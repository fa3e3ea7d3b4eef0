// Streaming attention backward for Hopper (sm_90a): the gradients of
// o = softmax(q.k^T * s).v over head-major (B, nh, n, hd) bf16 q/k/v.
//
// Replaces the two Pallas kernels of the library's backward,
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_bwd_dkv
// (pallas_call at :1121, body _flash_attention_dkv_kernel) and
// ::_flash_attention_bwd_dq (pallas_call at :1456), with the same arithmetic:
//
//   p  = exp(q.k^T * s - lse)          fp32, lse from the forward
//   dv = bf16(p)^T . do
//   dp = do . v^T
//   ds = p * (dp - di) * s             di = sum_d o * do, fp32, from the caller
//   dk = bf16(ds)^T . q,  dq = bf16(ds) . k
//
// with fp32 sums and bf16 outputs.
//
// Design.  Two launches, as the library has two kernels: a CUDA block cannot
// carry the TPU grid's serial accumulation across blocks in a scratch
// buffer, and one launch would need atomics for dq (or dk/dv).  Without
// atomics every sum runs in a fixed order, so a repeat is bit-identical.
//   dkv: one block of 4 warps per (64-key tile, head, batch).  K and V of the
//        tile stay in shared memory; each warp owns 16 keys and keeps their
//        dK and dV sums in fp32 WMMA accumulator fragments (registers) while
//        the block streams every 64-row q tile (q, do, lse, di) through
//        shared memory.  Per q tile a warp forms p^T and dp^T (16 x 64) with
//        WMMA, the elementwise step in fp32, and two more WMMA products.
//   dq:  one block of 4 warps per (64-row q tile, head, batch).  Each warp
//        owns 16 q rows (q, do, lse, di in shared memory) and keeps its dQ
//        sum in accumulator fragments while K/V stream in 64-key tiles.
// Ragged tiles (n % 64 != 0) read zero rows; keys past n are masked to p = 0
// and rows past n get lse = +inf, so they add nothing and are not written.
//
// What bounds it: five n x n x hd products, 10 * n^2 * hd FLOP per (batch,
// head) against 8 tensors of n * hd values moved (q, k, v, o, do read; dq,
// dk, dv written).  At the celebahq training shape (B 5, 16 heads, n 1024,
// hd 32) that is 26.8 GFLOP, 27.1 us at 989 TFLOP/s, against 5.2 MB per
// tensor, 12.5 us at 3.35 TB/s: bound by operations.  This first version
// uses warp-level WMMA (mma.sync) from plain shared memory loads, like the
// forward (flash_attn.cuh); wgmma, TMA and a load pipeline are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_attn.cuh"

namespace ddmi_attn_bwd {

using namespace nvcuda;
using ddmi_attn::KT;
using ddmi_attn::P_LD;
using ddmi_attn::QT;
using ddmi_attn::S_LD;
using ddmi_attn::THREADS;

struct BwdParams {
  const __nv_bfloat16* q;   // (B, nh, n, hd), contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;         // (B, nh, n)
  const float* di;          // (B, nh, n)
  __nv_bfloat16* dq;        // (B, nh, n, hd), contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, nh, n;
  float scale;
};

template <int HD>
struct BwdLayout {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim: a multiple of 16 up to 128");
  static constexpr int LD = HD + 8;                  // bf16 rows of q/k/v/do tiles
  static constexpr int TILE = 64 * LD * 2;           // one 64-row bf16 tile
  static constexpr int ROWS = 16 * LD * 2;           // one warp's 16 bf16 rows
  static constexpr int W_S = 16 * S_LD * 4;          // fp32 16 x 64 (scores, dp)
  static constexpr int W_P = 16 * P_LD * 2;          // bf16 16 x 64 (p, ds)
  // dkv: K, V tiles + q, do tiles + lse, di (64 each) + per warp S, dP, P, dS
  static constexpr int DKV_WARP = 2 * W_S + 2 * W_P;
  static constexpr size_t DKV_SMEM = 4 * (size_t)TILE + 2 * 64 * 4 + 4 * (size_t)DKV_WARP;
  // dq: K, V tiles + per warp q, do rows, S, dP, dS, lse, di (16 each)
  static constexpr int DQ_WARP = 2 * ROWS + 2 * W_S + W_P + 2 * 16 * 4;
  static constexpr size_t DQ_SMEM = 2 * (size_t)TILE + 4 * (size_t)DQ_WARP;
};

// rows [r0, r0 + rows) of a (n, HD) bf16 matrix into shared memory (stride
// LD); rows past n are zero.  Threads `t0, t0 + step, ...` share the copy.
template <int HD, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int rows, int n, int t0, int step) {
  for (int i = t0; i < rows * (HD / 8); i += step) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) raw = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
  }
}

// acc[dt] (16 x 16 fp32 fragments over HD columns) -> bf16 rows [r0, r0+16)
// of out (stride HD), rows past n skipped; `stage` is 256 floats of this
// warp's shared memory.
template <int HD>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HD / 16], float* stage,
    __nv_bfloat16* out, int r0, int n, int lane) {
#pragma unroll
  for (int dt = 0; dt < HD / 16; ++dt) {
    wmma::store_matrix_sync(stage, acc[dt], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i / 16, c = 16 * dt + i % 16;
      if (r0 + r < n) out[(size_t)(r0 + r) * HD + c] = __float2bfloat16(stage[i]);
    }
    __syncwarp();
  }
}

// C (16 x 64 fp32, stride S_LD) = A (16 x HD, row-major, stride LD) times
// the transpose of B (64 x HD rows, stride LD).
template <int HD, int LD>
__device__ __forceinline__ void rows_times_tile_t(float* C, const __nv_bfloat16* A,
                                                  const __nv_bfloat16* B) {
#pragma unroll
  for (int jt = 0; jt < 4; ++jt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
    wmma::fill_fragment(cf, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
      wmma::load_matrix_sync(af, A + 16 * kk, LD);
      wmma::load_matrix_sync(bf, B + (16 * jt) * LD + 16 * kk, LD);
      wmma::mma_sync(cf, af, bf, cf);
    }
    wmma::store_matrix_sync(C + 16 * jt, cf, S_LD, wmma::mem_row_major);
  }
}

// acc[dt] += A (16 x 64 bf16, stride P_LD) . B (64 x HD bf16 rows, stride LD)
template <int HD, int LD>
__device__ __forceinline__ void accumulate(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HD / 16], const __nv_bfloat16* A,
    const __nv_bfloat16* B) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
    wmma::load_matrix_sync(af, A + 16 * kk, P_LD);
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, B + (16 * kk) * LD + 16 * dt, LD);
      wmma::mma_sync(acc[dt], af, bf, acc[dt]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(BwdParams p) {
  using L = BwdLayout<HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = p.n;
  const size_t bh = (size_t)b * p.nh + h;
  const size_t head = bh * (size_t)n * HD;

  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::TILE);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * L::TILE);
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem + 3 * L::TILE);  // do
  float* lse_s = reinterpret_cast<float*>(smem + 4 * L::TILE);
  float* di_s = lse_s + 64;
  unsigned char* ws = smem + 4 * L::TILE + 2 * 64 * 4 + (size_t)warp * L::DKV_WARP;
  float* S = reinterpret_cast<float*>(ws);                    // p^T, 16 keys x 64 q
  float* DP = reinterpret_cast<float*>(ws + L::W_S);          // dp^T
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(ws + 2 * L::W_S);
  __nv_bfloat16* DS = reinterpret_cast<__nv_bfloat16*>(ws + 2 * L::W_S + L::W_P);

  const int k0 = kt * KT;
  load_rows<HD, LD>(Ks, p.k + head, k0, KT, n, tid, THREADS);
  load_rows<HD, LD>(Vs, p.v + head, k0, KT, n, tid, THREADS);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[HD / 16], dv[HD / 16];
#pragma unroll
  for (int dt = 0; dt < HD / 16; ++dt) {
    wmma::fill_fragment(dk[dt], 0.0f);
    wmma::fill_fragment(dv[dt], 0.0f);
  }
  const int key_base = k0 + 16 * warp;  // this warp's first key
  const __nv_bfloat16* Kw = Ks + 16 * warp * LD;
  const __nv_bfloat16* Vw = Vs + 16 * warp * LD;

  for (int q0 = 0; q0 < n; q0 += QT) {
    __syncthreads();  // every warp is done with the previous q tile
    load_rows<HD, LD>(Qs, p.q + head, q0, QT, n, tid, THREADS);
    load_rows<HD, LD>(Os, p.dout + head, q0, QT, n, tid, THREADS);
    if (tid < 64) {
      const bool in = q0 + tid < n;
      lse_s[tid] = in ? p.lse[bh * n + q0 + tid] : INFINITY;
      di_s[tid] = in ? p.di[bh * n + q0 + tid] : 0.0f;
    }
    __syncthreads();

    rows_times_tile_t<HD, LD>(S, Kw, Qs);   // (k . q^T) for this warp's keys
    rows_times_tile_t<HD, LD>(DP, Vw, Os);  // (v . do^T)
    __syncwarp();
    for (int i = lane; i < 16 * 64; i += 32) {
      const int r = i / 64, c = i % 64;
      const float pv = (key_base + r < n) ? expf(S[r * S_LD + c] * p.scale - lse_s[c]) : 0.0f;
      P[r * P_LD + c] = __float2bfloat16(pv);
      DS[r * P_LD + c] = __float2bfloat16(pv * (DP[r * S_LD + c] - di_s[c]) * p.scale);
    }
    __syncwarp();
    accumulate<HD, LD>(dv, P, Os);   // dv += p^T . do
    accumulate<HD, LD>(dk, DS, Qs);  // dk += ds^T . q
  }

  store_rows<HD>(dk, S, p.dk + head, key_base, n, lane);
  store_rows<HD>(dv, S, p.dv + head, key_base, n, lane);
}

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(BwdParams p) {
  using L = BwdLayout<HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = p.n;
  const size_t bh = (size_t)b * p.nh + h;
  const size_t head = bh * (size_t)n * HD;

  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::TILE);
  unsigned char* ws = smem + 2 * L::TILE + (size_t)warp * L::DQ_WARP;
  __nv_bfloat16* Qw = reinterpret_cast<__nv_bfloat16*>(ws);
  __nv_bfloat16* Ow = reinterpret_cast<__nv_bfloat16*>(ws + L::ROWS);  // do
  float* S = reinterpret_cast<float*>(ws + 2 * L::ROWS);
  float* DP = reinterpret_cast<float*>(ws + 2 * L::ROWS + L::W_S);
  __nv_bfloat16* DS = reinterpret_cast<__nv_bfloat16*>(ws + 2 * L::ROWS + 2 * L::W_S);
  float* lse_w = reinterpret_cast<float*>(ws + 2 * L::ROWS + 2 * L::W_S + L::W_P);
  float* di_w = lse_w + 16;

  const int q0 = qt * QT + 16 * warp;  // this warp's first q row
  load_rows<HD, LD>(Qw, p.q + head, q0, 16, n, lane, 32);
  load_rows<HD, LD>(Ow, p.dout + head, q0, 16, n, lane, 32);
  if (lane < 16) {
    const bool in = q0 + lane < n;
    lse_w[lane] = in ? p.lse[bh * n + q0 + lane] : INFINITY;
    di_w[lane] = in ? p.di[bh * n + q0 + lane] : 0.0f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[HD / 16];
#pragma unroll
  for (int dt = 0; dt < HD / 16; ++dt) wmma::fill_fragment(dq[dt], 0.0f);

  for (int c0 = 0; c0 < n; c0 += KT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<HD, LD>(Ks, p.k + head, c0, KT, n, tid, THREADS);
    load_rows<HD, LD>(Vs, p.v + head, c0, KT, n, tid, THREADS);
    __syncthreads();

    rows_times_tile_t<HD, LD>(S, Qw, Ks);   // q . k^T
    rows_times_tile_t<HD, LD>(DP, Ow, Vs);  // do . v^T
    __syncwarp();
    const int valid = min(KT, n - c0);
    for (int i = lane; i < 16 * 64; i += 32) {
      const int r = i / 64, c = i % 64;
      const float pv = (c < valid) ? expf(S[r * S_LD + c] * p.scale - lse_w[r]) : 0.0f;
      DS[r * P_LD + c] = __float2bfloat16(pv * (DP[r * S_LD + c] - di_w[r]) * p.scale);
    }
    __syncwarp();
    accumulate<HD, LD>(dq, DS, Ks);  // dq += ds . k
  }

  store_rows<HD>(dq, S, p.dq + head, q0, n, lane);
}

template <int HD>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t st) {
  using L = BwdLayout<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::DKV_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::DQ_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + 63) / 64, p.nh, p.B);
  attn_bwd_dkv_kernel<HD><<<grid, THREADS, L::DKV_SMEM, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<HD><<<grid, THREADS, L::DQ_SMEM, st>>>(p);
  return cudaGetLastError();
}

// The instances for head dim `hd`; cudaErrorInvalidValue for any other.
inline cudaError_t launch_bwd_hd(int hd, const BwdParams& p, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_bwd<16>(p, st);
    case 32: return launch_bwd<32>(p, st);
    case 48: return launch_bwd<48>(p, st);
    case 64: return launch_bwd<64>(p, st);
    case 80: return launch_bwd<80>(p, st);
    case 96: return launch_bwd<96>(p, st);
    case 112: return launch_bwd<112>(p, st);
    case 128: return launch_bwd<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ddmi_attn_bwd
