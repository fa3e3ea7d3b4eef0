// Streaming attention forward for Hopper (sm_90a): softmax(q.k^T * s).v over
// head-major q/k/v, with an online softmax in fp32 and the division by the
// row sum after P.V.
//
// The kernel of csrc/attention.cu (the counterpart of the TPU kernel
// ddmi_tpu/ops/pallas/attention.py::mha_vmem).  The flash attention forward
// and the fused attention block run the Hopper kernel of
// flash_fwd_sm90.cuh, whose wgmma/TMA core this one can adopt.
//
// Design.  One block of 4 warps per (64-row q tile, head, batch); each warp
// owns 16 q rows, kept as WMMA bf16 fragments in registers.  K and V stream
// through shared memory in 64-key tiles, so the shared memory a block needs
// does not grow with n (about 109 KB at hd 128, 70 KB at hd 64, 40 KB at
// hd 16), and two to five blocks stay resident per SM.  Per tile, a warp
// computes its 16 x 64 scores with WMMA into fp32 shared memory, takes the
// running row max and the exponentials in fp32 (two lanes per row), writes
// the probabilities as bf16, and accumulates P.V into an fp32 output tile in
// shared memory after rescaling it by exp(m_old - m_new).  A ragged q tile
// (n % 64 != 0) reads zero rows and writes none; keys past n in the last
// tile are masked to -inf before the max.
//
// Scale.  q is multiplied by the scale in fp32 and rounded once to bf16
// before q.k (mha_vmem's rounding).
//
// What bounds it: 4 * n^2 * hd FLOP per (batch, head) on 4 * n * hd * 2
// bytes, so at n >= 512 the work is far above the card's bf16 ridge and the
// tensor cores (plus the n^2 exp() on the SFU at small hd) bound it.  This
// first version uses warp-level WMMA (mma.sync) from plain shared memory,
// with K/V loads that the resident blocks, not a pipeline, hide; wgmma and
// TMA are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace ddmi_attn {

using namespace nvcuda;

constexpr int QT = 64;        // q rows per block (16 per warp)
constexpr int KT = 64;        // keys per streamed K/V tile
constexpr int THREADS = 128;  // 4 warps
constexpr int S_LD = KT + 4;  // fp32 scores, padded against bank conflicts
constexpr int P_LD = KT + 8;  // bf16 probabilities

struct Params {
  const __nv_bfloat16* q;  // (B, nh, n, hd), contiguous
  const __nv_bfloat16* k;  // (B, nh, n, hd), contiguous
  const __nv_bfloat16* v;  // (B, nh, n, hd), contiguous
  __nv_bfloat16* out;      // (B, nh, n, hd), contiguous
  int B, nh, n;
  float scale;
};

template <int HD>
struct Layout {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim: a multiple of 16 up to 128");
  static constexpr int KV_LD = HD + 8;                    // bf16 elements
  static constexpr int KV_BYTES = KT * KV_LD * 2;         // one of K, V
  static constexpr int W_Q = 16 * KV_LD * 2;              // q rows, bf16
  static constexpr int W_S = 16 * S_LD * 4;               // scores; later P.V staging
  static constexpr int W_P = 16 * P_LD * 2;               // probabilities, bf16
  static constexpr int W_O = 16 * HD * 4;                 // running output, fp32
  static constexpr int W_R = 128;                         // per-row rescale factors
  static constexpr int WARP_BYTES = W_Q + W_S + W_P + W_O + W_R;
  static constexpr size_t SMEM = 2 * (size_t)KV_BYTES + 4 * (size_t)WARP_BYTES;
};

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(Params p) {
  using L = Layout<HD>;
  constexpr int LD = L::KV_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = p.n;

  const size_t head = ((size_t)b * p.nh + h) * (size_t)n * HD;
  const __nv_bfloat16* q = p.q + head;
  const __nv_bfloat16* k = p.k + head;
  const __nv_bfloat16* v = p.v + head;

  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::KV_BYTES);
  unsigned char* ws = smem + 2 * L::KV_BYTES + (size_t)warp * L::WARP_BYTES;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(ws);
  float* S = reinterpret_cast<float*>(ws + L::W_Q);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(ws + L::W_Q + L::W_S);
  float* O = reinterpret_cast<float*>(ws + L::W_Q + L::W_S + L::W_P);
  float* R = reinterpret_cast<float*>(ws + L::W_Q + L::W_S + L::W_P + L::W_O);

  // this warp's 16 q rows; rows past n are zero
  const int q0 = qt * QT + warp * 16;
  for (int i = lane; i < 16 * (HD / 8); i += 32) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < n) {
      raw = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * HD + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * p.scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = raw;
  }
  for (int i = lane; i < 16 * HD; i += 32) O[i] = 0.0f;
  __syncwarp();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wmma::load_matrix_sync(qf[kk], Qs + kk * 16, LD);

  const int r = lane / 2, hf = lane % 2;  // lane owns row r, half hf of a tile's keys
  float m_run = -INFINITY, l_run = 0.0f;

  for (int c0 = 0; c0 < n; c0 += KT) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < KT * (HD / 8); i += THREADS) {
      const int kr = i / (HD / 8), c = (i % (HD / 8)) * 8;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
      if (c0 + kr < n) {
        kraw = *reinterpret_cast<const uint4*>(k + (size_t)(c0 + kr) * HD + c);
        vraw = *reinterpret_cast<const uint4*>(v + (size_t)(c0 + kr) * HD + c);
      }
      *reinterpret_cast<uint4*>(Ks + kr * LD + c) = kraw;
      *reinterpret_cast<uint4*>(Vs + kr * LD + c) = vraw;
    }
    __syncthreads();

    // S = q . k^T over this tile
#pragma unroll
    for (int jt = 0; jt < KT / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + (16 * jt) * LD + 16 * kk, LD);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(S + 16 * jt, sf, S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile's valid keys
    const int valid = min(KT, n - c0);
    const int j0 = hf * (KT / 2);
    const float* srow = S + r * S_LD + j0;
    float cmax = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < KT / 2; ++j)
      if (j0 + j < valid) cmax = fmaxf(cmax, srow[j]);
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
    const float m_new = fmaxf(m_run, cmax);
    float csum = 0.0f;
    __nv_bfloat16* prow = P + r * P_LD + j0;
#pragma unroll 8
    for (int j = 0; j < KT / 2; ++j) {
      const float e = (j0 + j < valid) ? expf(srow[j] - m_new) : 0.0f;
      csum += e;
      prow[j] = __float2bfloat16(e);
    }
    csum += __shfl_xor_sync(0xffffffffu, csum, 1);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + csum;
    m_run = m_new;
    if (hf == 0) R[r] = alpha;
    __syncwarp();

    // O = O * alpha + P . V, 16 output columns at a time (staged in S)
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> tf;
      wmma::fill_fragment(tf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, P + 16 * kk, P_LD);
        wmma::load_matrix_sync(vf, Vs + (16 * kk) * LD + 16 * dt, LD);
        wmma::mma_sync(tf, pf, vf, tf);
      }
      wmma::store_matrix_sync(S, tf, 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int rr = i / 16, cc = 16 * dt + i % 16;
        O[rr * HD + cc] = O[rr * HD + cc] * R[rr] + S[i];
      }
      __syncwarp();
    }
  }

  // normalise after P.V and write the rows that exist
  if (hf == 0) R[r] = 1.0f / l_run;
  __syncwarp();
  __nv_bfloat16* out = p.out + head;
  for (int i = lane; i < 16 * HD; i += 32) {
    const int rr = i / HD, d = i % HD;
    if (q0 + rr < n) out[(size_t)(q0 + rr) * HD + d] = __float2bfloat16(O[i] * R[rr]);
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t smem = Layout<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<HD><<<dim3((p.n + QT - 1) / QT, p.nh, p.B), THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// The instance for head dim `hd`; cudaErrorInvalidValue for any other.
inline cudaError_t launch_hd(int hd, const Params& p, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(p, st);
    case 32: return launch<32>(p, st);
    case 48: return launch<48>(p, st);
    case 64: return launch<64>(p, st);
    case 80: return launch<80>(p, st);
    case 96: return launch<96>(p, st);
    case 112: return launch<112>(p, st);
    case 128: return launch<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ddmi_attn
