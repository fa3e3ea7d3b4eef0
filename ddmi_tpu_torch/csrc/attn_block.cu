// Fused ADM attention block for Hopper (sm_90a): x + proj(MHA(qkv(GN(x)))).
//
// Replaces the TPU kernel ddmi_tpu/ops/pallas/attn_block.py::
// fused_attention_block (body `_kernel`).  The TPU kernel walks head chunks
// in order and accumulates the output projection's partial products in one
// resident block; CUDA blocks run concurrently and in no order, so the block
// is split into three launches instead, each with a deterministic sum order:
//
//   1. qkv GEMM  (M = B*n, N = 3C, K = C).  The prologue applies GroupNorm as
//      one multiply-add per element (statistics are folded into per-(b, c)
//      scale/bias by the caller); the epilogue adds the bias, pre-scales q by
//      the softmax scale in fp32, and writes q/k/v head-major in bf16.
//   2. attention, one block per (64-row q tile, head, batch), K and V
//      streamed through shared memory in 64-key tiles (csrc/flash_attn.cuh):
//      fp32 scores and online softmax, the division by the row sum after
//      P.V, and the output written token-major (B, n, C) for step 3.  Every
//      head dim that is a multiple of 16 up to 128 has an instance; a ragged
//      q tile and the key tail are masked, so any n is taken.
//   3. proj GEMM (M = B*n, N = C, K = C) whose epilogue adds bias + residual
//      in fp32 and casts to bf16.
//
// What bounds it on the card: at the image UNet's shapes (C = 512..2048,
// n = 1024..64, batch 8) the GEMMs do 2*B*n*C*4C FLOP on B*n*C*2 bytes of
// activations, far above the bf16 ridge, so they are tensor-core bound; this
// first version uses warp-level WMMA (mma.sync) fragments from plain shared
// memory tiles, not wgmma/TMA, and so reaches a fraction of the peak.  At
// the video UNet's shapes (n = 256..8, batch 2-4) the launches are small and
// latency, not throughput, bounds them.
#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_attn.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int A_LD = BK + 8;  // bf16 elements; padding breaks bank conflicts
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // fp32 elements
constexpr int GEMM_THREADS = 128;

enum { MODE_QKV = 0, MODE_PROJ = 1 };

struct GemmArgs {
  const __nv_bfloat16* a;    // (M, K) row-major activations
  const __nv_bfloat16* w;    // (K, N) row-major weights
  const float* bias;         // (N,)
  const float* es;           // (B, K) folded GN scale   [MODE_QKV]
  const float* eb;           // (B, K) folded GN shift   [MODE_QKV]
  const __nv_bfloat16* res;  // (M, N) residual          [MODE_PROJ]
  __nv_bfloat16* out;
  int M, N, K, n_tok, nh, hd;
  float q_scale;
};

template <int MODE>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int wr = (warp / 2) * 32;
  const int wc = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int v = tid; v < BM * BK / 8; v += GEMM_THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      const int gr = row0 + r;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (gr < p.M) {
        raw = *reinterpret_cast<const uint4*>(p.a + (size_t)gr * p.K + k0 + c);
        if (MODE == MODE_QKV) {
          __nv_bfloat16* xv = reinterpret_cast<__nv_bfloat16*>(&raw);
          const int b = gr / p.n_tok;
          const float* es = p.es + (size_t)b * p.K + k0 + c;
          const float* eb = p.eb + (size_t)b * p.K + k0 + c;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            xv[e] = __float2bfloat16(__bfloat162float(xv[e]) * es[e] + eb[e]);
        }
      }
      *reinterpret_cast<uint4*>(&As[r * A_LD + c]) = raw;
    }
    for (int v = tid; v < BK * BN / 8; v += GEMM_THREADS) {
      const int r = v / (BN / 8);
      const int c = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * B_LD + c]) =
          *reinterpret_cast<const uint4*>(p.w + (size_t)(k0 + r) * p.N + col0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[(wr + 16 * i) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk * B_LD + wc + 16 * j], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wr + 16 * i) * C_LD + wc + 16 * j], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();

  const int C = p.N / 3;
  const size_t B = (size_t)(p.M / p.n_tok);
  for (int e = tid; e < BM * BN; e += GEMM_THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= p.M) continue;
    float v = Cs[r * C_LD + c] + p.bias[gc];
    if (MODE == MODE_QKV) {
      // qkv-major input channels [q | k | v], each (head, dim)
      const int which = gc / C;
      const int rem = gc - which * C;
      const int h = rem / p.hd, d = rem - h * p.hd;
      if (which == 0) v *= p.q_scale;
      const int b = gr / p.n_tok, i = gr - b * p.n_tok;
      const size_t o = (((size_t)which * B + b) * p.nh + h) * (size_t)p.n_tok * p.hd +
                       (size_t)i * p.hd + d;
      p.out[o] = __float2bfloat16(v);
    } else {
      v += __bfloat162float(p.res[(size_t)gr * p.N + gc]);
      p.out[(size_t)gr * p.N + gc] = __float2bfloat16(v);
    }
  }
}

}  // namespace

extern "C" {

// x, res, out: (B*n, C) bf16; es/eb: (B, C) fp32; w_qkv: (C, 3C) bf16 with
// qkv-major output channels; b_qkv: (3C,) fp32; w_proj: (C, C) bf16; b_proj:
// (C,) fp32.  Scratch: qkv (3, B, nh, n, C / nh) bf16, attn (B*n, C) bf16.
// Takes C % 128 == 0 and a head dim C / nh that is a multiple of 16 up to
// 128; any n.  Returns the cudaError_t of the launches.
int ddmi_attn_block(const void* x, const void* es, const void* eb, const void* w_qkv,
                    const void* b_qkv, const void* w_proj, const void* b_proj, void* qkv,
                    void* attn, void* out, int B, int n, int C, int nh, float sm_scale,
                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * n;
  const int hd = C / nh;
  if (hd * nh != C || C % 128 || hd % 16 || hd > 128) return cudaErrorInvalidValue;

  GemmArgs g{};
  g.a = static_cast<const __nv_bfloat16*>(x);
  g.w = static_cast<const __nv_bfloat16*>(w_qkv);
  g.bias = static_cast<const float*>(b_qkv);
  g.es = static_cast<const float*>(es);
  g.eb = static_cast<const float*>(eb);
  g.out = static_cast<__nv_bfloat16*>(qkv);
  g.M = M; g.N = 3 * C; g.K = C; g.n_tok = n; g.nh = nh; g.hd = hd;
  g.q_scale = sm_scale;
  gemm_kernel<MODE_QKV><<<dim3(3 * C / BN, (M + BM - 1) / BM), GEMM_THREADS, 0, st>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // q already carries the scale (one fp32 multiply before the bf16 store)
  const size_t plane = (size_t)B * nh * n * hd;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  ddmi_attn::Params a{};
  a.q = q;
  a.k = q + plane;
  a.v = q + 2 * plane;
  a.out = static_cast<__nv_bfloat16*>(attn);
  a.out_sb = (long long)n * C; a.out_sh = hd; a.out_si = C;
  a.B = B; a.nh = nh; a.n = n;
  a.scale = 1.0f;
  a.prescale_q = 0;
  err = ddmi_attn::launch_hd(hd, a, st);
  if (err != cudaSuccess) return err;

  GemmArgs pr{};
  pr.a = static_cast<const __nv_bfloat16*>(attn);
  pr.w = static_cast<const __nv_bfloat16*>(w_proj);
  pr.bias = static_cast<const float*>(b_proj);
  pr.res = static_cast<const __nv_bfloat16*>(x);
  pr.out = static_cast<__nv_bfloat16*>(out);
  pr.M = M; pr.N = C; pr.K = C; pr.n_tok = n; pr.nh = nh; pr.hd = hd;
  pr.q_scale = 1.0f;
  gemm_kernel<MODE_PROJ><<<dim3(C / BN, (M + BM - 1) / BM), GEMM_THREADS, 0, st>>>(pr);
  return cudaGetLastError();
}

}  // extern "C"
