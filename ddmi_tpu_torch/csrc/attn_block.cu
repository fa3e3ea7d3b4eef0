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
//   2. attention, one block per (64-row q tile, head, batch): the head's K and
//      V sit whole in shared memory (n = 1024, hd = 32: 64 KB each), scores
//      and softmax are fp32 with an online (running-max) rescale, and the
//      division by the row sum comes after P.V.
//   3. proj GEMM (M = B*n, N = C, K = C) whose epilogue adds bias + residual
//      in fp32 and casts to bf16.
//
// What bounds it on the card: at the celebahq shapes (C = 512..2048, n =
// 1024..64, batch 8) the GEMMs do 2*B*n*C*4C FLOP on B*n*C*2 bytes of
// activations, far above the bf16 ridge, so they are tensor-core bound; this
// first version uses warp-level WMMA (mma.sync) fragments from plain shared
// memory tiles, not wgmma/TMA, and so reaches a fraction of the peak.  The
// attention step is bound by its n^2 exp() work on the SFU at hd = 32.
#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// ---------------------------------------------------------------- attention

constexpr int HD = 32;         // head dim (every celebahq attention block)
constexpr int QT = 64;         // q rows per block (16 per warp)
constexpr int KC = 64;         // keys per online-softmax chunk
constexpr int ATT_THREADS = 128;
constexpr int P_LD = KC + 8;   // bf16 elements
constexpr int S_LD = KC + 4;   // fp32 elements

// per-warp scratch, bytes (each a multiple of 128 so every region stays
// 32-byte aligned for WMMA)
constexpr int W_Q = 16 * HD * 2;        // q rows, bf16
constexpr int W_S = 16 * S_LD * 4;      // scores, fp32
constexpr int W_P = 16 * P_LD * 2;      // probabilities, bf16
constexpr int W_O = 16 * HD * 4;        // running output, fp32
constexpr int W_T = 16 * HD * 4;        // P.V of the chunk, fp32
constexpr int W_R = 128;                // per-row rescale factors
constexpr int WARP_BYTES = W_Q + W_S + W_P + W_O + W_T + W_R;

__global__ void __launch_bounds__(ATT_THREADS)
    attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                     int B, int nh, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const size_t head = ((size_t)b * nh + h) * (size_t)n * HD;
  const size_t plane = (size_t)B * nh * n * HD;
  const __nv_bfloat16* q = qkv + head;
  const __nv_bfloat16* k = qkv + plane + head;
  const __nv_bfloat16* v = qkv + 2 * plane + head;

  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + (size_t)n * HD;
  unsigned char* ws = smem + (size_t)n * HD * 4 + (size_t)warp * WARP_BYTES;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(ws);
  float* S = reinterpret_cast<float*>(ws + W_Q);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(ws + W_Q + W_S);
  float* O = reinterpret_cast<float*>(ws + W_Q + W_S + W_P);
  float* T = reinterpret_cast<float*>(ws + W_Q + W_S + W_P + W_O);
  float* R = reinterpret_cast<float*>(ws + W_Q + W_S + W_P + W_O + W_T);

  for (int i = tid; i < n * HD / 8; i += ATT_THREADS) {
    reinterpret_cast<uint4*>(Ks)[i] = reinterpret_cast<const uint4*>(k)[i];
    reinterpret_cast<uint4*>(Vs)[i] = reinterpret_cast<const uint4*>(v)[i];
  }
  const int q0 = qt * QT + warp * 16;
  for (int i = lane; i < 16 * HD / 8; i += 32)
    reinterpret_cast<uint4*>(Qs)[i] = reinterpret_cast<const uint4*>(q + (size_t)q0 * HD)[i];
  for (int i = lane; i < 16 * HD; i += 32) O[i] = 0.0f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wmma::load_matrix_sync(qf[kk], Qs + kk * 16, HD);

  // lane owns row r, half `hf` of the chunk's columns
  const int r = lane / 2, hf = lane % 2;
  float m_run = -INFINITY, l_run = 0.0f;

  for (int c0 = 0; c0 < n; c0 += KC) {
    // S = q . k^T  (scale already folded into q)
#pragma unroll
    for (int jt = 0; jt < KC / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + (size_t)(c0 + 16 * jt) * HD + 16 * kk, HD);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(S + 16 * jt, sf, S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    const float* srow = S + r * S_LD + hf * (KC / 2);
    float cmax = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < KC / 2; ++j) cmax = fmaxf(cmax, srow[j]);
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
    const float m_new = fmaxf(m_run, cmax);
    float csum = 0.0f;
    __nv_bfloat16* prow = P + r * P_LD + hf * (KC / 2);
#pragma unroll 8
    for (int j = 0; j < KC / 2; ++j) {
      const float e = expf(srow[j] - m_new);
      csum += e;
      prow[j] = __float2bfloat16(e);
    }
    csum += __shfl_xor_sync(0xffffffffu, csum, 1);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + csum;
    m_run = m_new;
    if (hf == 0) R[r] = alpha;
    __syncwarp();

    // T = P . V_chunk
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> tf;
      wmma::fill_fragment(tf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, P + 16 * kk, P_LD);
        wmma::load_matrix_sync(vf, Vs + (size_t)(c0 + 16 * kk) * HD + 16 * dt, HD);
        wmma::mma_sync(tf, pf, vf, tf);
      }
      wmma::store_matrix_sync(T + 16 * dt, tf, HD, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) O[i] = O[i] * R[i / HD] + T[i];
    __syncwarp();
  }

  // normalise after P.V; out is (B, n, C) with channels (head, dim)
  if (hf == 0) R[r] = 1.0f / l_run;
  __syncwarp();
  const int C = nh * HD;
  for (int i = lane; i < 16 * HD; i += 32) {
    const int rr = i / HD, d = i % HD;
    out[((size_t)b * n + q0 + rr) * C + h * HD + d] = __float2bfloat16(O[i] * R[rr]);
  }
}

size_t attention_smem_bytes(int n) { return (size_t)n * HD * 4 + 4 * (size_t)WARP_BYTES; }

}  // namespace

extern "C" {

// Shared memory the attention step needs at sequence length n.
size_t ddmi_attn_block_smem_bytes(int n) { return attention_smem_bytes(n); }

// x, res, out: (B*n, C) bf16; es/eb: (B, C) fp32; w_qkv: (C, 3C) bf16 with
// qkv-major output channels; b_qkv: (3C,) fp32; w_proj: (C, C) bf16; b_proj:
// (C,) fp32.  Scratch: qkv (3, B, nh, n, 32) bf16, attn (B*n, C) bf16.
// Returns the cudaError_t of the launches.
int ddmi_attn_block(const void* x, const void* es, const void* eb, const void* w_qkv,
                    const void* b_qkv, const void* w_proj, const void* b_proj, void* qkv,
                    void* attn, void* out, int B, int n, int C, int nh, float sm_scale,
                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * n;

  GemmArgs g{};
  g.a = static_cast<const __nv_bfloat16*>(x);
  g.w = static_cast<const __nv_bfloat16*>(w_qkv);
  g.bias = static_cast<const float*>(b_qkv);
  g.es = static_cast<const float*>(es);
  g.eb = static_cast<const float*>(eb);
  g.out = static_cast<__nv_bfloat16*>(qkv);
  g.M = M; g.N = 3 * C; g.K = C; g.n_tok = n; g.nh = nh; g.hd = HD;
  g.q_scale = sm_scale;
  gemm_kernel<MODE_QKV><<<dim3(3 * C / BN, (M + BM - 1) / BM), GEMM_THREADS, 0, st>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = attention_smem_bytes(n);
  err = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<<<dim3(n / QT, nh, B), ATT_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(attn), B, nh, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmArgs pr{};
  pr.a = static_cast<const __nv_bfloat16*>(attn);
  pr.w = static_cast<const __nv_bfloat16*>(w_proj);
  pr.bias = static_cast<const float*>(b_proj);
  pr.res = static_cast<const __nv_bfloat16*>(x);
  pr.out = static_cast<__nv_bfloat16*>(out);
  pr.M = M; pr.N = C; pr.K = C; pr.n_tok = n; pr.nh = nh; pr.hd = HD;
  pr.q_scale = 1.0f;
  gemm_kernel<MODE_PROJ><<<dim3(C / BN, (M + BM - 1) / BM), GEMM_THREADS, 0, st>>>(pr);
  return cudaGetLastError();
}

}  // extern "C"
