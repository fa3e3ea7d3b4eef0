// Fused styled-INR render for Hopper (sm_90a): the whole INRImage MLP per
// token tile on style-folded weights.
//
// Replaces the TPU kernel ddmi_tpu/ops/pallas/inr_decode.py::inr_decode_fused
// (body `_make_kernel`).  Per token: 4 StyledResBlocks + ToRGB = 13 matmuls on
// weights folded with the render's single style vector
// (ops/inr_decode.py::fold_inr_image_params), each conv followed by
// bias + LeakyReLU(0.2) * sqrt(2), each block by a residual * 1/sqrt(2).
//
// What bounds it on the card: unfused, each of the 13 matmuls reads and
// writes its (N, 256) activation through device memory, about 0.5 FLOP per
// byte at bf16: memory bound.  Here one block owns a 64-token tile and keeps
// its activations in shared memory through all 13 matmuls (two bf16
// (64, 256) buffers and one fp32 (64, 256) staging buffer, 131 KB), so device
// memory sees one read of the three (N, 128) feature rows and one write of
// the pixels.  The 2.2 MB of folded weights do not fit in shared memory; each
// layer's weights stream in 16-row k-steps from L2 straight into WMMA
// fragments, so the kernel is bound by L2 bandwidth and the rate at which
// warps issue tensor-core instructions, not by device memory.
//
// NoiseInjection (x + w * N(0, 1), one draw per token and conv) comes from a
// counter-based Philox4x32-10 keyed by (seed, token, conv), then Box-Muller.
// It is statistically the JAX noise, bit-different.  With every gain 0 the
// noise path is compiled out (HAS_NOISE = false), as in the JAX kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int T = 64;          // tokens per block
constexpr int CHP = 256;       // hidden width (padded ch)
constexpr int INP = 128;       // feature width (latent + 2, padded)
constexpr int NCONV = 12;
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (cols), 32 x 64 each
constexpr int H_LD = CHP + 8;  // bf16 elements
constexpr int S_LD = CHP + 4;  // fp32 elements
constexpr float SQRT2 = 1.41421356237309515f;
constexpr float INV_SQRT2 = 0.70710678118654757f;

constexpr size_t SMEM_H = (size_t)T * H_LD * 2;
constexpr size_t SMEM_S = (size_t)T * S_LD * 4;
constexpr size_t SMEM_G = (size_t)T * NCONV * 4;
constexpr size_t SMEM_BYTES = 2 * SMEM_H + SMEM_S + SMEM_G;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Params {
  const __nv_bfloat16* x0;   // (N, INP) tokens of the three pyramid levels
  const __nv_bfloat16* xm;
  const __nv_bfloat16* xh;
  const __nv_bfloat16* wa;   // (14, CHP, CHP) ch -> ch matmuls
  const __nv_bfloat16* wb;   // (6, INP, CHP) features -> ch matmuls
  const float* act_bias;     // (12, CHP)
  const float* noise_w;      // (12,)
  const float* rgb_bias;     // (CHP,)
  __nv_bfloat16* out;        // (N, out_ch)
  int out_ch;
  uint32_t seed;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ void zero(FragC (&acc)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc += a[rows wr.., 0:K] . w[0:K, cols wc..]; a in shared or global memory
__device__ __forceinline__ void mma(FragC (&acc)[2][4], const __nv_bfloat16* a, int lda,
                                    const __nv_bfloat16* w, int K, int wr, int wc) {
  for (int k = 0; k < K; k += 16) {
    FragA af[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], a + (wr + 16 * i) * lda + k, lda);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB bf;
      wmma::load_matrix_sync(bf, w + (size_t)k * CHP + wc + 16 * j, CHP);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
    }
  }
}

__device__ __forceinline__ void stage(float* S, FragC (&acc)[2][4], int wr, int wc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(S + (wr + 16 * i) * S_LD + wc + 16 * j, acc[i][j], S_LD,
                              wmma::mem_row_major);
}

__device__ __forceinline__ void unstage(FragC (&acc)[2][4], const float* S, int wr, int wc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(acc[i][j], S + (wr + 16 * i) * S_LD + wc + 16 * j, S_LD,
                             wmma::mem_row_major);
}

// NoiseInjection + fused bias-LeakyReLU of conv k, on the staged sums.
// To bf16 `dst`, or (dst == nullptr) in place in fp32.
template <bool HAS_NOISE>
__device__ __forceinline__ void styled(float* S, __nv_bfloat16* dst, const float* G,
                                       const float* __restrict__ bias, int k) {
  for (int e = threadIdx.x; e < T * CHP; e += THREADS) {
    const int r = e / CHP, c = e % CHP;
    float z = S[r * S_LD + c];
    if (HAS_NOISE) z += G[r * NCONV + k];
    z += bias[k * CHP + c];
    z = (z >= 0.0f ? z : 0.2f * z) * SQRT2;
    if (dst) dst[r * H_LD + c] = __float2bfloat16(z);
    else S[r * S_LD + c] = z;
  }
}

template <bool HAS_NOISE>
__global__ void __launch_bounds__(THREADS) inr_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_H);
  float* S = reinterpret_cast<float*>(smem + 2 * SMEM_H);
  float* G = reinterpret_cast<float*>(smem + 2 * SMEM_H + SMEM_S);

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 64;
  const size_t tok0 = (size_t)blockIdx.x * T;
  const __nv_bfloat16* x[3] = {p.x0 + tok0 * INP, p.xm + tok0 * INP, p.xh + tok0 * INP};
  const __nv_bfloat16* wa = p.wa;
  const size_t WA = (size_t)CHP * CHP, WB = (size_t)INP * CHP;

  if (HAS_NOISE) {
    for (int e = threadIdx.x; e < T * NCONV; e += THREADS) {
      const int r = e / NCONV, k = e % NCONV;
      const uint4 bits = philox4x32_10(make_uint4((uint32_t)(tok0 + r), (uint32_t)k, 0u, 0u),
                                        make_uint2(p.seed, 0x85EBCA6Bu));
      const float u1 = ((bits.x >> 8) + 1u) * (1.0f / 16777216.0f);  // (0, 1]
      const float u2 = (bits.y >> 8) * (1.0f / 16777216.0f);         // [0, 1)
      G[e] = sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958648f * u2) * p.noise_w[k];
    }
    __syncthreads();
  }

  FragC acc[2][4];
  // One StyledResBlock.  extra: this block's feature tile (or null);
  // wb1/wbs: its feature->ch slots for conv1/skip (or -1); wa1/was: the
  // h->ch slots for conv1/skip (or -1); wa2, wa3: conv2, conv3; k0: the
  // block's first conv index.  h lives in H (bf16) and is replaced.
  auto resblock = [&](const __nv_bfloat16* extra, int wb1, int wbs, int wa1, int was, int wa2,
                      int wa3, int k0) {
    zero(acc);
    if (wb1 >= 0) mma(acc, extra, INP, p.wb + wb1 * WB, INP, wr, wc);
    if (wa1 >= 0) mma(acc, H, H_LD, wa + wa1 * WA, CHP, wr, wc);
    stage(S, acc, wr, wc);
    __syncthreads();
    styled<HAS_NOISE>(S, A, G, p.act_bias, k0);
    __syncthreads();
    zero(acc);
    mma(acc, A, H_LD, wa + wa2 * WA, CHP, wr, wc);
    stage(S, acc, wr, wc);
    __syncthreads();
    styled<HAS_NOISE>(S, A, G, p.act_bias, k0 + 1);
    __syncthreads();
    zero(acc);
    mma(acc, A, H_LD, wa + wa3 * WA, CHP, wr, wc);
    stage(S, acc, wr, wc);
    __syncthreads();
    styled<HAS_NOISE>(S, nullptr, G, p.act_bias, k0 + 2);  // fp32, stays in S
    __syncthreads();
    if (wbs >= 0 || was >= 0) {
      // skip matmuls accumulate on top of conv3's output
      unstage(acc, S, wr, wc);
      if (wbs >= 0) mma(acc, extra, INP, p.wb + wbs * WB, INP, wr, wc);
      if (was >= 0) mma(acc, H, H_LD, wa + was * WA, CHP, wr, wc);
      __syncthreads();
      stage(S, acc, wr, wc);
      __syncthreads();
      for (int e = threadIdx.x; e < T * CHP; e += THREADS) {
        const int r = e / CHP, c = e % CHP;
        H[r * H_LD + c] = __float2bfloat16(S[r * S_LD + c] * INV_SQRT2);
      }
    } else {
      for (int e = threadIdx.x; e < T * CHP; e += THREADS) {
        const int r = e / CHP, c = e % CHP;
        H[r * H_LD + c] =
            __float2bfloat16((S[r * S_LD + c] + __bfloat162float(H[r * H_LD + c])) * INV_SQRT2);
      }
    }
    __syncthreads();
  };

  // slot tables as in ddmi_tpu/ops/pallas/inr_decode.py (_WA_ORDER/_WB_ORDER)
  resblock(x[0], 0, 1, -1, -1, 11, 12, 0);  // net_res1
  resblock(x[1], 2, 3, 0, 3, 1, 2, 3);      // net_res2
  resblock(x[2], 4, 5, 4, 7, 5, 6, 6);      // net_res3
  resblock(nullptr, -1, -1, 8, -1, 9, 10, 9);  // net_res4

  // torgb: only the first 16 output lanes are computed (out_ch <= 16)
  if (warp < T / 16) {
    FragC o;
    wmma::fill_fragment(o, 0.0f);
    for (int k = 0; k < CHP; k += 16) {
      FragA af;
      FragB bf;
      wmma::load_matrix_sync(af, H + (16 * warp) * H_LD + k, H_LD);
      wmma::load_matrix_sync(bf, wa + 13 * WA + (size_t)k * CHP, CHP);
      wmma::mma_sync(o, af, bf, o);
    }
    wmma::store_matrix_sync(S + (16 * warp) * S_LD, o, S_LD, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < T * p.out_ch; e += THREADS) {
    const int r = e / p.out_ch, c = e % p.out_ch;
    p.out[(tok0 + r) * p.out_ch + c] = __float2bfloat16(S[r * S_LD + c] + p.rgb_bias[c]);
  }
}

}  // namespace

extern "C" {

// x0/xm/xh: (N, 128) bf16, N a multiple of 64; wa (14, 256, 256) bf16;
// wb (6, 128, 256) bf16; act_bias (12, 256) fp32; noise_w (12,) fp32;
// rgb_bias (256,) fp32; out (N, out_ch) bf16, out_ch <= 16.
// Returns the cudaError_t of the launch.
int ddmi_inr_decode(const void* x0, const void* xm, const void* xh, const void* wa,
                    const void* wb, const void* act_bias, const void* noise_w,
                    const void* rgb_bias, void* out, int N, int out_ch, int has_noise,
                    unsigned int seed, void* stream) {
  Params p;
  p.x0 = static_cast<const __nv_bfloat16*>(x0);
  p.xm = static_cast<const __nv_bfloat16*>(xm);
  p.xh = static_cast<const __nv_bfloat16*>(xh);
  p.wa = static_cast<const __nv_bfloat16*>(wa);
  p.wb = static_cast<const __nv_bfloat16*>(wb);
  p.act_bias = static_cast<const float*>(act_bias);
  p.noise_w = static_cast<const float*>(noise_w);
  p.rgb_bias = static_cast<const float*>(rgb_bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.out_ch = out_ch;
  p.seed = seed;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(N / T);
  cudaError_t err;
  if (has_noise) {
    err = cudaFuncSetAttribute(inr_decode_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    inr_decode_kernel<true><<<grid, THREADS, SMEM_BYTES, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(inr_decode_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    inr_decode_kernel<false><<<grid, THREADS, SMEM_BYTES, st>>>(p);
  }
  return cudaGetLastError();
}

}  // extern "C"
