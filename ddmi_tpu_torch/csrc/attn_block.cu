// Fused ADM attention block for Hopper (sm_90a): x + proj(MHA(qkv(GN(x)))).
//
// Replaces the TPU kernel ddmi_tpu/ops/pallas/attn_block.py::
// fused_attention_block (body `_kernel`).  The TPU kernel walks head chunks
// in order and accumulates the output projection's partial products in one
// resident block; CUDA blocks run concurrently and in no order, so the block
// is four launches here, each with a fixed sum order (no split-K, no
// atomics: a repeat is bit-identical):
//
//   1. GroupNorm: one CTA per (group, batch) takes the group's mean and
//      biased variance in fp32 in two passes over x (as torch.var_mean),
//      then writes h = bf16(x * es + eb), es = rstd * gamma and eb = beta -
//      mean * es, as JAX materialises h in x's dtype before the qkv product.
//   2. qkv GEMM (M = B*n, N = 3C, K = C) and 4. proj GEMM (N = C): the
//      Hopper main loop of the flash kernels.  A producer warp feeds a
//      4-stage ring of 128 x 64 tiles of the activations and of the weight
//      by TMA on full/empty mbarriers; two consumer warpgroups of 64 rows
//      run wgmma m64n128k16 with both operands in shared memory, K-major.
//      The grid is persistent (one CTA per SM walks the 128 x 128 output
//      tiles), so the ring streams on across tiles and a tile's loads
//      overlap the epilogue of the one before it.
//      The weights are read as the module stores them: a Conv1d weight
//      (N, K, 1) is an (N, K) K-major matrix, wgmma's native B layout, so no
//      copy, gather or transpose of a weight is made per call.  TMA reads
//      rows past M as zero; the epilogue writes none of them.
//      qkv epilogue: + bias (read in its stored dtype, widened to fp32),
//      q times the softmax scale in fp32 before its one bf16 rounding (JAX,
//      attn_block.py:102), each output channel decoded from the module's
//      head-major order (head, {q, k, v}, dim) and written to (3, B, nh, n,
//      hd') bf16 with the head dim zero-padded to hd', the next flash
//      instance (16, 32, 64 or 128).
//      proj epilogue: + bias + the residual x in fp32, one bf16 rounding.
//   3. attention: the Hopper flash forward (flash_fwd_sm90.cuh) at hd' with
//      scale 1 (q carries the scale), writing only the hd real columns of
//      each head token-major into (B, n, C) for the proj GEMM.
//
// What bounds it on the card: at the image UNet's shapes (batch 8, n 1024 /
// 256 / 64, C 512 / 1024 / 2048) the GEMMs do 8 * B*n * C^2 FLOP on a few
// MB and the attention 4 * B * n^2 * C, so the tensor cores bound it.  At
// the video and NeRF UNets' shapes (n 256 down to 8, batch 2) a block is a
// few MFLOP to a few GFLOP and launch latency bounds it; there the design's
// point is that the host issues four launches and no other op.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "tensor_map.cuh"

namespace {

using namespace ddmi_sm90;

// ---- GroupNorm ----

constexpr int GN_THREADS = 256;

struct GnParams {
  const __nv_bfloat16* x;  // (B, n, C)
  const void* gamma;       // (C,) bf16 or fp32 (vec_f32)
  const void* beta;
  __nv_bfloat16* h;        // (B, n, C)
  int n, C, G, vec_f32;
  float eps;
};

__device__ __forceinline__ float load_vec(const void* p, int i, int f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// the sum of v over the CTA, the same value in every thread: a shuffle tree
// per warp, then the warps' partials added in warp order
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free again
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < GN_THREADS / 32; ++w) t += red[w];
  return t;
}

// 4 channels of one token (8 bytes): cpg % 4 == 0 and C % 128 == 0 keep every
// unit aligned
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__global__ void __launch_bounds__(GN_THREADS) group_norm_kernel(const GnParams p) {
  __shared__ float red[GN_THREADS / 32];
  const int g = blockIdx.x, cpg = p.C / p.G, units = cpg / 4, count = p.n * units;
  const size_t base = (size_t)blockIdx.y * p.n * p.C + (size_t)g * cpg;
  const __nv_bfloat16* x = p.x + base;
  const float inv_count = 1.0f / (float)(p.n * cpg);

  float s = 0.0f;
  for (int u = threadIdx.x; u < count; u += GN_THREADS) {
    const int i = u / units, c = (u - i * units) * 4;
    float v[4];
    load4(x + (size_t)i * p.C + c, v);
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  const float mean = block_sum(s, red) * inv_count;
  float q = 0.0f;
  for (int u = threadIdx.x; u < count; u += GN_THREADS) {
    const int i = u / units, c = (u - i * units) * 4;
    float v[4];
    load4(x + (size_t)i * p.C + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) q += (v[e] - mean) * (v[e] - mean);
  }
  const float rstd = rsqrtf(block_sum(q, red) * inv_count + p.eps);

  __nv_bfloat16* h = p.h + base;
  for (int u = threadIdx.x; u < count; u += GN_THREADS) {
    const int i = u / units, c = (u - i * units) * 4;
    float v[4];
    load4(x + (size_t)i * p.C + c, v);
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = g * cpg + c + e;
      const float es = rstd * load_vec(p.gamma, ch, p.vec_f32);
      const float eb = load_vec(p.beta, ch, p.vec_f32) - mean * es;
      o[e] = v[e] * es + eb;
    }
    uint2 raw;
    raw.x = pack_bf16(o[0], o[1]);
    raw.y = pack_bf16(o[2], o[3]);
    *reinterpret_cast<uint2*>(h + (size_t)i * p.C + c) = raw;
  }
}

// ---- GEMM: out = A . W^T, A (M, K) and W (N, K) both row-major ----

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int BAR_OFF = STAGES * (A_BYTES + B_BYTES);
constexpr size_t GEMM_SMEM = BAR_OFF + 128 + 1024;  // barriers, 1024-byte alignment

enum { MODE_QKV = 0, MODE_PROJ = 1 };

struct GemmParams {
  CUtensorMap a, w;          // (K, M) and (K, N) maps, boxes of 64 x BM and 64 x BN
  const void* bias;          // (N,), bf16 or fp32 (vec_f32)
  const __nv_bfloat16* res;  // (M, N) residual                       [MODE_PROJ]
  __nv_bfloat16* out;        // (M, N) [MODE_PROJ]; (3, B, nh, n, hdp) [MODE_QKV]
  int M, N, K, n_tok, nh, hd, hdp, vec_f32;
  float q_scale;
};

// the offset in the (3, B, nh, n, hdp) qkv scratch of output channel `col`
// (head-major: head, {q, k, v}, dim) without its token part, and its dim d
__device__ __forceinline__ size_t qkv_col_off(const GemmParams& p, int col, int& which, int& d) {
  const int h = col / (3 * p.hd), r = col - h * 3 * p.hd;
  which = r / p.hd;
  d = r - which * p.hd;
  return ((size_t)which * (p.M / p.n_tok) * p.nh + h) * p.n_tok * p.hdp + d;
}

// zeros after a head's last real dim d = hd - 1, at dst + 1 ... dst + hdp - hd
__device__ __forceinline__ void pad_head(const GemmParams& p, __nv_bfloat16* dst, int d) {
  if (d == p.hd - 1)
    for (int e = 1; e < p.hdp - p.hd + 1; ++e) dst[e] = __float2bfloat16(0.0f);
}

// The epilogue of one 64 x BN accumulator tile of a consumer warpgroup:
// d[4j + 2i + c] is row row0 + 8i, column n0 + 8j + 2 (lane % 4) + c.
template <int MODE>
__device__ __forceinline__ void epilogue(const GemmParams& p, const float (&acc)[BN / 2], int row0,
                                         int n0, int lane) {
  const bool pairs = MODE == MODE_PROJ || p.hd % 2 == 0;
  size_t row_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int b = row / p.n_tok;
    row_off[i] = MODE == MODE_PROJ ? (size_t)row * p.N
                                   : ((size_t)b * p.nh * p.n_tok + (row - b * p.n_tok)) * p.hdp;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    const float b0 = load_vec(p.bias, col, p.vec_f32), b1 = load_vec(p.bias, col + 1, p.vec_f32);
    if (MODE == MODE_PROJ) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row0 + 8 * i >= p.M) continue;
        const size_t o = row_off[i] + col;
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.res + o));
        *reinterpret_cast<uint32_t*>(p.out + o) =
            pack_bf16(acc[4 * j + 2 * i] + b0 + r.x, acc[4 * j + 2 * i + 1] + b1 + r.y);
      }
    } else if (pairs) {  // an even hd: the pair shares its head and q/k/v
      int which, d;
      const size_t c_off = qkv_col_off(p, col, which, d);
      const float sc = which == 0 ? p.q_scale : 1.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row0 + 8 * i >= p.M) continue;
        __nv_bfloat16* dst = p.out + c_off + row_off[i];
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16((acc[4 * j + 2 * i] + b0) * sc, (acc[4 * j + 2 * i + 1] + b1) * sc);
        pad_head(p, dst + 1, d + 1);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int which, d;
        const size_t c_off = qkv_col_off(p, col + c, which, d);
        const float sc = which == 0 ? p.q_scale : 1.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row0 + 8 * i >= p.M) continue;
          __nv_bfloat16* dst = p.out + c_off + row_off[i];
          *dst = __float2bfloat16((acc[4 * j + 2 * i + c] + (c ? b1 : b0)) * sc);
          pad_head(p, dst, d);
        }
      }
    }
  }
}

// Persistent: each CTA walks output tiles blockIdx.x, + gridDim.x, ...; the
// producer streams their k-tiles through one ring without a break, so the
// loads of a tile overlap the epilogue of the one before it.
template <int MODE>
__global__ void __launch_bounds__(CTA_THREADS, 1) gemm_kernel(const __grid_constant__ GemmParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sA = smem_u32(smem), sB = sA + STAGES * A_BYTES;
  const uint32_t full = sA + BAR_OFF, empty = full + 8 * STAGES;
  const int kt_n = p.K / BK, m_tiles = (p.M + BM - 1) / BM, tiles = m_tiles * (p.N / BN);
  const int wg = warpgroup_idx();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    producer_regs();
    if (threadIdx.x == CONSUMER_THREADS) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
        for (int kt = 0; kt < kt_n; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, A_BYTES + B_BYTES);
          tma_load_2d(sA + s * A_BYTES, &p.a, full + 8 * s, kt * BK, m0);
          tma_load_2d(sB + s * B_BYTES, &p.w, full + 8 * s, kt * BK, n0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64) of a tile ----
  consumer_regs();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
    for (int kt = 0; kt < kt_n; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<BN>::ss(acc, Sw128::k_major<BM>(sA + s * A_BYTES, 64 * wg, kk),
                      Sw128::k_major<BN>(sB + s * B_BYTES, 0, kk), kt > 0 || kk > 0);
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();  // the previous stage's products are done with it
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    epilogue<MODE>(p, acc, m0 + 64 * wg + 16 * warp + lane / 4, n0, lane);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <int MODE>
cudaError_t launch_gemm(const GemmParams& g, cudaStream_t st) {
  static bool sized = false;  // the attribute holds for the process
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int tiles = (g.N / BN) * ((g.M + BM - 1) / BM), sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  gemm_kernel<MODE><<<tiles < sms ? tiles : sms, CTA_THREADS, GEMM_SMEM, st>>>(g);
  return cudaGetLastError();
}

// ---- attention: the flash forward at the padded head dim HDP ----

template <int HDP>
cudaError_t attention(const __nv_bfloat16* qkv, __nv_bfloat16* attn, int B, int n, int nh, int hd,
                      cudaStream_t st) {
  using S = ddmi_flash::FwdShape<HDP>;
  const int bh = B * nh;
  const size_t plane = (size_t)bh * n * HDP;
  ddmi_flash::FwdParams a{};
  if (!ddmi_tma::tensor_map(&a.q, qkv, HDP, n, bh, S::BM) ||
      !ddmi_tma::tensor_map(&a.k, qkv + plane, HDP, n, bh, S::BN) ||
      !ddmi_tma::tensor_map(&a.v, qkv + 2 * plane, HDP, n, bh, S::BN))
    return cudaErrorInvalidValue;
  // token-major (B, n, C): head h's columns start at h * hd of each row
  a.out = attn;
  a.o_sb = (long long)n * nh * hd;
  a.o_sh = hd;
  a.o_sr = (long long)nh * hd;
  a.nh = nh;
  a.o_cols = hd;
  a.o_pairs = hd % 2 == 0;
  a.lse = nullptr;
  a.n = n;
  a.scale_log2 = LOG2E;  // q already carries the softmax scale
  return ddmi_flash::launch_fwd<HDP>(a, bh, st);
}

int head_dim_instance(int hd) { return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

}  // namespace

extern "C" {

// x, out: (B, n, C) bf16; gn_w, gn_b: (C,); w_qkv: the qkv Conv1d weight
// (3C, C[, 1]) bf16 with head-major output channels (head, {q, k, v}, dim);
// b_qkv: (3C,); w_proj: the proj Conv1d weight (C, C[, 1]) bf16; b_proj:
// (C,).  The four vectors are all bf16 (vec_f32 = 0) or all fp32 (1).
// Scratch: h (B*n, C), qkv (3, B, nh, n, hd'), attn (B*n, C), bf16, with
// hd' = the next of 16, 32, 64, 128 above C / nh.  Takes C % 128 == 0,
// C / nh <= 128, (C / G) % 4 == 0 and any n >= 1.  Four launches; returns
// the first cudaError_t.
int ddmi_attn_block(const void* x, const void* gn_w, const void* gn_b, const void* w_qkv,
                    const void* b_qkv, const void* w_proj, const void* b_proj, void* h, void* qkv,
                    void* attn, void* out, int B, int n, int C, int nh, int G, float eps,
                    float sm_scale, int vec_f32, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * n, hd = C / nh;
  if (n < 1 || hd * nh != C || C % 128 || hd > 128 || C % G || (C / G) % 4) return cudaErrorInvalidValue;
  const int hdp = head_dim_instance(hd);

  GnParams gn{static_cast<const __nv_bfloat16*>(x), gn_w, gn_b, static_cast<__nv_bfloat16*>(h),
              n, C, G, vec_f32, eps};
  group_norm_kernel<<<dim3(G, B), GN_THREADS, 0, st>>>(gn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmParams g{};
  if (!ddmi_tma::matrix_map(&g.a, h, M, C, BM) || !ddmi_tma::matrix_map(&g.w, w_qkv, 3 * C, C, BN))
    return cudaErrorInvalidValue;
  g.bias = b_qkv;
  g.out = static_cast<__nv_bfloat16*>(qkv);
  g.M = M; g.N = 3 * C; g.K = C; g.n_tok = n; g.nh = nh; g.hd = hd; g.hdp = hdp;
  g.vec_f32 = vec_f32;
  g.q_scale = sm_scale;
  err = launch_gemm<MODE_QKV>(g, st);
  if (err != cudaSuccess) return err;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* a = static_cast<__nv_bfloat16*>(attn);
  switch (hdp) {
    case 16: err = attention<16>(q, a, B, n, nh, hd, st); break;
    case 32: err = attention<32>(q, a, B, n, nh, hd, st); break;
    case 64: err = attention<64>(q, a, B, n, nh, hd, st); break;
    default: err = attention<128>(q, a, B, n, nh, hd, st); break;
  }
  if (err != cudaSuccess) return err;

  GemmParams pr{};
  if (!ddmi_tma::matrix_map(&pr.a, attn, M, C, BM) || !ddmi_tma::matrix_map(&pr.w, w_proj, C, C, BN))
    return cudaErrorInvalidValue;
  pr.bias = b_proj;
  pr.res = static_cast<const __nv_bfloat16*>(x);
  pr.out = static_cast<__nv_bfloat16*>(out);
  pr.M = M; pr.N = C; pr.K = C; pr.n_tok = n; pr.nh = nh; pr.hd = hd; pr.hdp = hdp;
  pr.vec_f32 = vec_f32;
  pr.q_scale = 1.0f;
  return launch_gemm<MODE_PROJ>(pr, st);
}

// The dynamic shared memory of a GEMM launch, for the build report.
int ddmi_attn_block_gemm_smem() { return (int)GEMM_SMEM; }

}  // extern "C"
