// Fused NeRF MLP for Hopper (sm_90a): the whole INRNeRF per tile of points.
//
// Replaces the TPU kernel ddmi_tpu/ops/pallas/nerf_mlp.py::nerf_mlp_fused
// (body `_kernel`).  Per point, on the weights of fold_nerf_params
// (ops/nerf_mlp.py, the JAX layout):
//   trunk  h = bf16(leaky_0.01(xp . WX[i] (i == 0 and skips) + h . WH[i] + b[i])), D layers
//   sigma  = h . w_sig + b_sig                          (fp32)
//   feat   = bf16(h . w_fin + b_fin)
//   d      = bf16(leaky_0.01(feat . w_dirf + dir . w_dird + b_dir)), 128 wide
//   rgb    = sigmoid(d . w_rgb + b_rgb)
// out (N, 4) fp32 = [rgb, sigma].  Sums are fp32 on bf16 operands; the
// biases are the folded bf16 values.
//
// What bounds it on the card: 1.1 MFLOP per point at the srn_cars widths
// (W 256, D 6, skips 2 and 4) against 388 bytes of input and output, about
// 2,800 FLOP per byte: the tensor cores, not device memory.  Unfused, each
// of the 11 matmuls would write and read its (N, 256) activation through
// device memory.  Here one block owns a 64-point tile and keeps h in shared
// memory through the whole network, so device memory sees one read of x and
// one write of (N, 4).  The TPU kernel's lane padding is gone: the block
// reads the 159 xyz and 27 dir columns straight from x into shared memory,
// zero-padded to the WMMA depth of 16 (160 and 32), and rows past N are
// zero and never written.  The 1.1 MB of bf16 weights do not fit in shared
// memory; each warp owns 32 of the 256 output columns, so a block reads
// every weight exactly once per layer, in 16-row k-steps from L2 straight
// into WMMA fragments.  Each layer's sums stay in registers until every warp
// has read h; then bias, LeakyReLU and the bf16 rounding run per fragment
// through a small per-warp scratch and overwrite h in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int T = 64;            // points per block
constexpr int W = 256;           // trunk width (the kernel's predicate)
constexpr int LANE = 128;        // columns of the folded head weights; W / 2
constexpr int THREADS = 256;     // 8 warps; warp w owns trunk columns [32w, 32w + 32)
constexpr int NWARP = THREADS / 32;
constexpr int RF = T / 16;       // row fragments per warp
constexpr int H_LD = W + 8;      // bf16 elements
constexpr float SLOPE = 0.01f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Params {
  const __nv_bfloat16* x;       // (N, in_xyz + in_dir)
  const __nv_bfloat16* wx;      // (D, XP, W) xyz-side kernels
  const __nv_bfloat16* wh;      // (D, W, W) h-side kernels
  const __nv_bfloat16* b;       // (D, W)
  const __nv_bfloat16* w_sig;   // (W, LANE), column 0 live
  const __nv_bfloat16* b_sig;   // (LANE,)
  const __nv_bfloat16* w_fin;   // (W, W)
  const __nv_bfloat16* b_fin;   // (W,)
  const __nv_bfloat16* w_dirf;  // (W, LANE)
  const __nv_bfloat16* w_dird;  // (DP, LANE), rows [0, in_dir) live
  const __nv_bfloat16* b_dir;   // (LANE,)
  const __nv_bfloat16* w_rgb;   // (LANE, LANE), columns 0..2 live
  const __nv_bfloat16* b_rgb;   // (LANE,)
  float* out;                   // (N, 4)
  int N, in_xyz, in_dir, XP, depth;
  unsigned skip_mask;           // bit i: layer i takes the xyz input too
  int XK, DK;                   // in_xyz, in_dir rounded up to 16
};

__host__ __device__ constexpr size_t smem_bytes(int XK, int DK) {
  return (size_t)T * H_LD * 2 + (size_t)T * (XK + 8) * 2 + (size_t)T * (DK + 8) * 2 +
         (size_t)NWARP * 256 * 4 + (size_t)T * 4;
}

template <int NC>
__device__ __forceinline__ void zero(FragC (&acc)[RF][NC]) {
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc[:, j] += A[0:T, 0:K] . B[0:K, c0 + 16j : c0 + 16j + 16]; A in shared
// memory, B in device memory (row-major, leading dimension ldb).
template <int NC>
__device__ __forceinline__ void mma_tile(FragC (&acc)[RF][NC], const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* __restrict__ B, int ldb, int K,
                                         int c0) {
  for (int k = 0; k < K; k += 16) {
    FragB bf[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j)
      wmma::load_matrix_sync(bf[j], B + (size_t)k * ldb + c0 + 16 * j, ldb);
#pragma unroll
    for (int i = 0; i < RF; ++i) {
      FragA af;
      wmma::load_matrix_sync(af, A + 16 * i * lda + k, lda);
#pragma unroll
      for (int j = 0; j < NC; ++j) wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
    }
  }
}

// One row fragment of A (rows r0..r0+15) times the first 16 columns of B.
__device__ __forceinline__ void mma_row(FragC& acc, const __nv_bfloat16* A, int lda,
                                        const __nv_bfloat16* __restrict__ B, int ldb, int K) {
  wmma::fill_fragment(acc, 0.0f);
  for (int k = 0; k < K; k += 16) {
    FragA af;
    FragB bf;
    wmma::load_matrix_sync(af, A + k, lda);
    wmma::load_matrix_sync(bf, B + (size_t)k * ldb, ldb);
    wmma::mma_sync(acc, af, bf, acc);
  }
}

// dst[:, c0 + 16j + c] = bf16(act(acc + bias)), one fragment at a time
// through the warp's scratch.
template <int NC, bool ACT>
__device__ __forceinline__ void epilogue(FragC (&acc)[RF][NC], float* scr,
                                         const __nv_bfloat16* __restrict__ bias,
                                         __nv_bfloat16* dst, int c0, int lane) {
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int c = c0 + 16 * j;
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, cc = e & 15;
        float v = scr[e] + __bfloat162float(bias[c + cc]);
        if (ACT) v = v > 0.0f ? v : SLOPE * v;
        dst[(16 * i + r) * H_LD + c + cc] = __float2bfloat16(v);
      }
      __syncwarp();
    }
}

__global__ void __launch_bounds__(THREADS, 2) nerf_mlp_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int xld = p.XK + 8, dld = p.DK + 8;
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem);  // (T, H_LD): h, feat, d
  __nv_bfloat16* XS = H + T * H_LD;                           // (T, xld): xyz input
  __nv_bfloat16* DS = XS + T * xld;                           // (T, dld): dir input
  float* SCR = reinterpret_cast<float*>(DS + T * dld);        // (NWARP, 16 * 16)
  float* SIG = SCR + NWARP * 256;                             // (T,)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scr = SCR + warp * 256;
  const long row0 = (long)blockIdx.x * T;
  const int C = p.in_xyz + p.in_dir;
  const long left = (long)p.N - row0;
  const int rows = left < T ? (int)left : T;

  // the tile's inputs, zero-padded to the WMMA depth; rows past N stay zero
  const __nv_bfloat16 bz = __float2bfloat16(0.0f);
  for (int e = threadIdx.x; e < T * xld; e += THREADS) XS[e] = bz;
  for (int e = threadIdx.x; e < T * dld; e += THREADS) DS[e] = bz;
  __syncthreads();
  const __nv_bfloat16* xt = p.x + row0 * C;
  for (int e = threadIdx.x; e < rows * C; e += THREADS) {
    const int r = e / C, c = e % C;
    if (c < p.in_xyz) XS[r * xld + c] = xt[e];
    else DS[r * dld + c - p.in_xyz] = xt[e];
  }
  __syncthreads();

  const int c0 = warp * 32;
  FragC acc[RF][2];
  for (int i = 0; i < p.depth; ++i) {
    zero(acc);
    if (i == 0 || ((p.skip_mask >> i) & 1u))
      mma_tile<2>(acc, XS, xld, p.wx + (size_t)i * p.XP * W, W, p.XK, c0);
    if (i > 0) mma_tile<2>(acc, H, H_LD, p.wh + (size_t)i * W * W, W, W, c0);
    __syncthreads();  // every warp has read h
    epilogue<2, true>(acc, scr, p.b + (size_t)i * W, H, c0, lane);
    __syncthreads();
  }

  // sigma (warp w < RF: rows 16w..16w+15) and feat (all warps) from h
  zero(acc);
  mma_tile<2>(acc, H, H_LD, p.w_fin, W, W, c0);
  FragC s;
  if (warp < RF) mma_row(s, H + 16 * warp * H_LD, H_LD, p.w_sig, LANE, W);
  __syncthreads();
  if (warp < RF) {
    wmma::store_matrix_sync(scr, s, 16, wmma::mem_row_major);
    __syncwarp();
    if (lane < 16) SIG[16 * warp + lane] = scr[lane * 16] + __bfloat162float(p.b_sig[0]);
    __syncwarp();
  }
  epilogue<2, false>(acc, scr, p.b_fin, H, c0, lane);  // feat replaces h
  __syncthreads();

  // d: warp w owns dir-head columns [16w, 16w + 16)
  FragC dacc[RF][1];
  zero(dacc);
  mma_tile<1>(dacc, H, H_LD, p.w_dirf, LANE, W, warp * 16);
  mma_tile<1>(dacc, DS, dld, p.w_dird, LANE, p.DK, warp * 16);
  __syncthreads();
  epilogue<1, true>(dacc, scr, p.b_dir, H, warp * 16, lane);  // d into H[:, 0:128]
  __syncthreads();

  if (warp < RF) {
    mma_row(s, H + 16 * warp * H_LD, H_LD, p.w_rgb, LANE, LANE);
    wmma::store_matrix_sync(scr, s, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 64; e += 32) {
      const int r = e >> 2, c = e & 3;
      const long row = row0 + 16 * warp + r;
      if (row < p.N) {
        const float v = c < 3
            ? 1.0f / (1.0f + expf(-(scr[r * 16 + c] + __bfloat162float(p.b_rgb[c]))))
            : SIG[16 * warp + r];
        p.out[row * 4 + c] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// x (N, in_xyz + in_dir) bf16; the folded weights of ops/nerf_mlp.py
// (bf16, width 256, XP = in_xyz padded to a multiple of 128); out (N, 4)
// fp32.  Returns the cudaError_t of the launch.
int ddmi_nerf_mlp(const void* x, const void* wx, const void* wh, const void* b,
                  const void* w_sig, const void* b_sig, const void* w_fin, const void* b_fin,
                  const void* w_dirf, const void* w_dird, const void* b_dir, const void* w_rgb,
                  const void* b_rgb, void* out, int N, int in_xyz, int in_dir, int XP, int depth,
                  unsigned int skip_mask, void* stream) {
  using bf = const __nv_bfloat16*;
  Params p;
  p.x = static_cast<bf>(x);
  p.wx = static_cast<bf>(wx);
  p.wh = static_cast<bf>(wh);
  p.b = static_cast<bf>(b);
  p.w_sig = static_cast<bf>(w_sig);
  p.b_sig = static_cast<bf>(b_sig);
  p.w_fin = static_cast<bf>(w_fin);
  p.b_fin = static_cast<bf>(b_fin);
  p.w_dirf = static_cast<bf>(w_dirf);
  p.w_dird = static_cast<bf>(w_dird);
  p.b_dir = static_cast<bf>(b_dir);
  p.w_rgb = static_cast<bf>(w_rgb);
  p.b_rgb = static_cast<bf>(b_rgb);
  p.out = static_cast<float*>(out);
  p.N = N;
  p.in_xyz = in_xyz;
  p.in_dir = in_dir;
  p.XP = XP;
  p.depth = depth;
  p.skip_mask = skip_mask;
  p.XK = (in_xyz + 15) / 16 * 16;
  p.DK = (in_dir + 15) / 16 * 16;
  const size_t smem = smem_bytes(p.XK, p.DK);
  if (N <= 0 || p.XK > XP || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(nerf_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + T - 1) / T);
  nerf_mlp_kernel<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
