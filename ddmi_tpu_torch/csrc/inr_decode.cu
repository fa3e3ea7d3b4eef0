// Fused styled-INR render for Hopper (sm_90a): the whole INRImage MLP per
// 128-token tile on style-folded weights.
//
// Replaces the TPU kernel ddmi_tpu/ops/pallas/inr_decode.py::inr_decode_fused
// (body `_make_kernel`).  Per token, on the weights of
// ops/inr_decode.py::fold_inr_image_params (wa (14, 256, 256), wb (6, 128,
// 256), both (K, N) row-major): 4 StyledResBlocks and ToRGB, 13 products of
// 256 x 256 and 6 of 128 x 256; after each styled product bias + optional
// noise, LeakyReLU(0.2) * sqrt(2); after each block a residual * 1/sqrt(2)
// rounded once to bf16.  Sums are fp32 on bf16 operands.
//
// What bounds it on the card: 2.1 MFLOP per token against 768 bytes of
// tokens in and a few bytes of pixels out: the tensor cores, if the 2.1 MB
// of folded weights reach them fast enough.  They do not fit in shared
// memory, so every tile of tokens streams all of them from L2, and the
// tile's size sets the L2 traffic per token.  The design (nerf_mlp.cu's):
//   * a persistent grid (one CTA per SM) of 128-token tiles, 64 rows per
//     consumer warpgroup: one weight slab serves 128 tokens, so a launch
//     over N tokens reads N / 128 x 2.1 MB from L2 (8.6 GB at N = 524,288;
//     the 64-token WMMA kernel before it read 17 GB, and loaded every B
//     fragment straight from L2 into registers);
//   * the weights stream through a ring of 32-row x 256-column bf16 slabs
//     (16 KB) filled by TMA from the fold's own (K, N) tensors, which are
//     wgmma's MN-major B operand as they lie, 128-byte swizzled, on
//     full/empty mbarriers; one producer warp walks the same slab sequence
//     as the consumers, tile after tile, so the ring never drains between
//     products or tiles;
//   * the activations stay in shared memory in the K-major swizzled layout
//     wgmma reads as its A operand: h (the block input, which the skip
//     product still needs), a (the chain a1 -> a2, overwritten after each
//     product) and the block's token rows x0 / xm / xh, which each
//     warpgroup loads for its own 64 rows by TMA once the previous block's
//     skip products are done with them (rows past N read as zeros);
//   * two consumer warpgroups run wgmma m64n256k16 into one fp32
//     accumulator of 128 registers a thread (setmaxnreg 232); the skip
//     products (wb[s] . x, and wa[s] . h in blocks 2-3) accumulate onto the
//     styled fp32 a3 in the same registers, then the sum is multiplied by
//     1/sqrt(2) and rounded once, as the plain version adds a3 and s in
//     fp32; block 4's identity skip adds h from shared memory;
//   * ToRGB (out_ch <= 16 live columns of wa[13], kept in shared memory) is
//     a dot product on the last epilogue's registers, summed over the four
//     lanes that share a row.
// Shared memory: h 64 KB + a 64 KB + x 32 KB + a ring of 16 KB slabs (4
// stages at out_ch <= 3, 3 at out_ch 16) + ToRGB columns, under 227 KB.
//
// NoiseInjection (x + w * N(0, 1), one draw per token and conv) comes from a
// counter-based Philox4x32-10 keyed by (seed, token, conv), then Box-Muller;
// ops/inr_decode.py::philox_normal gives the same draws on any device.  It
// is statistically the JAX noise, bit-different.  With every gain 0 the
// noise path is compiled out (NOISE = false), as in the JAX kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using namespace ddmi_sm90;

constexpr int T = 128;                  // tokens per tile: 64 per consumer warpgroup
constexpr int CHP = 256;                // hidden width
constexpr int INP = 128;                // token width (latent + in_ch, zero-padded)
constexpr int NWA = 14, NWB = 6;        // the fold's weight slots
constexpr int MAX_OUT_CH = 16;
constexpr int SLAB_ROWS = 32;           // K rows of a weight slab: two k-steps
constexpr int PANEL = SLAB_ROWS * 128;  // one 64-column panel of a slab: 4 KB
constexpr int SLAB = 4 * PANEL;         // a 32 x 256 slab: 16 KB
constexpr int MAX_STAGES = 8;
constexpr int ACT_PANEL = T * 128;      // one 64-column panel of a tile's activations: 16 KB
constexpr int H_BYTES = 4 * ACT_PANEL;  // h, a: 128 x 256
constexpr int X_BYTES = 2 * ACT_PANEL;  // x: 128 x 128
constexpr int X_HALF = 2 * 64 * 128;    // one warpgroup's 64 rows of x
constexpr int RING_OFF = 2 * H_BYTES + X_BYTES;
constexpr int MAX_SMEM = 232448;        // what a block may use
constexpr int BAR_BYTES = 256;
constexpr uint32_t NOISE_KEY = 0x85EBCA6Bu;
constexpr float SQRT2 = 1.41421356237309515f;
constexpr float INV_SQRT2 = 0.70710678118654757f;

struct Params {
  CUtensorMap wa, wb;        // (14 * 256, 256), (6 * 128, 256): 32-row x 64-column boxes
  CUtensorMap x0, xm, xh;    // (N, 128) tokens: 64-row x 64-column boxes
  const __nv_bfloat16* w_rgb;  // wa[13], (256, 256), columns 0..out_ch live
  const float* act_bias;     // (12, 256)
  const float* noise_w;      // (12,)
  const float* rgb_bias;     // (256,)
  __nv_bfloat16* out;        // (N, out_ch)
  int N, out_ch, stages, tiles;
  uint32_t seed;
};

// h, a, x, the ring, the barriers, the ToRGB columns; offsets from a
// 1024-byte aligned base
__host__ __device__ constexpr int bar_off(int stages) { return RING_OFF + stages * SLAB; }
__host__ __device__ constexpr int rgb_off(int stages) { return bar_off(stages) + BAR_BYTES; }
__host__ __device__ constexpr size_t smem_bytes(int stages, int out_ch) {
  return (size_t)rgb_off(stages) + out_ch * CHP * 2 + 1024;
}
__host__ __device__ constexpr int ring_stages(int out_ch) {
  return (MAX_SMEM - (int)smem_bytes(0, out_ch)) / SLAB > MAX_STAGES
             ? MAX_STAGES
             : (MAX_SMEM - (int)smem_bytes(0, out_ch)) / SLAB;
}

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

// w * N(0, 1) of token `tok`, conv k: Box-Muller on the counter (tok, k)
__device__ __forceinline__ float noise(uint32_t seed, uint32_t tok, int k, float w) {
  const uint4 bits = philox4x32_10(make_uint4(tok, (uint32_t)k, 0u, 0u), make_uint2(seed, NOISE_KEY));
  const float u1 = ((bits.x >> 8) + 1u) * (1.0f / 16777216.0f);  // (0, 1]
  const float u2 = (bits.y >> 8) * (1.0f / 16777216.0f);         // [0, 1)
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958648f * u2) * w;
}

// the ring as a consumer sees it: the slab count so far and the stage whose
// products may still be reading it
struct Ring {
  uint32_t base, full, empty;
  int stages, it, pending;
};

// acc (+)= A[:, 0 : 32 nslabs] . the ring's next nslabs slabs, for this
// warpgroup's 64 rows of the activation tile at a_tile; `first` starts the
// sums at zero.  A stage is released once the products of the stage after
// it are issued.
__device__ __forceinline__ void mma_slabs(float (&acc)[CHP / 2], Ring& r, uint32_t a_tile, int nslabs,
                                          bool first, int cw, int lane) {
  for (int i = 0; i < nslabs; ++i) {
    const int s = r.it % r.stages;
    mbar_wait(r.full + 8 * s, (r.it / r.stages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SLAB_ROWS / 16; ++kk)
      Wgmma<CHP>::ss_mn(acc, Sw128::k_major<T>(a_tile, 64 * cw, 2 * i + kk),
                        Sw128::mn_major<SLAB_ROWS>(r.base + s * SLAB, kk),
                        (first && i == 0 && kk == 0) ? 0 : 1);
    wgmma_commit();
    if (r.pending >= 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(r.empty + 8 * r.pending);
    }
    r.pending = s;
    ++r.it;
  }
}

__device__ __forceinline__ void mma_drain(float (&acc)[CHP / 2], Ring& r, int lane) {
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(r.empty + 8 * r.pending);
  r.pending = -1;
}

// the two values of a packed bf16 pair, exactly, as fp32
__device__ __forceinline__ float2 unpack_bf16(uint32_t h) {
  return make_float2(__uint_as_float(h << 16), __uint_as_float(h & 0xffff0000u));
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"((unsigned short)v) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float act(float z) { return (z >= 0.0f ? z : 0.2f * z) * SQRT2; }

// Accumulator d[4j + 2i + c] is row 16 warp + lane / 4 + 8i of the
// warpgroup's 64 and column 8j + 2 (lane % 4) + c; both rows share their
// phase in the 8-row swizzle atom, so the pair's shared address in an
// activation tile is o8[j % 8] (the row and its swizzled 16-byte chunk) plus
// constants: (j / 8) panels and 8i rows.
__device__ __forceinline__ uint32_t pair_off(const uint32_t (&o8)[8], int j, int i) {
  return o8[j % 8] + (j / 8) * ACT_PANEL + i * 1024;
}

// conv k's NoiseInjection and FusedLeakyReLU on the sums: to bf16 in the
// activation tile at dst (STORE), or in place in fp32
template <bool NOISE, bool STORE>
__device__ __forceinline__ void styled(float (&acc)[CHP / 2], const Params& p, int k, uint32_t tok,
                                       uint32_t dst, const uint32_t (&o8)[8], int col0) {
  float g[2] = {0.0f, 0.0f};
  if (NOISE) {
    const float w = __ldg(p.noise_w + k);
    g[0] = noise(p.seed, tok, k, w);
    g[1] = noise(p.seed, tok + 8, k, w);
  }
  const float2* bias = reinterpret_cast<const float2*>(p.act_bias + k * CHP + col0);
#pragma unroll
  for (int j = 0; j < CHP / 8; ++j) {
    const float2 b = __ldg(bias + 4 * j);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (NOISE) {
        v0 += g[i];
        v1 += g[i];
      }
      v0 = act(v0 + b.x);
      v1 = act(v1 + b.y);
      if (STORE) {
        sts32(dst + pair_off(o8, j, i), pack_bf16(v0, v1));
      } else {
        acc[4 * j + 2 * i] = v0;
        acc[4 * j + 2 * i + 1] = v1;
      }
    }
  }
}

// h = bf16((a3 + skip products) / sqrt(2)), summed in acc, into h's tile
__device__ __forceinline__ void residual(const float (&acc)[CHP / 2], uint32_t sH, const uint32_t (&o8)[8]) {
#pragma unroll
  for (int j = 0; j < CHP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sts32(sH + pair_off(o8, j, i),
            pack_bf16(acc[4 * j + 2 * i] * INV_SQRT2, acc[4 * j + 2 * i + 1] * INV_SQRT2));
}

// block 4's h = bf16((a3 + h) / sqrt(2)) and ToRGB on it: out = h . wa[13] +
// rgb_bias for the out_ch live columns, rows past N not stored
__device__ __forceinline__ void to_rgb(const float (&acc)[CHP / 2], const Params& p, uint32_t sH,
                                       uint32_t rgbw, const uint32_t (&o8)[8], int col0, long row0,
                                       int lane) {
  float rgb[2][MAX_OUT_CH];
#pragma unroll
  for (int c = 0; c < MAX_OUT_CH; ++c) rgb[0][c] = rgb[1][c] = 0.0f;
#pragma unroll
  for (int j = 0; j < CHP / 8; ++j) {
    float2 v[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 h = unpack_bf16(lds32(sH + pair_off(o8, j, i)));
      v[i] = unpack_bf16(pack_bf16((acc[4 * j + 2 * i] + h.x) * INV_SQRT2,
                                   (acc[4 * j + 2 * i + 1] + h.y) * INV_SQRT2));
    }
#pragma unroll
    for (int c = 0; c < MAX_OUT_CH; ++c) {
      if (c < p.out_ch) {
        const float2 w = unpack_bf16(lds32(rgbw + 2 * (c * CHP + 8 * j + col0)));
#pragma unroll
        for (int i = 0; i < 2; ++i) rgb[i][c] += v[i].x * w.x + v[i].y * w.y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long row = row0 + 8 * i;
#pragma unroll
    for (int c = 0; c < MAX_OUT_CH; ++c) {
      if (c < p.out_ch) {
        float s = rgb[i][c];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (lane % 4 == 0 && row < p.N)
          p.out[row * p.out_ch + c] = __float2bfloat16(s + __ldg(p.rgb_bias + c));
      }
    }
  }
}

template <bool NOISE>
__global__ void __launch_bounds__(CTA_THREADS, 1) inr_decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s0 = smem_u32(smem);
  const int st = p.stages;
  const uint32_t sH = s0, sA = s0 + H_BYTES, sX = s0 + 2 * H_BYTES;
  const uint32_t full = s0 + bar_off(st), empty = full + 8 * st, xfull = empty + 8 * st;
  const uint32_t rgbw = s0 + rgb_off(st);
  const int wg = warpgroup_idx();

  // ToRGB's live columns, one after another: rgbw[c * CHP + k] = wa[13][k][c]
  for (int e = threadIdx.x; e < p.out_ch * CHP; e += CTA_THREADS) {
    const int c = e / CHP, k = e % CHP;
    sts16(rgbw + 2 * e, __bfloat16_as_ushort(p.w_rgb[k * CHP + c]));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < st; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(xfull, 1);
    mbar_init(xfull + 8, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: the slab sequence of every tile this CTA takes ----
    producer_regs();
    if (threadIdx.x == CONSUMER_THREADS) {
      const uint32_t ring = s0 + RING_OFF;
      int it = 0;
      auto push = [&](const CUtensorMap* map, int row, int nslabs) {
        for (int k = 0; k < nslabs; ++k, ++it) {
          const int s = it % st;
          mbar_wait(empty + 8 * s, ((it / st) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, SLAB);
          for (int q = 0; q < 4; ++q)
            tma_load_2d(ring + s * SLAB + q * PANEL, map, full + 8 * s, 64 * q, row + SLAB_ROWS * k);
        }
      };
      auto wa = [&](int slot) { push(&p.wa, slot * CHP, CHP / SLAB_ROWS); };
      auto wb = [&](int slot) { push(&p.wb, slot * INP, INP / SLAB_ROWS); };
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        // the slot tables of ddmi_tpu/ops/pallas/inr_decode.py (_WA_ORDER,
        // _WB_ORDER), in the order the consumers multiply
        wb(0); wa(11); wa(12); wb(1);              // net_res1: conv1(x0), conv2, conv3, skip(x0)
        wa(0); wb(2); wa(1); wa(2); wb(3); wa(3);  // net_res2: conv1(h, xm), .., skip(xm, h)
        wa(4); wb(4); wa(5); wa(6); wb(5); wa(7);  // net_res3
        wa(8); wa(9); wa(10);                      // net_res4: identity skip
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each tile ----
  consumer_regs();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int cw = wg, bar_id = 1 + cw;
  Ring r{s0 + RING_OFF, full, empty, st, 0, -1};
  const uint32_t xbar = xfull + 8 * cw;
  uint32_t xphase = 0;
  const int lrow = 64 * cw + 16 * warp + lane / 4;  // tile row of d[.. + 0 + ..]
  const int col0 = 2 * (lane % 4), r8 = (lane / 4) % 8;
  uint32_t o8[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) o8[k] = lrow * 128 + col0 * 2 + ((k ^ r8) << 4);
  float acc[CHP / 2];

  // this warpgroup's 64 rows of a token tensor into x, from one thread; the
  // callers have made sure every product reading x is done
  auto load_x = [&](const CUtensorMap* map, int tile) {
    if (tid == 0) {
      mbar_expect_tx(xbar, X_HALF);
      for (int q = 0; q < 2; ++q)
        tma_load_2d(sX + q * ACT_PANEL + 64 * cw * 128, map, xbar, 64 * q, tile * T + 64 * cw);
    }
  };
  auto wait_x = [&]() {
    mbar_wait(xbar, xphase);
    xphase ^= 1;
  };
  // the products of the last call are done: wait, and let every warp of
  // the warpgroup get there before the epilogue overwrites what they read
  auto finish = [&]() {
    mma_drain(acc, r, lane);
    named_sync(bar_id, 128);
  };
  auto stored = [&]() {  // the epilogue's stores, before the next products read them
    fence_async_smem();
    named_sync(bar_id, 128);
  };

  load_x(&p.x0, blockIdx.x);
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const uint32_t tok = (uint32_t)(tile * T + lrow);
    for (int b = 0; b < 3; ++b) {  // net_res1..3: conv1 and skip also take x0, xm, xh
      const int k0 = 3 * b;
      if (b == 0) {
        wait_x();
        mma_slabs(acc, r, sX, INP / SLAB_ROWS, true, cw, lane);
      } else {
        mma_slabs(acc, r, sH, CHP / SLAB_ROWS, true, cw, lane);
        wait_x();
        mma_slabs(acc, r, sX, INP / SLAB_ROWS, false, cw, lane);
      }
      finish();
      styled<NOISE, true>(acc, p, k0, tok, sA, o8, col0);
      stored();
      mma_slabs(acc, r, sA, CHP / SLAB_ROWS, true, cw, lane);
      finish();
      styled<NOISE, true>(acc, p, k0 + 1, tok, sA, o8, col0);
      stored();
      mma_slabs(acc, r, sA, CHP / SLAB_ROWS, true, cw, lane);
      mma_drain(acc, r, lane);
      styled<NOISE, false>(acc, p, k0 + 2, tok, 0, o8, col0);
      mma_slabs(acc, r, sX, INP / SLAB_ROWS, false, cw, lane);  // skip products onto a3
      if (b > 0) mma_slabs(acc, r, sH, CHP / SLAB_ROWS, false, cw, lane);
      finish();
      if (b < 2)
        load_x(b == 0 ? &p.xm : &p.xh, tile);
      else if (tile + (int)gridDim.x < p.tiles)
        load_x(&p.x0, tile + gridDim.x);
      residual(acc, sH, o8);
      stored();
    }
    // net_res4
    mma_slabs(acc, r, sH, CHP / SLAB_ROWS, true, cw, lane);
    finish();
    styled<NOISE, true>(acc, p, 9, tok, sA, o8, col0);
    stored();
    mma_slabs(acc, r, sA, CHP / SLAB_ROWS, true, cw, lane);
    finish();
    styled<NOISE, true>(acc, p, 10, tok, sA, o8, col0);
    stored();
    mma_slabs(acc, r, sA, CHP / SLAB_ROWS, true, cw, lane);
    mma_drain(acc, r, lane);
    styled<NOISE, false>(acc, p, 11, tok, 0, o8, col0);
    to_rgb(acc, p, sH, rgbw, o8, col0, (long)tile * T + lrow, lane);
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

template <bool NOISE>
cudaError_t launch(const Params& p, int grid, size_t smem, cudaStream_t st) {
  static bool sized = false;  // the attribute holds for the process
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(inr_decode_kernel<NOISE>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  inr_decode_kernel<NOISE><<<grid, CTA_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x0/xm/xh: (N, 128) bf16, contiguous, 16-byte aligned, any N >= 1; wa
// (14, 256, 256) bf16; wb (6, 128, 256) bf16; act_bias (12, 256) fp32;
// noise_w (12,) fp32; rgb_bias (256,) fp32; out (N, out_ch) bf16, 1 <=
// out_ch <= 16.  Returns the cudaError_t of the launch.
int ddmi_inr_decode(const void* x0, const void* xm, const void* xh, const void* wa,
                    const void* wb, const void* act_bias, const void* noise_w,
                    const void* rgb_bias, void* out, int N, int out_ch, int has_noise,
                    unsigned int seed, void* stream) {
  if (N < 1 || out_ch < 1 || out_ch > MAX_OUT_CH || reinterpret_cast<uintptr_t>(act_bias) % 8)
    return (int)cudaErrorInvalidValue;
  Params p{};
  if (!ddmi_tma::matrix_map(&p.wa, wa, (long long)NWA * CHP, CHP, SLAB_ROWS) ||
      !ddmi_tma::matrix_map(&p.wb, wb, (long long)NWB * INP, CHP, SLAB_ROWS) ||
      !ddmi_tma::matrix_map(&p.x0, x0, N, INP, 64) || !ddmi_tma::matrix_map(&p.xm, xm, N, INP, 64) ||
      !ddmi_tma::matrix_map(&p.xh, xh, N, INP, 64))
    return (int)cudaErrorInvalidValue;
  p.w_rgb = static_cast<const __nv_bfloat16*>(wa) + (size_t)13 * CHP * CHP;
  p.act_bias = static_cast<const float*>(act_bias);
  p.noise_w = static_cast<const float*>(noise_w);
  p.rgb_bias = static_cast<const float*>(rgb_bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.N = N;
  p.out_ch = out_ch;
  p.stages = ring_stages(out_ch);
  p.tiles = (N + T - 1) / T;
  p.seed = seed;
  const int sms = sm_count();
  if (sms <= 0 || p.stages < 2) return (int)cudaErrorInvalidValue;
  const int grid = p.tiles < sms ? p.tiles : sms;
  const size_t smem = smem_bytes(p.stages, out_ch);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(has_noise ? launch<true>(p, grid, smem, st) : launch<false>(p, grid, smem, st));
}

// The dynamic shared memory and ring stages of a launch at out_ch, for the
// build report: bytes * 8 + stages.
int ddmi_inr_decode_smem(int out_ch) {
  return (int)smem_bytes(ring_stages(out_ch), out_ch) * 8 + ring_stages(out_ch);
}

}  // extern "C"
