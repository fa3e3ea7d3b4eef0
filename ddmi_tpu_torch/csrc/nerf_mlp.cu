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
// (W 256, D 6, skips 2 and 4) against 388 bytes of input and output: the
// tensor cores.  The 1.1 MB of bf16 weights do not fit in shared memory, so
// every tile of points streams all of them from L2; the tile's size sets
// the L2 traffic per point, and the tensor-core rate is reached only with
// wgmma fed from shared memory.  The design:
//   * a 128-point tile, 64 rows per consumer warpgroup: one weight slab
//     serves 128 points (1.1 MB of L2 reads per tile, 8.6 KB per point);
//   * the weights stream through a ring of 32-row x 256-column bf16 slabs
//     (16 KB; the 128-wide direction head uses half) filled by TMA from the
//     folded (K, N) row-major arrays, 128-byte swizzled, on full/empty
//     mbarriers; one producer warp walks the same slab sequence as the
//     consumers, tile after tile, so the ring never drains between layers
//     or tiles (the grid is persistent: one CTA per SM).  The consumers
//     hold at most two slabs (the one being multiplied and the one before
//     it, whose products may still run), so the rest of the ring is loads
//     in flight: at L2's latency the tensor cores need about 90 KB in
//     flight per SM, and 64-row slabs in a 3-stage ring left only 32 KB;
//   * the activations stay in shared memory in the K-major swizzled layout
//     wgmma reads as its A operand: h (128 x 256), the xyz input and the
//     direction input (each K padded to a multiple of 32, in 64-column
//     panels), zero in the padding; the B operand is the slab, MN-major;
//   * two consumer warpgroups run wgmma m64n256k16 (m64n128k16 for the
//     direction head) into fp32 accumulators in registers (setmaxnreg 232);
//     a skip layer accumulates xp . WX and h . WH into the same sums;
//   * the epilogue adds the bias, applies LeakyReLU(0.01) and rounds to bf16
//     on the accumulator registers, and writes the new h into shared memory
//     after every warp of its warpgroup has finished reading the old one (a
//     named barrier; each warpgroup owns its 64 rows of every buffer).  The
//     tensor cores wait through it, so it is kept to about ten instructions
//     per pair of values: one rounding, and st.shared at eight per-thread
//     swizzled base addresses plus constant offsets;
//   * sigma (one output) is a dot product of the last trunk layer's rounded
//     h with w_sig's column 0 on the registers of that epilogue, summed over
//     the four lanes that share a row; rgb (three outputs) likewise from d.
// Shared memory, at srn_cars' 159 xyz and 27 dir inputs: h 64 KB + xyz 48
// KB (three 64-column panels) + dir 16 KB + a 6-stage ring of 96 KB = 224
// KB, with the heads' 1.25 KB of live sigma and rgb weight columns and the
// barriers under the 227 KB a block may use.  Each further input panel
// takes one stage from the ring; at MAX_PANELS input panels (in_xyz +
// in_dir up to about 512) two stages are left, the least that runs.  The
// tile's x rows (372 bytes each, not 16-byte aligned, so not a TMA source)
// are read by the consumers themselves.
// Wider inputs run the kernel's CHUNKED instance: one buffer of
// CHUNK_PANELS input panels (256 columns, leaving the 6-stage ring) takes
// the xyz input a chunk at a time at every layer that reads it, and then
// the dir input, each chunk's products drained before the next chunk is
// read into the buffer (by cp.async, its bf16 pairs all in flight at
// once).  The weight slabs stream in the same order as in the resident
// instance, so the producer does not change; the consumers read x once per
// input layer instead of once per tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using namespace ddmi_sm90;

constexpr int T = 128;                  // points per tile: 64 per consumer warpgroup
constexpr int W = 256;                  // trunk width (the kernel's predicate)
constexpr int LANE = 128;               // columns of the folded head weights; W / 2
constexpr int SLAB_ROWS = 32;           // K rows of a weight slab: two k-steps
constexpr int PANEL = SLAB_ROWS * 128;  // one 64-column panel of a slab: 4 KB
constexpr int SLAB = 4 * PANEL;         // a 32 x 256 slab: 16 KB
constexpr int MAX_STAGES = 8;
constexpr int MAX_PANELS = 8;           // xyz + dir input panels: what leaves two stages
constexpr int CHUNK_PANELS = 4;         // the input buffer of the CHUNKED instance
constexpr int ACT_PANEL = T * 128;      // one 64-column panel of a tile's activations: 16 KB
constexpr int H_BYTES = 4 * ACT_PANEL;  // h, feat: 128 x 256
constexpr int MAX_SMEM = 232448;        // what a block may use
constexpr int BAR_BYTES = 128;
constexpr int HW_BYTES = (W + 3 * LANE) * 2;  // w_sig's column 0 and w_rgb's columns 0..2
constexpr int X_BATCH = 24;             // input loads in flight per thread
constexpr int CHUNK_BATCH = 8;          // the same in the CHUNKED instance's 2-byte loads
constexpr float SLOPE = 0.01f;

struct Params {
  CUtensorMap wx, wh, w_fin, w_dirf, w_dird;  // 32-row x 64-column boxes, 128-byte swizzle
  const __nv_bfloat16* x;                     // (N, in_xyz + in_dir), C even, 4-byte aligned
  const __nv_bfloat16* b;                     // (D, W)
  const __nv_bfloat16* w_sig;                 // (W, LANE), column 0 live
  const __nv_bfloat16* b_sig;                 // (LANE,)
  const __nv_bfloat16* b_fin;                 // (W,)
  const __nv_bfloat16* b_dir;                 // (LANE,)
  const __nv_bfloat16* w_rgb;                 // (LANE, LANE), columns 0..2 live
  const __nv_bfloat16* b_rgb;                 // (LANE,)
  float* out;                                 // (N, 4)
  int N, in_xyz, in_dir, XP, depth, xpanels, panels, xslabs, dslabs, stages, tiles;
  unsigned skip_mask;  // bit i: layer i takes the xyz input too
};

// activations (h, then the xyz panels and the dir panels: `panels` in
// all), ring, barriers; the offsets from a 1024-byte aligned base
__host__ __device__ constexpr int xs_off() { return H_BYTES; }
__host__ __device__ constexpr int ds_off(int xpanels) { return H_BYTES + xpanels * ACT_PANEL; }
__host__ __device__ constexpr int ring_off(int panels) { return H_BYTES + panels * ACT_PANEL; }
__host__ __device__ constexpr int bar_off(int panels, int stages) {
  return ring_off(panels) + stages * SLAB;
}
__host__ __device__ constexpr int hw_off(int panels, int stages) {
  return bar_off(panels, stages) + BAR_BYTES;
}
__host__ __device__ constexpr size_t smem_bytes(int panels, int stages) {
  return (size_t)hw_off(panels, stages) + HW_BYTES + 1024;
}
__host__ __device__ constexpr int ring_stages(int panels) {
  return (MAX_SMEM - (int)smem_bytes(panels, 0)) / SLAB > MAX_STAGES
             ? MAX_STAGES
             : (MAX_SMEM - (int)smem_bytes(panels, 0)) / SLAB;
}

// the ring as a consumer sees it: the slab count so far and the stage whose
// products may still be reading it
struct Ring {
  uint32_t base, full, empty;
  int stages, it, pending;
};

// acc (+)= A[:, 32 k0 : 32 (k0 + nslabs)] . slabs: the next nslabs slabs of
// the ring against columns 32 k0... of the activation tile at a_tile, for
// this warpgroup's 64 rows; `first` starts the sums at zero.  A stage is
// released once the products of the stage after it are issued.
template <int NW>
__device__ __forceinline__ void mma_slabs(float (&acc)[NW / 2], Ring& r, uint32_t a_tile, int k0,
                                          int nslabs, bool first, int cw, int lane) {
  for (int i = 0; i < nslabs; ++i) {
    const int s = r.it % r.stages;
    mbar_wait(r.full + 8 * s, (r.it / r.stages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SLAB_ROWS / 16; ++kk)
      Wgmma<NW>::ss_mn(acc, Sw128::k_major<T>(a_tile, 64 * cw, 2 * (k0 + i) + kk),
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

template <int NW>
__device__ __forceinline__ void mma_drain(float (&acc)[NW / 2], Ring& r, int lane) {
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(r.empty + 8 * r.pending);
  r.pending = -1;
}

// LeakyReLU(0.01): v for v > 0, else 0.01 v (the same values as a select)
__device__ __forceinline__ float leaky(float v) { return fmaxf(v, SLOPE * v); }

// the two values of a packed bf16 pair, exactly, as fp32
__device__ __forceinline__ float2 unpack_bf16(uint32_t h) {
  return make_float2(__uint_as_float(h << 16), __uint_as_float(h & 0xffff0000u));
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// this thread's NP bf16 pairs v[8j + col0], v[8j + col0 + 1]
template <int NP>
__device__ __forceinline__ void load_pairs(uint32_t (&bp)[NP], const __nv_bfloat16* v, int col0) {
#pragma unroll
  for (int j = 0; j < NP; ++j) bp[j] = __ldg(reinterpret_cast<const unsigned int*>(v + 8 * j + col0));
}

__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"((unsigned short)v) : "memory");
}

// The epilogue of an N = 256 product: bf16(act(acc + bias)) into this
// thread's pairs of the activation tile.  Accumulator d[4j + 2i + c] is row
// 16 warp + lane / 4 + 8i of the warpgroup's 64 and column 8j + 2 (lane % 4)
// + c; both rows share their phase in the 8-row swizzle atom, so the pair's
// shared address is b8[j % 8] (the row and its swizzled 16-byte chunk) plus
// constants: (j / 8) panels and 8i rows.  `bias` holds the thread's bias
// pairs (load_pairs).  With SIG, also sig[i] += the stored row . w_sig[:, 0],
// whose pairs are at shared address w_sig.
template <bool ACT, bool SIG>
__device__ __forceinline__ void store_act(const float (&acc)[W / 2], const uint32_t (&bias)[W / 8],
                                          const uint32_t (&b8)[8], int col0, uint32_t w_sig,
                                          float (&sig)[2]) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 bj = unpack_bf16(bias[j]);
    float2 ws = make_float2(0.0f, 0.0f);
    if (SIG) ws = unpack_bf16(lds32(w_sig + (8 * j + col0) * 2));
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      float v0 = acc[4 * j + 2 * ii] + bj.x, v1 = acc[4 * j + 2 * ii + 1] + bj.y;
      if (ACT) {
        v0 = leaky(v0);
        v1 = leaky(v1);
      }
      const uint32_t h = pack_bf16(v0, v1);
      sts32(b8[j % 8] + (j / 8) * ACT_PANEL + ii * 1024, h);
      if (SIG) {
        const float2 hv = unpack_bf16(h);
        sig[ii] += hv.x * ws.x + hv.y * ws.y;
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(uint32_t saddr, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(saddr), "l"(g) : "memory");
}

// CHUNKED: columns [c0, c0 + cols) of this warpgroup's `rows` rows of x into
// the input buffer at sIn, as columns [0, cols), and zeros in the columns up
// to the next multiple of SLAB_ROWS (weights there are the fold's zero rows,
// but the buffer holds the previous chunk's values).  From an even c0 the
// whole bf16 pairs go by 4-byte cp.async, all in flight at once (C is even,
// so every row's pairs are 4-byte aligned); an odd last column, an odd c0's
// chunk (the dir input after an odd in_xyz) and the zeros go bf16 by bf16
__device__ __forceinline__ void load_chunk(uint32_t sIn, const __nv_bfloat16* x, long row0, int C,
                                           int rows, int c0, int cols, int cw, int tid) {
  const int width = (cols + SLAB_ROWS - 1) / SLAB_ROWS * SLAB_ROWS;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x) + row0 * C + c0;
  int start = 0;
  if (c0 % 2 == 0) {
    const int pc = cols / 2, total = rows * pc;
    for (int e = tid; e < total; e += 128) {
      const int rr = e / pc, c = 2 * (e - rr * pc);
      cp_async4(sIn + Sw128::offset<T>(64 * cw + rr, c), xs + (long)rr * C + c);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    start = 2 * pc;
  }
  const int span = width - start, total = rows * span;
  for (int e0 = tid; e0 < total; e0 += 128 * CHUNK_BATCH) {
    unsigned short v[CHUNK_BATCH];
#pragma unroll
    for (int u = 0; u < CHUNK_BATCH; ++u) {
      const int e = e0 + 128 * u, rr = e / span, c = start + e - rr * span;
      v[u] = (e < total && c < cols) ? __ldcs(xs + (long)rr * C + c) : (unsigned short)0;
    }
#pragma unroll
    for (int u = 0; u < CHUNK_BATCH; ++u) {
      const int e = e0 + 128 * u;
      if (e >= total) break;
      const int rr = e / span, c = start + e - rr * span;
      sts16(sIn + Sw128::offset<T>(64 * cw + rr, c), v[u]);
    }
  }
  if (c0 % 2 == 0) asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// CHUNKED: acc (+)= the input columns [c0, c0 + width) of x . the next
// slabs of the ring, CHUNK_PANELS * 64 columns at a time through the buffer
template <int NW>
__device__ __forceinline__ void mma_chunks(float (&acc)[NW / 2], Ring& r, uint32_t sIn,
                                           const __nv_bfloat16* x, long row0, int C, int rows,
                                           int c0, int width, bool first, int cw, int tid,
                                           int lane, int bar_id) {
  for (int c = 0; c < width; c += CHUNK_PANELS * 64) {
    const int cols = width - c < CHUNK_PANELS * 64 ? width - c : CHUNK_PANELS * 64;
    if (r.pending >= 0) mma_drain<NW>(acc, r, lane);  // every product on the buffer is done
    named_sync(bar_id, 128);
    load_chunk(sIn, x, row0, C, rows, c0 + c, cols, cw, tid);
    fence_async_smem();
    named_sync(bar_id, 128);
    mma_slabs<NW>(acc, r, sIn, 0, (cols + SLAB_ROWS - 1) / SLAB_ROWS, first && c == 0, cw, lane);
  }
}

template <bool CHUNKED>
__global__ void __launch_bounds__(CTA_THREADS, 1) nerf_mlp_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s0 = smem_u32(smem);
  const int xp = p.xpanels, np = p.panels, st = p.stages;
  const uint32_t sH = s0, sX = s0 + xs_off(), sD = s0 + ds_off(xp);
  const uint32_t full = s0 + bar_off(np, st), empty = full + 8 * st;
  const int wg = warpgroup_idx();

  // the heads' few live weight columns, [w_sig[:, 0] | w_rgb[:, k] for k < 3]
  const uint32_t hw = s0 + hw_off(np, st);
  for (int e = threadIdx.x; e < W + 3 * LANE; e += CTA_THREADS) {
    const __nv_bfloat16 v = e < W ? p.w_sig[e * LANE] : p.w_rgb[((e - W) % LANE) * LANE + (e - W) / LANE];
    sts16(hw + 2 * e, __bfloat16_as_ushort(v));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < st; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: the slab sequence of every tile this CTA takes ----
    producer_regs();
    if (threadIdx.x == CONSUMER_THREADS) {
      const uint32_t ring = s0 + ring_off(np);
      int it = 0;
      auto push = [&](const CUtensorMap* map, int row, int panels) {
        const int s = it % st;
        mbar_wait(empty + 8 * s, ((it / st) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, panels * PANEL);
        for (int q = 0; q < panels; ++q) tma_load_2d(ring + s * SLAB + q * PANEL, map, full + 8 * s, 64 * q, row);
        ++it;
      };
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int i = 0; i < p.depth; ++i) {
          if (i == 0 || ((p.skip_mask >> i) & 1u))
            for (int k = 0; k < p.xslabs; ++k) push(&p.wx, i * p.XP + SLAB_ROWS * k, 4);
          if (i > 0)
            for (int k = 0; k < W / SLAB_ROWS; ++k) push(&p.wh, i * W + SLAB_ROWS * k, 4);
        }
        for (int k = 0; k < W / SLAB_ROWS; ++k) push(&p.w_fin, SLAB_ROWS * k, 4);
        for (int k = 0; k < W / SLAB_ROWS; ++k) push(&p.w_dirf, SLAB_ROWS * k, 2);
        for (int k = 0; k < p.dslabs; ++k) push(&p.w_dird, SLAB_ROWS * k, 2);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile ----
  consumer_regs();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int cw = wg, bar_id = 1 + cw;
  const int C = p.in_xyz + p.in_dir;
  Ring r{s0 + ring_off(np), full, empty, st, 0, -1};

  // the padding columns of the inputs stay zero: clear this warpgroup's rows
  // of every input panel (xyz, then dir: contiguous) once
  for (int e = tid; e < 64 * 32 * np; e += 128) {
    const int row = 64 * cw + e / (32 * np), word = e % (32 * np);
    *reinterpret_cast<uint32_t*>(smem + xs_off() + (word / 32) * ACT_PANEL + row * 128 + (word % 32) * 4) = 0u;
  }

  // this thread's accumulator rows and columns (see store_act)
  const int lrow = 64 * cw + 16 * warp + lane / 4;  // tile row of d[.. + 0 + ..]
  const int col0 = 2 * (lane % 4), r8 = (lane / 4) % 8;
  uint32_t b8[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) b8[k] = sH + lrow * 128 + col0 * 2 + ((k ^ r8) << 4);
  float acc[W / 2];
  float (&dacc)[LANE / 2] = *reinterpret_cast<float(*)[LANE / 2]>(&acc[0]);

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long row0 = (long)tile * T + 64 * cw;  // this warpgroup's first point
    const long left = (long)p.N - row0;
    const int rows = left < 64 ? (left > 0 ? (int)left : 0) : 64;

    // the tile's inputs: columns [0, in_xyz) to xyz, the rest to dir, in
    // bf16 pairs (C is even; a pair may straddle the two).  The rows are
    // contiguous, so pair e of the warpgroup's rows is at xt + 2e; X_BATCH
    // loads are issued before any is stored, so their latencies overlap
    if (!CHUNKED) {
    named_sync(bar_id, 128);  // the previous tile's products are done with xyz and dir
    const uint32_t* xt = reinterpret_cast<const uint32_t*>(p.x + row0 * C);
    const int pairs = rows * (C / 2);
    for (int e0 = tid; e0 < pairs; e0 += 128 * X_BATCH) {
      uint32_t v[X_BATCH];
#pragma unroll
      for (int u = 0; u < X_BATCH; ++u) {
        const int e = e0 + 128 * u;
        v[u] = e < pairs ? __ldcs(xt + e) : 0u;
      }
#pragma unroll
      for (int u = 0; u < X_BATCH; ++u) {
        const int e = e0 + 128 * u;
        if (e >= pairs) break;
        const int rr = e / (C / 2), c = 2 * (e - rr * (C / 2)), row = 64 * cw + rr;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = c + h;
          const uint32_t off = cc < p.in_xyz ? xs_off() + Sw128::offset<T>(row, cc)
                                             : ds_off(xp) + Sw128::offset<T>(row, cc - p.in_xyz);
          sts16(s0 + off, h ? v[u] >> 16 : v[u]);
        }
      }
    }
    fence_async_smem();
    named_sync(bar_id, 128);
    }

    // ---- trunk ----
    float sig[2] = {0.0f, 0.0f};
    for (int i = 0; i < p.depth; ++i) {
      const bool xin = i == 0 || ((p.skip_mask >> i) & 1u);
      if (xin) {
        if (CHUNKED)
          mma_chunks<W>(acc, r, sX, p.x, row0, C, rows, 0, p.in_xyz, true, cw, tid, lane, bar_id);
        else
          mma_slabs<W>(acc, r, sX, 0, p.xslabs, true, cw, lane);
      }
      if (i > 0) mma_slabs<W>(acc, r, sH, 0, W / SLAB_ROWS, !xin, cw, lane);
      uint32_t bias[W / 8];
      load_pairs(bias, p.b + (size_t)i * W, col0);  // in flight while the products finish
      mma_drain<W>(acc, r, lane);
      named_sync(bar_id, 128);  // every warp's products have read h
      if (i < p.depth - 1)
        store_act<true, false>(acc, bias, b8, col0, hw, sig);
      else
        store_act<true, true>(acc, bias, b8, col0, hw, sig);
      fence_async_smem();
      named_sync(bar_id, 128);
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      sig[ii] += __shfl_xor_sync(0xffffffffu, sig[ii], 1);
      sig[ii] += __shfl_xor_sync(0xffffffffu, sig[ii], 2);
      sig[ii] += __bfloat162float(p.b_sig[0]);
    }

    // ---- feat = bf16(h . w_fin + b_fin), replacing h ----
    mma_slabs<W>(acc, r, sH, 0, W / SLAB_ROWS, true, cw, lane);
    uint32_t bias[W / 8];
    load_pairs(bias, p.b_fin, col0);
    mma_drain<W>(acc, r, lane);
    named_sync(bar_id, 128);
    store_act<false, false>(acc, bias, b8, col0, hw, sig);
    fence_async_smem();
    named_sync(bar_id, 128);

    // ---- d = bf16(leaky(feat . w_dirf + dir . w_dird + b_dir)); rgb ----
    mma_slabs<LANE>(dacc, r, sH, 0, W / SLAB_ROWS, true, cw, lane);
    if (CHUNKED)
      mma_chunks<LANE>(dacc, r, sX, p.x, row0, C, rows, p.in_xyz, p.in_dir, false, cw, tid, lane,
                       bar_id);
    else
      mma_slabs<LANE>(dacc, r, sD, 0, p.dslabs, false, cw, lane);
    uint32_t bias_d[LANE / 8];
    load_pairs(bias_d, p.b_dir, col0);
    mma_drain<LANE>(dacc, r, lane);
    float rgb[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int j = 0; j < LANE / 8; ++j) {
      const int col = 8 * j + col0;
      const float2 bj = unpack_bf16(bias_d[j]);
      float2 w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) w[k] = unpack_bf16(lds32(hw + 2 * (W + k * LANE + col)));
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float2 d = unpack_bf16(pack_bf16(leaky(dacc[4 * j + 2 * ii] + bj.x),
                                               leaky(dacc[4 * j + 2 * ii + 1] + bj.y)));
#pragma unroll
        for (int k = 0; k < 3; ++k) rgb[ii][k] += d.x * w[k].x + d.y * w[k].y;
      }
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rgb[ii][k] += __shfl_xor_sync(0xffffffffu, rgb[ii][k], 1);
        rgb[ii][k] += __shfl_xor_sync(0xffffffffu, rgb[ii][k], 2);
      }
      const long row = (long)tile * T + lrow + 8 * ii;
      if (lane % 4 == 0 && row < p.N) {
        float4 o;
        o.x = 1.0f / (1.0f + expf(-(rgb[ii][0] + __bfloat162float(p.b_rgb[0]))));
        o.y = 1.0f / (1.0f + expf(-(rgb[ii][1] + __bfloat162float(p.b_rgb[1]))));
        o.z = 1.0f / (1.0f + expf(-(rgb[ii][2] + __bfloat162float(p.b_rgb[2]))));
        o.w = sig[ii];
        *reinterpret_cast<float4*>(p.out + row * 4) = o;
      }
    }
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

}  // namespace

extern "C" {

// x (N, in_xyz + in_dir) bf16, in_xyz + in_dir even, 4-byte aligned (the
// wrapper pads an odd one with a zero column); the folded weights of
// ops/nerf_mlp.py (bf16, width 256, XP = in_xyz and DP = in_dir padded to
// multiples of 128); out (N, 4) fp32.  Inputs of at most MAX_PANELS
// 64-column panels together stay resident for the tile; wider ones run the
// CHUNKED instance.  Returns the cudaError_t of the launch.
int ddmi_nerf_mlp(const void* x, const void* wx, const void* wh, const void* b,
                  const void* w_sig, const void* b_sig, const void* w_fin, const void* b_fin,
                  const void* w_dirf, const void* w_dird, const void* b_dir, const void* w_rgb,
                  const void* b_rgb, void* out, int N, int in_xyz, int in_dir, int XP, int DP,
                  int depth, unsigned int skip_mask, void* stream) {
  using bf = const __nv_bfloat16*;
  const int in_panels = (in_xyz + 63) / 64 + (in_dir + 63) / 64;
  const bool chunked = in_panels > MAX_PANELS;
  const int xpanels = chunked ? CHUNK_PANELS : (in_xyz + 63) / 64;
  const int panels = chunked ? CHUNK_PANELS : in_panels;
  if (N <= 0 || depth < 1 || in_xyz < 1 || in_dir < 1 || (in_xyz + in_dir) % 2 ||
      (in_xyz + 63) / 64 * 64 > XP || (in_dir + 63) / 64 * 64 > DP || reinterpret_cast<uintptr_t>(x) % 4)
    return (int)cudaErrorInvalidValue;
  const int stages = ring_stages(panels);
  Params p{};
  if (!ddmi_tma::matrix_map(&p.wx, wx, (long long)depth * XP, W, SLAB_ROWS) ||
      !ddmi_tma::matrix_map(&p.wh, wh, (long long)depth * W, W, SLAB_ROWS) ||
      !ddmi_tma::matrix_map(&p.w_fin, w_fin, W, W, SLAB_ROWS) ||
      !ddmi_tma::matrix_map(&p.w_dirf, w_dirf, W, LANE, SLAB_ROWS) ||
      !ddmi_tma::matrix_map(&p.w_dird, w_dird, DP, LANE, SLAB_ROWS) || stages < 2)
    return (int)cudaErrorInvalidValue;
  p.x = static_cast<bf>(x);
  p.b = static_cast<bf>(b);
  p.w_sig = static_cast<bf>(w_sig);
  p.b_sig = static_cast<bf>(b_sig);
  p.b_fin = static_cast<bf>(b_fin);
  p.b_dir = static_cast<bf>(b_dir);
  p.w_rgb = static_cast<bf>(w_rgb);
  p.b_rgb = static_cast<bf>(b_rgb);
  p.out = static_cast<float*>(out);
  p.N = N;
  p.in_xyz = in_xyz;
  p.in_dir = in_dir;
  p.XP = XP;
  p.depth = depth;
  p.xpanels = xpanels;
  p.panels = panels;
  p.xslabs = (in_xyz + SLAB_ROWS - 1) / SLAB_ROWS;
  p.dslabs = (in_dir + SLAB_ROWS - 1) / SLAB_ROWS;
  p.stages = stages;
  p.tiles = (N + T - 1) / T;
  p.skip_mask = skip_mask;
  static bool sized = false;  // the attributes hold for the process
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(nerf_mlp_kernel<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nerf_mlp_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const int grid = p.tiles < sms ? p.tiles : sms;
  if (chunked)
    nerf_mlp_kernel<true><<<grid, CTA_THREADS, smem_bytes(panels, stages),
                            reinterpret_cast<cudaStream_t>(stream)>>>(p);
  else
    nerf_mlp_kernel<false><<<grid, CTA_THREADS, smem_bytes(panels, stages),
                             reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The dynamic shared memory and ring stages of a launch at these input
// widths, for the build report: bytes * 8 + stages.
int ddmi_nerf_mlp_smem(int in_xyz, int in_dir) {
  int panels = (in_xyz + 63) / 64 + (in_dir + 63) / 64;
  if (panels > MAX_PANELS) panels = CHUNK_PANELS;
  return (int)smem_bytes(panels, ring_stages(panels)) * 8 + ring_stages(panels);
}

}  // extern "C"
