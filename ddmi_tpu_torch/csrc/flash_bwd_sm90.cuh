// Flash-attention backward for Hopper (sm_90a): the gradients of
// o = softmax(q.k^T * s).v over head-major (B, nh, n, hd) bf16 q/k/v.
//
// Replaces the two Pallas kernels of the library's backward,
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_bwd_dkv
// (pallas_call at :1121) and ::_flash_attention_bwd_dq (pallas_call at :1456),
// with their arithmetic:
//
//   p  = exp(q.k^T * s - lse)          fp32, lse (natural log) from the forward
//   dv = bf16(p)^T . do
//   dp = do . v^T
//   ds = p * (dp - di) * s             di = sum_d o * do, fp32, from the caller
//   dk = bf16(ds)^T . q,  dq = bf16(ds) . k
//
// with fp32 sums and bf16 outputs; exp(x) is taken as exp2(x * log2(e)).
//
// What bounds it: five n x n x hd products, 10 * n^2 * hd FLOP per (batch,
// head), against 8 tensors of n * hd values; at the training shape (5, 16,
// 1024, 32) that is 27 us of tensor time, and the 2 * n^2 exponentials of
// the two passes about 42 us of the exp unit.
//
// Design.  Two launches, as the library has two kernels: CUDA blocks run in
// no order, so each sum lives inside one block, and without atomics every
// sum runs in a fixed order, so a repeat is bit-identical.  Each kernel has
// one producer warp (TMA through full/empty mbarrier pairs) and two consumer
// warpgroups of 64 rows; every product is a wgmma:
//   dkv: a CTA per 128-key tile, K and V resident in shared memory.  Q and
//        dO stream in 64-row tiles through a two-stage ring; the producer
//        warp also stages each tile's lse (times log2(e)) and di, with
//        +inf and 0 for rows past n so that they add nothing.  Per tile a
//        warpgroup forms S^T = K.Q^T and dP^T = V.dO^T (shared-memory
//        operands, K-major), P^T and dS^T in registers, then dV += P^T.dO
//        and dK += dS^T.Q with P^T, dS^T as register A operands and dO, Q
//        as MN-major operands.
//   dq:  a CTA per 128-row q tile, Q and dO resident; K and V stream in
//        64-key tiles: S = Q.K^T, dP = dO.V^T, dS in registers, dQ += dS.K
//        (K MN-major).  Keys past n in the last tile get p = 0.
#pragma once

#include "hopper.cuh"

namespace ddmi_flash {

using namespace ddmi_sm90;

struct BwdParams {
  // (hd, n, B * nh) maps, boxes of 64 or 128 rows: dkv streams q64, do64
  // past k128, v128; dq streams k64, v64 past q128, do128
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  const float* lse;           // (B * nh, n)
  const float* di;            // (B * nh, n)
  __nv_bfloat16* dq;          // (B * nh, n, hd)
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int n;
  float scale;                // softmax scale
  float scale_log2;           // scale * log2(e)
};

template <int HD>
struct BwdShape {
  static constexpr int BIG = 128;   // resident rows per CTA: 64 per consumer warpgroup
  static constexpr int SMALL = 64;  // streamed rows per tile
  static constexpr int STAGES = 2;
  static constexpr int BIG_BYTES = BIG * HD * 2;
  static constexpr int SMALL_BYTES = SMALL * HD * 2;
  // two resident tiles, then per stage two streamed tiles and (dkv) lse, di
  static constexpr int STAT_OFF = 2 * BIG_BYTES + 2 * STAGES * SMALL_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * SMALL * 4;
  static constexpr size_t SMEM = BAR_OFF + 64 + 1024;
};

// a warpgroup's fp32 accumulator (rows row0 and row0 + 8 of this thread)
// -> bf16 rows of out, HD wide, rows past n skipped
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], __nv_bfloat16* out, int row0,
                                           int n, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * HD + 8 * jj + 2 * (lane % 4)) =
            pack_bf16(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(CTA_THREADS, 1) flash_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  using S = BwdShape<HD>;
  using T = Tile<HD>;
  constexpr int BIG = S::BIG, SM = S::SMALL, ST = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sK = smem_u32(smem), sV = sK + S::BIG_BYTES;
  const uint32_t sQ = sV + S::BIG_BYTES, sO = sQ + ST * S::SMALL_BYTES;  // streamed q, do
  float* stats = reinterpret_cast<float*>(smem + S::STAT_OFF);  // per stage: lse2[64], di[64]
  const uint32_t bar = sK + S::BAR_OFF;  // kv_full, full[ST], empty[ST]
  const uint32_t kv_full = bar, full = bar + 8, empty = full + 8 * ST;

  const int n = p.n, bh = blockIdx.y, k0 = blockIdx.x * BIG;
  const int n_tiles = (n + SM - 1) / SM;
  const int wg = warpgroup_idx();

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 33);  // the TMA arrival and the 32 lanes that stage lse, di
      mbar_init(empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    producer_regs();
    if (threadIdx.x < CONSUMER_THREADS + 32) {
      const int lane = threadIdx.x - CONSUMER_THREADS;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * S::BIG_BYTES);
        T::template load<BIG>(sK, &p.k128, kv_full, k0, bh);
        T::template load<BIG>(sV, &p.v128, kv_full, k0, bh);
      }
      const float* lse = p.lse + (size_t)bh * n;
      const float* di = p.di + (size_t)bh * n;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        mbar_wait(empty + 8 * s, ((i / ST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * S::SMALL_BYTES);
          T::template load<SM>(sQ + s * S::SMALL_BYTES, &p.q64, full + 8 * s, i * SM, bh);
          T::template load<SM>(sO + s * S::SMALL_BYTES, &p.do64, full + 8 * s, i * SM, bh);
        }
        float* tile_stats = stats + s * 2 * SM;
#pragma unroll
        for (int t = lane; t < SM; t += 32) {
          const int row = i * SM + t;
          tile_stats[t] = row < n ? lse[row] * LOG2E : INFINITY;
          tile_stats[SM + t] = row < n ? di[row] : 0.0f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    consumer_regs();
    const int cw = wg, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int krow = 64 * cw;  // this warpgroup's first key in the resident tiles
    const int col0 = 2 * (lane % 4);

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.0f;
    float st[SM / 2], dpt[SM / 2];
    uint32_t pa[SM / 16][4], da[SM / 16][4];

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      const uint32_t q_t = sQ + s * S::SMALL_BYTES, o_t = sO + s * S::SMALL_BYTES;
      mbar_wait(full + 8 * s, (i / ST) & 1);
      // S^T = K.Q^T and dP^T = V.dO^T for this warpgroup's 64 keys x 64 q rows
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<SM>::ss(st, T::template k_major<BIG>(sK, krow, kk), T::template k_major<SM>(q_t, 0, kk),
                      kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<SM>::ss(dpt, T::template k_major<BIG>(sV, krow, kk), T::template k_major<SM>(o_t, 0, kk),
                      kk > 0);
      wgmma_commit();
      const float* lse2 = stats + s * 2 * SM;
      const float* dis = lse2 + SM;
      wgmma_wait<1>();
      fence_regs(st);
      // P^T[key, q] = exp2(s * scale * log2(e) - lse2[q]); columns are q rows
#pragma unroll
      for (int i2 = 0; i2 < SM / 2; ++i2) {
        const int c = 8 * (i2 / 4) + col0 + (i2 % 2);
        st[i2] = exp2_approx(st[i2] * p.scale_log2 - lse2[c]);
      }
#pragma unroll
      for (int kk = 0; kk < SM / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) pa[kk][h] = pack_bf16(st[8 * kk + 2 * h], st[8 * kk + 2 * h + 1]);
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i2 = 0; i2 < SM / 2; ++i2) {
        const int c = 8 * (i2 / 4) + col0 + (i2 % 2);
        dpt[i2] = st[i2] * (dpt[i2] - dis[c]) * p.scale;
      }
#pragma unroll
      for (int kk = 0; kk < SM / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) da[kk][h] = pack_bf16(dpt[8 * kk + 2 * h], dpt[8 * kk + 2 * h + 1]);
      // dV += P^T.dO, dK += dS^T.Q (k runs over the tile's 64 q rows)
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SM / 16; ++kk) Wgmma<HD>::rs(dv, pa[kk], T::template mn_major<SM>(o_t, kk));
#pragma unroll
      for (int kk = 0; kk < SM / 16; ++kk) Wgmma<HD>::rs(dk, da[kk], T::template mn_major<SM>(q_t, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    const int row0 = k0 + krow + 16 * warp + lane / 4;
    store_rows<HD>(dk, p.dk + (size_t)bh * n * HD, row0, n, lane);
    store_rows<HD>(dv, p.dv + (size_t)bh * n * HD, row0, n, lane);
  }
}

template <int HD>
__global__ void __launch_bounds__(CTA_THREADS, 1) flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  using S = BwdShape<HD>;
  using T = Tile<HD>;
  constexpr int BIG = S::BIG, SM = S::SMALL, ST = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(smem), sO = sQ + S::BIG_BYTES;       // resident q, do
  const uint32_t sK = sO + S::BIG_BYTES, sV = sK + ST * S::SMALL_BYTES;  // streamed k, v
  const uint32_t bar = sQ + S::BAR_OFF;  // qo_full, full[ST], empty[ST]
  const uint32_t qo_full = bar, full = bar + 8, empty = full + 8 * ST;

  const int n = p.n, bh = blockIdx.y, m0 = blockIdx.x * BIG;
  const int n_tiles = (n + SM - 1) / SM;
  const int wg = warpgroup_idx();

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    producer_regs();
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(qo_full, 2 * S::BIG_BYTES);
      T::template load<BIG>(sQ, &p.q128, qo_full, m0, bh);
      T::template load<BIG>(sO, &p.do128, qo_full, m0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        mbar_wait(empty + 8 * s, ((j / ST) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * S::SMALL_BYTES);
        T::template load<SM>(sK + s * S::SMALL_BYTES, &p.k64, full + 8 * s, j * SM, bh);
        T::template load<SM>(sV + s * S::SMALL_BYTES, &p.v64, full + 8 * s, j * SM, bh);
      }
    }
  } else {
    consumer_regs();
    const int cw = wg, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int qrow = 64 * cw;
    const int col0 = 2 * (lane % 4);
    const int row0 = m0 + qrow + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    float lse2[2], dis[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < n ? p.lse[(size_t)bh * n + row] * LOG2E : INFINITY;
      dis[r] = row < n ? p.di[(size_t)bh * n + row] : 0.0f;
    }

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.0f;
    float sc[SM / 2], dp[SM / 2];
    uint32_t da[SM / 16][4];

    mbar_wait(qo_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const uint32_t k_t = sK + s * S::SMALL_BYTES, v_t = sV + s * S::SMALL_BYTES;
      mbar_wait(full + 8 * s, (j / ST) & 1);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<SM>::ss(sc, T::template k_major<BIG>(sQ, qrow, kk), T::template k_major<SM>(k_t, 0, kk),
                      kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<SM>::ss(dp, T::template k_major<BIG>(sO, qrow, kk), T::template k_major<SM>(v_t, 0, kk),
                      kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < SM / 2; ++i) sc[i] = exp2_approx(sc[i] * p.scale_log2 - lse2[(i / 2) % 2]);
      if ((j + 1) * SM > n) {  // ragged last tile: keys past n take no weight
        const int valid = n - j * SM;
#pragma unroll
        for (int i = 0; i < SM / 2; ++i)
          if (8 * (i / 4) + col0 + (i % 2) >= valid) sc[i] = 0.0f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < SM / 2; ++i) dp[i] = sc[i] * (dp[i] - dis[(i / 2) % 2]) * p.scale;
#pragma unroll
      for (int kk = 0; kk < SM / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) da[kk][h] = pack_bf16(dp[8 * kk + 2 * h], dp[8 * kk + 2 * h + 1]);
      // dQ += dS.K (k runs over the tile's 64 keys)
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SM / 16; ++kk) Wgmma<HD>::rs(dq, da[kk], T::template mn_major<SM>(k_t, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    store_rows<HD>(dq, p.dq + (size_t)bh * n * HD, row0, n, lane);
  }
}

template <int HD>
cudaError_t launch_bwd(const BwdParams& p, int bh, cudaStream_t st) {
  using S = BwdShape<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + S::BIG - 1) / S::BIG, bh);
  flash_bwd_dkv_kernel<HD><<<grid, CTA_THREADS, S::SMEM, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<HD><<<grid, CTA_THREADS, S::SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace ddmi_flash
