// Flash-attention forward for Hopper (sm_90a): o = softmax(q.k^T * s).v over
// head-major (B, nh, n, hd) bf16 q/k/v, and optionally each row's
// log-sum-exp of the scaled scores (natural log), for the backward.
//
// Replaces the forward of the library Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention (flash_attention.py:758),
// as the JAX package calls it at ddmi_tpu/nn/attention1d.py:77 and
// ddmi_tpu/nn/unet.py:185, with its function: fp32 scores multiplied by the
// scale, an online softmax over K/V blocks, the division after P.V.  The
// fused attention block (attn_block.cu) runs the same kernel with scale 1 on
// a q its GEMM has already scaled, writing token-major rows (FwdParams'
// output strides).  mha_vmem (flash.cu, the counterpart of
// ddmi_tpu/ops/pallas/attention.py::mha_vmem) runs it in the q pre-scale
// mode (FwdParams::q_prescale): each consumer warpgroup multiplies its 64
// rows of the Q tile by the scale in fp32 and rounds them once to bf16, in
// place in shared memory, before the first product reads them, as the TPU
// kernel rounds q * scale to q's dtype; the scores then take scale 1.
//
// What bounds it: 4 * n^2 * hd tensor FLOP per (batch, head) on 4 * n * hd
// * 2 bytes, so at n >= 512 the tensor cores bound it at hd 64 and 128; at
// hd 16 and 32 the n^2 exponentials do (an SM issues 16 ex2 per clock, one
// per score against 4 * hd FLOP).  The design, FlashAttention-3's:
//   * roles: one producer warp (its warpgroup gives up its registers with
//     setmaxnreg) and two consumer warpgroups of 64 q rows each, 128 rows
//     per CTA;
//   * copies: the producer loads the Q tile once and streams K and V in
//     128-key tiles (64 at hd 128) through a two-stage ring with TMA, full/empty mbarrier
//     pairs per stage, K and V on barriers of their own so that Q.K^T starts
//     before V lands; TMA zero-fills rows past n;
//   * S = Q.K^T: wgmma with both operands in shared memory, K-major;
//   * softmax on the accumulator registers: the row max by quad shuffles,
//     exp2 with s * log2(e) folded into one multiply, the row sums kept per
//     thread and reduced once at the end; keys past n in the last tile are
//     masked to -inf before the max;
//   * O += P.V: P packed to bf16 in registers is wgmma's register A operand
//     (the accumulator layout is the A-fragment layout), V an MN-major
//     operand in shared memory; O stays in registers and is rescaled there;
//   * overlap: tile j's S = Q.K_j^T is issued before tile j-1's P.V, and the
//     exponentials of tile j run while that P.V is in flight.
#pragma once

#include "hopper.cuh"

namespace ddmi_flash {

using namespace ddmi_sm90;

struct FwdParams {
  CUtensorMap q, k, v;   // (hd, n, B * nh) maps: boxes of BM (q) and BN (k, v) rows
  // row r of head h of batch b goes to out + b * o_sb + h * o_sh + r * o_sr:
  // (B, nh, n, hd) for the flash library, token-major (B, n, nh * hd') for
  // the attention block
  __nv_bfloat16* out;
  float* lse;            // (B * nh, n) or null
  long long o_sb, o_sh, o_sr;
  int n, nh;
  int o_cols;            // columns written per row: the head dim before zero-padding
  int o_pairs;           // o_cols and the strides even: columns stored in pairs
  float scale_log2;      // softmax scale * log2(e)
  int q_prescale;        // 1: q = bf16(q * q_scale) in shared memory first
  float q_scale;
};

// the output of a contiguous (B, nh, n, HD) tensor
inline void head_major_out(FwdParams& p, void* out, int nh, int n, int hd) {
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_sr = hd;
  p.o_sh = (long long)n * hd;
  p.o_sb = (long long)nh * n * hd;
  p.nh = nh;
  p.o_cols = hd;
  p.o_pairs = 1;
}

template <int HD>
struct FwdShape {
  static constexpr int BM = 128;  // q rows per CTA: 64 per consumer warpgroup
  // keys per K/V tile; at hd 128 a 64-key tile keeps S, P and O inside the
  // consumers' registers (at 128 keys ptxas spilled and serialised wgmma)
  static constexpr int BN = HD == 128 ? 64 : 128;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 128 + 1024;  // barriers, 1024-byte alignment
};

template <int HD>
__global__ void __launch_bounds__(CTA_THREADS, 1) flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  using S = FwdShape<HD>;
  using T = Tile<HD>;
  constexpr int BM = S::BM, BN = S::BN, ST = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + S::Q_BYTES, sV = sK + ST * S::KV_BYTES;
  const uint32_t bar = sQ + S::BAR_OFF;  // q_full, k_full[ST], k_empty[ST], v_full[ST], v_empty[ST]
  const uint32_t q_full = bar, k_full = bar + 8, k_empty = k_full + 8 * ST;
  const uint32_t v_full = k_empty + 8 * ST, v_empty = v_full + 8 * ST;

  const int n = p.n, bh = blockIdx.y, m0 = blockIdx.x * BM;
  const int n_tiles = (n + BN - 1) / BN;
  const int wg = warpgroup_idx();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    producer_regs();
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(q_full, S::Q_BYTES);
      T::template load<BM>(sQ, &p.q, q_full, m0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t ph = (j / ST) & 1;
        mbar_wait(k_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(k_full + 8 * s, S::KV_BYTES);
        T::template load<BN>(sK + s * S::KV_BYTES, &p.k, k_full + 8 * s, j * BN, bh);
        mbar_wait(v_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(v_full + 8 * s, S::KV_BYTES);
        T::template load<BN>(sV + s * S::KV_BYTES, &p.v, v_full + 8 * s, j * BN, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows [m0 + 64 cw, m0 + 64 cw + 64) ----
    consumer_regs();
    const int cw = wg, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const bool signals = lane == 0;  // one empty-barrier arrival per warp
    const int qrow = 64 * cw;        // first row of this warpgroup in the Q tile
    const int col0 = 2 * (lane % 4);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

    // S = Q.K_j^T for the K tile in stage s (issued, not awaited)
    auto issue_s = [&](int s) {
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<BN>::ss(sc, T::template k_major<BM>(sQ, qrow, kk),
                      T::template k_major<BN>(sK + s * S::KV_BYTES, 0, kk), kk > 0);
      wgmma_commit();
    };
    // O += P.V for the V tile in stage s (issued, not awaited)
    auto issue_pv = [&](int s) {
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Wgmma<HD>::rs(o, pa[kk], T::template mn_major<BN>(sV + s * S::KV_BYTES, kk));
      wgmma_commit();
    };
    // scores of tile j -> exp2 in place; returns the rescale factors of the
    // running sums in alpha and adds the tile's row sums into l_run
    auto softmax = [&](int j, float (&alpha)[2]) {
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] *= p.scale_log2;
      if ((j + 1) * BN > n) {  // ragged last tile: keys past n take no weight
        const int valid = n - j * BN;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          if (8 * (i / 4) + col0 + (i % 2) >= valid) sc[i] = -INFINITY;
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m_run[r] - mx[r]);
        m_run[r] = mx[r];
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] = exp2_approx(sc[i] - mx[(i / 2) % 2]);
        sum[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) pa[kk][h] = pack_bf16(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
    };

    mbar_wait(q_full, 0);
    if (p.q_prescale) {
      // this warpgroup's 64 rows of each panel are 64 * ROWB contiguous
      // bytes; the pass is elementwise, so the swizzle does not matter
      constexpr int CHUNKS = 64 * T::ROWB / 16;  // 16-byte chunks per panel
      for (int e = tid; e < T::PANELS * CHUNKS; e += 128) {
        uint4* c = reinterpret_cast<uint4*>(smem + (e / CHUNKS) * BM * T::ROWB + qrow * T::ROWB +
                                            (e % CHUNKS) * 16);
        uint4 w = *c;
        uint32_t* h = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = pack_bf16(__uint_as_float(h[i] << 16) * p.q_scale,
                           __uint_as_float(h[i] & 0xffff0000u) * p.q_scale);
        *c = w;
      }
      fence_async_smem();  // the products read the rounded tile
      named_sync(1 + cw, 128);
    }
    float alpha[2];
    mbar_wait(k_full, 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (signals) mbar_arrive(k_empty);
    softmax(0, alpha);
    pack_p();

    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % ST, sp = (j - 1) % ST;
      mbar_wait(k_full + 8 * s, (j / ST) & 1);
      issue_s(s);
      mbar_wait(v_full + 8 * sp, ((j - 1) / ST) & 1);
      issue_pv(sp);
      wgmma_wait<1>();  // S_j is ready; P_{j-1}.V_{j-1} may still run
      fence_regs(sc);
      if (signals) mbar_arrive(k_empty + 8 * s);
      softmax(j, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      if (signals) mbar_arrive(v_empty + 8 * sp);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      pack_p();
    }
    const int sl = (n_tiles - 1) % ST;
    mbar_wait(v_full + 8 * sl, ((n_tiles - 1) / ST) & 1);
    issue_pv(sl);
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: O / l in bf16; the row log-sum-exp in natural log
    const int r0 = m0 + qrow + 16 * warp + lane / 4;
    const int b = bh / p.nh;
    __nv_bfloat16* out = p.out + b * p.o_sb + (bh - b * p.nh) * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r0 + 8 * r;
      if (row < n) {
        const float inv = 1.0f / l;
        __nv_bfloat16* orow = out + row * p.o_sr;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          const int c = 8 * jj + col0;
          const float v0 = o[4 * jj + 2 * r] * inv, v1 = o[4 * jj + 2 * r + 1] * inv;
          if (p.o_pairs && c < p.o_cols) {
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(v0, v1);
          } else {
            if (c < p.o_cols) orow[c] = __float2bfloat16(v0);
            if (c + 1 < p.o_cols) orow[c + 1] = __float2bfloat16(v1);
          }
        }
        if (p.lse != nullptr && lane % 4 == 0)
          p.lse[(size_t)bh * n + row] = (m_run[r] + log2f(l)) * 0.69314718055994531f;
      }
    }
  }
}

template <int HD>
cudaError_t launch_fwd(const FwdParams& p, int bh, cudaStream_t st) {
  using S = FwdShape<HD>;
  // set on every launch: a static flag here would be one object across
  // every library that includes this header (the linker unifies a template's
  // static locals process-wide), and the kernel is each library's own
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<HD><<<dim3((p.n + S::BM - 1) / S::BM, bh), CTA_THREADS, S::SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace ddmi_flash
