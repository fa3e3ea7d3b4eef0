// Flash attention over head-major (B, nh, n, hd) bf16 q/k/v for Hopper
// (sm_90a), with a plain C interface for ctypes:
//
//   ddmi_flash_attention       replaces the forward of the library Pallas kernel
//                              jax.experimental.pallas.ops.tpu.flash_attention,
//                              as called at ddmi_tpu/nn/attention1d.py:77 and
//                              ddmi_tpu/nn/unet.py:185 (flash_fwd_sm90.cuh);
//   ddmi_flash_attention_lse   the same forward, also writing each row's
//                              log-sum-exp, taken when a gradient will be needed;
//   ddmi_flash_attention_bwd   replaces the library's backward kernels
//                              _flash_attention_bwd_dkv and _flash_attention_bwd_dq
//                              (flash_attention.py:1121, :1456): dq, dk, dv in
//                              two launches (flash_bwd_sm90.cuh);
//   ddmi_mha_vmem              replaces ddmi_tpu/ops/pallas/attention.py::mha_vmem
//                              (body `_kernel`): the forward core in its q
//                              pre-scale mode, softmax(bf16(q * s).k^T).v.
//
// Every entry builds its TMA tensor maps on the host, inside the one call
// (tensor_map.cuh).  Each (hd, n, B * nh) map reads one head's rows, and
// TMA fills rows past n with zeros.
//
// mha_vmem.  The TPU kernel holds a whole head's (n, n) scores in VMEM (n <=
// 1024, hd <= 128); at the video path's shapes (n 32-512, hd 16-96) a call
// is 1-16 MFLOP per head against a few microseconds of launch, so what
// bounds it on this card is the launch and its enqueue, not the tensor
// cores.  The entry is one launch with no scratch: the maps are encoded here
// over the caller's own tensors at their real head dim, boxes of the next
// instance's width (16, 32, 64, 128), so TMA's zero fill pads hd (and rows
// past n) without a copy, and the epilogue writes only the hd real columns.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"
#include "tensor_map.cuh"

namespace {

using ddmi_tma::tensor_map;

template <int HD>
int forward(const void* q, const void* k, const void* v, void* out, float* lse, int B, int nh,
            int n, float sm_scale, cudaStream_t st) {
  using S = ddmi_flash::FwdShape<HD>;
  const int bh = B * nh;
  ddmi_flash::FwdParams p{};
  if (!tensor_map(&p.q, q, HD, n, bh, S::BM) || !tensor_map(&p.k, k, HD, n, bh, S::BN) ||
      !tensor_map(&p.v, v, HD, n, bh, S::BN))
    return cudaErrorInvalidValue;
  ddmi_flash::head_major_out(p, out, nh, n, HD);
  p.lse = lse;
  p.n = n;
  p.scale_log2 = sm_scale * ddmi_flash::LOG2E;
  return ddmi_flash::launch_fwd<HD>(p, bh, st);
}

int forward(const void* q, const void* k, const void* v, void* out, float* lse, int B, int nh, int n,
            int hd, float sm_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return forward<16>(q, k, v, out, lse, B, nh, n, sm_scale, st);
    case 32: return forward<32>(q, k, v, out, lse, B, nh, n, sm_scale, st);
    case 64: return forward<64>(q, k, v, out, lse, B, nh, n, sm_scale, st);
    case 128: return forward<128>(q, k, v, out, lse, B, nh, n, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// softmax(bf16(q * sm_scale).k^T).v on the instance HD >= hd
template <int HD>
int mha(const void* q, const void* k, const void* v, void* out, int B, int nh, int n, int hd,
        float sm_scale, cudaStream_t st) {
  using S = ddmi_flash::FwdShape<HD>;
  const int bh = B * nh;
  ddmi_flash::FwdParams p{};
  if (!tensor_map(&p.q, q, hd, n, bh, S::BM, HD) || !tensor_map(&p.k, k, hd, n, bh, S::BN, HD) ||
      !tensor_map(&p.v, v, hd, n, bh, S::BN, HD))
    return cudaErrorInvalidValue;
  ddmi_flash::head_major_out(p, out, nh, n, hd);
  p.n = n;
  p.q_prescale = 1;
  p.q_scale = sm_scale;
  p.scale_log2 = ddmi_flash::LOG2E;  // q carries the scale
  return ddmi_flash::launch_fwd<HD>(p, bh, st);
}

// in: q, k, v, dout; stats: lse, di; grads: dq, dk, dv
template <int HD>
int backward(const void* const (&in)[4], const float* const (&stats)[2], void* const (&grads)[3],
             int bh, int n, float sm_scale, cudaStream_t st) {
  using S = ddmi_flash::BwdShape<HD>;
  ddmi_flash::BwdParams p{};
  if (!tensor_map(&p.q64, in[0], HD, n, bh, S::SMALL) || !tensor_map(&p.do64, in[3], HD, n, bh, S::SMALL) ||
      !tensor_map(&p.k128, in[1], HD, n, bh, S::BIG) || !tensor_map(&p.v128, in[2], HD, n, bh, S::BIG) ||
      !tensor_map(&p.q128, in[0], HD, n, bh, S::BIG) || !tensor_map(&p.do128, in[3], HD, n, bh, S::BIG) ||
      !tensor_map(&p.k64, in[1], HD, n, bh, S::SMALL) || !tensor_map(&p.v64, in[2], HD, n, bh, S::SMALL))
    return cudaErrorInvalidValue;
  p.lse = stats[0];
  p.di = stats[1];
  p.dq = static_cast<__nv_bfloat16*>(grads[0]);
  p.dk = static_cast<__nv_bfloat16*>(grads[1]);
  p.dv = static_cast<__nv_bfloat16*>(grads[2]);
  p.n = n;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * ddmi_flash::LOG2E;
  return ddmi_flash::launch_bwd<HD>(p, bh, st);
}

}  // namespace

extern "C" {

// q, k, v, out: (B, nh, n, hd) bf16, contiguous, 16-byte aligned; hd 16, 32,
// 64 or 128 (the wrapper zero-pads other head dims), any n >= 1.  Each
// returns the cudaError_t of its launch (cudaErrorInvalidValue for operands
// it does not take).
int ddmi_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int nh,
                         int n, int hd, float sm_scale, void* stream) {
  return forward(q, k, v, out, nullptr, B, nh, n, hd, sm_scale, stream);
}

// As ddmi_flash_attention, and lse (B, nh, n) fp32 gets each row's
// log-sum-exp (natural log) of the scaled scores.
int ddmi_flash_attention_lse(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int nh, int n, int hd, float sm_scale, void* stream) {
  return forward(q, k, v, out, static_cast<float*>(lse), B, nh, n, hd, sm_scale, stream);
}

// q, k, v, dout, dq, dk, dv: (B, nh, n, hd) bf16, contiguous; lse, di:
// (B, nh, n) fp32.  Two launches (dk/dv, then dq); returns the first error.
int ddmi_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* di, void* dq, void* dk, void* dv,
                             int B, int nh, int n, int hd, float sm_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* in[4] = {q, k, v, dout};
  void* grads[3] = {dq, dk, dv};
  const float* stats[2] = {static_cast<const float*>(lse), static_cast<const float*>(di)};
  if (n < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return backward<16>(in, stats, grads, B * nh, n, sm_scale, st);
    case 32: return backward<32>(in, stats, grads, B * nh, n, sm_scale, st);
    case 64: return backward<64>(in, stats, grads, B * nh, n, sm_scale, st);
    case 128: return backward<128>(in, stats, grads, B * nh, n, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// q, k, v, out: (B, nh, n, hd) bf16, contiguous, 16-byte aligned; hd a
// multiple of 8 up to 128 (the wrapper zero-pads others), any n >= 1.  Runs
// on the instance 16, 32, 64 or 128 that holds hd.  Returns the cudaError_t
// of its launch.
int ddmi_mha_vmem(const void* q, const void* k, const void* v, void* out, int B, int nh, int n,
                  int hd, float sm_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n < 1 || hd < 8 || hd > 128 || hd % 8) return cudaErrorInvalidValue;
  if (hd <= 16) return mha<16>(q, k, v, out, B, nh, n, hd, sm_scale, st);
  if (hd <= 32) return mha<32>(q, k, v, out, B, nh, n, hd, sm_scale, st);
  if (hd <= 64) return mha<64>(q, k, v, out, B, nh, n, hd, sm_scale, st);
  return mha<128>(q, k, v, out, B, nh, n, hd, sm_scale, st);
}

// The dynamic shared memory a launch asks for: the forward (kernel 0) or
// each backward kernel (1) at head dim hd; 0 for an hd without an instance.
int ddmi_flash_smem_bytes(int kernel, int hd) {
  switch (hd) {
    case 16: return (int)(kernel ? ddmi_flash::BwdShape<16>::SMEM : ddmi_flash::FwdShape<16>::SMEM);
    case 32: return (int)(kernel ? ddmi_flash::BwdShape<32>::SMEM : ddmi_flash::FwdShape<32>::SMEM);
    case 64: return (int)(kernel ? ddmi_flash::BwdShape<64>::SMEM : ddmi_flash::FwdShape<64>::SMEM);
    case 128: return (int)(kernel ? ddmi_flash::BwdShape<128>::SMEM : ddmi_flash::FwdShape<128>::SMEM);
    default: return 0;
  }
}

}  // extern "C"
