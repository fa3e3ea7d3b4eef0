// Multi-head attention over head-major (B, nh, n, hd) bf16 q/k/v for Hopper
// (sm_90a): three forward entry points on one streaming kernel
// (csrc/flash_attn.cuh) and the flash backward (csrc/flash_attn_bwd.cuh):
//
//   ddmi_mha_vmem        replaces ddmi_tpu/ops/pallas/attention.py::mha_vmem
//                        (body `_kernel`): q multiplied by the scale in fp32
//                        and rounded once to bf16 before q.k; the TPU kernel
//                        holds a whole (n, n) score matrix in VMEM (n <= 1024).
//   ddmi_flash_attention replaces the forward of the library Pallas kernel
//                        jax.experimental.pallas.ops.tpu.flash_attention, as
//                        called at ddmi_tpu/nn/attention1d.py:77 and
//                        ddmi_tpu/nn/unet.py:185: fp32 scores multiplied by
//                        the scale, K/V streamed in blocks (n up to 73,728 on
//                        the video decoder).
//   ddmi_flash_attention_lse   the flash forward that also writes each row's
//                        log-sum-exp, taken when a gradient will be needed;
//   ddmi_flash_attention_bwd   replaces the library's backward kernels
//                        _flash_attention_bwd_dkv and _flash_attention_bwd_dq
//                        (flash_attention.py:1121, :1456): dq, dk, dv from
//                        q, k, v, do, the forward's LSE and di = sum(o * do),
//                        two launches (see flash_attn_bwd.cuh).
//
// The forwards compute softmax(q.k^T * s).v with fp32 scores, an online
// softmax and the division after P.V.  mha_vmem and flash differ only in
// where the scale is rounded, which each wrapper reproduces.  A 227 KB
// shared memory cannot hold a whole head's K/V at n = 1024, hd = 128
// (512 KB), so all stream K/V in 64-key tiles; see flash_attn.cuh for the
// design and what bounds it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attn.cuh"
#include "flash_attn_bwd.cuh"

namespace {

int run(const void* q, const void* k, const void* v, void* out, int B, int nh, int n, int hd,
        float sm_scale, int prescale_q, float* lse, void* stream) {
  ddmi_attn::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.out_sh = (long long)n * hd;
  p.out_sb = p.out_sh * nh;
  p.out_si = hd;
  p.B = B; p.nh = nh; p.n = n;
  p.scale = sm_scale;
  p.prescale_q = prescale_q;
  p.lse = lse;
  return ddmi_attn::launch_hd(hd, p, reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// q, k, v, out: (B, nh, n, hd) bf16, contiguous; hd a multiple of 16 up to
// 128, any n >= 1.  Each returns the cudaError_t of its launch.
int ddmi_mha_vmem(const void* q, const void* k, const void* v, void* out, int B, int nh, int n,
                  int hd, float sm_scale, void* stream) {
  return run(q, k, v, out, B, nh, n, hd, sm_scale, 1, nullptr, stream);
}

int ddmi_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int nh,
                         int n, int hd, float sm_scale, void* stream) {
  return run(q, k, v, out, B, nh, n, hd, sm_scale, 0, nullptr, stream);
}

// As ddmi_flash_attention, and lse (B, nh, n) fp32 gets each row's
// log-sum-exp of the scaled scores.
int ddmi_flash_attention_lse(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int nh, int n, int hd, float sm_scale, void* stream) {
  return run(q, k, v, out, B, nh, n, hd, sm_scale, 0, static_cast<float*>(lse), stream);
}

// q, k, v, dout, dq, dk, dv: (B, nh, n, hd) bf16, contiguous; lse, di:
// (B, nh, n) fp32.  Two launches (dk/dv, then dq); returns the first error.
int ddmi_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* di, void* dq, void* dk, void* dv,
                             int B, int nh, int n, int hd, float sm_scale, void* stream) {
  ddmi_attn_bwd::BwdParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B; p.nh = nh; p.n = n;
  p.scale = sm_scale;
  return ddmi_attn_bwd::launch_bwd_hd(hd, p, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
