// Multi-head attention over head-major (B, nh, n, hd) bf16 q/k/v for Hopper
// (sm_90a) on the streaming kernel of csrc/flash_attn.cuh:
//
//   ddmi_mha_vmem        replaces ddmi_tpu/ops/pallas/attention.py::mha_vmem
//                        (body `_kernel`): q multiplied by the scale in fp32
//                        and rounded once to bf16 before q.k; the TPU kernel
//                        holds a whole (n, n) score matrix in VMEM (n <= 1024).
//
// It computes softmax(bf16(q * s).k^T).v with fp32 scores, an online softmax
// and the division after P.V.  A 227 KB shared memory cannot hold a whole
// head's K/V at n = 1024, hd = 128 (512 KB), so K/V stream in 64-key tiles;
// see flash_attn.cuh for the design and what bounds it.  The flash
// attention entries are in csrc/flash.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attn.cuh"

extern "C" {

// q, k, v, out: (B, nh, n, hd) bf16, contiguous; hd a multiple of 16 up to
// 128 (the wrapper zero-pads others), any n >= 1.  Returns the cudaError_t
// of its launch.
int ddmi_mha_vmem(const void* q, const void* k, const void* v, void* out, int B, int nh, int n,
                  int hd, float sm_scale, void* stream) {
  ddmi_attn::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.nh = nh; p.n = n;
  p.scale = sm_scale;
  return ddmi_attn::launch_hd(hd, p, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
