// Host-side TMA tensor maps for the Hopper kernels (flash.cu,
// attn_block.cu, nerf_mlp.cu, inr_decode.cu).  cuTensorMapEncodeTiled comes
// from the runtime's driver entry point, so no library needs -lcuda.  Every
// map is of bf16 elements, encoded inside the one ctypes call that launches
// the kernel; TMA fills elements past a tensor's end with zeros.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ddmi_tma {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

inline CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// the (hd, n, bh) map of a contiguous (bh, n, hd) bf16 tensor, boxes of
// `rows` rows by one swizzle panel of the kernel instance for head dim `inst`
// (min(inst * 2, 128) bytes; inst 0: hd).  With hd < inst the columns past
// hd read as zeros, so a tensor of any head dim that is a multiple of 8 (a
// row pitch of 16 bytes) runs on the next instance without a padded copy.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int n, int bh, int rows,
                       int inst = 0) {
  if (inst == 0) inst = hd;
  if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || hd % 8 != 0 || hd > inst)
    return false;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const int rowb = inst * 2 < 128 ? inst * 2 : 128;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)n * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)rowb / 2, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(rowb), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the (cols, rows) map of a row-major (rows, cols) bf16 matrix, boxes of
// `box_rows` rows by 64 columns (one 128-byte swizzle panel)
inline bool matrix_map(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_rows) {
  if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || cols % 8 != 0) return false;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ddmi_tma
