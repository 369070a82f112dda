// Helpers shared by the port's CUDA kernels (sm_90a, built with nvcc by
// ops/kernels/_build.py into shared libraries with a plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// dtype codes of the C interface (ops/kernels/_build.py DTYPE_CODES for
// the io types, WEIGHT_CODES for quantized weights)
// (float16: the cross-entropy kernels only)
enum DType {
  DT_FLOAT32 = 0,
  DT_BFLOAT16 = 1,
  DT_INT8 = 2,
  DT_FP8_E4M3 = 3,
  DT_FLOAT16 = 4
};

// the design a launch took, written by the C entries that report it
// (ops/kernels/fused_block.py GEMM_PATHS, in this order; paged_attention.cu
// has its own)
enum Design { DESIGN_WGMMA = 0, DESIGN_TILE = 1, DESIGN_SPLITK = 2 };

// err, and the design behind `out` (an int) where the launch went out
inline int launched(int err, void* out, int d) {
  if (err == 0) *static_cast<int*>(out) = d;
  return err;
}

// 16-byte global -> shared copy that bypasses the registers; with
// pred == false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// a load through L2 only (ld.global.cg): data that another block wrote in
// the same launch, before a grid-wide barrier, is never read from a stale
// L1 line
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ldcg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ptt

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
