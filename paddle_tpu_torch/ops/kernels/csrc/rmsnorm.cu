// Fused residual add + RMSNorm, for Hopper.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/rmsnorm.py
// `_fwd_kernel` (:39): per row, h = x (+ res) in fp32, inv = rsqrt(mean(h^2)
// + eps), y = (h * inv) * w in fp32; writes y and h in the io type and inv
// in fp32.  Without a residual h is x itself (written back in the io type,
// as the TPU kernel writes it).
//
// Design: one warp per row, 8 rows per block of 256 threads (the row's
// code is rmsnorm_row.cuh's, which fused_block.cu's QKV row pass shares).
// Pass one reads x (and res), sums the squares in fp32 and writes h; pass
// two reads the row again (an L1 hit: the warp has just read it) and
// writes y, so each byte crosses device memory once.  Rows move in
// 16-byte vectors when every row of every operand starts on a 16-byte
// boundary (aligned base pointers and d * sizeof(T) a multiple of 16),
// element by element otherwise, so any row count and any d is taken.
//
// What bounds it: bytes.  At T = 8192, d = 4096 in bf16 with a residual it
// moves 268 MB (x, res read, y, h written): 0.080 ms at 3.35 TB/s.
#include "rmsnorm_row.cuh"

namespace {

using ptt::norm::NT;
using ptt::norm::ROWS;

template <typename T, bool VEC, bool RES>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* x, const T* res, const T* w, T* y, T* h, float* inv,
               int rows, int d, float eps) {
  const int r = blockIdx.x * ROWS + threadIdx.x / 32;
  if (r >= rows) return;
  ptt::norm::rmsnorm_row<T, VEC, RES>(x, res, w, y, h, inv, r, d, eps);
}

template <typename T, bool VEC, bool RES>
int launch3(const void* x, const void* res, const void* w, void* y, void* h,
            void* inv, int rows, int d, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, VEC, RES><<<(rows + ROWS - 1) / ROWS, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const T*>(w), static_cast<T*>(y), static_cast<T*>(h),
      static_cast<float*>(inv), rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* res, const void* w, void* y, void* h,
           void* inv, int rows, int d, float eps, cudaStream_t s) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(res) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(h);
  const bool vec = any % 16 == 0 && (d * sizeof(T)) % 16 == 0;
  auto go = vec ? (res ? launch3<T, true, true> : launch3<T, true, false>)
                : (res ? launch3<T, false, true> : launch3<T, false, false>);
  return go(x, res, w, y, h, inv, rows, d, eps, s);
}

}  // namespace

extern "C" {

// y, h = rmsnorm(x (+ res)) * w, x (+ res); x, res, y, h [rows, d] and w [d]
// in one io type, res null for none; inv [rows] fp32.
int ptt_rmsnorm(int dtype, const void* x, const void* res, const void* w,
                void* y, void* h, void* inv, int rows, int d, float eps,
                void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return launch<__nv_bfloat16>(x, res, w, y, h, inv, rows, d, eps, s);
  if (dtype == ptt::DT_FLOAT32)
    return launch<float>(x, res, w, y, h, inv, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
