// Fused residual add + RMSNorm, for Hopper.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/rmsnorm.py
// `_fwd_kernel` (:39): per row, h = x (+ res) in fp32, inv = rsqrt(mean(h^2)
// + eps), y = (h * inv) * w in fp32; writes y and h in the io type and inv
// in fp32.  Without a residual h is x itself (written back in the io type,
// as the TPU kernel writes it).
//
// Design: one warp per row, 8 rows per block of 256 threads.  Pass one
// reads x (and res), sums the squares in fp32 and writes h; pass two reads
// the row again (an L1 hit: the warp has just read it) and writes y, so
// each byte crosses device memory once.  Rows move in 16-byte vectors when
// every row of every operand starts on a 16-byte boundary (aligned base
// pointers and d * sizeof(T) a multiple of 16), element by element
// otherwise, so any row count and any d is taken.
//
// What bounds it: bytes.  At T = 8192, d = 4096 in bf16 with a residual it
// moves 268 MB (x, res read, y, h written): 0.080 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int ROWS = 8;           // rows (warps) per block
constexpr int NT = 32 * ROWS;

template <typename T, bool VEC, bool RES>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* x, const T* res, const T* w, T* y, T* h, float* inv,
               int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * ROWS + threadIdx.x / 32;
  if (r >= rows) return;
  const size_t off = (size_t)r * d;
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  float ss = 0.f;
  // pass one: h = x (+ res), sum of squares
  for (int c = lane * V; c < d; c += 32 * V) {
    alignas(16) T xe[V], re[V], he[V];
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(xe) =
          *reinterpret_cast<const uint4*>(x + off + c);
      if constexpr (RES)
        *reinterpret_cast<uint4*>(re) =
            *reinterpret_cast<const uint4*>(res + off + c);
    } else {
      xe[0] = x[off + c];
      if constexpr (RES) re[0] = res[off + c];
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v = ptt::to_f(xe[i]);
      if constexpr (RES) v += ptt::to_f(re[i]);
      ss += v * v;
      he[i] = ptt::from_f<T>(v);
    }
    if constexpr (VEC)
      *reinterpret_cast<uint4*>(h + off + c) =
          *reinterpret_cast<const uint4*>(he);
    else
      h[off + c] = he[0];
  }
  ss = ptt::warp_sum(ss);
  const float iv = rsqrtf(ss / (float)d + eps);
  if (lane == 0) inv[r] = iv;
  // pass two: y = (h * inv) * w, h recomputed in fp32 from the same reads
  for (int c = lane * V; c < d; c += 32 * V) {
    alignas(16) T xe[V], re[V], we[V], ye[V];
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(xe) =
          *reinterpret_cast<const uint4*>(x + off + c);
      if constexpr (RES)
        *reinterpret_cast<uint4*>(re) =
            *reinterpret_cast<const uint4*>(res + off + c);
      *reinterpret_cast<uint4*>(we) = *reinterpret_cast<const uint4*>(w + c);
    } else {
      xe[0] = x[off + c];
      if constexpr (RES) re[0] = res[off + c];
      we[0] = w[c];
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v = ptt::to_f(xe[i]);
      if constexpr (RES) v += ptt::to_f(re[i]);
      ye[i] = ptt::from_f<T>((v * iv) * ptt::to_f(we[i]));
    }
    if constexpr (VEC)
      *reinterpret_cast<uint4*>(y + off + c) =
          *reinterpret_cast<const uint4*>(ye);
    else
      y[off + c] = ye[0];
  }
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
