// One row of the fused residual add + RMSNorm (rmsnorm.cu says what it
// replaces and what bounds it), as a device function run by one warp in
// two passes over the row (the second re-reads it, mostly from L1): the
// row pass of fused_block.cu's RMSNorm+QKV at T > 16 (x -> xn, inv), and
// rmsnorm.cu's rows that its register design does not take (off the
// 16-byte grid, or too long):
//   h = x (+ res) in fp32, inv = rsqrt(mean(h^2) + eps),
//   y = (h * inv) * w in fp32, cast to T.
// h is written in T where `h` is non-null, inv in fp32 where `inv` is.
// VEC: every row of every operand starts on a 16-byte boundary, so the
// row moves in 16-byte vectors; else element by element.
#pragma once

#include "common.cuh"

namespace ptt {
namespace norm {

constexpr int ROWS = 8;           // rows (warps) per block
constexpr int NT = 32 * ROWS;

template <typename T, bool VEC, bool RES>
__device__ __forceinline__ void rmsnorm_row(const T* x, const T* res,
                                            const T* w, T* y, T* h,
                                            float* inv, int r, int d,
                                            float eps) {
  const int lane = threadIdx.x % 32;
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
    if (h == nullptr) continue;
    if constexpr (VEC)
      *reinterpret_cast<uint4*>(h + off + c) =
          *reinterpret_cast<const uint4*>(he);
    else
      h[off + c] = he[0];
  }
  ss = ptt::warp_sum(ss);
  const float iv = rsqrtf(ss / (float)d + eps);
  if (lane == 0 && inv != nullptr) inv[r] = iv;
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

}  // namespace norm
}  // namespace ptt
