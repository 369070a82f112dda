// Fused residual add + RMSNorm, for Hopper.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/rmsnorm.py
// `_fwd_kernel` (:39): per row, h = x (+ res) in fp32, inv = rsqrt(mean(h^2)
// + eps), y = (h * inv) * w in fp32; writes y in the io type, inv in fp32
// and, with a residual, h in the io type.  Without one, h is x itself (x
// to fp32 and back is exact), so nothing writes it: the wrapper returns x.
//
// What bounds it: bytes.  At T = 8192, d = 4096 in bf16 it moves 268 MB
// with a residual (x, res read, y, h written: 0.080 ms at 3.35 TB/s) and
// 134 MB without (x read, y written: 0.040 ms).
//
// Design (rmsnorm_regs_kernel): each input byte is read once, and all of a
// row's loads are in flight before its sum of squares.  A row of d
// elements is W warps' (W = 1, 2, 4 or 8 by d, 8 / W rows a block of 256
// threads); thread t of the row loads its 16-byte vectors t, t + 32 W, ...
// (KV <= 4 of them) of x and res into registers in one round, sums their
// squares in fp32, the warps' sums meet in shared memory in warp order,
// and the same registers give y = (h * inv) * w (and h), stored as 16-byte
// vectors.  The grid is a block for every 8 / W rows, so the card holds
// eight 256-thread blocks a SM, 64 KB of loads in flight at d = 4096.
// Rows that are not all on the 16-byte grid (an unaligned pointer, or d *
// sizeof(T) not a multiple of 16), or longer than the registers take (d
// past 8192 in bf16, 4096 in fp32), run the first design (rmsnorm_row.cuh,
// a warp a row in two passes, element by element where unaligned), so any
// row count and any d is taken.
#include "rmsnorm_row.cuh"

namespace {

using ptt::norm::NT;
using ptt::norm::ROWS;

constexpr int kMaxVecs = 4;   // 16-byte vectors a thread holds of a row

template <typename T, bool VEC, bool RES>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* x, const T* res, const T* w, T* y, T* h, float* inv,
               int rows, int d, float eps) {
  const int r = blockIdx.x * ROWS + threadIdx.x / 32;
  if (r >= rows) return;
  ptt::norm::rmsnorm_row<T, VEC, RES>(x, res, w, y, h, inv, r, d, eps);
}

template <typename T, bool RES, int KV>
__global__ void __launch_bounds__(NT)
rmsnorm_regs_kernel(const T* x, const T* res, const T* w, T* y, T* h,
                    float* inv, int rows, int d, int W, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float part[NT / 32];
  const int per = 32 * W;                       // threads of a row
  const int t = threadIdx.x % per;
  const int r = blockIdx.x * (NT / per) + threadIdx.x / per;
  const bool live = r < rows;   // every thread meets the barrier below
  const size_t off = (size_t)r * d;
  uint4 xv[KV], rv[KV];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int c = (k * per + t) * V;
    if (live && c < d) {
      xv[k] = *reinterpret_cast<const uint4*>(x + off + c);
      if constexpr (RES) rv[k] = *reinterpret_cast<const uint4*>(res + off + c);
    }
  }
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    if (!live || (k * per + t) * V >= d) continue;
    const T* xe = reinterpret_cast<const T*>(&xv[k]);
    const T* re = reinterpret_cast<const T*>(&rv[k]);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v = ptt::to_f(xe[i]);
      if constexpr (RES) v += ptt::to_f(re[i]);
      ss += v * v;
    }
  }
  ss = ptt::warp_sum(ss);
  const int warp = threadIdx.x / 32, first = warp - warp % W;
  if (threadIdx.x % 32 == 0) part[warp] = ss;
  __syncthreads();
  if (!live) return;
  float tot = 0.f;
  for (int i = 0; i < W; ++i) tot += part[first + i];
  const float iv = rsqrtf(tot / (float)d + eps);
  if (t == 0 && inv != nullptr) inv[r] = iv;
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int c = (k * per + t) * V;
    if (c >= d) continue;
    const uint4 wv = *reinterpret_cast<const uint4*>(w + c);
    const T* xe = reinterpret_cast<const T*>(&xv[k]);
    const T* re = reinterpret_cast<const T*>(&rv[k]);
    const T* we = reinterpret_cast<const T*>(&wv);
    alignas(16) T ye[V], he[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v = ptt::to_f(xe[i]);
      if constexpr (RES) v += ptt::to_f(re[i]);
      ye[i] = ptt::from_f<T>((v * iv) * ptt::to_f(we[i]));
      he[i] = ptt::from_f<T>(v);
    }
    *reinterpret_cast<uint4*>(y + off + c) =
        *reinterpret_cast<const uint4*>(ye);
    if constexpr (RES)
      *reinterpret_cast<uint4*>(h + off + c) =
          *reinterpret_cast<const uint4*>(he);
  }
}

template <typename T, bool VEC, bool RES>
int launch_rows(const void* x, const void* res, const void* w, void* y,
                void* h, void* inv, int rows, int d, float eps,
                cudaStream_t stream) {
  rmsnorm_kernel<T, VEC, RES><<<(rows + ROWS - 1) / ROWS, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const T*>(w), static_cast<T*>(y), static_cast<T*>(h),
      static_cast<float*>(inv), rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool RES, int KV>
int launch_regs(const void* x, const void* res, const void* w, void* y,
                void* h, void* inv, int rows, int d, int W, float eps,
                cudaStream_t stream) {
  const int per_block = NT / (32 * W);
  rmsnorm_regs_kernel<T, RES, KV>
      <<<(rows + per_block - 1) / per_block, NT, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(res),
          static_cast<const T*>(w), static_cast<T*>(y), static_cast<T*>(h),
          static_cast<float*>(inv), rows, d, W, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool RES>
int launch_res(const void* x, const void* res, const void* w, void* y,
               void* h, void* inv, int rows, int d, float eps,
               cudaStream_t s) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(res) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(h);
  if (any % 16 != 0 || (d * sizeof(T)) % 16 != 0)
    return launch_rows<T, false, RES>(x, res, w, y, h, inv, rows, d, eps, s);
  // the fewest warps a row that leave a thread at most two vectors, up to
  // eight warps; then the vectors a thread holds
  const int vecs = d / (16 / (int)sizeof(T));
  int W = 1;
  while (W < 8 && vecs > 2 * 32 * W) W *= 2;
  const int kv = (vecs + 32 * W - 1) / (32 * W);
  if (kv > kMaxVecs)
    return launch_rows<T, true, RES>(x, res, w, y, h, inv, rows, d, eps, s);
  auto go = kv == 1   ? launch_regs<T, RES, 1>
            : kv == 2 ? launch_regs<T, RES, 2>
                      : launch_regs<T, RES, kMaxVecs>;
  return go(x, res, w, y, h, inv, rows, d, W, eps, s);
}

template <typename T>
int launch(const void* x, const void* res, const void* w, void* y, void* h,
           void* inv, int rows, int d, float eps, cudaStream_t s) {
  return res ? launch_res<T, true>(x, res, w, y, h, inv, rows, d, eps, s)
             : launch_res<T, false>(x, res, w, y, h, inv, rows, d, eps, s);
}

}  // namespace

extern "C" {

// y, h = rmsnorm(x (+ res)) * w, x (+ res); x, res, y, h [rows, d] and w [d]
// in one io type, inv [rows] fp32.  res null for none, and then h must be
// null too: h is x, and the caller keeps x.
int ptt_rmsnorm(int dtype, const void* x, const void* res, const void* w,
                void* y, void* h, void* inv, int rows, int d, float eps,
                void* stream) {
  if (rows <= 0 || d <= 0 || (res == nullptr) != (h == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return launch<__nv_bfloat16>(x, res, w, y, h, inv, rows, d, eps, s);
  if (dtype == ptt::DT_FLOAT32)
    return launch<float>(x, res, w, y, h, inv, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
