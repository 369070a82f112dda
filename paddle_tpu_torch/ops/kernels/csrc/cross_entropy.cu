// Fused softmax cross-entropy over [T, V] logits, for Hopper.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/cross_entropy.py
// `_fwd_kernel` (:75) and `_bwd_kernel` (:145).
//
//   forward   loss[t] = lse[t] - x[t, label[t]],  lse[t] = log sum_j exp(x[t, j])
//             One block per row streams the row once in 16-byte vector
//             loads (8 bf16/fp16 or 4 fp32 values), keeping a per-thread
//             online max and sum in fp32 that start, as the TPU kernel's
//             scratch does, at m = -1e30, s = 0: a -inf logit then adds
//             exp(-inf) = 0 and never a NaN.  The threads' (m, s) pairs merge
//             by warp shuffles and one shared-memory step.  Thread 0 reads the
//             gold logit directly (a label outside [0, V) matches no column:
//             gold = 0 and the loss is lse, as on the TPU) and writes loss and
//             lse in fp32.  A row whose logits are all -inf has lse = -inf.
//   backward  dx[t, j] = (exp(x[t, j] - lse[t]) - [j == label[t]]) * g[t],
//             written in x's type; one block per row, 16-byte loads and
//             stores.
//
// Rows need not be 16-byte aligned (V = 50257 puts every other row off the
// grid): each row takes its first elements one at a time up to the next
// 16-byte boundary, then whole vectors, then the tail one at a time.  Row
// offsets are 64-bit: T * V passes 2^31 at V = 128256, T = 16384.
//
// What bounds it: each reads the logits once (and the backward writes dx
// once), about 0.07 flop per byte, so device-memory bytes set its speed:
// 824 MB of bf16 logits at T = 8192, V = 50304 take 0.246 ms at 3.35 TB/s.
// exp is __expf (ex2.approx with a multiply), about 2 ulp, well inside
// the fp32 sums and far inside a bf16 dx, so the special-function units do
// not become the limit.
#include "common.cuh"

namespace {

constexpr float kNegInit = -1e30f;   // the TPU kernel's _NEG_INF

// merge the online-softmax state (m2, s2) into (m, s)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  float mn = fmaxf(m, m2);
  s = s * __expf(m - mn) + s2 * __expf(m2 - mn);
  m = mn;
}

// elements of a row up to its first 16-byte boundary
template <typename T>
__device__ __forceinline__ int head_of(const T* row, int V) {
  int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  int h = mis ? (16 - mis) / static_cast<int>(sizeof(T)) : 0;
  return h < V ? h : V;
}

template <typename T>
__global__ void ce_fwd_kernel(const T* __restrict__ x,
                              const int64_t* __restrict__ lbl,
                              float* __restrict__ loss,
                              float* __restrict__ lse, int V) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* xr = x + row * static_cast<size_t>(V);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int head = head_of(xr, V);
  const int nvec = (V - head) / VEC;
  const int tail = head + nvec * VEC;

  float m = kNegInit, s = 0.f;
  auto add1 = [&](float v) {
    if (v > m) {
      s = s * __expf(m - v) + 1.f;
      m = v;
    } else {
      s += __expf(v - m);
    }
  };
  for (int j = tid; j < head; j += nt) add1(ptt::to_f(xr[j]));
  for (int j = tail + tid; j < V; j += nt) add1(ptt::to_f(xr[j]));
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  for (int i = tid; i < nvec; i += nt) {
    uint4 raw = __ldg(xv + i);
    const T* e = reinterpret_cast<const T*>(&raw);
    float f[VEC];
    float vm = kNegInit;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      f[k] = ptt::to_f(e[k]);
      vm = fmaxf(vm, f[k]);
    }
    float mn = fmaxf(m, vm);
    float acc = s * __expf(m - mn);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc += __expf(f[k] - mn);
    m = mn;
    s = acc;
  }

  // block reduction of (m, s)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  __shared__ float sm[32], ss[32];
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nw; ++w) merge(m, s, sm[w], ss[w]);
    const float l = m + logf(s);
    const int64_t c = lbl[row];
    const float gold = (c >= 0 && c < V) ? ptt::to_f(xr[c]) : 0.f;
    lse[row] = l;
    loss[row] = l - gold;
  }
}

template <typename T>
__global__ void ce_bwd_kernel(const T* __restrict__ x,
                              const int64_t* __restrict__ lbl,
                              const float* __restrict__ lse,
                              const float* __restrict__ g, T* __restrict__ dx,
                              int V) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const size_t off = row * static_cast<size_t>(V);
  const T* xr = x + off;
  T* dr = dx + off;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float l = lse[row], gr = g[row];
  const int64_t c = lbl[row];
  const int head = head_of(xr, V);
  const int nvec = (V - head) / VEC;
  const int tail = head + nvec * VEC;
  auto one = [&](int j) {
    float p = __expf(ptt::to_f(xr[j]) - l);
    dr[j] = ptt::from_f<T>((p - (j == c ? 1.f : 0.f)) * gr);
  };
  for (int j = tid; j < head; j += nt) one(j);
  for (int j = tail + tid; j < V; j += nt) one(j);
  // x and dx share their offset from a 16-byte boundary when the wrapper
  // allocates dx aligned and x's base is aligned; otherwise store scalars
  const bool vec_store =
      ((reinterpret_cast<uintptr_t>(dr + head) & 15) == 0);
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  for (int i = tid; i < nvec; i += nt) {
    uint4 raw = __ldg(xv + i);
    const T* e = reinterpret_cast<const T*>(&raw);
    const int j0 = head + i * VEC;
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float p = __expf(ptt::to_f(e[k]) - l);
      r[k] = ptt::from_f<T>((p - (j0 + k == c ? 1.f : 0.f)) * gr);
    }
    if (vec_store) {
      *reinterpret_cast<uint4*>(dr + j0) = res;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) dr[j0 + k] = r[k];
    }
  }
}

// a block per row: 256 threads, or one warp where the row holds fewer
// than 256 vectors
int threads_for(int V, int vec) { return V / vec >= 256 ? 256 : 32; }

template <typename T>
int fwd_t(const void* x, const void* lbl, void* loss, void* lse, int T_, int V,
          cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  ce_fwd_kernel<T><<<T_, threads_for(V, VEC), 0, st>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(lbl),
      static_cast<float*>(loss), static_cast<float*>(lse), V);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_t(const void* x, const void* lbl, const void* lse, const void* g,
          void* dx, int T_, int V, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  ce_bwd_kernel<T><<<T_, threads_for(V, VEC), 0, st>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(lbl),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dx), V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// loss, lse [T] fp32 from logits x [T, V] (float32, bfloat16 or float16)
// and int64 labels [T].
int ptt_ce_fwd(int dtype, const void* x, const void* lbl, void* loss,
               void* lse, int T, int V, void* stream) {
  if (T <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return fwd_t<__nv_bfloat16>(x, lbl, loss, lse, T, V, s);
  if (dtype == ptt::DT_FLOAT16) return fwd_t<__half>(x, lbl, loss, lse, T, V, s);
  if (dtype == ptt::DT_FLOAT32) return fwd_t<float>(x, lbl, loss, lse, T, V, s);
  return (int)cudaErrorInvalidValue;
}

// dx [T, V] in x's type from x, labels, lse [T] and the fp32 cotangent g [T].
int ptt_ce_bwd(int dtype, const void* x, const void* lbl, const void* lse,
               const void* g, void* dx, int T, int V, void* stream) {
  if (T <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return bwd_t<__nv_bfloat16>(x, lbl, lse, g, dx, T, V, s);
  if (dtype == ptt::DT_FLOAT16)
    return bwd_t<__half>(x, lbl, lse, g, dx, T, V, s);
  if (dtype == ptt::DT_FLOAT32)
    return bwd_t<float>(x, lbl, lse, g, dx, T, V, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
