// Multi-tensor kernels, for Hopper: the optimizer step's global gradient
// norm and Adam / AdamW update, and the SDC sentinel's parameter digest,
// each one launch over every tensor.
//
// No Pallas kernel is replaced: the JAX package's step is one jitted
// program (paddle_tpu/jit/train_step.py:491-571) in which XLA fuses the
// per-leaf norm (one vdot a leaf) and the update rule
// (paddle_tpu/optimizer/optimizers.py:111-122 Adam, :144-155 AdamW, the
// fp32 master as in optimizer.py:121-148).  Run eagerly, the port issued
// about ten kernels a parameter for the update and one a parameter for
// the norm; these walk a device table of the tensors instead.
//
// What bounds them: bytes.  The norm reads every gradient once (Train's
// 1.92 B bf16 gradients: 3.8 GB, 1.15 ms at 3.35 TB/s); the update reads
// grad, both moments and the master (or the param, where it has none)
// and writes param, moments and master (28 bytes a bf16 parameter with a
// master: 53.8 GB, 16.1 ms).
//
// The tensors are cut into chunks of 2^16 elements; the table gives each
// tensor its pointers, element count, first chunk index and dtypes.
// Blocks of 256 threads stride over the chunk indices (a block walks the
// table forward as its chunks grow).
//
// The update, redesigned for HBM3.  The first design took four scalar
// elements 256 apart a thread a round: a warp's request on a 16-bit
// stream was 64 bytes, and with seven streams an element few bytes were
// in flight an SM; it reached 71-76% of the bound (PERF.md).  Now every
// stream moves in 16-byte vectors: a thread takes 8 elements a vector,
// one uint4 of a 16-bit stream and two of an fp32 stream, and issues
// every load of kRounds (2) vectors (grad, both moments, the master or
// the param) before any arithmetic.  Chunk edges are multiples of 8
// elements, so a tensor whose pointers are 16-byte aligned runs whole
// vectors up to its last numel % 8 elements, which (with every element
// of an unaligned tensor) take the scalar loop.  The grid is persistent:
// the resident blocks an SM (the occupancy query) times the SMs.  One,
// three or four vectors a round and streaming cache hints measured no
// faster (PERF.md).
//
// Norm (gradients fp32, bf16 or fp16; an inf or NaN propagates to the
// result): each chunk's fp32 sum of squares lands in a partial (a fixed
// tree inside the block); the last block to finish (an int32 ticket,
// reset by that block) sums each tensor's partials in chunk order, a
// warp a tensor, then the tensors in table order, and writes sqrt of the
// total.  The same inputs give the same bits on every launch.
//
// Update: reads lr, the update count, the clip scale (or none) and the
// step guard's keep flag (or none) from device memory, so a captured
// CUDA graph reads them at replay time.  Keep 0 returns before any
// store: a skipped step leaves every byte as it was.  The arithmetic is
// the reference's op order, each step rounded to fp32 (explicit _rn
// intrinsics: nothing contracts into an FMA; IEEE division and sqrt);
// the bias corrections 1 - b^t are fp32 (powf of the fp32 beta at the
// count), as the reference's traced step takes them.  The clip rounds
// the scaled gradient to its own dtype, as ClipGradByGlobalNorm casts it
// back; Adam's L2 decay is folded into the gradient in the work tensor's
// dtype (the 16-bit type of a 16-bit parameter without a master).
// Parameters and gradients are fp32, bf16 or fp16 in any pairing (AMP
// float16: fp16 parameters with fp32 masters, fp16 gradients); the
// master is written back to the parameter by one round-to-nearest cast
// (__float2half_rn for fp16), so a value past 65504 becomes inf.
// Digest (robustness/recovery.py's params_digest): the JAX package
// jits it (paddle_tpu/robustness/recovery.py:503-520) and XLA fuses the
// bitcast and the uint32 sum of each leaf.  Here one launch walks a table
// of the leaves (pointer, bytes, first chunk, element size 1, 2 or 4):
// each chunk of dchunk bytes (the caller's, a multiple of 16; the
// table's first-chunk column counts in it) is summed as uint32 (every
// element's bits
// zero-extended; 16-byte vector loads where the leaf is 16-byte aligned),
// the last block to finish sums each leaf's chunk partials, writes the
// per-leaf sums and folds them in leaf order into the FNV digest
// (acc = acc * 16777619 + sum, from 2166136261, all mod 2^32).  Integer
// arithmetic: the result equals the plain version's bit for bit.  Bound:
// bytes (every leaf read once).
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr long long CHUNK = 1LL << 16;
constexpr int UNROLL = 4;

struct NormEntry {
  const void* g;
  long long numel;
  long long chunk0;
  long long dt;
};

struct AdamEntry {
  void* p;
  const void* g;
  float* m;
  float* v;
  float* master;
  long long numel;
  long long chunk0;
  int dt;  // param dtype | grad dtype << 8 | master << 16
  float wd;
};

struct Hyper {
  float b1, omb1, b2, omb2, eps;
  int decoupled;
  int mp;  // multi_precision: the gradient is fp32 before the L2 decay
};

using bf16 = __nv_bfloat16;
using f16 = __half;

// the table index of chunk c, walking forward from t (a block's chunks
// only grow); empty tensors own no chunk and are stepped over
template <typename E>
__device__ __forceinline__ int entry_of(const E* tab, int n, int t,
                                        long long c) {
  while (t + 1 < n && tab[t + 1].chunk0 <= c) ++t;
  return t;
}

__device__ __forceinline__ float block_sum(float s, float* red) {
  s = ptt::warp_sum(s);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = s;
  __syncthreads();
  float tot = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) tot = __fadd_rn(tot, red[w]);
  __syncthreads();
  return tot;
}

template <typename G>
__device__ float chunk_sumsq(const G* __restrict__ g, long long lo,
                             long long hi) {
  float acc[UNROLL] = {0.f, 0.f, 0.f, 0.f};
  for (long long base = lo + threadIdx.x; base < hi; base += UNROLL * NT) {
    float x[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = base + (long long)k * NT;
      x[k] = i < hi ? ptt::to_f(g[i]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(x[k], x[k]));
  }
  return __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
}

__global__ void __launch_bounds__(NT)
norm_kernel(const NormEntry* __restrict__ tab, int n, long long nchunks,
            float* part, float* tsum, int* ticket, float* out) {
  __shared__ float red[NT / 32];
  __shared__ bool last;
  int t = 0;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    t = entry_of(tab, n, t, c);
    const NormEntry e = tab[t];
    const long long lo = (c - e.chunk0) * CHUNK;
    const long long hi = min(lo + CHUNK, e.numel);
    float s = e.dt == ptt::DT_BFLOAT16
                  ? chunk_sumsq(static_cast<const bf16*>(e.g), lo, hi)
              : e.dt == ptt::DT_FLOAT16
                  ? chunk_sumsq(static_cast<const f16*>(e.g), lo, hi)
                  : chunk_sumsq(static_cast<const float*>(e.g), lo, hi);
    s = block_sum(s, red);
    if (threadIdx.x == 0) part[c] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += NT / 32) {
    const long long c0 = tab[i].chunk0;
    const long long c1 = i + 1 < n ? tab[i + 1].chunk0 : nchunks;
    float s = 0.f;
    for (long long c = c0 + lane; c < c1; c += 32)
      s = __fadd_rn(s, __ldcg(part + c));
    s = ptt::warp_sum(s);
    if (lane == 0) tsum[i] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < n; ++i) total = __fadd_rn(total, tsum[i]);
    out[0] = __fsqrt_rn(total);
    *ticket = 0;
  }
}

// what a launch of the update reads once from device memory
struct Step {
  float lr, bc1, bc2, scale;
  bool clip;
};

// x rounded to T's precision (an identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ptt::to_f(ptt::from_f<T>(x));
}

// One element's update: gradient x (fp32 from G), moments
// mk, vk, work value w (the master, or the parameter), the tensor's decay
// wd; returns the new moments and work value.  P the parameter's type, G
// the gradient's, MASTER whether an fp32 master is the work tensor.
template <typename P, typename G, bool MASTER>
__device__ __forceinline__ void adam_elem(float x, float mk, float vk,
                                          float w, float wd, const Hyper& h,
                                          const Step& st, float& mn,
                                          float& vn, float& nw) {
  constexpr bool G16 = !std::is_same<G, float>::value;
  // the work tensor is 16-bit for a 16-bit parameter without a master
  constexpr bool W16 = !std::is_same<P, float>::value && !MASTER;
  if (st.clip) {                      // (g * scale).astype(g.dtype)
    x = __fmul_rn(x, st.scale);
    if (G16) x = round_to<G>(x);
  }
  if (!h.decoupled && wd != 0.f) {    // Adam's L2: g + wd * work
    float t = __fmul_rn(wd, w);
    if (W16) t = round_to<P>(t);
    x = __fadd_rn(x, t);
    // g + t stays 16-bit where both are the same 16-bit type
    if (W16 && std::is_same<G, P>::value && !h.mp) x = round_to<P>(x);
  }
  mn = __fadd_rn(__fmul_rn(h.b1, mk), __fmul_rn(h.omb1, x));
  vn = __fadd_rn(__fmul_rn(h.b2, vk), __fmul_rn(h.omb2, __fmul_rn(x, x)));
  const float mhat = __fdiv_rn(mn, st.bc1);
  const float vhat = __fdiv_rn(vn, st.bc2);
  float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (h.decoupled) upd = __fadd_rn(upd, __fmul_rn(wd, w));
  nw = __fsub_rn(w, __fmul_rn(st.lr, upd));
}

// one element at index i, scalar loads and stores (the tails)
template <typename P, typename G, bool MASTER>
__device__ __forceinline__ void adam_one(const AdamEntry& e, long long i,
                                         const Hyper& h, const Step& st) {
  P* p = static_cast<P*>(e.p);
  const float w = MASTER ? e.master[i] : ptt::to_f(p[i]);
  float mn, vn, nw;
  adam_elem<P, G, MASTER>(ptt::to_f(static_cast<const G*>(e.g)[i]), e.m[i],
                          e.v[i], w, e.wd, h, st, mn, vn, nw);
  e.m[i] = mn;
  e.v[i] = vn;
  if (MASTER) e.master[i] = nw;
  p[i] = ptt::from_f<P>(nw);
}

// -- 16-byte vectors -------------------------------------------------------

constexpr int VEC = 8;   // elements a thread a vector
// vectors whose loads a thread issues together before any arithmetic
constexpr int kRounds = 2;

// 8 elements of T as loaded: one uint4 of a 16-bit type, two of fp32
template <typename T>
struct Vec8 {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* p) {
  Vec8<T> v;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 2); ++k) v.u[k] = q[k];
  return v;
}

template <typename T>
__device__ __forceinline__ float at(const Vec8<T>& v, int i) {
  return ptt::to_f(reinterpret_cast<const T*>(v.u)[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&x)[VEC]) {
  Vec8<T> v;
  T* e = reinterpret_cast<T*>(v.u);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = ptt::from_f<T>(x[i]);
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 2); ++k) q[k] = v.u[k];
}

// elements [lo, hi) of one tensor (lo a multiple of VEC)
template <typename P, typename G, bool MASTER>
__device__ void adam_chunk(const AdamEntry& e, long long lo, long long hi,
                           const Hyper& h, const Step& st) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(e.p) |
                        reinterpret_cast<uintptr_t>(e.g) |
                        reinterpret_cast<uintptr_t>(e.m) |
                        reinterpret_cast<uintptr_t>(e.v) |
                        reinterpret_cast<uintptr_t>(e.master);
  const long long vend = any % 16 == 0 ? lo + (hi - lo) / VEC * VEC : lo;
  P* p = static_cast<P*>(e.p);
  const G* g = static_cast<const G*>(e.g);
  constexpr long long STEP = (long long)VEC * NT;
  for (long long i = lo + (long long)VEC * threadIdx.x; i < vend;
       i += STEP * kRounds) {
    // every load of the round's kRounds vectors first
    Vec8<G> gv[kRounds];
    Vec8<float> mv[kRounds], vv[kRounds], wm[kRounds];
    Vec8<P> wp[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long j = i + r * STEP;
      if (j >= vend) break;
      gv[r] = load8(g + j);
      mv[r] = load8(e.m + j);
      vv[r] = load8(e.v + j);
      if constexpr (MASTER) wm[r] = load8(e.master + j);
      else wp[r] = load8(p + j);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long j = i + r * STEP;
      if (j >= vend) break;
      float mn[VEC], vn[VEC], nw[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        adam_elem<P, G, MASTER>(at(gv[r], k), at(mv[r], k), at(vv[r], k),
                                MASTER ? at(wm[r], k) : at(wp[r], k), e.wd,
                                h, st, mn[k], vn[k], nw[k]);
      store8(e.m + j, mn);
      store8(e.v + j, vn);
      if constexpr (MASTER) store8(e.master + j, nw);
      store8(p + j, nw);
    }
  }
  for (long long i = vend + threadIdx.x; i < hi; i += NT)
    adam_one<P, G, MASTER>(e, i, h, st);
}

// a chunk of parameter type P: the gradient's type and the master from
// the table entry
template <typename P>
__device__ __forceinline__ void adam_by_grad(const AdamEntry& e, long long lo,
                                             long long hi, const Hyper& h,
                                             const Step& st) {
  const int gdt = (e.dt >> 8) & 0xff;
  constexpr bool P16 = !std::is_same<P, float>::value;
  const bool master = P16 && ((e.dt >> 16) & 1);
  if (gdt == ptt::DT_FLOAT32) {
    if (master) adam_chunk<P, float, P16>(e, lo, hi, h, st);
    else adam_chunk<P, float, false>(e, lo, hi, h, st);
  } else if (gdt == ptt::DT_BFLOAT16) {
    if (master) adam_chunk<P, bf16, P16>(e, lo, hi, h, st);
    else adam_chunk<P, bf16, false>(e, lo, hi, h, st);
  } else {
    if (master) adam_chunk<P, f16, P16>(e, lo, hi, h, st);
    else adam_chunk<P, f16, false>(e, lo, hi, h, st);
  }
}

__global__ void __launch_bounds__(NT)
adam_kernel(const AdamEntry* __restrict__ tab, int n, long long nchunks,
            Hyper h, const float* lr_p, const int* step_p,
            const float* scale_p, const unsigned char* keep_p) {
  if (keep_p != nullptr && *keep_p == 0) return;
  Step st;
  st.lr = *lr_p;
  const float t = static_cast<float>(*step_p);
  st.bc1 = __fsub_rn(1.f, powf(h.b1, t));
  st.bc2 = __fsub_rn(1.f, powf(h.b2, t));
  st.clip = scale_p != nullptr;
  st.scale = st.clip ? *scale_p : 1.f;
  int i = 0;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    i = entry_of(tab, n, i, c);
    const AdamEntry e = tab[i];
    const long long lo = (c - e.chunk0) * CHUNK;
    const long long hi = min(lo + CHUNK, e.numel);
    const int pdt = e.dt & 0xff;
    if (pdt == ptt::DT_FLOAT32)
      adam_by_grad<float>(e, lo, hi, h, st);
    else if (pdt == ptt::DT_BFLOAT16)
      adam_by_grad<bf16>(e, lo, hi, h, st);
    else
      adam_by_grad<f16>(e, lo, hi, h, st);
  }
}

struct DigestEntry {
  const void* p;
  long long nbytes;
  long long chunk0;
  long long esize;
};

__device__ __forceinline__ uint32_t word_sum(uint32_t w, long long esize) {
  if (esize == 4) return w;
  if (esize == 2) return (w & 0xFFFFu) + (w >> 16);
  return (w & 0xFFu) + ((w >> 8) & 0xFFu) + ((w >> 16) & 0xFFu) + (w >> 24);
}

__device__ __forceinline__ uint32_t elem_at(const unsigned char* p,
                                            long long b, long long esize) {
  if (esize == 4) return *reinterpret_cast<const uint32_t*>(p + b);
  if (esize == 2) return *reinterpret_cast<const uint16_t*>(p + b);
  return p[b];
}

__device__ __forceinline__ uint32_t warp_usum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// uint32 sum of bytes [lo, hi) of one leaf (lo a multiple of 16)
__device__ uint32_t chunk_usum(const DigestEntry& e, long long lo,
                               long long hi) {
  const unsigned char* p = static_cast<const unsigned char*>(e.p);
  uint32_t acc = 0;
  long long tail = lo;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p + lo);
    const long long nvec = (hi - lo) / 16;
    for (long long i = threadIdx.x; i < nvec; i += UNROLL * NT) {
      uint4 w[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long j = i + (long long)k * NT;
        w[k] = j < nvec ? __ldg(v + j) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        acc += word_sum(w[k].x, e.esize) + word_sum(w[k].y, e.esize) +
               word_sum(w[k].z, e.esize) + word_sum(w[k].w, e.esize);
    }
    tail = lo + nvec * 16;
  }
  for (long long b = tail + threadIdx.x * e.esize; b < hi;
       b += (long long)NT * e.esize)
    acc += elem_at(p, b, e.esize);
  return acc;
}

__global__ void __launch_bounds__(NT)
digest_kernel(const DigestEntry* __restrict__ tab, int n, long long nchunks,
              long long dchunk, uint32_t* part, int* ticket, uint32_t* out) {
  __shared__ uint32_t red[NT / 32];
  __shared__ bool last;
  int t = 0;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    t = entry_of(tab, n, t, c);
    const DigestEntry e = tab[t];
    const long long lo = (c - e.chunk0) * dchunk;
    const long long hi = min(lo + dchunk, e.nbytes);
    uint32_t s = warp_usum(chunk_usum(e, lo, hi));
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t tot = 0;
      for (int w = 0; w < NT / 32; ++w) tot += red[w];
      part[c] = tot;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += NT / 32) {
    const long long c0 = tab[i].chunk0;
    const long long c1 = i + 1 < n ? tab[i + 1].chunk0 : nchunks;
    uint32_t s = 0;
    for (long long c = c0 + lane; c < c1; c += 32) s += __ldcg(part + c);
    s = warp_usum(s);
    if (lane == 0) out[i] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t acc = 2166136261u;
    for (int i = 0; i < n; ++i) acc = acc * 16777619u + out[i];
    out[n] = acc;
    *ticket = 0;
  }
}

int sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

int grid_for(long long nchunks) {
  return static_cast<int>(std::min(nchunks, 8LL * sms()));
}

// the redesign's persistent grid: the blocks resident at once (the
// occupancy query, once a process), at most one a chunk
int adam_grid(long long nchunks) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, adam_kernel, NT,
                                                  0);
    return b > 0 ? b : 1;
  }();
  return static_cast<int>(std::min(nchunks, (long long)per_sm * sms()));
}

}  // namespace

extern "C" {

// the chunk size the tables are cut in (ops/kernels/multi_tensor.py)
int ptt_mt_chunk() { return static_cast<int>(CHUNK); }

// out[0] = sqrt(sum over every tensor of sum(fp32(g)^2)); part holds
// nchunks + n floats, ticket one int32 that is 0 between launches
int ptt_mt_norm(const void* table, int n, long long nchunks, void* part,
                void* ticket, void* out, void* stream) {
  if (n <= 0 || nchunks <= 0) return 0;
  float* p = static_cast<float*>(part);
  norm_kernel<<<grid_for(nchunks), NT, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const NormEntry*>(table), n, nchunks, p, p + nchunks,
      static_cast<int*>(ticket), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// the Adam / AdamW update of every tensor of the table (16-byte vectors,
// the persistent grid)
int ptt_mt_adam(const void* table, int n, long long nchunks, float b1,
                float omb1, float b2, float omb2, float eps, int decoupled,
                int mp, const void* lr, const void* step, const void* scale,
                const void* keep, void* stream) {
  if (n <= 0 || nchunks <= 0) return 0;
  adam_kernel<<<adam_grid(nchunks), NT, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamEntry*>(table), n, nchunks,
      Hyper{b1, omb1, b2, omb2, eps, decoupled, mp},
      static_cast<const float*>(lr), static_cast<const int*>(step),
      static_cast<const float*>(scale),
      static_cast<const unsigned char*>(keep));
  return static_cast<int>(cudaGetLastError());
}

// out[i] = the uint32 sum of leaf i's elements' bits, out[n] their FNV
// fold; the table cuts each leaf in chunks of dchunk bytes (a multiple of
// 16), part holds nchunks uint32, ticket one int32 that is 0 between
// launches
int ptt_mt_digest(const void* table, int n, long long nchunks,
                  long long dchunk, void* part, void* ticket, void* out,
                  void* stream) {
  if (dchunk <= 0 || dchunk % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || nchunks <= 0) return 0;
  digest_kernel<<<grid_for(nchunks), NT, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const DigestEntry*>(table), n, nchunks, dchunk,
      static_cast<uint32_t*>(part), static_cast<int*>(ticket),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
