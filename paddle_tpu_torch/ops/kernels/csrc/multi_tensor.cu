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
// Design (first, simple): the tensors are cut into chunks of 2^16
// elements; the table gives each tensor its pointers, element count,
// first chunk index and dtypes.  Blocks of 256 threads stride over the
// chunk indices (a block walks the table forward as its chunks grow),
// and each thread takes four elements 256 apart a round, loads first.
//
// Norm: each chunk's fp32 sum of squares lands in a partial (a fixed
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
// dtype (bf16 for a bf16 parameter without a master).
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

__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

// one chunk of one tensor: P the parameter's type, G the gradient's,
// MASTER whether an fp32 master is the work tensor
template <typename P, typename G, bool MASTER>
__device__ void adam_chunk(const AdamEntry& e, long long lo, long long hi,
                           const Hyper& h, float lr, float bc1, float bc2,
                           bool clip, float s) {
  constexpr bool GB = std::is_same<G, bf16>::value;
  // the work tensor is bf16 for a bf16 parameter without a master
  constexpr bool WB = std::is_same<P, bf16>::value && !MASTER;
  P* __restrict__ p = static_cast<P*>(e.p);
  const G* __restrict__ g = static_cast<const G*>(e.g);
  float* __restrict__ m = e.m;
  float* __restrict__ v = e.v;
  float* __restrict__ ms = e.master;
  const float wd = e.wd;
  for (long long base = lo + threadIdx.x; base < hi; base += UNROLL * NT) {
    float gf[UNROLL], mk[UNROLL], vk[UNROLL], w[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = base + (long long)k * NT;
      if (i < hi) {
        gf[k] = ptt::to_f(g[i]);
        mk[k] = m[i];
        vk[k] = v[i];
        w[k] = MASTER ? ms[i] : ptt::to_f(p[i]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = base + (long long)k * NT;
      if (i >= hi) continue;
      float x = gf[k];
      if (clip) {                         // (g * scale).astype(g.dtype)
        x = __fmul_rn(x, s);
        if (GB) x = rb(x);
      }
      if (!h.decoupled && wd != 0.f) {    // Adam's L2: g + wd * work
        float t = __fmul_rn(wd, w[k]);
        if (WB) t = rb(t);
        x = __fadd_rn(x, t);
        if (WB && GB && !h.mp) x = rb(x);
      }
      const float mn = __fadd_rn(__fmul_rn(h.b1, mk[k]), __fmul_rn(h.omb1, x));
      const float vn = __fadd_rn(__fmul_rn(h.b2, vk[k]),
                                 __fmul_rn(h.omb2, __fmul_rn(x, x)));
      const float mhat = __fdiv_rn(mn, bc1);
      const float vhat = __fdiv_rn(vn, bc2);
      float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
      if (h.decoupled) upd = __fadd_rn(upd, __fmul_rn(wd, w[k]));
      const float nw = __fsub_rn(w[k], __fmul_rn(lr, upd));
      m[i] = mn;
      v[i] = vn;
      if (MASTER) ms[i] = nw;
      p[i] = ptt::from_f<P>(nw);
    }
  }
}

__global__ void __launch_bounds__(NT)
adam_kernel(const AdamEntry* __restrict__ tab, int n, long long nchunks,
            Hyper h, const float* lr_p, const int* step_p,
            const float* scale_p, const unsigned char* keep_p) {
  if (keep_p != nullptr && *keep_p == 0) return;
  const float lr = *lr_p;
  const float st = static_cast<float>(*step_p);
  const float bc1 = __fsub_rn(1.f, powf(h.b1, st));
  const float bc2 = __fsub_rn(1.f, powf(h.b2, st));
  const bool clip = scale_p != nullptr;
  const float s = clip ? *scale_p : 1.f;
  int t = 0;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    t = entry_of(tab, n, t, c);
    const AdamEntry e = tab[t];
    const long long lo = (c - e.chunk0) * CHUNK;
    const long long hi = min(lo + CHUNK, e.numel);
    const int pdt = e.dt & 0xff, gdt = (e.dt >> 8) & 0xff;
    const bool master = (e.dt >> 16) & 1;
    if (pdt == ptt::DT_FLOAT32) {
      if (gdt == ptt::DT_FLOAT32)
        adam_chunk<float, float, false>(e, lo, hi, h, lr, bc1, bc2, clip, s);
      else
        adam_chunk<float, bf16, false>(e, lo, hi, h, lr, bc1, bc2, clip, s);
    } else if (gdt == ptt::DT_BFLOAT16) {
      if (master)
        adam_chunk<bf16, bf16, true>(e, lo, hi, h, lr, bc1, bc2, clip, s);
      else
        adam_chunk<bf16, bf16, false>(e, lo, hi, h, lr, bc1, bc2, clip, s);
    } else {
      if (master)
        adam_chunk<bf16, float, true>(e, lo, hi, h, lr, bc1, bc2, clip, s);
      else
        adam_chunk<bf16, float, false>(e, lo, hi, h, lr, bc1, bc2, clip, s);
    }
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

int grid_for(long long nchunks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(std::min(nchunks, 8LL * sms));
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

int ptt_mt_adam(const void* table, int n, long long nchunks, float b1,
                float omb1, float b2, float omb2, float eps, int decoupled,
                int mp, const void* lr, const void* step, const void* scale,
                const void* keep, void* stream) {
  if (n <= 0 || nchunks <= 0) return 0;
  Hyper h{b1, omb1, b2, omb2, eps, decoupled, mp};
  adam_kernel<<<grid_for(nchunks), NT, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamEntry*>(table), n, nchunks, h,
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
