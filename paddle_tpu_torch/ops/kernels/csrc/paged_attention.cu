// Paged decode attention over block-table KV pools, for Hopper.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (:86, fp pools) and `_decode_kernel_quant` (:145, int8
// pools): one query token per sequence attends to its cached keys/values,
// which live scattered through [num_blocks, block_size, kv_heads, head_dim]
// pools and are found through the row's block table.  Nothing is gathered
// into contiguous memory.
//
// One block per (sequence b, kv head).  The TPU kernel receives the block
// table by scalar prefetch and walks it with its sequential grid axis; here
// the block reads lengths[b] and bt[b, j] itself and loops over the row's
// live blocks, 128 tokens per iteration (the chunk's physical block ids go
// to shared memory first):
//   1. one thread per token reads its K row with 16-byte loads and scores it
//      against all `group = h / kv_heads` query heads sharing this kv head
//      (the K row is read once per group, and every thread has its loads in
//      flight at once);
//   2. one warp per head folds the chunk into the online softmax state
//      (running max and sum, fp32);
//   3. each thread owns head_dim columns and accumulates p * V in fp32
//      registers, rescaled by the running-max correction; V rows are read
//      coalesced across the block.
// Blocks at or past lengths[b] are never read.  Inactive engine rows carry
// a zero table row and length 1, so they read scratch block 0 only.
//
// Int8 pools carry one fp32 scale per (token, kv head) in [num_blocks,
// block_size, kv_heads] arrays that follow the same block ids.  They are
// dequantized at the load, as the TPU kernel does (paged_attention.py:
// 110-115): k = float(int8) * scale rounded to q's type, then the fp32
// dot; v likewise, before the p * V product.  A K row is then 128 bytes
// (eight 16-byte loads); its scale is read as a scalar (the 32 bytes of
// one token's scales are not 16-byte aligned per token), and the chunk's
// V scales go to shared memory in step 1 for step 3.
//
// What bounds it: device-memory bytes (the live K/V rows are read once,
// with few operations per byte; int8 pools read 264 bytes per token and kv
// head at head_dim 128, against 512 in bf16).  This version keeps one block per
// (row, kv head) - 64 blocks at B = 8, kv_heads = 8, fewer than the 132 SMs -
// and walks the sequence serially; splitting long rows across blocks
// (flash-decoding) is later work.  The unnormalised probabilities are
// rounded to V's type before the p * V product and summed unrounded, as
// the TPU kernel does (paged_attention.py:129-133).
#include "common.cuh"

namespace {

constexpr int NT = 128;          // threads per block (4 warps)
constexpr int NWARP = NT / 32;
constexpr float NEG = -1e30f;

// a K/V element as the products see it: fp pools as stored; int8 pools
// dequantized with the token's scale and rounded to q's type T
template <typename T, typename KV>
struct KVElem {
  static __device__ __forceinline__ float f(KV e, float) {
    return ptt::to_f(e);
  }
};
template <typename T>
struct KVElem<T, int8_t> {
  static __device__ __forceinline__ float f(int8_t e, float s) {
    return ptt::to_f(ptt::from_f<T>((float)e * s));
  }
};

template <typename T, typename KV, int G, int HD>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ bt,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int kvh, int bs, int mb, int cb, float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;  // int8 pools with scales
  constexpr int VEC = 16 / sizeof(KV);    // elements per 16-byte load
  constexpr int ND = (HD + NT - 1) / NT;  // head_dim columns per thread
  extern __shared__ __align__(16) float smem[];
  const int CH = cb * bs;                 // tokens per chunk
  float* q_s = smem;                      // [G][HD]
  float* p_s = q_s + G * HD;              // [G][CH] scores, then probs
  float* m_s = p_s + G * CH;              // [G] running max
  float* l_s = m_s + G;                   // [G] running sum
  float* c_s = l_s + G;                   // [G] this chunk's correction
  int* pb_s = reinterpret_cast<int*>(c_s + G);   // [cb] physical blocks
  float* vs_s = reinterpret_cast<float*>(pb_s + cb);   // int8: [CH] V scales

  const int b = blockIdx.x, kh = blockIdx.y;
  const int h = kvh * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  int nblk = len > 0 ? (len + bs - 1) / bs : 0;
  if (nblk > mb) nblk = mb;
  const int* btrow = bt + (size_t)b * mb;

  for (int e = tid; e < G * HD; e += NT)
    q_s[e] = ptt::to_f(q[((size_t)b * h + kh * G) * HD + e]);
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[ND][G];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = 0.f;

  for (int j0 = 0; j0 < nblk; j0 += cb) {
    const int nb = min(cb, nblk - j0);
    const int ntok = nb * bs;
    __syncthreads();   // q_s ready / previous chunk's p_s and pb_s consumed
    for (int i = tid; i < nb; i += NT) pb_s[i] = btrow[j0 + i];
    __syncthreads();
    // 1. scores: one thread per token, its K row read with 16-byte loads
    //    and dotted with all G query heads of this kv head
    for (int t = tid; t < ntok; t += NT) {
      const int slot = t % bs;
      const size_t row = ((size_t)pb_s[t / bs] * bs + slot) * kvh + kh;
      const uint4* krow = reinterpret_cast<const uint4*>(kp + row * HD);
      const float ksc = QUANT ? ks[row] : 0.f;
      if (QUANT) vs_s[t] = vs[row];
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll 4
      for (int c = 0; c < HD / VEC; ++c) {
        const uint4 raw = krow[c];
        const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float kf = KVElem<T, KV>::f(e[i], ksc);
#pragma unroll
          for (int g = 0; g < G; ++g)
            dot[g] = fmaf(q_s[g * HD + c * VEC + i], kf, dot[g]);
        }
      }
      const bool live = j0 * bs + t < len;
#pragma unroll
      for (int g = 0; g < G; ++g) p_s[g * CH + t] = live ? dot[g] * scale : NEG;
    }
    __syncthreads();
    // 2. online softmax update, one warp per head
    for (int g = warp; g < G; g += NWARP) {
      float* pg = p_s + g * CH;
      float mx = NEG;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, pg[t]);
      mx = ptt::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < ntok; t += 32) {
        const float p = expf(pg[t] - m_new);
        pg[t] = ptt::to_f(ptt::from_f<T>(p));   // p.astype(v.dtype)
        sum += p;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + p @ V: each thread owns head_dim columns, the
    //    V rows are read coalesced across the block
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = tid + i * NT;
      if (d < HD) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc[i][g] *= c_s[g];
#pragma unroll 8
        for (int t = 0; t < ntok; ++t) {
          const size_t row = ((size_t)pb_s[t / bs] * bs + t % bs) * kvh + kh;
          const float v = KVElem<T, KV>::f(vp[row * HD + d],
                                           QUANT ? vs_s[t] : 0.f);
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[i][g] = fmaf(p_s[g * CH + t], v, acc[i][g]);
        }
      }
    }
  }
  __syncthreads();   // l_s final

#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int d = tid + i * NT;
    if (d < HD) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float l = fmaxf(l_s[g], 1e-30f);
        out[((size_t)b * h + kh * G + g) * HD + d] =
            ptt::from_f<T>(acc[i][g] / l);
      }
    }
  }
}

// the kernel's pointers and sizes, passed down the dispatch by value
template <typename T, typename KV>
struct Args {
  const T* q;
  const KV* kp;
  const KV* vp;
  const float* ks;   // int8 pools: [nb, bs, kvh] scales; fp pools: null
  const float* vs;
  const int* bt;
  const int* lengths;
  T* out;
  int B, kvh, bs, mb;
  float scale;
};

template <typename T, typename KV, int G, int HD>
int launch_g(const Args<T, KV>& a, cudaStream_t stream) {
  const int cb = a.bs >= NT ? 1 : NT / a.bs;   // live blocks per chunk
  const int ch = cb * a.bs;                     // tokens per chunk
  const size_t smem = sizeof(float) * (G * HD + G * ch + 3 * G) +
                      sizeof(int) * cb +
                      (sizeof(KV) == 1 ? sizeof(float) * ch : 0);
  auto kern = paged_decode_kernel<T, KV, G, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B, a.kvh);
  kern<<<grid, NT, smem, stream>>>(a.q, a.kp, a.vp, a.ks, a.vs, a.bt,
                                   a.lengths, a.out, a.kvh, a.bs, a.mb, cb,
                                   a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int G>
int launch_hd(const Args<T, KV>& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_g<T, KV, G, 32>(a, s);
    case 64: return launch_g<T, KV, G, 64>(a, s);
    case 128: return launch_g<T, KV, G, 128>(a, s);
    case 256: return launch_g<T, KV, G, 256>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename KV>
int launch_t(const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* bt, const void* lengths, void* out,
             int B, int h, int kvh, int hd, int bs, int mb, float scale,
             cudaStream_t s) {
  const Args<T, KV> a{static_cast<const T*>(q),
                      static_cast<const KV*>(kp),
                      static_cast<const KV*>(vp),
                      static_cast<const float*>(ks),
                      static_cast<const float*>(vs),
                      static_cast<const int*>(bt),
                      static_cast<const int*>(lengths),
                      static_cast<T*>(out),
                      B, kvh, bs, mb, scale};
  switch (h / kvh) {
    case 1: return launch_hd<T, KV, 1>(a, hd, s);
    case 2: return launch_hd<T, KV, 2>(a, hd, s);
    case 4: return launch_hd<T, KV, 4>(a, hd, s);
    case 8: return launch_hd<T, KV, 8>(a, hd, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out[b, :, :] = softmax(q[b] K_b^T * scale) V_b over positions
// < lengths[b], with K_b/V_b read through bt[b, :] from the pools.
// q/out [B, h, hd]; pools [nb, bs, kvh, hd]; bt [B, mb] int32;
// lengths [B] int32.  h / kvh in {1, 2, 4, 8}; hd in {32, 64, 128, 256}.
int ptt_paged_decode(int dtype, const void* q, const void* kp, const void* vp,
                     const void* bt, const void* lengths, void* out, int B,
                     int h, int kvh, int hd, int bs, int mb, float scale,
                     void* stream) {
  if (B <= 0 || kvh <= 0 || h % kvh != 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(
        q, kp, vp, nullptr, nullptr, bt, lengths, out, B, h, kvh, hd, bs, mb,
        scale, s);
  if (dtype == ptt::DT_FLOAT32)
    return launch_t<float, float>(q, kp, vp, nullptr, nullptr, bt, lengths,
                                  out, B, h, kvh, hd, bs, mb, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The same over int8 pools kp/vp [nb, bs, kvh, hd] with fp32 scales ks/vs
// [nb, bs, kvh]: each K/V element is float(int8) * its token's scale,
// rounded to q's type (`dtype`).
int ptt_paged_decode_quant(int dtype, const void* q, const void* kp,
                           const void* vp, const void* ks, const void* vs,
                           const void* bt, const void* lengths, void* out,
                           int B, int h, int kvh, int hd, int bs, int mb,
                           float scale, void* stream) {
  if (B <= 0 || kvh <= 0 || h % kvh != 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return launch_t<__nv_bfloat16, int8_t>(q, kp, vp, ks, vs, bt, lengths,
                                           out, B, h, kvh, hd, bs, mb, scale,
                                           s);
  if (dtype == ptt::DT_FLOAT32)
    return launch_t<float, int8_t>(q, kp, vp, ks, vs, bt, lengths, out, B, h,
                                   kvh, hd, bs, mb, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
