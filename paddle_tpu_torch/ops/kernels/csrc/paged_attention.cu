// Paged decode attention over block-table KV pools, for Hopper.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (:86) for fp pools: one query token per sequence attends
// to its cached keys/values, which live scattered through
// [num_blocks, block_size, kv_heads, head_dim] pools and are found through
// the row's block table.  Nothing is gathered into contiguous memory.
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
// What bounds it: device-memory bytes (the live K/V rows are read once,
// with few operations per byte).  This version keeps one block per
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

template <typename T, int G, int HD>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int kvh, int bs, int mb, int cb, float scale) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int ND = (HD + NT - 1) / NT;  // head_dim columns per thread
  extern __shared__ __align__(16) float smem[];
  const int CH = cb * bs;                 // tokens per chunk
  float* q_s = smem;                      // [G][HD]
  float* p_s = q_s + G * HD;              // [G][CH] scores, then probs
  float* m_s = p_s + G * CH;              // [G] running max
  float* l_s = m_s + G;                   // [G] running sum
  float* c_s = l_s + G;                   // [G] this chunk's correction
  int* pb_s = reinterpret_cast<int*>(c_s + G);   // [cb] physical blocks

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
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll 4
      for (int c = 0; c < HD / VEC; ++c) {
        const uint4 raw = krow[c];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float kf = ptt::to_f(e[i]);
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
          const float v = ptt::to_f(vp[row * HD + d]);
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

template <typename T, int G, int HD>
int launch_g(const T* q, const T* kp, const T* vp, const int* bt,
             const int* lengths, T* out, int B, int kvh, int bs, int mb,
             float scale, cudaStream_t stream) {
  const int cb = bs >= NT ? 1 : NT / bs;   // live blocks per chunk
  const size_t smem = sizeof(float) * (G * HD + G * cb * bs + 3 * G) +
                      sizeof(int) * cb;
  auto kern = paged_decode_kernel<T, G, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, kvh);
  kern<<<grid, NT, smem, stream>>>(q, kp, vp, bt, lengths, out, kvh, bs, mb,
                                   cb, scale);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_hd(const T* q, const T* kp, const T* vp, const int* bt,
              const int* lengths, T* out, int B, int kvh, int hd, int bs,
              int mb, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_g<T, G, 32>(q, kp, vp, bt, lengths, out, B, kvh, bs, mb, scale, s);
    case 64: return launch_g<T, G, 64>(q, kp, vp, bt, lengths, out, B, kvh, bs, mb, scale, s);
    case 128: return launch_g<T, G, 128>(q, kp, vp, bt, lengths, out, B, kvh, bs, mb, scale, s);
    case 256: return launch_g<T, G, 256>(q, kp, vp, bt, lengths, out, B, kvh, bs, mb, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_t(const void* q, const void* kp, const void* vp, const int* bt,
             const int* lengths, void* out, int B, int h, int kvh, int hd,
             int bs, int mb, float scale, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(kp);
  const T* v_ = static_cast<const T*>(vp);
  T* o_ = static_cast<T*>(out);
  switch (h / kvh) {
    case 1: return launch_hd<T, 1>(q_, k_, v_, bt, lengths, o_, B, kvh, hd, bs, mb, scale, s);
    case 2: return launch_hd<T, 2>(q_, k_, v_, bt, lengths, o_, B, kvh, hd, bs, mb, scale, s);
    case 4: return launch_hd<T, 4>(q_, k_, v_, bt, lengths, o_, B, kvh, hd, bs, mb, scale, s);
    case 8: return launch_hd<T, 8>(q_, k_, v_, bt, lengths, o_, B, kvh, hd, bs, mb, scale, s);
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
  const int* bt_ = static_cast<const int*>(bt);
  const int* ln_ = static_cast<const int*>(lengths);
  if (dtype == ptt::DT_BFLOAT16)
    return launch_t<__nv_bfloat16>(q, kp, vp, bt_, ln_, out, B, h, kvh, hd,
                                   bs, mb, scale, s);
  if (dtype == ptt::DT_FLOAT32)
    return launch_t<float>(q, kp, vp, bt_, ln_, out, B, h, kvh, hd, bs, mb,
                           scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
