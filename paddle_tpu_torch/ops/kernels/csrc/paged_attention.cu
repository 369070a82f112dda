// Paged decode attention over block-table KV pools, for Hopper.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (:86, fp pools) and `_decode_kernel_quant` (:145, int8
// pools): one query token per sequence attends to its cached keys/values,
// which live scattered through [num_blocks, block_size, kv_heads, head_dim]
// pools and are found through the row's block table.  Nothing is gathered
// into contiguous memory.
//
// What bounds it: device-memory bytes (the live K/V rows are read once,
// with few operations per byte; int8 pools read 264 bytes per token and kv
// head at head_dim 128, against 512 in bf16): 17 MB at the serving shape
// (B = 8, lengths 1..1024), 5 us at 3.35 TB/s.  So the card has to keep
// many rows in flight at once, and one block per (row, kv head) walking its
// sequence - 64 blocks for 132 SMs - cannot.
//
// The design splits each row's sequence (flash-decoding).  The TPU kernel
// walks the block table along its sequential grid axis; here the grid is
// (B, kv_heads, splits) and split s of a row takes the tokens [s * ST,
// (s + 1) * ST): ST = kSplitTokens rounded down to whole pool blocks (at
// least one block).  The split count comes from the table's width alone
// (splits_of: max_blocks, block_size), never from the lengths, which live
// on the device; a split at or past its row's length returns at once.
// Each block, 128 threads:
//   1. one thread per token reads its K row with 16-byte loads and scores
//      it against all `group = h / kv_heads` query heads sharing this kv
//      head (the K row is read once per group);
//   2. one warp per head takes the split's max m and sum l of p = exp(s -
//      m), p rounded to V's type for the product, as the TPU kernel does
//      (paged_attention.py:129-133);
//   3. p V: the threads split the tokens into groups and the head_dim into
//      8-element vectors (4 in fp32), so every thread keeps its V loads in
//      flight at once; the groups' fp32 sums are added in group order.
// A row that fits one split normalises and writes its output directly.
// Otherwise each split writes an fp32 partial (m, l and the unnormalised
// [G, head_dim] sum) to a workspace the wrapper allocates, and the last
// split of the (row, kv head) to arrive - an atomic ticket, one per (row,
// kv head), reset by that block - merges the partials in split order:
// out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M the largest
// m_s.  (A second launch for the merge would cost its launch at every
// decode step; the ticket is quant_matmul.cu's split-K pattern.)  The
// merge reads every partial, its own too, from the workspace, so two calls
// give the same bits whichever split arrives last.  Only the order of the
// fp32 sums differs from the plain version.
//
// Inactive engine rows carry a zero table row and length 1, so they read
// scratch block 0 only; a row of length 0 writes zeros.
//
// Int8 pools carry one fp32 scale per (token, kv head) in [num_blocks,
// block_size, kv_heads] arrays that follow the same block ids.  They are
// dequantized at the load, as the TPU kernel does (paged_attention.py:
// 110-115): k = float(int8) * scale rounded to q's type, then the fp32
// dot; v likewise, before the p * V product.  A K row is then 128 bytes
// (eight 16-byte loads); its scale is read as a scalar (the 32 bytes of
// one token's scales are not 16-byte aligned per token), and the split's
// V scales go to shared memory in step 1 for step 3.  fp pools, int8
// pools and fp32 io are one template.
#include "common.cuh"

namespace {

constexpr int NT = 128;          // threads per block (4 warps)
constexpr int NWARP = NT / 32;
constexpr float NEG = -1e30f;
// tokens a split covers (ops/kernels/paged_attention.py SPLIT_TOKENS):
// at B = 8, kv_heads = 8 and 1024-token rows, 8 splits, 512 blocks
constexpr int kSplitTokens = 128;

// the design a launch takes (ops/kernels/paged_attention.py PAGED_PATHS,
// in this order): split rows with the merge, or one split a row
enum PagedDesign { PAGED_SPLIT = 0, PAGED_DIRECT = 1 };

// pool blocks a split covers, and the splits of a table max_blocks wide
inline __host__ __device__ int split_blocks(int bs) {
  return bs >= kSplitTokens ? 1 : kSplitTokens / bs;
}
inline int splits_of(int mb, int bs) {
  const int cb = split_blocks(bs);
  return (mb + cb - 1) / cb;
}

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

// the p V product's thread layout: PV elements of a V row a thread (16
// bytes; 8 bytes of int8), CV such vectors a row, TG token groups
template <typename KV, int HD>
struct PvPlan {
  static constexpr int PV = 16 / sizeof(KV) < 8 ? 16 / sizeof(KV) : 8;
  static constexpr int CV = HD / PV;
  static constexpr int TG = NT / CV;
  static_assert(NT % CV == 0, "a V row's vectors divide the block");
};

// PV elements of one V row at src (aligned to their bytes), as floats
template <typename T, typename KV, int PV>
__device__ __forceinline__ void load_v(const KV* src, float sc,
                                       float (&v)[PV]) {
  if constexpr (sizeof(KV) == 1) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < PV; ++i) v[i] = KVElem<T, KV>::f(e[i], sc);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < PV; ++i) v[i] = ptt::to_f(e[i]);
  }
}

// the kernel's pointers and sizes
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
  float* ws;      // [B, kvh, splits, G * (HD + 2)] partials (splits > 1)
  int* tickets;   // [B * kvh], zero between launches (splits > 1)
  int B, kvh, bs, mb, splits;
  float scale;
};

template <typename T, typename KV, int G, int HD>
__global__ void __launch_bounds__(NT)
paged_split_kernel(const Args<T, KV> a) {
  constexpr bool QUANT = sizeof(KV) == 1;  // int8 pools with scales
  constexpr int VEC = 16 / sizeof(KV);    // K elements per 16-byte load
  using P = PvPlan<KV, HD>;
  constexpr int PV = P::PV, CV = P::CV, TG = P::TG;
  constexpr int PART = G * (HD + 2);      // a partial: m, l, the sums
  extern __shared__ __align__(16) float smem[];
  __shared__ float m_s[G], l_s[G];
  __shared__ int last;
  const int cb = split_blocks(a.bs), ST = cb * a.bs;
  float* red = smem;                      // [TG][G][HD] token groups' sums
  float* q_s = red + TG * G * HD;         // [G][HD]
  float* p_s = q_s + G * HD;              // [G][ST] scores, then probs
  float* vs_s = p_s + G * ST;             // int8: [ST] V scales
  int* pb_s = reinterpret_cast<int*>(vs_s + (QUANT ? ST : 0));  // [cb]

  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int h = a.kvh * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the row's tokens (no more than its table holds) and the splits they
  // fill; split 0 always runs, so a row of length 0 still writes zeros
  const int len = min(max(a.lengths[b], 0), a.mb * a.bs);
  const int live = max(1, (len + ST - 1) / ST);
  if (split >= live) return;
  const int ntok = max(0, min(ST, len - split * ST));
  const int nb = (ntok + a.bs - 1) / a.bs;
  const int* btrow = a.bt + (size_t)b * a.mb + (size_t)split * cb;
  for (int i = tid; i < nb; i += NT) pb_s[i] = btrow[i];
  for (int e = tid; e < G * HD; e += NT)
    q_s[e] = ptt::to_f(a.q[((size_t)b * h + kh * G) * HD + e]);
  __syncthreads();

  // 1. scores: one thread per token, its K row read with 16-byte loads
  //    and dotted with all G query heads of this kv head
  for (int t = tid; t < ntok; t += NT) {
    const size_t row = ((size_t)pb_s[t / a.bs] * a.bs + t % a.bs) * a.kvh + kh;
    const uint4* krow = reinterpret_cast<const uint4*>(a.kp + row * HD);
    const float ksc = QUANT ? a.ks[row] : 0.f;
    if (QUANT) vs_s[t] = a.vs[row];
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
#pragma unroll
    for (int g = 0; g < G; ++g) p_s[g * ST + t] = dot[g] * a.scale;
  }
  __syncthreads();
  // 2. the split's softmax, one warp per head: max, p = exp(s - max)
  //    rounded to V's type, the sum of the unrounded p
  for (int g = warp; g < G; g += NWARP) {
    float* pg = p_s + g * ST;
    float mx = NEG;
    for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, pg[t]);
    mx = ptt::warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < ntok; t += 32) {
      const float p = expf(pg[t] - mx);
      pg[t] = ptt::to_f(ptt::from_f<T>(p));   // p.astype(v.dtype)
      sum += p;
    }
    sum = ptt::warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();
  // 3. p V: token group tg, columns c0 .. c0 + PV - 1
  const int tg = tid / CV, c0 = (tid % CV) * PV;
  float acc[PV][G];
#pragma unroll
  for (int i = 0; i < PV; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = 0.f;
#pragma unroll 4
  for (int t = tg; t < ntok; t += TG) {
    const size_t row = ((size_t)pb_s[t / a.bs] * a.bs + t % a.bs) * a.kvh + kh;
    float v[PV];
    load_v<T, KV, PV>(a.vp + row * HD + c0, QUANT ? vs_s[t] : 0.f, v);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = p_s[g * ST + t];
#pragma unroll
      for (int i = 0; i < PV; ++i) acc[i][g] = fmaf(p, v[i], acc[i][g]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < PV; i += 4)
      *reinterpret_cast<float4*>(red + (tg * G + g) * HD + c0 + i) =
          make_float4(acc[i][g], acc[i + 1][g], acc[i + 2][g], acc[i + 3][g]);
  __syncthreads();
  // the token groups' sums in group order: element e = g * HD + d
  auto group_sum = [&](int e) {
    float s = red[e];
#pragma unroll
    for (int j = 1; j < TG; ++j) s += red[j * G * HD + e];
    return s;
  };
  T* orow = a.out + ((size_t)b * h + kh * G) * HD;
  if (live == 1) {
    for (int e = tid; e < G * HD; e += NT)
      orow[e] = ptt::from_f<T>(group_sum(e) / fmaxf(l_s[e / HD], 1e-30f));
    return;
  }
  const size_t rk = (size_t)b * a.kvh + kh;
  float* part = a.ws + (rk * a.splits + split) * PART;
  for (int e = tid; e < G * HD; e += NT) part[2 * G + e] = group_sum(e);
  if (tid < G) {
    part[tid] = m_s[tid];
    part[G + tid] = l_s[tid];
  }
  // the last split of this (row, kv head) to finish merges the partials
  // (the barrier, then one thread's fence, publishes every thread's
  // partial before the ticket: fences are cumulative)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&a.tickets[rk], 1) == live - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p0 = a.ws + rk * a.splits * PART;
  for (int e = tid; e < G * HD; e += NT) {
    const int g = e / HD;
    float mx = NEG;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, __ldcg(p0 + s * PART + g));
    float num = 0.f, den = 0.f;
    for (int s = 0; s < live; ++s) {
      const float* ps = p0 + s * PART;
      const float w = expf(__ldcg(ps + g) - mx);
      num = fmaf(w, __ldcg(ps + 2 * G + e), num);
      den = fmaf(w, __ldcg(ps + G + g), den);
    }
    orow[e] = ptt::from_f<T>(num / fmaxf(den, 1e-30f));
  }
  if (tid == 0) a.tickets[rk] = 0;
}

template <typename T, typename KV, int G, int HD>
int launch_g(const Args<T, KV>& a, cudaStream_t stream) {
  using P = PvPlan<KV, HD>;
  const int cb = split_blocks(a.bs), st = cb * a.bs;
  const size_t smem =
      sizeof(float) * (P::TG * G * HD + G * HD + G * st +
                       (sizeof(KV) == 1 ? st : 0)) +
      sizeof(int) * cb;
  auto kern = paged_split_kernel<T, KV, G, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B, a.kvh, a.splits);
  kern<<<grid, NT, smem, stream>>>(a);
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
             void* ws, void* tickets, int B, int h, int kvh, int hd, int bs,
             int mb, float scale, cudaStream_t s) {
  const Args<T, KV> a{static_cast<const T*>(q),
                      static_cast<const KV*>(kp),
                      static_cast<const KV*>(vp),
                      static_cast<const float*>(ks),
                      static_cast<const float*>(vs),
                      static_cast<const int*>(bt),
                      static_cast<const int*>(lengths),
                      static_cast<T*>(out),
                      static_cast<float*>(ws),
                      static_cast<int*>(tickets),
                      B, kvh, bs, mb, splits_of(mb, bs), scale};
  switch (h / kvh) {
    case 1: return launch_hd<T, KV, 1>(a, hd, s);
    case 2: return launch_hd<T, KV, 2>(a, hd, s);
    case 4: return launch_hd<T, KV, 4>(a, hd, s);
    case 8: return launch_hd<T, KV, 8>(a, hd, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the checks both entries share, and the design a valid call takes
int plan(int B, int h, int kvh, int bs, int mb, const void* ws,
         const void* tickets, int* design) {
  if (B <= 0 || kvh <= 0 || h % kvh != 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  const bool split = splits_of(mb, bs) > 1;
  if (split && (ws == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  *design = split ? PAGED_SPLIT : PAGED_DIRECT;
  return 0;
}

}  // namespace

extern "C" {

// The splits of a row whose table is mb blocks of bs tokens wide: the
// workspace is B * kvh * splits * (h / kvh) * (hd + 2) fp32 and the
// tickets B * kvh int32 where splits > 1; 0 for an invalid size.
int ptt_paged_splits(int mb, int bs) {
  return mb > 0 && bs > 0 ? splits_of(mb, bs) : 0;
}

// out[b, :, :] = softmax(q[b] K_b^T * scale) V_b over positions
// < lengths[b], with K_b/V_b read through bt[b, :] from the pools.
// q/out [B, h, hd]; pools [nb, bs, kvh, hd]; bt [B, mb] int32;
// lengths [B] int32.  h / kvh in {1, 2, 4, 8}; hd in {32, 64, 128, 256}.
// ws and tickets: the merge's workspace and tickets (ptt_paged_splits),
// the tickets zero before the launch (and again after it); null where
// the table fits one split.  *design: the PagedDesign launched.
int ptt_paged_decode(int dtype, const void* q, const void* kp, const void* vp,
                     const void* bt, const void* lengths, void* out, void* ws,
                     void* tickets, int B, int h, int kvh, int hd, int bs,
                     int mb, float scale, void* stream, void* design) {
  int d = 0;
  int err = plan(B, h, kvh, bs, mb, ws, tickets, &d);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    err = launch_t<__nv_bfloat16, __nv_bfloat16>(
        q, kp, vp, nullptr, nullptr, bt, lengths, out, ws, tickets, B, h,
        kvh, hd, bs, mb, scale, s);
  else if (dtype == ptt::DT_FLOAT32)
    err = launch_t<float, float>(q, kp, vp, nullptr, nullptr, bt, lengths,
                                 out, ws, tickets, B, h, kvh, hd, bs, mb,
                                 scale, s);
  else
    err = (int)cudaErrorInvalidValue;
  return ptt::launched(err, design, d);
}

// The same over int8 pools kp/vp [nb, bs, kvh, hd] with fp32 scales ks/vs
// [nb, bs, kvh]: each K/V element is float(int8) * its token's scale,
// rounded to q's type (`dtype`).
int ptt_paged_decode_quant(int dtype, const void* q, const void* kp,
                           const void* vp, const void* ks, const void* vs,
                           const void* bt, const void* lengths, void* out,
                           void* ws, void* tickets, int B, int h, int kvh,
                           int hd, int bs, int mb, float scale, void* stream,
                           void* design) {
  int d = 0;
  int err = plan(B, h, kvh, bs, mb, ws, tickets, &d);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    err = launch_t<__nv_bfloat16, int8_t>(q, kp, vp, ks, vs, bt, lengths,
                                          out, ws, tickets, B, h, kvh, hd,
                                          bs, mb, scale, s);
  else if (dtype == ptt::DT_FLOAT32)
    err = launch_t<float, int8_t>(q, kp, vp, ks, vs, bt, lengths, out, ws,
                                  tickets, B, h, kvh, hd, bs, mb, scale, s);
  else
    err = (int)cudaErrorInvalidValue;
  return ptt::launched(err, design, d);
}

}  // extern "C"
