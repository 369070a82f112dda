// Flash attention forward and backward (dq, dk/dv), for Hopper.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   `_fwd_kernel` (:71)      -> flash_fwd_kernel
//   `_bwd_dq_kernel` (:192)  -> flash_dq_kernel
//   `_bwd_dkv_kernel` (:242) -> flash_dkv_kernel
// Inputs keep the API's [batch, seq, heads, head_dim] layout and are read
// through their row strides (heads * head_dim), so nothing is transposed
// first as the TPU wrapper does (:529-535).  Query head h reads kv head
// h / (H / HK): KV is never repeated for GQA.
//
// Design (one CTA of 4 warps per tile; every product is a GEMM between
// tiles in shared memory, every accumulator an fp32 tile in shared memory):
//   forward  one CTA per (q block of BQ rows, query head, batch).  Key
//            blocks up to the causal diagonal are walked in order (blocks
//            wholly above it are skipped, as :113-119 do); per block
//            S = Q K^T * scale, the online softmax (running max and sum,
//            fp32) rescales the O tile, and O += P V with P cast to V's
//            type first (:106-108).  Writes out (input type) and
//            lse = m + log(l) (fp32, [b, h, s]).
//   dq       one CTA per (q block, query head, batch), looping over key
//            blocks: P = exp(S - lse), dP = dO V^T,
//            dS = P * (dP - delta) * scale, dQ += dS K.  delta =
//            rowsum(dO * O) comes from the wrapper, as _bwd_pallas computes
//            it outside its kernel (:314-315).
//   dk/dv    one CTA per (key block, kv head, batch), walking every
//            (group head, q block) pair as the TPU grid's inner axis does
//            (:245-247, :355): dV += P^T dO, dK += dS^T Q over the whole
//            GQA group, so there are no atomics and the sums are
//            deterministic.
// bf16 runs its products on the tensor cores through nvcuda::wmma
// 16x16x16 with fp32 accumulation, BQ = BK = 64; fp32 runs them on the
// CUDA cores with fp32 FMAs (no TF32), BQ = BK = 32 (twice the bytes per
// element in the same shared memory).  head_dim is a template parameter;
// 128 is instantiated (the Llama path), 256 waits (ROADMAP.md, queue 2).
//
// Precision: the TPU backward takes the P^T dO, dS K and dS^T Q products
// in fp32 (:277-288).  The bf16 kernels here round P and dS to bf16 for
// the tensor-core products, as FlashAttention-2 does (accumulation stays
// fp32); in fp32 nothing is rounded.
//
// What bounds it: at the training shapes (s = 2048, head_dim 128) the
// products; each CTA reloads its K/V (forward, dq) or Q/dO (dk/dv) tiles
// from device memory (L2 catches most of it).  This first version keeps
// accumulators in shared memory between wmma calls and does not overlap
// loads with products; register-resident accumulators, wgmma and TMA are
// later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int NT = 128;             // threads per CTA
constexpr int NWARP = NT / 32;
constexpr float NEG = -1e30f;       // the TPU kernel's masked score

template <typename T>
struct Blk {
  static constexpr int Q = sizeof(T) == 2 ? 64 : 32;    // query rows
  static constexpr int K = Q;                           // key rows
  static constexpr int PAD = 16 / sizeof(T);            // 16-byte row pad
};

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// C[M][N] (fp32, shared, ldc) = (ACC ? C : 0) + A[M][K] . B[K][N], A and B
// in shared memory.  A_ROW: A[m][k] at a[m * lda + k], else a[k * lda + m].
// B_ROW: B[k][n] at b[k * ldb + n], else b[n * ldb + k].
template <typename T, int M, int N, int K, bool A_ROW, bool B_ROW, bool ACC>
__device__ __forceinline__ void gemm(const T* a, int lda, const T* b, int ldb,
                                     float* c, int ldc) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 2) {
    using LA = std::conditional_t<A_ROW, wmma::row_major, wmma::col_major>;
    using LB = std::conditional_t<B_ROW, wmma::row_major, wmma::col_major>;
    constexpr int FN = N / 16;
    const int warp = tid / 32;
    // a warp owns 16-row strips and every column tile of them, so each A
    // fragment is loaded once per k step
    for (int i = warp; i < M / 16; i += NWARP) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        if constexpr (ACC)
          wmma::load_matrix_sync(acc[j], c + i * 16 * ldc + j * 16, ldc,
                                 wmma::mem_row_major);
        else
          wmma::fill_fragment(acc[j], 0.f);
      }
#pragma unroll 2
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
        const T* pa = A_ROW ? a + i * 16 * lda + k : a + k * lda + i * 16;
        wmma::load_matrix_sync(fa, reinterpret_cast<const __nv_bfloat16*>(pa),
                               lda);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
          const T* pb = B_ROW ? b + k * ldb + j * 16 : b + j * 16 * ldb + k;
          wmma::load_matrix_sync(
              fb, reinterpret_cast<const __nv_bfloat16*>(pb), ldb);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(c + i * 16 * ldc + j * 16, acc[j], ldc,
                                wmma::mem_row_major);
    }
  } else {
    // fp32: thread (ty, tx) of an 8 x 16 grid owns rows ty + 8 i and
    // columns tx + 16 j
    constexpr int RM = M / 8, RN = N / 16;
    const int tx = tid % 16, ty = tid / 16;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        acc[i][j] = ACC ? c[(ty + 8 * i) * ldc + tx + 16 * j] : 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = ty + 8 * i;
        av[i] = ptt::to_f(A_ROW ? a[m * lda + k] : a[k * lda + m]);
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = tx + 16 * j;
        bv[j] = ptt::to_f(B_ROW ? b[k * ldb + n] : b[n * ldb + k]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        c[(ty + 8 * i) * ldc + tx + 16 * j] = acc[i][j];
  }
}

// ROWS rows of HD elements from global (row stride `stride` elements) into
// shared memory (row stride `ld`), 16 bytes per cp.async
template <typename T, int ROWS, int HD>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          size_t stride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, cc = (c % CPR) * VEC;
    ptt::cp_async16(dst + r * ld + cc, src + r * stride + cc, true);
  }
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int e = threadIdx.x; e < n; e += NT) p[e] = 0.f;
}

struct Args {
  const void* q;       // [B, S, H, D]
  const void* k;       // [B, S, HK, D]
  const void* v;       // [B, S, HK, D]
  void* o;             // [B, S, H, D] forward output
  const void* dout;    // [B, S, H, D]
  float* lse;          // [B, H, S]
  const float* delta;  // [B, H, S]
  void* dq;            // [B, S, H, D]
  void* dk;            // [B, S, HK, D]
  void* dv;            // [B, S, HK, D]
  int S, H, HK;
  float scale;
  int causal;
};

// -- shared-memory plans -------------------------------------------------------

template <typename T, int HD>
struct Plan {
  static constexpr int BQ = Blk<T>::Q, BK = Blk<T>::K;
  static constexpr int LDT = HD + Blk<T>::PAD;     // T tiles [rows][HD]
  static constexpr int LDS = BK + 4;               // fp32 score tiles
  static constexpr int LDP = BK + Blk<T>::PAD;     // T probability tiles
  static constexpr int LDA = HD + 4;               // fp32 accumulators
  static constexpr size_t TQ = align128(sizeof(T) * BQ * LDT);
  static constexpr size_t TK = align128(sizeof(T) * BK * LDT);
  static constexpr size_t SS = align128(sizeof(float) * BQ * LDS);
  static constexpr size_t SP = align128(sizeof(T) * BQ * LDP);
  static constexpr size_t AQ = align128(sizeof(float) * BQ * LDA);
  static constexpr size_t AK = align128(sizeof(float) * BK * LDA);
  static constexpr size_t ROWQ = align128(sizeof(float) * BQ);
  // forward: Q, K, V, S, P, O, m, l
  static constexpr size_t FWD = TQ + 2 * TK + SS + SP + AQ + 2 * ROWQ;
  // dq: Q, dO, K, V, S, dP, dS, dQ, lse, delta
  static constexpr size_t DQ = 2 * TQ + 2 * TK + 2 * SS + SP + AQ + 2 * ROWQ;
  // dk/dv: K, V, Q, dO, S, dP, P, dS, dK, dV, lse, delta
  static constexpr size_t DKV =
      2 * TK + 2 * TQ + 2 * SS + 2 * SP + 2 * AK + 2 * ROWQ;
};

// -- forward -------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  using P = Plan<T, HD>;
  constexpr int BQ = P::BQ, BK = P::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sp = smem;
  T* Qs = reinterpret_cast<T*>(sp);        sp += P::TQ;
  T* Ks = reinterpret_cast<T*>(sp);        sp += P::TK;
  T* Vs = reinterpret_cast<T*>(sp);        sp += P::TK;
  float* Ss = reinterpret_cast<float*>(sp); sp += P::SS;
  T* Ps = reinterpret_cast<T*>(sp);        sp += P::SP;
  float* Os = reinterpret_cast<float*>(sp); sp += P::AQ;
  float* m_s = reinterpret_cast<float*>(sp); sp += P::ROWQ;
  float* l_s = reinterpret_cast<float*>(sp);

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, HK = a.HK;
  const int kh = h / (H / HK);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qstride = (size_t)H * HD, kstride = (size_t)HK * HD;
  const int q0 = qi * BQ;
  const T* qg = static_cast<const T*>(a.q) + ((size_t)b * S + q0) * qstride +
                (size_t)h * HD;
  const T* kg = static_cast<const T*>(a.k) + (size_t)b * S * kstride +
                (size_t)kh * HD;
  const T* vg = static_cast<const T*>(a.v) + (size_t)b * S * kstride +
                (size_t)kh * HD;

  load_rows<T, BQ, HD>(Qs, P::LDT, qg, qstride);
  ptt::cp_async_commit();
  zero(Os, BQ * P::LDA);
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }
  // key blocks wholly above the diagonal are never visited
  const int nk = a.causal ? (q0 + BQ - 1) / BK + 1 : S / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    load_rows<T, BK, HD>(Ks, P::LDT, kg + (size_t)k0 * kstride, kstride);
    load_rows<T, BK, HD>(Vs, P::LDT, vg + (size_t)k0 * kstride, kstride);
    ptt::cp_async_commit();
    ptt::cp_async_wait<0>();
    __syncthreads();
    gemm<T, BQ, BK, HD, true, false, false>(Qs, P::LDT, Ks, P::LDT, Ss,
                                            P::LDS);
    __syncthreads();
    // online softmax, one warp per row; the warp also rescales its O row
    for (int r = warp; r < BQ; r += NWARP) {
      float* srow = Ss + r * P::LDS;
      const int qpos = q0 + r;
      float mx = NEG;
      for (int c = lane; c < BK; c += 32) {
        float s = srow[c] * a.scale;
        if (a.causal && k0 + c > qpos) s = NEG;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = ptt::warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(srow[c] - m_new);
        Ps[r * P::LDP + c] = ptt::from_f<T>(p);   // P to V's type (:107)
        sum += p;
      }
      sum = ptt::warp_sum(sum);
      const float corr = expf(m_prev - m_new);
      for (int d = lane; d < HD; d += 32) Os[r * P::LDA + d] *= corr;
      if (lane == 0) {
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    gemm<T, BQ, HD, BK, true, true, true>(Ps, P::LDP, Vs, P::LDT, Os, P::LDA);
    __syncthreads();   // K, V, S, P free for the next block
  }

  T* og = static_cast<T*>(a.o) +
          ((size_t)b * S + q0) * qstride + (size_t)h * HD;
  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const float l = l_s[r];
    const float safe_l = l > 0.f ? l : 1.f;
    og[r * qstride + d] = ptt::from_f<T>(Os[r * P::LDA + d] / safe_l);
  }
  float* lg = a.lse + ((size_t)b * H + h) * S + q0;
  for (int r = tid; r < BQ; r += NT) {
    const float l = l_s[r];
    lg[r] = m_s[r] + logf(l > 0.f ? l : 1.f);
  }
}

// -- backward: dq ----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_dq_kernel(Args a) {
  using P = Plan<T, HD>;
  constexpr int BQ = P::BQ, BK = P::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sp = smem;
  T* Qs = reinterpret_cast<T*>(sp);         sp += P::TQ;
  T* Gs = reinterpret_cast<T*>(sp);         sp += P::TQ;   // dO
  T* Ks = reinterpret_cast<T*>(sp);         sp += P::TK;
  T* Vs = reinterpret_cast<T*>(sp);         sp += P::TK;
  float* Ss = reinterpret_cast<float*>(sp);  sp += P::SS;
  float* dPs = reinterpret_cast<float*>(sp); sp += P::SS;
  T* dSs = reinterpret_cast<T*>(sp);        sp += P::SP;
  float* dQs = reinterpret_cast<float*>(sp); sp += P::AQ;
  float* lse_s = reinterpret_cast<float*>(sp); sp += P::ROWQ;
  float* del_s = reinterpret_cast<float*>(sp);

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, HK = a.HK;
  const int kh = h / (H / HK);
  const int tid = threadIdx.x;
  const size_t qstride = (size_t)H * HD, kstride = (size_t)HK * HD;
  const int q0 = qi * BQ;
  const size_t qoff = ((size_t)b * S + q0) * qstride + (size_t)h * HD;
  const T* kg = static_cast<const T*>(a.k) + (size_t)b * S * kstride +
                (size_t)kh * HD;
  const T* vg = static_cast<const T*>(a.v) + (size_t)b * S * kstride +
                (size_t)kh * HD;

  load_rows<T, BQ, HD>(Qs, P::LDT, static_cast<const T*>(a.q) + qoff,
                       qstride);
  load_rows<T, BQ, HD>(Gs, P::LDT, static_cast<const T*>(a.dout) + qoff,
                       qstride);
  ptt::cp_async_commit();
  zero(dQs, BQ * P::LDA);
  const size_t srow = ((size_t)b * H + h) * S + q0;
  for (int r = tid; r < BQ; r += NT) {
    lse_s[r] = a.lse[srow + r];
    del_s[r] = a.delta[srow + r];
  }
  const int nk = a.causal ? (q0 + BQ - 1) / BK + 1 : S / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    load_rows<T, BK, HD>(Ks, P::LDT, kg + (size_t)k0 * kstride, kstride);
    load_rows<T, BK, HD>(Vs, P::LDT, vg + (size_t)k0 * kstride, kstride);
    ptt::cp_async_commit();
    ptt::cp_async_wait<0>();
    __syncthreads();
    gemm<T, BQ, BK, HD, true, false, false>(Qs, P::LDT, Ks, P::LDT, Ss,
                                            P::LDS);
    gemm<T, BQ, BK, HD, true, false, false>(Gs, P::LDT, Vs, P::LDT, dPs,
                                            P::LDS);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      float s = Ss[r * P::LDS + c] * a.scale;
      if (a.causal && k0 + c > q0 + r) s = NEG;
      const float p = expf(s - lse_s[r]);
      const float ds = p * (dPs[r * P::LDS + c] - del_s[r]) * a.scale;
      dSs[r * P::LDP + c] = ptt::from_f<T>(ds);
    }
    __syncthreads();
    gemm<T, BQ, HD, BK, true, true, true>(dSs, P::LDP, Ks, P::LDT, dQs,
                                          P::LDA);
    __syncthreads();
  }
  T* dqg = static_cast<T*>(a.dq) + qoff;
  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    dqg[r * qstride + d] = ptt::from_f<T>(dQs[r * P::LDA + d]);
  }
}

// -- backward: dk, dv ------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(Args a) {
  using P = Plan<T, HD>;
  constexpr int BQ = P::BQ, BK = P::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sp = smem;
  T* Ks = reinterpret_cast<T*>(sp);         sp += P::TK;
  T* Vs = reinterpret_cast<T*>(sp);         sp += P::TK;
  T* Qs = reinterpret_cast<T*>(sp);         sp += P::TQ;
  T* Gs = reinterpret_cast<T*>(sp);         sp += P::TQ;   // dO
  float* Ss = reinterpret_cast<float*>(sp);  sp += P::SS;
  float* dPs = reinterpret_cast<float*>(sp); sp += P::SS;
  T* Ps = reinterpret_cast<T*>(sp);         sp += P::SP;
  T* dSs = reinterpret_cast<T*>(sp);        sp += P::SP;
  float* dKs = reinterpret_cast<float*>(sp); sp += P::AK;
  float* dVs = reinterpret_cast<float*>(sp); sp += P::AK;
  float* lse_s = reinterpret_cast<float*>(sp); sp += P::ROWQ;
  float* del_s = reinterpret_cast<float*>(sp);

  const int kj = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, HK = a.HK;
  const int rep = H / HK;
  const int tid = threadIdx.x;
  const size_t qstride = (size_t)H * HD, kstride = (size_t)HK * HD;
  const int k0 = kj * BK;
  const size_t koff = ((size_t)b * S + k0) * kstride + (size_t)kh * HD;

  load_rows<T, BK, HD>(Ks, P::LDT, static_cast<const T*>(a.k) + koff,
                       kstride);
  load_rows<T, BK, HD>(Vs, P::LDT, static_cast<const T*>(a.v) + koff,
                       kstride);
  ptt::cp_async_commit();
  zero(dKs, BK * P::LDA);
  zero(dVs, BK * P::LDA);
  // a q block whose last row precedes this key block sees none of it
  // under the causal mask (:290-292)
  const int qstart = a.causal ? k0 / BQ : 0;
  const int nq = S / BQ;
  for (int g = 0; g < rep; ++g) {
    const int h = kh * rep + g;
    for (int qi = qstart; qi < nq; ++qi) {
      const int q0 = qi * BQ;
      const size_t qoff = ((size_t)b * S + q0) * qstride + (size_t)h * HD;
      load_rows<T, BQ, HD>(Qs, P::LDT, static_cast<const T*>(a.q) + qoff,
                           qstride);
      load_rows<T, BQ, HD>(Gs, P::LDT, static_cast<const T*>(a.dout) + qoff,
                           qstride);
      ptt::cp_async_commit();
      const size_t srow = ((size_t)b * H + h) * S + q0;
      for (int r = tid; r < BQ; r += NT) {
        lse_s[r] = a.lse[srow + r];
        del_s[r] = a.delta[srow + r];
      }
      ptt::cp_async_wait<0>();
      __syncthreads();
      gemm<T, BQ, BK, HD, true, false, false>(Qs, P::LDT, Ks, P::LDT, Ss,
                                              P::LDS);
      gemm<T, BQ, BK, HD, true, false, false>(Gs, P::LDT, Vs, P::LDT, dPs,
                                              P::LDS);
      __syncthreads();
      for (int e = tid; e < BQ * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        float s = Ss[r * P::LDS + c] * a.scale;
        if (a.causal && k0 + c > q0 + r) s = NEG;
        const float p = expf(s - lse_s[r]);
        const float ds = p * (dPs[r * P::LDS + c] - del_s[r]) * a.scale;
        Ps[r * P::LDP + c] = ptt::from_f<T>(p);
        dSs[r * P::LDP + c] = ptt::from_f<T>(ds);
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: P and dS read transposed in place
      gemm<T, BK, HD, BQ, false, true, true>(Ps, P::LDP, Gs, P::LDT, dVs,
                                             P::LDA);
      gemm<T, BK, HD, BQ, false, true, true>(dSs, P::LDP, Qs, P::LDT, dKs,
                                             P::LDA);
      __syncthreads();   // Q, dO, P, dS, lse, delta free for the next pair
    }
  }
  T* dkg = static_cast<T*>(a.dk) + koff;
  T* dvg = static_cast<T*>(a.dv) + koff;
  for (int e = tid; e < BK * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    dkg[r * kstride + d] = ptt::from_f<T>(dKs[r * P::LDA + d]);
    dvg[r * kstride + d] = ptt::from_f<T>(dVs[r * P::LDA + d]);
  }
}

// -- launches --------------------------------------------------------------------

enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <typename T, int HD, int W>
int launch(const Args& a, int B, cudaStream_t stream) {
  using P = Plan<T, HD>;
  constexpr size_t smem = W == FWD ? P::FWD : W == DQ ? P::DQ : P::DKV;
  static_assert(smem <= 232448, "shared memory plan exceeds 227 KB");
  auto kern = W == FWD ? flash_fwd_kernel<T, HD>
              : W == DQ ? flash_dq_kernel<T, HD> : flash_dkv_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(W == DKV ? a.S / P::BK : a.S / P::BQ, W == DKV ? a.HK : a.H, B);
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int W>
int dispatch(int dtype, const Args& a, int B, int D, void* stream) {
  // every block size divides 64; D is the one instantiated head_dim
  if (B <= 0 || a.S <= 0 || a.S % 64 != 0 || a.HK <= 0 || a.H % a.HK != 0 ||
      D != 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16) return launch<__nv_bfloat16, 128, W>(a, B, s);
  if (dtype == ptt::DT_FLOAT32) return launch<float, 128, W>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out = softmax(q k^T * scale [causal]) v per query head; lse = m + log(l).
// q/out [B, S, H, D]; k/v [B, S, HK, D]; lse [B, H, S] fp32.
int ptt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                  void* out, void* lse, int B, int S, int H, int HK, int D,
                  float scale, int causal, void* stream) {
  Args a{q, k, v, out, nullptr, static_cast<float*>(lse), nullptr, nullptr,
         nullptr, nullptr, S, H, HK, scale, causal};
  return dispatch<FWD>(dtype, a, B, D, stream);
}

// dq from the saved lse and delta = rowsum(dout * out) ([B, H, S] fp32).
int ptt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int S, int H, int HK, int D, float scale,
                     int causal, void* stream) {
  Args a{q, k, v, nullptr, dout,
         const_cast<float*>(static_cast<const float*>(lse)),
         static_cast<const float*>(delta), dq, nullptr, nullptr, S, H, HK,
         scale, causal};
  return dispatch<DQ>(dtype, a, B, D, stream);
}

// dk, dv ([B, S, HK, D]) summed over each kv head's query group.
int ptt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int S, int H, int HK, int D,
                      float scale, int causal, void* stream) {
  Args a{q, k, v, nullptr, dout,
         const_cast<float*>(static_cast<const float*>(lse)),
         static_cast<const float*>(delta), nullptr, dk, dv, S, H, HK, scale,
         causal};
  return dispatch<DKV>(dtype, a, B, D, stream);
}

}  // extern "C"
