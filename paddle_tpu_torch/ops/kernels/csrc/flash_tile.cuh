// The pieces of the first flash-attention kernels, which fp32 runs in
// flash_attention.cu's dq and dk/dv and in the fp32 whole-block decoder
// kernel of fused_decoder.cu: the shared-memory tile GEMM, the row loads,
// the argument block and shared-memory plans, and the forward's work for
// one (q block, head, batch) tile as a device function (the decoder's
// attention phase).  flash_attention.cu says what the design is and what
// bounds it; bf16 runs the wgmma kernels (flash_hopper.cuh and
// flash_attention.cu), the fp32 flash forward 3xTF32 on wgmma
// (flash_tf32x3.cuh).
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr int NT = 128;             // threads per CTA
constexpr int NWARP = NT / 32;
constexpr float NEG = -1e30f;       // the TPU kernel's masked score

template <typename T>
struct Blk {
  static constexpr int Q = 32;                          // query rows
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
  // thread (ty, tx) of an 8 x 16 grid owns rows ty + 8 i and columns
  // tx + 16 j; fp32 FMAs on the CUDA cores
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

// -- forward: one tile ---------------------------------------------------------

// One (q block qi, query head h, batch b) tile of the forward: the CTA's
// NT threads walk the key blocks up to the causal diagonal.  `smem` holds
// Plan<T, HD>::FWD bytes.  With a.lse null the row statistics are not
// written (the decoder block needs only the output).
template <typename T, int HD>
__device__ __forceinline__ void flash_fwd_tile(const Args& a, int qi, int h,
                                               int b, unsigned char* smem) {
  using P = Plan<T, HD>;
  constexpr int BQ = P::BQ, BK = P::BK;
  unsigned char* sp = smem;
  T* Qs = reinterpret_cast<T*>(sp);        sp += P::TQ;
  T* Ks = reinterpret_cast<T*>(sp);        sp += P::TK;
  T* Vs = reinterpret_cast<T*>(sp);        sp += P::TK;
  float* Ss = reinterpret_cast<float*>(sp); sp += P::SS;
  T* Ps = reinterpret_cast<T*>(sp);        sp += P::SP;
  float* Os = reinterpret_cast<float*>(sp); sp += P::AQ;
  float* m_s = reinterpret_cast<float*>(sp); sp += P::ROWQ;
  float* l_s = reinterpret_cast<float*>(sp);

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
  if (a.lse == nullptr) return;
  float* lg = a.lse + ((size_t)b * H + h) * S + q0;
  for (int r = tid; r < BQ; r += NT) {
    const float l = l_s[r];
    lg[r] = m_s[r] + logf(l > 0.f ? l : 1.f);
  }
}

}  // namespace flash
}  // namespace ptt
