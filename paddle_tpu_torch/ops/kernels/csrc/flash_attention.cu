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
#include "flash_tile.cuh"

namespace {

using namespace ptt::flash;

// -- forward -----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash_fwd_tile<T, HD>(a, blockIdx.x, blockIdx.y, blockIdx.z, smem);
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
