// Flash attention forward and backward (dq, dk/dv), for Hopper.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   `_fwd_kernel` (:71)      -> flash_fwd_hopper (bf16), flash_fwd_kernel
//                               (fp32)
//   `_bwd_dq_kernel` (:192)  -> flash_dq_kernel
//   `_bwd_dkv_kernel` (:242) -> flash_dkv_kernel
// Inputs keep the API's [batch, seq, heads, head_dim] layout and are read
// through their row strides (heads * head_dim), so nothing is transposed
// first as the TPU wrapper does (:529-535).  Query head h reads kv head
// h / (H / HK): KV is never repeated for GQA.
//
// The bf16 forward (flash_fwd_hopper) is built for this card: one block
// of three warpgroups per (q tile of 128 rows, query head, batch).
//   - Loads: warpgroup 0 is the producer; one thread issues TMA loads over
//     4-d tensor maps of the [b, s, h, d] tensors (boxes of 64 d x 1 head
//     x 128 or 64 rows, 128-byte swizzle; rows past s are zero-filled):
//     the Q tile once, then the K and V tiles of each 64-key block
//     through a ring of 4 slots, K and V on separate mbarriers so S = Q K^T
//     starts before V lands; the consumers free a slot (one arrival per
//     warp) after their P V product.
//   - Products: warpgroups 1 and 2 own 64 query rows each.  S = Q K^T is
//     wgmma m64n64k16 from shared memory (K-major K), fp32 in registers;
//     the online softmax runs on those registers, in the exp2 domain (the
//     scores times scale * log2 e, one multiply; ex2.approx), row max and
//     sum across the 4 threads of a row by shuffles; P is cast to V's type
//     in registers (the TPU kernel's cast, :106-108) and is wgmma's A
//     operand for O += P V (MN-major V), so S, P and O never touch shared
//     memory.  Key block j's S and block j - 1's P V are in flight
//     together and the softmax of block j runs under the P V product;
//     64-key blocks keep S, P and O within the 168 registers a thread
//     (with 128-key blocks this loop spills).  setmaxnreg moves registers
//     from the producer (40) to the consumers (232).
//   - Causal blocks: key blocks wholly above the diagonal are never
//     loaded (:113-119); only the blocks that cross it are masked (s is a
//     multiple of 64, so no key block is ragged).
//   - Scheduling: blockIdx.y walks the q tiles heaviest first (the last
//     q tile has the most key blocks under the causal mask), so the
//     light tiles fill the tail of the grid.
//   - lse = (m2 + log2 l) ln 2, the natural-log value the backward
//     kernels read (m2 the running max in the exp2 domain).
// What bounds it at b=4, s=2048, 32/8 heads, head_dim 128, causal: the
// products, 137.4 GFLOP (0.139 ms at 989 TFLOP/s); the bytes (72 MB)
// take a sixth of that.  It runs at about a third of that rate; what
// holds it is not yet measured (PERF.md).
//
// fp32 (a parity path on no main path) and the backward use a simpler
// design (one CTA of 4 warps per tile; every product a GEMM between tiles
// in shared memory, every accumulator an fp32 tile in shared memory):
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
// bf16 backward products run on the tensor cores through nvcuda::wmma
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
// What bounds the backward at the training shapes: the products; each
// CTA reloads its K/V (dq) or Q/dO (dk/dv) tiles from device memory (L2
// catches most of it).  It keeps accumulators in shared memory between
// wmma calls and does not overlap loads with products.
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt::flash;

// -- forward -----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash_fwd_tile<T, HD>(a, blockIdx.x, blockIdx.y, blockIdx.z, smem);
}

// -- forward, bf16: wgmma, TMA and an mbarrier ring ---------------------------

namespace hop {

using bf16 = __nv_bfloat16;
using namespace ptt::hopper;
constexpr int BQ = 128;        // query rows a block (two consumer warpgroups)
constexpr int BK = 64;         // key rows a key block
constexpr int HD = 128;        // head_dim
constexpr int ST = 4;          // K / V ring slots
constexpr int THREADS = 384;
constexpr uint32_t QTILE = BQ * HD * 2;   // 32 KB: two 64-column chunks
constexpr uint32_t QCHUNK = QTILE / 2;
constexpr uint32_t KTILE = BK * HD * 2;   // 16 KB: two 64-column chunks
constexpr uint32_t KCHUNK = KTILE / 2;
// dynamic shared memory: alignment slack, Q, and each slot's K and V
constexpr size_t SMEM = 1024 + QTILE + 2 * ST * KTILE;

struct Params {
  CUtensorMap q;         // 4-d {d, heads, s, b}, boxes {64, 1, 128, 1}
  CUtensorMap k, v;      // boxes {64, 1, 64, 1}
  bf16* o;
  float* lse;
  int S, H, HK, nq;
  float scale2;          // scale * log2 e
  int causal;
};

// 2^x on the special-function unit; subnormal results flush to 0 (a
// probability below 2^-126 of the row's largest)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for a consumer's 64 rows (Qc) and a K tile, zeroed, issued
// and committed as one wgmma group
__device__ __forceinline__ void issue_qk(float (&sc)[32],
                                         const unsigned char* Qc,
                                         const unsigned char* Kt) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64<0>(sc, desc_kmajor(Qc + (kk / 4) * QCHUNK + (kk % 4) * 32),
                    desc_kmajor(Kt + (kk / 4) * KCHUNK + (kk % 4) * 32));
  wgmma_commit();
}

// O += P V for a V tile, P as wgmma's A fragments: one wgmma group
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[4][4],
                                         const unsigned char* Vt) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs_n128<1>(o, pa[kk], desc_mnmajor(Vt + kk * 2048, KCHUNK));
  wgmma_commit();
}

// The online softmax of one score tile in registers, in the exp2 domain:
// scores times scale * log2 e (masked above the diagonal where `edge`),
// the row max across the 4 threads of a row by shuffles, sc = 2^(s2 - m2)
// in place, l rescaled and this thread's share of the row sums added;
// corr = 2^(m2_old - m2_new) for O.  row: the first of the thread's two
// rows (the other is row + 8).
__device__ __forceinline__ void softmax(float (&sc)[32], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        bool edge, int k0, int row, int cq,
                                        float scale2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * i + e] * scale2;
      if (edge && k0 + 8 * i + cq + (e & 1) > row + 8 * (e >> 1))
        v = -INFINITY;
      sc[4 * i + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // a row masked so far
    corr[r] = ex2(m[r] - base[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(sc[4 * i + e] - base[e >> 1]);
      l[e >> 1] += pe;   // this thread's share; the row sums at the end
      sc[4 * i + e] = pe;
    }
}

// P in V's type as wgmma's A fragments: k16 step kk is the n8 blocks
// 2 kk and 2 kk + 1 of S
__device__ __forceinline__ void to_frags(const float (&sc)[32],
                                         uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_hopper(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qbar, kfull[ST], vfull[ST], empty[ST];
  unsigned char* Qs = align1024(smem_raw);
  auto Ks = [&](int s) { return Qs + QTILE + s * 2 * KTILE; };
  auto Vs = [&](int s) { return Ks(s) + KTILE; };

  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int qi = p.nq - 1 - blockIdx.y;   // heaviest q tile first
  const int q0 = qi * BQ;
  const int kh = h / (p.H / p.HK);
  // key blocks wholly above the diagonal are never loaded (s is a
  // multiple of 64, so no key block is ragged)
  const int nk = p.causal ? min((q0 + BQ) / BK, p.S / BK) : p.S / BK;
  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // the producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&qbar, QTILE);
      tma_load_4d(Qs, &p.q, &qbar, 0, h, q0, b);
      tma_load_4d(Qs + QCHUNK, &p.q, &qbar, 64, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        mbar_expect_tx(&kfull[s], KTILE);
        tma_load_4d(Ks(s), &p.k, &kfull[s], 0, kh, j * BK, b);
        tma_load_4d(Ks(s) + KCHUNK, &p.k, &kfull[s], 64, kh, j * BK, b);
        mbar_expect_tx(&vfull[s], KTILE);
        tma_load_4d(Vs(s), &p.v, &vfull[s], 0, kh, j * BK, b);
        tma_load_4d(Vs(s) + KCHUNK, &p.v, &vfull[s], 64, kh, j * BK, b);
      }
    }
    return;
  }
  regs_inc<232>();

  const int c = threadIdx.x / 128 - 1;           // consumer warpgroup
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 64 * c + 16 * (t / 32) + lane / 4;   // rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                 // first column of a pair
  const unsigned char* Qc = Qs + c * 64 * 128;   // this warpgroup's rows
  float o[64], sc[32], corr[2];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // a key block past this warpgroup's first row: the diagonal's
  auto edge = [&](int j) {
    return p.causal && j * BK + BK - 1 > q0 + 64 * c;
  };
  mbar_wait(&qbar, 0);

  // key block 0: S, then its softmax
  mbar_wait(&kfull[0], 0);
  issue_qk(sc, Qc, Ks(0));
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(sc, m, l, corr, edge(0), 0, q0 + r0, cq, p.scale2);
  to_frags(sc, pa);
  // key block j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight
  // together; the softmax of S_j runs under the P V product
  for (int j = 1; j < nk; ++j) {
    const int s = j % ST, sp = (j - 1) % ST;
    mbar_wait(&kfull[s], (j / ST) & 1);
    issue_qk(sc, Qc, Ks(s));
    mbar_wait(&vfull[sp], ((j - 1) / ST) & 1);
    issue_pv(o, pa, Vs(sp));
    wgmma_wait<1>();   // S_j
    fence_regs(sc);
    softmax(sc, m, l, corr, edge(j), j * BK, q0 + r0, cq, p.scale2);
    wgmma_wait<0>();   // P_{j-1} V_{j-1}: its slot and pa are free
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[sp]);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
    to_frags(sc, pa);
  }
  const int sl = (nk - 1) % ST;
  mbar_wait(&vfull[sl], ((nk - 1) / ST) & 1);
  issue_pv(o, pa, Vs(sl));
  wgmma_wait<0>();
  fence_regs(o);

  // out = O / l in bf16; lse in natural log
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= p.S) continue;
    const float safe_l = l[r] > 0.f ? l[r] : 1.f;
    uint32_t* og = reinterpret_cast<uint32_t*>(
        p.o + (((size_t)b * p.S + row) * p.H + h) * HD);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      og[(8 * i + cq) / 2] = pack_bf16(o[4 * i + 2 * r] / safe_l,
                                       o[4 * i + 2 * r + 1] / safe_l);
    if (lane % 4 == 0 && p.lse != nullptr)
      p.lse[((size_t)b * p.H + h) * p.S + row] =
          (m[r] + log2f(safe_l)) * 0.69314718055994531f;
  }
}

// the tensor map of a [B, S, heads, 128] bf16 tensor, boxes of 64 d x 1
// head x `rows` rows
cudaError_t map_bshd(CUtensorMap* map, const void* base, int B, int S,
                     int heads, int rows) {
  const uint64_t dims[4] = {HD, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {HD * 2, (uint64_t)heads * HD * 2,
                               (uint64_t)S * heads * HD * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return ptt::hopper::make_map(map, base, 4, dims, strides, box);
}

int launch(const ptt::flash::Args& a, int B, cudaStream_t stream) {
  Params p{};
  cudaError_t e = map_bshd(&p.q, a.q, B, a.S, a.H, BQ);
  if (e == cudaSuccess) e = map_bshd(&p.k, a.k, B, a.S, a.HK, BK);
  if (e == cudaSuccess) e = map_bshd(&p.v, a.v, B, a.S, a.HK, BK);
  if (e != cudaSuccess) return (int)e;
  p.o = static_cast<bf16*>(a.o);
  p.lse = a.lse;
  p.S = a.S;
  p.H = a.H;
  p.HK = a.HK;
  p.nq = (a.S + BQ - 1) / BQ;
  p.scale2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  e = cudaFuncSetAttribute(flash_fwd_hopper,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * a.H, p.nq);
  flash_fwd_hopper<<<grid, THREADS, SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace hop

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
  auto kern = [] {
    if constexpr (W == FWD) return flash_fwd_kernel<T, HD>;
    else if constexpr (W == DQ) return flash_dq_kernel<T, HD>;
    else return flash_dkv_kernel<T, HD>;
  }();
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
  if (dtype == ptt::DT_BFLOAT16) {
    if constexpr (W == FWD) return hop::launch(a, B, s);
    else return launch<__nv_bfloat16, 128, W>(a, B, s);
  }
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
