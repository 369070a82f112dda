// Flash attention forward and backward (dq, dk/dv), for Hopper.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   `_fwd_kernel` (:71)      -> flash_fwd_hopper (bf16), flash_fwd_kernel
//                               (fp32)
//   `_bwd_dq_kernel` (:192)  -> flash_dq_hopper (bf16), flash_dq_kernel
//                               (fp32)
//   `_bwd_dkv_kernel` (:242) -> flash_dkv_hopper (bf16), flash_dkv_kernel
//                               (fp32)
// Inputs keep the API's [batch, seq, heads, head_dim] layout and are read
// through their row strides (heads * head_dim), so nothing is transposed
// first as the TPU wrapper does (:529-535).  Query head h reads kv head
// h / (H / HK): KV is never repeated for GQA.
//
// The bf16 kernels are built for this card: one block of three
// warpgroups each, warpgroup 0 the producer (one thread issues TMA loads
// over 4-d tensor maps of the [b, s, h, d] tensors: boxes of 64 d x 1
// head x 128 or 64 rows, 128-byte swizzle, rows past s zero-filled, into
// rings of 4 slots on mbarriers; the consumers free a slot with one
// arrival per warp), warpgroups 1 and 2 the consumers, 64 rows each, every
// product a wgmma (m64n64k16 for score tiles from shared memory, both
// operands K-major; m64n128k16 for d-wide products with A from registers
// and B MN-major through the transpose bit) with fp32 accumulators in
// registers: scores and gradients never touch shared memory.  The
// accumulator fragment of a score tile is the A fragment of the next
// product (n8 blocks 2kk, 2kk + 1 are k16 step kk).  setmaxnreg moves
// registers from the producer to the consumers.  Softmax in the exp2
// domain (scores times scale * log2 e, ex2.approx).
//   forward  per (q tile of 128 rows, query head, batch): Q once, K and V
//            of each 64-key block through the ring (separate mbarriers, so
//            S = Q K^T starts before V lands); the online softmax on the
//            S registers, P cast to V's type (the TPU kernel's cast,
//            :106-108) for O += P V.  Key block j's S and block j - 1's
//            P V are in flight together, the softmax of block j under the
//            P V product; 64-key blocks keep S, P and O within the
//            registers (128-key blocks spill).  lse = (m2 + log2 l) ln 2,
//            the natural-log value the backward reads.
//   dq       per (q tile of 128 rows, query head, batch): Q and dO once,
//            K and V of each 64-key block through the ring; S = Q K^T and
//            dP = dO V^T, P = 2^(S scale log2 e - lse log2 e),
//            dS = P (dP - delta) scale cast to bf16 in registers,
//            dQ += dS K (K MN-major).  Block j's S and dP and block j - 1's
//            dQ product are in flight together, dS of block j under it.
//   dk/dv    per (key tile of 128 rows, kv head, batch), in transposed
//            score space as the TPU kernel works (:186-190): K and V once,
//            then (Q, dO, lse, delta) of every (group head, q block of 64
//            rows) pair through the ring, as the TPU grid's inner axis
//            walks them (:245-247, :355); S^T = K Q^T, dP^T = V dO^T,
//            P^T with lse and delta per column from the slot's copy (1-d
//            bulk copies), dV += P^T dO, dK += dS^T Q (dO and Q MN-major:
//            the tiles S^T and dP^T read K-major).  dK and dV stay in
//            registers over the whole GQA group: no atomics, one order,
//            deterministic sums.  The next pair's S^T and dP^T issued
//            under dV and dK ran slower than this loop, whose two
//            consumers interleave on the tensor cores.
// delta = rowsum(dO * O) comes from the wrapper, as _bwd_pallas computes
// it outside its kernels (:314-315).
//   Causal: key blocks above the diagonal (dq) and q blocks before it
//   (dk/dv) are never loaded (:113-119, :290-292); only blocks that cross
//   it are masked, by position (s is a multiple of 64: no 64-row block is
//   ragged).  A last 128-row tile of 64 rows (s % 128 == 64) runs one
//   consumer, so zero-filled rows are never computed or written.
//   Scheduling: blockIdx.y walks the tiles heaviest first (the last q
//   tiles, the first key tiles under the causal mask), so the light
//   tiles fill the tail of the grid.
// What bounds them at b=4, s=2048, 32/8 heads, head_dim 128, causal: the
// products (forward 137.4 GFLOP, 0.139 ms at 989 TFLOP/s; dq 206.2,
// dk/dv 274.9: S and dP are recomputed in both, 7 products against the
// 5 of a fused backward that gives up deterministic sums).  The times
// are in PERF.md.
//
// fp32 (a parity path on no main path) uses a simpler design (one CTA of
// 4 warps per tile; every product a GEMM between tiles in shared memory
// on the CUDA cores with fp32 FMAs, no TF32; every accumulator an fp32
// tile in shared memory; BQ = BK = 32):
//   forward  per (q block, query head, batch): key blocks up to the
//            diagonal in order; S = Q K^T * scale, the online softmax
//            (running max and sum, fp32) rescales the O tile, O += P V.
//            Writes out and lse = m + log(l) (fp32, [b, h, s]).
//   dq       per (q block, query head, batch), looping over key blocks:
//            P = exp(S - lse), dP = dO V^T, dS = P * (dP - delta) * scale,
//            dQ += dS K.
//   dk/dv    per (key block, kv head, batch), walking every (group head,
//            q block) pair: dV += P^T dO, dK += dS^T Q over the whole
//            group.
// head_dim is a template parameter of the fp32 kernels and a constant of
// the bf16 ones; 128 is built (the Llama path), 256 waits (ROADMAP.md,
// queue 2).
//
// Precision: the TPU backward takes the P^T dO, dS K and dS^T Q products
// in fp32 (:277-288).  The bf16 kernels here round P and dS to bf16 for
// the tensor-core products, as FlashAttention-2 does (accumulation stays
// fp32); in fp32 nothing is rounded.
#include "flash_hopper.cuh"
#include "flash_tile.cuh"

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
// the forward's constants and product helpers (flash_hopper.cuh)
using ptt::fwd::BK;
using ptt::fwd::BQ;
using ptt::fwd::ex2;
using ptt::fwd::HD;
using ptt::fwd::issue_pv;
using ptt::fwd::issue_qk;
using ptt::fwd::KCHUNK;
using ptt::fwd::KTILE;
using ptt::fwd::QCHUNK;
using ptt::fwd::QTILE;
using ptt::fwd::ST;
using ptt::fwd::to_frags;
constexpr int THREADS = 384;
// dynamic shared memory: alignment slack, Q, and each slot's K and V
constexpr size_t SMEM = 1024 + ptt::fwd::BYTES;

struct Params {
  CUtensorMap q;         // 4-d {d, heads, s, b}, boxes {64, 1, 128, 1}
  CUtensorMap k, v;      // boxes {64, 1, 64, 1}
  bf16* o;
  float* lse;
  int S, H, HK, nq;
  float scale2;          // scale * log2 e
  int causal;
};

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_hopper(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qfull, qempty, kfull[ST], vfull[ST], empty[ST];
  const ptt::fwd::Ring r{align1024(smem_raw), &qfull, &qempty, kfull, vfull,
                         empty};
  ptt::fwd::Item w;
  w.h = blockIdx.x % p.H;
  w.b = blockIdx.x / p.H;
  w.q0 = (p.nq - 1 - blockIdx.y) * BQ;   // heaviest q tile first
  w.kh = w.h / (p.H / p.HK);
  // key blocks wholly above the diagonal are never loaded (s is a
  // multiple of 64, so no key block is ragged)
  w.nk = p.causal ? min((w.q0 + BQ) / BK, p.S / BK) : p.S / BK;
  if (threadIdx.x == 0) ptt::fwd::ring_init(r);
  __syncthreads();

  int kv = 0;
  if (threadIdx.x < 128) {   // the producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0) ptt::fwd::produce<false>(r, &p.q, &p.k, &p.v, w, 0, kv);
    return;
  }
  regs_inc<232>();
  ptt::fwd::consume<false>(r, w, 0, kv, threadIdx.x / 128 - 1, p.S, p.H, p.scale2,
                    p.causal, p.o, p.lse);
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

// -- backward, bf16: dq and dk/dv on wgmma, TMA and mbarrier rings -----------

constexpr int BST = 4;   // ring slots of both backward kernels
constexpr float LOG2E = 1.4426950408889634f;
// dynamic shared memory of both: alignment slack, two 128-row tiles loaded
// once (Q and dO, or K and V) and each slot's two 64-row tiles (K and V,
// or Q and dO)
constexpr size_t BWD_SMEM = 1024 + 2 * QTILE + 2 * BST * KTILE;

struct BwdParams {
  CUtensorMap q, g;      // q and dO: boxes of 128 rows (dq), 64 (dk/dv)
  CUtensorMap k, v;      // boxes of 64 rows (dq), 128 (dk/dv)
  const float* lse;      // [b, h, s], natural log
  const float* delta;    // [b, h, s]
  bf16 *dq, *dk, *dv;
  int S, H, HK, ntiles;
  float scale, scale2;   // scale, scale * log2 e
  int causal;
};

// dS = P (dP - delta) scale for the dq kernel's row-major scores, P =
// 2^(S scale2 - lse2) recomputed in place of S and dS written over it:
// lse2 (lse * log2 e) and delta per row, P = 0 above the diagonal where
// `edge`.  row: the first of the thread's two rows (the other is row + 8)
__device__ __forceinline__ void ds_rows(float (&sc)[32], const float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], bool edge,
                                        int k0, int row, int cq, float scale2,
                                        float scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float pe = ex2(fmaf(sc[4 * i + e], scale2, -lse2[r]));
      if (edge && k0 + 8 * i + cq + (e & 1) > row + 8 * r) pe = 0.f;
      sc[4 * i + e] = pe * (dp[4 * i + e] - dl[r]) * scale;
    }
}

// One block of three warpgroups per (q tile of 128 rows, query head,
// batch): warpgroup 0 loads Q and dO once and streams the K and V tiles
// of each 64-key block through a ring; warpgroups 1 and 2 own 64 query
// rows each and keep S, dP, dS and dQ in registers.
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_hopper(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qbar, kfull[BST], vfull[BST], empty[BST];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Gs = Qs + QTILE;
  auto Ks = [&](int s) { return Gs + QTILE + s * 2 * KTILE; };
  auto Vs = [&](int s) { return Ks(s) + KTILE; };

  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int q0 = (p.ntiles - 1 - blockIdx.y) * BQ;   // heaviest q tile first
  const int kh = h / (p.H / p.HK);
  // key blocks wholly above the diagonal are never loaded
  const int nk = p.causal ? min((q0 + BQ) / BK, p.S / BK) : p.S / BK;
  // a last tile of 64 rows (s % 128 == 64) has one consumer
  const int nact = q0 + 64 < p.S ? 2 : 1;
  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < BST; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 4 * nact);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // the producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&qbar, 2 * QTILE);
      tma_load_4d(Qs, &p.q, &qbar, 0, h, q0, b);
      tma_load_4d(Qs + QCHUNK, &p.q, &qbar, 64, h, q0, b);
      tma_load_4d(Gs, &p.g, &qbar, 0, h, q0, b);
      tma_load_4d(Gs + QCHUNK, &p.g, &qbar, 64, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % BST;
        if (j >= BST) mbar_wait(&empty[s], (j / BST - 1) & 1);
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
  if (c >= nact) return;                         // rows past s only
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 64 * c + 16 * (t / 32) + lane / 4;   // rows r0, r0 + 8
  const int cq = 2 * (lane % 4);
  const unsigned char* Qc = Qs + c * 64 * 128;   // this warpgroup's rows
  const unsigned char* Gc = Gs + c * 64 * 128;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const size_t i = ((size_t)b * p.H + h) * p.S + row;
    lse2[r] = row < p.S ? p.lse[i] * LOG2E : INFINITY;   // P = 0 past s
    dl[r] = row < p.S ? p.delta[i] : 0.f;
  }
  // the key blocks this warpgroup needs: past its last row all is masked
  const int nkc = p.causal ? min(nk, (q0 + 64 * c + 64) / BK) : nk;
  auto edge = [&](int j) {
    return p.causal && j * BK + BK - 1 > q0 + 64 * c;
  };
  float acc[64], sc[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(&qbar, 0);

  // key block 0: S and dP, then dS
  mbar_wait(&kfull[0], 0);
  issue_qk(sc, Qc, Ks(0));
  mbar_wait(&vfull[0], 0);
  issue_qk(dp, Gc, Vs(0));
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  ds_rows(sc, dp, lse2, dl, edge(0), 0, q0 + r0, cq, p.scale2, p.scale);
  to_frags(sc, da);
  // key block j: S_j, dP_j and dQ += dS_{j-1} K_{j-1} in flight together;
  // dS_j is computed under the dQ product
  for (int j = 1; j < nkc; ++j) {
    const int s = j % BST, sp = (j - 1) % BST;
    mbar_wait(&kfull[s], (j / BST) & 1);
    issue_qk(sc, Qc, Ks(s));
    mbar_wait(&vfull[s], (j / BST) & 1);
    issue_qk(dp, Gc, Vs(s));
    issue_pv(acc, da, Ks(sp));
    wgmma_wait<1>();   // S_j and dP_j
    fence_regs(sc);
    fence_regs(dp);
    ds_rows(sc, dp, lse2, dl, edge(j), j * BK, q0 + r0, cq, p.scale2,
            p.scale);
    wgmma_wait<0>();   // dQ: block j - 1's slot and da are free
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[sp]);
    to_frags(sc, da);
  }
  issue_pv(acc, da, Ks((nkc - 1) % BST));
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= p.S) continue;
    uint32_t* dg = reinterpret_cast<uint32_t*>(
        p.dq + (((size_t)b * p.S + row) * p.H + h) * HD);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dg[(8 * i + cq) / 2] = pack_bf16(acc[4 * i + 2 * r],
                                       acc[4 * i + 2 * r + 1]);
  }
}

// One block of three warpgroups per (key tile of 128 rows, kv head,
// batch), in transposed score space: warpgroup 0 loads K and V once and
// streams (Q, dO, lse, delta) of every (group head, q block of 64 rows)
// pair through a ring; warpgroups 1 and 2 own 64 key rows each and keep
// S^T, dP^T, P^T, dS^T, dK and dV in registers.  The GQA sum stays in
// the block: no atomics, one order.
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_hopper(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t kvbar, qfull[BST], gfull[BST], empty[BST];
  __shared__ __align__(16) float lse_s[BST][64], dl_s[BST][64];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + QTILE;
  auto Qb = [&](int s) { return Vs + QTILE + s * 2 * KTILE; };
  auto Gb = [&](int s) { return Qb(s) + KTILE; };

  const int kh = blockIdx.x % p.HK, b = blockIdx.x / p.HK;
  const int k0 = blockIdx.y * BQ;   // the heaviest (first) key tiles first
  const int rep = p.H / p.HK;
  // q blocks wholly before the key tile see none of it under the causal
  // mask and are never loaded
  const int qb0 = p.causal ? k0 / 64 : 0;
  const int per = p.S / 64 - qb0;   // q blocks a group head
  const int items = rep * per;
  const int nact = k0 + 64 < p.S ? 2 : 1;   // a last tile of 64 keys
  if (threadIdx.x == 0) {
    mbar_init(&kvbar, 1);
    for (int s = 0; s < BST; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&gfull[s], 1);
      mbar_init(&empty[s], 4 * nact);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // the producer warpgroup
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&kvbar, 2 * QTILE);
      tma_load_4d(Ks, &p.k, &kvbar, 0, kh, k0, b);
      tma_load_4d(Ks + QCHUNK, &p.k, &kvbar, 64, kh, k0, b);
      tma_load_4d(Vs, &p.v, &kvbar, 0, kh, k0, b);
      tma_load_4d(Vs + QCHUNK, &p.v, &kvbar, 64, kh, k0, b);
      for (int i = 0; i < items; ++i) {
        const int s = i % BST;
        const int h = kh * rep + i / per, q0 = (qb0 + i % per) * 64;
        const size_t row = ((size_t)b * p.H + h) * p.S + q0;
        if (i >= BST) mbar_wait(&empty[s], (i / BST - 1) & 1);
        mbar_expect_tx(&qfull[s], KTILE + 2 * 64 * 4);
        tma_load_4d(Qb(s), &p.q, &qfull[s], 0, h, q0, b);
        tma_load_4d(Qb(s) + KCHUNK, &p.q, &qfull[s], 64, h, q0, b);
        bulk_load(lse_s[s], p.lse + row, 64 * 4, &qfull[s]);
        bulk_load(dl_s[s], p.delta + row, 64 * 4, &qfull[s]);
        mbar_expect_tx(&gfull[s], KTILE);
        tma_load_4d(Gb(s), &p.g, &gfull[s], 0, h, q0, b);
        tma_load_4d(Gb(s) + KCHUNK, &p.g, &gfull[s], 64, h, q0, b);
      }
    }
    return;
  }
  regs_inc<240>();

  const int c = threadIdx.x / 128 - 1;           // consumer warpgroup
  if (c >= nact) return;                         // keys past s only
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;       // rows r0, r0 + 8
  const int key = k0 + 64 * c + r0;              // of this thread's row r0
  const int cq = 2 * (lane % 4);                 // first column of a pair
  const unsigned char* Kc = Ks + c * 64 * 128;   // this warpgroup's keys
  const unsigned char* Vc = Vs + c * 64 * 128;
  float dk[64], dv[64], sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&kvbar, 0);

  for (int i = 0; i < items; ++i) {
    const int s = i % BST, ph = (i / BST) & 1;
    const int q0 = (qb0 + i % per) * 64;
    mbar_wait(&qfull[s], ph);
    if (p.causal && q0 + 63 < k0 + 64 * c) {   // every key after every query
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const bool edge = p.causal && k0 + 64 * c + 63 > q0;
    issue_qk(sc, Kc, Qb(s));   // S^T = K Q^T
    mbar_wait(&gfull[s], ph);
    issue_qk(dp, Vc, Gb(s));   // dP^T = V dO^T
    wgmma_wait<1>();
    fence_regs(sc);
    // P^T = 2^(S^T scale2 - lse2) with lse per column (query), from the
    // slot's copy: thread columns 8 i + cq, + 1
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l =
          *reinterpret_cast<const float2*>(&lse_s[s][8 * n + cq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = q0 + 8 * n + cq + (e & 1);
        float pe = ex2(fmaf(sc[4 * n + e], p.scale2,
                            -((e & 1) ? l.y : l.x) * LOG2E));
        if (edge && key + 8 * (e >> 1) > col) pe = 0.f;
        sc[4 * n + e] = pe;
      }
    }
    to_frags(sc, pa);
    issue_pv(dv, pa, Gb(s));   // dV += P^T dO
    wgmma_wait<1>();           // dP^T
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d =
          *reinterpret_cast<const float2*>(&dl_s[s][8 * n + cq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float de = (e & 1) ? d.y : d.x;
        dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - de) * p.scale;
      }
    }
    to_frags(dp, da);
    issue_pv(dk, da, Qb(s));   // dK += dS^T Q
    wgmma_wait<0>();           // the slot is free
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key + 8 * r;
    if (row >= p.S) continue;
    const size_t o = (((size_t)b * p.S + row) * p.HK + kh) * HD;
    uint32_t* kg = reinterpret_cast<uint32_t*>(p.dk + o);
    uint32_t* vg = reinterpret_cast<uint32_t*>(p.dv + o);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int a = 4 * i + 2 * r;
      kg[(8 * i + cq) / 2] = pack_bf16(dk[a], dk[a + 1]);
      vg[(8 * i + cq) / 2] = pack_bf16(dv[a], dv[a + 1]);
    }
  }
}

// dq (dkv = 0) or dk/dv (dkv = 1) of a bf16 backward
int launch_bwd(const ptt::flash::Args& a, int B, int dkv,
               cudaStream_t stream) {
  BwdParams p{};
  const int qrows = dkv ? 64 : BQ, krows = dkv ? BQ : BK;
  cudaError_t e = map_bshd(&p.q, a.q, B, a.S, a.H, qrows);
  if (e == cudaSuccess) e = map_bshd(&p.g, a.dout, B, a.S, a.H, qrows);
  if (e == cudaSuccess) e = map_bshd(&p.k, a.k, B, a.S, a.HK, krows);
  if (e == cudaSuccess) e = map_bshd(&p.v, a.v, B, a.S, a.HK, krows);
  if (e != cudaSuccess) return (int)e;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dq = static_cast<bf16*>(a.dq);
  p.dk = static_cast<bf16*>(a.dk);
  p.dv = static_cast<bf16*>(a.dv);
  p.S = a.S;
  p.H = a.H;
  p.HK = a.HK;
  p.ntiles = (a.S + BQ - 1) / BQ;
  p.scale = a.scale;
  p.scale2 = a.scale * LOG2E;
  p.causal = a.causal;
  auto kern = dkv ? flash_dkv_hopper : flash_dq_hopper;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * (dkv ? a.HK : a.H), p.ntiles);
  kern<<<grid, THREADS, BWD_SMEM, stream>>>(p);
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
    else return hop::launch_bwd(a, B, W == DKV, s);
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
