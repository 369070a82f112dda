// The bf16 flash forward on wgmma, TMA and an mbarrier ring, as device
// functions for one work item (a q tile of 128 rows of one query head of
// one batch row): flash_attention.cu's flash_fwd_hopper runs one item a
// block, fused_decoder.cu's block kernel walks many items a block in its
// attention phase.  flash_attention.cu's backward kernels share the
// constants and the product helpers.
//
// An item: Q once (128 rows, two 64-column chunks), K and V of each
// 64-key block through a ring of ST slots (separate mbarriers, so S = Q
// K^T starts before V lands); the online softmax on the S registers in
// the exp2 domain (scores times scale * log2 e, ex2.approx), P cast to
// V's type (the TPU kernel's cast, flash_attention.py:106-108) for O +=
// P V.  Key block j's S and block j - 1's P V are in flight together, the
// softmax of block j under the P V product; 64-key blocks keep S, P and O
// within the registers.  out = O / l with the l > 0 guard; lse = (m2 +
// log2 l) ln 2 where asked.  WALK (a block that walks several items):
// Q and the K/V slots are freed by arrivals (one per consumer warp) on
// qempty and empty, so the next item's Q and keys load while this one
// finishes; the running key-block count `kv` and the item count carry
// the slots' phases from item to item, as hopper_gemm.cuh's running slice
// count does for GEMM tiles.  Without WALK (one item a block) none of
// that is compiled: the kernel is the single-item loop, whose time the
// walk's arrivals cost.
#pragma once

#include "hopper.cuh"

namespace ptt {
namespace fwd {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;        // query rows an item (two consumer warpgroups)
constexpr int BK = 64;         // key rows a key block
constexpr int HD = 128;        // head_dim
constexpr int ST = 4;          // K / V ring slots
constexpr uint32_t QTILE = BQ * HD * 2;   // 32 KB: two 64-column chunks
constexpr uint32_t QCHUNK = QTILE / 2;
constexpr uint32_t KTILE = BK * HD * 2;   // 16 KB: two 64-column chunks
constexpr uint32_t KCHUNK = KTILE / 2;
// the item's shared memory after the 1024-byte alignment: Q, then each
// slot's K and V
constexpr uint32_t BYTES = QTILE + 2 * ST * KTILE;

// 2^x on the special-function unit; subnormal results flush to 0 (a
// probability below 2^-126 of the row's largest)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = A B^T for a consumer's 64 rows of a 128-row tile (A: Q, dO, K or V)
// and a 64-row tile (B: K, V, Q or dO), reduced over d; zeroed, issued and
// committed as one wgmma group
__device__ __forceinline__ void issue_qk(float (&sc)[32],
                                         const unsigned char* Qc,
                                         const unsigned char* Kt) {
  using namespace ptt::hopper;
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

// O += P V for a 64-row tile read MN-major (V; K for dQ, dO for dV, Q for
// dK), P as wgmma's A fragments (P; dS, P^T, dS^T): one wgmma group
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[4][4],
                                         const unsigned char* Vt) {
  using namespace ptt::hopper;
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
  using ptt::hopper::pack_bf16;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// the forward's shared memory (q: 1024-byte aligned, BYTES long) and its
// barriers, which the caller keeps in static shared memory
struct Ring {
  unsigned char* q;
  uint64_t *qfull, *qempty, *kfull, *vfull, *empty;   // empty..: ST each
  __device__ unsigned char* k(int s) const { return q + QTILE + s * 2 * KTILE; }
  __device__ unsigned char* v(int s) const { return k(s) + KTILE; }
};

// one thread, before a barrier of the whole block
__device__ __forceinline__ void ring_init(const Ring& r) {
  using namespace ptt::hopper;
  mbar_init(r.qfull, 1);
  mbar_init(r.qempty, 8);   // one arrival per consumer warp
  for (int s = 0; s < ST; ++s) {
    mbar_init(&r.kfull[s], 1);
    mbar_init(&r.vfull[s], 1);
    mbar_init(&r.empty[s], 8);
  }
  mbar_fence_init();
}

// one work item: q tile q0.. of query head h (kv head kh) of batch row b,
// nk key blocks
struct Item {
  int q0, h, kh, b, nk;
};

// item t of a grid's causal walk (nq q tiles of B x H heads), the
// heaviest q tiles (the last) first, so the light ones fill the tail
__device__ __forceinline__ Item causal_item(int t, int nq, int B, int H,
                                            int HK, int S) {
  const int bh = B * H;
  Item w;
  w.q0 = (nq - 1 - t / bh) * BQ;
  w.h = t % H;
  w.b = (t % bh) / H;
  w.kh = w.h / (H / HK);
  // key blocks wholly above the diagonal are never loaded (s is a
  // multiple of 64, so no key block is ragged)
  w.nk = min((w.q0 + BQ) / BK, S / BK);
  return w;
}

// The producer thread: Q of the item (WALK: once the consumers have
// released the previous item's, n items before this one on this block),
// then K and V of each key block into the ring, kv counting key blocks
// over items.
template <bool WALK>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* q,
                                        const CUtensorMap* k,
                                        const CUtensorMap* v, const Item& w,
                                        int n, int& kv) {
  using namespace ptt::hopper;
  if (WALK && n > 0) mbar_wait(r.qempty, (n - 1) & 1);
  mbar_expect_tx(r.qfull, QTILE);
  tma_load_4d(r.q, q, r.qfull, 0, w.h, w.q0, w.b);
  tma_load_4d(r.q + QCHUNK, q, r.qfull, 64, w.h, w.q0, w.b);
  for (int j = 0; j < w.nk; ++j, ++kv) {
    const int s = kv % ST;
    if (kv >= ST) mbar_wait(&r.empty[s], (kv / ST - 1) & 1);
    mbar_expect_tx(&r.kfull[s], KTILE);
    tma_load_4d(r.k(s), k, &r.kfull[s], 0, w.kh, j * BK, w.b);
    tma_load_4d(r.k(s) + KCHUNK, k, &r.kfull[s], 64, w.kh, j * BK, w.b);
    mbar_expect_tx(&r.vfull[s], KTILE);
    tma_load_4d(r.v(s), v, &r.vfull[s], 0, w.kh, j * BK, w.b);
    tma_load_4d(r.v(s) + KCHUNK, v, &r.vfull[s], 64, w.kh, j * BK, w.b);
  }
}

// Consumer warpgroup c (0, 1: rows 64 c .. of the tile) of one item, the
// n-th of this block, kv the running key-block count: out [B, S, H, HD]
// bf16 rows below S, lse [B, H, S] (natural log) unless null.
template <bool WALK>
__device__ __forceinline__ void consume(const Ring& r, const Item& w, int n,
                                        int& kv, int c, int S, int H,
                                        float scale2, bool causal, bf16* out,
                                        float* lse) {
  using namespace ptt::hopper;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 64 * c + 16 * (t / 32) + lane / 4;   // rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                 // first column of a pair
  const unsigned char* Qc = r.q + c * 64 * 128;  // this warpgroup's rows
  const int q0 = w.q0, nk = w.nk;
  float o[64], sc[32], corr[2];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // a key block past this warpgroup's first row: the diagonal's
  auto edge = [&](int j) { return causal && j * BK + BK - 1 > q0 + 64 * c; };
  mbar_wait(r.qfull, n & 1);

  // key block 0: S, then its softmax
  mbar_wait(&r.kfull[kv % ST], (kv / ST) & 1);
  issue_qk(sc, Qc, r.k(kv % ST));
  wgmma_wait<0>();
  fence_regs(sc);
  if (WALK && nk == 1 && lane == 0) mbar_arrive(r.qempty);   // Q's last read
  softmax(sc, m, l, corr, edge(0), 0, q0 + r0, cq, scale2);
  to_frags(sc, pa);
  // key block j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight
  // together; the softmax of S_j runs under the P V product
  for (int j = 1; j < nk; ++j) {
    const int s = (kv + j) % ST, sp = (kv + j - 1) % ST;
    mbar_wait(&r.kfull[s], ((kv + j) / ST) & 1);
    issue_qk(sc, Qc, r.k(s));
    mbar_wait(&r.vfull[sp], ((kv + j - 1) / ST) & 1);
    issue_pv(o, pa, r.v(sp));
    wgmma_wait<1>();   // S_j
    fence_regs(sc);
    if (WALK && j == nk - 1 && lane == 0) mbar_arrive(r.qempty);
    softmax(sc, m, l, corr, edge(j), j * BK, q0 + r0, cq, scale2);
    wgmma_wait<0>();   // P_{j-1} V_{j-1}: its slot and pa are free
    fence_regs(o);
    if (lane == 0) mbar_arrive(&r.empty[sp]);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
    to_frags(sc, pa);
  }
  const int sl = (kv + nk - 1) % ST;
  mbar_wait(&r.vfull[sl], ((kv + nk - 1) / ST) & 1);
  issue_pv(o, pa, r.v(sl));
  wgmma_wait<0>();
  fence_regs(o);
  if (WALK && lane == 0) mbar_arrive(&r.empty[sl]);
  kv += nk;

  // out = O / l in bf16; lse in natural log
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    if (row >= S) continue;
    const float safe_l = l[rr] > 0.f ? l[rr] : 1.f;
    uint32_t* og = reinterpret_cast<uint32_t*>(
        out + (((size_t)w.b * S + row) * H + w.h) * HD);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      og[(8 * i + cq) / 2] = pack_bf16(o[4 * i + 2 * rr] / safe_l,
                                       o[4 * i + 2 * rr + 1] / safe_l);
    if (lane % 4 == 0 && lse != nullptr)
      lse[((size_t)w.b * H + w.h) * S + row] =
          (m[rr] + log2f(safe_l)) * 0.69314718055994531f;
  }
}

}  // namespace fwd
}  // namespace ptt
