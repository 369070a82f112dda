// C = A . B on wgmma, fed by TMA through an mbarrier ring: the GEMM of the
// port's Hopper kernels, as device functions that a kernel calls for one
// output tile (csrc/hopper.cuh has the PTX pieces and the tile layouts).
// fused_block.cu runs it for bf16 at T > 16: the RMSNorm+QKV projection,
// the MLP's gate/up (two B operands a slot), fused_ffn's up and the down
// product of both; grouped_matmul.cu for the grouped expert FFN's two
// products in bf16 (3-d maps, a group and an expert a tile); fused_decoder.cu
// for the four GEMM phases of the bf16 decoder block (one ring for all).
// The wmma tile of gemm_tile.cuh is left to decode rows (T <= 16) and fp32.
//
//   A [M, K] bf16, K contiguous (x, xn, h): a 2-d tensor map {K, M} with
//     boxes {64, BM}; K-major operand.  Grouped: [G, C, K], a 3-d map
//     {K, C, G} with boxes {64, BM, 1} (rows past C zero-filled, so a tile
//     never reads the next group).
//   B [K, N] bf16, N contiguous (a weight in the [in, out] layout): a 2-d
//     tensor map {N, K} with boxes {64, 64}; MN-major operand (wgmma's
//     transpose bit), so no weight is transposed.  Grouped: [E, K, N], a
//     3-d map {N, K, E} with boxes {64, 64, 1}.
// A block is NC + 1 warpgroups.  Warpgroup 0 is the producer: one thread
// issues every TMA load.  Warpgroups 1..NC are the consumers; consumer c
// owns rows 64 c .. 64 c + 63 of the BM = 64 NC-row tile and all BN
// columns, as fp32 accumulators in registers (BN / 2 a thread, per B
// operand).  K walks in 64-deep slices through a ring of STAGES slots:
// slot s holds A's [BM][64] box and, for each of the NB B operands (NB =
// 2: the gate and up weights, one column tile of each), BN / 64 boxes of
// [64][64]; it fills on full[s] (one expect-tx arrival, then the TMA
// bytes) and frees on empty[s] (one arrival per consumer warp once its
// wgmma group has read the slot).  A consumer keeps one wgmma group in
// flight: the products of slice k run while it waits on slice k + 1.
// Rows and columns past the matrix are zero-filled by TMA; the caller's
// epilogue masks its stores.  A persistent kernel calls produce and
// consume once per output tile with one running slice count `it` on
// each side, so the ring's slots and phases carry from tile to tile and
// the producer loads the next tile while the consumers store this one.
#pragma once

#include "hopper.cuh"

namespace ptt {
namespace hopper {

template <int NC, int BN, int STAGES, int NB = 1>
struct GemmPlan {
  static_assert(BN == 128 || BN == 256, "wgmma n128 / n256 tiles");
  static_assert(NB == 1 || NB == 2, "one B operand, or gate and up");
  static constexpr int BM = 64 * NC, BK = 64;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr uint32_t A_BYTES = BM * BK * 2;
  static constexpr uint32_t B_BYTES = BK * BN * 2;   // one B operand
  static constexpr uint32_t STAGE_BYTES = A_BYTES + NB * B_BYTES;
  // dynamic shared memory: 1 KB of alignment slack, the ring, the barriers
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                                 2 * STAGES * sizeof(uint64_t);
};

template <int NC, int BN, int STAGES, int NB = 1>
struct GemmRing {
  using P = GemmPlan<NC, BN, STAGES, NB>;
  unsigned char* base;   // 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
  __device__ unsigned char* a(int s) const { return base + s * P::STAGE_BYTES; }
  // B operand j (0, or 1 for the second weight) of slot s
  __device__ unsigned char* b(int s, int j = 0) const {
    return a(s) + P::A_BYTES + j * P::B_BYTES;
  }
};

// The same ring memory and barriers read under another plan whose slots
// have the same size (the decoder block's 128 x 256 single-weight tiles and
// 128 x 128 gate/up tiles share one ring and its running slice count).
template <int BN2, int NB2, int NC, int BN, int STAGES, int NB>
__device__ __forceinline__ GemmRing<NC, BN2, STAGES, NB2> ring_as(
    const GemmRing<NC, BN, STAGES, NB>& r) {
  static_assert(GemmPlan<NC, BN2, STAGES, NB2>::STAGE_BYTES ==
                    GemmPlan<NC, BN, STAGES, NB>::STAGE_BYTES,
                "the two plans' slots must coincide");
  return GemmRing<NC, BN2, STAGES, NB2>{r.base, r.full, r.empty};
}

// Output tile t of a row_tiles x col_tiles grid in a persistent walk:
// column-major inside bands of `band` row tiles, so the tiles in flight on
// the card share their A rows and weight columns in L2.
__device__ __forceinline__ void band_tile(int t, int row_tiles, int col_tiles,
                                          int band, int& rt, int& ct) {
  const int per = band * col_tiles;
  const int first = t / per * band;
  const int rows_in = min(band, row_tiles - first);
  const int in = t % per;
  rt = first + in % rows_in;
  ct = in / rows_in;
}

// The ring in dynamic shared memory, its barriers initialised; every
// thread of the block calls it (it ends in __syncthreads).
template <int NC, int BN, int STAGES, int NB = 1>
__device__ __forceinline__ GemmRing<NC, BN, STAGES, NB> gemm_ring(
    unsigned char* smem) {
  using P = GemmPlan<NC, BN, STAGES, NB>;
  GemmRing<NC, BN, STAGES, NB> r;
  r.base = align1024(smem);
  r.full = reinterpret_cast<uint64_t*>(r.base + STAGES * P::STAGE_BYTES);
  r.empty = r.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// The producer (one thread): the K slices of A's rows m0.. and B's
// columns n0.. into the ring (b1: the second B operand where NB = 2).
// RANK 3: the grouped 3-d maps, A's group ga and B's expert gb (one B
// operand only).
template <int NC, int BN, int STAGES, int NB, int RANK = 2>
__device__ __forceinline__ void gemm_produce(
    const GemmRing<NC, BN, STAGES, NB>& r, const CUtensorMap* a,
    const CUtensorMap* b, int m0, int n0, int K, const CUtensorMap* b1,
    int& it, int ga = 0, int gb = 0) {
  static_assert(RANK == 2 || RANK == 3, "2-d or grouped 3-d maps");
  static_assert(RANK == 2 || NB == 1,
                "the second B operand is loaded through a 2-d map");
  using P = GemmPlan<NC, BN, STAGES, NB>;
  const int KT = K / P::BK;
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % STAGES;
    if (it >= STAGES) mbar_wait(&r.empty[s], ((it / STAGES) - 1) & 1);
    mbar_expect_tx(&r.full[s], P::STAGE_BYTES);
    if constexpr (RANK == 2)
      tma_load_2d(r.a(s), a, &r.full[s], kt * P::BK, m0);
    else
      tma_load_3d(r.a(s), a, &r.full[s], kt * P::BK, m0, ga);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      if constexpr (RANK == 2)
        tma_load_2d(r.b(s) + j * 8192, b, &r.full[s], n0 + 64 * j,
                    kt * P::BK);
      else
        tma_load_3d(r.b(s) + j * 8192, b, &r.full[s], n0 + 64 * j,
                    kt * P::BK, gb);
      if constexpr (NB == 2)
        tma_load_2d(r.b(s, 1) + j * 8192, b1, &r.full[s], n0 + 64 * j,
                    kt * P::BK);
    }
  }
}

// one output tile
template <int NC, int BN, int STAGES>
__device__ __forceinline__ void gemm_produce(
    const GemmRing<NC, BN, STAGES, 1>& r, const CUtensorMap* a,
    const CUtensorMap* b, int m0, int n0, int K) {
  int it = 0;
  gemm_produce<NC, BN, STAGES, 1>(r, a, b, m0, n0, K, nullptr, it);
}

// the k16 products of one slot: acc += A (64 rows from as) . B (bs)
template <int BN>
__device__ __forceinline__ void gemm_slot(float (&acc)[BN / 2],
                                          const unsigned char* as,
                                          const unsigned char* bs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = desc_kmajor(as + 32 * kk);
    const uint64_t db = desc_mnmajor(bs + 2048 * kk, 8192);
    if constexpr (BN == 256)
      wgmma_ss_n256<1>(acc, da, db);
    else
      wgmma_ss_n128<1>(acc, da, db);
  }
}

// Consumer warpgroup c (0..NC-1): acc = A[m0 + 64 c .., :] . B[:, n0 ..
// n0 + BN) and, where NB = 2, acc1 = the same rows . B1, in wgmma's
// accumulator layout (hopper.cuh).  All 128 threads of the warpgroup call
// it.
template <int NC, int BN, int STAGES, int NB>
__device__ __forceinline__ void gemm_consume(
    const GemmRing<NC, BN, STAGES, NB>& r, int K, int c, float (&acc)[BN / 2],
    float (&acc1)[NB == 2 ? BN / 2 : 1], int& it) {
  using P = GemmPlan<NC, BN, STAGES, NB>;
  const int KT = K / P::BK;
  const bool signals = threadIdx.x % 32 == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (NB == 2 ? BN / 2 : 1); ++i) acc1[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % STAGES;
    mbar_wait(&r.full[s], (it / STAGES) & 1);
    const unsigned char* as = r.a(s) + c * 64 * 128;
    fence_regs(acc);
    fence_regs(acc1);
    wgmma_fence();
    gemm_slot<BN>(acc, as, r.b(s));
    if constexpr (NB == 2) gemm_slot<BN>(acc1, as, r.b(s, 1));
    wgmma_commit();
    wgmma_wait<1>();   // the previous slice's group is done with its slot
    fence_regs(acc);
    fence_regs(acc1);
    if (kt > 0 && signals) mbar_arrive(&r.empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(acc1);
  if (signals) mbar_arrive(&r.empty[(it - 1) % STAGES]);   // the last slot
}

// one output tile, one B operand
template <int NC, int BN, int STAGES>
__device__ __forceinline__ void gemm_consume(
    const GemmRing<NC, BN, STAGES, 1>& r, int K, int c,
    float (&acc)[BN / 2]) {
  float none[1];
  int it = 0;
  gemm_consume<NC, BN, STAGES, 1>(r, K, c, acc, none, it);
}

}  // namespace hopper
}  // namespace ptt
