// C = A . B on wgmma, fed by TMA through an mbarrier ring: the GEMM of the
// port's Hopper kernels, as device functions that a kernel calls for one
// output tile (csrc/hopper.cuh has the PTX pieces and the tile layouts).
// fused_block.cu's RMSNorm+QKV projection runs it for bf16 at T > 16; the
// MLP, fused_ffn, the grouped FFN and the decoder block still run
// gemm_tile.cuh's wmma tile, and are to move onto this one.
//
//   A [M, K] bf16, K contiguous (x, xn): a 2-d tensor map {K, M} with
//     boxes {64, BM}; K-major operand.
//   B [K, N] bf16, N contiguous (a weight in the [in, out] layout): a 2-d
//     tensor map {N, K} with boxes {64, 64}; MN-major operand (wgmma's
//     transpose bit), so no weight is transposed.
// A block is NC + 1 warpgroups.  Warpgroup 0 is the producer: one thread
// issues every TMA load.  Warpgroups 1..NC are the consumers; consumer c
// owns rows 64 c .. 64 c + 63 of the BM = 64 NC-row tile and all BN
// columns, as fp32 accumulators in registers (BN / 2 a thread).  K walks
// in 64-deep slices through a ring of STAGES slots: slot s holds A's
// [BM][64] box and B's BN / 64 boxes of [64][64]; it fills on full[s]
// (one expect-tx arrival, then the TMA bytes) and frees on empty[s] (one
// arrival per consumer warp once its wgmma group has read the slot).  A
// consumer keeps one wgmma group in flight: the four k16 products of
// slice k run while it waits on slice k + 1.  Rows and columns past the
// matrix are zero-filled by TMA; the caller's epilogue masks its stores.
#pragma once

#include "hopper.cuh"

namespace ptt {
namespace hopper {

template <int NC, int BN, int STAGES>
struct GemmPlan {
  static_assert(BN == 128 || BN == 256, "wgmma n128 / n256 tiles");
  static constexpr int BM = 64 * NC, BK = 64;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr uint32_t A_BYTES = BM * BK * 2;
  static constexpr uint32_t B_BYTES = BK * BN * 2;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  // dynamic shared memory: 1 KB of alignment slack, the ring, the barriers
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                                 2 * STAGES * sizeof(uint64_t);
};

template <int NC, int BN, int STAGES>
struct GemmRing {
  using P = GemmPlan<NC, BN, STAGES>;
  unsigned char* base;   // 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
  __device__ unsigned char* a(int s) const { return base + s * P::STAGE_BYTES; }
  __device__ unsigned char* b(int s) const { return a(s) + P::A_BYTES; }
};

// The ring in dynamic shared memory, its barriers initialised; every
// thread of the block calls it (it ends in __syncthreads).
template <int NC, int BN, int STAGES>
__device__ __forceinline__ GemmRing<NC, BN, STAGES> gemm_ring(
    unsigned char* smem) {
  using P = GemmPlan<NC, BN, STAGES>;
  GemmRing<NC, BN, STAGES> r;
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
// columns n0.. into the ring.
template <int NC, int BN, int STAGES>
__device__ __forceinline__ void gemm_produce(
    const GemmRing<NC, BN, STAGES>& r, const CUtensorMap* a,
    const CUtensorMap* b, int m0, int n0, int K) {
  using P = GemmPlan<NC, BN, STAGES>;
  const int KT = K / P::BK;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    if (kt >= STAGES) mbar_wait(&r.empty[s], ((kt / STAGES) - 1) & 1);
    mbar_expect_tx(&r.full[s], P::STAGE_BYTES);
    tma_load_2d(r.a(s), a, &r.full[s], kt * P::BK, m0);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_2d(r.b(s) + j * 8192, b, &r.full[s], n0 + 64 * j, kt * P::BK);
  }
}

// Consumer warpgroup c (0..NC-1): acc = A[m0 + 64 c .., :] . B[:, n0 ..
// n0 + BN), in wgmma's accumulator layout (hopper.cuh).  All 128 threads
// of the warpgroup call it.
template <int NC, int BN, int STAGES>
__device__ __forceinline__ void gemm_consume(
    const GemmRing<NC, BN, STAGES>& r, int K, int c, float (&acc)[BN / 2]) {
  using P = GemmPlan<NC, BN, STAGES>;
  const int KT = K / P::BK;
  const bool signals = threadIdx.x % 32 == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&r.full[s], (kt / STAGES) & 1);
    const unsigned char* as = r.a(s) + c * 64 * 128;
    const unsigned char* bs = r.b(s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_kmajor(as + 32 * kk);
      const uint64_t db = desc_mnmajor(bs + 2048 * kk, 8192);
      if constexpr (BN == 256)
        wgmma_ss_n256<1>(acc, da, db);
      else
        wgmma_ss_n128<1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();   // slice kt - 1's group is done with its slot
    fence_regs(acc);
    if (kt > 0 && signals) mbar_arrive(&r.empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

}  // namespace hopper
}  // namespace ptt
