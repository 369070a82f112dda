// 3xTF32 on Hopper's tensor cores: fp32 matrix products with fp32-grade
// error on wgmma's TF32 path, for the fp32 instantiations of
// fused_block.cu's RMSNorm+QKV, gated MLP and fused_ffn at T >= 17 rows
// (kRowPassMinT).
//
// Replaces, in fp32, the Pallas TPU kernels paddle_tpu/ops/pallas/
// fused_block.py `_qkv_kernel` (:249, both variants) and `_mlp_kernel`
// (:494: the gated MLP and fused_ffn's act + bias).  Their fp32 port ran
// gemm_tile.cuh's fp32 branch before: CUDA-core FMAs, 67 TFLOP/s at most,
// and 8 scalar shared-memory loads for 32 FMAs a k step.  (fp32 at T <= 16
// keeps that tile, and so does the fp32 whole-block decoder.)
//
// Why three TF32 products and not one.  A TF32 operand keeps 10 explicit
// mantissa bits (about three decimal digits), so one TF32 pass errs by up
// to 2^-11 of every term, thousands of times a plain fp32 product's error.
// Each operand is split instead, x = hi + lo + r with hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna, common.cuh's tf32_split; |r| <= 2^-22 |x|), and
//   a . b ~= a_lo . b_hi + a_hi . b_lo + a_hi . b_hi
// (a_lo . b_lo, about 2^-22 of each term, is dropped).  A product of two
// TF32 values is exact in fp32 (11 x 11 significant bits), so what is
// left is the fp32 accumulation's error and the split's, close to a plain
// fp32 product; no flag chooses a lesser precision.  The three products of
// a k8 step go into one set of fp32 accumulators in that order, the small
// terms first: a_lo . b_hi, then a_hi . b_lo, then a_hi . b_hi.
//
// The tensor cores' fp32 accumulation is not an IEEE add: each wgmma's
// sum keeps about fp32's precision relative to its largest term (the
// running sum, once K grows) and does not round to nearest, so the error
// of 3 K / 8 chained wgmma grows with K and with the sum (on an H100 at
// K = 4096 it came to 11x a plain fp32 product's error against float64;
// PERF.md).  So each 32-deep slice's twelve products start a fresh
// sum (the first wgmma's scale-d is 0) and the consumer adds it to its
// fp32 totals with an ordinary (round-to-nearest) add once the slice's
// group is done: the tensor cores only ever sum 32 terms.
//
// What bounds it on an H100 SXM: the products, at 495 / 3 = 165 TFLOP/s
// (QKV's training variant at T = 8192, d 4096, dq 4096, dkv 1024: 412
// GFLOP, 2.50 ms; the MLP at f 14336: 2.89 TFLOP, 17.5 ms).  The split
// pre-pass moves bytes at 3.35 TB/s: the MLP's three weights read once and
// written twice, 2.1 GB (0.63 ms); QKV's, 0.30 GB (0.09 ms).
//
// The layout rule that shapes the design: for .tf32 wgmma takes A and B
// K-major only (the transpose bit that lets the bf16 ring read weights in
// the [in, out] layout exists only for 16-bit types).  So a pre-pass
//   - splits the activations [T, K] into hi and lo, K-major as they are
//     (tf32_split_kernel; QKV's row pass writes xn's hi and lo itself, and
//     the gate/up epilogue writes h's);
//   - splits each weight [K, N] into W^T's hi and lo, [N, K]
//     (tf32_split_t_kernel: 32 x 32 tiles transposed through shared
//     memory, 16-byte loads and stores, no bank conflicts),
// into a buffer the wrapper allocates for the call, as the bf16 ring's h.
// Weights change every optimizer step, so they are split on every call.
//
// The GEMM (tf32_produce / tf32_consume: hopper_gemm.cuh's ring and roles
// with four boxes a slot).  A slot holds A_hi and A_lo [BM][32] and B^T_hi
// and B^T_lo [BN][32]: boxes 32 fp32 (one 128-byte swizzle row) deep,
// 1024-byte aligned.  TMA fills slot s
// on full[s] (one expect-tx arrival, then the bytes; rows past the matrix
// zero-filled and counted), the consumer warps free it on empty[s].
// 128-row tiles (two consumer warpgroups) of 128 columns take 64 KB a slot
// and three slots; 64-row tiles (one consumer) take 48 KB and four.
// Gate/up needs no second B operand: its pre-pass interleaves the two
// weights' W^T rows in groups of 64 (rows 128 j .. 128 j + 63 the gate's
// columns 64 j .., the next 64 rows the up's), so one 128-column tile's
// accumulators hold g in columns 0..63 and u in 64..127 of the same 64
// outputs, in the same thread (fragment columns 8 i + .. and 8 (i + 8)
// + ..), and the epilogue pairs them.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace ptt {
namespace tf32x3 {

using namespace ptt::hopper;

// -- the split pre-pass ------------------------------------------------------

constexpr int kSplitThreads = 256;

// hi and lo of n4 16-byte vectors of fp32 values, a grid-stride walk
__global__ void __launch_bounds__(kSplitThreads)
tf32_split_kernel(const float* x, float* hi, float* lo, long long n4) {
  const long long stride = (long long)gridDim.x * kSplitThreads;
  for (long long i = (long long)blockIdx.x * kSplitThreads + threadIdx.x;
       i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    float4 h, l;
    tf32_split(v.x, h.x, l.x);
    tf32_split(v.y, h.y, l.y);
    tf32_split(v.z, h.z, l.z);
    tf32_split(v.w, h.w, l.w);
    reinterpret_cast<float4*>(hi)[i] = h;
    reinterpret_cast<float4*>(lo)[i] = l;
  }
}

// Up to three weights, each [K, N] row-major (N contiguous), as W^T hi and
// lo, K contiguous: column n of part i lands in row (n / group[i]) *
// stride[i] + n % group[i] of its destination (group = N, stride 0: W^T
// [N, K] as it is; gate/up: groups of 64 columns every 128 rows, the
// gate's at rows 0.., the up's at 64..); K, N and group multiples of 32.
// The grid's blocks are the parts' 32 x 32 tiles, part after part
// (first[i]: part i's first block).
struct SplitT {
  const float* src[3];
  float* hi[3];
  float* lo[3];
  int K[3], N[3], group[3], stride[3];
  long long first[4];
  int parts;
};

__global__ void __launch_bounds__(kSplitThreads)
tf32_split_t_kernel(const __grid_constant__ SplitT p) {
  // row k of the tile at s[k], padded to 33: both the row-wise writes and
  // the column-wise reads below fall on 32 distinct banks a warp
  __shared__ float s[32][33];
  const long long b = blockIdx.x;
  int part = 0;
  while (part + 1 < p.parts && b >= p.first[part + 1]) ++part;
  const long long t = b - p.first[part];
  const int K = p.K[part], N = p.N[part];
  const int k0 = (int)(t / (N / 32)) * 32, n0 = (int)(t % (N / 32)) * 32;
  const int tid = threadIdx.x, r = tid / 8, q = tid % 8;
  const float4 v = *reinterpret_cast<const float4*>(
      p.src[part] + (size_t)(k0 + r) * N + n0 + 4 * q);
  s[r][4 * q] = v.x;
  s[r][4 * q + 1] = v.y;
  s[r][4 * q + 2] = v.z;
  s[r][4 * q + 3] = v.w;
  __syncthreads();
  // thread (n = r, k = 4 q ..): row n of W^T, four k values
  float4 h, l;
  tf32_split(s[4 * q][r], h.x, l.x);
  tf32_split(s[4 * q + 1][r], h.y, l.y);
  tf32_split(s[4 * q + 2][r], h.z, l.z);
  tf32_split(s[4 * q + 3][r], h.w, l.w);
  const int n = n0 + r;
  const size_t o =
      ((size_t)(n / p.group[part]) * p.stride[part] + n % p.group[part]) * K +
      k0 + 4 * q;
  *reinterpret_cast<float4*>(p.hi[part] + o) = h;
  *reinterpret_cast<float4*>(p.lo[part] + o) = l;
}

// the parts' tiles into first[], then one launch
inline int split_t(SplitT& st, cudaStream_t stream) {
  long long total = 0;
  for (int i = 0; i < st.parts; ++i) {
    if (st.group[i] == 0) st.group[i] = st.N[i];   // W^T as it is
    if (st.K[i] % 32 != 0 || st.N[i] % 32 != 0 || st.group[i] % 32 != 0)
      return (int)cudaErrorInvalidValue;
    st.first[i] = total;
    total += (long long)(st.K[i] / 32) * (st.N[i] / 32);
  }
  st.first[st.parts] = total;
  if (total == 0 || total > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  tf32_split_t_kernel<<<(unsigned)total, kSplitThreads, 0, stream>>>(st);
  return (int)cudaGetLastError();
}

// hi and lo of n fp32 values (n a multiple of 4)
inline int split(const float* x, float* hi, float* lo, long long n,
                 cudaStream_t stream) {
  if (n % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const long long need = (n4 + kSplitThreads - 1) / kSplitThreads;
  const int grid = (int)(need < 16LL * sm_count() ? need : 16LL * sm_count());
  if (grid > 0)
    tf32_split_kernel<<<grid, kSplitThreads, 0, stream>>>(x, hi, lo, n4);
  return (int)cudaGetLastError();
}

// -- the GEMM ring -----------------------------------------------------------

template <int NC>
struct Tf32Plan {
  static constexpr int BM = 64 * NC, BN = 128, BK = 32;   // BK: 128 bytes
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr uint32_t A_BYTES = BM * BK * 4;   // A_hi, or A_lo
  static constexpr uint32_t B_BYTES = BN * BK * 4;   // B^T_hi, or B^T_lo
  static constexpr uint32_t STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  // as many slots as 192 KB holds: three of 64 KB, four of 48 KB
  static constexpr int STAGES = (192 * 1024) / STAGE_BYTES;
  // dynamic shared memory: 1 KB of alignment slack, the ring, the barriers
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                                 2 * STAGES * sizeof(uint64_t);
  static_assert(STAGES >= 2 && SMEM <= 232448,
                "two slots or more, within a block's shared memory");
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
                "every box starts on a 1024-byte boundary");
};

// The operands' tensor maps: A [T, K] split, B^T [rows, K] split (boxes
// {32, BM} and {32, BN})
struct Tf32Maps {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
};

template <int NC>
struct Tf32Ring {
  using P = Tf32Plan<NC>;
  unsigned char* base;   // 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
  // A's (b = 0) or B^T's (b = 1) hi (lo = 0) or lo (lo = 1) box of slot s
  __device__ unsigned char* box(int s, int b, int lo) const {
    return base + s * P::STAGE_BYTES + b * 2 * P::A_BYTES +
           lo * (b ? P::B_BYTES : P::A_BYTES);
  }
};

// The ring in dynamic shared memory, its barriers initialised; every
// thread of the block calls it (it ends in __syncthreads).
template <int NC>
__device__ __forceinline__ Tf32Ring<NC> tf32_ring(unsigned char* smem) {
  using P = Tf32Plan<NC>;
  Tf32Ring<NC> r;
  r.base = align1024(smem);
  r.full = reinterpret_cast<uint64_t*>(r.base + P::STAGES * P::STAGE_BYTES);
  r.empty = r.full + P::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// The producer (one thread): the 32-deep K slices of A's rows m0.. and of
// B^T's rows n0.. into the ring; `it` is the running slice count, carried
// from tile to tile.
template <int NC>
__device__ __forceinline__ void tf32_produce(const Tf32Ring<NC>& r,
                                             const Tf32Maps& m, int m0,
                                             int n0, int K, int& it) {
  using P = Tf32Plan<NC>;
  const int KT = K / P::BK;
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % P::STAGES;
    if (it >= P::STAGES) mbar_wait(&r.empty[s], ((it / P::STAGES) - 1) & 1);
    mbar_expect_tx(&r.full[s], P::STAGE_BYTES);
    const int k = kt * P::BK;
    tma_load_2d(r.box(s, 0, 0), &m.a_hi, &r.full[s], k, m0);
    tma_load_2d(r.box(s, 0, 1), &m.a_lo, &r.full[s], k, m0);
    tma_load_2d(r.box(s, 1, 0), &m.b_hi, &r.full[s], k, n0);
    tma_load_2d(r.box(s, 1, 1), &m.b_lo, &r.full[s], k, n0);
  }
}

// acc = 0: D = A . B, the old D not read
template <int BN>
__device__ __forceinline__ void tf32_mma(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int acc = 1) {
  wgmma_tf32<BN>(d, da, db, acc);
}

// The four k8 steps of one slot, three products each, in the order of the
// top: part = A_lo . B_hi (the slot's first product starts the sum), then
// += A_hi . B_lo, += A_hi . B_hi, ...
template <int BN>
__device__ __forceinline__ void tf32_slot(float (&part)[BN / 2],
                                          const unsigned char* ah,
                                          const unsigned char* al,
                                          const unsigned char* bh,
                                          const unsigned char* bl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dah = desc_kmajor(ah + 32 * kk);
    const uint64_t dal = desc_kmajor(al + 32 * kk);
    const uint64_t dbh = desc_kmajor(bh + 32 * kk);
    const uint64_t dbl = desc_kmajor(bl + 32 * kk);
    tf32_mma<BN>(part, dal, dbh, kk > 0);
    tf32_mma<BN>(part, dah, dbl);
    tf32_mma<BN>(part, dah, dbh);
  }
}

// Consumer warpgroup c (0..NC-1): acc = A[m0 + 64 c .., :] . B in wgmma's
// accumulator layout.  Each slice's products are summed by wgmma into
// `part` from zero, and once the group is done (the slot then freed)
// added to acc in fp32 (the top says why); the other consumer
// warpgroup's products run meanwhile.  All 128 threads of the warpgroup
// call it.
template <int NC>
__device__ __forceinline__ void tf32_consume(const Tf32Ring<NC>& r, int K,
                                             int c, float (&acc)[64],
                                             int& it) {
  using P = Tf32Plan<NC>;
  constexpr int BN = P::BN;
  const int KT = K / P::BK;
  const bool signals = threadIdx.x % 32 == 0;
  float part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % P::STAGES;
    mbar_wait(&r.full[s], (it / P::STAGES) & 1);
    fence_regs(part);
    wgmma_fence();
    tf32_slot<BN>(part, r.box(s, 0, 0) + c * 64 * 128,
                  r.box(s, 0, 1) + c * 64 * 128, r.box(s, 1, 0),
                  r.box(s, 1, 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    if (signals) mbar_arrive(&r.empty[s]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }
}

}  // namespace tf32x3
}  // namespace ptt
