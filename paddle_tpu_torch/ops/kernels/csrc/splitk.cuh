// Split-K at decode rows (T <= 16), shared by quant_matmul.cu
// (quant_splitk_kernel: 8-bit weights) and fused_block.cu
// (qkv_splitk_kernel: bf16 weights, after the RMSNorm row pass;
// mlp_splitk_kernel: the MLP's and fused_ffn's two products, on the strip
// stream at the end of this file).
//
// Every weight byte is read once for 2 T operations, so these launches are
// bound by the weight bytes, and a serial walk over K in a few column
// blocks leaves most of the card idle.  A block owns kSkBN output columns
// and one of `splits` contiguous ranges of K (split j takes the 64-deep
// slices j * n / splits .. (j + 1) * n / splits - 1 of the n = K / 64);
// its kSkWarps warps take one 16-deep step of every slice each and run
// mma.sync m16n8k16 with the weight as A (the block's 128 columns as 8
// m-tiles) and the <= 16 tokens as B (one or two n8 tiles).  The kernels'
// comments give the fragment map.  What is here:
//   - the split rule: splits = ceil(factor * SMs / column tiles) (factor
//     kSplitFactor blocks a SM unless the caller asks for more),
//     capped so that a split keeps kMinSlices 64-deep slices and raised so
//     that none is deeper than kMaxSplitDepth (its x rows sit in shared
//     memory), never more than the slices;
//   - mma.sync m16n8k16 bf16 with fp32 accumulators;
//   - the block's end (splitk_finish): the warps' sums added in warp
//     order; with one split they are the output, else the block writes an
//     fp32 partial [split, T, columns] to a workspace the wrapper
//     allocates, and the last block of the column tile to arrive (an
//     atomic ticket, splitk_arrive, reset by that block) sums the splits
//     in order 0..splits-1.  Two calls on the same inputs give the same
//     bits;
//   - the strip stream (the end of this file), the MLP's: a warp a
//     64-column strip, 128-byte-swizzled boxes and fragments that read
//     shared memory without a bank conflict.
#pragma once

#include "common.cuh"

namespace ptt {
namespace splitk {

// the largest T that takes split-K and the split rule's constants
// (ops/kernels/splitk.py mirrors them and splitk_splits)
constexpr int kSplitKMaxT = 16;
constexpr int kSkBN = 128;            // output columns a block
constexpr int kSkWarps = 4;           // warps a block: one k16 step each
constexpr int kSplitFactor = 2;       // blocks per SM the splits aim at
constexpr int kMinSlices = 4;         // 64-deep slices a split keeps
constexpr int kMaxSplitDepth = 2048;  // the deepest split (x in shared)

inline int splitk_splits(int K, int N, int sms, int factor = kSplitFactor) {
  const int tiles = (N + kSkBN - 1) / kSkBN;
  const int slices = K / 64;
  int s = (factor * sms + tiles - 1) / tiles;
  s = min(s, max(1, slices / kMinSlices));
  s = max(s, (K + kMaxSplitDepth - 1) / kMaxSplitDepth);
  return min(s, slices);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// After every thread of the block has written its partial of a column
// tile to the workspace: whether this block is the last of the tile's
// `splits` to arrive, and so sums them (true at once with one split).
// The barrier, then one thread's fence, publishes every thread's partial
// before the ticket (fences are cumulative); the last block resets the
// ticket, which every other block has taken, and fences before it reads
// their partials.
__device__ __forceinline__ bool splitk_arrive(int* ticket, int splits) {
  __shared__ int last;
  __syncthreads();
  if (splits == 1) return true;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == splits - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// The end of a split-K block of kSkWarps * 32 threads, after a barrier
// that frees `smem` (kSkWarps * 8 * NT8 * kSkBN floats).  d: this lane's
// accumulators, d[j][nt][2 h + e] = column 16 g + 2 j + h of the block,
// token 8 nt + 2 q + e (lane = 4 g + q).  Thread `tid` owns the block's
// column tid: `live` says whether it exists, `wcol` is its column in the
// workspace ws [splits][T][ldw].  store(t, v) writes token t's finished
// fp32 sum of that column; only live threads call it.  `ticket`: the
// column tile's, zero before the launch and again after it.
template <int NT8, typename Store>
__device__ __forceinline__ void splitk_finish(const float (&d)[8][NT8][4],
                                              unsigned char* smem, int T,
                                              int split, int splits,
                                              float* ws, int ldw, int wcol,
                                              bool live, int* ticket,
                                              Store store) {
  constexpr int NTOK = 8 * NT8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  // the warps' sums, [warp][token][column], added in warp order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * NTOK + 8 * nt + 2 * q + e % 2) * kSkBN + 16 * g + 2 * m +
            e / 2] = d[m][nt][e];
  __syncthreads();
  auto warp_total = [&](int t) {
    float v = red[t * kSkBN + tid];
#pragma unroll
    for (int w = 1; w < kSkWarps; ++w) v += red[(w * NTOK + t) * kSkBN + tid];
    return v;
  };
  if (splits == 1) {
    if (live)
      for (int t = 0; t < T; ++t) store(t, warp_total(t));
    return;
  }
  float* part = ws + (size_t)split * T * ldw + wcol;
  if (live)
    for (int t = 0; t < T; ++t) part[(size_t)t * ldw] = warp_total(t);
  if (!splitk_arrive(ticket, splits)) return;
  if (live) {
    // every token's sum at once, four splits' loads issued before their
    // adds: the loads of a round are independent, the adds in split order
    float v[NTOK];
#pragma unroll
    for (int t = 0; t < NTOK; ++t) v[t] = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 4) {
      float buf[4][NTOK];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* src = ws + (size_t)(s0 + i) * T * ldw + wcol;
#pragma unroll
        for (int t = 0; t < NTOK; ++t)
          buf[i][t] = s0 + i < splits && t < T
                          ? __ldcg(src + (size_t)t * ldw) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < NTOK; ++t)
          if (s0 + i < splits) v[t] += buf[i][t];
    }
#pragma unroll
    for (int t = 0; t < NTOK; ++t)
      if (t < T) store(t, v[t]);
  }
}

// -- the strip stream (fused_block.cu mlp_splitk_kernel) ---------------------
//
// A warp owns one 64-column strip of a bf16 weight W [K, N] (N contiguous)
// over its split's K range and streams it in [64 k][64 n] boxes, each with
// the tokens' [ntok][64 k] box of the same slice, both written by TMA with
// the 128-byte swizzle (hopper.cuh): row r of a box at r * 128 bytes, its
// 16-byte unit v at unit v ^ (r % 8).  One box is four k16 steps of
// mma.sync m16n8k16 with the weight as A: the strip's 64 columns are 4
// m-tiles, the <= 16 tokens one or two n8 tiles.  The fragments are
// relabelled (the sums are the same under any one-to-one relabelling of
// the m rows and of the reduction indices, one for A and B alike) so that
// shared memory serves every read without a bank conflict:
//   - reduction indices 2 q, 2 q + 1, 2 q + 8 and 2 q + 9 (lane = 4 g +
//     q) are rows q, q + 4, q + 8 and q + 12 of the k16 step;
//   - lane g owns the 16-byte unit sv(g) = g / 2 + 4 (g % 2) of every row,
//     columns 8 sv .. 8 sv + 7: m-tile m's rows g and g + 8 are its
//     columns 8 sv + 2 m and 8 sv + 2 m + 1, the low and high halves of
//     word m of the lane's vector;
//   - so a lane's A fragments of a k16 step are its units of four rows,
//     four 16-byte loads, paired across rows by byte permutes.  The eight
//     lanes of a quarter warp (g = 2 p, 2 p + 1 and q = 0..3) read units
//     sv ^ (q + 4 (i % 2)): four values for each g, and the two g in the
//     two halves of the row, so eight distinct units (the [16][128] boxes
//     of the quant and QKV rings, unswizzled, put the four q of a g on one
//     unit: a 4-way conflict);
//   - a lane's B fragment is elements q, q + 4 and q + 8, q + 12 of the
//     step in token row 8 nt + g: four 2-byte reads, whose swizzled units
//     (k / 8) ^ g differ across the eight g, two q sharing each word.
// The accumulators d[m][nt][2 h + e] are column 8 sv + 2 m + h of the
// strip, token 8 nt + 2 q + e.

// the unit of every row that lane (g, q) reads: sv(g) above
__device__ __forceinline__ int strip_unit(int lane) {
  const int g = lane / 4;
  return g / 2 + 4 * (g % 2);
}

// byte offsets in a box of this lane's rows q + 4 i (i = 0..3) of k16 step
// 0 (step kk adds kk * 2048: 16 rows, and a multiple of 8 leaves the
// swizzle as it is)
__device__ __forceinline__ void strip_offsets(int lane, int (&off)[4]) {
  const int q = lane % 4, sv = strip_unit(lane);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    off[i] = (q + 4 * i) * 128 + 16 * (sv ^ (q + 4 * (i % 2)));
}

// One [64][64] weight box of the strip and its [8 NT8][64] token box into
// d: four k16 steps.
template <int NT8>
__device__ __forceinline__ void strip_box(float (&d)[4][NT8][4],
                                          const unsigned char* box,
                                          const unsigned char* xbox,
                                          const int (&off)[4], int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t b[NT8][2];
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      // element k of token row 8 nt + g (row % 8 = g)
      const unsigned char* row = xbox + (8 * nt + g) * 128;
      auto at = [&](int i) -> uint32_t {
        const int k = 16 * kk + q + 4 * i;
        return *reinterpret_cast<const unsigned short*>(
            row + 16 * ((k / 8) ^ g) + 2 * (k % 8));
      };
      b[nt][0] = at(0) | at(1) << 16;
      b[nt][1] = at(2) | at(3) << 16;
    }
    uint4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint4*>(box + kk * 2048 + off[i]);
    // word m of row i (m a constant once unrolled)
    auto word = [&](int i, int m) -> uint32_t {
      const uint4& v = r[i];
      return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
    };
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t a0 = __byte_perm(word(0, m), word(1, m), 0x5410);
      const uint32_t a1 = __byte_perm(word(0, m), word(1, m), 0x7632);
      const uint32_t a2 = __byte_perm(word(2, m), word(3, m), 0x5410);
      const uint32_t a3 = __byte_perm(word(2, m), word(3, m), 0x7632);
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
        mma_bf16_16816(d[m][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
    }
  }
}

}  // namespace splitk
}  // namespace ptt
