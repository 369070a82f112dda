// Split-K at decode rows (T <= 16), shared by quant_matmul.cu
// (quant_splitk_kernel: 8-bit weights) and fused_block.cu
// (qkv_splitk_kernel: bf16 weights, after the RMSNorm row pass).
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
//     atomic ticket, reset by that block) sums the splits in order
//     0..splits-1.  Two calls on the same inputs give the same bits.
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
  // the last block of this column tile to finish sums the splits in order
  // (the barrier, then one thread's fence, publishes every thread's
  // partial before the ticket: fences are cumulative)
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
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
  if (tid == 0) *ticket = 0;
}

}  // namespace splitk
}  // namespace ptt
