// Weight-only quantized matmul, for Hopper: y = x @ dequant(qw, scale).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/quant_matmul.py
// `_quant_kernel` (:133).  x [T, K] is bf16 or fp32 (the io type), qw
// [K, N] holds int8 or float8 e4m3 values (row-major, the [in, out]
// layout), scale [N] is the fp32 per-output-channel factor, y [T, N] is in
// the io type.  The op order is the TPU kernel's (quant_matmul.py:138-143):
// the weight is up-converted to the io type (exact for int8 and e4m3 into
// bf16 or fp32), the product accumulates in fp32, the scale multiplies the
// fp32 accumulator, and one cast writes the io type.  The scale is never
// folded into the weight, and nothing is dequantized in fp32 and rounded.
// The TPU kernel keeps K whole in one tile; K is blocked here, so only the
// order of the fp32 sum differs from the plain version.
//
// Three designs, one C entry point:
//
// bf16 at T <= 16 (decode): split-K (quant_splitk_kernel).  Every weight
// byte is read once for 2 T operations, so the launch is bound by the
// weight bytes (58.7 MB for gate/up: 17.5 us at 3.35 TB/s), and a serial
// walk over K in a few column blocks leaves most of the card idle.  A
// block owns 128 output columns and one of `splits` contiguous ranges of
// K, splits = ceil(kSplitFactor * SMs / column tiles), capped so that a
// split keeps kMinSlices 64-deep slices and raised so that none is deeper
// than kMaxSplitDepth (its x rows sit in shared memory): the grid covers
// the card at every decode shape (k/v: 8 column tiles x 16 splits).  Each
// of the 4 warps takes one 16-deep step of every 64-deep slice and
// streams its [16 rows][128 columns] weight boxes by TMA into a ring of
// its own (kSkStages slots, one mbarrier each, 32 KB in flight a block;
// the ring and the x rows fit three blocks on a SM at the decode shapes,
// so the ~2 blocks a SM of the split rule run in one wave).  (16-byte
// cp.async per lane streamed slower, at any depth from 4 to 10 steps.)
// Each lane converts its bytes once in registers (hopper.cuh
// w8_to_f, pack_bf16_exact) and runs mma.sync m16n8k16 with the weight as
// A (128 output columns as 8 m-tiles, rows and k permuted so that a
// thread's bytes are its fragment) and the <= 16 tokens as B (one or two
// n8 tiles).  The block sums its 4 warps in a fixed order; with one split
// it scales and casts, else it writes an fp32 partial [split, T, N] to a
// workspace the wrapper allocates, and the last block of the column tile
// to arrive (an atomic ticket, reset by that block) sums the splits in
// order 0..splits-1, scales and casts once.  Two calls on the same inputs
// give the same bits.
//
// bf16 at T > 16 (prefill chunks): wgmma (quant_wgmma_kernel), the ring of
// hopper_gemm.cuh with the weight's raw bytes in place of a bf16 tile: a
// producer thread issues TMA for the x tile (128-byte swizzle) and the raw
// [64, BN] weight box (no swizzle, a row of BN bytes); the consumer
// warpgroups convert the raw box into a bf16 tile in the swizzled MN-major
// layout that desc_mnmajor reads (w8_store_sw128), fence the proxy, meet
// at a named barrier and run wgmma_ss on it.  The converted tiles rotate
// through three buffers, so slice k + 1 converts while slice k's wgmma
// group is in flight, and a buffer is rewritten only after every consumer
// has waited on the group that read it.  The conversion, not the product,
// holds this kernel (converting in three spare warps of the producer
// warpgroup instead, behind mbarriers, ran slower), so a converted slice
// serves as many rows as the tiles allow.  The scale
// multiplies the fp32 accumulators in the epilogue before the one cast.
// Persistent blocks walk the tiles.  Tiles: 64 x 128 on one consumer
// warpgroup up to 64 rows; 128 x 256 on two where every SM gets two
// tiles; 256 x 128 on four past 128 rows where half the SMs get a tile (a
// 256-row prefill chunk then converts each weight slice once); else 128 x
// 128 on two.
//
// fp32 io (any T): the first design (quant_matmul_kernel): [BM, 64] output
// tiles, K in 64-deep steps through a cp.async ring, the raw tile
// up-converted in shared memory, fp32 FMAs on the CUDA cores (no TF32).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// -- fp32 io: the first design ------------------------------------------------

constexpr int BN = 64;    // output columns per block
constexpr int BK = 64;    // reduction depth per pipeline stage
constexpr int NT = 128;   // threads per block (4 warps)

template <int BM>
struct Cfg {
  static constexpr int STAGES = BM == 16 ? 8 : 4;
  static constexpr int LDA = BK + 4;   // x stage row stride (16B rows)
  static constexpr int LDB = BN + 4;   // converted weight row stride
  static constexpr size_t A_BYTES = (size_t)STAGES * BM * LDA * 4;
  static constexpr size_t W_BYTES = (size_t)STAGES * BK * BN;   // raw bytes
  static constexpr size_t B_BYTES = (size_t)BK * LDB * 4;
  static constexpr size_t SMEM = A_BYTES + W_BYTES + B_BYTES;
};

template <bool FP8, int BM>
__global__ void __launch_bounds__(NT)
quant_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qw,
                    const float* __restrict__ scale, float* __restrict__ y,
                    int T_, int K, int N) {
  using C = Cfg<BM>;
  constexpr int STAGES = C::STAGES, LDA = C::LDA, LDB = C::LDB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);              // [S][BM][LDA]
  uint8_t* Ws = smem_raw + C::A_BYTES;                         // [S][BK][BN]
  float* Bs = reinterpret_cast<float*>(smem_raw + C::A_BYTES + C::W_BYTES);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KT = K / BK;

  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    float* as = As + s * BM * LDA;
    for (int c = tid; c < BM * BK / 4; c += NT) {
      const int r = c / (BK / 4), cc = (c % (BK / 4)) * 4;
      const bool ok = m0 + r < T_;
      const float* src = ok ? x + (size_t)(m0 + r) * K + k0 + cc : x;
      ptt::cp_async16(as + r * LDA + cc, src, ok);
    }
    uint8_t* ws = Ws + s * BK * BN;
    for (int c = tid; c < BK * BN / 16; c += NT) {
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      ptt::cp_async16(ws + r * BN + cc, qw + (size_t)(k0 + r) * N + n0 + cc,
                      true);
    }
  };

  // keep STAGES-1 tiles in flight before anything else
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    ptt::cp_async_commit();
  }

  // thread owns rows ty + 8 i, columns 4 tx .. 4 tx + 3
  constexpr int RM = BM / 8;
  float f[RM][4];
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[i][j] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    ptt::cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt landed; stage (kt-1)%S and Bs are free
    if (kt + STAGES - 1 < KT)
      load_tile(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    ptt::cp_async_commit();
    const int s = kt % STAGES;
    // up-convert the raw weight tile, 16 bytes a step
    const uint8_t* ws = Ws + s * BK * BN;
    for (int c = tid; c < BK * BN / 16; c += NT) {
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(ws + r * BN + cc);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        Bs[r * LDB + cc + i] = ptt::hopper::w8_at<FP8>(raw, i);
    }
    __syncthreads();
    const float* as = As + s * BM * LDA;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * LDB + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = as[(ty + 8 * i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) f[i][j] = fmaf(a, bv[j], f[i][j]);
      }
    }
  }
  ptt::cp_async_wait<0>();

  // epilogue: y = acc * scale[n]
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = m0 + ty + 8 * i;
    if (r >= T_) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      y[(size_t)r * N + c] = f[i][j] * scale[c];
    }
  }
}

template <bool FP8, int BM>
int launch_fp32(const void* x, const void* qw, const float* scale, void* y,
                int T_, int K, int N, cudaStream_t stream) {
  constexpr size_t smem = Cfg<BM>::SMEM;
  auto kern = quant_matmul_kernel<FP8, BM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / BN, (T_ + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(static_cast<const float*>(x),
                                   static_cast<const uint8_t*>(qw), scale,
                                   static_cast<float*>(y), T_, K, N);
  return (int)cudaGetLastError();
}

template <bool FP8>
int quant_fp32(const void* x, const void* qw, const float* scale, void* y,
               int T_, int K, int N, cudaStream_t s) {
  // decode-sized row counts take 16-row tiles; longer chunks 64
  if (T_ <= 16) return launch_fp32<FP8, 16>(x, qw, scale, y, T_, K, N, s);
  return launch_fp32<FP8, 64>(x, qw, scale, y, T_, K, N, s);
}

// -- bf16 at T <= 16: split-K --------------------------------------------------

// the largest T that takes split-K (ops/kernels/quant_matmul.py,
// SPLITK_MAX_T); the split rule's constants (QM.splitk_splits mirrors
// splitk_splits)
constexpr int kSplitKMaxT = 16;
constexpr int kSkBN = 128;            // output columns a block
constexpr int kSkWarps = 4;           // warps a block: one k16 step each
constexpr int kSkStages = 4;          // k16 steps in flight per warp
constexpr int kSplitFactor = 2;       // blocks per SM the splits aim at
constexpr int kMinSlices = 4;         // 64-deep slices a split keeps
constexpr int kMaxSplitDepth = 2048;  // the deepest split (x in shared)
constexpr int kSkRingBytes = kSkStages * kSkWarps * 2048;   // 32 KB

int splitk_splits(int K, int N, int sms) {
  const int tiles = (N + kSkBN - 1) / kSkBN;
  const int slices = K / 64;
  int s = (kSplitFactor * sms + tiles - 1) / tiles;
  s = min(s, max(1, slices / kMinSlices));
  s = max(s, (K + kMaxSplitDepth - 1) / kMaxSplitDepth);
  return min(s, slices);
}

struct SplitArgs {
  CUtensorMap w;  // qw [K, N] as bytes: boxes of 16 rows x 128 columns
  const bf16* x;
  const float* scale;
  bf16* y;
  float* ws;      // [splits, T, N] fp32 partials (splits > 1)
  int* tickets;   // one per column tile, 0 between launches
  int T, K, N, splits;
};

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

// NT8 n8 tiles of tokens (1: T <= 8, 2: T <= 16).  The product is D^T =
// W^T x^T: M = the block's 128 output columns, N = the tokens, K = the
// reduction.  mma's fragment of lane (g = lane / 4, q = lane % 4) holds A
// rows g, g + 8 and reduction indices 2q, 2q + 1, 2q + 8, 2q + 9.  Any
// one-to-one relabelling of rows and of reduction indices (the same for
// A and B) leaves the sums as they are, so: m-tile j's rows g and g + 8
// are columns 16 g + 2 j and 16 g + 2 j + 1, and reduction indices 2q +
// e and 2q + 8 + e are k = 4q + e and 4q + 2 + e.  A lane's A fragments
// for the 8 m-tiles of a k16 step are then exactly the bytes of rows 4q
// .. 4q + 3 at columns 16 g .. 16 g + 15: four 16-byte vectors of the
// step's [16][128] box; its B fragment is x[token][4q .. 4q + 3]; its
// accumulators d[j][nt][2h + e] are column 16 g + 2 j + h, token 8 nt +
// 2 q + e.  Each warp streams its boxes through its own ring of
// kSkStages slots, each on its own mbarrier: lane 0 issues the TMA, the
// warp waits on the slot's phase, reads it, and lane 0 refills it.
template <bool FP8, int NT8>
__global__ void __launch_bounds__(kSkWarps * 32)
quant_splitk_kernel(const __grid_constant__ SplitArgs p) {
  using namespace ptt::hopper;
  constexpr int NTOK = 8 * NT8;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[kSkWarps][kSkStages];
  unsigned char* smem = align1024(smem_raw);   // TMA boxes: aligned
  const int n0 = blockIdx.x * kSkBN, split = blockIdx.y;
  const int slices = p.K / 64;
  const int s0 = split * slices / p.splits;
  const int steps = (split + 1) * slices / p.splits - s0;   // per warp
  const int k0 = 64 * s0, depth = 64 * steps;
  const int xstride = 2 * depth + 32;   // bytes; 32 spreads the rows' banks
  unsigned char* xs = smem + kSkRingBytes;   // [NTOK][xstride]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  unsigned char* ring = smem + warp * (kSkStages * 2048);   // this warp's
  uint64_t* bar = bars[warp];
  if (lane == 0) {
    for (int s = 0; s < kSkStages; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncwarp();
  // step j of this warp: rows k0 + 64 j + 16 warp .. + 15 of the block's
  // 128 columns (past N: zeros from TMA)
  auto load = [&](int j) {
    const int s = j % kSkStages;
    mbar_expect_tx(&bar[s], 2048);
    tma_load_2d(ring + s * 2048, &p.w, &bar[s], n0, k0 + 64 * j + 16 * warp);
  };
  if (lane == 0)
    for (int j = 0; j < kSkStages && j < steps; ++j) load(j);
  // the x rows of this split (rows past T zero), 16 bytes a thread
#pragma unroll
  for (int r = 0; r < NTOK; ++r) {
    const bool ok = r < p.T;
    for (int kc = 8 * tid; kc < depth; kc += 8 * kSkWarps * 32)
      ptt::cp_async16(xs + r * xstride + 2 * kc,
                      ok ? p.x + (size_t)r * p.K + k0 + kc : p.x, ok);
  }
  ptt::cp_async_commit();
  ptt::cp_async_wait<0>();
  __syncthreads();

  float d[8][NT8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][nt][e] = 0.f;

  for (int j = 0; j < steps; ++j) {
    const int s = j % kSkStages;
    mbar_wait(&bar[s], (j / kSkStages) & 1);
    const unsigned char* box = ring + s * 2048;
    uint4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint4*>(box + (4 * q + i) * 128 + 16 * g);
    __syncwarp();   // every lane has read the slot: refill it
    if (lane == 0 && j + kSkStages < steps) {
      fence_proxy_async();
      load(j + kSkStages);
    }
    const int kl = 64 * j + 16 * warp + 4 * q;
    uint2 b[NT8];
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      b[nt] = *reinterpret_cast<const uint2*>(xs + (8 * nt + g) * xstride +
                                              2 * kl);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const uint32_t a0 = pack_bf16_exact(w8_at<FP8>(r[0], 2 * m),
                                          w8_at<FP8>(r[1], 2 * m));
      const uint32_t a1 = pack_bf16_exact(w8_at<FP8>(r[0], 2 * m + 1),
                                          w8_at<FP8>(r[1], 2 * m + 1));
      const uint32_t a2 = pack_bf16_exact(w8_at<FP8>(r[2], 2 * m),
                                          w8_at<FP8>(r[3], 2 * m));
      const uint32_t a3 = pack_bf16_exact(w8_at<FP8>(r[2], 2 * m + 1),
                                          w8_at<FP8>(r[3], 2 * m + 1));
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
        mma_bf16_16816(d[m][nt], a0, a1, a2, a3, b[nt].x, b[nt].y);
    }
  }
  __syncthreads();   // every warp is done with the ring: it holds the sums

  // the 4 warps' sums, [warp][token][column], added in warp order
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
  const int n = n0 + tid;   // this thread's column in the epilogue
  const bool live = n < p.N;
  const float sc = live ? p.scale[n] : 0.f;
  if (p.splits == 1) {
    for (int t = 0; t < p.T; ++t) {
      float v = red[t * kSkBN + tid];
#pragma unroll
      for (int w = 1; w < kSkWarps; ++w) v += red[(w * NTOK + t) * kSkBN + tid];
      if (live) p.y[(size_t)t * p.N + n] = __float2bfloat16(v * sc);
    }
    return;
  }
  float* part = p.ws + (size_t)split * p.T * p.N;
  for (int t = 0; t < p.T; ++t) {
    float v = red[t * kSkBN + tid];
#pragma unroll
    for (int w = 1; w < kSkWarps; ++w) v += red[(w * NTOK + t) * kSkBN + tid];
    if (live) part[(size_t)t * p.N + n] = v;
  }
  // the last block of this column tile to finish sums the splits in order
  // (the barrier, then one thread's fence, publishes every thread's
  // partial before the ticket: fences are cumulative)
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&p.tickets[blockIdx.x], 1) == p.splits - 1;
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
    for (int s0 = 0; s0 < p.splits; s0 += 4) {
      float buf[4][NTOK];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* src = p.ws + (size_t)(s0 + i) * p.T * p.N + n;
#pragma unroll
        for (int t = 0; t < NTOK; ++t)
          buf[i][t] = s0 + i < p.splits && t < p.T
                          ? __ldcg(src + (size_t)t * p.N) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < NTOK; ++t)
          if (s0 + i < p.splits) v[t] += buf[i][t];
    }
#pragma unroll
    for (int t = 0; t < NTOK; ++t)
      if (t < p.T) p.y[(size_t)t * p.N + n] = __float2bfloat16(v[t] * sc);
  }
  if (tid == 0) p.tickets[blockIdx.x] = 0;
}

template <bool FP8, int NT8>
int launch_splitk(SplitArgs& a, const void* qw, cudaStream_t stream) {
  const uint64_t dims[2] = {(uint64_t)a.N, (uint64_t)a.K};
  const uint64_t stride[1] = {(uint64_t)a.N};
  const uint32_t box[2] = {128, 16};
  cudaError_t e = ptt::hopper::make_map_u8(&a.w, qw, dims, stride, box);
  if (e != cudaSuccess) return (int)e;
  auto kern = quant_splitk_kernel<FP8, NT8>;
  const int slices = a.K / 64;
  const int deepest = 64 * ((slices + a.splits - 1) / a.splits);
  const int smem = 1024 + kSkRingBytes + 8 * NT8 * (2 * deepest + 32);
  static_assert(kSkRingBytes >= kSkWarps * 16 * kSkBN * 4,
                "the warps' sums reuse the ring");
  e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      1024 + kSkRingBytes + 8 * NT8 * (2 * kMaxSplitDepth + 32));
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + kSkBN - 1) / kSkBN, a.splits);
  kern<<<grid, kSkWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// -- bf16 at T > 16: wgmma over raw weight tiles --------------------------------

constexpr int kBand = 16;   // row tiles a band of the tile walk covers

template <int NC, int BN>
struct QPlan {
  static constexpr int BM = 64 * NC;
  // x + raw weight slots: as deep as shared memory allows (a 64-row
  // tile keeps two blocks on a SM)
  static constexpr int STAGES = NC == 1 ? 3 : NC == 4 || BN == 256 ? 4 : 6;
  static constexpr int BUFS = 3;                   // converted bf16 tiles
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr uint32_t A_BYTES = BM * 64 * 2;
  static constexpr uint32_t W_BYTES = 64 * BN;           // raw bytes
  static constexpr uint32_t STAGE_BYTES = A_BYTES + W_BYTES;
  static constexpr uint32_t B_BYTES = 64 * BN * 2;       // a bf16 tile
  // 16-byte units of a raw box each consumer thread converts
  static constexpr int UNITS = 64 * BN / 16 / (128 * NC);
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                                 (size_t)BUFS * B_BYTES +
                                 2 * STAGES * sizeof(uint64_t);
};

struct WgmmaArgs {
  CUtensorMap x, w;   // x [T, K] bf16 (swizzled boxes), qw [K, N] bytes
  const float* scale;
  bf16* y;
  int T, K, N, row_tiles, col_tiles;
};

// named barrier 1 over the consumer warpgroups (0 is __syncthreads)
template <int NC>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
}

// Persistent: block b takes tiles b, b + gridDim.x, ... (column-major in
// bands of kBand row tiles, as qkv_gemm_kernel walks them); the producer
// and the consumers each keep a running slice count `it`, so slots,
// phases and converted buffers carry from tile to tile.
template <bool FP8, int NC, int BN>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
quant_wgmma_kernel(const __grid_constant__ WgmmaArgs p) {
  using namespace ptt::hopper;
  using P = QPlan<NC, BN>;
  constexpr int S = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* bufs = base + S * P::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(bufs + P::BUFS * P::B_BYTES);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int tiles = p.row_tiles * p.col_tiles, band = kBand * p.col_tiles;
  auto origin = [&](int t, int& m0, int& n0) {
    const int first = t / band * kBand;
    const int rows_in = min(kBand, p.row_tiles - first);
    const int in = t % band;
    m0 = (first + in % rows_in) * P::BM;
    n0 = in / rows_in * BN;
  };
  const int KT = p.K / 64;
  int it = 0, m0, n0;
  if (threadIdx.x < 128) {   // the producer warpgroup: one thread issues
    if constexpr (NC == 2) regs_dec<40>();
    if (threadIdx.x == 0)
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        origin(t, m0, n0);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
          unsigned char* slot = base + s * P::STAGE_BYTES;
          mbar_expect_tx(&full[s], P::STAGE_BYTES);
          tma_load_2d(slot, &p.x, &full[s], 64 * kt, m0);
          tma_load_2d(slot + P::A_BYTES, &p.w, &full[s], n0, 64 * kt);
        }
      }
    return;
  }
  if constexpr (NC == 2) regs_inc<232>();
  const int ct = threadIdx.x - 128;   // 0 .. 128 NC - 1
  const int c = ct / 128, lane = ct % 32, w = ct / 32 % 4;
  const bool signals = lane == 0;
  float acc[BN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    origin(t, m0, n0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const unsigned char* slot = base + s * P::STAGE_BYTES;
      // the raw box into bf16 tile it % 3: its last reader, slice it -
      // 3's wgmma group, finished before every consumer reached the
      // previous slice's barrier.  Each thread loads its units first,
      // then converts and stores them.
      unsigned char* bt = bufs + (it % P::BUFS) * P::B_BYTES;
      const unsigned char* raw = slot + P::A_BYTES;
      uint4 v[P::UNITS];
#pragma unroll
      for (int j = 0; j < P::UNITS; ++j) {
        const int u = ct + 128 * NC * j;
        v[j] = *reinterpret_cast<const uint4*>(raw + u * 16);
      }
#pragma unroll
      for (int j = 0; j < P::UNITS; ++j) {
        const int u = ct + 128 * NC * j;
        w8_store_sw128<FP8>(bt, u / (BN / 16), u % (BN / 16) * 16, v[j]);
      }
      fence_proxy_async();
      consumers_sync<NC>();
      const unsigned char* as = slot + c * 64 * 128;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_kmajor(as + 32 * kk);
        const uint64_t db = desc_mnmajor(bt + 2048 * kk, 8192);
        if constexpr (BN == 256)
          wgmma_ss_n256<1>(acc, da, db);
        else
          wgmma_ss_n128<1>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous slice's group is done with its slot
      fence_regs(acc);
      if (kt > 0 && signals) mbar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (signals) mbar_arrive(&empty[(it - 1) % S]);   // the tile's last slot
    // epilogue: the scale on the fp32 sums, one cast, masked past T and N
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 64 * c + 16 * w + lane / 4 + 8 * hh;
      if (row >= p.T) continue;
      uint32_t* orow = reinterpret_cast<uint32_t*>(p.y + (size_t)row * p.N);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
        if (col < p.N)
          orow[col / 2] = pack_bf16(acc[4 * i + 2 * hh] * p.scale[col],
                                    acc[4 * i + 2 * hh + 1] * p.scale[col + 1]);
      }
    }
  }
}

template <bool FP8, int NC, int BN>
int launch_wgmma(WgmmaArgs& a, const void* x, const void* qw,
                 cudaStream_t stream) {
  using P = QPlan<NC, BN>;
  const uint64_t xdims[2] = {(uint64_t)a.K, (uint64_t)a.T};
  const uint64_t xstride[1] = {(uint64_t)a.K * 2};
  const uint32_t xbox[2] = {64, (uint32_t)P::BM};
  cudaError_t e = ptt::hopper::make_map(&a.x, x, 2, xdims, xstride, xbox);
  const uint64_t wdims[2] = {(uint64_t)a.N, (uint64_t)a.K};
  const uint64_t wstride[1] = {(uint64_t)a.N};
  const uint32_t wbox[2] = {(uint32_t)BN, 64};
  if (e == cudaSuccess)
    e = ptt::hopper::make_map_u8(&a.w, qw, wdims, wstride, wbox);
  if (e != cudaSuccess) return (int)e;
  a.row_tiles = (a.T + P::BM - 1) / P::BM;
  a.col_tiles = (a.N + BN - 1) / BN;
  auto kern = quant_wgmma_kernel<FP8, NC, BN>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = min(a.row_tiles * a.col_tiles, (NC == 1 ? 2 : 1) *
                                                      ptt::hopper::sm_count());
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool FP8>
int quant_bf16(const void* x, const void* qw, const float* scale, void* y,
               void* ws, void* tickets, int T_, int K, int N,
               cudaStream_t s) {
  if (T_ <= kSplitKMaxT) {
    SplitArgs a{};
    a.x = static_cast<const bf16*>(x);
    a.scale = scale;
    a.y = static_cast<bf16*>(y);
    a.ws = static_cast<float*>(ws);
    a.tickets = static_cast<int*>(tickets);
    a.T = T_;
    a.K = K;
    a.N = N;
    a.splits = splitk_splits(K, N, ptt::hopper::sm_count());
    if (a.splits > 1 && (ws == nullptr || tickets == nullptr))
      return (int)cudaErrorInvalidValue;
    return T_ <= 8 ? launch_splitk<FP8, 1>(a, qw, s)
                   : launch_splitk<FP8, 2>(a, qw, s);
  }
  WgmmaArgs a{};
  a.scale = scale;
  a.y = static_cast<bf16*>(y);
  a.T = T_;
  a.K = K;
  a.N = N;
  // the conversion, not the product, is the work a slice adds, so a
  // converted slice serves as many rows as it can: 64 x 128 tiles up to
  // 64 rows, 128 x 256 where they give every SM two, 256 x 128 (four
  // consumer warpgroups) past 128 rows where they give half the SMs one,
  // else 128 x 128
  const int sms = ptt::hopper::sm_count();
  if (T_ <= 64) return launch_wgmma<FP8, 1, 128>(a, x, qw, s);
  if ((T_ + 127) / 128 * ((N + 255) / 256) >= 2 * sms)
    return launch_wgmma<FP8, 2, 256>(a, x, qw, s);
  if (T_ > 128 && (T_ + 255) / 256 * ((N + 127) / 128) >= sms / 2)
    return launch_wgmma<FP8, 4, 128>(a, x, qw, s);
  return launch_wgmma<FP8, 2, 128>(a, x, qw, s);
}

}  // namespace

extern "C" {

// The split-K plan of a call: the number of K splits bf16 at T <= 16
// takes (its workspace is splits * T * N fp32 where splits > 1, and it
// needs (N + 127) / 128 tickets), 0 where the call takes no workspace.
int ptt_quant_splits(int dtype, int T, int K, int N) {
  if (dtype != ptt::DT_BFLOAT16 || T <= 0 || T > kSplitKMaxT || K < 64)
    return 0;
  return splitk_splits(K, N, ptt::hopper::sm_count());
}

// y = (x @ float(qw)) * scale, one cast; x [T, K] and y [T, N] in `dtype`
// (float32 or bfloat16), qw [K, N] int8 or float8 e4m3 (`wtype`), scale
// [N] fp32.  K and N multiples of 64; every pointer 16-byte aligned.  ws
// and tickets: the split-K workspace (ptt_quant_splits), the tickets
// zero before the launch (and again after it); null where it takes none.
int ptt_quant_matmul(int dtype, int wtype, const void* x, const void* qw,
                     const void* scale, void* y, void* ws, void* tickets,
                     int T, int K, int N, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || K % BK != 0 || N % BN != 0 ||
      (wtype != ptt::DT_INT8 && wtype != ptt::DT_FP8_E4M3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const bool fp8 = wtype == ptt::DT_FP8_E4M3;
  if (dtype == ptt::DT_BFLOAT16)
    return fp8 ? quant_bf16<true>(x, qw, sc, y, ws, tickets, T, K, N, s)
               : quant_bf16<false>(x, qw, sc, y, ws, tickets, T, K, N, s);
  if (dtype == ptt::DT_FLOAT32)
    return fp8 ? quant_fp32<true>(x, qw, sc, y, T, K, N, s)
               : quant_fp32<false>(x, qw, sc, y, T, K, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
