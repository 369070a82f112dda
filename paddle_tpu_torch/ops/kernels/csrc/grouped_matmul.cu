// Grouped expert FFN, y[g] = gelu(x[g] @ W1[e] + b1[e]) @ W2[e] + b2[e] over
// capacity-grouped tokens x [G, C, d], group g bound to expert
// e = g / rep (rep = G / E), rows at and past counts[g] exactly zero.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/grouped_matmul.py
// `_grouped_kernel` (:121, pallas_call at :175).
//
// The TPU kernel walks the hidden axis innermost and folds each
// [block_c, block_f] hidden tile into a [block_c, d] fp32 accumulator in
// VMEM.  At d = 2560 that accumulator is 640 KB for 64 rows, about three
// times the 227 KB a Hopper block may use, so the FFN is two launches
// here, as the gated MLP of fused_block.cu is:
//   MODE_UP    h[g] = bf16(gelu(x[g] @ W1[e] + b1[e]))  into a [G, C, h]
//              workspace in x's type: exactly the TPU kernel's rounding
//              point (hb.astype(x_ref.dtype), grouped_matmul.py:150);
//   MODE_DOWN  y[g] = h[g] @ W2[e] + b2[e].
// The hidden makes one round trip through device memory (G * C * h *
// itemsize bytes each way).
//
// Counts: the kernels read each group's count from device memory, so the
// host never waits for the routing.  Rows at and past the count are
// skipped: a row tile that starts at or past it is not computed (UP
// writes nothing: DOWN never keeps those rows; DOWN writes the tile's
// zeros), and inside a partial tile DOWN writes zero for the rows past it
// (a NaN in an unrouted row of x reaches only that row, which DOWN
// zeroes).  The last capacity tile may be partial (C = 960 is no multiple
// of 128): rows past C are neither read nor written.
//
// bf16 (the MoE step's path) runs each launch as a persistent walk on the
// wgmma / TMA ring of hopper_gemm.cuh: one block of three warpgroups a SM
// (a producer thread issuing TMA loads, two consumer warpgroups of 64 rows
// each), 128-row tiles of 256 columns where every SM gets two, else 128.
// A is a 3-d tensor map {K, C, G} over x (UP) or the hidden (DOWN), boxes
// {64, 128, 1}: TMA zero-fills rows past C, so a tile never reads the next
// group; B a 3-d map {N, K, E} over w1 / w2 in their [E, in, out] layout,
// read MN-major, group g taking expert g / rep.  The producer and the
// consumers read the counts and walk the same live tiles (those with a
// routed row), so the ring's running slice count agrees; block b takes
// live tiles b, b + grid, ..., so the blocks get equal shares however the
// counts fall (striding over all tiles and skipping the dead ones left
// the shares to the counts).  The live tiles are walked group after
// group, column-major inside a group's row tiles, so a group's weight
// columns stay in L2 while its rows stream.  DOWN's consumers then store
// the dead tiles' zeros, walked the same way.
// The epilogue runs from the fp32 accumulators: UP adds b1 in fp32, takes
// the exact-erf gelu and casts once; DOWN adds b2 in fp32 and casts once.
//
// What bounds it: at the MoE step's shapes (G = 64, C = 960, d = 2560,
// h = 1536, ~768 routed rows a group) the products, 4 * sum(counts) * d * h
// operations (773 GFLOP, 0.78 ms at 989 TFLOP/s).  Row tiles are whole
// 128-row tiles, so a partial tile computes its rows past the count too.
//
// fp32 (a parity path on no main path) keeps the first design: 64 x 64
// output tiles, 64-deep k steps through a 3-stage cp.async ring, fp32 FMAs
// on the CUDA cores (no TF32), a grid of (column tile, row tile, group).
#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

enum Mode { MODE_UP = 0, MODE_DOWN = 1 };

// jax.nn.gelu(approximate=False): 0.5 x erfc(-x / sqrt 2), in fp32
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * erfcf(-v * 0.70710678118654752f);
}

// -- fp32: the first design ---------------------------------------------------

constexpr int BM = 64;       // capacity rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 64;       // reduction depth per pipeline stage
constexpr int NT = 128;      // threads per block (4 warps)
constexpr int STAGES = 3;
constexpr int LDA = BK + 4;  // fp32 tiles, rows kept 16-byte aligned
constexpr int LDB = BN + 4;
constexpr int VEC = 4;       // fp32 elements per cp.async

struct Args {
  const void* a;       // UP: x [G, C, K]; DOWN: h [G, C, K]
  const void* b;       // UP: w1 [E, K, N]; DOWN: w2 [E, K, N]
  const void* bias;    // UP: b1 [E, N]; DOWN: b2 [E, N]
  const int* counts;   // [G] valid-row prefix of each group
  void* c;             // UP: h [G, C, N]; DOWN: y [G, C, N]
  int C, K, N, rep;
};

constexpr size_t smem_bytes() {
  constexpr size_t pipe =
      (size_t)STAGES * (BM * LDA + BK * LDB) * sizeof(float);
  constexpr size_t cst = (size_t)BM * (BN + 4) * sizeof(float);
  return pipe > cst ? pipe : cst;
}

template <int MODE>
__global__ void __launch_bounds__(NT)
grouped_kernel(Args g) {
  const int grp = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int col = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int C = g.C, K = g.K, N = g.N;
  const int cnt = min(max(g.counts[grp], 0), C);
  float* Cg = static_cast<float*>(g.c) + (size_t)grp * C * N;

  if (m0 >= cnt) {
    // no routed row in this tile: skip the products
    if (MODE == MODE_DOWN) {
      const int rows = min(BM, C - m0);
      for (int e = tid; e < rows * BN; e += NT)
        Cg[(size_t)(m0 + e / BN) * N + col + e % BN] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + STAGES * BM * LDA;
  const int ex = grp / g.rep;
  const float* A = static_cast<const float*>(g.a) + (size_t)grp * C * K;
  const float* B = static_cast<const float*>(g.b) + (size_t)ex * K * N;

  const int KT = K / BK;
  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    float* as = As + s * BM * LDA;
    for (int c = tid; c < BM * BK / VEC; c += NT) {
      int r = c / (BK / VEC), cc = (c % (BK / VEC)) * VEC;
      bool ok = m0 + r < cnt;          // rows past the count load as zero
      const float* src = ok ? A + (size_t)(m0 + r) * K + k0 + cc : A;
      ptt::cp_async16(as + r * LDA + cc, src, ok);
    }
    float* bs = Bs + s * BK * LDB;
    for (int c = tid; c < BK * BN / VEC; c += NT) {
      int r = c / (BN / VEC), cc = (c % (BN / VEC)) * VEC;
      ptt::cp_async16(bs + r * LDB + cc, B + (size_t)(k0 + r) * N + col + cc,
                      true);
    }
  };

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
    __syncthreads();   // tile kt visible to all; stage (kt-1)%S free
    if (kt + STAGES - 1 < KT)
      load_tile(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    ptt::cp_async_commit();
    const int s = kt % STAGES;
    const float* as = As + s * BM * LDA;
    const float* bs = Bs + s * BK * LDB;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk * LDB + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float a = as[(ty + 8 * i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) f[i][j] = fmaf(a, bv[j], f[i][j]);
      }
    }
  }
  ptt::cp_async_wait<0>();
  __syncthreads();   // pipeline buffers are reused for the C tile

  // epilogue: stage the fp32 tile in shared memory, then bias (+ gelu)
  constexpr int LDC = BN + 4;
  float* Cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty + 8 * i) * LDC + tx * 4 + j] = f[i][j];
  __syncthreads();
  const float* bias = static_cast<const float*>(g.bias) + (size_t)ex * N + col;
  const int rows = min(BM, C - m0);
  for (int e = tid; e < rows * BN; e += NT) {
    int r = e / BN, c = e % BN;
    float v = 0.f;
    if (m0 + r < cnt) {
      v = Cs[r * LDC + c] + bias[c];
      if (MODE == MODE_UP) v = gelu_erf(v);
    } else if (MODE == MODE_UP) {
      continue;   // MODE_DOWN never reads hidden rows past the count
    }
    Cg[(size_t)(m0 + r) * N + col + c] = v;
  }
}

template <int MODE>
int launch_fp32(const Args& g, int G, cudaStream_t stream) {
  if (g.K % BK != 0 || g.N % BN != 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes();
  auto kern = grouped_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(g.N / BN, (g.C + BM - 1) / BM, G);
  kern<<<grid, NT, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

// -- bf16: persistent walks on the wgmma / TMA ring ---------------------------

namespace hop {

using bf16 = __nv_bfloat16;
constexpr int NC = 2;        // consumer warpgroups: 128-row tiles
constexpr int TM = 64 * NC;
constexpr int STAGES = 4;

struct Params {
  CUtensorMap a, b;      // 3-d: A {K, C, G}, B {N, K, E}
  const bf16* bias;      // [E, N]
  const int* counts;     // [G]
  bf16* c;               // [G, C, N]
  int G, C, K, N, rep, row_tiles, col_tiles;
};

// counts[g] clamped to [0, C]
__device__ __forceinline__ int count_of(const Params& p, int g) {
  return min(max(__ldg(p.counts + g), 0), p.C);
}

// The row tiles of group g that hold a routed row (LIVE), or the others
template <bool LIVE>
__device__ __forceinline__ int rows_of(const Params& p, int g) {
  const int n = (count_of(p, g) + TM - 1) / TM;
  return LIVE ? n : p.row_tiles - n;
}

// A walk over the live (or the dead) tiles of every group, in order:
// groups one after another, column-major inside a group's live (dead)
// row tiles.  Block b takes the tiles b, b + gridDim.x, ... of it, so
// every block gets as many live tiles as any other, give or take one,
// however the counts fall.  `base` is the first tile of group g, n its
// row tiles.
struct Walk {
  int g = 0, base = 0, n = -1;
};

// Tile r of the walk (r grows call by call): group g, rows m0..,
// columns n0..; false past the last tile.
template <bool LIVE>
__device__ __forceinline__ bool walk(const Params& p, Walk& w, int r, int bn,
                                     int& g, int& m0, int& n0) {
  if (w.n < 0) w.n = rows_of<LIVE>(p, 0);
  while (r >= w.base + w.n * p.col_tiles) {
    w.base += w.n * p.col_tiles;
    if (++w.g == p.G) return false;
    w.n = rows_of<LIVE>(p, w.g);
  }
  const int in = r - w.base;
  g = w.g;
  m0 = ((LIVE ? 0 : p.row_tiles - w.n) + in % w.n) * TM;
  n0 = in / w.n * bn;
  return true;
}

// Consumer warpgroup c's epilogue of the tile (g, m0, n0): the fp32 bias
// (and gelu), one cast, bf16 pairs from the fragment; rows past C never
// stored, rows past the count zero (DOWN) or left (UP); a dead tile's
// rows all zero (acc unread)
template <int BN, int MODE>
__device__ __forceinline__ void store_tile(const Params& p,
                                           const float (&acc)[BN / 2], int g,
                                           int m0, int n0, int c, bool dead) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4;
  const int cnt = count_of(p, g);
  const bf16* bias = p.bias + (size_t)(g / p.rep) * p.N;
  bf16* out = p.c + (size_t)g * p.C * p.N;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 64 * c + 16 * w + lane / 4 + 8 * hh;
    if (row >= p.C || (MODE == MODE_UP && row >= cnt)) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + (size_t)row * p.N);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      if (col >= p.N) continue;
      float v[2] = {0.f, 0.f};
      if (!dead && row < cnt) {
        const float2 b2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + col));
        v[0] = acc[4 * i + 2 * hh] + b2.x;
        v[1] = acc[4 * i + 2 * hh + 1] + b2.y;
        if (MODE == MODE_UP) {
          v[0] = gelu_erf(v[0]);
          v[1] = gelu_erf(v[1]);
        }
      }
      orow[col / 2] = ptt::hopper::pack_bf16(v[0], v[1]);
    }
  }
}

template <int BN, int MODE>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
grouped_hopper(const __grid_constant__ Params p) {
  using namespace ptt::hopper;
  extern __shared__ unsigned char smem_raw[];
  const auto ring = gemm_ring<NC, BN, STAGES>(smem_raw);
  int it = 0, g, m0, n0;
  if (threadIdx.x < 128) {   // the producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0) {
      Walk live;
      for (int r = blockIdx.x; walk<true>(p, live, r, BN, g, m0, n0);
           r += gridDim.x)
        gemm_produce<NC, BN, STAGES, 1, 3>(ring, &p.a, &p.b, m0, n0, p.K,
                                           nullptr, it, g, g / p.rep);
    }
    return;
  }
  regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  float acc[BN / 2], none[1];
  Walk live;
  for (int r = blockIdx.x; walk<true>(p, live, r, BN, g, m0, n0);
       r += gridDim.x) {
    gemm_consume(ring, p.K, c, acc, none, it);
    store_tile<BN, MODE>(p, acc, g, m0, n0, c, false);
  }
  if constexpr (MODE == MODE_DOWN) {   // the zeros of the dead tiles
    Walk dead;
    for (int r = blockIdx.x; walk<false>(p, dead, r, BN, g, m0, n0);
         r += gridDim.x)
      store_tile<BN, MODE>(p, acc, g, m0, n0, c, true);
  }
}

template <int BN, int MODE>
int launch_bn(Params& p, const Args& g, int G, int E, cudaStream_t stream) {
  using P = ptt::hopper::GemmPlan<NC, BN, STAGES>;
  const uint64_t adims[3] = {(uint64_t)g.K, (uint64_t)g.C, (uint64_t)G};
  const uint64_t astride[2] = {(uint64_t)g.K * 2, (uint64_t)g.C * g.K * 2};
  const uint32_t abox[3] = {64, (uint32_t)TM, 1};
  cudaError_t e = ptt::hopper::make_map(&p.a, g.a, 3, adims, astride, abox);
  const uint64_t bdims[3] = {(uint64_t)g.N, (uint64_t)g.K, (uint64_t)E};
  const uint64_t bstride[2] = {(uint64_t)g.N * 2, (uint64_t)g.K * g.N * 2};
  const uint32_t bbox[3] = {64, 64, 1};
  if (e == cudaSuccess)
    e = ptt::hopper::make_map(&p.b, g.b, 3, bdims, bstride, bbox);
  if (e != cudaSuccess) return (int)e;
  p.col_tiles = (g.N + BN - 1) / BN;
  auto kern = grouped_hopper<BN, MODE>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = min(G * p.row_tiles * p.col_tiles,
                       ptt::hopper::sm_count());
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// 128 x 256 tiles where every SM gets two, else 128 x 128 (the choice of
// fused_block.cu's mlp_hopper for its two-consumer tiles)
template <int MODE>
int launch(const Args& g, int G, cudaStream_t stream) {
  if (g.K % 64 != 0 || g.N % 64 != 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.bias = static_cast<const bf16*>(g.bias);
  p.counts = g.counts;
  p.c = static_cast<bf16*>(g.c);
  p.G = G;
  p.C = g.C;
  p.K = g.K;
  p.N = g.N;
  p.rep = g.rep;
  p.row_tiles = (g.C + TM - 1) / TM;
  const int E = G / g.rep;
  if (G * p.row_tiles * ((g.N + 255) / 256) >= 2 * ptt::hopper::sm_count())
    return launch_bn<256, MODE>(p, g, G, E, stream);
  return launch_bn<128, MODE>(p, g, G, E, stream);
}

}  // namespace hop

template <int MODE>
int launch(int dtype, const Args& g, int G, void* stream, void* design) {
  if (G <= 0 || g.C <= 0 || g.rep <= 0 || G % g.rep != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return ptt::launched(hop::launch<MODE>(g, G, s), design,
                         ptt::DESIGN_WGMMA);
  if (dtype == ptt::DT_FLOAT32)
    return ptt::launched(launch_fp32<MODE>(g, G, s), design,
                         ptt::DESIGN_TILE);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// h[g] = gelu(x[g] @ w1[g / rep] + b1[g / rep]) for rows < counts[g];
// x [G, C, d], w1 [E, d, h], b1 [E, h], counts [G] int32, h [G, C, h];
// design (an int) receives the design launched (enum Design).
int ptt_grouped_ffn_up(int dtype, const void* x, const void* w1,
                       const void* b1, const void* counts, void* h, int G,
                       int C, int d, int hid, int rep, void* stream,
                       void* design) {
  Args g{x, w1, b1, static_cast<const int*>(counts), h, C, d, hid, rep};
  return launch<MODE_UP>(dtype, g, G, stream, design);
}

// y[g] = h[g] @ w2[g / rep] + b2[g / rep] for rows < counts[g], zero for
// the other rows; h [G, C, h], w2 [E, h, d], b2 [E, d], y [G, C, d].
int ptt_grouped_ffn_down(int dtype, const void* h, const void* w2,
                         const void* b2, const void* counts, void* y, int G,
                         int C, int hid, int d, int rep, void* stream,
                         void* design) {
  Args g{h, w2, b2, static_cast<const int*>(counts), y, C, hid, d, rep};
  return launch<MODE_DOWN>(dtype, g, G, stream, design);
}

}  // extern "C"
