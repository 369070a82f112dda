// Fused RMSNorm + QKV projection, the gated SwiGLU MLP and fused_ffn, for
// Hopper.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/fused_block.py
// `_qkv_kernel` (:249) and `_mlp_kernel` (:494: gated silu, and the
// non-gated act + bias variant of `fused_ffn`).
//
// One tiled GEMM body C[T, N] = A[T, K] @ B[K, N] (row-major, weights in
// the [in, out] layout) serves four launches through its prologue and
// epilogue:
//   MODE_QKV    (T <= 16, and fp32) A = x.  The block first computes its
//               rows' inverse RMS in fp32; every x tile that lands in
//               shared memory is then normalised in place, xn = (x * inv)
//               * wn cast to the weight type (the cast point of
//               _qkv_reference, fused_block.py:348), so the normalised
//               activations never exist in device memory.
//               The grid's columns walk the concatenation q | k | v; each
//               column tile lies inside one of the three.  The training
//               variant (non-null xn / inv) also writes the normalised rows
//               xn [T, d] in x's type and the fp32 inverse RMS [T], the
//               residuals of _qkv_fwd (fused_block.py:371-383); only the
//               blocks of the first column tile store them, so each row is
//               written once.
//   MODE_GATEUP A = x, two weight tiles (gate, up) per k step; the epilogue
//               writes h = silu(x @ Wg) * (x @ Wu) cast to the io type, which
//               is the TPU kernel's cast of h to Wd's type (fused_block.py:526).
//   MODE_PLAIN  y = h @ Wd (+ b, added to the fp32 sum before the one cast:
//               the down half of both MLPs).
//   MODE_FFN_UP A = x; the epilogue writes h = act(x @ W1 + b1) cast to the
//               io type (relu, exact-erf gelu or silu on the fp32 sum plus
//               the fp32 bias: the TPU kernel's u, h and cast of h to W2's
//               type, fused_block.py:520-529), the up half of `fused_ffn`.
// The TPU kernel keeps a [bt, d] fp32 down-projection accumulator in VMEM
// across the hidden axis; a Hopper block cannot hold that (16 rows of
// d = 4096 fp32 are 256 KB, over the 227 KB a block may use), so each MLP
// is two launches here and h makes one round trip through device memory
// (T * f * itemsize bytes each way: 32 MB at T = 8192, f = 2048 in bf16).
//
// What bounds it: at decode (T = 8 rows) the weights are read once for very
// few operations, so the launch is bound by device-memory bytes.  The design
// keeps several 64-deep weight tiles in flight per block through a cp.async
// ring (6 stages for 16-row tiles, 3 for 64-row tiles; rows past T are
// zero-filled), so each block streams its weight columns without waiting on
// every load.  Row tiles are 16 rows at decode (one wmma row) and 64 rows
// past 16 (fp32 only: bf16 there is the wgmma GEMM below).  bf16 runs on the tensor cores through nvcuda::wmma
// 16x16x16 with fp32 accumulators; fp32 runs on the CUDA cores with fp32
// FMAs (no TF32).  The tile itself is gemm_tile.cuh's, which the fp32
// whole-block decoder kernel (fused_decoder.cu) calls too.
//
// RMSNorm+QKV in bf16 at T > 16 (prefill chunks, training, scoring) is
// two launches from one C call, in the TPU kernel's structure: normalise
// each row once, then project (fused_block.py:264-271 normalises a token
// block at j == 0 and keeps xn in VMEM for every output block):
//   1. the row pass (qkv_rows_kernel, rmsnorm_row.cuh's code, one warp a
//      row): xn = ((x * inv) * wn) cast to x's type and inv in fp32, the
//      cast points of _qkv_reference (fused_block.py:345-348).  In the
//      training variant xn and inv are the outputs the custom VJP saves;
//      in the forward variant xn goes to a workspace the wrapper
//      allocates and inv is not written;
//   2. the GEMM [q | k | v] = xn @ [wq | wk | wv] (qkv_gemm_kernel, the
//      wgmma / TMA ring of hopper_gemm.cuh): 128 x 256 tiles on two
//      consumer warpgroups where there are at least two tiles a SM, 64 x
//      128 on one otherwise; each column tile lies inside q, k or v (a
//      part's last tile may be partial: TMA zero-fills the columns past
//      it and the store masks them), and the blocks walk the tiles in
//      bands of 16 row tiles, so the tiles in flight share their x rows
//      and weight columns in L2.  The epilogue casts once and stores bf16
//      pairs from the registers.
// What bounds it at T = 8192 (d 4096, dq 4096, dkv 1024): the products,
// 412 GFLOP (0.42 ms at 989 TFLOP/s); the row pass moves 128 MB (0.04
// ms).  Normalising inside the GEMM would make each of the 96 column
// tiles of a row tile re-read x for its inverse RMS and renormalise
// every k slice; the GEMM reads xn as it is.
//
// The MLP and fused_ffn in bf16 at T > 16 run their three GEMM modes on the
// same ring (mlp_gemm_kernel, persistent: a block a SM, or two for the
// 64-row single-weight tile, each walking its tiles so that one tile's
// stores overlap the next one's loads): gate/up takes two B operands a
// slot (A 128 x 64, Bg and Bu 64 x 128: 48 KB, four slots) and keeps two
// accumulators a consumer, writing h = silu(g) * u from fp32 once cast;
// fused_ffn's up adds the fp32 bias and applies the activation before its
// cast; the down product adds the optional bias before its cast.  Tiles:
// 128 x 256 (gate/up 128 x 128 of each weight) where every SM gets two,
// 128 x 128 where every SM gets one, else 64 x 128; bands of 16 row tiles,
// a partial last column tile zero-filled by TMA and masked at the store.
// What bounds the training forward's MLP (T = 8192, d 4096, f 14336): the
// products, 2.9 TFLOP (2.9 ms at 989 TFLOP/s); a 256-row prefill chunk:
// the weight bytes (352 MB, 0.105 ms) and the products (90 GFLOP, 0.091
// ms) about equally.
// T <= 16 (decode, bound by the weight bytes) and fp32 keep the wmma tile
// below, as one launch.
//
#include "gemm_tile.cuh"
#include "hopper_gemm.cuh"
#include "rmsnorm_row.cuh"

namespace {

using namespace ptt::gemm;

template <typename T, int BM, int MODE>
__global__ void __launch_bounds__(NT)
gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  gemm_tile<T, BM, MODE>(g, blockIdx.y, blockIdx.x, smem_raw);
}

template <typename T, int BM, int MODE>
int launch_bm(const GemmArgs& g, int ncols, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, BM, MODE>();
  auto kern = gemm_kernel<T, BM, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(ncols / BN, (g.T + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_t(const GemmArgs& g, int ncols, cudaStream_t stream) {
  // decode-sized row counts take one 16-row wmma tile; longer chunks 64
  // (bf16 past 16 rows is qkv_hopper's and mlp_hopper's)
  if (g.T <= 16) return launch_bm<T, 16, MODE>(g, ncols, stream);
  if constexpr (sizeof(T) == 2)
    return (int)cudaErrorInvalidValue;
  else
    return launch_bm<T, 64, MODE>(g, ncols, stream);
}

template <int MODE>
int launch(int dtype, const GemmArgs& g, int ncols, void* stream) {
  if (g.T <= 0 || g.K % BK != 0 || ncols % BN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16) return launch_t<__nv_bfloat16, MODE>(g, ncols, s);
  if (dtype == ptt::DT_FLOAT32) return launch_t<float, MODE>(g, ncols, s);
  return (int)cudaErrorInvalidValue;
}


// -- RMSNorm+QKV at T > 16 in bf16: row pass, then the wgmma GEMM ------------

using bf16 = __nv_bfloat16;
// the smallest T that takes the two-launch path in bf16; the wrapper
// (ops/kernels/fused_block.py, ROW_PASS_MIN_T) allocates the forward
// variant's xn workspace by the same rule
constexpr int kRowPassMinT = 17;
constexpr int kStages = 4;   // 64-deep K slices in flight
constexpr int kBand = 16;    // row tiles a band of the tile walk covers

__global__ void __launch_bounds__(ptt::norm::NT)
qkv_rows_kernel(const bf16* x, const bf16* wn, bf16* xn, float* inv,
                int rows, int d, float eps) {
  const int r = blockIdx.x * ptt::norm::ROWS + threadIdx.x / 32;
  if (r >= rows) return;
  ptt::norm::rmsnorm_row<bf16, true, false>(x, nullptr, wn, xn, nullptr, inv,
                                           r, d, eps);
}

struct QkvParams {
  CUtensorMap xn, wq, wk, wv;   // A, and B of each column part
  bf16* out[3];                 // q, k, v
  int n[3];                     // dq, dkv, dkv
  int tiles[3];                 // column tiles of each part
  int T, K, row_tiles;
};

template <int NC, int BN>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 2 ? 1 : 2)
qkv_gemm_kernel(const __grid_constant__ QkvParams p) {
  using namespace ptt::hopper;
  using P = GemmPlan<NC, BN, kStages>;
  extern __shared__ unsigned char smem_raw[];
  const auto ring = gemm_ring<NC, BN, kStages>(smem_raw);
  // block -> (row tile, column tile): column-major inside bands of kBand
  // row tiles
  int rt, ct, part = 0;
  band_tile(blockIdx.x, p.row_tiles, p.tiles[0] + p.tiles[1] + p.tiles[2],
            kBand, rt, ct);
  const int m0 = rt * P::BM;
  while (part < 2 && ct >= p.tiles[part]) ct -= p.tiles[part++];
  const int n0 = ct * BN;
  if (threadIdx.x < 128) {   // the producer warpgroup
    if constexpr (NC == 2) regs_dec<40>();
    const CUtensorMap* w = part == 0 ? &p.wq : part == 1 ? &p.wk : &p.wv;
    if (threadIdx.x == 0) gemm_produce(ring, &p.xn, w, m0, n0, p.K);
    return;
  }
  if constexpr (NC == 2) regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  float acc[BN / 2];
  gemm_consume(ring, p.K, c, acc);
  // epilogue: one cast, bf16 pairs from the fragment, masked past T and
  // past the part's width
  const int t = threadIdx.x % 128, lane = t % 32;
  const int n = p.n[part];
  bf16* out = p.out[part];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 64 * c + 16 * (t / 32) + lane / 4 + 8 * hh;
    if (row >= p.T) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + (size_t)row * n);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      if (col < n)
        orow[col / 2] =
            pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    }
  }
}

template <int NC, int BN>
int launch_qkv_gemm(QkvParams& p, const void* xn, const void* const w[3],
                    cudaStream_t stream) {
  using P = ptt::hopper::GemmPlan<NC, BN, kStages>;
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.T};
  const uint64_t astride[1] = {(uint64_t)p.K * 2};
  const uint32_t abox[2] = {64, (uint32_t)P::BM};
  cudaError_t e = ptt::hopper::make_map(&p.xn, xn, 2, adims, astride, abox);
  CUtensorMap* maps[3] = {&p.wq, &p.wk, &p.wv};
  for (int i = 0; i < 3 && e == cudaSuccess; ++i) {
    const uint64_t dims[2] = {(uint64_t)p.n[i], (uint64_t)p.K};
    const uint64_t stride[1] = {(uint64_t)p.n[i] * 2};
    const uint32_t box[2] = {64, 64};
    e = ptt::hopper::make_map(maps[i], w[i], 2, dims, stride, box);
    p.tiles[i] = (p.n[i] + BN - 1) / BN;
  }
  if (e != cudaSuccess) return (int)e;
  p.row_tiles = (p.T + P::BM - 1) / P::BM;
  auto kern = qkv_gemm_kernel<NC, BN>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.row_tiles * (p.tiles[0] + p.tiles[1] + p.tiles[2]);
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

int qkv_hopper(const void* x, const void* wn, const void* const w[3],
               void* const out[3], void* xn, void* inv, int T, int d, int dq,
               int dkv, float eps, cudaStream_t stream) {
  if (xn == nullptr || d % 64 != 0) return (int)cudaErrorInvalidValue;
  constexpr int ROWS = ptt::norm::ROWS;
  qkv_rows_kernel<<<(T + ROWS - 1) / ROWS, ptt::norm::NT, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wn),
      static_cast<bf16*>(xn), static_cast<float*>(inv), T, d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  QkvParams p{};
  for (int i = 0; i < 3; ++i) p.out[i] = static_cast<bf16*>(out[i]);
  p.n[0] = dq;
  p.n[1] = p.n[2] = dkv;
  p.T = T;
  p.K = d;
  // 128 x 256 tiles where they give every SM two, else 64 x 128 (more
  // blocks for short T)
  const int big =
      (T + 127) / 128 * ((dq + 255) / 256 + 2 * ((dkv + 255) / 256));
  if (big >= 2 * ptt::hopper::sm_count())
    return launch_qkv_gemm<2, 256>(p, xn, w, stream);
  return launch_qkv_gemm<1, 128>(p, xn, w, stream);
}

// -- gate/up, fused_ffn's up and the down product at T > 16 in bf16 ---------

struct MlpParams {
  CUtensorMap a, b0, b1;   // A; B (the gate, or the one weight); the up
  bf16* out;               // [T, N]
  const bf16* bias;        // FFN_UP: b1 [N]; PLAIN: b [N] or null
  int T, K, N, row_tiles, col_tiles;
};

// The output tiles of MODE_GATEUP (B = wg and wu, two accumulators),
// MODE_FFN_UP or MODE_PLAIN on hopper_gemm.cuh's ring, with the epilogue
// of gemm_tile.cuh's mode in fp32 and one cast.  Persistent: block b
// takes tiles b, b + gridDim.x, ... in the order of QKV's GEMM
// (column-major inside bands of kBand row tiles), and its producer loads
// the next tile while the consumers store this one.  FFN_UP's activation
// is a template argument: with all three inlined into the unrolled
// epilogue, the relu kernel ran several times slower than the plain
// product.
template <int NC, int BN, int MODE, int ACT>
__global__ void __launch_bounds__(128 * (NC + 1),
                                  NC == 1 && MODE != MODE_GATEUP ? 2 : 1)
mlp_gemm_kernel(const __grid_constant__ MlpParams p) {
  using namespace ptt::hopper;
  constexpr int NB = MODE == MODE_GATEUP ? 2 : 1;
  using P = GemmPlan<NC, BN, kStages, NB>;
  extern __shared__ unsigned char smem_raw[];
  const auto ring = gemm_ring<NC, BN, kStages, NB>(smem_raw);
  const int tiles = p.row_tiles * p.col_tiles;
  auto origin = [&](int t, int& m0, int& n0) {
    int rt, ct;
    band_tile(t, p.row_tiles, p.col_tiles, kBand, rt, ct);
    m0 = rt * P::BM;
    n0 = ct * BN;
  };
  int it = 0, m0, n0;
  if (threadIdx.x < 128) {   // the producer warpgroup
    if constexpr (NC == 2) regs_dec<40>();
    if (threadIdx.x == 0)
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        origin(t, m0, n0);
        gemm_produce(ring, &p.a, &p.b0, m0, n0, p.K, &p.b1, it);
      }
    return;
  }
  if constexpr (NC == 2) regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4;
  float acc[BN / 2];
  float acc1[NB == 2 ? BN / 2 : 1];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    origin(t, m0, n0);
    gemm_consume(ring, p.K, c, acc, acc1, it);
    // epilogue: fp32 values, one cast, bf16 pairs from the fragment,
    // masked past T and past N
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 64 * c + 16 * w + lane / 4 + 8 * hh;
      if (row >= p.T) continue;
      uint32_t* orow = reinterpret_cast<uint32_t*>(p.out + (size_t)row * p.N);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
        if (col >= p.N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[4 * i + 2 * hh + e];
          if constexpr (MODE == MODE_GATEUP) {
            const float sg = 1.f / (1.f + expf(-v[e]));
            v[e] = (v[e] * sg) * acc1[NB == 2 ? 4 * i + 2 * hh + e : 0];
          } else {
            if (p.bias != nullptr) v[e] += __bfloat162float(p.bias[col + e]);
            if constexpr (MODE == MODE_FFN_UP) v[e] = activate(v[e], ACT);
          }
        }
        orow[col / 2] = ptt::hopper::pack_bf16(v[0], v[1]);
      }
    }
  }
}

template <int NC, int BN, int MODE, int ACT>
int launch_mlp_gemm(MlpParams& p, const void* a, const void* b0,
                    const void* b1, cudaStream_t stream) {
  constexpr int NB = MODE == MODE_GATEUP ? 2 : 1;
  using P = ptt::hopper::GemmPlan<NC, BN, kStages, NB>;
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.T};
  const uint64_t astride[1] = {(uint64_t)p.K * 2};
  const uint32_t abox[2] = {64, (uint32_t)P::BM};
  cudaError_t e = ptt::hopper::make_map(&p.a, a, 2, adims, astride, abox);
  const uint64_t bdims[2] = {(uint64_t)p.N, (uint64_t)p.K};
  const uint64_t bstride[1] = {(uint64_t)p.N * 2};
  const uint32_t bbox[2] = {64, 64};
  if (e == cudaSuccess)
    e = ptt::hopper::make_map(&p.b0, b0, 2, bdims, bstride, bbox);
  if (e == cudaSuccess && NB == 2)
    e = ptt::hopper::make_map(&p.b1, b1, 2, bdims, bstride, bbox);
  if (e != cudaSuccess) return (int)e;
  p.row_tiles = (p.T + P::BM - 1) / P::BM;
  p.col_tiles = (p.N + BN - 1) / BN;
  auto kern = mlp_gemm_kernel<NC, BN, MODE, ACT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  // as many blocks as are resident at once (two a SM for the 64-row
  // single-weight tile, else one), each walking its share of the tiles
  const int per_sm = NC == 1 && NB == 1 ? 2 : 1;
  const int grid =
      min(p.row_tiles * p.col_tiles, per_sm * ptt::hopper::sm_count());
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// C [T, N] = A [T, K] . B [K, N] with MODE's epilogue (ACT: FFN_UP's
// activation).  The tile: 128 rows x 256 columns (gate/up: 128 of each
// weight) where every SM gets two tiles; else 128 x 128 where every SM
// gets one; else 64 x 128 (a down product of few columns at a 256-row
// chunk: 128 tiles), so a chunk bound by the weight bytes still spreads
// over the card.
template <int MODE, int ACT>
int mlp_hopper(const void* a, const void* b0, const void* b1,
               const void* bias, void* out, int T, int K, int N,
               cudaStream_t stream) {
  if (K % 64 != 0 || N % 64 != 0) return (int)cudaErrorInvalidValue;
  MlpParams p{};
  p.out = static_cast<bf16*>(out);
  p.bias = static_cast<const bf16*>(bias);
  p.T = T;
  p.K = K;
  p.N = N;
  constexpr int WIDE = MODE == MODE_GATEUP ? 128 : 256;
  const int rows = (T + 127) / 128, sms = ptt::hopper::sm_count();
  if (rows * ((N + WIDE - 1) / WIDE) >= 2 * sms)
    return launch_mlp_gemm<2, WIDE, MODE, ACT>(p, a, b0, b1, stream);
  if (rows * ((N + 127) / 128) >= sms)
    return launch_mlp_gemm<2, 128, MODE, ACT>(p, a, b0, b1, stream);
  return launch_mlp_gemm<1, 128, MODE, ACT>(p, a, b0, b1, stream);
}

// -- the descriptor check of hopper.cuh ---------------------------------------

// C [64, N] fp32 = A [64, 64] . B on one warpgroup, the operands through
// TMA (128-byte swizzle) and wgmma: mode 0 takes B^T as [N, 64] (K-major,
// as flash's K rows; N = 64 is every score tile of the flash forward and
// backward: S, dP, S^T, dP^T), mode 1 B as [64, N] (MN-major, as the
// weights and flash's V), mode 2 as mode 1 with A from registers (N = 128,
// as flash's P V, dS K, P^T dO and dS^T Q), modes 3 and 4 B as [64, N]
// int8 (3) or e4m3 (4) bytes that the threads up-convert into the swizzled
// MN-major tile themselves (w8_store_sw128, as the quant matmul's prefill
// GEMM does), then the proxy fence and a barrier before wgmma reads it.
// tests/test_torch_cuda.py holds it against torch.matmul.
struct CheckParams {
  CUtensorMap a, b;
  const bf16* a_raw;
  const unsigned char* b_raw;   // modes 3, 4
  float* c;
};

template <int N, int MODE>
__global__ void __launch_bounds__(128)
wgmma_check_kernel(const __grid_constant__ CheckParams p) {
  using namespace ptt::hopper;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar;
  unsigned char* As = align1024(smem_raw);
  unsigned char* Bs = As + 8192;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, 8192 + (MODE >= 3 ? 0 : N * 128));
    tma_load_2d(As, &p.a, &bar, 0, 0);
    if (MODE == 0)
      tma_load_2d(Bs, &p.b, &bar, 0, 0);
    else if (MODE <= 2)
      for (int j = 0; j < N / 64; ++j)
        tma_load_2d(Bs + j * 8192, &p.b, &bar, 64 * j, 0);
  }
  if constexpr (MODE >= 3) {
    for (int u = threadIdx.x; u < 64 * N / 16; u += 128) {
      const int k = u / (N / 16), n = u % (N / 16) * 16;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(p.b_raw + (size_t)k * N + n);
      w8_store_sw128<MODE == 4>(Bs, k, n, raw);
    }
    fence_proxy_async();
    __syncthreads();
  }
  const int t = threadIdx.x, lane = t % 32, r0 = 16 * (t / 32) + lane / 4;
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = 16 * kk + 2 * (lane % 4);
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(p.a_raw);
    af[kk][0] = a32[(r0 * 64 + k) / 2];
    af[kk][1] = a32[((r0 + 8) * 64 + k) / 2];
    af[kk][2] = a32[(r0 * 64 + k + 8) / 2];
    af[kk][3] = a32[((r0 + 8) * 64 + k + 8) / 2];
  }
  mbar_wait(&bar, 0);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = desc_kmajor(As + 32 * kk);
    if constexpr (MODE == 0) {
      const uint64_t db = desc_kmajor(Bs + 32 * kk);
      if constexpr (N == 256) wgmma_ss_n256<0>(acc, da, db);
      else if constexpr (N == 128) wgmma_ss_n128<0>(acc, da, db);
      else wgmma_ss_n64<0>(acc, da, db);
    } else {
      const uint64_t db = desc_mnmajor(Bs + 2048 * kk, 8192);
      if constexpr (MODE == 2) wgmma_rs_n128<1>(acc, af[kk], db);
      else if constexpr (N == 256) wgmma_ss_n256<1>(acc, da, db);
      else wgmma_ss_n128<1>(acc, da, db);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p.c[(r0 + 8 * (e / 2)) * N + 8 * i + 2 * (lane % 4) + e % 2] =
          acc[4 * i + e];
}

template <int N, int MODE>
int launch_check(CheckParams& p, cudaStream_t stream) {
  auto kern = wgmma_check_kernel<N, MODE>;
  const int smem = 1024 + 8192 + N * 128;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v = (rmsnorm(x) * wn) @ (wq | wk | wv); x [T, d], wq [d, dq],
// wk/wv [d, dkv]; outputs row-major [T, dq], [T, dkv], [T, dkv].  With
// non-null xn [T, d] (x's type) and inv [T] (fp32) the training variant
// also writes the normalised rows and the inverse RMS.  bf16 at T >= 17
// needs xn in both variants (the forward variant's is a workspace) and
// runs two launches on `stream`: the row pass, then the wgmma GEMM.
int ptt_rmsnorm_qkv(int dtype, const void* x, const void* wn, const void* wq,
                    const void* wk, const void* wv, void* q, void* k, void* v,
                    void* xn, void* inv, int T, int d, int dq, int dkv,
                    float eps, void* stream) {
  if (dtype == ptt::DT_BFLOAT16 && T >= kRowPassMinT) {
    // the row pass, then the GEMM; xn is the training variant's output or
    // the forward variant's workspace, inv null in the forward variant
    if (dq % 64 != 0 || dkv % 64 != 0) return (int)cudaErrorInvalidValue;
    const void* w[3] = {wq, wk, wv};
    void* const out[3] = {q, k, v};
    return qkv_hopper(x, wn, w, out, xn, inv, T, d, dq, dkv, eps,
                      static_cast<cudaStream_t>(stream));
  }
  if (dq % BN != 0 || dkv % BN != 0 || (xn == nullptr) != (inv == nullptr))
    return (int)cudaErrorInvalidValue;
  GemmArgs g{x, wq, wk, wv, wn, q, k, v, T, d, dq, dkv, eps};
  g.xn = xn;
  g.inv = static_cast<float*>(inv);
  return launch<MODE_QKV>(dtype, g, dq + 2 * dkv, stream);
}

// h = silu(x @ wg) * (x @ wu); x [T, d], wg/wu [d, f], h [T, f].
int ptt_mlp_gate_up(int dtype, const void* x, const void* wg, const void* wu,
                    void* h, int T, int d, int f, void* stream) {
  if (dtype == ptt::DT_BFLOAT16 && T >= kRowPassMinT)
    return mlp_hopper<MODE_GATEUP, 0>(x, wg, wu, nullptr, h, T, d, f,
                                      static_cast<cudaStream_t>(stream));
  GemmArgs g{x, wg, wu, nullptr, nullptr, h, nullptr, nullptr, T, d, f, 0,
             0.f};
  return launch<MODE_GATEUP>(dtype, g, f, stream);
}

// y = a @ w (+ b); a [T, K], w [K, N], b [N] or null, y [T, N].
int ptt_matmul(int dtype, const void* a, const void* w, const void* b,
               void* y, int T, int K, int N, void* stream) {
  if (dtype == ptt::DT_BFLOAT16 && T >= kRowPassMinT)
    return mlp_hopper<MODE_PLAIN, 0>(a, w, nullptr, b, y, T, K, N,
                                     static_cast<cudaStream_t>(stream));
  GemmArgs g{a, w, nullptr, nullptr, nullptr, y, nullptr, nullptr, T, K, N, 0,
             0.f};
  g.bias = b;
  return launch<MODE_PLAIN>(dtype, g, N, stream);
}

// h = act(x @ w1 + b1); x [T, d], w1 [d, f], b1 [f], h [T, f]; act 0 relu,
// 1 exact-erf gelu, 2 silu.
int ptt_ffn_up(int dtype, const void* x, const void* w1, const void* b1,
               void* h, int T, int d, int f, int act, void* stream) {
  if (act < ACT_RELU || act > ACT_SILU || b1 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == ptt::DT_BFLOAT16 && T >= kRowPassMinT) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (act == ACT_RELU)
      return mlp_hopper<MODE_FFN_UP, ACT_RELU>(x, w1, nullptr, b1, h, T, d,
                                               f, s);
    if (act == ACT_GELU)
      return mlp_hopper<MODE_FFN_UP, ACT_GELU>(x, w1, nullptr, b1, h, T, d,
                                               f, s);
    return mlp_hopper<MODE_FFN_UP, ACT_SILU>(x, w1, nullptr, b1, h, T, d, f,
                                             s);
  }
  GemmArgs g{x, w1, nullptr, nullptr, nullptr, h, nullptr, nullptr, T, d, f, 0,
             0.f};
  g.bias = b1;
  g.act = act;
  return launch<MODE_FFN_UP>(dtype, g, f, stream);
}

// hopper.cuh's descriptor check: c [64, n] fp32 = a [64, 64] . b (bf16);
// b is [n, 64] (B^T) in mode 0, [64, n] in modes 1 and 2 (mode 2: a from
// registers, n = 128 only), [64, n] int8 (mode 3) or e4m3 (mode 4) bytes
// converted by the threads; n 128 or 256, and 64 in mode 0.
int ptt_wgmma_check(int mode, const void* a, const void* b, void* c, int n,
                    void* stream) {
  if (!((mode == 0 || mode == 1 || mode == 3 || mode == 4) &&
        (n == 128 || n == 256)) &&
      !(mode == 2 && n == 128) && !(mode == 0 && n == 64))
    return (int)cudaErrorInvalidValue;
  CheckParams p{};
  p.a_raw = static_cast<const bf16*>(a);
  p.b_raw = static_cast<const unsigned char*>(b);
  p.c = static_cast<float*>(c);
  const uint64_t adims[2] = {64, 64}, astride[1] = {128};
  const uint32_t abox[2] = {64, 64};
  cudaError_t e = ptt::hopper::make_map(&p.a, a, 2, adims, astride, abox);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode >= 3) {
    if (mode == 3) return n == 128 ? launch_check<128, 3>(p, s)
                                   : launch_check<256, 3>(p, s);
    return n == 128 ? launch_check<128, 4>(p, s) : launch_check<256, 4>(p, s);
  }
  const uint64_t bdims[2] = {mode == 0 ? 64u : (uint64_t)n,
                             mode == 0 ? (uint64_t)n : 64u};
  const uint64_t bstride[1] = {mode == 0 ? 128u : (uint64_t)n * 2};
  const uint32_t bbox[2] = {64, mode == 0 ? (uint32_t)n : 64u};
  e = ptt::hopper::make_map(&p.b, b, 2, bdims, bstride, bbox);
  if (e != cudaSuccess) return (int)e;
  if (mode == 0) return n == 64    ? launch_check<64, 0>(p, s)
                        : n == 128 ? launch_check<128, 0>(p, s)
                                   : launch_check<256, 0>(p, s);
  if (mode == 1) return n == 128 ? launch_check<128, 1>(p, s)
                                 : launch_check<256, 1>(p, s);
  return launch_check<128, 2>(p, s);
}

}  // extern "C"
