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
// The first design, kept for QKV's training variant at T <= 16 and for
// fp32 at T <= 16: at decode (T = 8 rows) the weights are read once for very few
// operations, so the launch is bound by device-memory bytes.  The tile
// keeps several 64-deep weight tiles in flight per block through a cp.async
// ring (6 stages for 16-row tiles, 3 for 64-row tiles; rows past T are
// zero-filled), so each block streams its weight columns without waiting on
// every load.  Row tiles are 16 rows at decode (one wmma row); past 16 rows
// bf16 is the wgmma GEMM and fp32 3xTF32 (below).  bf16 runs on the tensor cores through nvcuda::wmma
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
// RMSNorm+QKV in bf16 at T <= 16 (decode steps; the forward variant) is
// split-K (splitk.cuh's design): every weight byte is read once for 2 T
// operations, so the launch is bound by the weight bytes (50.3 MB at
// Llama-3-8B width: 15 us at 3.35 TB/s), and the wmma tile's 96 blocks,
// each walking all of K, left most of the card idle.  Two launches of one
// C call, as at T > 16: the row pass (qkv_decode_rows_kernel, a block a
// row) writes xn = ((x * inv) * wn) cast to bf16, _qkv_reference's cast
// point, to a [T, d] workspace; then qkv_splitk_kernel.  (Recomputing the inverse RMS in
// every block instead would make each of the ~500 blocks read all T rows
// of x: 34 MB from L2 at T = 8, more than half the weight bytes.)  The
// column tiles (128 wide) walk q | k | v, each inside one part (a part's
// last tile may be partial: TMA zero-fills the columns past it and the
// stores mask them); K is split by qkv_splits, which aims at four blocks
// a SM (the blocks all resident in one wave, and every SM holding the
// same number): 48 tiles x 11 splits at Llama-3-8B width on 132 SMs.
// Each warp streams its [16 rows][128 columns] bf16 weight boxes by TMA
// through a ring of its own (QkvPlan's STAGES slots, one mbarrier each); a
// lane's A fragments for the 8 m-tiles of a k16 step are words of rows
// 4q .. 4q + 3 at columns 16 g .. 16 g + 15, paired across rows by byte
// permutes.  The splits' fp32 partials are summed in split order by the
// last block of each column tile (its own tickets, not the quant
// matmul's), so two calls give the same bits.
// The training variant at T <= 16, and fp32 at T <= 16, keep the wmma /
// fp32 tile below, as one launch.
//
// The MLP and fused_ffn in bf16 at T <= 16 (decode steps; Llama-3-8B's MLP
// reads 352 MB of weights, 0.105 ms at 3.35 TB/s) are split-K too, two
// launches of one C call (ptt_mlp) with h [T, f] between them, each on
// splitk.cuh's strip stream (mlp_splitk_kernel): a block owns 256 output
// columns, a 64-column strip a warp, and one K split; each warp streams
// [64 k][64 n] boxes (gate/up: one of each weight a slot) with the tokens'
// box of the same 64-deep slice, all with the 128-byte swizzle, through a
// ring of its own (three or five slots, 45-54 KB), fragments relabelled so
// that no shared-memory read conflicts.  mlp_splits aims at one wave of a block a
// SM (gate/up: 56 tiles x 2 splits, down: 16 x 8 at Llama-3-8B width on
// 132 SMs).  Every block writes an fp32 partial; the last block of a tile
// (its own tickets, not QKV's or the quant matmul's) sums them in split
// order and only then applies the epilogue, since silu and the FFN's
// activations are not linear: h = silu(g) * u, or act(u + b1), cast once;
// the down product adds its bias to the merged sum before the one cast.
// Two calls give the same bits.
//
// fp32 at T > 16 (AMP O1's gray QKV and MLP in an fp32 model, fp32
// training and scoring) is 3xTF32 on wgmma (tf32x3.cuh says why three TF32
// products and what bounds them: 165 TFLOP/s for the products, 3.35 TB/s
// for the split pre-pass), on the same ring roles as bf16 with four boxes
// a slot, since tf32 wgmma reads both operands K-major only:
//   RMSNorm+QKV (qkv_tf32x3): the three weights' W^T hi / lo (one
//     tf32_split_t_kernel launch), the row pass (qkv_rows_kernel<float>:
//     xn in x's type, fp32 here, the cast point of _qkv_reference, and
//     inv, in the training variant; xn's TF32 hi and lo always), then the
//     GEMM over q | k | v (tf32x3_gemm_kernel, MODE_QKV, fp32 stores);
//   the MLP / fused_ffn (mlp_tf32x3): W1 (gated: Wg's and Wu's rows
//     interleaved in groups of 64, so one B tile holds g and u of the same
//     64 outputs) and W2 split in one launch, x split (tf32_split_kernel),
//     the up product whose epilogue writes h's hi and lo straight into the
//     down product's operand workspaces (silu(g) * u, or act(u + b1), on
//     the fp32 sums; h itself is never written), then the down product
//     (+ b2).
// 128 x 128 tiles where every SM gets one, else 64 rows; persistent, the
// tiles walked in bands of 4 row tiles (kTf32Band: the split A rows are
// twice bf16's bytes twice over, and a band of 16 outgrew L2).
//
// fp16 (AMP float16) at T > 16 runs the bf16 designs above with the
// element type a template argument (qkv_hopper<E>, mlp_hopper_pair<E>:
// the row pass in E, wgmma's f16 products, TMA's FLOAT16 maps, the
// epilogue's one round-to-nearest cast).  A value past 65504 (h =
// silu(g) u under a large activation, say) becomes inf as JAX's
// astype(float16) makes it: nothing saturates.  fp16 at T <= 16 (decode
// rows: split-K, and the training variant's tile) has no kernel and the
// wrapper raises (ROADMAP.md, queue 1, item 11).
//
#include "gemm_tile.cuh"
#include "hopper_gemm.cuh"
#include "rmsnorm_row.cuh"
#include "splitk.cuh"
#include "tf32x3.cuh"

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
  // (bf16 and fp16 past 16 rows are qkv_hopper's and mlp_hopper's)
  if (g.T <= 16) return launch_bm<T, 16, MODE>(g, ncols, stream);
  if constexpr (sizeof(T) == 2)
    return (int)cudaErrorInvalidValue;
  else
    return launch_bm<T, 64, MODE>(g, ncols, stream);
}

// bf16 takes the tile in QKV's training variant only (at T <= 16; every
// other bf16 launch is split-K or wgmma)
template <int MODE>
int launch(int dtype, const GemmArgs& g, int ncols, void* stream) {
  if (g.T <= 0 || g.K % BK != 0 || ncols % BN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (MODE == MODE_QKV)
    if (dtype == ptt::DT_BFLOAT16)
      return launch_t<__nv_bfloat16, MODE>(g, ncols, s);
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

// bf16: xn (and inv); fp32 (SPLIT, the 3xTF32 path): also xn's TF32 hi
// and lo, and xn itself only where the training variant asks for it
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(ptt::norm::NT)
qkv_rows_kernel(const T* x, const T* wn, T* xn, float* inv, float* hi,
                float* lo, int rows, int d, float eps) {
  const int r = blockIdx.x * ptt::norm::ROWS + threadIdx.x / 32;
  if (r >= rows) return;
  ptt::norm::rmsnorm_row<T, true, false, SPLIT>(x, nullptr, wn, xn, nullptr,
                                                inv, r, d, eps, hi, lo);
}

struct QkvParams {
  CUtensorMap xn, wq, wk, wv;   // A, and B of each column part
  void* out[3];                 // q, k, v (E)
  int n[3];                     // dq, dkv, dkv
  int tiles[3];                 // column tiles of each part
  int T, K, row_tiles;
};

// E: the operands' type (bf16 or fp16)
template <typename E, int NC, int BN>
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
  gemm_consume<E>(ring, p.K, c, acc);
  // epilogue: one cast, E pairs from the fragment, masked past T and past
  // the part's width
  const int t = threadIdx.x % 128, lane = t % 32;
  const int n = p.n[part];
  E* out = static_cast<E*>(p.out[part]);
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
            Elem<E>::pack(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    }
  }
}

template <typename E, int NC, int BN>
int launch_qkv_gemm(QkvParams& p, const void* xn, const void* const w[3],
                    cudaStream_t stream) {
  using P = ptt::hopper::GemmPlan<NC, BN, kStages>;
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.T};
  const uint64_t astride[1] = {(uint64_t)p.K * 2};
  const uint32_t abox[2] = {64, (uint32_t)P::BM};
  cudaError_t e =
      ptt::hopper::make_map<E>(&p.xn, xn, 2, adims, astride, abox);
  CUtensorMap* maps[3] = {&p.wq, &p.wk, &p.wv};
  for (int i = 0; i < 3 && e == cudaSuccess; ++i) {
    const uint64_t dims[2] = {(uint64_t)p.n[i], (uint64_t)p.K};
    const uint64_t stride[1] = {(uint64_t)p.n[i] * 2};
    const uint32_t box[2] = {64, 64};
    e = ptt::hopper::make_map<E>(maps[i], w[i], 2, dims, stride, box);
    p.tiles[i] = (p.n[i] + BN - 1) / BN;
  }
  if (e != cudaSuccess) return (int)e;
  p.row_tiles = (p.T + P::BM - 1) / P::BM;
  auto kern = qkv_gemm_kernel<E, NC, BN>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.row_tiles * (p.tiles[0] + p.tiles[1] + p.tiles[2]);
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// E: bf16 or fp16, every operand (the norm weight too)
template <typename E>
int qkv_hopper(const void* x, const void* wn, const void* const w[3],
               void* const out[3], void* xn, void* inv, int T, int d, int dq,
               int dkv, float eps, cudaStream_t stream) {
  if (xn == nullptr || d % 64 != 0) return (int)cudaErrorInvalidValue;
  constexpr int ROWS = ptt::norm::ROWS;
  qkv_rows_kernel<E, false>
      <<<(T + ROWS - 1) / ROWS, ptt::norm::NT, 0, stream>>>(
          static_cast<const E*>(x), static_cast<const E*>(wn),
          static_cast<E*>(xn), static_cast<float*>(inv), nullptr, nullptr,
          T, d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  QkvParams p{};
  for (int i = 0; i < 3; ++i) p.out[i] = out[i];
  p.n[0] = dq;
  p.n[1] = p.n[2] = dkv;
  p.T = T;
  p.K = d;
  // 128 x 256 tiles where they give every SM two, else 64 x 128 (more
  // blocks for short T)
  const int big =
      (T + 127) / 128 * ((dq + 255) / 256 + 2 * ((dkv + 255) / 256));
  if (big >= 2 * ptt::hopper::sm_count())
    return launch_qkv_gemm<E, 2, 256>(p, xn, w, stream);
  return launch_qkv_gemm<E, 1, 128>(p, xn, w, stream);
}

// -- RMSNorm+QKV at T <= 16 in bf16: split-K --------------------------------

using namespace ptt::splitk;
constexpr int kQkvSplitFactor = 4;   // blocks per SM the splits aim at

// k16 steps (4 KB boxes) in flight per warp: three for up to 8 tokens,
// two for 16, so that four blocks fit on a SM with their xn rows
template <int NT8>
struct QkvPlan {
  static constexpr int STAGES = NT8 == 1 ? 3 : 2;
  static constexpr int RING = STAGES * kSkWarps * 4096;   // 48 / 32 KB
  static_assert(RING >= kSkWarps * 8 * NT8 * kSkBN * 4,
                "the warps' sums reuse the ring");
};

// the row pass at decode rows: one block a row, every thread's loads in
// flight at once (qkv_rows_kernel's warp a row walks it in dependent
// steps); xn = ((x * inv) * wn) cast to bf16, inv in fp32
constexpr int kRowThreads = 512;

__global__ void __launch_bounds__(kRowThreads)
qkv_decode_rows_kernel(const bf16* x, const bf16* wn, bf16* xn, int d,
                       float eps) {
  __shared__ float part[kRowThreads / 32];
  __shared__ float inv_s;
  const int tid = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int c = 8 * tid; c < d; c += 8 * kRowThreads) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + off + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = ptt::to_f(e[i]);
      ss += v * v;
    }
  }
  ss = ptt::warp_sum(ss);
  if (tid % 32 == 0) part[tid / 32] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) t += part[w];
    inv_s = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float iv = inv_s;
  for (int c = 8 * tid; c < d; c += 8 * kRowThreads) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + off + c);
    const uint4 wv = *reinterpret_cast<const uint4*>(wn + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    const bf16* we = reinterpret_cast<const bf16*>(&wv);
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      oe[i] = __float2bfloat16((ptt::to_f(e[i]) * iv) * ptt::to_f(we[i]));
    *reinterpret_cast<uint4*>(xn + off + c) = o;
  }
}

// the 128-column tiles of q | k | v, each inside one part
inline int qkv_tiles(int dq, int dkv) {
  return (dq + kSkBN - 1) / kSkBN + 2 * ((dkv + kSkBN - 1) / kSkBN);
}

inline int qkv_splits(int d, int dq, int dkv, int sms) {
  return splitk_splits(d, qkv_tiles(dq, dkv) * kSkBN, sms, kQkvSplitFactor);
}

struct QkvSplitArgs {
  CUtensorMap w[3];   // wq, wk, wv: boxes of 16 rows x 128 columns
  const bf16* xn;     // [T, K], the row pass's
  bf16* out[3];       // q, k, v
  float* ws;          // [splits, T, tiles * 128] fp32 partials
  int* tickets;       // one per column tile, 0 between launches
  int n[3], tiles[3];
  int T, K, splits;
};

// NT8 n8 tiles of tokens (1: T <= 8, 2: T <= 16); quant_matmul.cu's
// quant_splitk_kernel gives the fragment map: m-tile j's rows g and g + 8
// are columns 16 g + 2 j and 16 g + 2 j + 1, reduction indices 2 q + e
// and 2 q + 8 + e are k = 4 q + e and 4 q + 2 + e.  A box row is 128
// bf16 (256 bytes); word j of a lane's 32 bytes of row 4 q + i holds
// columns 16 g + 2 j (low half) and 16 g + 2 j + 1 (high half).
template <int NT8>
__global__ void __launch_bounds__(kSkWarps * 32)
qkv_splitk_kernel(const __grid_constant__ QkvSplitArgs p) {
  using namespace ptt::hopper;
  constexpr int NTOK = 8 * NT8;
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = QkvPlan<NT8>::STAGES;
  __shared__ uint64_t bars[kSkWarps][STAGES];
  unsigned char* smem = align1024(smem_raw);   // TMA boxes: aligned
  const int tile = blockIdx.x, split = blockIdx.y;
  int part = 0, ct = tile;
  while (part < 2 && ct >= p.tiles[part]) ct -= p.tiles[part++];
  const int n0 = ct * kSkBN;   // the tile's first column in its part
  const int slices = p.K / 64;
  const int s0 = split * slices / p.splits;
  const int steps = (split + 1) * slices / p.splits - s0;   // per warp
  const int k0 = 64 * s0, depth = 64 * steps;
  const int xstride = 2 * depth + 32;   // bytes; 32 spreads the rows' banks
  unsigned char* xs = smem + QkvPlan<NT8>::RING;   // [NTOK][xstride] xn
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  unsigned char* ring = smem + warp * (STAGES * 4096);   // this warp's
  uint64_t* bar = bars[warp];
  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncwarp();
  // step j of this warp: rows k0 + 64 j + 16 warp .. + 15 of the tile's
  // 128 columns (past the part's width: zeros from TMA)
  auto load = [&](int j) {
    const int s = j % STAGES;
    mbar_expect_tx(&bar[s], 4096);
    tma_load_2d(ring + s * 4096, &p.w[part], &bar[s], n0,
                k0 + 64 * j + 16 * warp);
  };
  if (lane == 0)
    for (int j = 0; j < STAGES && j < steps; ++j) load(j);
  // the xn rows of this split (rows past T zero), 16 bytes a thread
#pragma unroll
  for (int r = 0; r < NTOK; ++r) {
    const bool ok = r < p.T;
    for (int kc = 8 * tid; kc < depth; kc += 8 * kSkWarps * 32)
      ptt::cp_async16(xs + r * xstride + 2 * kc,
                      ok ? p.xn + (size_t)r * p.K + k0 + kc : p.xn, ok);
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
    const int s = j % STAGES;
    mbar_wait(&bar[s], (j / STAGES) & 1);
    const unsigned char* box = ring + s * 4096;
    uint4 r[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        r[i][h] = *reinterpret_cast<const uint4*>(box + (4 * q + i) * 256 +
                                                  32 * g + 16 * h);
    // word m of row 4 q + i (m a constant once unrolled)
    auto word = [&](int i, int m) -> uint32_t {
      const uint4& v = r[i][m / 4];
      return m % 4 == 0 ? v.x : m % 4 == 1 ? v.y : m % 4 == 2 ? v.z : v.w;
    };
    __syncwarp();   // every lane has read the slot: refill it
    if (lane == 0 && j + STAGES < steps) {
      fence_proxy_async();
      load(j + STAGES);
    }
    const int kl = 64 * j + 16 * warp + 4 * q;
    uint2 b[NT8];
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      b[nt] = *reinterpret_cast<const uint2*>(xs + (8 * nt + g) * xstride +
                                              2 * kl);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const uint32_t a0 = __byte_perm(word(0, m), word(1, m), 0x5410);
      const uint32_t a1 = __byte_perm(word(0, m), word(1, m), 0x7632);
      const uint32_t a2 = __byte_perm(word(2, m), word(3, m), 0x5410);
      const uint32_t a3 = __byte_perm(word(2, m), word(3, m), 0x7632);
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
        mma_bf16_16816(d[m][nt], a0, a1, a2, a3, b[nt].x, b[nt].y);
    }
  }
  __syncthreads();   // every warp is done with the ring: it holds the sums
  const int n = n0 + tid;   // this thread's column in its part
  const int ldo = p.n[part];
  bf16* out = p.out[part];
  splitk_finish<NT8>(d, smem, p.T, split, p.splits, p.ws,
                     (p.tiles[0] + p.tiles[1] + p.tiles[2]) * kSkBN,
                     tile * kSkBN + tid, n < ldo, &p.tickets[tile],
                     [&](int t, float v) {
                       out[(size_t)t * ldo + n] = __float2bfloat16(v);
                     });
}

template <int NT8>
int launch_qkv_splitk(const QkvSplitArgs& a, cudaStream_t stream) {
  auto kern = qkv_splitk_kernel<NT8>;
  const int slices = a.K / 64;
  const int deepest = 64 * ((slices + a.splits - 1) / a.splits);
  constexpr int RING = QkvPlan<NT8>::RING;
  const int smem = 1024 + RING + 8 * NT8 * (2 * deepest + 32);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      1024 + RING + 8 * NT8 * (2 * kMaxSplitDepth + 32));
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.tiles[0] + a.tiles[1] + a.tiles[2], a.splits);
  kern<<<grid, kSkWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the row pass into xn, then split-K over it: two launches on `stream`
int qkv_splitk(const void* x, const void* wn, const void* const w[3],
               void* const out[3], void* xn, void* ws, void* tickets, int T,
               int d, int dq, int dkv, float eps, cudaStream_t stream) {
  if (xn == nullptr || d % 64 != 0) return (int)cudaErrorInvalidValue;
  QkvSplitArgs a{};
  a.xn = static_cast<const bf16*>(xn);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.n[0] = dq;
  a.n[1] = a.n[2] = dkv;
  a.T = T;
  a.K = d;
  a.splits = qkv_splits(d, dq, dkv, ptt::hopper::sm_count());
  if (a.splits > 1 && (ws == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    a.out[i] = static_cast<bf16*>(out[i]);
    a.tiles[i] = (a.n[i] + kSkBN - 1) / kSkBN;
    const uint64_t dims[2] = {(uint64_t)a.n[i], (uint64_t)d};
    const uint64_t stride[1] = {(uint64_t)a.n[i] * 2};
    const uint32_t box[2] = {kSkBN, 16};
    cudaError_t e = ptt::hopper::encode(
        &a.w[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_NONE,
        w[i], 2, dims, stride, box);
    if (e != cudaSuccess) return (int)e;
  }
  qkv_decode_rows_kernel<<<T, kRowThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wn),
      static_cast<bf16*>(xn), d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return T <= 8 ? launch_qkv_splitk<1>(a, stream)
                : launch_qkv_splitk<2>(a, stream);
}

// -- the MLP and fused_ffn at T <= 16 in bf16: split-K on the strip stream --

constexpr int kMlpBN = 256;   // output columns a block: a strip a warp

// A warp's ring: STAGES slots, each a [64][64] box of every weight (NB)
// and the tokens' [8 NT8][64] box of the same slice
template <int NB, int NT8>
struct MlpPlan {
  static constexpr int STAGES = NB == 2 ? 3 : 5;
  static constexpr int X_BYTES = 8 * NT8 * 128;
  static constexpr int SLOT = NB * 8192 + X_BYTES;
  static constexpr int RING = STAGES * SLOT;           // a warp's
  static constexpr int SMEM = 1024 + kSkWarps * RING;  // 1 KB: alignment
  static_assert(SMEM <= 232448, "the block's rings fit shared memory");
};

// The K splits of one MLP launch: one wave of a block a SM where the
// column tiles leave room (the rings take most of a SM's shared memory),
// never more splits than 64-deep slices
inline int mlp_splits(int K, int N, int sms) {
  const int tiles = (N + kMlpBN - 1) / kMlpBN;
  return min(max(1, sms / tiles), K / 64);
}

struct MlpSplitArgs {
  CUtensorMap w[2];   // the weight (gate/up: the gate, then the up)
  CUtensorMap x;      // [T, K]: boxes of 8 NT8 rows x 64
  const bf16* bias;   // FFN_UP: b1 [N]; PLAIN: b [N] or null
  bf16* out;          // [T, N]
  float* ws;          // fp32 partials, [splits][NB][tiles][warp][f][lane][4]
  int* tickets;       // one per column tile, 0 between launches
  int T, K, N, splits;
};

// One product of the MLP (MODE_GATEUP: x @ Wg and x @ Wu, NB = 2),
// fused_ffn's up (MODE_FFN_UP, ACT) or either's down (MODE_PLAIN) at NTOK
// = 8 NT8 tokens: a block owns a 256-column tile and one K split; warp w
// streams the tile's strip w (64 columns) through its own ring, a [64][64]
// box of each weight and the slice's token box a slot, on one mbarrier
// (splitk.cuh says how the fragments read them).  Every block writes its
// fp32 partial in fragment order (lane l's accumulators of m-tile m and
// n-tile nt, f = NT8 m + nt, as one float4 at [f][l]: each store and load
// is 512 contiguous bytes a warp); the last of a tile's splits to arrive
// has every thread sum its own fragments over the splits in split order
// and only then apply the epilogue: silu(g) * u, act(u + b1) or + b, one
// cast.  Launched as a dependent of the previous kernel (the down product
// after gate/up), a block loads its first weight boxes before it waits for
// that kernel: the token rows, the workspace and the tickets are its.
template <int MODE, int ACT, int NT8>
__global__ void __launch_bounds__(kSkWarps * 32)
mlp_splitk_kernel(const __grid_constant__ MlpSplitArgs p) {
  using namespace ptt::hopper;
  constexpr int NB = MODE == MODE_GATEUP ? 2 : 1;
  constexpr int NTOK = 8 * NT8;
  using P = MlpPlan<NB, NT8>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[kSkWarps][P::STAGES];
  unsigned char* smem = align1024(smem_raw);   // TMA boxes: aligned
  const int tile = blockIdx.x, split = blockIdx.y;
  const int slices = p.K / 64;
  const int s0 = split * slices / p.splits;
  const int k0 = 64 * s0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = tile * kMlpBN + 64 * warp;   // this warp's strip
  // N is a multiple of 64: a strip lies wholly inside the matrix or
  // wholly past it (the last tile's), and one past it streams nothing
  const int steps =
      n0 < p.N ? (split + 1) * slices / p.splits - s0 : 0;
  unsigned char* ring = smem + warp * P::RING;
  uint64_t* bar = bars[warp];
  if (lane == 0) {
    for (int s = 0; s < P::STAGES; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncwarp();
  griddep_launch();
  // slice j of the split: rows k0 + 64 j .. + 63 of the strip (columns
  // past N and token rows past T: zeros from TMA); the slot's barrier
  // expects the weight and token boxes both
  auto load_w = [&](int j) {
    const int s = j % P::STAGES;
    mbar_expect_tx(&bar[s], P::SLOT);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_load_2d(ring + s * P::SLOT + nb * 8192, &p.w[nb], &bar[s], n0,
                  k0 + 64 * j);
  };
  auto load_x = [&](int j) {
    const int s = j % P::STAGES;
    tma_load_2d(ring + s * P::SLOT + NB * 8192, &p.x, &bar[s], k0 + 64 * j,
                0);
  };
  if (lane == 0)
    for (int j = 0; j < P::STAGES && j < steps; ++j) load_w(j);
  griddep_wait();
  if (lane == 0)
    for (int j = 0; j < P::STAGES && j < steps; ++j) load_x(j);
  int off[4];
  strip_offsets(lane, off);
  float d[NB][4][NT8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nb][m][nt][e] = 0.f;
  for (int j = 0; j < steps; ++j) {
    const int s = j % P::STAGES;
    mbar_wait(&bar[s], (j / P::STAGES) & 1);
    const unsigned char* slot = ring + s * P::SLOT;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      strip_box<NT8>(d[nb], slot + nb * 8192, slot + NB * 8192, off, lane);
    __syncwarp();   // every lane has read the slot: refill it
    if (lane == 0 && j + P::STAGES < steps) {
      fence_proxy_async();
      load_w(j + P::STAGES);
      load_x(j + P::STAGES);
    }
  }
  // the block's partial, in fragment order
  constexpr int FR = 4 * NT8;   // float4 fragments a lane, per weight
  const int tiles = gridDim.x;
  auto part = [&](int s, int nb) {
    return reinterpret_cast<float4*>(p.ws) +
           ((size_t)((s * NB + nb) * tiles + tile) * kSkWarps + warp) * FR *
               32 +
           lane;
  };
  if (steps > 0)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
          part(split, nb)[(NT8 * m + nt) * 32] =
              make_float4(d[nb][m][nt][0], d[nb][m][nt][1], d[nb][m][nt][2],
                          d[nb][m][nt][3]);
  if (!splitk_arrive(&p.tickets[tile], p.splits) || steps == 0) return;
  // the last block: each thread its own fragments, the splits' partials in
  // split order (ROUND splits' loads in flight at once, 16 float4)
  constexpr int ROUND = 4 / (NB * NT8);
  float4 acc[NB][FR];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int f = 0; f < FR; ++f) acc[nb][f] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < p.splits; s += ROUND) {
    float4 v[ROUND][NB][FR];
#pragma unroll
    for (int i = 0; i < ROUND; ++i)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int f = 0; f < FR; ++f)
          v[i][nb][f] = s + i < p.splits ? __ldcg(part(s + i, nb) + f * 32)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < ROUND; ++i)
      if (s + i < p.splits)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int f = 0; f < FR; ++f) {
            acc[nb][f].x += v[i][nb][f].x;
            acc[nb][f].y += v[i][nb][f].y;
            acc[nb][f].z += v[i][nb][f].z;
            acc[nb][f].w += v[i][nb][f].w;
          }
  }
  // fragment (m, nt): (x, y) are column 8 sv + 2 m, tokens 8 nt + 2 q and
  // + 1; (z, w) the next column, the same tokens
  const int q = lane % 4;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int col = n0 + 8 * strip_unit(lane) + 2 * m;
    float b[2] = {0.f, 0.f};
    if (MODE != MODE_GATEUP && p.bias != nullptr) {
      b[0] = __bfloat162float(p.bias[col]);
      b[1] = __bfloat162float(p.bias[col + 1]);
    }
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * nt + 2 * q + e;
        if (t >= p.T) continue;
        const float4& a = acc[0][NT8 * m + nt];
        float o[2] = {e == 0 ? a.x : a.y, e == 0 ? a.z : a.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (MODE == MODE_GATEUP) {
            const float4& u = acc[NB - 1][NT8 * m + nt];
            const float sg = 1.f / (1.f + expf(-o[h]));
            o[h] = (o[h] * sg) * (h == 0 ? (e == 0 ? u.x : u.y)
                                         : (e == 0 ? u.z : u.w));
          } else {
            if (p.bias != nullptr) o[h] += b[h];
            if constexpr (MODE == MODE_FFN_UP) o[h] = activate(o[h], ACT);
          }
        }
        *reinterpret_cast<uint32_t*>(p.out + (size_t)t * p.N + col) =
            ptt::hopper::pack_bf16(o[0], o[1]);
      }
  }
}

template <int MODE, int ACT, int NT8>
int launch_mlp_splitk(MlpSplitArgs& a, const void* x, bool dependent,
                      cudaStream_t stream) {
  using P = MlpPlan<MODE == MODE_GATEUP ? 2 : 1, NT8>;
  const uint64_t dims[2] = {(uint64_t)a.K, (uint64_t)a.T};
  const uint64_t stride[1] = {(uint64_t)a.K * 2};
  const uint32_t box[2] = {64, 8 * NT8};
  cudaError_t e = ptt::hopper::make_map(&a.x, x, 2, dims, stride, box);
  if (e != cudaSuccess) return (int)e;
  auto kern = mlp_splitk_kernel<MODE, ACT, NT8>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           P::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kMlpBN - 1) / kMlpBN, a.splits);
  cfg.blockDim = dim3(kSkWarps * 32);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kern, a);
}

// out [T, N] = epilogue(x [T, K] . w0 (and . w1)): one split-K launch,
// dependent (a programmatic dependent launch) on the kernel before it in
// `stream` where `dependent`; ws holds ws_floats fp32 values, at least
// splits * NB * tiles * 256 * NTOK (NTOK = 8 at T <= 8, else 16)
template <int MODE, int ACT>
int mlp_splitk(const void* x, const void* w0, const void* w1,
               const void* bias, void* out, void* ws, long long ws_floats,
               void* tickets, int T, int K, int N, bool dependent,
               cudaStream_t stream) {
  constexpr int NB = MODE == MODE_GATEUP ? 2 : 1;
  MlpSplitArgs a{};
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.T = T;
  a.K = K;
  a.N = N;
  a.splits = mlp_splits(K, N, ptt::hopper::sm_count());
  const long long tiles = (N + kMlpBN - 1) / kMlpBN;
  const int ntok = T <= 8 ? 8 : 16;
  if (ws == nullptr || tickets == nullptr ||
      (long long)a.splits * NB * tiles * kMlpBN * ntok > ws_floats)
    return (int)cudaErrorInvalidValue;
  const uint64_t dims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t stride[1] = {(uint64_t)N * 2};
  const uint32_t box[2] = {64, 64};
  const void* w[2] = {w0, w1};
  for (int i = 0; i < NB; ++i) {
    cudaError_t e = ptt::hopper::make_map(&a.w[i], w[i], 2, dims, stride, box);
    if (e != cudaSuccess) return (int)e;
  }
  return T <= 8 ? launch_mlp_splitk<MODE, ACT, 1>(a, x, dependent, stream)
                : launch_mlp_splitk<MODE, ACT, 2>(a, x, dependent, stream);
}

// -- gate/up, fused_ffn's up and the down product at T > 16 in bf16 ---------

struct MlpParams {
  CUtensorMap a, b0, b1;   // A; B (the gate, or the one weight); the up
  void* out;               // [T, N], E
  const void* bias;        // E; FFN_UP: b1 [N]; PLAIN: b [N] or null
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
// product.  E: the operands' type (bf16 or fp16).
template <typename E, int NC, int BN, int MODE, int ACT>
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
    gemm_consume<E>(ring, p.K, c, acc, acc1, it);
    // epilogue: fp32 values, one cast, E pairs from the fragment, masked
    // past T and past N
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 64 * c + 16 * w + lane / 4 + 8 * hh;
      if (row >= p.T) continue;
      uint32_t* orow = reinterpret_cast<uint32_t*>(static_cast<E*>(p.out) +
                                                   (size_t)row * p.N);
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
            if (p.bias != nullptr)
              v[e] += Elem<E>::to(static_cast<const E*>(p.bias)[col + e]);
            if constexpr (MODE == MODE_FFN_UP) v[e] = activate(v[e], ACT);
          }
        }
        orow[col / 2] = Elem<E>::pack(v[0], v[1]);
      }
    }
  }
}

template <typename E, int NC, int BN, int MODE, int ACT>
int launch_mlp_gemm(MlpParams& p, const void* a, const void* b0,
                    const void* b1, cudaStream_t stream) {
  constexpr int NB = MODE == MODE_GATEUP ? 2 : 1;
  using P = ptt::hopper::GemmPlan<NC, BN, kStages, NB>;
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.T};
  const uint64_t astride[1] = {(uint64_t)p.K * 2};
  const uint32_t abox[2] = {64, (uint32_t)P::BM};
  cudaError_t e = ptt::hopper::make_map<E>(&p.a, a, 2, adims, astride, abox);
  const uint64_t bdims[2] = {(uint64_t)p.N, (uint64_t)p.K};
  const uint64_t bstride[1] = {(uint64_t)p.N * 2};
  const uint32_t bbox[2] = {64, 64};
  if (e == cudaSuccess)
    e = ptt::hopper::make_map<E>(&p.b0, b0, 2, bdims, bstride, bbox);
  if (e == cudaSuccess && NB == 2)
    e = ptt::hopper::make_map<E>(&p.b1, b1, 2, bdims, bstride, bbox);
  if (e != cudaSuccess) return (int)e;
  p.row_tiles = (p.T + P::BM - 1) / P::BM;
  p.col_tiles = (p.N + BN - 1) / BN;
  auto kern = mlp_gemm_kernel<E, NC, BN, MODE, ACT>;
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
// over the card.  E: bf16 or fp16, every operand.
template <typename E, int MODE, int ACT>
int mlp_hopper(const void* a, const void* b0, const void* b1,
               const void* bias, void* out, int T, int K, int N,
               cudaStream_t stream) {
  if (K % 64 != 0 || N % 64 != 0) return (int)cudaErrorInvalidValue;
  MlpParams p{};
  p.out = out;
  p.bias = bias;
  p.T = T;
  p.K = K;
  p.N = N;
  constexpr int WIDE = MODE == MODE_GATEUP ? 128 : 256;
  const int rows = (T + 127) / 128, sms = ptt::hopper::sm_count();
  if (rows * ((N + WIDE - 1) / WIDE) >= 2 * sms)
    return launch_mlp_gemm<E, 2, WIDE, MODE, ACT>(p, a, b0, b1, stream);
  if (rows * ((N + 127) / 128) >= sms)
    return launch_mlp_gemm<E, 2, 128, MODE, ACT>(p, a, b0, b1, stream);
  return launch_mlp_gemm<E, 1, 128, MODE, ACT>(p, a, b0, b1, stream);
}

// both products of the MLP (gated: wu non-null) or of fused_ffn (act) at
// T > 16 on the ring, h [T, f] between them, in E
template <typename E>
int mlp_hopper_pair(int act, const void* x, const void* w1, const void* wu,
                    const void* w2, const void* b1, const void* b2, void* h,
                    void* y, int T, int d, int f, cudaStream_t s) {
  int e = wu != nullptr
      ? mlp_hopper<E, MODE_GATEUP, 0>(x, w1, wu, nullptr, h, T, d, f, s)
      : act == ACT_RELU
          ? mlp_hopper<E, MODE_FFN_UP, ACT_RELU>(x, w1, nullptr, b1, h, T,
                                                 d, f, s)
      : act == ACT_GELU
          ? mlp_hopper<E, MODE_FFN_UP, ACT_GELU>(x, w1, nullptr, b1, h, T,
                                                 d, f, s)
          : mlp_hopper<E, MODE_FFN_UP, ACT_SILU>(x, w1, nullptr, b1, h, T,
                                                 d, f, s);
  if (e == 0)
    e = mlp_hopper<E, MODE_PLAIN, 0>(h, w2, nullptr, b2, y, T, f, d, s);
  return e;
}

// -- fp32 at T > 16: 3xTF32 on wgmma (tf32x3.cuh) ----------------------------

struct Tf32Params {
  ptt::tf32x3::Tf32Maps m;   // A split; B^T split
  float* out[3];   // QKV: q, k, v; PLAIN: y; GATEUP, FFN_UP: h's hi, lo
  int n[3];        // each part's output columns (QKV: dq, dkv, dkv; else N)
  int boff[3];     // each part's first row of B^T (QKV: 0, dq, dq + dkv)
  int tiles[3];    // each part's column tiles
  const float* bias;   // FFN_UP: b1 [N]; PLAIN: b [N] or null
  int T, K, row_tiles, col_tiles;
};

// row tiles a band of the 3xTF32 walk covers: the A rows of a band
// (4 x 128 rows x K x hi and lo: 16.8 MB at K = 4096) stay in L2 while the
// band's column tiles pass; bands of 16, the bf16 ring's, did not fit and
// ran the MLP's products markedly slower on an H100 (tf32_band_sweep.py
// builds this file with -DPTT_TF32_BAND=n for each band it times)
#ifndef PTT_TF32_BAND
#define PTT_TF32_BAND 4
#endif
constexpr int kTf32Band = PTT_TF32_BAND;

// The output tiles of MODE_QKV (the columns of q | k | v, a tile inside
// one part), MODE_GATEUP (B^T the gate's and the up's rows interleaved in
// groups of 64: a tile's accumulator columns 0..63 are g, 64..127 u, of
// its 64 outputs), MODE_FFN_UP or MODE_PLAIN on tf32x3.cuh's ring, the
// epilogue of the bf16 ring's mode on the fp32 sums.  GATEUP and FFN_UP
// write h's TF32 hi and lo (the down product's A) in place of h.
// Persistent: block b takes tiles b, b + gridDim.x, ... in bands of
// kTf32Band row tiles, and its producer loads the next tile while the
// consumers store this one.
template <int NC, int MODE, int ACT>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
tf32x3_gemm_kernel(const __grid_constant__ Tf32Params p) {
  using namespace ptt::hopper;
  using namespace ptt::tf32x3;
  using P = Tf32Plan<NC>;
  constexpr int BN = P::BN;
  // output columns a tile: gate/up's B tile holds g and u of half as many
  constexpr int ON = MODE == MODE_GATEUP ? BN / 2 : BN;
  extern __shared__ unsigned char smem_raw[];
  const auto ring = tf32_ring<NC>(smem_raw);
  const int tiles = p.row_tiles * p.col_tiles;
  auto origin = [&](int t, int& m0, int& part, int& ct) {
    int rt;
    band_tile(t, p.row_tiles, p.col_tiles, kTf32Band, rt, ct);
    m0 = rt * P::BM;
    part = 0;
    if constexpr (MODE == MODE_QKV)
      while (part < 2 && ct >= p.tiles[part]) ct -= p.tiles[part++];
  };
  int it = 0, m0, part, ct;
  if (threadIdx.x < 128) {   // the producer warpgroup
    if constexpr (NC == 2) regs_dec<40>();
    if (threadIdx.x == 0)
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        origin(t, m0, part, ct);
        tf32_produce(ring, p.m, m0, p.boff[part] + ct * BN, p.K, it);
      }
    return;
  }
  if constexpr (NC == 2) regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4;
  float acc[BN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    origin(t, m0, part, ct);
    tf32_consume(ring, p.K, c, acc, it);
    // epilogue: fp32 pairs from the fragment, masked past T and past the
    // part's width
    const int n = p.n[part], n0 = ct * ON;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 64 * c + 16 * w + lane / 4 + 8 * hh;
      if (row >= p.T) continue;
      const size_t o = (size_t)row * n;
#pragma unroll
      for (int i = 0; i < ON / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
        if (col >= n) continue;
        float v[2] = {acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]};
        if constexpr (MODE == MODE_GATEUP || MODE == MODE_FFN_UP) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (MODE == MODE_GATEUP) {
              const float sg = 1.f / (1.f + expf(-v[e]));
              v[e] = (v[e] * sg) * acc[4 * (i + ON / 8) + 2 * hh + e];
            } else {
              v[e] = activate(v[e] + p.bias[col + e], ACT);
            }
          }
          float2 hi, lo;
          ptt::tf32_split(v[0], hi.x, lo.x);
          ptt::tf32_split(v[1], hi.y, lo.y);
          *reinterpret_cast<float2*>(p.out[0] + o + col) = hi;
          *reinterpret_cast<float2*>(p.out[1] + o + col) = lo;
        } else {
          if (MODE == MODE_PLAIN && p.bias != nullptr) {
            v[0] += p.bias[col];
            v[1] += p.bias[col + 1];
          }
          *reinterpret_cast<float2*>(p.out[part] + o + col) =
              make_float2(v[0], v[1]);
        }
      }
    }
  }
}

template <int NC, int MODE, int ACT>
int launch_tf32x3(Tf32Params& p, const float* a_hi, const float* a_lo,
                  const float* b_hi, const float* b_lo, int brows,
                  cudaStream_t stream) {
  using P = ptt::tf32x3::Tf32Plan<NC>;
  constexpr int ON = MODE == MODE_GATEUP ? P::BN / 2 : P::BN;
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.T};
  const uint64_t bdims[2] = {(uint64_t)p.K, (uint64_t)brows};
  const uint64_t stride[1] = {(uint64_t)p.K * 4};
  const uint32_t abox[2] = {32, (uint32_t)P::BM};
  const uint32_t bbox[2] = {32, (uint32_t)P::BN};
  using ptt::hopper::make_map_f32;
  cudaError_t e = make_map_f32(&p.m.a_hi, a_hi, 2, adims, stride, abox);
  if (e == cudaSuccess)
    e = make_map_f32(&p.m.a_lo, a_lo, 2, adims, stride, abox);
  if (e == cudaSuccess)
    e = make_map_f32(&p.m.b_hi, b_hi, 2, bdims, stride, bbox);
  if (e == cudaSuccess)
    e = make_map_f32(&p.m.b_lo, b_lo, 2, bdims, stride, bbox);
  if (e != cudaSuccess) return (int)e;
  p.row_tiles = (p.T + P::BM - 1) / P::BM;
  p.col_tiles = 0;
  for (int i = 0; i < (MODE == MODE_QKV ? 3 : 1); ++i)
    p.col_tiles += p.tiles[i] = (p.n[i] + ON - 1) / ON;
  auto kern = tf32x3_gemm_kernel<NC, MODE, ACT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid =
      min(p.row_tiles * p.col_tiles, ptt::hopper::sm_count());
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// C = A . B with MODE's epilogue over the split operands (B^T: `brows`
// rows of K), on 128-column tiles of B^T (gate/up: 64 outputs, g and u):
// 128 rows (two consumers) where the tiles give every SM one, else 64.
template <int MODE, int ACT>
int tf32x3_gemm(Tf32Params& p, const float* a_hi, const float* a_lo,
                const float* b_hi, const float* b_lo, int brows,
                cudaStream_t stream) {
  constexpr int ON = MODE == MODE_GATEUP ? 64 : 128;
  int cols = 0;
  for (int i = 0; i < (MODE == MODE_QKV ? 3 : 1); ++i)
    cols += (p.n[i] + ON - 1) / ON;
  if ((p.T + 127) / 128 * cols >= ptt::hopper::sm_count())
    return launch_tf32x3<2, MODE, ACT>(p, a_hi, a_lo, b_hi, b_lo, brows,
                                       stream);
  return launch_tf32x3<1, MODE, ACT>(p, a_hi, a_lo, b_hi, b_lo, brows,
                                     stream);
}

// The fp32 workspace (floats) of the 3xTF32 QKV: W^T's hi and lo of q | k
// | v, then xn's hi and lo (ops/kernels/fused_block.py, tf32x3_qkv_floats)
inline long long qkv_tf32x3_floats(int T, int d, int dq, int dkv) {
  return 2LL * (dq + 2 * dkv) * d + 2LL * T * d;
}

// The fp32 workspace of the 3xTF32 MLP / fused_ffn: W1^T's (and Wu^T's)
// hi and lo, W2^T's, x's, then h's (fused_block.py, tf32x3_mlp_floats)
inline long long mlp_tf32x3_floats(int T, int d, int f, bool gated) {
  return 2LL * (gated ? 3 : 2) * f * d + 2LL * T * (d + f);
}

int qkv_tf32x3(const void* x, const void* wn, const void* const w[3],
               void* const out[3], void* xn, void* inv, void* ws, int T,
               int d, int dq, int dkv, float eps, cudaStream_t stream) {
  if (ws == nullptr || d % 64 != 0 || (xn == nullptr) != (inv == nullptr))
    return (int)cudaErrorInvalidValue;
  const int ntot = dq + 2 * dkv;
  float* wt_hi = static_cast<float*>(ws);
  float* wt_lo = wt_hi + (size_t)ntot * d;
  float* x_hi = wt_lo + (size_t)ntot * d;
  float* x_lo = x_hi + (size_t)T * d;
  // W^T's hi and lo of the three weights, rows 0, dq and dq + dkv
  ptt::tf32x3::SplitT st{};
  st.parts = 3;
  const int n[3] = {dq, dkv, dkv}, off[3] = {0, dq, dq + dkv};
  for (int i = 0; i < 3; ++i) {
    st.src[i] = static_cast<const float*>(w[i]);
    st.hi[i] = wt_hi + (size_t)off[i] * d;
    st.lo[i] = wt_lo + (size_t)off[i] * d;
    st.K[i] = d;
    st.N[i] = n[i];
  }
  int e = ptt::tf32x3::split_t(st, stream);
  if (e != 0) return e;
  // the row pass: inv and xn (the training variant's), xn's hi and lo
  constexpr int ROWS = ptt::norm::ROWS;
  qkv_rows_kernel<float, true>
      <<<(T + ROWS - 1) / ROWS, ptt::norm::NT, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(wn),
          static_cast<float*>(xn), static_cast<float*>(inv), x_hi, x_lo, T,
          d, eps);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  Tf32Params p{};
  for (int i = 0; i < 3; ++i) {
    p.out[i] = static_cast<float*>(out[i]);
    p.n[i] = n[i];
    p.boff[i] = off[i];
  }
  p.T = T;
  p.K = d;
  return tf32x3_gemm<MODE_QKV, 0>(p, x_hi, x_lo, wt_hi, wt_lo, ntot, stream);
}

int mlp_tf32x3(int act, const void* x, const void* w1, const void* wu,
               const void* w2, const void* b1, const void* b2, void* y,
               void* ws, long long ws_floats, int T, int d, int f,
               cudaStream_t stream) {
  const bool gated = wu != nullptr;
  const int nb = gated ? 2 : 1;
  if (ws == nullptr || ws_floats < mlp_tf32x3_floats(T, d, f, gated))
    return (int)cudaErrorInvalidValue;
  float* w1_hi = static_cast<float*>(ws);
  float* w1_lo = w1_hi + (size_t)nb * f * d;
  float* w2_hi = w1_lo + (size_t)nb * f * d;
  float* w2_lo = w2_hi + (size_t)d * f;
  float* x_hi = w2_lo + (size_t)d * f;
  float* x_lo = x_hi + (size_t)T * d;
  float* h_hi = x_lo + (size_t)T * d;
  float* h_lo = h_hi + (size_t)T * f;
  // W1^T (gated: the gate's and the up's rows interleaved in groups of
  // 64, the gate's first) and W2^T, hi and lo, in one launch; then x's hi
  // and lo
  ptt::tf32x3::SplitT st{};
  const void* src[3] = {w1, gated ? wu : w2, w2};
  for (int i = 0; i <= nb; ++i) {
    const bool down = i == nb;
    st.src[i] = static_cast<const float*>(src[i]);
    st.hi[i] = down ? w2_hi : w1_hi + (size_t)i * 64 * d;
    st.lo[i] = down ? w2_lo : w1_lo + (size_t)i * 64 * d;
    st.K[i] = down ? f : d;
    st.N[i] = down ? d : f;
    if (gated && !down) {
      st.group[i] = 64;
      st.stride[i] = 128;
    }
  }
  st.parts = nb + 1;
  int e = ptt::tf32x3::split_t(st, stream);
  if (e == 0)
    e = ptt::tf32x3::split(static_cast<const float*>(x), x_hi, x_lo,
                           (long long)T * d, stream);
  if (e != 0) return e;
  Tf32Params up{};
  up.out[0] = h_hi;
  up.out[1] = h_lo;
  up.n[0] = f;
  up.bias = static_cast<const float*>(b1);
  up.T = T;
  up.K = d;
  e = gated ? tf32x3_gemm<MODE_GATEUP, 0>(up, x_hi, x_lo, w1_hi, w1_lo,
                                          2 * f, stream)
      : act == ACT_RELU
          ? tf32x3_gemm<MODE_FFN_UP, ACT_RELU>(up, x_hi, x_lo, w1_hi, w1_lo,
                                               f, stream)
      : act == ACT_GELU
          ? tf32x3_gemm<MODE_FFN_UP, ACT_GELU>(up, x_hi, x_lo, w1_hi, w1_lo,
                                               f, stream)
          : tf32x3_gemm<MODE_FFN_UP, ACT_SILU>(up, x_hi, x_lo, w1_hi, w1_lo,
                                               f, stream);
  if (e != 0) return e;
  Tf32Params down{};
  down.out[0] = static_cast<float*>(y);
  down.n[0] = d;
  down.bias = static_cast<const float*>(b2);
  down.T = T;
  down.K = f;
  return tf32x3_gemm<MODE_PLAIN, 0>(down, h_hi, h_lo, w2_hi, w2_lo, d,
                                    stream);
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

// Mode 5: C [64, N] fp32 = A [64, 32] . B, one tf32 product (four k8
// steps) with both operands K-major, as the 3xTF32 GEMM reads them: A and
// B^T [N, 32] fp32 through TMA (boxes {32, 64} and {32, N}, 128-byte
// swizzle).  The caller passes TF32 values (low 13 bits zero), so the
// product is exact and only the fp32 sums' order differs from a matmul.
// Mode 6 (RS): A from registers instead, each thread's fragment read from
// device memory (hopper.cuh's layout), as the fp32 flash forward holds P.
template <int N, bool RS>
__global__ void __launch_bounds__(128)
wgmma_tf32_check_kernel(const __grid_constant__ CheckParams p) {
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
    mbar_expect_tx(&bar, 8192 + N * 128);
    tma_load_2d(As, &p.a, &bar, 0, 0);
    tma_load_2d(Bs, &p.b, &bar, 0, 0);
  }
  const int t = threadIdx.x, lane = t % 32, r0 = 16 * (t / 32) + lane / 4;
  uint32_t af[4][4];
  if constexpr (RS) {
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(p.a_raw);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 8 * kk + lane % 4;
      af[kk][0] = a32[r0 * 32 + k];
      af[kk][1] = a32[(r0 + 8) * 32 + k];
      af[kk][2] = a32[r0 * 32 + k + 4];
      af[kk][3] = a32[(r0 + 8) * 32 + k + 4];
    }
  }
  mbar_wait(&bar, 0);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (RS)
      wgmma_tf32_rs<N>(acc, af[kk], desc_kmajor(Bs + 32 * kk));
    else
      wgmma_tf32<N>(acc, desc_kmajor(As + 32 * kk), desc_kmajor(Bs + 32 * kk));
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

template <int N, bool RS>
int launch_tf32_check(CheckParams& p, const void* a, const void* b,
                      cudaStream_t stream) {
  const uint64_t adims[2] = {32, 64}, bdims[2] = {32, N}, stride[1] = {128};
  const uint32_t abox[2] = {32, 64}, bbox[2] = {32, N};
  cudaError_t e = ptt::hopper::make_map_f32(&p.a, a, 2, adims, stride, abox);
  if (e == cudaSuccess)
    e = ptt::hopper::make_map_f32(&p.b, b, 2, bdims, stride, bbox);
  if (e != cudaSuccess) return (int)e;
  auto kern = wgmma_tf32_check_kernel<N, RS>;
  const int smem = 1024 + 8192 + N * 128;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
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

// The split-K plan of a call: the number of K splits that bf16 at T <=
// 16 in the forward variant (train 0) takes (its workspace is splits * T
// * tiles * 128 fp32 where splits > 1, tiles = ceil(dq / 128) + 2 *
// ceil(dkv / 128), and it needs `tiles` tickets; xn is a [T, d]
// workspace), 0 where the call takes no split-K workspace.
int ptt_qkv_splits(int dtype, int T, int d, int dq, int dkv, int train) {
  if (dtype != ptt::DT_BFLOAT16 || train || T <= 0 || T > kSplitKMaxT ||
      d < 64)
    return 0;
  return qkv_splits(d, dq, dkv, ptt::hopper::sm_count());
}

// q, k, v = (rmsnorm(x) * wn) @ (wq | wk | wv); x [T, d], wq [d, dq],
// wk/wv [d, dkv]; outputs row-major [T, dq], [T, dkv], [T, dkv].  With
// non-null xn [T, d] (x's type) and inv [T] (fp32) the training variant
// also writes the normalised rows and the inverse RMS.  bf16 and fp16 at
// T >= 17 need xn in both variants (the forward variant's is a workspace) and
// runs two launches on `stream`: the row pass, then the wgmma GEMM.  The
// forward variant in bf16 at T <= 16 (xn its workspace, inv null) is the
// row pass, then split-K: ws and tickets are its workspace
// (ptt_qkv_splits), the tickets zero before the launch (and again after
// it).  fp32 at T >= 17 is 3xTF32: the weights' split, the row pass (xn
// and inv in the training variant, null both in the forward variant) and
// the GEMM, three launches; ws is its fp32 workspace, at least
// qkv_tf32x3_floats(T, d, dq, dkv) values.  *design: the Design launched.
int ptt_rmsnorm_qkv(int dtype, const void* x, const void* wn, const void* wq,
                    const void* wk, const void* wv, void* q, void* k, void* v,
                    void* xn, void* inv, void* ws, void* tickets, int T,
                    int d, int dq, int dkv, float eps, void* stream,
                    void* design) {
  const void* w[3] = {wq, wk, wv};
  void* const out[3] = {q, k, v};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_FLOAT32 && T >= kRowPassMinT) {
    if (dq % 64 != 0 || dkv % 64 != 0) return (int)cudaErrorInvalidValue;
    return ptt::launched(
        qkv_tf32x3(x, wn, w, out, xn, inv, ws, T, d, dq, dkv, eps, s),
        design, ptt::DESIGN_TF32X3);
  }
  if ((dtype == ptt::DT_BFLOAT16 || dtype == ptt::DT_FLOAT16) &&
      T >= kRowPassMinT) {
    // the row pass, then the GEMM; xn is the training variant's output or
    // the forward variant's workspace, inv null in the forward variant
    if (dq % 64 != 0 || dkv % 64 != 0) return (int)cudaErrorInvalidValue;
    return ptt::launched(
        dtype == ptt::DT_FLOAT16
            ? qkv_hopper<__half>(x, wn, w, out, xn, inv, T, d, dq, dkv, eps,
                                 s)
            : qkv_hopper<bf16>(x, wn, w, out, xn, inv, T, d, dq, dkv, eps,
                               s),
        design, ptt::DESIGN_WGMMA);
  }
  if (dtype == ptt::DT_BFLOAT16 && T > 0 && T <= kSplitKMaxT &&
      xn != nullptr && inv == nullptr) {
    if (dq % 64 != 0 || dkv % 64 != 0) return (int)cudaErrorInvalidValue;
    return ptt::launched(
        qkv_splitk(x, wn, w, out, xn, ws, tickets, T, d, dq, dkv, eps, s),
        design, ptt::DESIGN_SPLITK);
  }
  if (dq % BN != 0 || dkv % BN != 0 || (xn == nullptr) != (inv == nullptr))
    return (int)cudaErrorInvalidValue;
  GemmArgs g{x, wq, wk, wv, wn, q, k, v, T, d, dq, dkv, eps};
  g.xn = xn;
  g.inv = static_cast<float*>(inv);
  return ptt::launched(launch<MODE_QKV>(dtype, g, dq + 2 * dkv, stream),
                       design, ptt::DESIGN_TILE);
}

// y = (silu(x @ w1) * (x @ wu)) @ w2 (gated: wu non-null, no biases), or
// y = act(x @ w1 + b1) @ w2 (+ b2) (fused_ffn: act 0 relu, 1 exact-erf
// gelu, 2 silu; b1 [f] required, b2 [d] or null); x [T, d], w1 and wu
// [d, f], w2 [f, d], y [T, d].  Two launches on `stream` with h [T, f]
// between them: the epilogue of the first (the gate's activation times
// the up, or the bias and activation) applied to fp32 sums, cast once to
// the io type.  bf16 and fp16 at T >= kRowPassMinT run the wgmma ring,
// bf16 at T <= kSplitKMaxT split-K (ws: ws_floats fp32 values, at least
// the larger launch's splits * NB * ceil(N / 256) * 256 * NTOK by
// mlp_splits, NB = 2 for the gated gate/up, NTOK = 8 at T <= 8, else 16,
// refused if fewer;
// tickets: as many as the wider product's 256-column tiles, zero before
// the call and again after it), fp32 at T >= kRowPassMinT 3xTF32 (ws:
// ws_floats fp32 values, at least mlp_tf32x3_floats, refused if fewer; h
// unused: the up product writes h's hi and lo into ws) and fp32 below it
// the tile.  d and f multiples of 64.  *design: the Design launched.
int ptt_mlp(int dtype, int act, const void* x, const void* w1,
            const void* wu, const void* w2, const void* b1, const void* b2,
            void* h, void* y, void* ws, long long ws_floats, void* tickets,
            int T, int d, int f, void* stream, void* design) {
  const bool gated = wu != nullptr;
  if (T <= 0 || d % 64 != 0 || f % 64 != 0 ||
      (gated ? b1 != nullptr || b2 != nullptr
             : b1 == nullptr || act < ACT_RELU || act > ACT_SILU))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e, used;
  if ((dtype == ptt::DT_BFLOAT16 || dtype == ptt::DT_FLOAT16) &&
      T >= kRowPassMinT) {
    e = dtype == ptt::DT_FLOAT16
            ? mlp_hopper_pair<__half>(act, x, w1, wu, w2, b1, b2, h, y, T, d,
                                      f, s)
            : mlp_hopper_pair<bf16>(act, x, w1, wu, w2, b1, b2, h, y, T, d,
                                    f, s);
    used = ptt::DESIGN_WGMMA;
  } else if (dtype == ptt::DT_BFLOAT16 && T <= kSplitKMaxT) {
    // the down product a dependent of the first: it streams its weight
    // while the first finishes
    e = gated ? mlp_splitk<MODE_GATEUP, 0>(x, w1, wu, nullptr, h, ws,
                                           ws_floats, tickets, T, d, f,
                                           false, s)
        : act == ACT_RELU
            ? mlp_splitk<MODE_FFN_UP, ACT_RELU>(x, w1, nullptr, b1, h, ws,
                                                ws_floats, tickets, T, d, f,
                                                false, s)
        : act == ACT_GELU
            ? mlp_splitk<MODE_FFN_UP, ACT_GELU>(x, w1, nullptr, b1, h, ws,
                                                ws_floats, tickets, T, d, f,
                                                false, s)
            : mlp_splitk<MODE_FFN_UP, ACT_SILU>(x, w1, nullptr, b1, h, ws,
                                                ws_floats, tickets, T, d, f,
                                                false, s);
    if (e == 0)
      e = mlp_splitk<MODE_PLAIN, 0>(h, w2, nullptr, b2, y, ws, ws_floats,
                                    tickets, T, f, d, true, s);
    used = ptt::DESIGN_SPLITK;
  } else if (dtype == ptt::DT_FLOAT32 && T >= kRowPassMinT) {
    e = mlp_tf32x3(act, x, w1, wu, w2, b1, b2, y, ws, ws_floats, T, d, f, s);
    used = ptt::DESIGN_TF32X3;
  } else {
    GemmArgs up{x, w1, wu, nullptr, nullptr, h, nullptr, nullptr, T, d, f, 0,
                0.f};
    up.bias = b1;
    up.act = act;
    e = gated ? launch<MODE_GATEUP>(dtype, up, f, stream)
              : launch<MODE_FFN_UP>(dtype, up, f, stream);
    if (e == 0) {
      GemmArgs down{h, w2, nullptr, nullptr, nullptr, y, nullptr, nullptr, T,
                    f, d, 0, 0.f};
      down.bias = b2;
      e = launch<MODE_PLAIN>(dtype, down, d, stream);
    }
    used = ptt::DESIGN_TILE;
  }
  return ptt::launched(e, design, used);
}

// hopper.cuh's descriptor check: c [64, n] fp32 = a [64, 64] . b (bf16);
// b is [n, 64] (B^T) in mode 0, [64, n] in modes 1 and 2 (mode 2: a from
// registers, n = 128 only), [64, n] int8 (mode 3) or e4m3 (mode 4) bytes
// converted by the threads; n 128 or 256, and 64 in mode 0.  Mode 5: c
// [64, n] = a [64, 32] . b, tf32 (fp32 arrays of TF32 values), b given as
// B^T [n, 32]; n 32, 64, 128 or 256.  Mode 6: mode 5 with a from
// registers; n 64 or 128.
int ptt_wgmma_check(int mode, const void* a, const void* b, void* c, int n,
                    void* stream) {
  const bool tf32_ok = (mode == 5 && (n == 32 || n == 64)) ||
                       (mode == 6 && (n == 64 || n == 128));
  if (!((mode == 0 || mode == 1 || mode == 3 || mode == 4 || mode == 5) &&
        (n == 128 || n == 256)) &&
      !(mode == 2 && n == 128) && !(mode == 0 && n == 64) && !tf32_ok)
    return (int)cudaErrorInvalidValue;
  CheckParams p{};
  p.a_raw = static_cast<const bf16*>(a);
  p.b_raw = static_cast<const unsigned char*>(b);
  p.c = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 5)
    return n == 32    ? launch_tf32_check<32, false>(p, a, b, s)
           : n == 64  ? launch_tf32_check<64, false>(p, a, b, s)
           : n == 128 ? launch_tf32_check<128, false>(p, a, b, s)
                      : launch_tf32_check<256, false>(p, a, b, s);
  if (mode == 6)
    return n == 64 ? launch_tf32_check<64, true>(p, a, b, s)
                   : launch_tf32_check<128, true>(p, a, b, s);
  const uint64_t adims[2] = {64, 64}, astride[1] = {128};
  const uint32_t abox[2] = {64, 64};
  cudaError_t e = ptt::hopper::make_map(&p.a, a, 2, adims, astride, abox);
  if (e != cudaSuccess) return (int)e;
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
