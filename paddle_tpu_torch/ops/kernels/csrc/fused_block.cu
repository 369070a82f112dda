// Fused RMSNorm + QKV projection and the gated SwiGLU MLP, for Hopper.
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
// for prefill chunks.  bf16 runs on the tensor cores through nvcuda::wmma
// 16x16x16 with fp32 accumulators; fp32 runs on the CUDA cores with fp32
// FMAs (no TF32).  The tile itself is gemm_tile.cuh's, which the
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
  // (bf16 QKV past 16 rows is qkv_hopper's)
  if (g.T <= 16) return launch_bm<T, 16, MODE>(g, ncols, stream);
  if constexpr (MODE == MODE_QKV && sizeof(T) == 2)
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
  const int ncol = p.tiles[0] + p.tiles[1] + p.tiles[2];
  const int band = kBand * ncol;
  const int first = blockIdx.x / band * kBand;
  const int rows_in = min(kBand, p.row_tiles - first);
  const int in = blockIdx.x % band;
  const int m0 = (first + in % rows_in) * P::BM;
  int ct = in / rows_in, part = 0;
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

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
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
  if (big >= 2 * sm_count()) return launch_qkv_gemm<2, 256>(p, xn, w, stream);
  return launch_qkv_gemm<1, 128>(p, xn, w, stream);
}

// -- the descriptor check of hopper.cuh ---------------------------------------

// C [64, N] fp32 = A [64, 64] . B on one warpgroup, the operands through
// TMA (128-byte swizzle) and wgmma: mode 0 takes B^T as [N, 64] (K-major,
// as flash's K rows; N = 64 is every score tile of the flash forward and
// backward: S, dP, S^T, dP^T), mode 1 B as [64, N] (MN-major, as the
// weights and flash's V), mode 2 as mode 1 with A from registers (N = 128,
// as flash's P V, dS K, P^T dO and dS^T Q).  tests/test_torch_cuda.py
// holds it against torch.matmul.
struct CheckParams {
  CUtensorMap a, b;
  const bf16* a_raw;
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
    mbar_expect_tx(&bar, 8192 + N * 128);
    tma_load_2d(As, &p.a, &bar, 0, 0);
    if (MODE == 0)
      tma_load_2d(Bs, &p.b, &bar, 0, 0);
    else
      for (int j = 0; j < N / 64; ++j)
        tma_load_2d(Bs + j * 8192, &p.b, &bar, 64 * j, 0);
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
  GemmArgs g{x, wg, wu, nullptr, nullptr, h, nullptr, nullptr, T, d, f, 0,
             0.f};
  return launch<MODE_GATEUP>(dtype, g, f, stream);
}

// y = a @ w (+ b); a [T, K], w [K, N], b [N] or null, y [T, N].
int ptt_matmul(int dtype, const void* a, const void* w, const void* b,
               void* y, int T, int K, int N, void* stream) {
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
  GemmArgs g{x, w1, nullptr, nullptr, nullptr, h, nullptr, nullptr, T, d, f, 0,
             0.f};
  g.bias = b1;
  g.act = act;
  return launch<MODE_FFN_UP>(dtype, g, f, stream);
}

// hopper.cuh's descriptor check: c [64, n] fp32 = a [64, 64] . b (bf16);
// b is [n, 64] (B^T) in mode 0, [64, n] in modes 1 and 2 (mode 2: a from
// registers, n = 128 only); n 128 or 256, and 64 in mode 0.
int ptt_wgmma_check(int mode, const void* a, const void* b, void* c, int n,
                    void* stream) {
  if (!((mode == 0 || mode == 1) && (n == 128 || n == 256)) &&
      !(mode == 2 && n == 128) && !(mode == 0 && n == 64))
    return (int)cudaErrorInvalidValue;
  CheckParams p{};
  p.a_raw = static_cast<const bf16*>(a);
  p.c = static_cast<float*>(c);
  const uint64_t adims[2] = {64, 64}, astride[1] = {128};
  const uint32_t abox[2] = {64, 64};
  cudaError_t e = ptt::hopper::make_map(&p.a, a, 2, adims, astride, abox);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bdims[2] = {mode == 0 ? 64u : (uint64_t)n,
                             mode == 0 ? (uint64_t)n : 64u};
  const uint64_t bstride[1] = {mode == 0 ? 128u : (uint64_t)n * 2};
  const uint32_t bbox[2] = {64, mode == 0 ? (uint32_t)n : 64u};
  e = ptt::hopper::make_map(&p.b, b, 2, bdims, bstride, bbox);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return n == 64    ? launch_check<64, 0>(p, s)
                        : n == 128 ? launch_check<128, 0>(p, s)
                                   : launch_check<256, 0>(p, s);
  if (mode == 1) return n == 128 ? launch_check<128, 1>(p, s)
                                 : launch_check<256, 1>(p, s);
  return launch_check<128, 2>(p, s);
}

}  // extern "C"
