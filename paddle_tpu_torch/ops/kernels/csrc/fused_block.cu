// Fused RMSNorm + QKV projection and the gated SwiGLU MLP, for Hopper.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/fused_block.py
// `_qkv_kernel` (:249) and `_mlp_kernel` (:494: gated silu, and the
// non-gated act + bias variant of `fused_ffn`).
//
// One tiled GEMM body C[T, N] = A[T, K] @ B[K, N] (row-major, weights in
// the [in, out] layout) serves four launches through its prologue and
// epilogue:
//   MODE_QKV    A = x.  The block first computes its rows' inverse RMS in
//               fp32; every x tile that lands in shared memory is then
//               normalised in place, xn = (x * inv) * wn cast to the weight
//               type (the cast point of _qkv_reference, fused_block.py:348),
//               so the normalised activations never exist in device memory.
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
// for prefill chunks.  bf16 runs on the
// tensor cores through nvcuda::wmma 16x16x16 with fp32 accumulators; fp32
// runs on the CUDA cores with fp32 FMAs (no TF32).  wgmma, TMA and warp
// specialisation are later work.  The tile itself is gemm_tile.cuh's, which
// the whole-block decoder kernel (fused_decoder.cu) calls too.
#include "gemm_tile.cuh"

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
  if (g.T <= 16) return launch_bm<T, 16, MODE>(g, ncols, stream);
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

}  // namespace

extern "C" {

// q, k, v = (rmsnorm(x) * wn) @ (wq | wk | wv); x [T, d], wq [d, dq],
// wk/wv [d, dkv]; outputs row-major [T, dq], [T, dkv], [T, dkv].  With
// non-null xn [T, d] (x's type) and inv [T] (fp32) the training variant
// also writes the normalised rows and the inverse RMS.
int ptt_rmsnorm_qkv(int dtype, const void* x, const void* wn, const void* wq,
                    const void* wk, const void* wv, void* q, void* k, void* v,
                    void* xn, void* inv, int T, int d, int dq, int dkv,
                    float eps, void* stream) {
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

}  // extern "C"
