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
//
// Each block owns a [BM, 64] output tile and walks K in 64-deep steps
// through a cp.async ring: the x tile and the raw 1-byte weight tile land
// in shared memory, the weight tile is up-converted there into an io-type
// tile, and the product runs on the tensor cores (nvcuda::wmma 16x16x16
// bf16, fp32 accumulators) or, for fp32, on CUDA-core FMAs (no TF32).  The
// TPU kernel keeps K whole in one tile; K is blocked here, so only the
// order of the fp32 sum differs from the plain version.
//
// What bounds it: at decode (T = 8 rows) every weight byte is read once for
// 2 T operations, so the launch is bound by device-memory bytes, half the
// bf16 weight's.  BM = 16 tiles keep 8 weight tiles (32 KB) in flight per
// block for that; 64-row tiles (prefill chunks) reuse each weight tile 64
// times and keep 4.  A row tile past T is zero-filled and never stored.
// Split-K for the narrow projections, wgmma and TMA are later work.
#include <cuda_fp8.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 64;    // output columns per block
constexpr int BK = 64;    // reduction depth per pipeline stage
constexpr int NT = 128;   // threads per block (4 warps)

template <typename T, int BM>
struct Cfg {
  static constexpr int STAGES = BM == 16 ? 8 : 4;
  static constexpr int PAD = 16 / sizeof(T);   // keeps rows 16B-aligned
  static constexpr int LDA = BK + PAD;         // x stage row stride
  static constexpr int LDB = BN + PAD;         // converted weight row stride
  static constexpr int VEC = 16 / sizeof(T);   // x elements per cp.async
  static constexpr size_t A_BYTES = (size_t)STAGES * BM * LDA * sizeof(T);
  static constexpr size_t W_BYTES = (size_t)STAGES * BK * BN;   // raw bytes
  static constexpr size_t B_BYTES = (size_t)BK * LDB * sizeof(T);
  static constexpr size_t SMEM = A_BYTES + W_BYTES + B_BYTES;
};

// one stored weight byte as a float (exact: int8 and e4m3 values are
// representable in bf16 and fp32)
template <typename W>
__device__ __forceinline__ float w_to_f(uint8_t b);
template <>
__device__ __forceinline__ float w_to_f<int8_t>(uint8_t b) {
  return (float)(int8_t)b;
}
template <>
__device__ __forceinline__ float w_to_f<__nv_fp8_e4m3>(uint8_t b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

template <typename T, typename W, int BM>
__global__ void __launch_bounds__(NT)
quant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ qw,
                    const float* __restrict__ scale, T* __restrict__ y, int T_,
                    int K, int N) {
  using C = Cfg<T, BM>;
  constexpr int STAGES = C::STAGES, LDA = C::LDA, LDB = C::LDB, VEC = C::VEC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);                  // [S][BM][LDA]
  uint8_t* Ws = smem_raw + C::A_BYTES;                     // [S][BK][BN]
  T* Bs = reinterpret_cast<T*>(smem_raw + C::A_BYTES + C::W_BYTES);  // [BK][LDB]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KT = K / BK;

  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    T* as = As + s * BM * LDA;
    for (int c = tid; c < BM * BK / VEC; c += NT) {
      const int r = c / (BK / VEC), cc = (c % (BK / VEC)) * VEC;
      const bool ok = m0 + r < T_;
      const T* src = ok ? x + (size_t)(m0 + r) * K + k0 + cc : x;
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

  constexpr bool TC = sizeof(T) == 2;
  constexpr int WM = BM == 16 ? 1 : 2;   // warps along M
  constexpr int WN = 4 / WM;             // warps along N
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int FM = TM / 16, FN = TN / 16;
  const int warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  // tensor-core path (bf16)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TC ? FM : 1]
                                                         [TC ? FN : 1];
  // CUDA-core path (fp32): thread owns rows ty + 8 i, columns 4 tx .. 4 tx + 3
  constexpr int RM = BM / 8;
  float f[TC ? 1 : RM][4];
  const int tx = tid % 16, ty = tid / 16;
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f[i][j] = 0.f;
  }

  for (int kt = 0; kt < KT; ++kt) {
    ptt::cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt landed; stage (kt-1)%S and Bs are free
    if (kt + STAGES - 1 < KT)
      load_tile(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    ptt::cp_async_commit();
    const int s = kt % STAGES;
    // up-convert the raw weight tile into the io type, 16 bytes a step
    const uint8_t* ws = Ws + s * BK * BN;
    for (int c = tid; c < BK * BN / 16; c += NT) {
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(ws + r * BN + cc);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      __align__(16) T v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = ptt::from_f<T>(w_to_f<W>(b[i]));
      uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDB + cc);
#pragma unroll
      for (int i = 0; i < 16 * (int)sizeof(T) / 16; ++i)
        dst[i] = reinterpret_cast<const uint4*>(v)[i];
    }
    __syncthreads();
    const T* as = As + s * BM * LDA;
    if constexpr (TC) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[FM];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(
              af[i],
              reinterpret_cast<const __nv_bfloat16*>(as) +
                  (wm * TM + i * 16) * LDA + kk,
              LDA);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(
              bf,
              reinterpret_cast<const __nv_bfloat16*>(Bs) + kk * LDB +
                  wn * TN + j * 16,
              LDB);
#pragma unroll
          for (int i = 0; i < FM; ++i)
            wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ptt::to_f(Bs[kk * LDB + tx * 4 + j]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float a = ptt::to_f(as[(ty + 8 * i) * LDA + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] = fmaf(a, bv[j], f[i][j]);
        }
      }
    }
  }
  ptt::cp_async_wait<0>();
  __syncthreads();   // the pipeline buffers are reused for the C tile

  // epilogue: stage the fp32 tile, then y = (acc * scale[n]) in the io type
  constexpr int LDC = BN + 4;
  float* Cs = reinterpret_cast<float*>(smem_raw);
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * TM + i * 16) * LDC + wn * TN + j * 16, acc[i][j], LDC,
            wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty + 8 * i) * LDC + tx * 4 + j] = f[i][j];
  }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    if (m0 + r >= T_) continue;
    y[(size_t)(m0 + r) * N + n0 + c] =
        ptt::from_f<T>(Cs[r * LDC + c] * scale[n0 + c]);
  }
}

template <typename T, typename W, int BM>
int launch_bm(const void* x, const void* qw, const float* scale, void* y,
              int T_, int K, int N, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, BM>::SMEM;
  static_assert(smem >= (size_t)BM * (BN + 4) * sizeof(float),
                "the C tile reuses the pipeline buffers");
  auto kern = quant_matmul_kernel<T, W, BM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / BN, (T_ + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x),
                                   static_cast<const uint8_t*>(qw), scale,
                                   static_cast<T*>(y), T_, K, N);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_t(const void* x, const void* qw, const float* scale, void* y,
             int T_, int K, int N, cudaStream_t s) {
  // decode-sized row counts take one 16-row wmma tile; longer chunks 64
  if (T_ <= 16) return launch_bm<T, W, 16>(x, qw, scale, y, T_, K, N, s);
  return launch_bm<T, W, 64>(x, qw, scale, y, T_, K, N, s);
}

template <typename T>
int launch_w(int wtype, const void* x, const void* qw, const float* scale,
             void* y, int T_, int K, int N, cudaStream_t s) {
  if (wtype == ptt::DT_INT8)
    return launch_t<T, int8_t>(x, qw, scale, y, T_, K, N, s);
  if (wtype == ptt::DT_FP8_E4M3)
    return launch_t<T, __nv_fp8_e4m3>(x, qw, scale, y, T_, K, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y = (x @ float(qw)) * scale, one cast; x [T, K] and y [T, N] in `dtype`
// (float32 or bfloat16), qw [K, N] int8 or float8 e4m3 (`wtype`), scale
// [N] fp32.  K and N multiples of 64; every pointer 16-byte aligned.
int ptt_quant_matmul(int dtype, int wtype, const void* x, const void* qw,
                     const void* scale, void* y, int T, int K, int N,
                     void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || K % BK != 0 || N % BN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == ptt::DT_BFLOAT16)
    return launch_w<__nv_bfloat16>(wtype, x, qw, sc, y, T, K, N, s);
  if (dtype == ptt::DT_FLOAT32)
    return launch_w<float>(wtype, x, qw, sc, y, T, K, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
