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
// Counts: every block reads its group's count from device memory, so the
// host never waits for the routing.  A block whose rows all lie at or past
// the count returns at once: MODE_UP writes nothing (MODE_DOWN never reads
// those rows), MODE_DOWN first writes its rows' zeros.  Inside a partial
// tile, rows past the count are zero-filled as they load and come back
// zero; the last capacity tile may be partial (C = 960 is no multiple of
// 64) and rows past C are neither read nor written.
//
// What bounds it: at the MoE step's shapes (G = 64, C = 960, d = 2560,
// h = 1536, ~768 routed rows a group) it is a GEMM of 4 * sum(counts) * d * h
// operations, bound by the tensor cores.  The body is fused_block.cu's
// tiled GEMM: 64 x 64 output tiles, 64-deep k steps through a 3-stage
// cp.async ring, bf16 on the tensor cores through nvcuda::wmma 16x16x16
// with fp32 accumulators, fp32 on the CUDA cores with fp32 FMAs (no TF32).
// Bias, the exact-erf gelu and the casts run in fp32 in the epilogue.
// wgmma, TMA and persistent tiles are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

enum Mode { MODE_UP = 0, MODE_DOWN = 1 };

constexpr int BM = 64;       // capacity rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 64;       // reduction depth per pipeline stage
constexpr int NT = 128;      // threads per block (4 warps)
constexpr int STAGES = 3;

struct Args {
  const void* a;       // UP: x [G, C, K]; DOWN: h [G, C, K]
  const void* b;       // UP: w1 [E, K, N]; DOWN: w2 [E, K, N]
  const void* bias;    // UP: b1 [E, N]; DOWN: b2 [E, N]
  const int* counts;   // [G] valid-row prefix of each group
  void* c;             // UP: h [G, C, N]; DOWN: y [G, C, N]
  int C, K, N, rep;
};

template <typename T>
struct Tile {
  static constexpr int PAD = 16 / sizeof(T);   // keeps rows 16B-aligned
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr int VEC = 16 / sizeof(T);   // elements per cp.async
};

template <typename T>
constexpr size_t smem_bytes() {
  size_t pipe = (size_t)STAGES * (BM * Tile<T>::LDA + BK * Tile<T>::LDB) *
                sizeof(T);
  size_t cst = (size_t)BM * (BN + 4) * sizeof(float);
  return pipe > cst ? pipe : cst;
}

// jax.nn.gelu(approximate=False): 0.5 x erfc(-x / sqrt 2), in fp32
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * erfcf(-v * 0.70710678118654752f);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
grouped_kernel(Args g) {
  constexpr int LDA = Tile<T>::LDA, LDB = Tile<T>::LDB, VEC = Tile<T>::VEC;
  const int grp = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int col = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int C = g.C, K = g.K, N = g.N;
  const int cnt = min(max(g.counts[grp], 0), C);
  T* Cg = static_cast<T*>(g.c) + (size_t)grp * C * N;

  if (m0 >= cnt) {
    // no routed row in this tile: skip the products
    if (MODE == MODE_DOWN) {
      const int rows = min(BM, C - m0);
      for (int e = tid; e < rows * BN; e += NT)
        Cg[(size_t)(m0 + e / BN) * N + col + e % BN] = ptt::from_f<T>(0.f);
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + STAGES * BM * LDA;
  const int ex = grp / g.rep;
  const T* A = static_cast<const T*>(g.a) + (size_t)grp * C * K;
  const T* B = static_cast<const T*>(g.b) + (size_t)ex * K * N;

  const int KT = K / BK;
  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    T* as = As + s * BM * LDA;
    for (int c = tid; c < BM * BK / VEC; c += NT) {
      int r = c / (BK / VEC), cc = (c % (BK / VEC)) * VEC;
      bool ok = m0 + r < cnt;          // rows past the count load as zero
      const T* src = ok ? A + (size_t)(m0 + r) * K + k0 + cc : A;
      ptt::cp_async16(as + r * LDA + cc, src, ok);
    }
    T* bs = Bs + s * BK * LDB;
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

  // 4 warps as 2 x 2, each a 32 x 32 quarter of the tile
  constexpr int TM = BM / 2, TN = BN / 2;
  constexpr int FM = TM / 16, FN = TN / 16;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  constexpr bool TC = sizeof(T) == 2;
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
    __syncthreads();   // tile kt visible to all; stage (kt-1)%S free
    if (kt + STAGES - 1 < KT)
      load_tile(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    ptt::cp_async_commit();
    const int s = kt % STAGES;
    const T* as = As + s * BM * LDA;
    const T* bs = Bs + s * BK * LDB;
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
              reinterpret_cast<const __nv_bfloat16*>(bs) + kk * LDB +
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
        for (int j = 0; j < 4; ++j) bv[j] = ptt::to_f(bs[kk * LDB + tx * 4 + j]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          float a = ptt::to_f(as[(ty + 8 * i) * LDA + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] = fmaf(a, bv[j], f[i][j]);
        }
      }
    }
  }
  ptt::cp_async_wait<0>();
  __syncthreads();   // pipeline buffers are reused for the C tile

  // epilogue: stage the fp32 tile in shared memory, then bias (+ gelu) and
  // one cast per element
  constexpr int LDC = BN + 4;
  float* Cs = reinterpret_cast<float*>(smem_raw);
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(Cs + (wm * TM + i * 16) * LDC + wn * TN + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty + 8 * i) * LDC + tx * 4 + j] = f[i][j];
  }
  __syncthreads();
  const T* bias = static_cast<const T*>(g.bias) + (size_t)ex * N + col;
  const int rows = min(BM, C - m0);
  for (int e = tid; e < rows * BN; e += NT) {
    int r = e / BN, c = e % BN;
    float v = 0.f;
    if (m0 + r < cnt) {
      v = Cs[r * LDC + c] + ptt::to_f(bias[c]);
      if (MODE == MODE_UP) v = gelu_erf(v);
    } else if (MODE == MODE_UP) {
      continue;   // MODE_DOWN never reads hidden rows past the count
    }
    Cg[(size_t)(m0 + r) * N + col + c] = ptt::from_f<T>(v);
  }
}

template <typename T, int MODE>
int launch_t(const Args& g, int G, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  auto kern = grouped_kernel<T, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(g.N / BN, (g.C + BM - 1) / BM, G);
  kern<<<grid, NT, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(int dtype, const Args& g, int G, void* stream) {
  if (G <= 0 || g.C <= 0 || g.rep <= 0 || G % g.rep != 0 || g.K % BK != 0 ||
      g.N % BN != 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return launch_t<__nv_bfloat16, MODE>(g, G, s);
  if (dtype == ptt::DT_FLOAT32) return launch_t<float, MODE>(g, G, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// h[g] = gelu(x[g] @ w1[g / rep] + b1[g / rep]) for rows < counts[g];
// x [G, C, d], w1 [E, d, h], b1 [E, h], counts [G] int32, h [G, C, h].
int ptt_grouped_ffn_up(int dtype, const void* x, const void* w1,
                       const void* b1, const void* counts, void* h, int G,
                       int C, int d, int hid, int rep, void* stream) {
  Args g{x, w1, b1, static_cast<const int*>(counts), h, C, d, hid, rep};
  return launch<MODE_UP>(dtype, g, G, stream);
}

// y[g] = h[g] @ w2[g / rep] + b2[g / rep] for rows < counts[g], zero for
// the other rows; h [G, C, h], w2 [E, h, d], b2 [E, d], y [G, C, d].
int ptt_grouped_ffn_down(int dtype, const void* h, const void* w2,
                         const void* b2, const void* counts, void* y, int G,
                         int C, int hid, int d, int rep, void* stream) {
  Args g{h, w2, b2, static_cast<const int*>(counts), y, C, hid, d, rep};
  return launch<MODE_DOWN>(dtype, g, G, stream);
}

}  // extern "C"
