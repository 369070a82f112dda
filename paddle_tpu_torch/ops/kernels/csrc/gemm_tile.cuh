// The 64-column GEMM tile of fused_block.cu, as a device function that a
// kernel calls once per output tile: C[T, N] = A[T, K] @ B[K, N] (row-major,
// weights in the [in, out] layout), with the prologue and epilogue of one
// of five modes (csrc/fused_block.cu says what each is for):
//   MODE_QKV     rmsnorm of the A tile in shared memory, columns over
//                q | k | v (and the training variant's xn / inv outputs)
//   MODE_GATEUP  two weight tiles; h = silu(x Wg) * (x Wu) cast to T
//   MODE_PLAIN   y = a W (+ b, added to the fp32 sum before the one cast)
//   MODE_FFN_UP  h = act(x W1 + b1) cast to T
//   MODE_RESID   y = r + (a W cast to T), the add in T's precision (the
//                residual adds of a decoder block); r is read through L2
//                only, so a tile may read rows that another block wrote
//                before a grid-wide barrier
// A block of NT threads computes one BM x BN tile per call; the caller
// picks (row_tile, col_tile) and the shared memory (smem_bytes of the
// same instantiation).  Calls in a loop need a __syncthreads() between
// them: the epilogue reads the same shared memory the next prologue fills.
// bf16 runs on the tensor cores through nvcuda::wmma 16x16x16 with fp32
// accumulators; fp32 on the CUDA cores with fp32 FMAs (no TF32).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace ptt {
namespace gemm {

using namespace nvcuda;

enum Mode {
  MODE_QKV = 0,
  MODE_GATEUP = 1,
  MODE_PLAIN = 2,
  MODE_FFN_UP = 3,
  MODE_RESID = 4
};
// MODE_FFN_UP activations (ops/kernels/fused_block.py ACT_CODES)
enum Act { ACT_RELU = 0, ACT_GELU = 1, ACT_SILU = 2 };

constexpr int BN = 64;       // output columns per block
constexpr int BK = 64;       // reduction depth per pipeline stage
constexpr int NT = 128;      // threads per block (4 warps)

// cp.async pipeline depth.  Decode-sized tiles (16 rows) are bound by the
// weight bytes each block has in flight, so they keep more stages (as
// many as fit in 227 KB for the dual-weight fp32 case); 64-row tiles
// reuse each weight tile 64 times and keep 3.
template <typename T, int BM>
struct Stages {
  static constexpr int value = BM == 16 ? (sizeof(T) == 2 ? 6 : 4) : 3;
};

struct GemmArgs {
  const void* a;    // [T, K]
  const void* b0;   // QKV: wq [K, dq]; GATEUP: wg [K, N]; PLAIN: w [K, N]
  const void* b1;   // QKV: wk [K, dkv]; GATEUP: wu [K, N]
  const void* b2;   // QKV: wv [K, dkv]
  const void* wn;   // QKV: norm weight [K]
  void* c0;         // QKV: q [T, dq]; GATEUP: h [T, N]; PLAIN: y [T, N]
  void* c1;         // QKV: k [T, dkv]
  void* c2;         // QKV: v [T, dkv]
  int T, K;
  int n0, n1;       // QKV: dq, dkv; otherwise n0 = N
  float eps;
  void* xn = nullptr;     // QKV training variant: normalised rows [T, K]
  float* inv = nullptr;   // QKV training variant: inverse RMS [T]
  const void* bias = nullptr;   // FFN_UP: b1 [N]; PLAIN: b [N] or null
  int act = ACT_RELU;           // FFN_UP
  const void* resid = nullptr;  // RESID: r [T, N]
};

__device__ __forceinline__ float activate(float u, int act) {
  if (act == ACT_RELU) return fmaxf(u, 0.f);
  if (act == ACT_GELU) return 0.5f * u * erfcf(-u * 0.70710678118654752f);
  return u / (1.f + expf(-u));   // silu
}

template <typename T>
struct Tile {
  static constexpr int PAD = 16 / sizeof(T);   // keeps rows 16B-aligned
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr int VEC = 16 / sizeof(T);   // elements per cp.async
};

template <typename T, int BM, int MODE>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int nb = MODE == MODE_GATEUP ? 2 : 1;
  constexpr int STAGES = Stages<T, BM>::value;
  constexpr int nw = MODE == MODE_QKV ? BK : 0;   // norm-weight slice
  size_t pipe = (size_t)STAGES *
                (BM * Tile<T>::LDA + nb * BK * Tile<T>::LDB + nw) * sizeof(T);
  size_t cst = (size_t)nb * BM * (BN + 4) * sizeof(float);
  return pipe > cst ? pipe : cst;
}

template <typename T, int BM, int MODE>
__device__ __forceinline__ void gemm_tile(const GemmArgs& g, int row_tile,
                                          int col_tile,
                                          unsigned char* smem_raw) {
  constexpr bool DUAL = MODE == MODE_GATEUP;
  constexpr int STAGES = Stages<T, BM>::value;
  constexpr int LDA = Tile<T>::LDA, LDB = Tile<T>::LDB, VEC = Tile<T>::VEC;
  __shared__ float s_inv[BM];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs0 = As + STAGES * BM * LDA;
  T* Bs1 = Bs0 + STAGES * BK * LDB;
  T* Ws = Bs0 + (DUAL ? 2 : 1) * STAGES * BK * LDB;   // QKV: wn slices

  const int tid = threadIdx.x;
  const int m0 = row_tile * BM;
  const int gcol = col_tile * BN;   // column in the grid's output space
  const int T_ = g.T, K = g.K;
  const T* A = static_cast<const T*>(g.a);

  // which weight / output this column tile belongs to
  const T* B0 = static_cast<const T*>(g.b0);
  const T* B1 = static_cast<const T*>(g.b1);
  T* C = static_cast<T*>(g.c0);
  int ldb = g.n0, col = gcol;
  if (MODE == MODE_QKV) {
    if (gcol >= g.n0 + g.n1) {
      B0 = static_cast<const T*>(g.b2);
      C = static_cast<T*>(g.c2);
      ldb = g.n1;
      col = gcol - g.n0 - g.n1;
    } else if (gcol >= g.n0) {
      B0 = static_cast<const T*>(g.b1);
      C = static_cast<T*>(g.c1);
      ldb = g.n1;
      col = gcol - g.n0;
    }
  }

  const int KT = K / BK;
  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    T* as = As + s * BM * LDA;
    for (int c = tid; c < BM * BK / VEC; c += NT) {
      int r = c / (BK / VEC), cc = (c % (BK / VEC)) * VEC;
      bool ok = m0 + r < T_;
      const T* src = ok ? A + (size_t)(m0 + r) * K + k0 + cc : A;
      ptt::cp_async16(as + r * LDA + cc, src, ok);
    }
    if (MODE == MODE_QKV && tid < BK / VEC)
      ptt::cp_async16(Ws + s * BK + tid * VEC,
                      static_cast<const T*>(g.wn) + k0 + tid * VEC, true);
    T* bs0 = Bs0 + s * BK * LDB;
    T* bs1 = Bs1 + s * BK * LDB;
    for (int c = tid; c < BK * BN / VEC; c += NT) {
      int r = c / (BN / VEC), cc = (c % (BN / VEC)) * VEC;
      size_t off = (size_t)(k0 + r) * ldb + col + cc;
      ptt::cp_async16(bs0 + r * LDB + cc, B0 + off, true);
      if (DUAL) ptt::cp_async16(bs1 + r * LDB + cc, B1 + off, true);
    }
  };

  // keep STAGES-1 tiles in flight before anything else
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    ptt::cp_async_commit();
  }

  if (MODE == MODE_QKV) {
    // prologue: inverse RMS of this block's rows, fp32, 16-byte loads
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BM; r += NT / 32) {
      float ss = 0.f;
      if (m0 + r < T_) {
        const uint4* row =
            reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K);
#pragma unroll 4
        for (int c = lane; c < K / VEC; c += 32) {
          uint4 raw = row[c];
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float v = ptt::to_f(e[i]);
            ss += v * v;
          }
        }
      }
      ss = ptt::warp_sum(ss);
      if (lane == 0) s_inv[r] = rsqrtf(ss / (float)K + g.eps);
    }
  }

  // accumulators
  constexpr int WM = BM == 16 ? 1 : 2;   // warps along M
  constexpr int WN = 4 / WM;             // warps along N
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int FM = TM / 16, FN = TN / 16;
  const int warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  constexpr bool TC = sizeof(T) == 2;
  // tensor-core path (bf16)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0[TC ? FM : 1]
                                                          [TC ? FN : 1];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[TC && DUAL ? FM : 1]
                                                          [TC && DUAL ? FN : 1];
  // CUDA-core path (fp32): thread owns rows ty + 8 i, columns 4 tx .. 4 tx + 3
  constexpr int RM = BM / 8;
  float f0[TC ? 1 : RM][4], f1[TC || !DUAL ? 1 : RM][4];
  const int tx = tid % 16, ty = tid / 16;
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fill_fragment(acc0[i][j], 0.f);
        if constexpr (DUAL) wmma::fill_fragment(acc1[i][j], 0.f);
      }
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f0[i][j] = 0.f;
        if constexpr (DUAL) f1[i][j] = 0.f;
      }
  }

  for (int kt = 0; kt < KT; ++kt) {
    ptt::cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt visible to all; stage (kt-1)%S free
    if (kt + STAGES - 1 < KT) load_tile(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    ptt::cp_async_commit();
    const int s = kt % STAGES;
    T* as = As + s * BM * LDA;
    const T* bs0 = Bs0 + s * BK * LDB;
    const T* bs1 = Bs1 + s * BK * LDB;
    if (MODE == MODE_QKV) {
      // normalise the x tile in place: xn = (x * inv) * wn, cast to T
      // (rows past T are zero already)
      const T* ws = Ws + s * BK;
      const int rows = min(BM, T_ - m0);
      for (int e = tid; e < rows * BK; e += NT) {
        int r = e / BK, c = e % BK;
        float x = ptt::to_f(as[r * LDA + c]);
        float xn = (x * s_inv[r]) * ptt::to_f(ws[c]);
        as[r * LDA + c] = ptt::from_f<T>(xn);
      }
      __syncthreads();
      if (g.xn != nullptr && col_tile == 0) {
        // training variant: the first column tile stores this k slice of
        // the normalised rows (16-byte copies) and, once, the inverse RMS
        T* xg = static_cast<T*>(g.xn) + (size_t)m0 * K + kt * BK;
        for (int e = tid; e < rows * (BK / VEC); e += NT) {
          int r = e / (BK / VEC), c = (e % (BK / VEC)) * VEC;
          *reinterpret_cast<uint4*>(xg + (size_t)r * K + c) =
              *reinterpret_cast<const uint4*>(as + r * LDA + c);
        }
        if (kt == 0)
          for (int r = tid; r < rows; r += NT) g.inv[m0 + r] = s_inv[r];
      }
    }
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
              reinterpret_cast<const __nv_bfloat16*>(bs0) + kk * LDB +
                  wn * TN + j * 16,
              LDB);
#pragma unroll
          for (int i = 0; i < FM; ++i)
            wmma::mma_sync(acc0[i][j], af[i], bf, acc0[i][j]);
          if constexpr (DUAL) {
            wmma::load_matrix_sync(
                bf,
                reinterpret_cast<const __nv_bfloat16*>(bs1) + kk * LDB +
                    wn * TN + j * 16,
                LDB);
#pragma unroll
            for (int i = 0; i < FM; ++i)
              wmma::mma_sync(acc1[i][j], af[i], bf, acc1[i][j]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float b0v[4], b1v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0v[j] = ptt::to_f(bs0[kk * LDB + tx * 4 + j]);
          if constexpr (DUAL) b1v[j] = ptt::to_f(bs1[kk * LDB + tx * 4 + j]);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          float a = ptt::to_f(as[(ty + 8 * i) * LDA + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            f0[i][j] = fmaf(a, b0v[j], f0[i][j]);
            if constexpr (DUAL) f1[i][j] = fmaf(a, b1v[j], f1[i][j]);
          }
        }
      }
    }
  }
  ptt::cp_async_wait<0>();
  __syncthreads();   // pipeline buffers are reused for the C tile

  // epilogue: stage the fp32 tile(s) in shared memory, then write out
  constexpr int LDC = BN + 4;
  float* Cs0 = reinterpret_cast<float*>(smem_raw);
  float* Cs1 = Cs0 + BM * LDC;
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        float* p = Cs0 + (wm * TM + i * 16) * LDC + wn * TN + j * 16;
        wmma::store_matrix_sync(p, acc0[i][j], LDC, wmma::mem_row_major);
        if constexpr (DUAL)
          wmma::store_matrix_sync(p + BM * LDC, acc1[i][j], LDC,
                                  wmma::mem_row_major);
      }
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Cs0[(ty + 8 * i) * LDC + tx * 4 + j] = f0[i][j];
        if constexpr (DUAL) Cs1[(ty + 8 * i) * LDC + tx * 4 + j] = f1[i][j];
      }
  }
  __syncthreads();
  const int ldc = MODE == MODE_QKV ? ldb : g.n0;
  const T* bias = static_cast<const T*>(g.bias);
  const T* R = static_cast<const T*>(g.resid);
  for (int e = tid; e < BM * BN; e += NT) {
    int r = e / BN, c = e % BN;
    if (m0 + r >= T_) continue;
    float v = Cs0[r * LDC + c];
    if (MODE == MODE_GATEUP) {
      float u = Cs1[r * LDC + c];
      float sg = 1.f / (1.f + expf(-v));
      v = (v * sg) * u;
    }
    if ((MODE == MODE_PLAIN || MODE == MODE_FFN_UP) && bias != nullptr)
      v += ptt::to_f(bias[col + c]);
    if (MODE == MODE_FFN_UP) v = activate(v, g.act);
    const size_t at = (size_t)(m0 + r) * ldc + col + c;
    if (MODE == MODE_RESID)   // the product rounds to T, then the add
      v = ptt::to_f(ptt::ldcg(R + at)) + ptt::to_f(ptt::from_f<T>(v));
    C[at] = ptt::from_f<T>(v);
  }
}

}  // namespace gemm
}  // namespace ptt
