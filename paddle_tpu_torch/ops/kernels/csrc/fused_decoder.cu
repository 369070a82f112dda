// The whole Llama decoder block in one launch, for Hopper.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/fused_block.py
// `_decoder_kernel` (:830):
//   y = x2 + mlp(rmsnorm(x2) * wn2),  x2 = x + attn(rmsnorm(x) * wn1) wo
// with RoPE on q and k, causal attention with GQA (query head h reads kv
// head h / (H / HK)) and the SwiGLU MLP.
//
// Why not a translation: the TPU kernel walks its grid (batch, row tile i,
// inner phase j) in order on one core and keeps the whole sequence's K/V in
// VMEM scratch, so row tile i finds rows 0..i already projected.  Hopper
// runs blocks in parallel in no order and gives a block 227 KB, so here the
// launch is one persistent cooperative kernel (cudaLaunchCooperativeKernel,
// as many blocks as fit on the 132 SMs at once) that walks seven phases,
// each a loop over its work items strided by the grid, with a grid-wide
// barrier (cooperative_groups grid.sync) between phases:
//   0  norm1        one warp per row: xn = (x * inv) * wn1, cast to T
//   1  q | k | v    64 x 64 GEMM tiles of xn @ (wq | wk | wv), cast to T
//   1b RoPE         q and k rotated in place in fp32, cast to T again
//   2  attention    one flash forward tile per (64-row q block, head,
//                   batch) (32 rows in fp32), heaviest q blocks first
//   3  o-proj       tiles of attn @ wo, cast to T, then x2 = x + that in T
//   4  norm2 + MLP  one warp per row: xn = (x2 * inv) * wn2, cast to T;
//                   then tiles of h = silu(xn wg) * (xn wu), cast to T
//   5  down         tiles of h @ wd, cast to T, then y = x2 + that in T
// Every cast point is the TPU kernel's (and _decoder_reference's,
// fused_block.py:1043-1073): norms in the fused form (fp32 multiply by the
// weight, one cast), fp32 products cast once, p cast to V's type before PV,
// o = acc / l with the l > 0 guard, the residual adds in T.
//
// The GEMM phases call gemm_tile.cuh's tile (fused_block.cu's kernels) and
// the attention phase flash_tile.cuh's forward tile (flash_attention.cu's
// forward kernel); tiles are visited in groups of 8 row tiles, so the
// weight column panels and the rows a wave of blocks reads stay in L2.
//
// Workspace: xn, q, k, v, the attention output, x2 and h live in device
// memory that the wrapper allocates (T * (2 d + 2 dq + 2 dkv + f) elements:
// 0.52 GB at T = 8192 in bf16, h [8192, 14336] the most); every phase
// reads the previous one's output through L2 (cp.async.cg or ld.global.cg),
// never through a stale L1 line.  Keeping it on chip, with tile-level
// dependencies in place of the grid barriers, is later work.
//
// What bounds it: the products (436 MFLOP a token at Llama-3-8B width plus
// causal attention): the same wmma tiles as the per-segment kernels, so
// the same ~15% of the tensor cores' peak; the barriers cost the tail of
// each phase.
#include <cooperative_groups.h>

#include "flash_tile.cuh"
#include "gemm_tile.cuh"

namespace {

namespace cgr = cooperative_groups;
using ptt::gemm::GemmArgs;
using ptt::gemm::gemm_tile;
using ptt::gemm::MODE_GATEUP;
using ptt::gemm::MODE_PLAIN;
using ptt::gemm::MODE_RESID;
using ptt::gemm::smem_bytes;

constexpr int NT = 128;       // threads per block, both tiles'
constexpr int HD = 128;       // the head_dim the flash tile is built for
constexpr int BM = 64;        // GEMM row tile
constexpr int BN = ptt::gemm::BN;
constexpr int GROUP = 8;      // row tiles per group of the tile order
// 1 / sqrt(HD) rounded once to fp32, as the wrappers' Python float scale is
constexpr float SCALE = 0.08838834764831845f;
static_assert(ptt::gemm::NT == NT && ptt::flash::NT == NT,
              "the GEMM and flash tiles must share the block size");

struct DecArgs {
  const void* x;                       // [T, d]
  const void *wn1, *wq, *wk, *wv;      // [d], [d, dq], [d, dkv], [d, dkv]
  const float *cos, *sin;              // [s, HD / 2] fp32
  const void *wo, *wn2, *wg, *wu, *wd; // [dq, d], [d], [d, f] x2, [f, d]
  void* y;                             // [T, d]
  void *xn, *q, *k, *v, *attn, *x2, *h;   // workspace
  int b, s, d, dq, dkv, f, nh, nkvh;
  float eps;
};

template <typename T>
constexpr size_t smem_plan() {
  constexpr size_t fl = ptt::flash::Plan<T, HD>::FWD;
  constexpr size_t gu = smem_bytes<T, BM, MODE_GATEUP>();
  constexpr size_t pl = smem_bytes<T, BM, MODE_PLAIN>();
  constexpr size_t rs = smem_bytes<T, BM, MODE_RESID>();
  constexpr size_t m = fl > gu ? fl : gu;
  constexpr size_t n = pl > rs ? pl : rs;
  return m > n ? m : n;
}

// tile t of an nrow x ncol grid of output tiles: groups of GROUP row tiles,
// row tiles fastest inside a group
__device__ __forceinline__ void tile_of(int t, int nrow, int ncol, int& rt,
                                        int& ct) {
  const int per = GROUP * ncol;
  const int first = (t / per) * GROUP;
  const int rows = min(GROUP, nrow - first);
  const int in = t % per;
  rt = first + in % rows;
  ct = in / rows;
}

// dst = (src * inv) * w cast to T, inv = rsqrt(mean(src^2) + eps) in fp32:
// one warp per row, 16-byte loads through L2 (d is a multiple of 64)
template <typename T>
__device__ void norm_rows(const T* src, const T* w, T* dst, int rows, int d,
                          float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int nw = gridDim.x * (NT / 32);
  for (int r = blockIdx.x * (NT / 32) + threadIdx.x / 32; r < rows; r += nw) {
    const uint4* row = reinterpret_cast<const uint4*>(src + (size_t)r * d);
    float ss = 0.f;
    for (int c = lane; c < d / V; c += 32) {
      uint4 raw = __ldcg(row + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = ptt::to_f(e[i]);
        ss += v * v;
      }
    }
    ss = ptt::warp_sum(ss);
    const float inv = rsqrtf(ss / (float)d + eps);
    const uint4* wr = reinterpret_cast<const uint4*>(w);
    uint4* out = reinterpret_cast<uint4*>(dst + (size_t)r * d);
    for (int c = lane; c < d / V; c += 32) {
      uint4 raw = __ldcg(row + c), wv = wr[c], o;
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* we = reinterpret_cast<const T*>(&wv);
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int i = 0; i < V; ++i)
        oe[i] = ptt::from_f<T>((ptt::to_f(e[i]) * inv) * ptt::to_f(we[i]));
      out[c] = o;
    }
  }
}

// RoPE in place on the q [T, nh, HD] and k [T, nkvh, HD] rows, position
// r % s, the half-rotation of _rope_ref (fused_block.py:1031-1040)
template <typename T>
__device__ void rope_rows(T* q, T* k, const float* cos, const float* sin,
                          int rows, int s, int nh, int nkvh) {
  constexpr int HH = HD / 2;
  const int heads = nh + nkvh;
  const size_t n = (size_t)rows * heads * HH;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n;
       e += (size_t)gridDim.x * NT) {
    const int i = (int)(e % HH);
    const size_t rh = e / HH;
    const int hh = (int)(rh % heads);
    const int r = (int)(rh / heads);
    T* base = hh < nh ? q + ((size_t)r * nh + hh) * HD
                      : k + ((size_t)r * nkvh + hh - nh) * HD;
    const int pos = r % s;
    const float c = cos[pos * HH + i], sn = sin[pos * HH + i];
    const float x1 = ptt::to_f(ptt::ldcg(base + i));
    const float x2 = ptt::to_f(ptt::ldcg(base + i + HH));
    base[i] = ptt::from_f<T>(x1 * c - x2 * sn);
    base[i + HH] = ptt::from_f<T>(x2 * c + x1 * sn);
  }
}

// every tile of one GEMM phase
template <typename T, int MODE>
__device__ void gemm_phase(const GemmArgs& g, int ncol, unsigned char* smem) {
  const int nrow = (g.T + BM - 1) / BM;
  for (int t = blockIdx.x; t < nrow * ncol; t += gridDim.x) {
    int rt, ct;
    tile_of(t, nrow, ncol, rt, ct);
    gemm_tile<T, BM, MODE>(g, rt, ct, smem);
    __syncthreads();   // the next tile's prologue refills shared memory
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) decoder_kernel(DecArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cgr::grid_group grid = cgr::this_grid();
  const int rows = a.b * a.s;

  // 0: norm1
  norm_rows<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.wn1),
               static_cast<T*>(a.xn), rows, a.d, a.eps);
  grid.sync();

  // 1: the q | k | v column tiles
  {
    const int nq = a.dq / BN, nk = a.dkv / BN, ncol = nq + 2 * nk;
    const int nrow = (rows + BM - 1) / BM;
    for (int t = blockIdx.x; t < nrow * ncol; t += gridDim.x) {
      int rt, ct;
      tile_of(t, nrow, ncol, rt, ct);
      const void* w = a.wq;
      void* out = a.q;
      int n = a.dq;
      if (ct >= nq + nk) {
        w = a.wv, out = a.v, n = a.dkv, ct -= nq + nk;
      } else if (ct >= nq) {
        w = a.wk, out = a.k, n = a.dkv, ct -= nq;
      }
      GemmArgs g{a.xn, w, nullptr, nullptr, nullptr, out, nullptr, nullptr,
                 rows, a.d, n, 0, 0.f};
      gemm_tile<T, BM, MODE_PLAIN>(g, rt, ct, smem);
      __syncthreads();
    }
  }
  grid.sync();

  // 1b: RoPE
  rope_rows<T>(static_cast<T*>(a.q), static_cast<T*>(a.k), a.cos, a.sin,
               rows, a.s, a.nh, a.nkvh);
  grid.sync();

  // 2: causal attention, heaviest q blocks first
  {
    using P = ptt::flash::Plan<T, HD>;
    ptt::flash::Args fa{a.q, a.k, a.v, a.attn, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, a.s, a.nh, a.nkvh,
                        SCALE, 1};
    const int nqb = a.s / P::BQ, bh = a.b * a.nh;
    for (int t = blockIdx.x; t < nqb * bh; t += gridDim.x) {
      const int qi = nqb - 1 - t / bh, h = t % a.nh, bb = (t % bh) / a.nh;
      ptt::flash::flash_fwd_tile<T, HD>(fa, qi, h, bb, smem);
      __syncthreads();
    }
  }
  grid.sync();

  // 3: o-projection + residual: x2 = x + attn @ wo
  {
    GemmArgs g{a.attn, a.wo, nullptr, nullptr, nullptr, a.x2, nullptr,
               nullptr, rows, a.dq, a.d, 0, 0.f};
    g.resid = a.x;
    gemm_phase<T, MODE_RESID>(g, a.d / BN, smem);
  }
  grid.sync();

  // 4: norm2, then h = silu(xn @ wg) * (xn @ wu)
  norm_rows<T>(static_cast<const T*>(a.x2), static_cast<const T*>(a.wn2),
               static_cast<T*>(a.xn), rows, a.d, a.eps);
  grid.sync();
  {
    GemmArgs g{a.xn, a.wg, a.wu, nullptr, nullptr, a.h, nullptr, nullptr,
               rows, a.d, a.f, 0, 0.f};
    gemm_phase<T, MODE_GATEUP>(g, a.f / BN, smem);
  }
  grid.sync();

  // 5: down projection + residual: y = x2 + h @ wd
  {
    GemmArgs g{a.h, a.wd, nullptr, nullptr, nullptr, a.y, nullptr, nullptr,
               rows, a.f, a.d, 0, 0.f};
    g.resid = a.x2;
    gemm_phase<T, MODE_RESID>(g, a.d / BN, smem);
  }
}

// the cooperative grid: every block resident at once, or no launch
template <typename T>
cudaError_t grid_of(int* per_sm, int* sms) {
  constexpr size_t smem = smem_plan<T>();
  static_assert(smem <= 232448, "shared memory plan exceeds 227 KB");
  auto kern = decoder_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, NT,
                                                         smem)) != cudaSuccess)
    return e;
  return *per_sm < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

template <typename T>
int launch(DecArgs a, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t e = grid_of<T>(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)decoder_kernel<T>,
                                  dim3(per_sm * sms), dim3(NT), params,
                                  smem_plan<T>(), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = the decoder block of x [b * s, d] (see the top of this file); weights
// [in, out] in x's type, cos/sin [s, 64] fp32; xn, q, k, v, attn, x2, h the
// workspace ([T, d], [T, dq], [T, dkv] x2, [T, dq], [T, d], [T, f]).
int ptt_fused_decoder(int dtype, const void* x, const void* wn1,
                      const void* wq, const void* wk, const void* wv,
                      const void* cos, const void* sin, const void* wo,
                      const void* wn2, const void* wg, const void* wu,
                      const void* wd, void* y, void* xn, void* q, void* k,
                      void* v, void* attn, void* x2, void* h, int b, int s,
                      int d, int dq, int dkv, int f, int nh, int nkvh,
                      float eps, void* stream) {
  if (b <= 0 || s <= 0 || s % 64 != 0 || d <= 0 || d % 64 != 0 ||
      f <= 0 || f % 64 != 0 || nh <= 0 || nkvh <= 0 || nh % nkvh != 0 ||
      dq != nh * HD || dkv != nkvh * HD)
    return (int)cudaErrorInvalidValue;
  DecArgs a{x, wn1, wq, wk, wv, static_cast<const float*>(cos),
            static_cast<const float*>(sin), wo, wn2, wg, wu, wd, y, xn, q, k,
            v, attn, x2, h, b, s, d, dq, dkv, f, nh, nkvh, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16) return launch<__nv_bfloat16>(a, st);
  if (dtype == ptt::DT_FLOAT32) return launch<float>(a, st);
  return (int)cudaErrorInvalidValue;
}

// out[0] blocks per SM, out[1] SMs, out[2] dynamic shared memory bytes of
// the cooperative grid for `dtype`
int ptt_fused_decoder_grid(int dtype, void* out) {
  int* o = static_cast<int*>(out);
  if (dtype == ptt::DT_BFLOAT16) {
    o[2] = (int)smem_plan<__nv_bfloat16>();
    return (int)grid_of<__nv_bfloat16>(o, o + 1);
  }
  if (dtype == ptt::DT_FLOAT32) {
    o[2] = (int)smem_plan<float>();
    return (int)grid_of<float>(o, o + 1);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
