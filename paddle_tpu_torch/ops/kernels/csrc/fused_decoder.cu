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
// as many blocks as fit on the 132 SMs at once) that walks its phases, each
// a loop over its work items strided by the grid, with a grid-wide barrier
// (cooperative_groups grid.sync) between phases.  Every cast point is the
// TPU kernel's (and _decoder_reference's, fused_block.py:1043-1073): norms
// in the fused form (fp32 multiply by the weight, one cast), fp32 products
// cast once, RoPE in fp32 on the cast q and k and cast again (_rope_ref),
// p cast to V's type before PV, o = acc / l with the l > 0 guard, the
// residual adds in T.
//
// bf16 (decoder_hopper): one block of three warpgroups a SM, warpgroup 0
// the producer (one thread issues every TMA load), warpgroups 1 and 2 the
// consumers (64 rows each of a 128-row tile), setmaxnreg moving registers
// from the first to the others for the whole launch.  Seven phases, in
// order:
//   norm1     the consumers' warps, a row each: xn = (x * inv) * wn1, cast
//   q | k | v hopper_gemm.cuh's ring, xn @ [wq | wk | wv] in 128 x 256
//             tiles, two whole heads each (a part's last tile may hold one
//             and TMA's zeros); RoPE in the epilogue: in wgmma's
//             accumulator layout the thread that holds column c of a head
//             also holds column c + 64 (fragment entries 4 i + .. and
//             4 (i + 8) + ..), so the rotation is register-local: the fp32
//             product cast to T, RoPE in fp32 of the cast values
//             (unfused multiplies and adds, _rope_ref's order), cast again
//   attention flash_hopper.cuh's forward, one item per (128-row q tile,
//             head, batch), heaviest q tiles first, over 4-d tensor maps of
//             the q, k, v workspace ([b, s, heads, 128]); no lse
//   o-proj    the ring, x2 = x + cast(attn @ wo), the add in T
//   norm2     as norm1: xn = (x2 * inv) * wn2, cast
//   gate/up   the ring with the gate and up weights in one slot (128 x 128
//             of each): h = cast(silu(g) * u)
//   down      the ring, y = x2 + cast(h @ wd)
// with a grid barrier after each of the first six.  One ring serves all
// four GEMM phases (the 128 x 256 and the gate/up slots have one size) and
// one running slice count on each side carries its slots' phases across
// them; the flash phase's Q / K / V tiles overlay the ring's slots, its
// mbarriers do not (static shared memory).  The producer warpgroup's
// threads meet every grid barrier (no thread returns early).  Phases
// whose output TMA reads next (xn, q, k, v, attn, h) are written with
// ordinary stores: every thread fences the async proxy
// (fence.proxy.async.global) before each barrier and the producer thread
// after it.
//
// Workspace: xn, q, k, v, the attention output, x2 and h live in device
// memory that the wrapper allocates (T * (2 d + 2 dq + 2 dkv + f) elements:
// 0.52 GB at T = 8192 in bf16, h [8192, 14336] the most); the threads read
// x2 through L2 (ld.global.cg), never through a stale L1 line.  Keeping h
// and the attention output on chip, with tile-level dependencies in place
// of the grid barriers, is later work.
//
// What bounds it: the products (436 MFLOP a token at Llama-3-8B width plus
// causal attention: 3.75 ms at b = 4, s = 2048 at 989 TFLOP/s); the
// barriers cost the tail of each phase.
//
// fp32 (decoder_kernel, a parity path on no main path) keeps the first
// design: 128-thread blocks, gemm_tile.cuh's 64 x 64 tile for the GEMM
// phases and flash_tile.cuh's forward tile, RoPE as its own pass, seven
// barriers.
#include <cooperative_groups.h>

#include "flash_hopper.cuh"
#include "flash_tile.cuh"
#include "gemm_tile.cuh"
#include "hopper_gemm.cuh"

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

// dst = (src * inv) * w cast to T, inv = rsqrt(mean(src^2) + eps) in fp32:
// one warp a row (warp `wid` of the grid's `nw` taking rows wid, wid + nw,
// ...), 16-byte loads through L2 (d is a multiple of 64)
template <typename T>
__device__ __forceinline__ void norm_rows(const T* src, const T* w, T* dst,
                                          int rows, int d, float eps,
                                          int wid, int nw) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  for (int r = wid; r < rows; r += nw) {
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
    ptt::hopper::band_tile(t, nrow, ncol, GROUP, rt, ct);
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
  const int wid = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int nw = gridDim.x * (NT / 32);
  norm_rows<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.wn1),
               static_cast<T*>(a.xn), rows, a.d, a.eps, wid, nw);
  grid.sync();

  // 1: the q | k | v column tiles
  {
    const int nq = a.dq / BN, nk = a.dkv / BN, ncol = nq + 2 * nk;
    const int nrow = (rows + BM - 1) / BM;
    for (int t = blockIdx.x; t < nrow * ncol; t += gridDim.x) {
      int rt, ct;
      ptt::hopper::band_tile(t, nrow, ncol, GROUP, rt, ct);
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
               static_cast<T*>(a.xn), rows, a.d, a.eps, wid, nw);
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

int launch_fp32(DecArgs a, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t e = grid_of<float>(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)decoder_kernel<float>,
                                  dim3(per_sm * sms), dim3(NT), params,
                                  smem_plan<float>(), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// -- bf16: persistent phases on the wgmma / TMA ring --------------------------

namespace hop {

using bf16 = __nv_bfloat16;
using namespace ptt::hopper;
constexpr int NC = 2;                   // consumer warpgroups
constexpr int THREADS = 128 * (NC + 1);
constexpr int STAGES = 4;
constexpr int TM = 64 * NC;             // rows of a GEMM tile
constexpr int WIDE = 256;               // q | k | v, o-proj and down
constexpr int GU = 128;                 // gate/up: of each weight
constexpr int BAND = 16;                // row tiles a band of a GEMM walk
using Ring = GemmRing<NC, WIDE, STAGES, 1>;
using RingGU = GemmRing<NC, GU, STAGES, 2>;
constexpr size_t SMEM = GemmPlan<NC, WIDE, STAGES, 1>::SMEM;
static_assert(ptt::fwd::BYTES <=
                  STAGES * GemmPlan<NC, WIDE, STAGES, 1>::STAGE_BYTES,
              "the flash tiles lie inside the ring's slots");
static_assert(SMEM <= 232448, "shared memory plan exceeds 227 KB");

struct Params {
  CUtensorMap xn, wq, wk, wv;   // q | k | v: A, and B of each part
  CUtensorMap fq, fk, fv;       // attention: 4-d maps of q, k, v
  CUtensorMap attn, wo;         // o-proj
  CUtensorMap wg, wu;           // gate/up (A: xn)
  CUtensorMap h, wd;            // down
  const bf16 *x, *wn1, *wn2;
  const float *cos, *sin;       // [s, 64] fp32
  bf16 *y, *xn_w, *q, *k, *v, *attn_w, *x2, *h_w;   // output, workspace
  int b, s, d, dq, dkv, f, nh, nkvh, T, row_tiles;
  float eps, scale2;
};

// Every thread of every block: this phase's ordinary stores made visible
// to the async proxy (the next phase's TMA loads), then the grid barrier.
__device__ __forceinline__ void phase_barrier(cgr::grid_group& grid) {
  fence_proxy_async_global();
  grid.sync();
}

// the q | k | v walk: tile t -> rows m0.., part (0 q, 1 k, 2 v), columns
// n0.. of that part
__device__ __forceinline__ void qkv_tile(const Params& p, int t, int& m0,
                                         int& part, int& n0) {
  const int tq = (p.dq + WIDE - 1) / WIDE, tk = (p.dkv + WIDE - 1) / WIDE;
  int rt, ct;
  band_tile(t, p.row_tiles, tq + 2 * tk, BAND, rt, ct);
  m0 = rt * TM;
  part = ct < tq ? 0 : ct < tq + tk ? 1 : 2;
  n0 = (part == 0 ? ct : part == 1 ? ct - tq : ct - tq - tk) * WIDE;
}

__device__ __forceinline__ int qkv_tiles(const Params& p) {
  return p.row_tiles *
         ((p.dq + WIDE - 1) / WIDE + 2 * ((p.dkv + WIDE - 1) / WIDE));
}

// a bf16 value of an fp32 one, back in fp32 (torch's .to(bf16).float())
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The q | k | v epilogue of consumer c (warp w, lane): cast once; for q and
// k then RoPE (_rope_ref, fused_block.py:1031-1040) on the cast values in
// fp32, half i of a head pairing column j with j + 64 in the same thread
// (fragment entries 4 i + 2 hh + e and 4 (i + 8) + 2 hh + e of each
// 128-column head), no fused multiply-add, and cast again.
__device__ __forceinline__ void store_qkv(const Params& p,
                                          const float (&acc)[WIDE / 2],
                                          int part, int m0, int n0, int c,
                                          int w, int lane) {
  const int n = part == 0 ? p.dq : p.dkv;
  bf16* out = part == 0 ? p.q : part == 1 ? p.k : p.v;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 64 * c + 16 * w + lane / 4 + 8 * hh;
    if (row >= p.T) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + (size_t)row * n);
    const int pos = row % p.s;
#pragma unroll
    for (int hd = 0; hd < WIDE / 128; ++hd) {
      const int col0 = n0 + 128 * hd;   // the head's first column
      if (col0 >= n) continue;          // n is a multiple of 128
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = 8 * i + 2 * (lane % 4);   // column in the half head
        const int a = 4 * (16 * hd + i) + 2 * hh, b = a + 32;
        float x1[2] = {rbf(acc[a]), rbf(acc[a + 1])};
        float x2[2] = {rbf(acc[b]), rbf(acc[b + 1])};
        if (part < 2) {
          const float2 cs = __ldg(reinterpret_cast<const float2*>(
              p.cos + (size_t)pos * 64 + j));
          const float2 sn = __ldg(reinterpret_cast<const float2*>(
              p.sin + (size_t)pos * 64 + j));
          const float cv[2] = {cs.x, cs.y}, sv[2] = {sn.x, sn.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float r1 = __fsub_rn(__fmul_rn(x1[e], cv[e]),
                                       __fmul_rn(x2[e], sv[e]));
            const float r2 = __fadd_rn(__fmul_rn(x2[e], cv[e]),
                                       __fmul_rn(x1[e], sv[e]));
            x1[e] = r1;
            x2[e] = r2;
          }
        }
        orow[(col0 + j) / 2] = pack_bf16(x1[0], x1[1]);
        orow[(col0 + 64 + j) / 2] = pack_bf16(x2[0], x2[1]);
      }
    }
  }
}

// out = resid + cast(acc), the add in bf16 (resid read through L2): the
// o-projection's x2 and the down product's y, N = d
__device__ __forceinline__ void store_resid(const Params& p,
                                            const float (&acc)[WIDE / 2],
                                            const bf16* resid, bf16* out,
                                            int m0, int n0, int c, int w,
                                            int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 64 * c + 16 * w + lane / 4 + 8 * hh;
    if (row >= p.T) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + (size_t)row * p.d);
    const unsigned int* rrow =
        reinterpret_cast<const unsigned int*>(resid + (size_t)row * p.d);
#pragma unroll
    for (int i = 0; i < WIDE / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      if (col >= p.d) continue;
      const unsigned int raw = __ldcg(rrow + col / 2);
      const float2 r = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw));
      orow[col / 2] = pack_bf16(r.x + rbf(acc[4 * i + 2 * hh]),
                                r.y + rbf(acc[4 * i + 2 * hh + 1]));
    }
  }
}

// h = cast(silu(g) * u) from the two fp32 accumulators
__device__ __forceinline__ void store_gateup(const Params& p,
                                             const float (&g)[GU / 2],
                                             const float (&u)[GU / 2],
                                             int m0, int n0, int c, int w,
                                             int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 64 * c + 16 * w + lane / 4 + 8 * hh;
    if (row >= p.T) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(p.h_w + (size_t)row * p.f);
#pragma unroll
    for (int i = 0; i < GU / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      if (col >= p.f) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gv = g[4 * i + 2 * hh + e];
        v[e] = (gv * (1.f / (1.f + expf(-gv)))) * u[4 * i + 2 * hh + e];
      }
      orow[col / 2] = pack_bf16(v[0], v[1]);
    }
  }
}

// the consumer warpgroups: the row phases and every tile's products and
// epilogue
__device__ __forceinline__ void consume(const Params& p, const Ring& ring,
                                        const ptt::fwd::Ring& fr,
                                        cgr::grid_group& grid) {
  const RingGU ring2 = ring_as<GU, 2>(ring);
  const int c = threadIdx.x / 128 - 1, w = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  // consumer warps of the grid, for the row phases
  const int wid = blockIdx.x * 4 * NC + threadIdx.x / 32 - 4;
  const int nw = gridDim.x * 4 * NC;
  int it = 0;   // the ring's running slice count (the producer's twin)

  norm_rows<bf16>(p.x, p.wn1, p.xn_w, p.T, p.d, p.eps, wid, nw);
  phase_barrier(grid);

  {  // q | k | v with RoPE
    float acc[WIDE / 2], none[1];
    const int tiles = qkv_tiles(p);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, part, n0;
      qkv_tile(p, t, m0, part, n0);
      gemm_consume(ring, p.d, c, acc, none, it);
      store_qkv(p, acc, part, m0, n0, c, w, lane);
    }
  }
  phase_barrier(grid);

  {  // causal attention
    const int nq = (p.s + ptt::fwd::BQ - 1) / ptt::fwd::BQ;
    const int items = nq * p.b * p.nh;
    int kv = 0, n = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x, ++n) {
      const ptt::fwd::Item wi =
          ptt::fwd::causal_item(t, nq, p.b, p.nh, p.nkvh, p.s);
      ptt::fwd::consume<true>(fr, wi, n, kv, c, p.s, p.nh, p.scale2, true,
                        p.attn_w, nullptr);
    }
  }
  phase_barrier(grid);

  const int ct_d = (p.d + WIDE - 1) / WIDE;
  {  // o-projection + residual
    float acc[WIDE / 2], none[1];
    for (int t = blockIdx.x; t < p.row_tiles * ct_d; t += gridDim.x) {
      int rt, ct;
      band_tile(t, p.row_tiles, ct_d, BAND, rt, ct);
      gemm_consume(ring, p.dq, c, acc, none, it);
      store_resid(p, acc, p.x, p.x2, rt * TM, ct * WIDE, c, w, lane);
    }
  }
  phase_barrier(grid);

  norm_rows<bf16>(p.x2, p.wn2, p.xn_w, p.T, p.d, p.eps, wid, nw);
  phase_barrier(grid);

  {  // gate/up
    float g[GU / 2], u[GU / 2];
    const int ct_f = (p.f + GU - 1) / GU;
    for (int t = blockIdx.x; t < p.row_tiles * ct_f; t += gridDim.x) {
      int rt, ct;
      band_tile(t, p.row_tiles, ct_f, BAND, rt, ct);
      gemm_consume(ring2, p.d, c, g, u, it);
      store_gateup(p, g, u, rt * TM, ct * GU, c, w, lane);
    }
  }
  phase_barrier(grid);

  {  // down + residual
    float acc[WIDE / 2], none[1];
    for (int t = blockIdx.x; t < p.row_tiles * ct_d; t += gridDim.x) {
      int rt, ct;
      band_tile(t, p.row_tiles, ct_d, BAND, rt, ct);
      gemm_consume(ring, p.f, c, acc, none, it);
      store_resid(p, acc, p.x2, p.y, rt * TM, ct * WIDE, c, w, lane);
    }
  }
}

// the producer warpgroup: thread 0 issues every TMA load, all 128 threads
// meet every grid barrier
__device__ __forceinline__ void produce(const Params& p, const Ring& ring,
                                        const ptt::fwd::Ring& fr,
                                        cgr::grid_group& grid) {
  const RingGU ring2 = ring_as<GU, 2>(ring);
  const bool issuer = threadIdx.x == 0;
  int it = 0;
  phase_barrier(grid);   // norm1

  if (issuer) {   // q | k | v
    fence_proxy_async_global();
    const int tiles = qkv_tiles(p);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, part, n0;
      qkv_tile(p, t, m0, part, n0);
      gemm_produce(ring, &p.xn, part == 0 ? &p.wq : part == 1 ? &p.wk : &p.wv,
                   m0, n0, p.d, nullptr, it);
    }
  }
  phase_barrier(grid);

  if (issuer) {   // attention
    fence_proxy_async_global();
    const int nq = (p.s + ptt::fwd::BQ - 1) / ptt::fwd::BQ;
    const int items = nq * p.b * p.nh;
    int kv = 0, n = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x, ++n)
      ptt::fwd::produce<true>(fr, &p.fq, &p.fk, &p.fv,
                        ptt::fwd::causal_item(t, nq, p.b, p.nh, p.nkvh, p.s),
                        n, kv);
  }
  phase_barrier(grid);

  const int ct_d = (p.d + WIDE - 1) / WIDE;
  if (issuer) {   // o-projection
    fence_proxy_async_global();
    for (int t = blockIdx.x; t < p.row_tiles * ct_d; t += gridDim.x) {
      int rt, ct;
      band_tile(t, p.row_tiles, ct_d, BAND, rt, ct);
      gemm_produce(ring, &p.attn, &p.wo, rt * TM, ct * WIDE, p.dq, nullptr,
                   it);
    }
  }
  phase_barrier(grid);
  phase_barrier(grid);   // norm2

  if (issuer) {   // gate/up
    fence_proxy_async_global();
    const int ct_f = (p.f + GU - 1) / GU;
    for (int t = blockIdx.x; t < p.row_tiles * ct_f; t += gridDim.x) {
      int rt, ct;
      band_tile(t, p.row_tiles, ct_f, BAND, rt, ct);
      gemm_produce(ring2, &p.xn, &p.wg, rt * TM, ct * GU, p.d, &p.wu, it);
    }
  }
  phase_barrier(grid);

  if (issuer) {   // down
    fence_proxy_async_global();
    for (int t = blockIdx.x; t < p.row_tiles * ct_d; t += gridDim.x) {
      int rt, ct;
      band_tile(t, p.row_tiles, ct_d, BAND, rt, ct);
      gemm_produce(ring, &p.h, &p.wd, rt * TM, ct * WIDE, p.f, nullptr, it);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
decoder_hopper(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qfull, qempty, kfull[ptt::fwd::ST], vfull[ptt::fwd::ST],
      kvempty[ptt::fwd::ST];
  const Ring ring = gemm_ring<NC, WIDE, STAGES, 1>(smem_raw);
  const ptt::fwd::Ring fr{ring.base, &qfull, &qempty, kfull, vfull, kvempty};
  if (threadIdx.x == 0) ptt::fwd::ring_init(fr);
  __syncthreads();
  cgr::grid_group grid = cgr::this_grid();
  if (threadIdx.x < 128) {
    regs_dec<40>();
    produce(p, ring, fr, grid);
  } else {
    regs_inc<232>();
    consume(p, ring, fr, grid);
  }
}

// a bf16 [rows, K] operand (A) in boxes of {64, TM}, or a weight [K, N]
// (B) in boxes of {64, 64}
cudaError_t map_a(CUtensorMap* m, const void* base, int rows, int K) {
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)rows};
  const uint64_t stride[1] = {(uint64_t)K * 2};
  const uint32_t box[2] = {64, (uint32_t)TM};
  return make_map(m, base, 2, dims, stride, box);
}
cudaError_t map_b(CUtensorMap* m, const void* base, int K, int N) {
  const uint64_t dims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t stride[1] = {(uint64_t)N * 2};
  const uint32_t box[2] = {64, 64};
  return make_map(m, base, 2, dims, stride, box);
}
// [b, s, heads, 128] in boxes of 64 d x 1 head x `rows` rows
cudaError_t map_bshd(CUtensorMap* m, const void* base, int B, int S,
                     int heads, int rows) {
  const uint64_t dims[4] = {128, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {256, (uint64_t)heads * 256,
                               (uint64_t)S * heads * 256};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return make_map(m, base, 4, dims, strides, box);
}

// the cooperative grid: one block a SM, or no launch
cudaError_t grid_of(int* per_sm, int* sms) {
  cudaError_t e = cudaFuncSetAttribute(
      decoder_hopper, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
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
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, decoder_hopper, THREADS, SMEM)) != cudaSuccess)
    return e;
  return *per_sm < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

int launch(const DecArgs& a, cudaStream_t stream) {
  Params p{};
  const int T = a.b * a.s;
  cudaError_t e = map_a(&p.xn, a.xn, T, a.d);
  if (e == cudaSuccess) e = map_b(&p.wq, a.wq, a.d, a.dq);
  if (e == cudaSuccess) e = map_b(&p.wk, a.wk, a.d, a.dkv);
  if (e == cudaSuccess) e = map_b(&p.wv, a.wv, a.d, a.dkv);
  if (e == cudaSuccess) e = map_bshd(&p.fq, a.q, a.b, a.s, a.nh, 128);
  if (e == cudaSuccess) e = map_bshd(&p.fk, a.k, a.b, a.s, a.nkvh, 64);
  if (e == cudaSuccess) e = map_bshd(&p.fv, a.v, a.b, a.s, a.nkvh, 64);
  if (e == cudaSuccess) e = map_a(&p.attn, a.attn, T, a.dq);
  if (e == cudaSuccess) e = map_b(&p.wo, a.wo, a.dq, a.d);
  if (e == cudaSuccess) e = map_b(&p.wg, a.wg, a.d, a.f);
  if (e == cudaSuccess) e = map_b(&p.wu, a.wu, a.d, a.f);
  if (e == cudaSuccess) e = map_a(&p.h, a.h, T, a.f);
  if (e == cudaSuccess) e = map_b(&p.wd, a.wd, a.f, a.d);
  if (e != cudaSuccess) return (int)e;
  p.x = static_cast<const bf16*>(a.x);
  p.wn1 = static_cast<const bf16*>(a.wn1);
  p.wn2 = static_cast<const bf16*>(a.wn2);
  p.cos = a.cos;
  p.sin = a.sin;
  p.y = static_cast<bf16*>(a.y);
  p.xn_w = static_cast<bf16*>(a.xn);
  p.q = static_cast<bf16*>(a.q);
  p.k = static_cast<bf16*>(a.k);
  p.v = static_cast<bf16*>(a.v);
  p.attn_w = static_cast<bf16*>(a.attn);
  p.x2 = static_cast<bf16*>(a.x2);
  p.h_w = static_cast<bf16*>(a.h);
  p.b = a.b;
  p.s = a.s;
  p.d = a.d;
  p.dq = a.dq;
  p.dkv = a.dkv;
  p.f = a.f;
  p.nh = a.nh;
  p.nkvh = a.nkvh;
  p.T = T;
  p.row_tiles = (T + TM - 1) / TM;
  p.eps = a.eps;
  p.scale2 = SCALE * 1.4426950408889634f;
  int per_sm = 0, sms = 0;
  if ((e = grid_of(&per_sm, &sms)) != cudaSuccess) return (int)e;
  void* params[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)decoder_hopper,
                                  dim3(per_sm * sms), dim3(THREADS), params,
                                  SMEM, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace hop

}  // namespace

extern "C" {

// y = the decoder block of x [b * s, d] (see the top of this file); weights
// [in, out] in x's type, cos/sin [s, 64] fp32; xn, q, k, v, attn, x2, h the
// workspace ([T, d], [T, dq], [T, dkv] x2, [T, dq], [T, d], [T, f]);
// design (an int) receives the design launched (enum Design).
int ptt_fused_decoder(int dtype, const void* x, const void* wn1,
                      const void* wq, const void* wk, const void* wv,
                      const void* cos, const void* sin, const void* wo,
                      const void* wn2, const void* wg, const void* wu,
                      const void* wd, void* y, void* xn, void* q, void* k,
                      void* v, void* attn, void* x2, void* h, int b, int s,
                      int d, int dq, int dkv, int f, int nh, int nkvh,
                      float eps, void* stream, void* design) {
  if (b <= 0 || s <= 0 || s % 64 != 0 || d <= 0 || d % 64 != 0 ||
      f <= 0 || f % 64 != 0 || nh <= 0 || nkvh <= 0 || nh % nkvh != 0 ||
      dq != nh * HD || dkv != nkvh * HD)
    return (int)cudaErrorInvalidValue;
  DecArgs a{x, wn1, wq, wk, wv, static_cast<const float*>(cos),
            static_cast<const float*>(sin), wo, wn2, wg, wu, wd, y, xn, q, k,
            v, attn, x2, h, b, s, d, dq, dkv, f, nh, nkvh, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DT_BFLOAT16)
    return ptt::launched(hop::launch(a, st), design, ptt::DESIGN_WGMMA);
  if (dtype == ptt::DT_FLOAT32)
    return ptt::launched(launch_fp32(a, st), design, ptt::DESIGN_TILE);
  return (int)cudaErrorInvalidValue;
}

// out[0] blocks per SM, out[1] SMs, out[2] dynamic shared memory bytes of
// the cooperative grid for `dtype`
int ptt_fused_decoder_grid(int dtype, void* out) {
  int* o = static_cast<int*>(out);
  if (dtype == ptt::DT_BFLOAT16) {
    o[2] = (int)hop::SMEM;
    return (int)hop::grid_of(o, o + 1);
  }
  if (dtype == ptt::DT_FLOAT32) {
    o[2] = (int)smem_plan<float>();
    return (int)grid_of<float>(o, o + 1);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
