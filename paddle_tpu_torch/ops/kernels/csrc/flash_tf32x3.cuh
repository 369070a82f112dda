// The fp32 flash-attention forward on Hopper's tensor cores: 3xTF32 on
// wgmma at head_dim 64 and 128, fed by TMA through an mbarrier ring.
//
// Replaces, in fp32, the Pallas TPU kernel paddle_tpu/ops/pallas/
// flash_attention.py `_fwd_kernel` (:71, pallas_call :156): out =
// softmax(Q K^T scale [causal]) V per query head over [b, s, h, d] q and
// [b, s, hk, d] k / v (query head h reads kv head h / (H / HK)), and lse =
// m + log l as [b, h, s] fp32 (natural log, as the backward reads it).
// Its port ran flash_tile.cuh's first design before (CUDA-core FMAs on
// 32 x 32 tiles, every accumulator in shared memory), head_dim 64 through
// a zero pad to 128.
//
// Arithmetic (tf32x3.cuh says why): every product is three TF32 passes
// over split operands, x = hi + lo with hi = tf32(x) and lo = tf32(x -
// hi) (cvt.rna, common.cuh's tf32_split), a k8 step's three small terms
// first: a_lo b_hi, a_hi b_lo, a_hi b_hi.  Each 32-deep slice is summed
// on the tensor cores from zero (the first wgmma's scale-d is 0), and
// the slices' sums are added to fp32 totals with IEEE adds, in order:
//   S = Q K^T  HD / 32 slices over d; Q and K are K-major as they lie.
//   O += P V   BK / 32 slices over keys; P, the online softmax's fp32
//              registers, is split into hi and lo in registers as wgmma's
//              A; V arrives as V^T [d, keys], because tf32 wgmma takes B
//              K-major only (the transpose bit exists for 16-bit types).
// Softmax in fp32 in the exp2 domain (scores times scale * log2 e,
// ex2.approx), as the bf16 forward does it, with the running max and sum
// in registers and O rescaled per key block.  No flag picks a lesser
// precision: the Pallas kernel's fp32 dots keep fp32 inputs.
//
// The split pre-pass (tf32x3.cuh's tf32_split_kernel on q and on k as
// they lie; flash_split_vt_kernel: V^T through 32 x 32 tiles in shared
// memory) writes Q's and K's hi / lo and V^T's hi / lo [b, hk, d, s] into
// a workspace the wrapper allocates for the call (floats()).  Q is split
// there too and read by wgmma from shared memory at both head dims: as A
// from registers its hi and lo would take 64 registers a thread at d=64
// and 128 at d=128, beside O and the slices' sums.
//
// P's layout.  A thread's S accumulator holds key columns (2t, 2t + 1) of
// each n8 block (t = lane % 4); a tf32 A fragment of depth 8 holds
// columns (t, t + 4).  The sum over keys does not care about their order,
// so the pre-pass stores V^T's keys permuted within each group of 8:
// logical column c holds key pi(c) = 2c for c < 4 and 2 (c - 4) + 1
// otherwise (keys 0 2 4 6 1 3 5 7).  Then the accumulator's pair (2t,
// 2t + 1) is the fragment's pair (t, t + 4), with no shuffle.
//
// Structure: flash_fwd_hopper's (flash_attention.cu).  One block of three
// warpgroups per (q tile of 128 rows, query head, batch), the heaviest q
// tiles first under the causal mask.  Warpgroup 0's first thread loads
// Q's hi and lo once, then each key block's K (hi, lo) and V^T (hi, lo)
// as two units of a ring of NU units on mbarriers, K first; the
// consumers free a unit with one arrival per warp.  Warpgroups 1 and 2
// own 64 query rows each; a last tile of 64 rows (s % 128 == 64) runs
// one.  Key blocks wholly above the diagonal are never loaded; a
// consumer waits for, and frees, the units past its own diagonal.
//   HD   BK  Q hi + lo  unit   units  dynamic shared memory
//   64   64  64 KB      32 KB  5      225 KB
//   128  32  128 KB     32 KB  3      225 KB
// Each consumer issues a key block's S slices as one wgmma group (each
// slice into its own registers), waits, sums them and frees K; runs the
// softmax and splits P; issues the P V slices as one group, waits and
// adds them to O.  The two consumers interleave on the tensor cores.
// Registers a consumer thread: O (HD / 2), the S slices (64), the P V
// slices (64) and P's hi / lo fragments (BK / 2 each).
//
// What bounds it on an H100 SXM: the products, 4 b h s^2 d FLOP (about
// half under the causal mask) at 495 / 3 = 165 TFLOP/s (ERNIE-3.0-medium
// at b=8, s=1024, 12 heads, d=64: 25.8 GFLOP, 0.156 ms); the pre-pass
// reads q, k and v once and writes them twice (ERNIE: 226 MB, 0.067 ms
// at 3.35 TB/s).
#pragma once

#include "common.cuh"
#include "flash_hopper.cuh"
#include "flash_tile.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace ptt {
namespace fwd32 {

using namespace ptt::hopper;

constexpr int BQ = 128;             // query rows a block (two consumers)
constexpr int THREADS = 384;
constexpr uint32_t UNIT = 32768;    // a ring unit: K_j or V^T_j, hi then lo
constexpr uint32_t HALF = UNIT / 2;
constexpr float LN2 = 0.69314718055994531f;

template <int HD>
struct Plan {
  static constexpr int BK = HD == 64 ? 64 : 32;   // keys a block
  static constexpr int SD = HD / 32;              // S's slices, over d
  static constexpr int SK = BK / 32;              // P V's slices, over keys
  static constexpr uint32_t QCH = BQ * 128;       // a Q chunk: 32 d x 128
  static constexpr uint32_t QHALF = SD * QCH;     // Q's hi (or lo)
  static constexpr uint32_t KCH = BK * 128;       // a K chunk: 32 d x BK
  static constexpr uint32_t VCH = HD * 128;       // a V^T chunk: 32 keys x HD
  // as many units as fit beside Q, 1 KB of alignment slack and 1 KB for
  // the static shared memory (the barriers)
  static constexpr int NU = (232448 - 2048 - 2 * QHALF) / UNIT;
  static constexpr size_t SMEM = 1024 + 2 * (size_t)QHALF + NU * UNIT;
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  static_assert(SD * KCH == HALF && SK * VCH == HALF,
                "a unit holds one key block's K or V^T, hi and lo");
  static_assert(NU >= 3 && SMEM + 1024 <= 232448,
                "three units or more, within a block's shared memory");
};

struct Params {
  CUtensorMap qh, ql;   // 4-d {d, heads, s, b}, boxes {32, 1, 128, 1}
  CUtensorMap kh, kl;   // boxes {32, 1, BK, 1}
  CUtensorMap vh, vl;   // V^T: 4-d {s, d, hk, b}, boxes {32, HD, 1, 1}
  float* o;
  float* lse;
  int S, H, HK, nq;
  float scale2;         // scale * log2 e
  int causal;
};

// the workspace's fp32 values: Q's hi and lo, K's, V^T's
inline long long floats(int B, int S, int H, int HK, int D) {
  return 2LL * B * S * D * (H + 2LL * HK);
}

// -- the split pre-pass ------------------------------------------------------

// V [B, S, HK, D] as V^T hi and lo [B, HK, D, S], the keys of each group
// of 8 in the order pi (the top): block (key tile, d tile, b * HK + kh)
// moves 32 keys x 32 d through shared memory, 16-byte loads and stores
__global__ void __launch_bounds__(ptt::tf32x3::kSplitThreads)
flash_split_vt_kernel(const float* v, float* vh, float* vl, int S, int HK,
                      int D) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32, bk = blockIdx.z;
  const int b = bk / HK, kh = bk % HK;
  const int tid = threadIdx.x, r = tid / 8, q = tid % 8;
  const float4 x = *reinterpret_cast<const float4*>(
      v + (((size_t)b * S + k0 + r) * HK + kh) * D + d0 + 4 * q);
  t[r][4 * q] = x.x;
  t[r][4 * q + 1] = x.y;
  t[r][4 * q + 2] = x.z;
  t[r][4 * q + 3] = x.w;
  __syncthreads();
  // thread (d0 + r, logical columns 4 q .. 4 q + 3): keys kb, kb + 2,
  // kb + 4, kb + 6 of the tile (pi of 4 (q % 2) + e in group q / 2)
  const int kb = 8 * (q / 2) + q % 2;
  float4 h, l;
  tf32_split(t[kb][r], h.x, l.x);
  tf32_split(t[kb + 2][r], h.y, l.y);
  tf32_split(t[kb + 4][r], h.z, l.z);
  tf32_split(t[kb + 6][r], h.w, l.w);
  const size_t o = ((size_t)bk * D + d0 + r) * S + k0 + 4 * q;
  *reinterpret_cast<float4*>(vh + o) = h;
  *reinterpret_cast<float4*>(vl + o) = l;
}

// -- the forward -------------------------------------------------------------

// The producer thread: Q's hi and lo, then units 2 j (K_j) and 2 j + 1
// (V^T_j) of the nk key blocks into the ring.
template <int HD>
__device__ __forceinline__ void produce(const Params& p, unsigned char* qs,
                                        unsigned char* ring, uint64_t* qfull,
                                        uint64_t* full, uint64_t* empty,
                                        int q0, int h, int kh, int b,
                                        int nk) {
  using P = Plan<HD>;
  mbar_expect_tx(qfull, 2 * P::QHALF);
  for (int s = 0; s < P::SD; ++s) {
    tma_load_4d(qs + s * P::QCH, &p.qh, qfull, 32 * s, h, q0, b);
    tma_load_4d(qs + P::QHALF + s * P::QCH, &p.ql, qfull, 32 * s, h, q0, b);
  }
  for (int u = 0; u < 2 * nk; ++u) {
    const int slot = u % P::NU, k0 = u / 2 * P::BK;
    unsigned char* d = ring + slot * UNIT;
    if (u >= P::NU) mbar_wait(&empty[slot], (u / P::NU - 1) & 1);
    mbar_expect_tx(&full[slot], UNIT);
    if (u % 2 == 0) {
      for (int s = 0; s < P::SD; ++s) {
        tma_load_4d(d + s * P::KCH, &p.kh, &full[slot], 32 * s, kh, k0, b);
        tma_load_4d(d + HALF + s * P::KCH, &p.kl, &full[slot], 32 * s, kh,
                    k0, b);
      }
    } else {
      for (int s = 0; s < P::SK; ++s) {
        tma_load_4d(d + s * P::VCH, &p.vh, &full[slot], k0 + 32 * s, 0, kh,
                    b);
        tma_load_4d(d + HALF + s * P::VCH, &p.vl, &full[slot], k0 + 32 * s,
                    0, kh, b);
      }
    }
  }
}

// P's hi and lo as the A fragments of the P V slices: k8 step kk of
// slice s is the accumulator's n8 block 4 s + kk, whose pair (2t, 2t + 1)
// of rows r and r + 8 is the fragment's (t, t + 4) under pi
template <int SK, int NV>
__device__ __forceinline__ void p_frags(const float (&sc)[NV],
                                        uint32_t (&ph)[SK][4][4],
                                        uint32_t (&pl)[SK][4][4]) {
#pragma unroll
  for (int s = 0; s < SK; ++s)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int n = 4 * (4 * s + kk);
      const float v[4] = {sc[n], sc[n + 2], sc[n + 1], sc[n + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hi, lo;
        tf32_split(v[e], hi, lo);
        ph[s][kk][e] = __float_as_uint(hi);
        pl[s][kk][e] = __float_as_uint(lo);
      }
    }
}

// Consumer warpgroup c (rows 64 c .. of the tile q0..) of query head h,
// batch b: nk key blocks, units 2 j and 2 j + 1 of the ring.  All 128
// threads of the warpgroup call it.
template <int HD>
__device__ __forceinline__ void consume(const Params& p,
                                        const unsigned char* qs,
                                        const unsigned char* ring,
                                        uint64_t* qfull, uint64_t* full,
                                        uint64_t* empty, int c, int q0,
                                        int h, int b, int nk) {
  using P = Plan<HD>;
  constexpr int BK = P::BK, SD = P::SD, SK = P::SK;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 64 * c + 16 * (t / 32) + lane / 4;   // rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                 // first column of a pair
  const bool signals = lane == 0;
  const unsigned char* qc = qs + c * 64 * 128;   // this warpgroup's rows
  // the key blocks this warpgroup needs: past its last row all is masked
  const int nkc = p.causal ? min(nk, (q0 + 64 * c + 64) / BK) : nk;
  auto edge = [&](int j) {
    return p.causal && j * BK + BK - 1 > q0 + 64 * c;
  };
  auto unit = [&](int u) { return ring + (u % P::NU) * UNIT; };
  auto wait_full = [&](int u) {
    mbar_wait(&full[u % P::NU], (u / P::NU) & 1);
  };
  float o[HD / 2], sl[SD][BK / 2], ol[SK][HD / 2], corr[2];
  uint32_t ph[SK][4][4], pl[SK][4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  mbar_wait(qfull, 0);

  for (int j = 0; j < nkc; ++j) {
    // S: slice s (d 32 s ..) into sl[s], all in one group
    wait_full(2 * j);
    const unsigned char* ku = unit(2 * j);
#pragma unroll
    for (int s = 0; s < SD; ++s) fence_regs(sl[s]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < SD; ++s)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dqh = desc_kmajor(qc + s * P::QCH + 32 * kk);
        const uint64_t dql =
            desc_kmajor(qc + P::QHALF + s * P::QCH + 32 * kk);
        const uint64_t dkh = desc_kmajor(ku + s * P::KCH + 32 * kk);
        const uint64_t dkl = desc_kmajor(ku + HALF + s * P::KCH + 32 * kk);
        wgmma_tf32<BK>(sl[s], dql, dkh, kk > 0);
        wgmma_tf32<BK>(sl[s], dqh, dkl);
        wgmma_tf32<BK>(sl[s], dqh, dkh);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < SD; ++s) fence_regs(sl[s]);
    if (signals) mbar_arrive(&empty[(2 * j) % P::NU]);
#pragma unroll
    for (int s = 1; s < SD; ++s)
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sl[0][i] += sl[s][i];

    ptt::fwd::softmax(sl[0], m, l, corr, edge(j), j * BK, q0 + r0, cq,
                      p.scale2);
    p_frags<SK>(sl[0], ph, pl);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V: slice s (keys 32 s ..) into ol[s], all in one group
    wait_full(2 * j + 1);
    const unsigned char* vu = unit(2 * j + 1);
#pragma unroll
    for (int s = 0; s < SK; ++s) {
      fence_regs(ol[s]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ph[s][kk]);
        fence_regs(pl[s][kk]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < SK; ++s)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dvh = desc_kmajor(vu + s * P::VCH + 32 * kk);
        const uint64_t dvl = desc_kmajor(vu + HALF + s * P::VCH + 32 * kk);
        wgmma_tf32_rs<HD>(ol[s], pl[s][kk], dvh, kk > 0);
        wgmma_tf32_rs<HD>(ol[s], ph[s][kk], dvl);
        wgmma_tf32_rs<HD>(ol[s], ph[s][kk], dvh);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < SK; ++s) fence_regs(ol[s]);
    if (signals) mbar_arrive(&empty[(2 * j + 1) % P::NU]);
#pragma unroll
    for (int s = 0; s < SK; ++s)
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] += ol[s][i];
  }
  // the blocks past this warpgroup's diagonal: free them once loaded (an
  // early arrival would count toward the unit's previous use)
  for (int u = 2 * nkc; u < 2 * nk; ++u) {
    wait_full(u);
    if (signals) mbar_arrive(&empty[u % P::NU]);
  }

  // out = O / l; lse in natural log
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    if (row >= p.S) continue;
    const float safe_l = l[rr] > 0.f ? l[rr] : 1.f;
    float* og = p.o + (((size_t)b * p.S + row) * p.H + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(og + 8 * i + cq) =
          make_float2(o[4 * i + 2 * rr] / safe_l,
                      o[4 * i + 2 * rr + 1] / safe_l);
    if (lane % 4 == 0)
      p.lse[((size_t)b * p.H + h) * p.S + row] =
          (m[rr] + log2f(safe_l)) * LN2;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32x3(const __grid_constant__ Params p) {
  using P = Plan<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qfull, full[P::NU], empty[P::NU];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + 2 * P::QHALF;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int q0 = (p.nq - 1 - blockIdx.y) * BQ;   // heaviest q tile first
  const int kh = h / (p.H / p.HK);
  // key blocks wholly above the diagonal are never loaded (s is a
  // multiple of 64, so no key block is ragged)
  const int nk = p.causal ? min((q0 + BQ) / P::BK, p.S / P::BK)
                          : p.S / P::BK;
  const int nact = q0 + 64 < p.S ? 2 : 1;   // a last tile of 64 rows
  if (threadIdx.x == 0) {
    mbar_init(&qfull, 1);
    for (int s = 0; s < P::NU; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nact);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // the producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0)
      produce<HD>(p, qs, ring, &qfull, full, empty, q0, h, kh, b, nk);
    return;
  }
  regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;   // consumer warpgroup
  if (c >= nact) return;                 // rows past s only
  consume<HD>(p, qs, ring, &qfull, full, empty, c, q0, h, b, nk);
}

// -- host --------------------------------------------------------------------

// the split pre-pass of q, k and v into `work` (floats() values)
inline int split(const ptt::flash::Args& a, int B, int D, float* work,
                 cudaStream_t stream) {
  const long long nq = (long long)B * a.S * a.H * D;
  const long long nk = (long long)B * a.S * a.HK * D;
  float *qh = work, *ql = qh + nq, *kh = ql + nq, *kl = kh + nk;
  float *vh = kl + nk, *vl = vh + nk;
  int e = ptt::tf32x3::split(static_cast<const float*>(a.q), qh, ql, nq,
                             stream);
  if (e == 0)
    e = ptt::tf32x3::split(static_cast<const float*>(a.k), kh, kl, nk,
                           stream);
  if (e != 0) return e;
  flash_split_vt_kernel<<<dim3(a.S / 32, D / 32, B * a.HK),
                          ptt::tf32x3::kSplitThreads, 0, stream>>>(
      static_cast<const float*>(a.v), vh, vl, a.S, a.HK, D);
  return (int)cudaGetLastError();
}

// a 4-d fp32 map of a [B, S, heads, HD] tensor, boxes of 32 d x 1 head x
// `rows` rows
template <int HD>
cudaError_t map_bshd(CUtensorMap* map, const float* base, int B, int S,
                     int heads, int rows) {
  const uint64_t dims[4] = {HD, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {HD * 4, (uint64_t)heads * HD * 4,
                               (uint64_t)S * heads * HD * 4};
  const uint32_t box[4] = {32, 1, (uint32_t)rows, 1};
  return make_map_f32(map, base, 4, dims, strides, box);
}

// a 4-d fp32 map of V^T [B, HK, HD, S], boxes of 32 keys x HD
template <int HD>
cudaError_t map_vt(CUtensorMap* map, const float* base, int B, int S,
                   int HK) {
  const uint64_t dims[4] = {(uint64_t)S, HD, (uint64_t)HK, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)S * 4, (uint64_t)S * HD * 4,
                               (uint64_t)HK * HD * S * 4};
  const uint32_t box[4] = {32, HD, 1, 1};
  return make_map_f32(map, base, 4, dims, strides, box);
}

// the forward over the split operands in `work`
template <int HD>
int launch(const ptt::flash::Args& a, int B, const float* work,
           cudaStream_t stream) {
  using P = Plan<HD>;
  const long long nq = (long long)B * a.S * a.H * HD;
  const long long nk = (long long)B * a.S * a.HK * HD;
  const float *qh = work, *ql = qh + nq, *kh = ql + nq, *kl = kh + nk;
  const float *vh = kl + nk, *vl = vh + nk;
  Params p{};
  cudaError_t e = map_bshd<HD>(&p.qh, qh, B, a.S, a.H, BQ);
  if (e == cudaSuccess) e = map_bshd<HD>(&p.ql, ql, B, a.S, a.H, BQ);
  if (e == cudaSuccess) e = map_bshd<HD>(&p.kh, kh, B, a.S, a.HK, P::BK);
  if (e == cudaSuccess) e = map_bshd<HD>(&p.kl, kl, B, a.S, a.HK, P::BK);
  if (e == cudaSuccess) e = map_vt<HD>(&p.vh, vh, B, a.S, a.HK);
  if (e == cudaSuccess) e = map_vt<HD>(&p.vl, vl, B, a.S, a.HK);
  if (e != cudaSuccess) return (int)e;
  p.o = static_cast<float*>(a.o);
  p.lse = a.lse;
  p.S = a.S;
  p.H = a.H;
  p.HK = a.HK;
  p.nq = (a.S + BQ - 1) / BQ;
  p.scale2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  auto kern = flash_fwd_tf32x3<HD>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * a.H, p.nq);
  kern<<<grid, THREADS, P::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// the pre-pass, then the forward: head_dim D (64 or 128), a workspace of
// at least floats() values
inline int run(const ptt::flash::Args& a, int B, int D, float* work,
               long long work_floats, cudaStream_t stream) {
  if ((D != 64 && D != 128) || work == nullptr ||
      work_floats < floats(B, a.S, a.H, a.HK, D))
    return (int)cudaErrorInvalidValue;
  const int e = split(a, B, D, work, stream);
  if (e != 0) return e;
  return D == 64 ? launch<64>(a, B, work, stream)
                 : launch<128>(a, B, work, stream);
}

}  // namespace fwd32
}  // namespace ptt
