// Hopper (sm_90a) building blocks of the port's wgmma / TMA kernels, shared
// by flash_attention.cu (the bf16 flash forward, dq and dk/dv, the forward
// through flash_hopper.cuh), quant_matmul.cu (the bf16 prefill GEMM over
// 8-bit weights) and, through hopper_gemm.cuh, fused_block.cu (the QKV, MLP
// and fused_ffn GEMMs), grouped_matmul.cu (the grouped expert FFN) and
// fused_decoder.cu (the whole-block decoder, flash_hopper.cuh too):
//   - mbarriers: init, expect-tx, arrive and a parity wait;
//   - TMA: cp.async.bulk.tensor loads of 2-d, 3-d and 4-d boxes into shared
//     memory and 1-d bulk copies, completed on an mbarrier, and the
//     host-side CUtensorMap encoder, fetched from libcuda through the
//     runtime (cudaGetDriverEntryPoint*), so no library links -lcuda;
//   - wgmma: shared-memory descriptors for 128-byte-swizzled tiles,
//     fence / commit / wait, and the m64nNk16 bf16 products with fp32
//     accumulators in registers (A from shared memory or from registers);
//     the m64nNk8 tf32 products (both operands K-major, from shared
//     memory) of tf32x3.cuh's 3xTF32 GEMM;
//   - setmaxnreg, to move registers from a producer warpgroup to the
//     consumers;
//   - tiles that threads write for wgmma: 8-bit weights up-converted to
//     bf16 in registers and stored in TMA's swizzled layout, and the proxy
//     fence between those stores and wgmma's reads.
//
// Operand tiles.  Every bf16 operand tile is written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B: boxes of 64 bf16 (128 bytes) along the
// contiguous dimension, one 128-byte row per element of the other
// dimension, 8 rows to a 1024-byte swizzle atom; every tile starts on a
// 1024-byte boundary.  A wider tile is several such boxes side by side
// ("chunks" of 64 columns).  wgmma reads them through a descriptor:
//   K-major  (the reduction dimension contiguous: A = x or Q, and flash's
//            B = K rows): SBO = 1024 bytes between 8-row groups; LBO is
//            not used with swizzling (1).  A k16 step is +32 bytes.
//   MN-major (N contiguous: weights in the [in, out] layout, V as
//            [keys, d]; wgmma's transpose bit): LBO = the bytes between
//            64-column chunks along N, SBO = 1024 bytes between 8-row
//            groups along K.  A k16 step is +16 rows = +2048 bytes.
// fused_block.cu's ptt_wgmma_check holds one 64 x N x 64 product of each
// kind against torch.matmul on the card, one whose B tile threads
// converted from int8 (w8_store_sw128), and one 64 x N x 32 tf32 product
// (fp32 boxes of 32 elements, both operands K-major).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

namespace ptt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (swizzled tiles need it;
// the plans reserve 1 KB of slack for it)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the inits, before a __syncthreads: the barriers are visible to
// the other threads and to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the phase of parity `phase` to complete.  A wait that never
// ends (a lost arrival or byte count) traps after 2^26 polls (seconds;
// no block waits on another), so a fault surfaces as a launch error and
// not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// box (c0 innermost, c1) of `map` into shared memory at dst, completing
// on bar (which must expect the box's bytes: out-of-bounds elements are
// zero-filled and counted)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of device memory at src into shared memory at
// dst, both 16-byte aligned, completing on bar (which must expect them):
// the flash backward's per-slot lse and delta rows
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- registers ---------------------------------------------------------------

// the warpgroup's per-thread register limit (all four warps execute it)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait that guards them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) : : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) : : "memory");
}

// -- wgmma -------------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile starting at p (see the top)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= (uint64_t)((lbo >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFFu) << 32;
  d |= (uint64_t)1 << 62;   // 128-byte swizzle
  return d;
}
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return desc_sw128(p, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mnmajor(const void* p,
                                                 uint32_t chunk_bytes) {
  return desc_sw128(p, chunk_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// two fp32 values as a bf16 pair (round to nearest even), low half first:
// the A-register operand of wgmma
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x N] += A[64 x 16] . B[16 x N], bf16 operands, fp32 accumulators.
// The accumulator fragment of thread t (warp w = t / 32 of the
// warpgroup, lane l): d[4 i + 2 h + e] is row 16 w + l / 4 + 8 h,
// column 8 i + 2 (l % 4) + e.  ss: A from shared memory (K-major
// descriptor); rs: A from registers, a[0..3] = rows (16 w + l / 4, +8)
// x k pairs (2 (l % 4), +8), as a bf16x2 each.  TB: B's transpose bit
// (1 = MN-major).  The operand lists are written out: inline PTX takes
// no loops.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// -- TF32 (tf32x3.cuh's three products) -------------------------------------

// D[64 x N] += A[64 x 8] . B[8 x N], tf32 operands both from shared
// memory, fp32 accumulators in the fragment of the bf16 products above.
// For .tf32 wgmma takes both operands K-major only (there is no transpose
// bit for 32-bit types): A's rows and B^T's rows hold K, 32 fp32 to a
// 128-byte swizzle row, so a k8 step is +32 bytes, desc_kmajor's
// arithmetic as bf16's k16.  acc = 0: D = A . B (D's old value not read).
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_n256(float (&d)[128], uint64_t da,
                                               uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

// -- programmatic dependent launch -------------------------------------------

// A kernel launched with cudaLaunchAttributeProgrammaticStreamSerialization
// may start before the previous kernel of its stream has ended, once every
// block of that kernel has called griddep_launch or exited.  griddep_wait
// blocks the calling thread until the previous kernel has completed and its
// writes are visible; in a kernel launched without the attribute both are
// no-ops.
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// -- threads writing operand tiles ------------------------------------------

// after threads write shared memory that wgmma or TMA (the async proxy)
// will read or overwrite: each thread fences, then signals (a barrier or
// an mbarrier arrival) the threads that issue the async operation
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Device memory that threads wrote with ordinary stores and TMA reads
// later in the same launch (a persistent kernel's workspace, behind a
// grid-wide barrier): the writers fence before the barrier, the thread
// that issues the loads after it.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// 8-bit weights up-converted exactly.  Byte i (0..3) of the word w as an
// fp32 value: int8 through the 2^23 magic number (w's bytes biased by
// 128, placed under the exponent of 2^23, 2^23 + 128 subtracted), e4m3
// by moving its exponent and mantissa into fp32's fields (the value is
// then 2^-120 of the e4m3 value, subnormals included) and scaling by
// 2^120.  Both are exact, and the value fits bf16 (pack_bf16_exact).
template <bool FP8>
__device__ __forceinline__ float w8_to_f(uint32_t w, int i) {
  if constexpr (FP8) {
    const uint32_t b = w >> (8 * i);
    return __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20)) *
           0x1p120f;
  } else {
    return __uint_as_float(
               __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
  }
}

// byte c (0..15) of a 16-byte vector as fp32
template <bool FP8>
__device__ __forceinline__ float w8_at(const uint4& v, int c) {
  const uint32_t w = c < 4 ? v.x : c < 8 ? v.y : c < 12 ? v.z : v.w;
  return w8_to_f<FP8>(w, c % 4);
}

// two fp32 values that bf16 holds exactly (an int8 or e4m3 value has at
// most 8 significant bits, so the low 16 bits of its fp32 are zero) as a
// bf16 pair, low half first: their high halves, one byte permute in
// place of a conversion
__device__ __forceinline__ uint32_t pack_bf16_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// bytes c and c + 1 of a 16-byte vector as a bf16 pair (c even)
template <bool FP8>
__device__ __forceinline__ uint32_t w8_pair(const uint4& v, int c) {
  return pack_bf16_exact(w8_at<FP8>(v, c), w8_at<FP8>(v, c + 1));
}

// 16 weight bytes of row k (the reduction index), columns n .. n + 15 (n
// a multiple of 16) up-converted into a bf16 B tile laid out as TMA's
// 128-byte swizzle writes it for desc_mnmajor: 64-column chunks of 8192
// bytes, row k at k * 128 in its chunk, the 16-byte unit u (columns 8 u
// .. 8 u + 7 of the chunk) at unit u ^ (k % 8).
template <bool FP8>
__device__ __forceinline__ void w8_store_sw128(unsigned char* tile, int k,
                                               int n, const uint4& raw) {
  unsigned char* row = tile + (n / 64) * 8192 + k * 128;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = (n % 64) / 8 + h;
    uint4 o;
    o.x = w8_pair<FP8>(raw, 8 * h + 0);
    o.y = w8_pair<FP8>(raw, 8 * h + 2);
    o.z = w8_pair<FP8>(raw, 8 * h + 4);
    o.w = w8_pair<FP8>(raw, 8 * h + 6);
    *reinterpret_cast<uint4*>(row + 16 * (u ^ (k % 8))) = o;
  }
}

}  // namespace hopper
}  // namespace ptt

// -- host --------------------------------------------------------------------

namespace ptt {
namespace hopper {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the streaming multiprocessors of the current device, looked up once
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// A tensor map of `rank` (<= 4) dimensions.  The same arguments give the
// same map, so the maps encoded are kept, keyed by all of them (the base
// pointer, dims, strides and box among them), and a call that repeats one
// (the weights and workspaces of a decode step, every step) copies it
// instead of encoding it again.
inline cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type,
                          CUtensorMapSwizzle swizzle, const void* base,
                          int rank, const uint64_t* dims,
                          const uint64_t* strides, const uint32_t* box) {
  if (rank < 1 || rank > 4) return cudaErrorInvalidValue;
  std::array<uint64_t, 13> key{};
  key[0] = (uint64_t)type;
  key[1] = (uint64_t)swizzle;
  key[2] = reinterpret_cast<uint64_t>(base);
  key[3] = (uint64_t)rank;
  for (int i = 0; i < rank; ++i) {
    key[4 + i] = dims[i];
    if (i > 0) key[7 + i] = strides[i - 1];
    key[11 + i / 2] |= (uint64_t)box[i] << (32 * (i % 2));
  }
  static std::mutex mu;
  static std::map<std::array<uint64_t, 13>, CUtensorMap> kept;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto hit = kept.find(key);
    if (hit != kept.end()) {
      *map = hit->second;
      return cudaSuccess;
    }
  }
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base),
                  reinterpret_cast<const cuuint64_t*>(dims),
                  reinterpret_cast<const cuuint64_t*>(strides),
                  reinterpret_cast<const cuuint32_t*>(box), elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (kept.size() >= 4096) kept.clear();   // bounded: freed buffers' maps
  kept.emplace(key, *map);
  return cudaSuccess;
}

// a bf16 tensor map with 128-byte swizzle and zero fill out of bounds:
// `rank` dimensions innermost first, the byte strides of dimensions
// 1..rank-1, and the box (box[0] = 64 elements: one 128-byte row)
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rank,
                            const uint64_t* dims, const uint64_t* strides,
                            const uint32_t* box) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides, box);
}

// an fp32 tensor map with 128-byte swizzle and zero fill out of bounds:
// box[0] = 32 elements (one 128-byte row); tf32x3.cuh's operands
inline cudaError_t make_map_f32(CUtensorMap* map, const void* base, int rank,
                                const uint64_t* dims, const uint64_t* strides,
                                const uint32_t* box) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides, box);
}

// a 2-d map of 8-bit values (int8 or e4m3 weights, read as bytes) without
// swizzle: the box lands row-major, box[0] bytes a row (a multiple of 16,
// at most 256); out-of-bounds bytes are zero, which both types read as 0
inline cudaError_t make_map_u8(CUtensorMap* map, const void* base,
                               const uint64_t* dims, const uint64_t* strides,
                               const uint32_t* box) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                CU_TENSOR_MAP_SWIZZLE_NONE, base, 2, dims, strides, box);
}

}  // namespace hopper
}  // namespace ptt
