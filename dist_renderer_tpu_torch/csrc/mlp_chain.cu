// The MLP chain probe: STEPS chained evaluations of an n_layers x width
// ReLU MLP on every column of x, in bf16 (P23) and in int8 (P24).
// Counterparts of scripts/diag_int8.py's make_bf16_kernel (:59) and
// make_int8_kernel (:82), both launched at :129.
//
// Per step, with h0 the fp32 carry of a column:
//   bf16: h = bf16(h0); per layer h = bf16(relu(W_l . h)), fp32 sums;
//   int8: h = int8(clip(rint(16 h0), -127, 127)); per layer, int32 sums,
//         h = int8(clip(rint(acc / 512), 0, 127));
//   then h0 = h0 + 0.125 h / (1 + |h|) in fp32 (the build's -fmad=false
//   keeps the multiply and the add apart, as the plain version computes
//   them).
// The int8 chain is exact: its sums are integers below 2^24, and the
// requantization and carry are fp32 operations the plain version repeats
// (the increment from a table of the 128 IEEE divisions), so the two agree
// bit for bit. The bf16 chain sums in the tensor cores' order, and a sum
// near a bf16 rounding boundary can round the other way; it divides the
// increment by a reciprocal (within 2 ulp).
//
// Bound: at diag_int8's defaults (8 layers of 512 x 512, 32 steps, 32,768
// columns) 2.2e12 multiply-adds: 4.45 ms at the bf16 dense peak, 2.22 ms
// at the int8 one. Device-memory bytes are far below (0.04 ms), but the
// first version (a block per 64 columns, mma.sync with the weights'
// fragments loaded from L2 at every k-step, the carry in shared memory)
// re-read 68.7 GB of weights from L2 and waited out each load.
//
// Design (chain_kernel<Cfg>; diag/chain_designs.cu times it against the
// first version and the steps between):
// - A consumer warpgroup owns 64 columns (the 64 rows of each wgmma's M)
//   for all steps; a block has two, so 128 columns share every weight
//   byte that reaches its shared memory (32 GB from L2 in bf16 at the
//   defaults).
// - wgmma in both precisions: m64n128k16 .f32.bf16.bf16 and m64n128k32
//   .s32.s8.s8, a layer's outputs in chunks of 128 rows. A is the
//   warpgroup's activations [64][width] in shared memory (no-swizzle
//   K-major core matrices, as point_mlp.cuh keeps them), B the weight
//   tile from the ring.
// - A weight ring: one producer thread streams every layer's weights in
//   tiles of [128 rows][128 bytes of k] (a weight row a 128-byte swizzle
//   row, the layout the B descriptor reads) with TMA (a tensor map over
//   the weights, built at each launch) into up to 16 stages of 16 KB,
//   full/empty mbarriers between it and both warpgroups; point_mlp.cuh's
//   mbarrier, fence and wgmma helpers are reused by include. Its warpgroup
//   gives its registers to the consumers (setmaxnreg 24 / 240). The second
//   consumer starts LAG tiles behind the first, so that their epilogues
//   tend to fall in each other's MMAs.
// - Optionally (Cfg's CL, not shipped) a cluster of CL blocks shares the
//   stream: each producer copies 1 / CL of every tile and multicasts it;
//   a block's empty barrier then counts the consumer warps of the cluster.
// - The fp32 carry lives in `out` (x at the first step), read and written
//   once a step by the threads holding the last layer's accumulators, and
//   prefetched into L2 when the last layer starts. Each layer's outputs
//   overwrite its inputs in place once the warpgroup's last MMA has read
//   them (the earlier chunks' outputs wait in registers, packed), so
//   shared memory holds only the activations and the ring.
// - Columns past `cols` (a block wider than the call) run on zeros and
//   are neither read nor written.
// What bounds it now (chain_designs, H100): the MMAs alone run at ~93% of
// the bf16 peak; the epilogues (packing each layer's outputs, the last
// layer's carry reads and writes) and each chunk's drained MMA pipeline
// overlap the tensor cores only in part, and an epilogue under the next
// chunk's MMAs (OVL) needs more registers than a thread has.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "point_mlp.cuh"

namespace drt {
namespace mc {

using pm::fence_async_smem;
using pm::make_desc;
using pm::mbar_expect_tx;
using pm::mbar_init;
using pm::mbar_wait;
using pm::smem_u32;
using pm::warp_uniform;
using pm::wgmma_commit;
using pm::wgmma_fence;
using pm::wgmma_wait;

constexpr int WG = 128;    // threads of a consumer warpgroup
constexpr int COLS = 64;   // columns a warpgroup owns: the wgmma's M
constexpr int LINE = 128;  // bytes of k in a ring row: one 128-byte swizzle row
constexpr int BOX = 128;   // weight rows one tile piece covers, split over a cluster

// What a launch runs (diag/chain_designs.cu times the parts alone): the
// ring's copies and waits, the MMAs and epilogues, or both (shipped).
constexpr int RING = 1, MMA = 2, EPI = 4, MATH = MMA | EPI, BOTH = RING | MATH;

// The shipped configuration: warpgroups a block and blocks a cluster (no
// multicast: the L2 feeds bulk copies of one 4 MB weight set at ~19 TB/s
// on an H100, above the ~7 TB/s 128 columns a block need at the bound, and
// clusters of 2 and 4 measured slower; diag/chain_designs.cu).
constexpr int SHIP_WGS = 2;
constexpr int SHIP_CL = 1;

// A launch's configuration: the precision, the width, WGS consumer
// warpgroups a block, clusters of CL blocks, output chunks of BN rows
// (a wgmma's N; BN rows x 128 bytes of k a ring tile), whether a
// chunk's epilogue overlaps the next chunk's MMAs (OVL), and whether the
// second warpgroup starts LAG tiles behind the first (LAGGED), so that
// one's epilogues fall in the other's MMAs.
template <bool INT8_, int WIDTH_, int WGS_, int CL_, int BN_, bool OVL_ = false,
          bool LAGGED_ = true>
struct Cfg {
  static constexpr bool INT8 = INT8_, OVL = OVL_, LAGGED = LAGGED_;
  static constexpr int WIDTH = WIDTH_, WGS = WGS_, CL = CL_, BN = BN_;
  static constexpr int ESIZE = INT8 ? 1 : 2;
  static constexpr int KB = WIDTH * ESIZE / LINE;  // ring tiles a chunk
  static constexpr int NC = WIDTH / BN;             // chunks a layer
  static constexpr int HOLD = INT8 ? BN / 8 : BN / 4;  // registers of a held chunk
  static constexpr int ACT = COLS * WIDTH * ESIZE;  // a warpgroup's activations
  static constexpr int STAGE = BN * LINE;
  static constexpr int TABLE = 128 * 4;  // int8: the carry increment of each h
  static constexpr int FIT = (pm::SMEM_LIMIT - 1024 - 2 * 8 * 8 - TABLE - WGS * ACT) / STAGE;
  static constexpr int STAGES = FIT < 16 ? FIT : 16;
  static constexpr int LAG = KB < STAGES - 2 ? KB : (STAGES > 2 ? STAGES - 2 : 1);
  static constexpr int THREADS = (WGS + 1) * WG;  // and a producer warpgroup
  static constexpr int SMEM = 1024 + STAGES * STAGE + WGS * ACT + 2 * STAGES * 8 + TABLE;
  static_assert(WIDTH % BN == 0 && (BN == 128 || BN == 256), "chunks of 128 or 256 rows");
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(BOX % (8 * CL) == 0, "a cluster's piece of a tile is whole swizzle atoms");
};

// The shipped configuration: chunks of 128 rows (the held chunks and an
// accumulator fit a consumer thread's 240 registers; chunks of 256 spill).
template <bool INT8, int WIDTH>
using Ship = Cfg<INT8, WIDTH, SHIP_WGS, SHIP_CL, 128>;

struct Args {
  CUtensorMap wmap;  // the weights as [n_layers * width][width], 128-byte swizzled boxes
  const float* x;
  float* out;
  int cols, n_layers, steps;
};

// The carry's increment 0.125 h / (1 + |h|): int8, an integer h in
// [0, 127], from a table the block fills with IEEE divisions (the plain
// version's bits); bf16, by a reciprocal (within 2 ulp: the bf16 chain
// is held to a tolerance, not to bits).
__device__ __forceinline__ float increment(float hf) {
  return 0.125f * hf / (1.f + fabsf(hf));
}

template <bool INT8>
__device__ __forceinline__ float increment(float hf, const float* table) {
  if constexpr (INT8)
    return table[(int)hf];
  else
    return __fdividef(0.125f * hf, 1.f + fabsf(hf));
}

// ---- PTX wrappers beside point_mlp.cuh's ----------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// The warpgroup's own barrier (named barriers 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG) : "memory");
}

// One arrival, from the threads with `one` set, on the mbarrier at the
// same shared offset in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank, bool one) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 ra;\nsetp.ne.u32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(bar), "r"(rank), "r"((int)one) : "memory");
}

// A [BOX / CL rows][128 bytes] box of the weights at (element c0, row c1)
// into shared memory at dst, completing on bar; with CL > 1 into every
// block of the cluster at the same offset.
template <int CL>
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (CL == 1)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(m), "r"(c0), "r"(c1), "r"(bar) : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
        :: "r"(dst), "l"(m), "r"(c0), "r"(c1), "r"(bar), "h"((uint16_t)((1 << CL) - 1))
        : "memory");
}

// Keeps the compiler from reading an accumulator before wgmma_wait.
__device__ __forceinline__ void fence_acc(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void fence_acc(int& r) { asm volatile("" : "+r"(r) :: "memory"); }

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle (the TMA's CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes,
// 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64][N] (+)= A[64][k16] * B[k16][N], bf16 in, fp32 accumulators.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  pm::wgmma<128>(d, da, db, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64][N] (+)= A[64][k32] * B[k32][N], s8 in, s32 accumulators (exact).
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the block's parts -----------------------------------------------------

// The byte of activation (column c, k) in a warpgroup's [k bytes / 16][64][16]
// buffer: K-major core matrices of 8 columns x 16 bytes.
template <bool INT8>
__device__ __forceinline__ int act_off(int c, int k) {
  const int kb = k * (INT8 ? 1 : 2);
  return ((kb >> 4) * COLS + c) * 16 + (kb & 15);
}

// The byte offset, less the thread's own (act_off of its row r0 and k q),
// of accumulator pair p of a chunk whose first output row is n0: row
// r0 + 8 (p & 1), outputs n0 + 8 (p >> 1) + q and + 1. A constant once p
// and n0 are (q < 8 never carries into the next 16 bytes).
template <bool INT8>
__host__ __device__ constexpr int pair_off(int n0, int p) {
  return INT8 ? (((n0 + 8 * (p >> 1)) >> 4) * COLS + 8 * (p & 1)) * 16 + ((8 * (p >> 1)) & 15)
              : (((n0 + 8 * (p >> 1)) >> 3) * COLS + 8 * (p & 1)) * 16;
}

// A layer's input value from an fp32 carry: bf16(h0), or
// int8(clip(rint(16 h0), -127, 127)) as its byte.
template <bool INT8>
__device__ __forceinline__ uint32_t quantize(float h0) {
  if constexpr (INT8)
    return (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(h0 * 16.f), -127.f), 127.f);
  else
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(h0));
}

// A pair's two values (bf16x2 or two int8 bytes) at p, the thread's
// place in the buffer plus a pair_off.
template <bool INT8>
__device__ __forceinline__ void put_pair(unsigned char* p, uint32_t v) {
  if constexpr (INT8)
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)v;
  else
    *reinterpret_cast<uint32_t*>(p) = v;
}

// Release a ring stage: one arrival per consumer warp on that stage's empty
// barrier in every block of the cluster, after its MMAs read the stage.
template <int CL>
__device__ __forceinline__ void release(uint32_t bar) {
  const bool one = (threadIdx.x & 31) == 0;
  if constexpr (CL == 1) {
    pm::mbar_arrive(bar, one);
  } else {
#pragma unroll
    for (int r = 0; r < CL; ++r) mbar_arrive_at(bar, (uint32_t)r, one);
  }
}

struct Ring {
  uint32_t base, full, empty;
  int stage;
  uint32_t phase;
  int signal;  // the first warpgroup: tiles to finish before the second starts
};

// The second warpgroup's start (named barrier 3: the first arrives, the
// second waits).
__device__ __forceinline__ void lag_arrive() {
  asm volatile("bar.arrive 3, %0;\n" :: "n"(2 * WG) : "memory");
}

__device__ __forceinline__ void lag_wait() {
  asm volatile("bar.sync 3, %0;\n" :: "n"(2 * WG) : "memory");
}

// One chunk of BN output rows over all of K on the tensor cores: KB ring
// tiles, four wgmma k-steps of 32 bytes each, the previous tile released
// once its MMAs have completed; `meanwhile` runs once the first tile's
// MMAs are issued (the previous chunk's epilogue, under OVL).
template <typename C, int PH, typename T, typename F>
__device__ __forceinline__ void mma_chunk(T (&acc)[C::BN / 2], uint32_t a_addr, Ring& ring,
                                          F&& meanwhile) {
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0;
  auto issue = [&](int kb) {  // tile kb's MMAs, once it has landed
    if constexpr ((PH & RING) != 0) mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    const uint32_t b = ring.base + ring.stage * C::STAGE;
    if constexpr ((PH & MMA) != 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = make_desc(a_addr + (4 * kb + kk) * (2 * COLS * 16), COLS * 16, 128);
        const uint64_t db = sw128_desc(b + 32 * kk);
        if constexpr (C::INT8)
          wgmma_s8<C::BN>(acc, da, db, 1);
        else
          wgmma_bf16<C::BN>(acc, da, db, 1);
      }
      wgmma_commit();
    }
    const int stage = ring.stage;
    if (++ring.stage == C::STAGES) {
      ring.stage = 0;
      ring.phase ^= 1u;
    }
    return stage;
  };
  int prev = issue(0);
  meanwhile();
#pragma unroll 1
  for (int kb = 1; kb < C::KB; ++kb) {
    const int stage = issue(kb);
    if constexpr ((PH & MMA) != 0) wgmma_wait<1>();
    if constexpr ((PH & RING) != 0) release<C::CL>(ring.empty + 8 * prev);
    prev = stage;
    if (ring.signal > 0 && --ring.signal == 0) lag_arrive();
  }
  if constexpr ((PH & MMA) != 0) wgmma_wait<0>();
  if constexpr ((PH & RING) != 0) release<C::CL>(ring.empty + 8 * prev);
  if (ring.signal > 0 && --ring.signal == 0) lag_arrive();
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) fence_acc(acc[i]);
}

// A warpgroup's place in the launch: its buffer at the thread's own
// offset, the carry (x at the first step, then out) at the thread's first
// pair, whether its columns exist, and the increments' table.
struct Sink {
  unsigned char* act;  // + act_off(r0, q)
  const float* src;    // + q * cols + col + r0
  float* out;          // + q * cols + col + r0
  const float* table;
  size_t cols;
  bool live;
};

// The last layer's output from accumulator v, as a float: bf16(relu(v)),
// or clip(rint(v / 512), 0, 127) (exact: |v| < 2^24).
template <bool INT8, typename T>
__device__ __forceinline__ float layer_value(T v) {
  if constexpr (INT8)
    return fminf(fmaxf(rintf((float)v * (1.f / 512.f)), 0.f), 127.f);
  else
    return __bfloat162float(__float2bfloat16_rn(fmaxf(v, 0.f)));
}

// A hidden layer's two outputs as the buffer holds them: bf16x2 of
// relu (one conversion for both), or two bytes of clip(rint(v / 512), 0,
// 127) (clamped before the one rounding conversion: the same value, as
// clipping and rounding to nearest even commute at the integer bounds).
template <bool INT8, typename T>
__device__ __forceinline__ uint32_t hidden_pair(T v0, T v1) {
  if constexpr (INT8) {
    const int h0 = __float2int_rn(fminf(fmaxf((float)v0 * (1.f / 512.f), 0.f), 127.f));
    const int h1 = __float2int_rn(fminf(fmaxf((float)v1 * (1.f / 512.f), 0.f), 127.f));
    return (uint32_t)h0 | (uint32_t)h1 << 8;
  } else {
    const __nv_bfloat162 y = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    return *reinterpret_cast<const uint32_t*>(&y);
  }
}

// Pair p's packed value into hold (int8: two pairs a word) or the buffer
// at act (the thread's place for the chunk's first row).
template <typename C, bool HOLD>
__device__ __forceinline__ void place(uint32_t (&hold)[C::HOLD], int p, uint32_t v,
                                      unsigned char* act) {
  if constexpr (HOLD && C::INT8)
    hold[p >> 1] = (p & 1) ? hold[p >> 1] | v << 16 : v;
  else if constexpr (HOLD)
    hold[p] = v;
  else
    put_pair<C::INT8>(act + pair_off<C::INT8>(0, p), v);
}

// The buffer's bytes before output row n0 (a multiple of 16) at one row.
template <bool INT8>
__host__ __device__ constexpr int chunk_bytes(int n0) {
  return n0 * (INT8 ? 1 : 2) * COLS;
}

// A hidden layer's chunk passed on, pair by pair in the wgmma fragment
// order (pair p: row r0 + 8 (p & 1), outputs n0 + 8 (p >> 1) + q and + 1):
// into hold when HOLD, else into the buffer.
template <typename C, bool HOLD, typename T>
__device__ __forceinline__ void pass_hidden(const T (&acc)[C::BN / 2], uint32_t (&hold)[C::HOLD],
                                            unsigned char* act) {
#pragma unroll
  for (int p = 0; p < C::BN / 4; ++p)
    place<C, HOLD>(hold, p, hidden_pair<C::INT8>(acc[2 * p], acc[2 * p + 1]), act);
}

// The last layer's chunk: each value's carry updated in out, and the next
// step's inputs from the new carries placed as pass_hidden places its. The
// carries are read 4 pairs at a time, all loads first.
template <typename C, bool HOLD, typename T>
__device__ __forceinline__ void pass_last(const T (&acc)[C::BN / 2], uint32_t (&hold)[C::HOLD],
                                          unsigned char* act, const float* src, float* out,
                                          const Sink& s) {
  constexpr int G = 4;
#pragma unroll
  for (int p0 = 0; p0 < C::BN / 4; p0 += G) {
    float h0[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int p = p0 + g;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        h0[g][e] = s.live ? src[(8 * (p >> 1) + e) * s.cols + 8 * (p & 1)] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int p = p0 + g;
      float nc[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        nc[e] = h0[g][e] + increment<C::INT8>(layer_value<C::INT8>(acc[2 * p + e]), s.table);
        if (s.live) out[(8 * (p >> 1) + e) * s.cols + 8 * (p & 1)] = nc[e];
      }
      place<C, HOLD>(hold, p,
                     quantize<C::INT8>(nc[0]) | quantize<C::INT8>(nc[1]) << (C::INT8 ? 8 : 16),
                     act);
    }
  }
}

// Chunk n0's values passed on, after a hidden or the last layer.
template <typename C, bool HOLD, typename T>
__device__ __forceinline__ void pass_on(bool last, int n0, const T (&acc)[C::BN / 2],
                                        uint32_t (&hold)[C::HOLD], const Sink& s) {
  unsigned char* act = s.act + chunk_bytes<C::INT8>(n0);
  if (last)
    pass_last<C, HOLD>(acc, hold, act, s.src + n0 * s.cols, s.out + n0 * s.cols, s);
  else
    pass_hidden<C, HOLD>(acc, hold, act);
}

// A held chunk (first output row n0) into the buffer.
template <typename C>
__device__ __forceinline__ void put_held(const uint32_t (&hold)[C::HOLD], int n0,
                                         unsigned char* act) {
  act += chunk_bytes<C::INT8>(n0);
#pragma unroll
  for (int p = 0; p < C::BN / 4; ++p)
    put_pair<C::INT8>(act + pair_off<C::INT8>(0, p),
                      C::INT8 ? hold[p >> 1] >> (16 * (p & 1)) : hold[p]);
}

// A layer's chunks from CH on, for one warpgroup: chunk CH's MMAs, the
// epilogue of chunk CH - 1 (packed into hold) under them (OVL) or after
// the chunk before (not OVL); after the last chunk's MMAs have read the
// layer's input, the held chunks and the last one overwrite it. Without
// EPI the sums go to `sum` (they reach a compare).
template <typename C, int PH, int CH, typename T>
__device__ __forceinline__ void chunks(T (&acc)[2][C::BN / 2],
                                       uint32_t (&hold)[C::NC > 1 ? C::NC - 1 : 1][C::HOLD],
                                       bool last, uint32_t a_addr, Ring& ring, const Sink& s,
                                       int wg, T& sum) {
  auto epilogue = [&] {
    if constexpr (CH > 0 && (PH & EPI) != 0)
      pass_on<C, true>(last, (CH - 1) * C::BN, acc[(CH - 1) & 1], hold[CH - 1], s);
  };
  if constexpr (C::OVL) {
    mma_chunk<C, PH>(acc[CH & 1], a_addr, ring, epilogue);
  } else {
    epilogue();
    mma_chunk<C, PH>(acc[CH & 1], a_addr, ring, [] {});
  }
  if constexpr ((PH & EPI) == 0) {
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) sum += acc[CH & 1][i];
  }
  if constexpr (CH + 1 < C::NC) {
    chunks<C, PH, CH + 1>(acc, hold, last, a_addr, ring, s, wg, sum);
  } else if constexpr ((PH & EPI) != 0) {
    wg_sync(wg);  // the warpgroup's MMAs have read this layer's input
#pragma unroll
    for (int h = 0; h + 1 < C::NC; ++h) put_held<C>(hold[h], h * C::BN, s.act);
    pass_on<C, false>(last, CH * C::BN, acc[CH & 1], hold[0], s);
  }
}

// A consumer warpgroup: its 64 columns through every step and layer. A
// layer's chunks but the last wait in registers (hold) until the last
// chunk's MMAs have read the layer's input, then all overwrite it.
template <typename C, int PH>
__device__ __forceinline__ void consume(const Args& a, unsigned char* act, const float* table,
                                        Ring ring, int wg) {
  using T = typename std::conditional<C::INT8, int, float>::type;
  constexpr int NH = C::NC > 1 ? C::NC - 1 : 1;
  const int t = threadIdx.x % WG, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2), q = 2 * (lane & 3);
  const size_t col = ((size_t)blockIdx.x * C::WGS + wg) * COLS;
  Sink s;
  s.act = act + act_off<C::INT8>(r0, q);
  s.out = a.out + (size_t)q * a.cols + col + r0;
  s.table = table;
  s.cols = a.cols;
  s.live = col < (size_t)a.cols;
  for (int i = t; i < C::WIDTH * COLS; i += WG) {
    const int k = i / COLS, c = i % COLS;
    const float v = s.live ? a.x[(size_t)k * a.cols + col + c] : 0.f;
    if constexpr (C::INT8)
      act[act_off<true>(c, k)] = (unsigned char)quantize<true>(v);
    else
      *reinterpret_cast<uint16_t*>(act + act_off<false>(c, k)) = (uint16_t)quantize<false>(v);
  }
  fence_async_smem();
  wg_sync(wg);
  const uint32_t a_addr = smem_u32(act);
  if constexpr (C::LAGGED && C::WGS == 2) {
    if (wg == 1) lag_wait();
    else ring.signal = C::LAG;
  }
  for (int step = 0; step < a.steps; ++step) {
    const float* carry = step == 0 ? a.x : a.out;
    s.src = carry + (size_t)q * a.cols + col + r0;
    for (int layer = 0; layer < a.n_layers; ++layer) {
      const bool last = layer == a.n_layers - 1;
      if (last && s.live)  // the carry, for this layer's epilogue
        for (int i = t; i < 2 * C::WIDTH; i += WG)
          prefetch_l2(carry + (size_t)(i >> 1) * a.cols + col + 32 * (i & 1));
      uint32_t hold[NH][C::HOLD];
      T acc[2][C::BN / 2];
      T sum = 0;
      chunks<C, PH, 0>(acc, hold, last, a_addr, ring, s, wg, sum);
      if constexpr ((PH & EPI) == 0) {
        if (sum == (T)1234567) a.out[0] = (float)sum;
        continue;
      }
      fence_async_smem();
      wg_sync(wg);
    }
  }
}

// The producer thread: every tile the consumers read, in their order
// (step, layer, chunk, k), this block's 1 / CL of each multicast to the
// cluster; then it waits until every block of the cluster has released
// every stage, so that no copy or arrival targets a block that has exited.
template <typename C>
__device__ __forceinline__ void produce(const Args& a, Ring ring) {
  const int rank = C::CL > 1 ? (int)cluster_rank() : 0;
  for (int step = 0; step < a.steps; ++step)
    for (int layer = 0; layer < a.n_layers; ++layer)
      for (int n0 = 0; n0 < C::WIDTH; n0 += C::BN)
        for (int kb = 0; kb < C::KB; ++kb) {
          const uint32_t full = ring.full + 8 * ring.stage;
          mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
          mbar_expect_tx(full, C::STAGE);
          for (int j = 0; j < C::BN; j += BOX) {
            const int r = j + rank * (BOX / C::CL);
            tma_load<C::CL>(ring.base + ring.stage * C::STAGE + r * LINE, &a.wmap,
                            kb * (LINE / C::ESIZE), layer * C::WIDTH + n0 + r, full);
          }
          if (++ring.stage == C::STAGES) {
            ring.stage = 0;
            ring.phase ^= 1u;
          }
        }
  for (int i = 0; i < C::STAGES; ++i) {
    mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
    if (++ring.stage == C::STAGES) {
      ring.stage = 0;
      ring.phase ^= 1u;
    }
  }
}

template <typename C, int PH = BOTH>
__global__ void __launch_bounds__(C::THREADS, 1) chain_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  if (a.steps == 0) {  // out = x on the block's columns
    const size_t col = (size_t)blockIdx.x * C::WGS * COLS;
    for (int i = tid; i < C::WIDTH * C::WGS * COLS; i += C::THREADS) {
      const size_t k = i / (C::WGS * COLS), c = col + i % (C::WGS * COLS);
      if (c < (size_t)a.cols) a.out[k * a.cols + c] = a.x[k * a.cols + c];
    }
    return;
  }
  Ring ring;
  ring.base = smem_u32(smem);
  ring.full = smem_u32(smem + C::STAGES * C::STAGE + C::WGS * C::ACT);
  ring.empty = ring.full + 8 * C::STAGES;
  ring.stage = 0;
  ring.phase = 0;
  ring.signal = 0;
  float* table = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE + C::WGS * C::ACT +
                                          2 * C::STAGES * 8);
  if (C::INT8 && tid < 128) table[tid] = increment((float)tid);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, C::CL * C::WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (C::CL > 1) cluster_sync();
  // the producer warpgroup gives its registers to the consumers (two
  // warpgroups' accumulators and held chunks need more than the 168 a
  // thread of 384 starts with)
  const int wg = warp_uniform(tid / WG);
  if (wg == C::WGS) {
    if constexpr (C::WGS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == C::WGS * WG && (PH & RING) != 0) produce<C>(a, ring);
  } else {
    if constexpr (C::WGS > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<C, PH>(a, smem + C::STAGES * C::STAGE + wg * C::ACT, table, ring, wg);
  }
}

// ---- host ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once through the runtime's
// entry-point query (the library does not link libcuda).
inline EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The weights [n_layers][width][width] as a 2-D map of n_layers * width
// rows, boxes of [BOX / CL rows][128 bytes] in the 128-byte swizzle.
inline cudaError_t weight_map(CUtensorMap* m, const void* w, bool int8, int width, int n_layers,
                              int cl) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int esize = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)width * n_layers};
  const cuuint64_t strides[1] = {(cuuint64_t)width * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(LINE / esize), (cuuint32_t)(BOX / cl)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(m, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, const_cast<void*>(w), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename C, int PH = BOTH>
int launch(const float* x, const void* w, float* out, int cols, int n_layers, int steps,
           void* stream) {
  void (*kernel)(Args) = chain_kernel<C, PH>;
  static const cudaError_t attr =  // once per instantiation
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  Args a;
  cudaError_t err = weight_map(&a.wmap, w, C::INT8, C::WIDTH, n_layers, C::CL);
  if (err != cudaSuccess) return (int)err;
  a.x = x;
  a.out = out;
  a.cols = cols;
  a.n_layers = n_layers;
  a.steps = steps;
  const int per = C::WGS * COLS;
  const int blocks = ((cols + per - 1) / per + C::CL - 1) / C::CL * C::CL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C::CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool INT8>
int launch_width(const float* x, const void* w, float* out, int width, int cols, int n_layers,
                 int steps, void* stream) {
  if (cols <= 0 || cols % COLS != 0 || n_layers <= 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  switch (width) {
    case 128: return launch<Ship<INT8, 128>>(x, w, out, cols, n_layers, steps, stream);
    case 256: return launch<Ship<INT8, 256>>(x, w, out, cols, n_layers, steps, stream);
    case 384: return launch<Ship<INT8, 384>>(x, w, out, cols, n_layers, steps, stream);
    case 512: return launch<Ship<INT8, 512>>(x, w, out, cols, n_layers, steps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

inline int smem_bytes(int width, bool int8) {
  switch (width) {
    case 128: return int8 ? Ship<true, 128>::SMEM : Ship<false, 128>::SMEM;
    case 256: return int8 ? Ship<true, 256>::SMEM : Ship<false, 256>::SMEM;
    case 384: return int8 ? Ship<true, 384>::SMEM : Ship<false, 384>::SMEM;
    case 512: return int8 ? Ship<true, 512>::SMEM : Ship<false, 512>::SMEM;
    default: return -1;
  }
}

}  // namespace mc
}  // namespace drt

// x, out [width][cols] fp32; w [n_layers][width][width] (bf16 for P23,
// int8 for P24; 16-byte aligned), W[o][i] multiplying input row i into
// output row o; width in {128, 256, 384, 512}, cols a multiple of 64.
// Launches on the caller's stream and returns cudaGetLastError().
extern "C" int drt_mlp_chain_bf16(const float* x, const void* w, float* out, int width,
                                  int cols, int n_layers, int steps, void* stream) {
  return drt::mc::launch_width<false>(x, w, out, width, cols, n_layers, steps, stream);
}

extern "C" int drt_mlp_chain_int8(const float* x, const void* w, float* out, int width,
                                  int cols, int n_layers, int steps, void* stream) {
  return drt::mc::launch_width<true>(x, w, out, width, cols, n_layers, steps, stream);
}

// The dynamic shared memory a block of either chain asks for (-1 for a
// width the kernel does not take).
extern "C" int drt_mlp_chain_smem(int width, int int8) {
  return drt::mc::smem_bytes(width, int8 != 0);
}
