// The tensor-core MLP body of the point evals K5 and K6 (point_eval.cu)
// and of every routed march kernel, K1, K1-multi, K1-grid and K2
// (march_mma.cuh, once a step): one evaluation of the latent-folded
// decoder for a tile of M = 64 rows (points, or a march step's sample
// positions), on Hopper's warpgroup MMA. K3 and K4 (recompute.cu) run
// their forward and reverse sweeps on its MMA loop (mma_chunk), producer
// (stream_layer), ring and near-tie queue. Only the in-order witness
// (march_in_order.cu, no route) evaluates the decoder on CUDA cores.
//
// Replaces, with point_eval.cu, the JAX package's TPU kernels
// dist_renderer_tpu/ops/pallas/mlp_eval.py::pallas_point_eval (K5) and
// ::pallas_point_eval_banked (K6), whose body is march_body.py's
// mlp_apply on a 512-point block.
//
// What bounds it on an H100: the 8x512 decoder is 1.58 M multiply-adds a
// point against 3.16 MB of bf16 weights. On the tensor cores (989
// TFLOP/s bf16) a 64-point tile is ~27 us of MMA, and every weight
// passes through shared memory once per tile: the ring's writes and the
// MMA's operand reads are ~1.3 MB of shared-memory traffic per 512x512
// layer, near the 128 bytes a cycle an SM gives at that rate, and the
// weights are re-read from L2 once per tile (49 KB a point).
//
// Design:
// - Activations stay on chip: bf16 in two [K/8][M][8] shared buffers (the
//   MMA's no-swizzle K-major core-matrix layout: each 8x8 block is 128
//   contiguous bytes), one read and one written per layer. K is padded to
//   16 with zeros.
// - Hidden products on tensor cores: wgmma.mma_async m64nNk16 bf16 -> fp32,
//   A (activations) and B (weights) from shared memory. A hidden layer's
//   outputs run as N-chunks of 128 (then 64, then 8), each accumulated
//   over all of K in registers: no split-K, no atomics, a fixed k loop, so
//   a point's bits depend on nothing else in its tile or launch. Two
//   consumer warpgroups take alternate chunks: one's epilogue runs while
//   the other's MMAs do. The last layer's few outputs are summed in k
//   order on CUDA cores.
// - Weights streamed: the host lays each chunk's K-slices out as
//   contiguous 16 KB tiles in the B operand's layout (pack_mma_tiles in
//   batched_march.py, built once per packing). One producer warp copies
//   them with cp.async.bulk into a 4-stage shared ring; mbarriers carry
//   "full" (bytes landed) and "empty" (the consuming warps' MMAs done).
// - Each block streams the weights alone: on an H100 the producer never
//   waits on the L2, so blocks do not share a stream.
// - Near ties summed again in k order: the tensor cores sum in another
//   order than the plain version's k order, so a value within NEAR_TIE *
//   2^-24 * |w| |h| (the weight column's and the input row's L2 norms) of
//   a bf16 rounding boundary (after ReLU) is summed again in k order on
//   CUDA cores from the weights row by row (pack_mma_rows): a few tenths
//   of a percent of them. That margin is empirical, not a bound (see
//   NEAR_TIE in batched_march.py): with it every activation was the
//   in-order plain version's on the decoders it was measured on, and a
//   missed tie moves a value by at most a bf16 rounding's worth.
// - The rest on CUDA cores in fp32, in the plain version's order: the
//   x-only first layer (3 -> width) straight into the activation buffer,
//   and every epilogue: acc + the x-products (K6: the high half's sum
//   plus the low half's) + the bias, then ReLU and one round-to-nearest-
//   even to bf16; the last layer's first OUT_ROWS outputs through tanhf
//   when the decoder ends in one. Biases and x weights are staged per
//   layer in shared memory; K6 and the march read a bias column per row
//   where a tile's rows belong to more than one frame.
// - One evaluation is eval_tile: the producer warp streams the weights
//   from a running stream-tile count, so the march evaluates a tile many
//   times on one ring (the weight sequence is the same every time).

#pragma once

#include "march_body.cuh"

namespace drt {
namespace pm {

constexpr int M = 64;              // points per thread block: one wgmma row block
constexpr int WG = 128;            // threads of a consumer warpgroup
constexpr int CONSUMERS = 2 * WG;  // two consumer warpgroups, alternating N-chunks
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 4;          // weight ring depth
constexpr int STAGE_BYTES = 16384; // one weight tile: [kt / 8][nt][8] bf16, nt * kt * 2 bytes
constexpr int QCAP = 2048;         // near-tie queue entries per layer
constexpr int SUB = 32;            // K6's dead-tile granularity (the plain version's)
constexpr int SMEM_LIMIT = 232448; // dynamic shared memory a block may use on an H100

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int align1k(int x) { return (x + 1023) & ~1023; }

// The widest activation row (K padded to 16) of a decoder.
inline int act_width(const Decoder& dec) {
  int w = 16;
  for (int l = 0; l < dec.n_layers; ++l) {
    const int o = round16(dec.out_p[l]), i = round16(dec.in_p[l]);
    w = o > w ? o : w;
    w = i > w ? i : w;
  }
  return w;
}

// The shared-memory plan (bytes): two activation buffers [w16 / 8][M][8]
// bf16 and the weight ring (1024-aligned), then the layer's biases,
// near-tie scales [w16] and x weights [3][w16] in fp32, positions [6][M]
// fp32, frames [M] int32, row norms [M] fp32, the near-tie queue and its
// count, the near ties the queue could not hold as a bit a value, and the
// ring's 2 * STAGES mbarriers. The march (march_mma.cuh) adds its rows'
// carries [12][M] and geometry [8][M] and the step's values [M], fp32,
// and their ray or pixel indices [M], int32.
// ops/kernels/mlp_eval.py's smem_plan_bytes is the same sum for the CPU
// side; a card test holds the two equal (drt_point_mlp_smem,
// drt_march_mma_smem).
struct Plan {
  int act, ring, bias, wn, wx, x, frame, hn, q, qn, mask, bar, carry, geo, sdf, pix, bytes;
};

__host__ __device__ inline Plan smem_plan(int w16, bool march = false) {
  Plan p;
  p.act = 0;
  p.ring = p.act + align1k(2 * M * w16 * 2);
  p.bias = p.ring + STAGES * STAGE_BYTES;
  p.wn = p.bias + w16 * 4;
  p.wx = p.wn + w16 * 4;
  p.x = p.wx + 3 * w16 * 4;
  p.frame = p.x + 6 * M * 4;
  p.hn = p.frame + M * 4;
  p.q = p.hn + M * 4;
  p.qn = p.q + QCAP * 4;
  p.mask = p.qn + 16;
  p.bar = p.mask + M * w16 / 8;
  p.carry = p.bar + 2 * STAGES * 8;
  p.geo = p.carry + 12 * M * 4;
  p.sdf = p.geo + 8 * M * 4;
  p.pix = p.sdf + M * 4;
  p.bytes = march ? p.pix + M * 4 : p.carry;
  return p;
}

// ---- PTX wrappers --------------------------------------------------------

// x, known to the compiler as one value across the warp (lane 0's): a
// branch on it is not divergent, which the warpgroup MMAs need.
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Arrive on the mbarrier at bar from the threads with `one` set.
// Predicated inside the asm: a branch around it would be a divergent path
// in the MMA pipeline, and ptxas would serialize the warpgroup MMAs.
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" :: "r"(bar), "r"((int)one)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The consumer warpgroups' barrier (the producer warp is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// Chunk hand-off between the consumer warpgroups: the warpgroup of
// chunk g arrives once it has seen its last tile land; the warpgroup of
// chunk g + 1 syncs before waiting on its first, so every ring stage's
// parity it waits on is the next one (named barriers 2 and 3, one per
// receiving warpgroup).
__device__ __forceinline__ void handoff_arrive(int to_wg) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(2 + to_wg), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void handoff_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(2 + wg), "n"(CONSUMERS) : "memory");
}

// Generic-proxy shared-memory writes made visible to the MMA's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from reading an accumulator before wgmma_wait.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major core matrices:
// lbo the byte step between core matrices along K, sbo along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D[64][N] (+)= A[64][16] * B[16][N], bf16 in, fp32 accumulators in the
// wgmma fragment order; scale_d 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the tile ------------------------------------------------------------

// Where the last layer's outputs go: K5's [n][OUT_ROWS] rows, K6's [n]
// values (+POS_BIG on a sub-tile with no active point), or the march's
// s_sdf [M] (the first output, for the step that follows).
enum Sink { SINK_POINTS, SINK_BANKED, SINK_MARCH };

struct PointArgs {
  const float* pts;                  // [n][3] fp32
  const unsigned char* active;       // K6: [n] (0 = inactive)
  const int* frame_of_block;         // K6: [ceil(n / block)] bank columns
  int block, n;
  const __nv_bfloat16* W;            // the packed weights (x rows read here)
  const __nv_bfloat16* tiles;        // the hidden weights in the MMA layout
  const __nv_bfloat16* wrows;        // the hidden weights, [out_p][k16] a layer
  const float* wscale;               // [total] near-tie scale of each output column
  const float* bank;                 // [total][bank_stride] fp32 biases
  int bank_stride;
  float* out;                        // [n][OUT_ROWS] fp32
  Decoder dec;
  int w16;                           // act_width(dec)
};

// The next N-chunk of a layer's remaining rest (a multiple of 8) columns.
__host__ __device__ __forceinline__ int next_chunk(int rest) {
  return rest >= 128 ? 128 : (rest >= 64 ? 64 : 8);
}

// Element (row r, column c) of a [w16 / 8][M][8] activation buffer.
__device__ __forceinline__ int act_idx(int r, int c) {
  return ((c >> 3) * M + r) * 8 + (c & 7);
}

// Per-block state the consumer warpgroups read: shared-memory regions and
// the launch's values, held in registers.
struct Tile {
  __nv_bfloat16* act;           // the two activation buffers
  float* s_bias;                // the layer's biases (pure tiles)
  float* s_wn;                  // the layer's near-tie scales
  float* s_wx;                  // the layer's x weights [3][w16]
  const float* s_x;             // positions [6][M]
  const int* s_frame;           // K6: each row's bank column
  float* s_hn;                  // the layer input's row norms
  unsigned* q;                  // near-tie queue: (row << 16) | column
  int* qn;
  unsigned* mask;               // near ties past QCAP: bit r * w16 + c
  uint32_t ring, full, empty;   // shared addresses: the ring and its barriers
  const float* bank;
  const __nv_bfloat16* wrows;
  float* out;
  float* sdf;                   // the march's s_sdf
  int bank_stride, n, w16, tile0, frame0;
  bool final_tanh;
  bool pure;                    // every row reads bank column frame0
  unsigned live;                // K6: bit s set = sub-tile s holds an active point
};

// One layer's values, read once from the layer table.
struct Layer {
  size_t base;                  // its first weight in tiles and wrows
  int b_off, in_p, k16;
  bool has_x, last;
};

// The x-products of column c at row r (the march body's order): the high
// halves' fmaf chain, plus the low halves' under SPLIT_X.
template <bool SPLIT_X>
__device__ __forceinline__ float xprod(const Tile& tl, int c, int r) {
  const float w0 = tl.s_wx[c], w1 = tl.s_wx[tl.w16 + c], w2 = tl.s_wx[2 * tl.w16 + c];
  float xz = fmaf(w2, tl.s_x[2 * M + r], fmaf(w1, tl.s_x[M + r], w0 * tl.s_x[r]));
  if constexpr (SPLIT_X)
    xz = xz + fmaf(w2, tl.s_x[5 * M + r], fmaf(w1, tl.s_x[4 * M + r], w0 * tl.s_x[3 * M + r]));
  return xz;
}

__device__ __forceinline__ float bias_at(const Tile& tl, const Layer& L, int c, int r) {
  if (tl.pure) return tl.s_bias[c];
  return __ldg(tl.bank + (size_t)(L.b_off + c) * tl.bank_stride + tl.s_frame[r]);
}

// A hidden product's sum over k finished into the layer's value: + the
// x-products + the bias (the plain version's order).
template <bool SPLIT_X>
__device__ __forceinline__ float finish(const Tile& tl, const Layer& L, float acc, int c,
                                        int r) {
  if (L.has_x) acc = acc + xprod<SPLIT_X>(tl, c, r);
  return acc + bias_at(tl, L, c, r);
}

// The last layer's value v at (row r, column c): stored when c is one of
// the OUT_ROWS outputs and the row one of the launch's points; K6 writes
// +POS_BIG for a row of a sub-tile with no active point; the march keeps
// every row's first output in s_sdf.
template <int OUT_ROWS, int SINK>
__device__ __forceinline__ void store_out(const Tile& tl, int r, int c, float v) {
  if constexpr (SINK == SINK_MARCH) {
    if (c == 0) tl.sdf[r] = tl.final_tanh ? tanhf(v) : v;
    return;
  }
  const int p = tl.tile0 + r;
  if (c >= OUT_ROWS || p >= tl.n) return;
  const float y = tl.final_tanh ? tanhf(v) : v;
  if constexpr (SINK == SINK_BANKED)
    tl.out[p] = (tl.live >> (r / SUB)) & 1u ? y : POS_BIG;
  else
    tl.out[(size_t)OUT_ROWS * p + c] = y;
}

// The hidden product of (row r, column c) summed in k order from 0, one
// fmaf per term (the march body's and the in-order plain version's sum),
// from the input activations and the weight row w (in_p values): SEG
// 16-byte loads of the row in flight at once, the row's L2 latency paid
// in_p / (8 SEG) times (SEG = 1 for a short row, e.g. the last layer's
// reverse, out_p long).
template <int SEG = 32>
__device__ __forceinline__ float sum_in_order(const __nv_bfloat16* w, int in_p,
                                              const __nv_bfloat16* hin, int r) {
  float acc = 0.0f;
  for (int k0 = 0; k0 < in_p; k0 += 8 * SEG) {
    uint4 x[SEG];
#pragma unroll
    for (int g = 0; g < SEG; ++g)
      x[g] = __ldg(reinterpret_cast<const uint4*>(w + min(k0 + 8 * g, in_p - 8)));
#pragma unroll
    for (int g = 0; g < SEG; ++g) {
      const int k = k0 + 8 * g;
      if (k < in_p) {
        float f[8], h[8];
        unpack8(x[g], f);
        unpack8(*reinterpret_cast<const uint4*>(hin + act_idx(r, k)), h);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(h[i], f[i], acc);
      }
    }
  }
  return acc;
}

// The in-order value of queue entry e ((row << 16) | column), after ReLU,
// into hout.
template <bool SPLIT_X>
__device__ __forceinline__ void recompute(const Tile& tl, const Layer& L,
                                          const __nv_bfloat16* hin, __nv_bfloat16* hout,
                                          unsigned e) {
  const int r = (int)(e >> 16), c = (int)(e & 0xffffu);
  const float acc = sum_in_order(tl.wrows + L.base + (size_t)c * L.k16, L.in_p, hin, r);
  hout[act_idx(r, c)] = __float2bfloat16_rn(fmaxf(finish<SPLIT_X>(tl, L, acc, c, r), 0.0f));
}

// Queue (row r, column c) for the in-order recompute; past QC entries,
// mark its bit.
template <int QC = QCAP>
__device__ __forceinline__ void near_tie(const Tile& tl, int r, int c) {
  const int i = atomicAdd(tl.qn, 1);
  if (i < QC) {
    tl.q[i] = ((unsigned)r << 16) | (unsigned)c;
  } else {
    const int b = r * tl.w16 + c;
    atomicOr(tl.mask + b / 32, 1u << (b % 32));
  }
}

// Release a ring stage: one arrival per consumer warp, after this warp's
// MMAs that read it completed.
__device__ __forceinline__ void release(const Tile& tl, int stage) {
  mbar_arrive(tl.empty + 8 * stage, (threadIdx.x & 31) == 0);
}

// The product of one N-chunk (NT columns) over all of K (k16, a multiple
// of 16) on the tensor cores, for one warpgroup, into acc (fp32, the wgmma
// fragment order): A from the activation buffer at a_base, B streamed
// through the RS-stage ring from stream tile t0 on. KH_SPLIT: the A column
// of K index k is k - kh from kh on (the recompute's split layer reads
// [hi | hi | lo] from a [hi | lo] buffer). The warpgroup of a chunk waits
// for its turn and passes it on (see handoff_arrive).
template <int NT, int RS = STAGES, bool KH_SPLIT = false>
__device__ __forceinline__ void mma_chunk(const Tile& tl, float (&acc)[NT / 2],
                                          uint32_t a_base, int k16, int kh, int t0,
                                          bool wait_turn, bool pass_turn) {
  constexpr int KT = STAGE_BYTES / (2 * NT);
  const int wg = warp_uniform(threadIdx.x / WG);
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  if (wait_turn) handoff_wait(wg);
  int t = t0, prev = 0;
  for (int k0 = 0; k0 < k16; k0 += KT, ++t) {
    const int kt = min(KT, k16 - k0);
    const int stage = t % RS;
    mbar_wait(tl.full + 8 * stage, (uint32_t)(t / RS) & 1u);
    if (pass_turn && k0 + KT >= k16) handoff_arrive(1 - wg);
    wgmma_fence();
    const uint32_t b_base = tl.ring + stage * STAGE_BYTES;
    for (int kk = 0; kk < kt; kk += 16) {
      int ka = k0 + kk;
      if constexpr (KH_SPLIT) ka = ka >= kh ? ka - kh : ka;
      wgmma<NT>(acc, make_desc(a_base + ka * (M * 2), M * 16, 128),
                make_desc(b_base + kk * (NT * 2), NT * 16, 128), 1);
    }
    wgmma_commit();
    if (k0 > 0) {
      wgmma_wait<1>();
      release(tl, prev);
    }
    prev = stage;
  }
  wgmma_wait<0>();
  release(tl, prev);
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) fence_reg(acc[i]);
}

// One N-chunk [n0, n0 + NT) of a hidden layer (not the last) for one
// warpgroup: the
// product over all of K on the tensor cores, streamed through the ring
// from stream tile t0 on, then the epilogue. A hidden layer's value whose
// bf16 rounding (after ReLU) the tensor cores' summation order may have
// moved, |v - v_in_order| <= s_wn[c] * s_hn[r], is queued for the
// in-order recompute.
template <int NT, bool SPLIT_X>
__device__ __forceinline__ void chunk(const Tile& tl, const Layer& L, int n0, int t0,
                                      const __nv_bfloat16* hin, __nv_bfloat16* hout,
                                      bool wait_turn, bool pass_turn) {
  float acc[NT / 2];
  mma_chunk<NT>(tl, acc, smem_u32(hin), L.k16, 0, t0, wait_turn, pass_turn);

  // epilogue: thread (warp w of the warpgroup, lane) holds rows
  // 16w + lane/4 (+8), and in each 8-column group the columns
  // 2 (lane % 4) (+1). Branch-free passes over the registers: + the
  // x-products, + the bias, then ReLU, bf16 and the near-tie test.
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x % WG) >> 5) + (lane >> 2);
  const int cq = n0 + 2 * (lane & 3);
  if (L.has_x) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i)
      acc[i] = acc[i] + xprod<SPLIT_X>(tl, cq + 8 * (i / 4) + (i & 1), r0 + 8 * ((i / 2) & 1));
  }
  if (tl.pure) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = acc[i] + tl.s_bias[cq + 8 * (i / 4) + (i & 1)];
  } else {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i)
      acc[i] = acc[i] + bias_at(tl, L, cq + 8 * (i / 4) + (i & 1), r0 + 8 * ((i / 2) & 1));
  }
  const float hn[2] = {tl.s_hn[r0], tl.s_hn[r0 + 8]};
  uint32_t y[NT / 4], ties[NT / 4];
#pragma unroll
  for (int i = 0; i < NT / 4; ++i) {  // column pair (c, c + 1) of row r0 + 8h
    const int c = cq + 8 * (i / 2), h = i & 1;
    const float v0 = acc[2 * i], v1 = acc[2 * i + 1];
    const float d0 = tl.s_wn[c] * hn[h], d1 = tl.s_wn[c + 1] * hn[h];
    const __nv_bfloat162 out = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    const __nv_bfloat162 lo =
        __floats2bfloat162_rn(fmaxf(v0 - d0, 0.0f), fmaxf(v1 - d1, 0.0f));
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(fmaxf(v0 + d0, 0.0f), fmaxf(v1 + d1, 0.0f));
    y[i] = *reinterpret_cast<const uint32_t*>(&out);
    ties[i] = *reinterpret_cast<const uint32_t*>(&lo) ^ *reinterpret_cast<const uint32_t*>(&hi);
  }
#pragma unroll
  for (int i = 0; i < NT / 4; ++i)
    *reinterpret_cast<uint32_t*>(hout + act_idx(r0 + 8 * (i & 1), cq + 8 * (i / 2))) = y[i];
#pragma unroll
  for (int i = 0; i < NT / 4; ++i) {  // rare
    if (ties[i] & 0xffffu) near_tie(tl, r0 + 8 * (i & 1), cq + 8 * (i / 2));
    if (ties[i] >> 16) near_tie(tl, r0 + 8 * (i & 1), cq + 8 * (i / 2) + 1);
  }
}

// The last layer's first OUT_ROWS outputs with a hidden product, on CUDA
// cores, each summed in k order from 0 (the plain version's sum): 8
// columns of 512 are 0.3% of the decoder's products, and the outputs,
// which no bf16 rounding follows, are then the plain version's bits too.
template <int OUT_ROWS, bool SPLIT_X, int SINK>
__device__ __forceinline__ void last_layer(const Tile& tl, const Layer& L,
                                           const __nv_bfloat16* hin) {
  for (int i = threadIdx.x; i < M * OUT_ROWS; i += CONSUMERS) {
    const int r = i % M, c = i / M;
    const float acc = sum_in_order(tl.wrows + L.base + (size_t)c * L.k16, L.in_p, hin, r);
    store_out<OUT_ROWS, SINK>(tl, r, c, finish<SPLIT_X>(tl, L, acc, c, r));
  }
}

// A layer without a hidden product (the first: 3 -> width) on CUDA
// cores: v = the x-products + the bias, 8 columns of a row per item.
template <int OUT_ROWS, bool SPLIT_X, int SINK>
__device__ __forceinline__ void x_layer(const Tile& tl, const Layer& L, int cols,
                                        __nv_bfloat16* hout) {
  for (int i = threadIdx.x; i < M * (cols / 8); i += CONSUMERS) {
    const int r = i % M, c0 = 8 * (i / M);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = xprod<SPLIT_X>(tl, c0 + e, r) + bias_at(tl, L, c0 + e, r);
    if (L.last) {
#pragma unroll
      for (int e = 0; e < 8; ++e) store_out<OUT_ROWS, SINK>(tl, r, c0 + e, v[e]);
      continue;
    }
    uint4 packed;
    uint32_t* u = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 y =
          __floats2bfloat162_rn(fmaxf(v[2 * e], 0.0f), fmaxf(v[2 * e + 1], 0.0f));
      u[e] = *reinterpret_cast<const uint32_t*>(&y);
    }
    *reinterpret_cast<uint4*>(hout + act_idx(r, c0)) = packed;
  }
}

// The two consumer warpgroups: layer by layer, stage the layer's biases,
// near-tie scales and x weights and the input's row norms; run the
// layer's N-chunks, chunk g of the stream on warpgroup g % 2, the other
// warpgroup's epilogue overlapping the next chunk's MMAs; recompute the
// queued near ties in k order; zero the K padding. The evaluation's
// weights are ring tiles t0, t0 + 1, ... of the block's stream.
template <int OUT_ROWS, bool SPLIT_X, int SINK>
__device__ void consume(const PointArgs& a, const Tile& tl, int t0) {
  const Decoder& dec = a.dec;
  const int n_layers = dec.n_layers;
  const int tid = threadIdx.x, wg = warp_uniform(tid / WG);
  __nv_bfloat16* hin = tl.act;
  __nv_bfloat16* hout = tl.act + M * tl.w16;
  int t = t0, g = 0;  // stream tile and chunk counters
  int chunks = 0;    // hidden N-chunks in the stream
  for (int l = 0; l < n_layers - 1; ++l)  // the last layer is not streamed
    if (dec.wh_off[l] >= 0)
      for (int n0 = 0; n0 < dec.out_p[l]; n0 += next_chunk(dec.out_p[l] - n0)) ++chunks;
  Layer L;
  L.base = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int out_p = dec.out_p[l], wx_off = dec.wx_off[l];
    const bool hidden = dec.wh_off[l] >= 0;
    L.last = l == n_layers - 1;
    L.b_off = dec.b_off[l];
    L.in_p = dec.in_p[l];
    L.k16 = round16(L.in_p);
    L.has_x = wx_off >= 0;
    const int cols = L.last ? min(out_p, 8) : out_p;  // the last layer: its first 8
    const bool ties = hidden && !L.last;
    if (tl.pure)
      for (int o = tid; o < cols; o += CONSUMERS)
        tl.s_bias[o] = __ldg(tl.bank + (size_t)(L.b_off + o) * tl.bank_stride + tl.frame0);
    if (ties)
      for (int o = tid; o < cols; o += CONSUMERS) tl.s_wn[o] = __ldg(a.wscale + L.b_off + o);
    if (L.has_x)
      for (int i = tid; i < 3 * cols; i += CONSUMERS) {
        const int c = i / cols, o = i - c * cols;
        tl.s_wx[c * tl.w16 + o] = __bfloat162float(a.W[wx_off + c * out_p + o]);
      }
    if (ties) {
      // the input rows' L2 norms: four threads a row, then a shuffle sum
      const int r = tid / 4, part = tid % 4;
      float ss = 0.0f;
      for (int k = 8 * part; k < L.in_p; k += 32) {
        float h[8];
        unpack8(*reinterpret_cast<const uint4*>(hin + act_idx(r, k)), h);
#pragma unroll
        for (int i = 0; i < 8; ++i) ss = fmaf(h[i], h[i], ss);
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (part == 0) tl.s_hn[r] = sqrtf(ss);
      if (tid == 0) *tl.qn = 0;
    }
    consumer_sync();
    if (!hidden) {
      x_layer<OUT_ROWS, SPLIT_X, SINK>(tl, L, cols, hout);
    } else if (L.last) {
      last_layer<OUT_ROWS, SPLIT_X, SINK>(tl, L, hin);
    } else {
      for (int n0 = 0, nt; n0 < cols; n0 += nt, ++g) {
        nt = next_chunk(cols - n0);
        const int kt = STAGE_BYTES / (2 * nt);
        if (g % 2 == wg) {
          const bool wait_turn = g > 0, pass_turn = g + 1 < chunks;
          if (nt == 128)
            chunk<128, SPLIT_X>(tl, L, n0, t, hin, hout, wait_turn, pass_turn);
          else if (nt == 64)
            chunk<64, SPLIT_X>(tl, L, n0, t, hin, hout, wait_turn, pass_turn);
          else
            chunk<8, SPLIT_X>(tl, L, n0, t, hin, hout, wait_turn, pass_turn);
        }
        t += (L.k16 + kt - 1) / kt;
      }
    }
    if (!L.last) {
      if (ties) {
        consumer_sync();
        const int queued = *tl.qn;
        for (int i = tid; i < min(queued, QCAP); i += CONSUMERS)
          recompute<SPLIT_X>(tl, L, hin, hout, tl.q[i]);
        if (queued > QCAP)  // the overflow, a word of bits a thread
          for (int w = tid; w < M * tl.w16 / 32; w += CONSUMERS) {
            for (unsigned bits = tl.mask[w]; bits; bits &= bits - 1) {
              const int b = 32 * w + __ffs(bits) - 1;
              const unsigned e = ((unsigned)(b / tl.w16) << 16) | (unsigned)(b % tl.w16);
              recompute<SPLIT_X>(tl, L, hin, hout, e);
            }
            tl.mask[w] = 0;
          }
      }
      // zero the K padding after the outputs (the next layer's K is 16-aligned)
      const int pad = round16(out_p) - out_p;
      for (int i = tid; i < M * pad; i += CONSUMERS)
        hout[act_idx(i % M, out_p + i / M)] = __float2bfloat16_rn(0.0f);
      fence_async_smem();
    }
    consumer_sync();
    if (hidden) L.base += (size_t)out_p * L.k16;
    __nv_bfloat16* tmp = hin;
    hin = hout;
    hout = tmp;
  }
}

// The ring tiles one evaluation streams: every N-chunk's K-slices of the
// hidden layers but the last.
__host__ __device__ inline int stream_tiles(const Decoder& dec) {
  int tiles = 0;
  for (int l = 0; l < dec.n_layers - 1; ++l) {
    if (dec.wh_off[l] < 0) continue;
    const int k16 = round16(dec.in_p[l]);
    for (int n0 = 0, nt; n0 < dec.out_p[l]; n0 += nt) {
      nt = next_chunk(dec.out_p[l] - n0);
      const int kt_max = STAGE_BYTES / (2 * nt);
      tiles += (k16 + kt_max - 1) / kt_max;
    }
  }
  return tiles;
}

// The producer's copies of one layer's tiles, read from src on: every
// N-chunk of its cols outputs, each in K-slices of k16 (tiles laid out as
// pack_mma_tiles lays them), into the RS-stage ring at (stage, phase),
// which it advances.
template <int RS = STAGES>
__device__ __forceinline__ const char* stream_layer(const char* src, int cols, int k16,
                                                    uint32_t ring, uint32_t full,
                                                    uint32_t empty, int& stage,
                                                    uint32_t& phase) {
  for (int n0 = 0, nt; n0 < cols; n0 += nt) {
    nt = next_chunk(cols - n0);
    const int kt_max = STAGE_BYTES / (2 * nt);
    for (int k0 = 0; k0 < k16; k0 += kt_max) {
      const uint32_t bytes = 2u * nt * min(kt_max, k16 - k0);
      mbar_wait(empty + 8 * stage, phase ^ 1u);
      mbar_expect_tx(full + 8 * stage, bytes);
      bulk_copy(ring + stage * STAGE_BYTES, src, bytes, full + 8 * stage);
      src += bytes;
      if (++stage == RS) {
        stage = 0;
        phase ^= 1u;
      }
    }
  }
  return src;
}

// The producer: one thread streams every tile the consumers read, in
// their order, into the ring, as the block's stream tiles t, t + 1, ...
static __device__ void produce(const Decoder& dec, const __nv_bfloat16* tiles, uint32_t ring,
                               uint32_t full, uint32_t empty, int t) {
  const char* src = reinterpret_cast<const char*>(tiles);
  int stage = t % STAGES;
  uint32_t phase = (uint32_t)(t / STAGES) & 1u;
  for (int l = 0; l < dec.n_layers - 1; ++l)  // the last layer is not streamed
    if (dec.wh_off[l] >= 0)
      src = stream_layer(src, dec.out_p[l], round16(dec.in_p[l]), ring, full, empty, stage,
                         phase);
}

// The block's state for eval_tile: the plan's regions and the launch's
// values. The caller sets the tile's own (tile0, frame0, pure, live, sdf).
__device__ __forceinline__ Tile make_tile(const PointArgs& a, unsigned char* smem,
                                          const Plan& plan) {
  Tile tl;
  tl.act = reinterpret_cast<__nv_bfloat16*>(smem + plan.act);
  tl.s_bias = reinterpret_cast<float*>(smem + plan.bias);
  tl.s_wn = reinterpret_cast<float*>(smem + plan.wn);
  tl.s_wx = reinterpret_cast<float*>(smem + plan.wx);
  tl.s_x = reinterpret_cast<float*>(smem + plan.x);
  tl.s_frame = reinterpret_cast<int*>(smem + plan.frame);
  tl.s_hn = reinterpret_cast<float*>(smem + plan.hn);
  tl.q = reinterpret_cast<unsigned*>(smem + plan.q);
  tl.qn = reinterpret_cast<int*>(smem + plan.qn);
  tl.mask = reinterpret_cast<unsigned*>(smem + plan.mask);
  const uint64_t* bars = reinterpret_cast<const uint64_t*>(smem + plan.bar);
  tl.ring = smem_u32(smem + plan.ring);
  tl.full = smem_u32(bars);
  tl.empty = smem_u32(bars + STAGES);
  tl.bank = a.bank;
  tl.wrows = a.wrows;
  tl.out = a.out;
  tl.sdf = nullptr;
  tl.bank_stride = a.bank_stride;
  tl.n = a.n;
  tl.w16 = a.w16;
  tl.final_tanh = a.dec.final_tanh != 0;
  tl.tile0 = 0;
  tl.frame0 = 0;
  tl.pure = true;
  tl.live = 3u;
  return tl;
}

// Every thread of the block, once, before its first evaluation and a
// __syncthreads(): clear the near-tie overflow bits and initialize the
// RS-stage ring's barriers.
template <int RS = STAGES>
__device__ __forceinline__ void init_block(const Tile& tl) {
  for (int w = threadIdx.x; w < M * tl.w16 / 32; w += THREADS) tl.mask[w] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RS; ++s) {
      mbar_init(tl.full + 8 * s, 1);
      mbar_init(tl.empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// One evaluation of the decoder for the tile's M rows (positions in
// s_x), by every thread of the block: the producer warp streams the
// weights as stream tiles t0 .. t0 + stream_tiles(dec) - 1, the consumer
// warpgroups evaluate. Every tile it streams is consumed before it
// returns, so nothing is in flight between evaluations.
template <int OUT_ROWS, bool SPLIT_X, int SINK>
__device__ __forceinline__ void eval_tile(const PointArgs& a, const Tile& tl, int t0) {
  if (warp_uniform(threadIdx.x / 32) >= CONSUMERS / 32) {
    if (threadIdx.x == CONSUMERS) produce(a.dec, a.tiles, tl.ring, tl.full, tl.empty, t0);
    __syncwarp();
  } else {
    consume<OUT_ROWS, SPLIT_X, SINK>(a, tl, t0);
  }
}

// One evaluation of the decoder for the block's M points. BANKED (K6): a
// point's biases are its frame's bank column, and a block whose points are
// all inactive writes +POS_BIG and skips the MLP.
template <int OUT_ROWS, bool SPLIT_X, bool BANKED>
__global__ void __launch_bounds__(THREADS, 1)
point_mlp_kernel(const __grid_constant__ PointArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Plan plan = smem_plan(a.w16);
  const int t = threadIdx.x;
  const int tile0 = blockIdx.x * M;
  if constexpr (BANKED) {
    const int p = tile0 + t;
    if (!__syncthreads_or(t < M && p < a.n && a.active[p] != 0)) {
      if (t < M && p < a.n) a.out[p] = POS_BIG;
      return;
    }
  }
  Tile tl = make_tile(a, smem, plan);
  float* s_x = reinterpret_cast<float*>(smem + plan.x);
  int* s_frame = reinterpret_cast<int*>(smem + plan.frame);
  if (t < M) {
    const int p = tile0 + t;
    const bool mine = p < a.n;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float x = mine ? a.pts[3 * (size_t)p + ax] : 0.0f;
      const float hi = round_bf16(x);
      s_x[ax * M + t] = hi;
      if constexpr (SPLIT_X) s_x[(3 + ax) * M + t] = round_bf16(x - hi);
    }
    if constexpr (BANKED) s_frame[t] = a.frame_of_block[min(p, a.n - 1) / a.block];
  }
  tl.tile0 = tile0;
  if constexpr (BANKED) {
    const int last_p = a.n - 1;
    tl.frame0 = a.frame_of_block[min(tile0, last_p) / a.block];
    const int p = tile0 + t;
    tl.pure = warp_uniform(__syncthreads_and(
        t >= M || a.frame_of_block[min(p, last_p) / a.block] == tl.frame0));
    const bool act_p = t < M && p < a.n && a.active[p] != 0;
    tl.live = (__syncthreads_or(act_p && t < SUB) ? 1u : 0u) |
              (__syncthreads_or(act_p && t >= SUB) ? 2u : 0u);
  }
  init_block(tl);
  __syncthreads();
  eval_tile<OUT_ROWS, SPLIT_X, BANKED ? SINK_BANKED : SINK_POINTS>(a, tl, 0);
}

// The decoder as the kernels take it (make_decoder's rule, its activation
// width) and the launch's pointers; K5's and K6's shared-memory plan must
// fit the block.
inline cudaError_t point_args(const int* table, int n_layers, int final_tanh,
                              const void* W, const void* tiles, const void* wrows,
                              const float* wscale, const float* bank,
                              int bank_stride, const float* pts, int n, float* out,
                              PointArgs* a) {
  cudaError_t err = make_decoder(table, n_layers, final_tanh, &a->dec);
  if (err != cudaSuccess) return err;
  a->w16 = act_width(a->dec);
  if (smem_plan(a->w16).bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  a->pts = pts;
  a->active = nullptr;
  a->frame_of_block = nullptr;
  a->block = 1;
  a->n = n;
  a->W = static_cast<const __nv_bfloat16*>(W);
  a->tiles = static_cast<const __nv_bfloat16*>(tiles);
  a->wrows = static_cast<const __nv_bfloat16*>(wrows);
  a->wscale = wscale;
  a->bank = bank;
  a->bank_stride = bank_stride;
  a->out = out;
  return cudaSuccess;
}

}  // namespace pm
}  // namespace drt
