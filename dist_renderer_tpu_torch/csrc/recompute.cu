// K3: the fused precise recompute forward, and K4: its cotangent-seeded
// backward, on Hopper's tensor cores.
//
// Replace the JAX package's TPU kernels
// dist_renderer_tpu/ops/pallas/recompute.py::precise_sdg_call
// (_make_fwd_kernel: _forward, _seed_last, _reverse) and
// ::precise_bias_grads_call (_make_bwd_kernel).
//
// K3 computes, per point: the precise SDF value s, the spatial gradient
// g = ds/dx by a reverse sweep over the stored ReLU gates, and
// dd = <g, v>. K4 runs the same forward and reverse sweep seeded by a
// cotangent instead of ones, and returns u_l = sum over points of the
// preactivation gradient delta_l of each layer the latent enters (the
// latent gradient is then sum_l W_z,l u_l, two small products on the
// host side), and optionally the ct-weighted xyz gradient per point.
//
// Rounding points are the TPU kernel's and the plain version's:
//   - layers consuming the raw input (split layers) take three bf16
//     products, W_hi.h_hi + W_lo.h_hi + W_hi.h_lo, on their hidden input
//     and on xyz; other hidden layers take one bf16 product; the bias
//     comes first, then each product's own fp32 sum over k is added in
//     turn;
//   - the reverse sweep multiplies bf16(delta) by the bf16 weights W_hi,
//     accumulating in fp32, and gates by the forward's ReLU masks.
//
// What bounds it on an H100: the 8x512 decoder is 3.43 M multiply-adds a
// point (the forward, the split skip layer's three products, the
// reverse): 0.45 ms for 65,536 points on the tensor cores (989 TFLOP/s
// bf16), 6.7 ms on the CUDA cores (67 TFLOP/s fp32). A 64-point tile
// streams every hidden weight from L2 through shared memory once
// forward (3.4 MB, the skip layer's lo included) and once in reverse
// (3.1 MB): as for K5, the L2 stream and the shared-memory traffic of
// the ring, not the MMAs, bound a tile.
//
// K3's value mode (precise_value_kernel, drt_precise_value) replaces no
// TPU kernel. The renderer's composition keeps only s of a ray that
// missed (its margin), so where a frame's hits overflow the compose
// bucket it runs K3 on the hits and this mode on the misses. It is K3's
// forward, tile for tile: the same rounding points, the same near-tie
// queue, the last layer's row 0 in k order and the tanh chain, so a
// point's s is K3's s bit for bit. It keeps no gates and has no reverse:
// the producer streams the forward tiles alone. What bounds it: 1.84 M of
// the 3.42 M multiply-adds a point, and 3.4 MB of the 6.5 MB of weights
// a 64-point tile streams (8x512 decoder).
//
// Design (point_mlp.cuh's machinery: 64-row wgmma tiles, a producer warp
// streaming 16 KB weight tiles through a cp.async.bulk ring, two consumer
// warpgroups on alternating N-chunks, near ties summed again in k order):
// - A persistent grid: one block per SM strides over the 64-point tiles.
//   The producer streams, per tile, the forward tiles (pack_precise's
//   ftiles) and then the reverse tiles (rtiles), through a 3-stage ring.
//   One body (precise_block) serves the three modes, a template
//   parameter: K4, K3 and K3's value.
// - Forward. Layer 0 (x only) on CUDA cores: bias, then the three x
//   products, each a 3-term fmaf chain. Hidden layers on the tensor
//   cores: wgmma m64nNk16, bf16(h) as A from shared memory, N-chunks of
//   128, then 64, then 8, each summed over all of K in registers (no
//   split-K, no atomics: a point's bits depend on nothing else in the
//   launch); the epilogue adds the bias, then the x products. A split
//   layer runs one accumulator over K = 3 k16: A = [hi | hi | lo] read
//   from one [hi | lo] activation buffer against B = [W_hi; W_lo; W_hi].
//   One accumulator, not three: it keeps the 128-wide chunks' registers,
//   and the near-tie test covers the association it changes.
// - The layer feeding a split layer runs on CUDA cores, in k order, for
//   every value: its consumer reads bf16(h - bf16(h)), whose rounding
//   boundaries lie 2^8 times closer than bf16(h)'s, and a CPU model of
//   the tensor cores' order put 23% of that layer's values within the
//   near-tie margin of one (tests/test_torch_recompute_mma.py). 8.4 M
//   multiply-adds a tile at width 512. On the tensor cores, with those
//   ties settled one by one through the overflow bits, K3 took 1.8x as
//   long on an H100 (kernel_times.py, a patched copy).
// - Near ties: a tensor-core value within NEAR_TIE * 2^-24 * |w| |h| (the
//   B column's and the A row's L2 norms) of a decision is summed again in
//   k order from the plain version's operands, in its association. The
//   decisions: the ReLU gate (0 is a boundary) and the bf16 rounding
//   forward, the bf16 rounding of delta in reverse. Past QCAP a value is
//   marked in the overflow bits.
// - Each hidden layer's ReLU gates are bitmasks in shared memory; the
//   reverse needs the gates, not the activations.
// - The last layer's row 0 (s and the tanh chain's seed) on CUDA cores in
//   k order; its reverse (K = out_p, 8) on CUDA cores in o order. Hidden
//   layers' reverse on the tensor cores: A = bf16(delta) [M][out_p], B =
//   W_hi in the reverse orientation (rtiles); the epilogue gates, rounds
//   to bf16 and queues near ties, summed again in o order from the
//   forward-orientation rows. gx = W_x_hi^T . bf16(delta) per x-taking
//   layer on CUDA cores in o order, added from the top layer down.
// - K4's sum over points: u sums the fp32 delta of the layers the latent
//   enters, not its bf16 rounding, so K4 computes those deltas in o order
//   on CUDA cores (the reverse of layers 1 and 5 of the 8x512 decoder,
//   2 x 16.8 M multiply-adds a tile): the tensor cores' order moved u by
//   3e-7 relative, and the fits of the tasks, chaotic over 10 steps from
//   the zero latent, followed it elsewhere (fit_sensitivity.py moves u so
//   and empties their meshes for some seeds). Each 32 rows of a column are
//   summed in fp64 by a fixed shuffle-down tree into a slot of a buffer;
//   sum_tiles_kernel adds the slots in order, in chunks of a fixed size,
//   pass after pass: the sum a warp per 32-point tile takes, so u keeps
//   the bits the port's fits were measured with. It depends on neither
//   the grid nor the SM count, and two launches on the same inputs give
//   the same bits.
// - Shared memory at width 512: activations 131,072 bytes, the ring
//   49,152, the gates 30,720, the rest 16,192: 227,136 of the 232,448 a
//   block may use. A 4-stage ring does not fit beside the gates; with the
//   gates in a per-block slot of global memory instead it measured no
//   faster on an H100.

#include "point_mlp.cuh"

namespace drt {
namespace rk {

using pm::CONSUMERS;
using pm::M;
using pm::STAGE_BYTES;
using pm::THREADS;
using pm::WG;
using pm::act_idx;
using pm::round16;

constexpr int RS = 3;       // weight ring stages
constexpr int QCAP = 1024;  // near-tie queue entries per layer
constexpr int SLOTS = 2;    // K4's partial sums a tile: one per 32 rows

// The body's modes: K4 (the cotangent-seeded backward), K3 (s, dd, g) and
// K3's value alone (the forward and s: no gates kept, no reverse).
enum Mode { K4 = 0, K3 = 1, VALUE = 2 };

struct Precise {
  int n_layers, use_tanh, final_tanh, w16, u_rows, gate_words;
  int out_p[MAX_LAYERS], in_p[MAX_LAYERS], split[MAX_LAYERS];
  int fwd_hi[MAX_LAYERS], lo_rows[MAX_LAYERS], rev[MAX_LAYERS];
  int wx_hi[MAX_LAYERS], wx_lo[MAX_LAYERS], b_off[MAX_LAYERS];
  int u_off[MAX_LAYERS];   // row of the layer's u in K4's output, -1 = none
  int g_off[MAX_LAYERS];   // its gate words [M][g_wpr] (every layer but the last)
  int g_wpr[MAX_LAYERS];
  int exact[MAX_LAYERS];   // 1: on CUDA cores in k order (no hidden input, or feeds a split layer)
};

// Host: table = (use_tanh, final_tanh, then per layer out_p, in_p, split,
// fwd_hi, lo_rows, rev, wx_hi, wx_lo, b_off): offsets into the packed
// weights of W_hi [in_p][out_p], W_lo^T [out_p][in_p] (split layers),
// W_hi^T [out_p][in_p], the x weights [3][out_p] hi and lo, and the
// layer's first bias. The latent enters exactly
// the split layers (pack_precise: split = takes_z), so they carry u. Layer
// 0 takes xyz only; every later layer takes the layer before it.
static cudaError_t make_precise(const int* table, int n_layers, Precise* p) {
  if (n_layers < 2 || n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
  p->n_layers = n_layers;
  p->use_tanh = table[0];
  p->final_tanh = table[1];
  p->u_rows = 0;
  p->gate_words = 0;
  int w16 = 16;
  for (int l = 0; l < n_layers; ++l) {
    const int* t = table + 2 + 9 * l;
    p->out_p[l] = t[0];
    p->in_p[l] = t[1];
    p->split[l] = t[2];
    p->fwd_hi[l] = t[3];
    p->lo_rows[l] = t[4];
    p->rev[l] = t[5];
    p->wx_hi[l] = t[6];
    p->wx_lo[l] = t[7];
    p->b_off[l] = t[8];
    p->u_off[l] = t[2] ? p->u_rows : -1;
    if (t[2]) p->u_rows += t[0];
    if (t[0] <= 0 || t[0] % 8 || t[1] % 8) return cudaErrorInvalidValue;
    for (int q = 3; q < 8; ++q)
      if (t[q] >= 0 && t[q] % 8) return cudaErrorInvalidValue;
    const bool has_wh = t[3] >= 0;
    if (has_wh != (l > 0)) return cudaErrorInvalidValue;
    if (has_wh && (t[1] != p->out_p[l - 1] || t[5] < 0 || (t[2] && t[4] < 0)))
      return cudaErrorInvalidValue;
    if ((t[6] >= 0) != (t[7] >= 0) || (!has_wh && t[6] < 0)) return cudaErrorInvalidValue;
    const int wo = round16(t[0]), wi = (has_wh && t[2] ? 2 : 1) * round16(t[1]);
    w16 = wo > w16 ? wo : w16;
    w16 = wi > w16 ? wi : w16;
  }
  for (int l = 0; l < n_layers; ++l) {
    p->exact[l] = l == 0 || (l + 1 < n_layers && p->split[l + 1]);
    p->g_wpr[l] = (p->out_p[l] + 31) / 32;
    p->g_off[l] = l + 1 < n_layers ? p->gate_words : -1;
    if (l + 1 < n_layers) p->gate_words += M * p->g_wpr[l];
  }
  p->w16 = w16;
  return cudaSuccess;
}

// The shared-memory plan (bytes): two activation buffers [w16 / 8][M][8]
// bf16 and the weight ring (1024-aligned), the gates' words, then the
// layer's biases and near-tie scales [w16] fp32, positions [6][M]
// (hi, lo), directions [3][M], the xyz gradient [3][M], the last layer's
// row-0 preactivation or the seed, and s [2][M], the row norms [M], the
// near-tie queue, its count, its overflow bits, and the ring's mbarriers.
// recompute.py's precise_smem_bytes is the same sum for the CPU side; a
// card test holds the two equal (drt_precise_smem).
struct Plan {
  int act, ring, gate, bias, wn, x, v, gx, pre, hn, q, qn, mask, bar, bytes;
};

__host__ __device__ inline Plan smem_plan(int w16, int gate_words) {
  Plan p;
  p.act = 0;
  p.ring = pm::align1k(2 * M * w16 * 2);
  p.gate = p.ring + RS * STAGE_BYTES;
  p.bias = p.gate + 4 * gate_words;
  p.wn = p.bias + 4 * w16;
  p.x = p.wn + 4 * w16;
  p.v = p.x + 6 * M * 4;
  p.gx = p.v + 3 * M * 4;
  p.pre = p.gx + 3 * M * 4;
  p.hn = p.pre + 2 * M * 4;
  p.q = p.hn + M * 4;
  p.qn = p.q + 4 * QCAP;
  p.mask = p.qn + 16;
  p.bar = p.mask + M * w16 / 8;
  p.bytes = p.bar + 2 * RS * 8;
  return p;
}

struct Args {
  const float* pts;               // [n][3]
  const float* dirs;              // K3: [n][3]
  const float* ct;                // K4: [n][seed_rows]
  int n, seed_rows, scalar_chain;
  const __nv_bfloat16* W;         // pack_precise's flat
  const __nv_bfloat16* ftiles;    // the forward's tensor-core tiles
  const __nv_bfloat16* rtiles;    // the reverse's
  const float* fscale;            // forward near-tie scales, at the layer's bias rows
  const float* rscale;            // reverse near-tie scales, at the rows of the layer below
  const float* bias;              // the folded biases, concatenated
  float* out;                     // K3: [5][n] s, dd, g
  float* gx;                      // K4: [n][3] or null
  double* partials;               // K4: [tiles][SLOTS][u_rows]
  unsigned* ties;                 // += values queued as near ties, values past QCAP
  Precise P;
};

// The block's shared-memory regions; tl holds the ring, the activation
// buffers, the layer's biases (s_bias), near-tie scales (s_wn), row norms
// (s_hn) and the near-tie queue.
struct Blk {
  pm::Tile tl;
  unsigned* gate;
  float* x;    // [6][M]: xyz rounded to bf16, then the low halves
  float* v;    // K3: directions [3][M]
  float* gx;   // [3][M]
  float* pre;  // [2][M]: row 0's preactivation, then the seed; s
  int tile;
};

__device__ __forceinline__ int n_chunks(int cols) {
  int c = 0;
  for (int n0 = 0; n0 < cols; n0 += pm::next_chunk(cols - n0)) ++c;
  return c;
}

// The forward's K: the split layer reads [hi | hi | lo].
__device__ __forceinline__ int fwd_k(const Precise& P, int l) {
  return (P.split[l] ? 3 : 1) * round16(P.in_p[l]);
}

// v + the x products of column c at row r: W_hi.x_hi, W_lo.x_hi,
// W_hi.x_lo, each a 3-term fmaf chain, added in turn.
__device__ __forceinline__ float add_x(const Args& a, int l, float v, int c, const float* s_x,
                                       int r) {
  const int op = a.P.out_p[l];
  const __nv_bfloat16* h = a.W + a.P.wx_hi[l] + c;
  const __nv_bfloat16* o = a.W + a.P.wx_lo[l] + c;
  const float h0 = __bfloat162float(h[0]), h1 = __bfloat162float(h[op]),
              h2 = __bfloat162float(h[2 * op]);
  const float l0 = __bfloat162float(o[0]), l1 = __bfloat162float(o[op]),
              l2 = __bfloat162float(o[2 * op]);
  const float x0 = s_x[r], x1 = s_x[M + r], x2 = s_x[2 * M + r];
  const float y0 = s_x[3 * M + r], y1 = s_x[4 * M + r], y2 = s_x[5 * M + r];
  v = v + fmaf(h2, x2, fmaf(h1, x1, h0 * x0));
  v = v + fmaf(l2, x2, fmaf(l1, x1, l0 * x0));
  return v + fmaf(h2, y2, fmaf(h1, y1, h0 * y0));
}

// The preactivation of layer l at (row r, column c) in the plain
// version's order: the bias b, + each hidden product's own k-order sum,
// + the x products.
__device__ __forceinline__ float fwd_value(const Args& a, const Blk& b, int l, int c, int r,
                                           const __nv_bfloat16* hin, float bias) {
  const Precise& P = a.P;
  const int in_p = P.in_p[l];
  const __nv_bfloat16* wr = a.W + P.rev[l] + (size_t)c * in_p;
  float v = bias + pm::sum_in_order(wr, in_p, hin, r);
  if (P.split[l]) {
    v = v + pm::sum_in_order(a.W + P.lo_rows[l] + (size_t)c * in_p, in_p, hin, r);
    v = v + pm::sum_in_order(wr, in_p, hin + round16(in_p) * M, r);
  }
  if (P.wx_hi[l] >= 0) v = add_x(a, l, v, c, b.x, r);
  return v;
}

__device__ __forceinline__ uint32_t bf2_bits(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows_in_order's loads of k0 .. k0 + 7: 8 weight rows, 4 activation rows.
__device__ __forceinline__ void rows_load(const __nv_bfloat16* w, int len,
                                          const __nv_bfloat16* h, int rg, int k0,
                                          uint4 (&wv)[8], uint4 (&hv)[4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wv[j] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)j * len + k0));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    hv[i] = *reinterpret_cast<const uint4*>(h + act_idx(rg + 16 * i, k0));
}

// part[i][j] = sum over k < len, in k order from 0, of h[rg + 16 i][k] *
// w[j][k] (w: 8 rows of len, row j contiguous; h an activation buffer):
// one fmaf a term, the plain version's sum.
__device__ __forceinline__ void rows_in_order(const __nv_bfloat16* w, int len,
                                              const __nv_bfloat16* h, int rg,
                                              float (&part)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
  uint4 wv[8], hv[4];
  rows_load(w, len, h, rg, 0, wv, hv);
  for (int k0 = 0; k0 < len; k0 += 8) {
    // the next 8 k's loads in flight during these 8 k's FMAs
    uint4 wn[8], hn[4];
    rows_load(w, len, h, rg, k0 + 8 < len ? k0 + 8 : k0, wn, hn);
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // k0 + 2e (low halves), then k0 + 2e + 1
      float w0[8], w1[8], h0[4], h1[4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t u = reinterpret_cast<const uint32_t*>(&wv[j])[e];
        w0[j] = __uint_as_float(u << 16);
        w1[j] = __uint_as_float(u & 0xffff0000u);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t u = reinterpret_cast<const uint32_t*>(&hv[i])[e];
        h0[i] = __uint_as_float(u << 16);
        h1[i] = __uint_as_float(u & 0xffff0000u);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(h0[i], w0[j], part[i][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(h1[i], w1[j], part[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) wv[j] = wn[j];
#pragma unroll
    for (int i = 0; i < 4; ++i) hv[i] = hn[i];
  }
}

// Layer l on CUDA cores, every value in the plain version's order (bias,
// each product's k-order sum, the x products): layer 0, and a layer whose
// consumer splits its input. An item is 8 columns x 4 rows (rg + 16 i);
// weights from the forward-orientation rows in L2, activations from
// shared memory. Writes bf16(relu(v)) at column c of hout and, with lo,
// bf16(relu(v) - that) at column round16(out_p) + c, and with GATES the
// gates.
template <bool GATES>
__device__ __forceinline__ void exact_layer(const Args& a, const Blk& b, int l, const __nv_bfloat16* hin,
                            __nv_bfloat16* hout, bool lo) {
  const Precise& P = a.P;
  const int out_p = P.out_p[l], in_p = P.in_p[l];
  const int passes = P.fwd_hi[l] < 0 ? 0 : (P.split[l] ? 3 : 1);
  const int kh_out = round16(out_p);
  unsigned* gate = b.gate + P.g_off[l];
  const int wpr = P.g_wpr[l];
  for (int it = threadIdx.x; it < (out_p / 8) * 16; it += CONSUMERS) {
    const int rg = it & 15, c0 = 8 * (it >> 4);
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bj = b.tl.s_bias[c0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = bj;
    }
    for (int pass = 0; pass < passes; ++pass) {
      // W_hi.h_hi, W_lo.h_hi, W_hi.h_lo
      const __nv_bfloat16* w =
          a.W + (pass == 1 ? P.lo_rows[l] : P.rev[l]) + (size_t)c0 * in_p;
      const __nv_bfloat16* h = pass == 2 ? hin + round16(in_p) * M : hin;
      float part[4][8];
      rows_in_order(w, in_p, h, rg, part);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] + part[i][j];
    }
    if (P.wx_hi[l] >= 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = add_x(a, l, acc[i][j], c0 + j, b.x, rg + 16 * i);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      unsigned bits = 0u;
      uint32_t hi[4], lw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v0 = acc[i][2 * e], v1 = acc[i][2 * e + 1];
        bits |= (v0 > 0.0f ? 1u : 0u) << (2 * e);
        bits |= (v1 > 0.0f ? 1u : 0u) << (2 * e + 1);
        const float y0 = fmaxf(v0, 0.0f), y1 = fmaxf(v1, 0.0f);
        hi[e] = bf2_bits(y0, y1);
        lw[e] = bf2_bits(y0 - __uint_as_float(hi[e] << 16),
                         y1 - __uint_as_float(hi[e] & 0xffff0000u));
      }
      *reinterpret_cast<uint4*>(hout + act_idx(r, c0)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      if (lo)
        *reinterpret_cast<uint4*>(hout + act_idx(r, kh_out + c0)) =
            make_uint4(lw[0], lw[1], lw[2], lw[3]);
      if (GATES) atomicOr(gate + r * wpr + (c0 >> 5), bits << (c0 & 31));
    }
  }
}

// The fragment's (row, column) of accumulator i: thread (warp w of the
// warpgroup, lane) holds rows 16w + lane/4 (+8), and in each 8-column
// group the columns 2 (lane % 4) (+1).
__device__ __forceinline__ int frag_row0() {
  return 16 * ((threadIdx.x % WG) >> 5) + ((threadIdx.x & 31) >> 2);
}

// One forward N-chunk [n0, n0 + NT) of hidden layer l for one warpgroup:
// the product on the tensor cores, then bias + acc + the x products,
// ReLU, bf16 and (GATES) the gates; a value whose gate or bf16 rounding
// the tensor cores' order may have moved, |v - v_in_order| <= s_wn[c] *
// s_hn[r], is queued.
template <int NT, bool GATES>
__device__ __forceinline__ void fwd_chunk(const Args& a, const Blk& b, int l, int n0, int t0,
                                          const __nv_bfloat16* hin, __nv_bfloat16* hout,
                                          bool wait_turn, bool pass_turn) {
  const Precise& P = a.P;
  const pm::Tile& tl = b.tl;
  const int kv = fwd_k(P, l);
  float acc[NT / 2];
  pm::mma_chunk<NT, RS, true>(tl, acc, pm::smem_u32(hin), kv,
                              P.split[l] ? round16(P.in_p[l]) : kv, t0, wait_turn, pass_turn);
  const int lane = threadIdx.x & 31;
  const int r0 = frag_row0();
  const int cq = n0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = tl.s_bias[cq + 8 * (i / 4) + (i & 1)] + acc[i];
  if (P.wx_hi[l] >= 0) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i)
      acc[i] = add_x(a, l, acc[i], cq + 8 * (i / 4) + (i & 1), b.x, r0 + 8 * ((i / 2) & 1));
  }
  const float hn[2] = {tl.s_hn[r0], tl.s_hn[r0 + 8]};
  uint32_t y[NT / 4], ties[NT / 4];
#pragma unroll
  for (int i = 0; i < NT / 4; ++i) {  // column pair (c, c + 1) of row r0 + 8h
    const int c = cq + 8 * (i / 2), h = i & 1;
    const float v0 = acc[2 * i], v1 = acc[2 * i + 1];
    const float d0 = tl.s_wn[c] * hn[h], d1 = tl.s_wn[c + 1] * hn[h];
    y[i] = bf2_bits(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    ties[i] = bf2_bits(fmaxf(v0 - d0, 0.0f), fmaxf(v1 - d1, 0.0f)) ^
              bf2_bits(fmaxf(v0 + d0, 0.0f), fmaxf(v1 + d1, 0.0f));
  }
#pragma unroll
  for (int i = 0; i < NT / 4; ++i)
    *reinterpret_cast<uint32_t*>(hout + act_idx(r0 + 8 * (i & 1), cq + 8 * (i / 2))) = y[i];
  // the gates: a word is 32 columns; 128- and 64-wide chunks start on a
  // word, so the quad's OR is the word and one lane stores it; 8-wide
  // chunks share their word with the layer's other 8-wide chunks
  if constexpr (GATES) {
    constexpr int NW = NT >= 32 ? NT / 32 : 1;
    unsigned gw[2][NW];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < NW; ++m) gw[h][m] = 0u;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      const int c = cq + 8 * (i / 4) + (i & 1);
      gw[(i / 2) & 1][i / 16] |= (acc[i] > 0.0f ? 1u : 0u) << (c & 31);
    }
    unsigned* gate = b.gate + P.g_off[l] + (n0 >> 5);
    const int wpr = P.g_wpr[l];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < NW; ++m) {
        unsigned w = gw[h][m];
        w |= __shfl_xor_sync(0xffffffffu, w, 1);
        w |= __shfl_xor_sync(0xffffffffu, w, 2);
        unsigned* dst = gate + (r0 + 8 * h) * wpr + m;
        if (NT >= 32) {
          if ((lane & 3) == (m & 3)) *dst = w;
        } else if ((lane & 3) == 0) {
          atomicOr(dst, w);
        }
      }
  }
#pragma unroll
  for (int i = 0; i < NT / 4; ++i) {  // rare
    if (ties[i] & 0xffffu) pm::near_tie<QCAP>(tl, r0 + 8 * (i & 1), cq + 8 * (i / 2));
    if (ties[i] >> 16) pm::near_tie<QCAP>(tl, r0 + 8 * (i & 1), cq + 8 * (i / 2) + 1);
  }
}

// A queued forward value of layer l ((row << 16) | column) in k order:
// its bf16 activation and (GATES) its gate.
template <bool GATES>
__device__ __forceinline__ void fwd_tie(const Args& a, const Blk& b, int l,
                                        const __nv_bfloat16* hin, __nv_bfloat16* hout,
                                        unsigned e) {
  const int r = (int)(e >> 16), c = (int)(e & 0xffffu);
  const float v = fwd_value(a, b, l, c, r, hin, b.tl.s_bias[c]);
  hout[act_idx(r, c)] = __float2bfloat16_rn(fmaxf(v, 0.0f));
  if (!GATES) return;
  unsigned* w = b.gate + a.P.g_off[l] + r * a.P.g_wpr[l] + (c >> 5);
  if (v > 0.0f)
    atomicOr(w, 1u << (c & 31));
  else
    atomicAnd(w, ~(1u << (c & 31)));
}

// One reverse N-chunk [n0, n0 + NT) of hidden layer l for one warpgroup:
// delta_{l-1} = gate_{l-1} * (bf16(delta_l) . W_l^T) on the tensor cores
// (hin holds bf16(delta_l)), then bf16 into hout with the near-tie test.
template <int NT>
__device__ __forceinline__ void rev_chunk(const Args& a, const Blk& b, int l, int n0, int t0,
                                          const __nv_bfloat16* hin, __nv_bfloat16* hout,
                                          bool wait_turn, bool pass_turn) {
  const Precise& P = a.P;
  const pm::Tile& tl = b.tl;
  const int k16 = round16(P.out_p[l]);
  float acc[NT / 2];
  pm::mma_chunk<NT, RS, true>(tl, acc, pm::smem_u32(hin), k16, k16, t0, wait_turn, pass_turn);
  const int lane = threadIdx.x & 31;
  const int r0 = frag_row0();
  const int cq = n0 + 2 * (lane & 3);
  constexpr int NW = NT >= 32 ? NT / 32 : 1;
  const unsigned* gate = b.gate + P.g_off[l - 1] + (n0 >> 5);
  const int wpr = P.g_wpr[l - 1];
  unsigned gw[2][NW];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < NW; ++m) gw[h][m] = gate[(r0 + 8 * h) * wpr + m];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int c = cq + 8 * (i / 4) + (i & 1);
    acc[i] = acc[i] * (((gw[(i / 2) & 1][i / 16] >> (c & 31)) & 1u) ? 1.0f : 0.0f);
  }
  const float hn[2] = {tl.s_hn[r0], tl.s_hn[r0 + 8]};
  uint32_t y[NT / 4], ties[NT / 4];
#pragma unroll
  for (int i = 0; i < NT / 4; ++i) {
    const int c = cq + 8 * (i / 2), h = i & 1;
    const unsigned g = gw[h][i / 8] >> (c & 31);
    const float v0 = acc[2 * i], v1 = acc[2 * i + 1];
    const float d0 = tl.s_wn[c] * hn[h], d1 = tl.s_wn[c + 1] * hn[h];
    y[i] = bf2_bits(v0, v1);
    ties[i] = (bf2_bits(v0 - d0, v1 - d1) ^ bf2_bits(v0 + d0, v1 + d1)) &
              ((g & 1u ? 0xffffu : 0u) | (g & 2u ? 0xffff0000u : 0u));
  }
#pragma unroll
  for (int i = 0; i < NT / 4; ++i)
    *reinterpret_cast<uint32_t*>(hout + act_idx(r0 + 8 * (i & 1), cq + 8 * (i / 2))) = y[i];
#pragma unroll
  for (int i = 0; i < NT / 4; ++i) {  // rare
    if (ties[i] & 0xffffu) pm::near_tie<QCAP>(tl, r0 + 8 * (i & 1), cq + 8 * (i / 2));
    if (ties[i] >> 16) pm::near_tie<QCAP>(tl, r0 + 8 * (i & 1), cq + 8 * (i / 2) + 1);
  }
}

// A queued reverse value (gate 1) in o order from the forward-orientation
// rows of layer l ([in_p][out_p], row c contiguous).
__device__ __forceinline__ void rev_tie(const Args& a, int l, const __nv_bfloat16* hin,
                                        __nv_bfloat16* hout, unsigned e) {
  const int r = (int)(e >> 16), c = (int)(e & 0xffffu);
  const int op = a.P.out_p[l];
  const float v = pm::sum_in_order(a.W + a.P.fwd_hi[l] + (size_t)c * op, op, hin, r);
  hout[act_idx(r, c)] = __float2bfloat16_rn(v);
}

// The near ties a layer queued: the queue, then the overflow bits.
template <bool FWD, bool GATES = true>
__device__ __forceinline__ void settle_ties(const Args& a, const Blk& b, int l,
                                            const __nv_bfloat16* hin, __nv_bfloat16* hout) {
  const pm::Tile& tl = b.tl;
  const int queued = *tl.qn;
  const int tid = threadIdx.x;
  for (int i = tid; i < min(queued, QCAP); i += CONSUMERS) {
    if (FWD)
      fwd_tie<GATES>(a, b, l, hin, hout, tl.q[i]);
    else
      rev_tie(a, l, hin, hout, tl.q[i]);
  }
  if (queued > QCAP)  // the overflow, a word of bits a thread
    for (int w = tid; w < M * tl.w16 / 32; w += CONSUMERS) {
      for (unsigned bits = tl.mask[w]; bits; bits &= bits - 1) {
        const int bit = 32 * w + __ffs(bits) - 1;
        const unsigned e = ((unsigned)(bit / tl.w16) << 16) | (unsigned)(bit % tl.w16);
        if (FWD)
          fwd_tie<GATES>(a, b, l, hin, hout, e);
        else
          rev_tie(a, l, hin, hout, e);
      }
      tl.mask[w] = 0;
    }
  if (tid == 0 && queued > 0) {
    atomicAdd(a.ties, (unsigned)queued);
    if (queued > QCAP) atomicAdd(a.ties + 1, (unsigned)(queued - QCAP));
  }
}

// The row norms of the tensor cores' A operand over K: four threads a
// row, then a shuffle sum. FWD split layers: [hi | hi | lo].
__device__ __forceinline__ void row_norms(const Blk& b, const __nv_bfloat16* hin, int len,
                                          int lo_at) {
  const int tid = threadIdx.x, r = tid / 4, part = tid % 4;
  float ss = 0.0f, sl = 0.0f;
  for (int k = 8 * part; k < len; k += 32) {
    float h[8];
    unpack8(*reinterpret_cast<const uint4*>(hin + act_idx(r, k)), h);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(h[i], h[i], ss);
    if (lo_at > 0) {
      unpack8(*reinterpret_cast<const uint4*>(hin + act_idx(r, lo_at + k)), h);
#pragma unroll
      for (int i = 0; i < 8; ++i) sl = fmaf(h[i], h[i], sl);
    }
  }
  ss = lo_at > 0 ? 2.0f * ss + sl : ss;
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  if (part == 0) b.tl.s_hn[r] = sqrtf(ss);
}

// The x products' share of the xyz gradient, layer l: gx[c][r] +=
// sum_o W_x_hi[c][o] bf16(delta_l)[r][o] in o order (hin holds bf16(delta_l)).
__device__ __forceinline__ void gx_layer(const Args& a, const Blk& b, int l,
                                         const __nv_bfloat16* hin) {
  const Precise& P = a.P;
  if (P.wx_hi[l] < 0) return;
  for (int i = threadIdx.x; i < 3 * M; i += CONSUMERS) {
    const int c = i / M, r = i - c * M;
    b.gx[i] += pm::sum_in_order(a.W + P.wx_hi[l] + c * P.out_p[l], P.out_p[l], hin, r);
  }
}

// K4's sum over points, per 32 rows of a tile: x[r] (r < 32) summed in
// fp64 by the tree of a warp's shuffle-down reduction (x[i] + x[i + 16],
// then + the partner 8, 4, 2, 1 lanes on), into slot (2 tile + half).
// K4 on CUDA cores summed a 32-point tile so (slot = tile), and the slots
// in order, chunk by chunk: the same fp32 deltas give the same u bits.

// K4's partials of layer l from values on CUDA cores, one thread a column:
// the last layer and the one below it, where the latent enters there.
template <typename F>
__device__ __forceinline__ void u_direct(const Args& a, const Blk& b, int l, F value) {
  const Precise& P = a.P;
  for (int c = threadIdx.x; c < P.out_p[l]; c += CONSUMERS)
    for (int half = 0; half < 2; ++half) {
      double s[16];
      for (int i = 0; i < 16; ++i)
        s[i] = (double)value(32 * half + i, c) + (double)value(32 * half + i + 16, c);
      for (int off = 8; off > 0; off >>= 1)
        for (int i = 0; i < off; ++i) s[i] += s[i + off];
      a.partials[((size_t)b.tile * SLOTS + half) * P.u_rows + P.u_off[l] + c] = s[0];
    }
}

// K4's reverse of hidden layer l where the latent enters layer l - 1: on
// CUDA cores, every value in o order (the plain version's fp32 delta_{l-1},
// which u sums), gated, rounded to bf16 into hout; each column's rows
// summed per 32 rows by the shuffle-down tree above. An item is 8 columns
// x 4 rows (rg + 16 i), a half-warp the 64 rows of its 8 columns.
__device__ __forceinline__ void exact_rev_layer(const Args& a, const Blk& b, int l,
                                                const __nv_bfloat16* hin,
                                                __nv_bfloat16* hout) {
  const Precise& P = a.P;
  const int cols = P.in_p[l], op = P.out_p[l];
  const unsigned* gate = b.gate + P.g_off[l - 1];
  const int wpr = P.g_wpr[l - 1];
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  for (int it = threadIdx.x; it < (cols / 8) * 16; it += CONSUMERS) {
    const int rg = it & 15, c0 = 8 * (it >> 4);
    float v[4][8];
    rows_in_order(a.W + P.fwd_hi[l] + (size_t)c0 * op, op, hin, rg, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const unsigned g = gate[r * wpr + (c0 >> 5)] >> (c0 & 31);
      uint32_t y[4];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = v[i][j] * (((g >> j) & 1u) ? 1.0f : 0.0f);
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = bf2_bits(v[i][2 * e], v[i][2 * e + 1]);
      *reinterpret_cast<uint4*>(hout + act_idx(r, c0)) = make_uint4(y[0], y[1], y[2], y[3]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows 32 h + rg and 32 h + rg + 16
        double s = (double)v[2 * h][j] + (double)v[2 * h + 1][j];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) s += __shfl_down_sync(half, s, off, 16);
        if (rg == 0)
          a.partials[((size_t)b.tile * SLOTS + h) * P.u_rows + P.u_off[l - 1] + c0 + j] = s;
      }
  }
}

// The SDF value from the last layer's row-0 preactivation, and the
// reverse seed there: `seed` times the tanh chain's derivative.
__device__ __forceinline__ float tanh_chain(const Precise& P, float pre0, float seed,
                                            float* s_out) {
  float s = pre0;
  if (P.use_tanh) s = tanhf(s);
  if (P.final_tanh) s = tanhf(s);
  float dchain = seed;
  if (P.use_tanh) {
    const float t1 = tanhf(pre0);
    dchain = dchain * (1.0f - t1 * t1);
  }
  if (P.final_tanh) dchain = dchain * (1.0f - s * s);
  *s_out = s;
  return dchain;
}

// K4 runs the reverse of layer l on CUDA cores where the latent enters
// layer l - 1 (exact_rev_layer); K3 runs every hidden layer's on the
// tensor cores.
template <int MODE>
__device__ __forceinline__ bool exact_rev(const Precise& P, int l) {
  return MODE == K4 && P.u_off[l - 1] >= 0;
}

// Zero an activation buffer's columns [c0, c1) (the K padding).
__device__ __forceinline__ void zero_cols(__nv_bfloat16* h, int c0, int c1) {
  for (int i = threadIdx.x; i < M * (c1 - c0); i += CONSUMERS)
    h[act_idx(i % M, c0 + i / M)] = __float2bfloat16_rn(0.0f);
}

// The consumer warpgroups: per tile, the forward, the seed, the reverse
// and the outputs (VALUE: the forward and s). Chunk g of the tile's
// tensor-core chunks (forward, then reverse) runs on warpgroup g % 2; t
// counts the block's ring tiles.
template <int MODE>
__device__ __forceinline__ void consume(const Args& a, Blk& b, int tiles) {
  constexpr bool SDG = MODE == K3, REV = MODE != VALUE;
  const Precise& P = a.P;
  const int tid = threadIdx.x, wg = pm::warp_uniform(tid / WG);
  const int L = P.n_layers - 1;
  const int w16 = P.w16;
  int chunks = 0;
  for (int l = 1; l < L; ++l)
    chunks += (P.exact[l] ? 0 : n_chunks(P.out_p[l])) +
              (!REV || exact_rev<MODE>(P, l) ? 0 : n_chunks(P.in_p[l]));
  const bool want_gx = SDG || a.gx != nullptr;
  const bool need_pre = MODE != K4 || a.scalar_chain;
  const int sr = a.seed_rows;
  int t = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    b.tile = tile;
    const int r0 = tile * M;
    pm::consumer_sync();  // the last tile's outputs are read
    if (tid < M) {
      const int p = r0 + tid;
      const bool mine = p < a.n;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float xv = mine ? a.pts[3 * (size_t)p + ax] : 0.0f;
        const float hi = round_bf16(xv);
        b.x[ax * M + tid] = hi;
        b.x[(3 + ax) * M + tid] = round_bf16(xv - hi);
        if (SDG) b.v[ax * M + tid] = mine ? a.dirs[3 * (size_t)p + ax] : 0.0f;
        if (REV) b.gx[ax * M + tid] = 0.0f;
      }
    }
    if (REV)
      for (int w = tid; w < P.gate_words; w += CONSUMERS) b.gate[w] = 0u;
    __nv_bfloat16* cur = b.tl.act;
    __nv_bfloat16* oth = b.tl.act + M * w16;
    int g = 0;

    // ---- forward: layers 0 .. L-1 into cur, swapping ----
    for (int l = 0; l < L; ++l) {
      const int out_p = P.out_p[l];
      const bool tc = !P.exact[l];
      for (int o = tid; o < out_p; o += CONSUMERS) {
        b.tl.s_bias[o] = a.bias[P.b_off[l] + o];
        if (tc) b.tl.s_wn[o] = a.fscale[P.b_off[l] + o];
      }
      if (tc) {
        row_norms(b, cur, P.in_p[l], P.split[l] ? round16(P.in_p[l]) : 0);
        if (tid == 0) *b.tl.qn = 0;
      }
      pm::consumer_sync();
      const bool lo = P.split[l + 1] != 0;
      if (!tc) {
        exact_layer<REV>(a, b, l, cur, oth, lo);
      } else {
        const int kv = fwd_k(P, l);
        for (int n0 = 0, nt; n0 < out_p; n0 += nt, ++g) {
          nt = pm::next_chunk(out_p - n0);
          if (g % 2 == wg) {
            const bool wait_turn = g > 0, pass_turn = g + 1 < chunks;
            if (nt == 128)
              fwd_chunk<128, REV>(a, b, l, n0, t, cur, oth, wait_turn, pass_turn);
            else if (nt == 64)
              fwd_chunk<64, REV>(a, b, l, n0, t, cur, oth, wait_turn, pass_turn);
            else
              fwd_chunk<8, REV>(a, b, l, n0, t, cur, oth, wait_turn, pass_turn);
          }
          const int kt = STAGE_BYTES / (2 * nt);
          t += (kv + kt - 1) / kt;
        }
        pm::consumer_sync();
        settle_ties<true, REV>(a, b, l, cur, oth);
      }
      const int k16 = round16(out_p);
      zero_cols(oth, out_p, k16);
      if (lo) zero_cols(oth, k16 + out_p, 2 * k16);
      pm::fence_async_smem();
      pm::consumer_sync();
      __nv_bfloat16* tmp = cur;
      cur = oth;
      oth = tmp;
    }

    // ---- the last layer's row 0 (s) and the reverse seed, into oth ----
    if (need_pre)
      for (int r = tid; r < M; r += CONSUMERS) {
        const float pre = fwd_value(a, b, L, 0, r, cur, a.bias[P.b_off[L]]);
        const int p = r0 + r;
        const float seed = MODE != K4 ? 1.0f : (p < a.n ? a.ct[(size_t)p * sr] : 0.0f);
        float s;
        b.pre[r] = tanh_chain(P, pre, seed, &s);
        b.pre[M + r] = s;
      }
    pm::consumer_sync();
    if constexpr (!REV) {
      if (tid < M && r0 + tid < a.n) a.out[r0 + tid] = b.pre[M + tid];
      continue;
    }
    const int oL = P.out_p[L], iL = P.in_p[L];
    auto seed_at = [&](int r, int o) -> float {
      if (o >= oL) return 0.0f;
      if (need_pre) return o == 0 ? b.pre[r] : 0.0f;
      const int p = r0 + r;
      return o < sr && p < a.n ? a.ct[(size_t)p * sr + o] : 0.0f;
    };
    for (int i = tid; i < M * round16(oL); i += CONSUMERS)
      oth[act_idx(i % M, i / M)] = __float2bfloat16_rn(seed_at(i % M, i / M));
    if (!SDG && P.u_off[L] >= 0) u_direct(a, b, L, seed_at);
    pm::consumer_sync();

    // ---- the last layer's reverse on CUDA cores: oth -> cur ----
    if (want_gx) gx_layer(a, b, L, oth);
    const unsigned* gate_b = b.gate + P.g_off[L - 1];
    const int wpr_b = P.g_wpr[L - 1];
    auto delta_below = [&](int r, int k) -> float {
      const float v = pm::sum_in_order<1>(a.W + P.fwd_hi[L] + (size_t)k * oL, oL, oth, r);
      return v * (((gate_b[r * wpr_b + (k >> 5)] >> (k & 31)) & 1u) ? 1.0f : 0.0f);
    };
    for (int i = tid; i < M * (iL / 8); i += CONSUMERS) {
      const int r = i % M, k0 = 8 * (i / M);
      uint32_t y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = bf2_bits(delta_below(r, k0 + 2 * e), delta_below(r, k0 + 2 * e + 1));
      *reinterpret_cast<uint4*>(cur + act_idx(r, k0)) = make_uint4(y[0], y[1], y[2], y[3]);
    }
    if (!SDG && P.u_off[L - 1] >= 0) u_direct(a, b, L - 1, delta_below);
    zero_cols(cur, iL, round16(iL));
    pm::fence_async_smem();
    pm::consumer_sync();

    // ---- the hidden layers' reverse on the tensor cores: cur -> oth ----
    for (int l = L - 1; l >= 1; --l) {
      const int cols = P.in_p[l], k16 = round16(P.out_p[l]);
      if (exact_rev<MODE>(P, l)) {
        if (want_gx) gx_layer(a, b, l, cur);
        exact_rev_layer(a, b, l, cur, oth);
        zero_cols(oth, cols, round16(cols));
        pm::fence_async_smem();
        pm::consumer_sync();
        __nv_bfloat16* tmp = cur;
        cur = oth;
        oth = tmp;
        continue;
      }
      for (int k = tid; k < cols; k += CONSUMERS) b.tl.s_wn[k] = a.rscale[P.b_off[l - 1] + k];
      row_norms(b, cur, P.out_p[l], 0);
      if (tid == 0) *b.tl.qn = 0;
      pm::consumer_sync();
      if (want_gx) gx_layer(a, b, l, cur);
      for (int n0 = 0, nt; n0 < cols; n0 += nt, ++g) {
        nt = pm::next_chunk(cols - n0);
        if (g % 2 == wg) {
          const bool wait_turn = g > 0, pass_turn = g + 1 < chunks;
          if (nt == 128)
            rev_chunk<128>(a, b, l, n0, t, cur, oth, wait_turn, pass_turn);
          else if (nt == 64)
            rev_chunk<64>(a, b, l, n0, t, cur, oth, wait_turn, pass_turn);
          else
            rev_chunk<8>(a, b, l, n0, t, cur, oth, wait_turn, pass_turn);
        }
        const int kt = STAGE_BYTES / (2 * nt);
        t += (k16 + kt - 1) / kt;
      }
      pm::consumer_sync();
      settle_ties<false>(a, b, l, cur, oth);
      zero_cols(oth, cols, round16(cols));
      pm::fence_async_smem();
      pm::consumer_sync();
      __nv_bfloat16* tmp = cur;
      cur = oth;
      oth = tmp;
    }
    if (want_gx) gx_layer(a, b, 0, cur);
    pm::consumer_sync();

    // ---- outputs ----
    if (SDG) {
      if (tid < M && r0 + tid < a.n) {
        const int p = r0 + tid;
        const float g0 = b.gx[tid], g1 = b.gx[M + tid], g2 = b.gx[2 * M + tid];
        a.out[p] = b.pre[M + tid];
        a.out[(size_t)a.n + p] = g0 * b.v[tid] + g1 * b.v[M + tid] + g2 * b.v[2 * M + tid];
        a.out[2 * (size_t)a.n + p] = g0;
        a.out[3 * (size_t)a.n + p] = g1;
        a.out[4 * (size_t)a.n + p] = g2;
      }
    } else if (a.gx != nullptr) {
      for (int i = tid; i < 3 * M; i += CONSUMERS) {
        const int c = i / M, r = i - c * M;
        if (r0 + r < a.n) a.gx[(size_t)(r0 + r) * 3 + c] = b.gx[i];
      }
    }
  }
}

// The producer: per tile, the forward's tensor-core layers' tiles, then
// (but for VALUE) the reverse's, in the consumers' order (K4 skips the
// layers it runs on CUDA cores).
template <int MODE>
__device__ void produce(const Args& a, const pm::Tile& tl, int tiles) {
  const Precise& P = a.P;
  const int L = P.n_layers - 1;
  int stage = 0;
  uint32_t phase = 0u;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const char* src = reinterpret_cast<const char*>(a.ftiles);
    for (int l = 1; l < L; ++l)
      if (!P.exact[l])
        src = pm::stream_layer<RS>(src, P.out_p[l], fwd_k(P, l), tl.ring, tl.full, tl.empty,
                                   stage, phase);
    if (MODE == VALUE) continue;
    src = reinterpret_cast<const char*>(a.rtiles);
    for (int l = L - 1; l >= 1; --l) {
      if (exact_rev<MODE>(P, l))
        src += (size_t)2 * P.in_p[l] * round16(P.out_p[l]);
      else
        src = pm::stream_layer<RS>(src, P.in_p[l], round16(P.out_p[l]), tl.ring, tl.full,
                                   tl.empty, stage, phase);
    }
  }
}

// A block of the kernels in mode MODE.
template <int MODE>
__device__ __forceinline__ void precise_block(const Args& a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Plan plan = smem_plan(a.P.w16, a.P.gate_words);
  Blk b;
  pm::Tile& tl = b.tl;
  tl.act = reinterpret_cast<__nv_bfloat16*>(smem + plan.act);
  tl.s_bias = reinterpret_cast<float*>(smem + plan.bias);
  tl.s_wn = reinterpret_cast<float*>(smem + plan.wn);
  tl.s_hn = reinterpret_cast<float*>(smem + plan.hn);
  tl.q = reinterpret_cast<unsigned*>(smem + plan.q);
  tl.qn = reinterpret_cast<int*>(smem + plan.qn);
  tl.mask = reinterpret_cast<unsigned*>(smem + plan.mask);
  const uint64_t* bars = reinterpret_cast<const uint64_t*>(smem + plan.bar);
  tl.ring = pm::smem_u32(smem + plan.ring);
  tl.full = pm::smem_u32(bars);
  tl.empty = pm::smem_u32(bars + RS);
  tl.w16 = a.P.w16;
  b.gate = reinterpret_cast<unsigned*>(smem + plan.gate);
  b.x = reinterpret_cast<float*>(smem + plan.x);
  b.v = reinterpret_cast<float*>(smem + plan.v);
  b.gx = reinterpret_cast<float*>(smem + plan.gx);
  b.pre = reinterpret_cast<float*>(smem + plan.pre);
  b.tile = 0;
  pm::init_block<RS>(tl);
  __syncthreads();
  const int tiles = (a.n + M - 1) / M;
  if (pm::warp_uniform(threadIdx.x / 32) >= CONSUMERS / 32) {
    if (threadIdx.x == CONSUMERS) produce<MODE>(a, tl, tiles);
    __syncwarp();
  } else {
    consume<MODE>(a, b, tiles);
  }
}

// SDG: K3; else K4.
template <bool SDG>
__global__ void __launch_bounds__(THREADS, 1) precise_kernel(const __grid_constant__ Args a) {
  precise_block<SDG ? K3 : K4>(a);
}

// K3's value alone (drt_precise_value), under a name of its own so that
// K3's and K4's keep theirs.
__global__ void __launch_bounds__(THREADS, 1) precise_value_kernel(const __grid_constant__ Args a) {
  precise_block<VALUE>(a);
}

// One pass of the fixed-order sum: out[c][row] = sum over slots
// c*chunk .. (c+1)*chunk-1 of in[slot][row], in slot order. The last pass
// (one chunk) writes float to out_f instead.
__global__ void sum_tiles_kernel(const double* __restrict__ in, int slots, int rows, int chunk,
                                 double* __restrict__ out_d, float* __restrict__ out_f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int chunks = (slots + chunk - 1) / chunk;
  if (i >= (long long)chunks * rows) return;
  const int row = (int)(i % rows), c = (int)(i / rows);
  const int end = min(slots, (c + 1) * chunk);
  double sum = 0.0;
  for (int q = c * chunk; q < end; ++q) sum += in[(size_t)q * rows + row];
  if (out_f != nullptr)
    out_f[row] = (float)sum;
  else
    out_d[(size_t)c * rows + row] = sum;
}

// The decoder, its buffers and the launch's own values into a; a decoder
// whose plan does not fit a block is refused.
static cudaError_t precise_args(const int* table, int n_layers, const void* W,
                                const void* ftiles, const void* rtiles,
                                const float* fscale, const float* rscale, const float* bias,
                                Args* a) {
  cudaError_t err = make_precise(table, n_layers, &a->P);
  if (err != cudaSuccess) return err;
  if (smem_plan(a->P.w16, a->P.gate_words).bytes > pm::SMEM_LIMIT) return cudaErrorInvalidValue;
  a->W = static_cast<const __nv_bfloat16*>(W);
  a->ftiles = static_cast<const __nv_bfloat16*>(ftiles);
  a->rtiles = static_cast<const __nv_bfloat16*>(rtiles);
  a->fscale = fscale;
  a->rscale = rscale;
  a->bias = bias;
  a->pts = a->dirs = a->ct = nullptr;
  a->out = a->gx = nullptr;
  a->partials = nullptr;
  a->seed_rows = 1;
  a->scalar_chain = 1;
  return cudaSuccess;
}

// A persistent grid: what fits on the card, at most one block a tile.
static cudaError_t launch(void (*kernel)(Args), const Args& a, cudaStream_t stream) {
  const int bytes = smem_plan(a.P.w16, a.P.gate_words).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, bytes);
  const int tiles = (a.n + M - 1) / M;
  const int grid = occ * sms < tiles ? occ * sms : tiles;
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace rk
}  // namespace drt

// K3. points, dirs [n][3] fp32; W the packed bf16 weights (flat), ftiles
// and rtiles the forward's and the reverse's tensor-core tiles, fscale
// and rscale the near-tie scales,
// bias the per-layer padded biases, concatenated (pack_precise); table in
// host memory (see make_precise); out [5][n] fp32: s, dd, g; ties [2]
// uint32 counters (+= values queued as near ties, values past the queue).
// Returns cudaGetLastError().
extern "C" int drt_precise_sdg(const float* pts, const float* dirs, int n, const void* W,
                               const void* ftiles, const void* rtiles,
                               const float* fscale, const float* rscale, const float* bias,
                               const int* table, int n_layers, float* out, unsigned* ties,
                               void* stream) {
  using namespace drt::rk;
  Args a;
  cudaError_t err = precise_args(table, n_layers, W, ftiles, rtiles, fscale, rscale,
                                 bias, &a);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  a.pts = pts;
  a.dirs = dirs;
  a.n = n;
  a.out = out;
  a.ties = ties;
  return (int)launch(precise_kernel<true>, a, (cudaStream_t)stream);
}

// K3's value alone: s [n] fp32 into out, for points [n][3]; the other
// arguments as for drt_precise_sdg (rtiles and rscale are not read).
extern "C" int drt_precise_value(const float* pts, int n, const void* W, const void* ftiles,
                                 const void* rtiles, const float* fscale, const float* rscale,
                                 const float* bias, const int* table, int n_layers, float* out,
                                 unsigned* ties, void* stream) {
  using namespace drt::rk;
  Args a;
  cudaError_t err = precise_args(table, n_layers, W, ftiles, rtiles, fscale, rscale,
                                 bias, &a);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  a.pts = pts;
  a.n = n;
  a.out = out;
  a.ties = ties;
  return (int)launch(precise_value_kernel, a, (cudaStream_t)stream);
}

// K4. points [n][3] and ct [n][seed_rows] fp32; W .. bias and table as
// for drt_precise_sdg; gx [n][3] fp32 or null; partials [slots][u_rows]
// and scratch [ceil(slots / chunk)][u_rows] fp64 work buffers, slots >=
// 2 ceil(n / 64), one per 32 points (u_rows: the summed out_p of the
// split layers);
// u [u_rows] fp32 out, layers in ascending order; ties as for K3.
// Returns cudaGetLastError().
extern "C" int drt_precise_bias_grads(const float* pts, const float* ct, int n, int seed_rows,
                                      int scalar_chain, const void* W, const void* ftiles,
                                      const void* rtiles,
                                      const float* fscale, const float* rscale,
                                      const float* bias, const int* table, int n_layers,
                                      float* gx, double* partials, double* scratch, int slots,
                                      int chunk, float* u, unsigned* ties, void* stream) {
  using namespace drt::rk;
  Args a;
  cudaError_t err = precise_args(table, n_layers, W, ftiles, rtiles, fscale, rscale,
                                 bias, &a);
  if (err != cudaSuccess) return (int)err;
  const int need = SLOTS * ((n + M - 1) / M);
  if (a.P.u_rows <= 0 || seed_rows < 1 || seed_rows > a.P.out_p[n_layers - 1] || n < 0 ||
      chunk < 2 || slots < need || slots < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) {
    err = cudaMemsetAsync(u, 0, (size_t)a.P.u_rows * sizeof(float), s);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  a.pts = pts;
  a.ct = ct;
  a.n = n;
  a.seed_rows = seed_rows;
  a.scalar_chain = scalar_chain;
  a.gx = gx;
  a.partials = partials;
  a.ties = ties;
  err = launch(precise_kernel<false>, a, s);
  if (err != cudaSuccess) return (int)err;
  // the per-32-point partials, summed in slot order, chunk by chunk
  const double* src = partials;
  double* dst = scratch;
  int count = need;
  for (;;) {
    const int chunks = (count + chunk - 1) / chunk;
    const long long threads = (long long)chunks * a.P.u_rows;
    const int blocks = (int)((threads + 255) / 256);
    if (chunks == 1) {
      sum_tiles_kernel<<<blocks, 256, 0, s>>>(src, count, a.P.u_rows, chunk, nullptr, u);
      break;
    }
    sum_tiles_kernel<<<blocks, 256, 0, s>>>(src, count, a.P.u_rows, chunk, dst, nullptr);
    count = chunks;
    src = dst;
    dst = dst == scratch ? partials : scratch;
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory (bytes) K3 and K4 ask for with this decoder
// (smem_plan), -1 for a table make_precise refuses: for the host's check
// of its own sum.
extern "C" int drt_precise_smem(const int* table, int n_layers) {
  drt::rk::Precise P;
  if (drt::rk::make_precise(table, n_layers, &P) != cudaSuccess) return -1;
  return drt::rk::smem_plan(P.w16, P.gate_words).bytes;
}
