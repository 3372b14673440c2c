// The tensor-core tile march of every routed march kernel, one body on
// point_mlp.cuh's evaluation: K1 (batched_march.cu: a persistent grid
// striding over the tiles), K1-multi (fused_march.cu: one block per tile),
// K1-grid (fused_march.cu: one frame, the folded biases as a one-column
// bank) and K2's generations (queue_march.cu: a persistent grid over a
// queue of pixels).
//
// Replaces, with those files, the JAX package's TPU kernels
// dist_renderer_tpu/ops/pallas/batched_march.py::
// pallas_sphere_trace_persistent (K1) and ::pallas_sphere_trace_batched
// (K1-multi), fused_march.py::pallas_sphere_trace (K1-grid) and
// queue_march.py::queue_march (K2), whose step body is march_body.py's
// mlp_apply/march_loop.
//
// Computes, for each tile of M = 64 rows: the bracket-secant sphere trace
// of each row's ray for at most kmax steps (budget max_steps, salvage
// optional), each step evaluating the latent-folded MLP with the biases
// of the ray's frame (ray or pixel p belongs to frame p / rays_per_frame).
// A tile's rows come from one of two sources:
// - a range (K1, K1-multi, K1-grid): rows tile * M .. tile * M + 63 of
//   the n rays, the carry fresh from the ray's seed and active flag, kmax
//   = max_steps, the result written as [8][n] rows;
// - a queue (K2): the pixels q_in[tile * M ..] of the queue's *cnt_in,
//   the carry loaded from state [12][n] at the pixel and stored back there
//   after at most kmax steps (the generation's cap), the rays still active
//   appended to q_out (a warp ballot, one atomicAdd a warp).
// A tile marches until every row has finished or kmax ends; a tile with
// no active ray costs one vote.
//
// Frames: a range tile may straddle two frames (frames are padded to 32
// rays only), a queue tile may hold rays of any number of frames. A tile
// is pure when every row's frame equals row 0's (a block vote; rows past
// the end take row 0's frame): it stages its biases once a layer; an
// impure tile reads a bias per row (point_mlp.cuh's bias_at).
//
// What bounds it on an H100: a step is one evaluation of the decoder for
// the tile's 64 rows (1.58 M multiply-adds a row for the 8x512 decoder),
// so the tensor cores, as for K5 (point_mlp.cuh); 64 rays march until the
// slowest finishes, so a tile's lanes idle as its rays finish (the rounds
// scheduler's caps and re-packs bound that for K1, the queue's dense
// re-packing after each generation for K2).
//
// Design:
// - Each step: 64 threads write the bf16-rounded sample positions, the
//   block runs point_mlp.cuh's eval_tile (wgmma, near ties summed again in
//   k order, the last layer's first output in k order into s_sdf), then
//   64 threads run march_body.cuh's march_one. The activations are the
//   in-order ones up to a near tie the margin misses (NEAR_TIE in
//   batched_march.py), so a ray's bits are the in-order plain version's
//   and the in-order witness's (march_in_order.cu), whatever tile, queue
//   slot or launch holds it.
// - The carry (12 floats), geometry (o, v, near - margin, far) and ray or
//   pixel index of the tile's rows live in shared memory, not in
//   registers: the consumer warpgroups' accumulators take the 168 a
//   288-thread block gets.
// - The producer warp streams the same weight sequence once per step,
//   counting ring tiles across steps and tiles, and votes with the block
//   each step: it never streams a step that does not run, so no copy is
//   in flight when the block exits.
// - The continue vote is __syncthreads_or through warp_uniform, and the
//   queue's count is read through warp_uniform: a loop that looks
//   divergent around the MMAs makes ptxas serialize them.

#pragma once

#include "point_mlp.cuh"

namespace drt {
namespace mm {

using pm::M;

struct MarchArgs {
  pm::PointArgs p;        // the decoder, its weights and the bias bank
  const float* rays;      // [16][n]: origin 0-2, dir 3-5, d0, near, far, active
  int n, rays_per_frame;
  int kmax;               // steps a tile marches at most in this launch
  MarchParams mp;
  float* out;             // a range: [8][n] rows
  float* state;           // a queue: the carries [12][n] in pixel order
  const int* q_in;        // a queue: its pixels q_in[0 : *cnt_in]
  const int* cnt_in;
  int* q_out;             // a queue: survivors appended at *cnt_out
  int* cnt_out;
};

// Geometry rows of the plan's [8][M] region.
enum { G_O = 0, G_V = 3, G_NEAR = 6, G_FAR = 7 };

// Append value to queue for every lane with flag set: a warp ballot and
// one atomicAdd a warp. Every lane of the warp must call it.
__device__ __forceinline__ void append_warp(bool flag, int value, int* queue, int* count) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (m == 0u) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (flag) queue[base + __popc(m & ((1u << lane) - 1u))] = value;
}

// The march of every tile of the launch's rows, by every thread of the
// block. PERSISTENT: each block strides over the tiles (gridDim.x apart);
// else a block marches tile blockIdx.x. QUEUE: the rows are the queue's
// pixels, else a range of the rays.
template <bool PERSISTENT, bool QUEUE>
__device__ __forceinline__ void march_tiles(const MarchArgs& a) {
  extern __shared__ __align__(1024) unsigned char march_smem[];
  unsigned char* smem = march_smem;
  const pm::Plan plan = pm::smem_plan(a.p.w16, true);
  const int t = threadIdx.x;
  const int n = a.n, rpf = a.rays_per_frame;
  pm::Tile tl = pm::make_tile(a.p, smem, plan);
  tl.sdf = reinterpret_cast<float*>(smem + plan.sdf);
  float* s_x = reinterpret_cast<float*>(smem + plan.x);
  int* s_frame = reinterpret_cast<int*>(smem + plan.frame);
  float* s_c = reinterpret_cast<float*>(smem + plan.carry);
  float* s_g = reinterpret_cast<float*>(smem + plan.geo);
  int* s_pix = reinterpret_cast<int*>(smem + plan.pix);
  pm::init_block(tl);
  __syncthreads();
  // a queue's count was written by the launch before this one on the stream
  const int rows = QUEUE ? pm::warp_uniform(*a.cnt_in) : n;
  const int tiles = (rows + M - 1) / M;
  const int per_eval = pm::stream_tiles(a.p.dec);
  int stream = 0;  // the block's ring tiles streamed so far
  for (int tile = blockIdx.x; tile < tiles; tile += PERSISTENT ? (int)gridDim.x : tiles) {
    const int i0 = tile * M;
    // each row's ray: its index in a range, its pixel in a queue; rows
    // past the end take row 0's
    const int pix0 = QUEUE ? a.q_in[i0] : i0;
    const bool mine = t < M && i0 + t < rows;
    const int pix = mine ? (QUEUE ? a.q_in[i0 + t] : i0 + t) : pix0;
    if (t < M) {
      Carry c = fresh_carry(0.0f, 0.0f);
      float g[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (mine) {
#pragma unroll
        for (int i = 0; i < 6; ++i) g[i] = a.rays[(size_t)i * n + pix];
        if constexpr (QUEUE)
          c = load_carry(a.state, n, pix);
        else
          c = fresh_carry(a.rays[6 * (size_t)n + pix], a.rays[9 * (size_t)n + pix]);
        g[G_NEAR] = a.rays[7 * (size_t)n + pix] - a.mp.margin;
        g[G_FAR] = a.rays[8 * (size_t)n + pix];
      }
      store_carry(c, s_c, M, t);
#pragma unroll
      for (int i = 0; i < 8; ++i) s_g[i * M + t] = g[i];
      s_frame[t] = pix / rpf;
      s_pix[t] = pix;
    }
    tl.tile0 = i0;
    tl.frame0 = pix0 / rpf;
    tl.pure = pm::warp_uniform(__syncthreads_and(pix / rpf == tl.frame0));
    for (int k = 0; k < a.kmax; ++k) {
      if (!pm::warp_uniform(__syncthreads_or(t < M && s_c[M + t] > 0.5f))) break;
      if (t < M) {
        const float d = s_c[t];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax)
          s_x[ax * M + t] = round_bf16(s_g[(G_O + ax) * M + t] + d * s_g[(G_V + ax) * M + t]);
      }
      __syncthreads();
      pm::eval_tile<1, false, pm::SINK_MARCH>(a.p, tl, stream);
      stream += per_eval;
      __syncthreads();
      if (t < M) {
        Carry c = load_carry(s_c, M, t);
        march_one(c, tl.sdf[t], s_g[G_NEAR * M + t], s_g[G_FAR * M + t], a.mp);
        store_carry(c, s_c, M, t);
      }
    }
    if (t < M) {  // warps 0 and 1, whole
      const bool row = i0 + t < rows;
      const int p = s_pix[t];
      const Carry c = load_carry(s_c, M, t);
      if constexpr (QUEUE) {
        if (row) store_carry(c, a.state, n, p);
        append_warp(row && c.act > 0.5f, p, a.q_out, a.cnt_out);
      } else if (row) {
        const bool brk = c.d_lo > NEG_BIG / 2 && c.d_hi < POS_BIG / 2;
        float* o = a.out + p;
        o[0 * (size_t)n] = c.d;
        o[1 * (size_t)n] = c.hit;
        o[2 * (size_t)n] = c.min_sdf;
        o[3 * (size_t)n] = c.d_at_min;
        o[4 * (size_t)n] = c.last_f;
        o[5 * (size_t)n] = c.steps;
        o[6 * (size_t)n] = fmaxf(c.act, c.unres);
        o[7 * (size_t)n] = brk ? 1.0f : 0.0f;
      }
    }
  }
}

// K1 (PERSISTENT) and K1-multi: a range of rays.
template <bool PERSISTENT>
__global__ void __launch_bounds__(pm::THREADS, 1)
march_mma_kernel(const __grid_constant__ MarchArgs a) {
  march_tiles<PERSISTENT, false>(a);
}

// The arguments every march launch shares: the decoder, its MMA layout
// and bias bank, the rays and the march's parameters (kmax = max_steps;
// the outputs and the queue are the caller's). A decoder whose plan does
// not fit a block is refused before any launch.
inline cudaError_t march_args(const float* rays, int n, int rays_per_frame, const void* W,
                              const void* tiles, const void* wrows, const float* wscale,
                              const int* table, int n_layers, const float* bank,
                              int bank_stride, int final_tanh, float eps, float deps,
                              float alpha, float margin, int max_steps, int salvage,
                              MarchArgs* a) {
  cudaError_t err = pm::point_args(table, n_layers, final_tanh, W, tiles, wrows, wscale,
                                   bank, bank_stride, nullptr, n, nullptr, &a->p);
  if (err != cudaSuccess) return err;
  if (pm::smem_plan(a->p.w16, true).bytes > pm::SMEM_LIMIT) return cudaErrorInvalidValue;
  a->rays = rays;
  a->n = n;
  a->rays_per_frame = rays_per_frame;
  a->kmax = max_steps;
  a->mp = MarchParams{eps, deps, alpha, margin, max_steps, salvage};
  a->out = nullptr;
  a->state = nullptr;
  a->q_in = nullptr;
  a->cnt_in = nullptr;
  a->q_out = nullptr;
  a->cnt_out = nullptr;
  return cudaSuccess;
}

// One launch of a march kernel over at most max_tiles tiles: a block per
// tile, or (persistent) what fits on the card, each block striding over
// them. Returns a cudaError_t.
template <typename K>
inline int launch(K kernel, bool persistent, int max_tiles, const MarchArgs& a,
                  void* stream) {
  const int bytes = pm::smem_plan(a.p.w16, true).bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  int grid = max_tiles;
  if (persistent) {
    int dev = 0, sms = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, pm::THREADS, bytes);
    if (occ * sms < grid) grid = occ * sms;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  kernel<<<grid, pm::THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// A range march: K1, K1-multi or K1-grid, out [8][n].
template <typename K>
inline int launch_range(K kernel, bool persistent, const float* rays, int n,
                        int rays_per_frame, const void* W, const void* tiles,
                        const void* wrows, const float* wscale, const int* table,
                        int n_layers, const float* bank, int bank_stride, int final_tanh,
                        float eps, float deps, float alpha, float margin, int max_steps,
                        int salvage, float* out, void* stream) {
  MarchArgs a;
  cudaError_t err = march_args(rays, n, rays_per_frame, W, tiles, wrows, wscale, table,
                               n_layers, bank, bank_stride, final_tanh, eps, deps, alpha,
                               margin, max_steps, salvage, &a);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (rays_per_frame <= 0) return (int)cudaErrorInvalidValue;
  a.out = out;
  return launch(kernel, persistent, (n + M - 1) / M, a, stream);
}

}  // namespace mm
}  // namespace drt
