// The tensor-core tile march of K1 (batched_march.cu: a persistent grid
// striding over the tiles) and K1-multi (fused_march.cu: one block per
// tile), one __global__ template on point_mlp.cuh's body.
//
// Replaces, with those two files, the JAX package's TPU kernels
// dist_renderer_tpu/ops/pallas/batched_march.py::
// pallas_sphere_trace_persistent (K1) and ::pallas_sphere_trace_batched
// (K1-multi), whose step body is march_body.py's mlp_apply/march_loop.
//
// Computes, for each tile of M = 64 rays: the full bracket-secant sphere
// trace of each ray (fresh carry, full budget, salvage optional), each
// step evaluating the latent-folded MLP with the biases of the ray's frame
// (ray r belongs to frame r / rays_per_frame; a tile may straddle two
// frames, frames being padded to 32 rays only). The tile marches until
// every ray has finished or the budget ends; a tile with no active ray
// costs one vote and writes its rows from the fresh carry.
//
// What bounds it on an H100: a step is one evaluation of the decoder for
// the tile's 64 rows (1.58 M multiply-adds a row for the 8x512 decoder),
// so the tensor cores, as for K5 (point_mlp.cuh); 64 rays march until the
// slowest finishes, so a tile's lanes idle as its rays finish (the rounds
// scheduler's caps and re-packs bound that).
//
// Design:
// - Each step: 64 threads write the bf16-rounded sample positions, the
//   block runs point_mlp.cuh's eval_tile (wgmma, near ties summed again in
//   k order, the last layer's first output in k order into s_sdf), then
//   64 threads run march_body.cuh's march_one. The activations are the
//   in-order ones up to a near tie the margin misses (NEAR_TIE in
//   batched_march.py), so a ray's bits are those of K1-grid, K2 and the
//   in-order plain version, whatever tile or launch holds it.
// - The carry (12 floats) and geometry (o, v, near - margin, far) of the
//   tile's rays live in shared memory, not in registers: the consumer
//   warpgroups' accumulators take the 168 a 288-thread block gets.
// - The producer warp streams the same weight sequence once per step,
//   counting ring tiles across steps and tiles, and votes with the block
//   each step: it never streams a step that does not run, so no copy is
//   in flight when the block exits.
// - The continue vote is __syncthreads_or through warp_uniform: a loop
//   that looks divergent around the MMAs makes ptxas serialize them.

#pragma once

#include "point_mlp.cuh"

namespace drt {
namespace mm {

using pm::M;

struct MarchArgs {
  pm::PointArgs p;        // the decoder, its weights and the bias bank
  const float* rays;      // [16][n]: origin 0-2, dir 3-5, d0, near, far, active
  int n, rays_per_frame;
  MarchParams mp;
  float* out;             // [8][n]
};

// Geometry rows of the plan's [8][M] region.
enum { G_O = 0, G_V = 3, G_NEAR = 6, G_FAR = 7 };

template <bool PERSISTENT>
__global__ void __launch_bounds__(pm::THREADS, 1)
march_mma_kernel(const __grid_constant__ MarchArgs a) {
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
  pm::init_block(tl);
  __syncthreads();
  const int tiles = (n + M - 1) / M;
  const int per_eval = pm::stream_tiles(a.p.dec);
  int stream = 0;  // the block's ring tiles streamed so far
  for (int tile = blockIdx.x; tile < tiles; tile += PERSISTENT ? (int)gridDim.x : tiles) {
    const int r0 = tile * M, r = r0 + t;
    const bool mine = t < M && r < n;
    if (t < M) {
      Carry c = fresh_carry(0.0f, 0.0f);
      float g[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (mine) {
#pragma unroll
        for (int i = 0; i < 6; ++i) g[i] = a.rays[(size_t)i * n + r];
        c = fresh_carry(a.rays[6 * (size_t)n + r], a.rays[9 * (size_t)n + r]);
        g[G_NEAR] = a.rays[7 * (size_t)n + r] - a.mp.margin;
        g[G_FAR] = a.rays[8 * (size_t)n + r];
      }
      store_carry(c, s_c, M, t);
#pragma unroll
      for (int i = 0; i < 8; ++i) s_g[i * M + t] = g[i];
      s_frame[t] = min(r, n - 1) / rpf;
    }
    tl.tile0 = r0;
    tl.frame0 = r0 / rpf;
    tl.pure = tl.frame0 == (min(r0 + M, n) - 1) / rpf;
    for (int k = 0; k < a.mp.max_steps; ++k) {
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
    if (mine) {
      const Carry c = load_carry(s_c, M, t);
      const bool brk = c.d_lo > NEG_BIG / 2 && c.d_hi < POS_BIG / 2;
      float* o = a.out + r;
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

// One launch: K1 (PERSISTENT: what fits on the card, each block striding
// over the tiles) or K1-multi (a block per tile). Returns a cudaError_t;
// a decoder whose plan does not fit a block is refused before launch.
template <bool PERSISTENT>
inline int launch(const float* rays, int n, int rays_per_frame, const void* W,
                  const void* tiles, const void* wrows, const float* wscale,
                  const int* table, int n_layers, const float* bank, int bank_stride,
                  int final_tanh, float eps, float deps, float alpha, float margin,
                  int max_steps, int salvage, float* out, void* stream) {
  MarchArgs a;
  cudaError_t err = pm::point_args(table, n_layers, final_tanh, W, tiles, wrows, wscale,
                                   bank, bank_stride, nullptr, n, nullptr, &a.p);
  if (err != cudaSuccess) return (int)err;
  const pm::Plan plan = pm::smem_plan(a.p.w16, true);
  if (plan.bytes > pm::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (rays_per_frame <= 0) return (int)cudaErrorInvalidValue;
  a.rays = rays;
  a.n = n;
  a.rays_per_frame = rays_per_frame;
  a.mp = MarchParams{eps, deps, alpha, margin, max_steps, salvage};
  a.out = out;
  auto kernel = march_mma_kernel<PERSISTENT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + M - 1) / M;
  int grid = n_tiles;
  if (PERSISTENT) {
    int dev = 0, sms = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, pm::THREADS, plan.bytes);
    if (occ * sms < grid) grid = occ * sms;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  kernel<<<grid, pm::THREADS, plan.bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mm
}  // namespace drt
