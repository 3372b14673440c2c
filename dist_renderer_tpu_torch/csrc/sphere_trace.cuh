// K1-grid's tile march (fused_march.cu: one block per 32-ray tile, the
// folded biases as one column). K1 and K1-multi march 64-ray tiles on the
// tensor cores instead (march_mma.cuh); on the same rays all three give
// the same bits, through the in-order sums their MLP bodies share.
//
// Computes, for one tile of TILE rays: the full bracket-secant sphere
// trace of each ray (fresh carry, full budget, salvage optional), each
// step evaluating the latent-folded MLP with the biases of the ray's frame
// (ray r belongs to frame r / rays_per_frame). The tile marches until
// every ray has finished or the budget ends; a dead tile (the c2f skip
// class, rays missing the bounding sphere) costs one barrier and writes
// its init rows. What bounds it is in march_body.cuh.
//
// It is inlined into the kernel: K1-grid read ~6% slower on an H100 when
// it ran a grid-stride loop for its single tile.

#pragma once

#include "march_body.cuh"

namespace drt {

// rays [16][n] fp32 (origin 0-2, dir 3-5, d0, near, far, active); out [8][n]
// fp32 (depth, hit, min_sdf, depth_at_min, last_sdf, steps, unresolved,
// bracketed). first is the tile's first ray. Every thread of the block
// must call it.
__device__ __forceinline__ void trace_tile(
    const float* __restrict__ rays, int n, int rays_per_frame, int first,
    const Decoder& dec, const __nv_bfloat16* __restrict__ W,
    const float* __restrict__ bank, int bank_stride, const MarchParams& mp,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float s_x[3 * TILE];
  __shared__ float s_sdf[TILE];
  __shared__ int s_frame[TILE];
  const int t = threadIdx.x;
  const int r = first + t;
  const bool mine = t < TILE && r < n;
  float o[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
  float near_lo = 0.0f, far = 0.0f;
  Carry c = fresh_carry(0.0f, 0.0f);
  if (mine) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = rays[a * n + r];
      v[a] = rays[(3 + a) * n + r];
    }
    c = fresh_carry(rays[6 * n + r], rays[9 * n + r]);
    near_lo = rays[7 * n + r] - mp.margin;
    far = rays[8 * n + r];
  }
  if (t < TILE) s_frame[t] = mine ? r / rays_per_frame : 0;
  march_tile(dec, W, bank, bank_stride, mp, mp.max_steps, c, o, v, near_lo,
             far, s_frame, s_x, s_h, s_sdf);
  if (mine) {
    const bool brk = c.d_lo > NEG_BIG / 2 && c.d_hi < POS_BIG / 2;
    out[0 * n + r] = c.d;
    out[1 * n + r] = c.hit;
    out[2 * n + r] = c.min_sdf;
    out[3 * n + r] = c.d_at_min;
    out[4 * n + r] = c.last_f;
    out[5 * n + r] = c.steps;
    out[6 * n + r] = fmaxf(c.act, c.unres);
    out[7 * n + r] = brk ? 1.0f : 0.0f;
  }
}

}  // namespace drt
