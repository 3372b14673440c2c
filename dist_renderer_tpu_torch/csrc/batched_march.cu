// K1: the persistent multi-frame march.
//
// Replaces the JAX package's TPU kernel
// dist_renderer_tpu/ops/pallas/batched_march.py::pallas_sphere_trace_persistent
// (_make_persistent_kernel, step body march_body.py mlp_apply/march_loop).
//
// Computes: the full bracket-secant sphere trace of every ray (fresh carry,
// full budget, salvage optional), each step evaluating the latent-folded
// MLP with the frame's biases from a bias bank [total, F_pad].
//
// Design: a block owns a tile of TILE rays and marches it until every ray
// of the tile has finished (or the budget ends), then takes the next tile
// (grid-stride over tiles; the grid is what fits on the card). A dead tile
// costs one barrier. The TPU kernel walked a host-built list of live
// 512-ray chunks because each grid step cost ~11 us there; here a block
// simply finds its tile dead. What bounds it is in march_body.cuh.

#include "march_body.cuh"

namespace drt {

__global__ void __launch_bounds__(NTHREADS)
sphere_trace_kernel(const float* __restrict__ rays, int n, int rays_per_frame,
                    Decoder dec, const __nv_bfloat16* __restrict__ W,
                    const float* __restrict__ bank, int bank_stride,
                    MarchParams mp, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float s_x[3 * TILE];
  __shared__ float s_sdf[TILE];
  __shared__ int s_frame[TILE];
  const int t = threadIdx.x;
  for (long long tile = blockIdx.x; tile * TILE < n; tile += gridDim.x) {
    const int r = (int)(tile * TILE) + t;
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
}

}  // namespace drt

// rays [16][n] fp32 (origin 0-2, dir 3-5, d0, near, far, active); W the
// packed bf16 weights; table [n_layers][5] in host memory; bank
// [total][bank_stride] fp32; out [8][n] fp32. Returns cudaGetLastError().
extern "C" int drt_sphere_trace_persistent(
    const float* rays, int n, int rays_per_frame, const void* W,
    const int* table, int n_layers, const float* bank, int bank_stride,
    int final_tanh, float eps, float deps, float alpha, float margin,
    int max_steps, int salvage, float* out, void* stream) {
  using namespace drt;
  Decoder dec;
  cudaError_t err = make_decoder(table, n_layers, final_tanh, &dec);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (rays_per_frame <= 0) return (int)cudaErrorInvalidValue;
  const MarchParams mp{eps, deps, alpha, margin, max_steps, salvage};
  const size_t smem = march_smem_bytes(dec);
  err = cudaFuncSetAttribute(sphere_trace_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = persistent_grid(sphere_trace_kernel, smem, (n + TILE - 1) / TILE);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  sphere_trace_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      rays, n, rays_per_frame, dec, static_cast<const __nv_bfloat16*>(W), bank,
      bank_stride, mp, out);
  return (int)cudaGetLastError();
}
