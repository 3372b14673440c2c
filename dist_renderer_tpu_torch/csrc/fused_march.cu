// K1-grid, the single-frame grid march, and K1-multi, the multi-frame
// grid march: both on march_mma.cuh's tensor-core tile march, one block
// per 64-ray tile.
//
// K1-grid replaces the JAX package's TPU kernel
// dist_renderer_tpu/ops/pallas/fused_march.py::pallas_sphere_trace
// (_make_kernel, step body march_body.py mlp_apply/march_rows); K1-multi
// replaces dist_renderer_tpu/ops/pallas/batched_march.py::
// pallas_sphere_trace_batched (_make_multi_kernel), its multi-frame form.
//
// Computes: the full bracket-secant sphere trace of every ray (seeded or
// from the sphere entry, inactive rays never march, salvage optional),
// each step evaluating the latent-folded MLP with the biases of the ray's
// frame: K1-grid's rays are one frame and read column 0 of the folded
// biases (a one-column bank, rays_per_frame = n); K1-multi's are
// frame-major, rays_per_frame each, and ray r reads column r /
// rays_per_frame of the bias bank [total, F_pad] (a tile may straddle two
// frames: each ray finds its own column, where the TPU kernel selected
// one per block).
//
// Design: one launch per call, one thread block per tile (a grid of
// tiles, as the TPU kernels' grids of 512-ray blocks), so the hardware
// hands the next tile to whichever SM frees first: on the bench decoder
// that beat K1's persistent grid, whose blocks each stride over a fixed
// set of tiles (PERF.md). Both run K1's tile march, so on the same rays
// they equal K1 bit for bit. K1-grid has a kernel of its own, the same
// template, so a profile and the build log name it. What bounds them is in
// march_mma.cuh.

#include "march_mma.cuh"

namespace drt {

constexpr bool GRID_PERSISTENT = false;  // K1-grid: a block per tile

// K1-grid: a range of one frame's rays.
__global__ void __launch_bounds__(pm::THREADS, 1)
sphere_trace_grid_kernel(const __grid_constant__ mm::MarchArgs a) {
  mm::march_tiles<GRID_PERSISTENT, false>(a);
}

}  // namespace drt

// K1-grid. rays [16][n] fp32 (origin 0-2, dir 3-5, d0, near, far, active);
// W the packed bf16 weights, tiles, wrows and wscale their MMA layout (as
// for K1, batched_march.cu); table [n_layers][5] in host memory; bias the
// folded biases [total][bias_stride] fp32 (column 0 is read); out [8][n]
// fp32. Returns cudaGetLastError().
extern "C" int drt_sphere_trace_grid(
    const float* rays, int n, const void* W, const void* tiles, const void* wrows,
    const float* wscale, const int* table, int n_layers, const float* bias,
    int bias_stride, int final_tanh, float eps, float deps, float alpha, float margin,
    int max_steps, int salvage, float* out, void* stream) {
  using namespace drt;
  return mm::launch_range(sphere_trace_grid_kernel, GRID_PERSISTENT, rays, n, n, W, tiles,
                          wrows, wscale, table, n_layers, bias, bias_stride, final_tanh, eps,
                          deps, alpha, margin, max_steps, salvage, out, stream);
}

// K1-multi: K1's arguments (drt_sphere_trace_persistent), one block per
// 64-ray tile; bank [total][bank_stride] fp32.
extern "C" int drt_sphere_trace_batched(
    const float* rays, int n, int rays_per_frame, const void* W, const void* tiles,
    const void* wrows, const float* wscale, const int* table, int n_layers,
    const float* bank, int bank_stride, int final_tanh, float eps, float deps,
    float alpha, float margin, int max_steps, int salvage, float* out, void* stream) {
  using namespace drt::mm;
  return launch_range(march_mma_kernel<false>, false, rays, n, rays_per_frame, W, tiles,
                      wrows, wscale, table, n_layers, bank, bank_stride, final_tanh, eps,
                      deps, alpha, margin, max_steps, salvage, out, stream);
}
