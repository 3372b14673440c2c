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
// Design: march_mma.cuh's tensor-core tile march on a persistent grid (one
// 288-thread block per SM, its shared-memory plan being most of the SM's;
// each block strides over the 64-ray tiles, taking the next when its tile
// has finished). The TPU kernel walked a host-built list of live 512-ray
// chunks because each grid step cost ~11 us there; here a block simply
// finds its tile dead. What bounds it is in march_mma.cuh.

#include "march_mma.cuh"

// rays [16][n] fp32 (origin 0-2, dir 3-5, d0, near, far, active); W the
// packed bf16 weights, tiles their MMA layout, wrows the hidden weights
// row by row and wscale [total] fp32 the near-tie scales (as for K5,
// point_eval.cu); table [n_layers][5] in host memory; bank
// [total][bank_stride] fp32; out [8][n] fp32. Returns cudaGetLastError().
extern "C" int drt_sphere_trace_persistent(
    const float* rays, int n, int rays_per_frame, const void* W, const void* tiles,
    const void* wrows, const float* wscale, const int* table, int n_layers,
    const float* bank, int bank_stride, int final_tanh, float eps, float deps,
    float alpha, float margin, int max_steps, int salvage, float* out, void* stream) {
  using namespace drt::mm;
  return launch_range(march_mma_kernel<true>, true, rays, n, rays_per_frame, W, tiles,
                      wrows, wscale, table, n_layers, bank, bank_stride, final_tanh, eps,
                      deps, alpha, margin, max_steps, salvage, out, stream);
}
