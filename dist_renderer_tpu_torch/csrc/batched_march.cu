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
// Design: sphere_trace.cuh's tile march on a persistent grid (what fits on
// the card; each block strides over the tiles, taking the next when its
// tile has finished). The TPU kernel walked a host-built list of live
// 512-ray chunks because each grid step cost ~11 us there; here a block
// simply finds its tile dead.

#include "sphere_trace.cuh"

namespace drt {

__global__ void __launch_bounds__(NTHREADS)
sphere_trace_kernel(const float* __restrict__ rays, int n, int rays_per_frame,
                    Decoder dec, const __nv_bfloat16* __restrict__ W,
                    const float* __restrict__ bank, int bank_stride,
                    MarchParams mp, float* __restrict__ out) {
  for (long long tile = blockIdx.x; tile * TILE < n; tile += gridDim.x)
    trace_tile(rays, n, rays_per_frame, (int)(tile * TILE), dec, W, bank,
               bank_stride, mp, out);
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
