// K1-grid, the single-frame grid march on CUDA cores, and K1-multi, the
// multi-frame grid march on tensor cores.
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
// biases; K1-multi's are frame-major, rays_per_frame each, and ray r reads
// column r / rays_per_frame of the bias bank [total, F_pad] (a tile may
// straddle two frames: each ray finds its own column, where the TPU
// kernel selected one per block).
//
// Design: one launch per call, one thread block per tile (a grid of
// tiles, as the TPU kernels' grids of 512-ray blocks), so the hardware
// hands the next tile to whichever SM frees first. K1-grid runs
// sphere_trace.cuh's 32-ray tile march on march_body.cuh's CUDA-core
// mlp_tile; K1-multi runs K1's 64-ray tensor-core tile march
// (march_mma.cuh), so on the same rays it equals K1 bit for bit, and both
// equal K1-grid and K2 through the in-order sums their bodies share.

#include "march_mma.cuh"
#include "sphere_trace.cuh"

namespace drt {

__global__ void __launch_bounds__(NTHREADS)
sphere_trace_grid_kernel(const float* __restrict__ rays, int n,
                         int rays_per_frame, Decoder dec,
                         const __nv_bfloat16* __restrict__ W,
                         const float* __restrict__ bank, int bank_stride,
                         MarchParams mp, float* __restrict__ out) {
  trace_tile(rays, n, rays_per_frame, blockIdx.x * TILE, dec, W, bank,
             bank_stride, mp, out);
}

}  // namespace drt

// K1-grid. rays [16][n] fp32 (origin 0-2, dir 3-5, d0, near, far, active);
// W the packed bf16 weights; table [n_layers][5] in host memory; bias the
// folded biases [total][bias_stride] fp32 (column 0 is read); out [8][n]
// fp32. Returns cudaGetLastError().
extern "C" int drt_sphere_trace_grid(
    const float* rays, int n, const void* W, const int* table, int n_layers,
    const float* bias, int bias_stride, int final_tanh, float eps, float deps,
    float alpha, float margin, int max_steps, int salvage, float* out,
    void* stream) {
  using namespace drt;
  Decoder dec;
  cudaError_t err = make_decoder(table, n_layers, final_tanh, &dec);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  const MarchParams mp{eps, deps, alpha, margin, max_steps, salvage};
  const size_t smem = march_smem_bytes(dec);
  err = cudaFuncSetAttribute(sphere_trace_grid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + TILE - 1) / TILE;
  sphere_trace_grid_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      rays, n, n, dec, static_cast<const __nv_bfloat16*>(W), bias, bias_stride, mp, out);
  return (int)cudaGetLastError();
}

// K1-multi: K1's arguments (drt_sphere_trace_persistent), one block per
// 64-ray tile; bank [total][bank_stride] fp32.
extern "C" int drt_sphere_trace_batched(
    const float* rays, int n, int rays_per_frame, const void* W, const void* tiles,
    const void* wrows, const float* wscale, const int* table, int n_layers,
    const float* bank, int bank_stride, int final_tanh, float eps, float deps,
    float alpha, float margin, int max_steps, int salvage, float* out, void* stream) {
  return drt::mm::launch<false>(rays, n, rays_per_frame, W, tiles, wrows, wscale, table,
                                n_layers, bank, bank_stride, final_tanh, eps, deps, alpha,
                                margin, max_steps, salvage, out, stream);
}
