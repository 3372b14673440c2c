// K1-grid: the single-frame grid march.
//
// Replaces the JAX package's TPU kernel
// dist_renderer_tpu/ops/pallas/fused_march.py::pallas_sphere_trace
// (_make_kernel, step body march_body.py mlp_apply/march_rows).
//
// Computes: the full bracket-secant sphere trace of every ray of one frame
// (seeded or from the sphere entry, inactive rays never march, salvage
// optional), each step evaluating the latent-folded MLP with the frame's
// folded biases, one fp32 vector.
//
// Design: one launch per call, one thread block per TILE-ray tile (a grid
// of tiles, as the TPU kernel's grid of 512-ray blocks), so the hardware
// hands the next tile to whichever SM frees first. The body is
// sphere_trace.cuh's tile march, K1's, with the biases read as a
// one-column bank and every ray in frame 0, so on the same rays K1-grid
// equals K1 at F=1 bit for bit; only the grid differs (K1 launches what
// fits on the card and strides over the tiles, 1.3-1.4x slower on a frame's
// rays from the sphere entry on an H100).

#include "sphere_trace.cuh"

namespace drt {

__global__ void __launch_bounds__(NTHREADS)
sphere_trace_grid_kernel(const float* __restrict__ rays, int n, Decoder dec,
                         const __nv_bfloat16* __restrict__ W,
                         const float* __restrict__ bias, int bias_stride,
                         MarchParams mp, float* __restrict__ out) {
  trace_tile(rays, n, n, blockIdx.x * TILE, dec, W, bias, bias_stride, mp, out);
}

}  // namespace drt

// rays [16][n] fp32 (origin 0-2, dir 3-5, d0, near, far, active); W the
// packed bf16 weights; table [n_layers][5] in host memory; bias the folded
// biases [total][bias_stride] fp32 (column 0 is read); out [8][n] fp32.
// Returns cudaGetLastError().
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
      rays, n, dec, static_cast<const __nv_bfloat16*>(W), bias, bias_stride,
      mp, out);
  return (int)cudaGetLastError();
}
