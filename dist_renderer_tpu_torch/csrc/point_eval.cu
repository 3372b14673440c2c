// K5: bulk point evaluation of the latent-folded decoder, and K6: the
// banked point evaluation of many frames' points. Both run point_mlp.cuh's
// tensor-core MLP body once per 64-point tile (one thread block), as the
// march kernels K1 and K1-multi run it once per step (march_mma.cuh).
//
// K5 replaces the JAX package's TPU kernel
// dist_renderer_tpu/ops/pallas/mlp_eval.py::pallas_point_eval
// (_make_eval_kernel: one march_body.mlp_apply per 512-point block):
// mesh-extraction SDF grids, color lookups and the forward of the
// differentiable color head. Computes points [n][3] fp32, rounded to bf16
// as the march rounds its sample positions -> the folded decoder's first
// out_rows outputs, out [n][out_rows] fp32 (through tanh when the decoder
// ends in one). bf16 weights, fp32 accumulation and one bf16 rounding per
// ReLU output, as the march; the activations are the in-order ones, so a
// point's value is the march's up to the last layer's summation order.
//
// K6 replaces dist_renderer_tpu/ops/pallas/mlp_eval.py::
// pallas_point_eval_banked (_make_banked_kernel): the proxy verify stage's
// certification probes (ops/cert.py). Points [n][3] fp32, frame-major,
// with active flags [n] and one frame per `block` points
// (frame_of_block[p / block], the bank column of the point's biases) ->
// out [n] fp32. precise_x splits each position into bf16 halves, hi =
// bf16(p) and lo = bf16(p - hi), and every x-product runs on both: the
// probes are about one bf16 quantum of |p| ~ 1 apart, so one half would
// alias them. A 32-point sub-tile with no active point gets +POS_BIG on
// every lane; a 64-point tile with no active point skips the MLP.
//
// What bounds both on an H100, and what the design does about it: see
// point_mlp.cuh.

#include "point_mlp.cuh"

namespace drt {

template <int OUT_ROWS, bool SPLIT_X, bool BANKED>
static cudaError_t launch_point_mlp(const pm::PointArgs& a, void* stream) {
  const pm::Plan plan = pm::smem_plan(a.w16);
  if (plan.bytes > pm::SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = pm::point_mlp_kernel<OUT_ROWS, SPLIT_X, BANKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (a.n + pm::M - 1) / pm::M;
  kernel<<<tiles, pm::THREADS, plan.bytes, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // namespace drt

// K5. pts [n][3] fp32; W the packed bf16 weights, tiles their MMA layout
// (batched_march.pack_mma_tiles), wrows the hidden weights row by row
// (pack_mma_rows) and wscale [total] fp32 each output column's near-tie
// scale (pack_mma_scales); table [n_layers][5] in host
// memory; bias the folded biases [total][bias_stride] fp32 (column 0 is
// read); out [n][out_rows] fp32, out_rows 1 or 3. Returns
// cudaGetLastError().
extern "C" int drt_point_eval(const float* pts, int n, const void* W, const void* tiles,
                              const void* wrows, const float* wscale, const int* table,
                              int n_layers,
                              const float* bias,
                              int bias_stride, int final_tanh, int out_rows,
                              float* out, void* stream) {
  drt::pm::PointArgs a;
  cudaError_t err = drt::pm::point_args(table, n_layers, final_tanh, W, tiles, wrows, wscale,
                                    bias, bias_stride, pts, n, out, &a);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (out_rows == 1) return (int)drt::launch_point_mlp<1, false, false>(a, stream);
  if (out_rows == 3) return (int)drt::launch_point_mlp<3, false, false>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// K6. pts [n][3] fp32; active [n] bytes (0 = inactive); frame_of_block
// [ceil(n / block)] int32, each a column of bank [total][bank_stride]; W,
// tiles, wrows, wscale and table as for K5; precise_x 1 splits the
// positions into bf16 halves; out [n] fp32. Returns cudaGetLastError().
extern "C" int drt_point_eval_banked(const float* pts, const unsigned char* active,
                                     const int* frame_of_block, int block, int n,
                                     const void* W, const void* tiles, const void* wrows,
                                     const float* wscale, const int* table, int n_layers,
                                     const float* bank,
                                     int bank_stride,
                                     int final_tanh, int precise_x, float* out,
                                     void* stream) {
  drt::pm::PointArgs a;
  cudaError_t err = drt::pm::point_args(table, n_layers, final_tanh, W, tiles, wrows, wscale,
                                    bank, bank_stride, pts, n, out, &a);
  if (err != cudaSuccess) return (int)err;
  if (block <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  a.active = active;
  a.frame_of_block = frame_of_block;
  a.block = block;
  if (precise_x) return (int)drt::launch_point_mlp<1, true, true>(a, stream);
  return (int)drt::launch_point_mlp<1, false, true>(a, stream);
}

// The dynamic shared memory (bytes) K5 and K6 ask for at activation width
// w16 (point_mlp.cuh's smem_plan), for the host's check of its own sum.
extern "C" int drt_point_mlp_smem(int w16) { return drt::pm::smem_plan(w16).bytes; }

// The same for K1 and K1-multi, whose plan adds the rays' march state.
extern "C" int drt_march_mma_smem(int w16) { return drt::pm::smem_plan(w16, true).bytes; }
