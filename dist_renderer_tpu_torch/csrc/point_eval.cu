// K5: bulk point evaluation of the latent-folded decoder.
//
// Replaces the JAX package's TPU kernel
// dist_renderer_tpu/ops/pallas/mlp_eval.py::pallas_point_eval
// (_make_eval_kernel: one march_body.mlp_apply per 512-point block, no
// loop): mesh-extraction SDF grids, color lookups and the forward of the
// differentiable color head.
//
// Computes: points [n][3] fp32, rounded to bf16 as the march rounds its
// sample positions -> the folded decoder's first out_rows output rows,
// out [n][out_rows] fp32 (through tanh when the decoder ends in one).
// The bf16 weights, fp32 accumulation and one bf16 rounding per ReLU
// output are the march's, so a point's value is the one the march would
// read there.
//
// Design: one thread block per TILE-point tile (K1-grid's grid); the tile
// runs the march's MLP body, march_body.cuh's mlp_tile, once. A thread
// sums each output in a fixed k order, so a point's bits do not depend
// on its tile or on how a caller groups points into launches. A ragged
// last tile evaluates zeros in its spare lanes and stores only its own
// points. What bounds it on an H100 is march_body.cuh's: CUDA-core FMA
// throughput (about 1.6 M multiply-adds a point for the 8x512 decoder)
// with the bf16 weights L2-resident; tensor cores are later work.

#include "march_body.cuh"

namespace drt {

template <int OUT_ROWS>
__global__ void __launch_bounds__(NTHREADS)
point_eval_kernel(const float* __restrict__ pts, int n, Decoder dec,
                  const __nv_bfloat16* __restrict__ W,
                  const float* __restrict__ bias, int bias_stride,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float s_x[3 * TILE];
  __shared__ float s_out[OUT_ROWS * TILE];
  __shared__ int s_frame[TILE];
  const int t = threadIdx.x;
  const int p = blockIdx.x * TILE + t;
  if (t < TILE) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      s_x[a * TILE + t] = p < n ? round_bf16(pts[3 * p + a]) : 0.0f;
    s_frame[t] = 0;  // every point reads column 0 of the folded biases
  }
  __syncthreads();
  mlp_tile<OUT_ROWS>(dec, W, bias, bias_stride, s_frame, s_x, s_h, s_out);
  if (t < TILE && p < n) {
#pragma unroll
    for (int c = 0; c < OUT_ROWS; ++c) out[OUT_ROWS * p + c] = s_out[c * TILE + t];
  }
}

template <int OUT_ROWS>
static cudaError_t launch_point_eval(const float* pts, int n, const Decoder& dec,
                                     const void* W, const float* bias,
                                     int bias_stride, float* out, void* stream) {
  const size_t smem = march_smem_bytes(dec);
  cudaError_t err = cudaFuncSetAttribute(point_eval_kernel<OUT_ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + TILE - 1) / TILE;
  point_eval_kernel<OUT_ROWS><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      pts, n, dec, static_cast<const __nv_bfloat16*>(W), bias, bias_stride, out);
  return cudaGetLastError();
}

}  // namespace drt

// K5. pts [n][3] fp32; W the packed bf16 weights; table [n_layers][5] in
// host memory; bias the folded biases [total][bias_stride] fp32 (column 0
// is read); out [n][out_rows] fp32, out_rows 1 or 3. Returns
// cudaGetLastError().
extern "C" int drt_point_eval(const float* pts, int n, const void* W,
                              const int* table, int n_layers, const float* bias,
                              int bias_stride, int final_tanh, int out_rows,
                              float* out, void* stream) {
  drt::Decoder dec;
  cudaError_t err = drt::make_decoder(table, n_layers, final_tanh, &dec);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (out_rows == 1)
    return (int)drt::launch_point_eval<1>(pts, n, dec, W, bias, bias_stride, out, stream);
  if (out_rows == 3)
    return (int)drt::launch_point_eval<3>(pts, n, dec, W, bias, bias_stride, out, stream);
  return (int)cudaErrorInvalidValue;
}
