// K5: bulk point evaluation of the latent-folded decoder, and K6: the
// banked point evaluation of many frames' points (below K5).
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

// K6: the banked point evaluation. Replaces the JAX package's TPU kernel
// dist_renderer_tpu/ops/pallas/mlp_eval.py::pallas_point_eval_banked
// (_make_banked_kernel): the proxy verify stage's certification probes
// (ops/cert.py), full-decoder values at points of many frames against the
// shared weights and the [total][bank_stride] bias bank.
//
// Computes: points [n][3] fp32, frame-major, with active flags [n] and
// one frame per `block` points (frame_of_block[p / block], the bank
// column the point's biases come from) -> out [n] fp32. With SPLIT_X each
// position is split into two bf16 halves, hi = bf16(p) and
// lo = bf16(p - hi), and every x-product runs on both (mlp_tile's
// SPLIT_X): the probes are spaced about one bf16 quantum of |p| ~ 1
// apart, so one bf16 half would alias them. A 32-point tile with no
// active point writes +POS_BIG on every lane and skips the MLP (the TPU
// kernel's unit was its 512-point block; the certification reads only
// active lanes).
//
// Design: K5's grid, one thread block per TILE-point tile running the
// march's MLP body once; each lane reads its own frame's bias column, as
// the multi-frame march does. Bounded, like K5, by CUDA-core FMA
// throughput with the weights L2-resident; the split adds 3 x-products
// per x-layer output, about 0.1% of the 8x512 decoder's multiply-adds.
template <bool SPLIT_X>
__global__ void __launch_bounds__(NTHREADS)
point_eval_banked_kernel(const float* __restrict__ pts,
                         const unsigned char* __restrict__ active,
                         const int* __restrict__ frame_of_block, int block, int n,
                         Decoder dec, const __nv_bfloat16* __restrict__ W,
                         const float* __restrict__ bank, int bank_stride,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float s_x[(SPLIT_X ? 6 : 3) * TILE];
  __shared__ float s_out[TILE];
  __shared__ int s_frame[TILE];
  const int t = threadIdx.x;
  const int p = blockIdx.x * TILE + t;
  const bool mine = t < TILE && p < n;
  if (!__syncthreads_or(mine && active[p] != 0)) {
    if (mine) out[p] = POS_BIG;
    return;
  }
  if (t < TILE) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = mine ? pts[3 * p + a] : 0.0f;
      const float hi = round_bf16(x);
      s_x[a * TILE + t] = hi;
      if constexpr (SPLIT_X) s_x[(3 + a) * TILE + t] = round_bf16(x - hi);
    }
    s_frame[t] = mine ? frame_of_block[p / block] : 0;
  }
  __syncthreads();
  mlp_tile<1, SPLIT_X>(dec, W, bank, bank_stride, s_frame, s_x, s_h, s_out);
  if (mine) out[p] = s_out[t];
}

template <bool SPLIT_X>
static cudaError_t launch_point_eval_banked(const float* pts, const unsigned char* active,
                                            const int* frame_of_block, int block, int n,
                                            const Decoder& dec, const void* W,
                                            const float* bank, int bank_stride,
                                            float* out, void* stream) {
  const size_t smem = march_smem_bytes(dec);
  cudaError_t err = cudaFuncSetAttribute(point_eval_banked_kernel<SPLIT_X>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + TILE - 1) / TILE;
  point_eval_banked_kernel<SPLIT_X><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      pts, active, frame_of_block, block, n, dec,
      static_cast<const __nv_bfloat16*>(W), bank, bank_stride, out);
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

// K6. pts [n][3] fp32; active [n] bytes (0 = inactive); frame_of_block
// [ceil(n / block)] int32, each a column of bank [total][bank_stride]; W
// and table as for K5; precise_x 1 splits the positions into bf16 halves;
// out [n] fp32. Returns cudaGetLastError().
extern "C" int drt_point_eval_banked(const float* pts, const unsigned char* active,
                                     const int* frame_of_block, int block, int n,
                                     const void* W, const int* table, int n_layers,
                                     const float* bank, int bank_stride, int final_tanh,
                                     int precise_x, float* out, void* stream) {
  drt::Decoder dec;
  cudaError_t err = drt::make_decoder(table, n_layers, final_tanh, &dec);
  if (err != cudaSuccess) return (int)err;
  if (block <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (precise_x)
    return (int)drt::launch_point_eval_banked<true>(pts, active, frame_of_block, block, n,
                                                    dec, W, bank, bank_stride, out, stream);
  return (int)drt::launch_point_eval_banked<false>(pts, active, frame_of_block, block, n,
                                                   dec, W, bank, bank_stride, out, stream);
}
