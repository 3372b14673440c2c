// The in-order march: a verification aid, not a port of a TPU kernel and
// no route. No wrapper of any path calls it.
//
// Marches every ray as the routed march kernels do (K1, K1-multi, K1-grid,
// K2: march_mma.cuh), with each step's decoder evaluation on CUDA cores
// and every hidden product summed in k order from 0, one fmaf a term: the
// plain version's order with the in-order product (dot_in_order.cu in
// place of its GEMM). The tensor-core kernels sum in another order and sum
// again in k order only the values near a bf16 rounding boundary
// (NEAR_TIE, an empirical margin); equal bits here, on millions of rays,
// are the evidence that the margin missed no tie there.
//
// Computes: rays [16][n] (origin 0-2, dir 3-5, d0, near, far, active) ->
// out [8][n] (depth, hit, min_sdf, depth_at_min, last_sdf, steps,
// unresolved, bracketed): the full bracket-secant march of each ray from
// its fresh carry, salvage optional, ray r reading column r /
// rays_per_frame of the bias bank.
//
// Design: one block of 256 threads per 32-ray tile. A thread computes an
// 8-output x 8-ray micro-tile of a layer, one fmaf chain a value in k
// order; activations stay in shared memory (bf16, two [width][32]
// buffers); one warp owns the tile's march state, one ray a lane. Bound by
// CUDA-core FMA throughput (1.58 M multiply-adds a ray and step for the
// 8x512 decoder): several times slower than the tensor-core march, which
// is why no path runs it.

#include "march_body.cuh"

namespace drt {
namespace io {

constexpr int TILE = 32;        // rays per thread block
constexpr int NTHREADS = 256;   // threads per block
constexpr int RG = TILE / 8;    // 8-ray groups per tile

// One MLP evaluation for the tile: positions s_x [3][TILE] (bf16-rounded
// fp32) -> s_sdf [TILE], the last layer's first output row (through the
// final tanh when the decoder has one). s_h holds two [max_width][TILE]
// bf16 buffers. Every thread of the block must call it; it ends with a
// barrier.
static __device__ void mlp_tile(const Decoder& dec,
                                const __nv_bfloat16* __restrict__ W,
                                const float* __restrict__ bank, int bank_stride,
                                const int* s_frame, const float* s_x,
                                __nv_bfloat16* s_h, float* s_sdf) {
  __nv_bfloat16* hin = s_h;
  __nv_bfloat16* hout = s_h + dec.max_width * TILE;
  for (int l = 0; l < dec.n_layers; ++l) {
    const int out_p = dec.out_p[l], in_p = dec.in_p[l];
    const int wh_off = dec.wh_off[l], wx_off = dec.wx_off[l];
    const int b_off = dec.b_off[l];
    const bool last = l == dec.n_layers - 1;
    // the last layer only needs its first output: one group of 8
    const int items = last ? RG : (out_p / 8) * RG;
    for (int it = threadIdx.x; it < items; it += NTHREADS) {
      const int og = it / RG, rg = it - og * RG;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      if (wh_off >= 0) {
        const __nv_bfloat16* wp = W + wh_off + og * 8;
        const __nv_bfloat16* hp = hin + rg * 8;
#pragma unroll 2
        for (int k = 0; k < in_p; ++k) {
          float w[8], h[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * out_p)), w);
          unpack8(*reinterpret_cast<const uint4*>(hp + k * TILE), h);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(w[i], h[j], acc[i][j]);
        }
      }
      if (wx_off >= 0) {
        float wx[3][8];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          unpack8(__ldg(reinterpret_cast<const uint4*>(W + wx_off + c * out_p + og * 8)),
                  wx[c]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = rg * 8 + j;
          const float x0 = s_x[r], x1 = s_x[TILE + r], x2 = s_x[2 * TILE + r];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float xz = fmaf(wx[2][i], x2, fmaf(wx[1][i], x1, wx[0][i] * x0));
            acc[i][j] = wh_off >= 0 ? acc[i][j] + xz : xz;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = rg * 8 + j;
        const float* bcol = bank + s_frame[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int o = og * 8 + i;
          const float v = acc[i][j] + __ldg(bcol + (size_t)(b_off + o) * bank_stride);
          if (!last) {
            hout[o * TILE + r] = __float2bfloat16_rn(fmaxf(v, 0.0f));
          } else if (o == 0) {
            s_sdf[r] = dec.final_tanh ? tanhf(v) : v;
          }
        }
      }
    }
    __syncthreads();
    __nv_bfloat16* tmp = hin;
    hin = hout;
    hout = tmp;
  }
}

__global__ void __launch_bounds__(NTHREADS)
march_in_order_kernel(const float* __restrict__ rays, int n, int rays_per_frame,
                      Decoder dec, const __nv_bfloat16* __restrict__ W,
                      const float* __restrict__ bank, int bank_stride, MarchParams mp,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float s_x[3 * TILE];
  __shared__ float s_sdf[TILE];
  __shared__ int s_frame[TILE];
  const int t = threadIdx.x;
  const int r = blockIdx.x * TILE + t;
  const bool mine = t < TILE && r < n;
  float o[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
  float near_lo = 0.0f, far = 0.0f;
  Carry c = fresh_carry(0.0f, 0.0f);
  if (mine) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = rays[(size_t)a * n + r];
      v[a] = rays[(size_t)(3 + a) * n + r];
    }
    c = fresh_carry(rays[6 * (size_t)n + r], rays[9 * (size_t)n + r]);
    near_lo = rays[7 * (size_t)n + r] - mp.margin;
    far = rays[8 * (size_t)n + r];
  }
  if (t < TILE) s_frame[t] = mine ? r / rays_per_frame : 0;
  for (int k = 0; k < mp.max_steps; ++k) {
    if (!__syncthreads_or(t < TILE && c.act > 0.5f)) break;
    if (t < TILE) {
#pragma unroll
      for (int a = 0; a < 3; ++a) s_x[a * TILE + t] = round_bf16(o[a] + c.d * v[a]);
    }
    __syncthreads();
    mlp_tile(dec, W, bank, bank_stride, s_frame, s_x, s_h, s_sdf);
    if (t < TILE) march_one(c, s_sdf[t], near_lo, far, mp);
  }
  if (mine) {
    const bool brk = c.d_lo > NEG_BIG / 2 && c.d_hi < POS_BIG / 2;
    float* y = out + r;
    y[0 * (size_t)n] = c.d;
    y[1 * (size_t)n] = c.hit;
    y[2 * (size_t)n] = c.min_sdf;
    y[3 * (size_t)n] = c.d_at_min;
    y[4 * (size_t)n] = c.last_f;
    y[5 * (size_t)n] = c.steps;
    y[6 * (size_t)n] = fmaxf(c.act, c.unres);
    y[7 * (size_t)n] = brk ? 1.0f : 0.0f;
  }
}

}  // namespace io
}  // namespace drt

// rays [16][n] fp32; W the packed bf16 weights (input-major, as for every
// march); table [n_layers][5] in host memory; bank [total][bank_stride]
// fp32, ray r reading column r / rays_per_frame; out [8][n] fp32. Returns
// cudaGetLastError().
extern "C" int drt_march_in_order(const float* rays, int n, int rays_per_frame,
                                  const void* W, const int* table, int n_layers,
                                  const float* bank, int bank_stride, int final_tanh,
                                  float eps, float deps, float alpha, float margin,
                                  int max_steps, int salvage, float* out, void* stream) {
  using namespace drt;
  Decoder dec;
  cudaError_t err = make_decoder(table, n_layers, final_tanh, &dec);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (rays_per_frame <= 0) return (int)cudaErrorInvalidValue;
  const MarchParams mp{eps, deps, alpha, margin, max_steps, salvage};
  const size_t smem = 2 * (size_t)dec.max_width * io::TILE * sizeof(__nv_bfloat16);
  err = cudaFuncSetAttribute(io::march_in_order_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + io::TILE - 1) / io::TILE;
  io::march_in_order_kernel<<<grid, io::NTHREADS, smem, (cudaStream_t)stream>>>(
      rays, n, rays_per_frame, dec, static_cast<const __nv_bfloat16*>(W), bank,
      bank_stride, mp, out);
  return (int)cudaGetLastError();
}
