// K3: the fused precise recompute forward, and K4: its cotangent-seeded
// backward.
//
// Replace the JAX package's TPU kernels
// dist_renderer_tpu/ops/pallas/recompute.py::precise_sdg_call
// (_make_fwd_kernel: _forward, _seed_last, _reverse) and
// ::precise_bias_grads_call (_make_bwd_kernel).
//
// K3 computes, per point: the precise SDF value s, the spatial gradient
// g = ds/dx by a reverse sweep over the stored ReLU gates, and
// dd = <g, v>. K4 runs the same forward and reverse sweep seeded by a
// cotangent instead of ones, and returns u_l = sum over points of the
// preactivation gradient delta_l of each layer the latent enters (the
// latent gradient is then sum_l W_z,l u_l, two small products on the
// host side), and optionally the ct-weighted xyz gradient per point.
//
// Rounding points are the TPU kernel's:
//   - layers consuming the raw input (split layers) take three bf16
//     products, W_hi.h_hi + W_lo.h_hi + W_hi.h_lo, on their hidden input
//     and on xyz; other hidden layers take one bf16 product; each product
//     is its own fp32 sum over k (an fmaf chain), added to the bias in
//     turn, the TPU kernel's association;
//   - the reverse sweep multiplies bf16(delta) by the bf16 weights in
//     their original orientation, accumulating in fp32.
//
// Design: a block owns a tile of TILE points (grid-stride over tiles).
// The forward keeps fp32 activations in two [width][TILE] shared buffers
// and each layer's ReLU gates as bitmasks (one 32-bit word per output,
// bit = ray); the reverse reuses the two buffers for delta. A thread
// computes an 8 x 8 (outputs x rays) micro-tile: forward weights are read
// input-major and reverse weights output-major, so either way one 16-byte
// load brings 8 consecutive outputs. Zero-padded rows and columns (253 ->
// 256 at the skip shrink) contribute exact zeros. K3 and K4 share the
// forward and the reverse sweep (precise_forward, precise_reverse), so a
// K4 seeded with ones walks K3's arithmetic step for step.
//
// K4's sum over points: the TPU kernel carried u across its sequential
// grid steps. Here each tile writes its own partial (its 32 rays summed
// in fp64 by a fixed warp-shuffle tree) to slot `tile` of a buffer, and
// sum_tiles_kernel adds the slots in tile order, in chunks of a fixed
// size, pass after pass.
// The result depends on neither the grid size nor the SM count, and two
// launches on the same inputs give the same bits (no atomics).
//
// What bounds it on an H100: CUDA-core FMA throughput, about 3.4 M
// multiply-adds per point for the 8x512 decoder (forward, the split skip
// layer's extra products, reverse), with weights re-read from L2 once per
// tile; shared memory (147 KB per block at width 512) allows one block
// per SM. K4's per-tile partials (8 bytes x 1,024 rows per 32 points for
// the 8x512 decoder) and their sum are a few percent of its time. Tensor
// cores are later work.

#include "march_body.cuh"

namespace drt {

static_assert(TILE == 32, "K4's per-tile sum gives each ray of a tile one lane");

struct Precise {
  int n_layers, use_tanh, final_tanh, max_width, u_rows;
  int out_p[MAX_LAYERS], in_p[MAX_LAYERS], split[MAX_LAYERS];
  int fwd_hi[MAX_LAYERS], fwd_lo[MAX_LAYERS], rev[MAX_LAYERS];
  int wx_hi[MAX_LAYERS], wx_lo[MAX_LAYERS], b_off[MAX_LAYERS];
  int u_off[MAX_LAYERS];  // row of the layer's u in K4's output, -1 = none
};

// Host: table = (use_tanh, final_tanh, then per layer out_p, in_p, split,
// fwd_hi, fwd_lo, rev, wx_hi, wx_lo, b_off). The latent enters exactly
// the split layers (pack_precise: split = takes_z), so they carry u.
static cudaError_t make_precise(const int* table, int n_layers, Precise* p) {
  if (n_layers < 2 || n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
  p->n_layers = n_layers;
  p->use_tanh = table[0];
  p->final_tanh = table[1];
  p->u_rows = 0;
  int width = 8;
  for (int l = 0; l < n_layers; ++l) {
    const int* t = table + 2 + 9 * l;
    p->out_p[l] = t[0];
    p->in_p[l] = t[1];
    p->split[l] = t[2];
    p->fwd_hi[l] = t[3];
    p->fwd_lo[l] = t[4];
    p->rev[l] = t[5];
    p->wx_hi[l] = t[6];
    p->wx_lo[l] = t[7];
    p->b_off[l] = t[8];
    p->u_off[l] = t[2] ? p->u_rows : -1;
    if (t[2]) p->u_rows += t[0];
    if (t[0] <= 0 || t[0] % 8 || t[1] % 8) return cudaErrorInvalidValue;
    for (int q = 3; q < 8; ++q)
      if (t[q] >= 0 && t[q] % 8) return cudaErrorInvalidValue;
    const bool has_wh = t[3] >= 0;
    if (has_wh && (l == 0 || t[1] != p->out_p[l - 1] || t[5] < 0 ||
                   (t[2] && t[4] < 0)))
      return cudaErrorInvalidValue;
    if (t[6] >= 0 && t[7] < 0) return cudaErrorInvalidValue;
    if (!has_wh && t[6] < 0) return cudaErrorInvalidValue;
    if (t[0] > width) width = t[0];
    if (t[1] > width) width = t[1];
  }
  p->max_width = width;
  return cudaSuccess;
}

static size_t precise_smem_bytes(const Precise& p) {
  return (2 * (size_t)p.max_width * TILE + (size_t)(p.n_layers - 1) * p.max_width) * 4;
}

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The precise forward of one tile: the points' xyz in s_x [3][TILE];
// activations ping-pong between s_a and s_b; each hidden layer's ReLU
// gates go to s_gate as bitmasks; the last layer's row-0 preactivation to
// s_pre0. Ends after a barrier.
__device__ __forceinline__ void precise_forward(
    const Precise& P, const __nv_bfloat16* __restrict__ W,
    const float* __restrict__ bias, float* s_a, float* s_b, unsigned* s_gate,
    const float* s_x, float* s_pre0) {
  const int t = threadIdx.x;
  const int mw = P.max_width;
  const int last = P.n_layers - 1;
  float* hin = s_a;
  float* hout = s_b;
  for (int l = 0; l <= last; ++l) {
    const int out_p = P.out_p[l], in_p = P.in_p[l];
    const int items = l == last ? RG : (out_p / 8) * RG;
    for (int it = t; it < items; it += NTHREADS) {
      const int og = it / RG, rg = it - og * RG;
      // acc = bias + each product's own fp32 sum, product by product
      // (the TPU kernel's and the plain version's association)
      float acc[8][8], part[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float b = __ldg(bias + P.b_off[l] + og * 8 + i);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = b;
      }
      const int n_h = P.fwd_hi[l] < 0 ? 0 : (P.split[l] ? 3 : 1);
      for (int pass = 0; pass < n_h; ++pass) {
        // split passes: W_hi.h_hi, W_lo.h_hi, W_hi.h_lo
        const __nv_bfloat16* wp =
            W + (pass == 1 ? P.fwd_lo[l] : P.fwd_hi[l]) + og * 8;
        const float* hp = hin + rg * 8;
        const bool low_h = pass == 2;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
#pragma unroll 2
        for (int k = 0; k < in_p; ++k) {
          float w[8], h[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * out_p)), w);
          load8f(hp + k * TILE, h);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float hi = round_bf16(h[j]);
            h[j] = low_h ? round_bf16(h[j] - hi) : hi;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) part[i][j] = fmaf(w[i], h[j], part[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] + part[i][j];
      }
      if (P.wx_hi[l] >= 0) {
        // x passes: W_hi.x_hi, W_lo.x_hi, W_hi.x_lo, each a 3-term sum
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          const int woff = pass == 1 ? P.wx_lo[l] : P.wx_hi[l];
          float w[3][8];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            unpack8(__ldg(reinterpret_cast<const uint4*>(W + woff + c * out_p + og * 8)),
                    w[c]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float x[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float xv = s_x[c * TILE + rg * 8 + j];
              const float xi = round_bf16(xv);
              x[c] = pass == 2 ? round_bf16(xv - xi) : xi;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
              acc[i][j] = acc[i][j] +
                          fmaf(w[2][i], x[2], fmaf(w[1][i], x[1], w[0][i] * x[0]));
          }
        }
      }
      if (l < last) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int o = og * 8 + i;
          unsigned bits = 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            bits |= (acc[i][j] > 0.0f ? 1u : 0u) << j;
            hout[o * TILE + rg * 8 + j] = fmaxf(acc[i][j], 0.0f);
          }
          atomicOr(&s_gate[l * mw + o], bits << (rg * 8));
        }
      } else if (og == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s_pre0[rg * 8 + j] = acc[0][j];
      }
    }
    __syncthreads();
    float* tmp = hin;
    hin = hout;
    hout = tmp;
  }
}

// The SDF value from the last layer's row-0 preactivation, and the
// reverse seed there: `seed` times the tanh chain's derivative.
__device__ __forceinline__ float tanh_chain(const Precise& P, float pre0,
                                            float seed, float* s_out) {
  float s = pre0;
  if (P.use_tanh) s = tanhf(s);
  if (P.final_tanh) s = tanhf(s);
  float dchain = seed;
  if (P.use_tanh) {
    const float t1 = tanhf(pre0);
    dchain = dchain * (1.0f - t1 * t1);
  }
  if (P.final_tanh) dchain = dchain * (1.0f - s * s);
  *s_out = s;
  return dchain;
}

// The reverse sweep of one tile from D, the last layer's preactivation
// gradient [out_p][TILE]; D and E ping-pong. With s_gx, adds the xyz
// gradient to s_gx [3][TILE]. With u, writes for each layer the latent
// enters the tile's sum over its rays of delta_l (fp64, a fixed tree) to
// u[u_off + o] (TILE is the warp size). Ends without a barrier after the layer with no hidden
// input.
__device__ __forceinline__ void precise_reverse(
    const Precise& P, const __nv_bfloat16* __restrict__ W, float* D, float* E,
    const unsigned* s_gate, float* s_gx, double* u) {
  const int t = threadIdx.x;
  for (int l = P.n_layers - 1; l >= 0; --l) {
    const int out_p = P.out_p[l], in_p = P.in_p[l];
    if (u != nullptr && P.u_off[l] >= 0) {
      // one warp per row, one lane per ray, a fixed shuffle tree
      const int lane = t & 31;
      for (int o = t >> 5; o < out_p; o += NTHREADS / 32) {
        double sum = (double)D[o * TILE + lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_down_sync(0xffffffffu, sum, off);
        if (lane == 0) u[P.u_off[l] + o] = sum;
      }
    }
    if (s_gx != nullptr && P.wx_hi[l] >= 0 && t < 3 * TILE) {
      const int c = t / TILE, r = t - c * TILE;
      const __nv_bfloat16* wx = W + P.wx_hi[l] + c * out_p;
      float sum = 0.0f;
      for (int o = 0; o < out_p; ++o)
        sum = fmaf(__bfloat162float(wx[o]), round_bf16(D[o * TILE + r]), sum);
      s_gx[c * TILE + r] += sum;
    }
    if (P.fwd_hi[l] < 0) break;  // no hidden input: the sweep ends here
    const unsigned* gate = s_gate + (l - 1) * P.max_width;
    const int items = (in_p / 8) * RG;
    for (int it = t; it < items; it += NTHREADS) {
      const int kg = it / RG, rg = it - kg * RG;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      const __nv_bfloat16* wp = W + P.rev[l] + kg * 8;
      const float* dp = D + rg * 8;
#pragma unroll 2
      for (int o = 0; o < out_p; ++o) {
        float w[8], d[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(wp + (size_t)o * in_p)), w);
        load8f(dp + o * TILE, d);
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] = round_bf16(d[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(w[i], d[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = kg * 8 + i;
        const unsigned g = gate[k] >> (rg * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          E[k * TILE + rg * 8 + j] = acc[i][j] * (((g >> j) & 1u) ? 1.0f : 0.0f);
      }
    }
    __syncthreads();
    float* tmp = D;
    D = E;
    E = tmp;
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
precise_sdg_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                   int n, Precise P, const __nv_bfloat16* __restrict__ W,
                   const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mw = P.max_width;
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_b = s_a + mw * TILE;
  unsigned* s_gate = reinterpret_cast<unsigned*>(s_b + mw * TILE);
  __shared__ float s_x[3 * TILE], s_v[3 * TILE], s_gx[3 * TILE];
  __shared__ float s_pre0[TILE];
  const int t = threadIdx.x;
  const int last = P.n_layers - 1;

  for (long long tile = blockIdx.x; tile * TILE < n; tile += gridDim.x) {
    const int r0 = (int)(tile * TILE);
    if (t < 3 * TILE) {
      const int c = t / TILE, r = t - c * TILE;
      const bool ok = r0 + r < n;
      s_x[c * TILE + r] = ok ? pts[(size_t)(r0 + r) * 3 + c] : 0.0f;
      s_v[c * TILE + r] = ok ? dirs[(size_t)(r0 + r) * 3 + c] : 0.0f;
      s_gx[c * TILE + r] = 0.0f;
    }
    for (int q = t; q < last * mw; q += NTHREADS) s_gate[q] = 0u;
    __syncthreads();

    precise_forward(P, W, bias, s_a, s_b, s_gate, s_x, s_pre0);

    // reverse seed: d s / d pre_last on row 0 (the tanh chain)
    float* D = s_a;
    float s_val = 0.0f;
    if (t < TILE) D[t] = tanh_chain(P, s_pre0[t], 1.0f, &s_val);
    for (int q = TILE + t; q < P.out_p[last] * TILE; q += NTHREADS) D[q] = 0.0f;
    __syncthreads();

    precise_reverse(P, W, D, s_b, s_gate, s_gx, nullptr);
    __syncthreads();

    if (t < TILE && r0 + t < n) {
      const int r = r0 + t;
      const float g0 = s_gx[t], g1 = s_gx[TILE + t], g2 = s_gx[2 * TILE + t];
      out[r] = s_val;
      out[(size_t)n + r] = g0 * s_v[t] + g1 * s_v[TILE + t] + g2 * s_v[2 * TILE + t];
      out[2 * (size_t)n + r] = g0;
      out[3 * (size_t)n + r] = g1;
      out[4 * (size_t)n + r] = g2;
    }
    __syncthreads();
  }
}

// ct [n][seed_rows]. scalar_chain: column 0 seeds row 0 through the tanh
// chain; else the columns are preactivation cotangents of the last
// layer's first seed_rows rows. partials [tiles][u_rows]; gx [n][3] or
// null.
__global__ void __launch_bounds__(NTHREADS, 1)
precise_bias_grads_kernel(const float* __restrict__ pts, const float* __restrict__ ct,
                          int n, int seed_rows, int scalar_chain, Precise P,
                          const __nv_bfloat16* __restrict__ W,
                          const float* __restrict__ bias, float* __restrict__ gx,
                          double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mw = P.max_width;
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_b = s_a + mw * TILE;
  unsigned* s_gate = reinterpret_cast<unsigned*>(s_b + mw * TILE);
  __shared__ float s_x[3 * TILE], s_gx[3 * TILE];
  __shared__ float s_pre0[TILE];
  const int t = threadIdx.x;
  const int last = P.n_layers - 1;

  for (long long tile = blockIdx.x; tile * TILE < n; tile += gridDim.x) {
    const int r0 = (int)(tile * TILE);
    if (t < 3 * TILE) {
      const int c = t / TILE, r = t - c * TILE;
      s_x[c * TILE + r] = r0 + r < n ? pts[(size_t)(r0 + r) * 3 + c] : 0.0f;
      s_gx[c * TILE + r] = 0.0f;
    }
    for (int q = t; q < last * mw; q += NTHREADS) s_gate[q] = 0u;
    __syncthreads();

    precise_forward(P, W, bias, s_a, s_b, s_gate, s_x, s_pre0);

    // reverse seed from the cotangent; rays past n seed zero
    float* D = s_a;
    if (scalar_chain) {
      if (t < TILE) {
        const float c = r0 + t < n ? ct[(size_t)(r0 + t) * seed_rows] : 0.0f;
        float s_val;
        D[t] = tanh_chain(P, s_pre0[t], c, &s_val);
      }
      for (int q = TILE + t; q < P.out_p[last] * TILE; q += NTHREADS) D[q] = 0.0f;
    } else {
      for (int q = t; q < P.out_p[last] * TILE; q += NTHREADS) {
        const int row = q / TILE, r = q - row * TILE;
        D[q] = row < seed_rows && r0 + r < n
                   ? ct[(size_t)(r0 + r) * seed_rows + row] : 0.0f;
      }
    }
    __syncthreads();

    precise_reverse(P, W, D, s_b, s_gate, gx != nullptr ? s_gx : nullptr,
                    partials + (size_t)tile * P.u_rows);
    __syncthreads();

    if (gx != nullptr && t < 3 * TILE) {
      const int c = t / TILE, r = t - c * TILE;
      if (r0 + r < n) gx[(size_t)(r0 + r) * 3 + c] = s_gx[c * TILE + r];
    }
    __syncthreads();
  }
}

// One pass of the fixed-order sum: out[c][row] = sum over tiles
// c*chunk .. (c+1)*chunk-1 of in[tile][row], in tile order. The last pass
// (one chunk) writes float to out_f instead.
__global__ void sum_tiles_kernel(const double* __restrict__ in, int tiles,
                                 int rows, int chunk, double* __restrict__ out_d,
                                 float* __restrict__ out_f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int chunks = (tiles + chunk - 1) / chunk;
  if (i >= (long long)chunks * rows) return;
  const int row = (int)(i % rows), c = (int)(i / rows);
  const int end = min(tiles, (c + 1) * chunk);
  double sum = 0.0;
  for (int q = c * chunk; q < end; ++q) sum += in[(size_t)q * rows + row];
  if (out_f != nullptr)
    out_f[row] = (float)sum;
  else
    out_d[(size_t)c * rows + row] = sum;
}

}  // namespace drt

// points, dirs [n][3] fp32; W the packed bf16 weights; bias the per-layer
// padded biases, concatenated; table in host memory (see make_precise);
// out [5][n] fp32: s, dd, g. Returns cudaGetLastError().
extern "C" int drt_precise_sdg(const float* pts, const float* dirs, int n,
                               const void* W, const float* bias,
                               const int* table, int n_layers, float* out,
                               void* stream) {
  using namespace drt;
  Precise P;
  cudaError_t err = make_precise(table, n_layers, &P);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = precise_smem_bytes(P);
  err = cudaFuncSetAttribute(precise_sdg_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = persistent_grid(precise_sdg_kernel, smem, (n + TILE - 1) / TILE);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  precise_sdg_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      pts, dirs, n, P, static_cast<const __nv_bfloat16*>(W), bias, out);
  return (int)cudaGetLastError();
}

// K4. points [n][3] and ct [n][seed_rows] fp32; W, bias, table as for
// drt_precise_sdg; gx [n][3] fp32 or null; partials [tiles][u_rows] and
// scratch [ceil(tiles / chunk)][u_rows] fp64 work buffers, tiles >=
// ceil(n / TILE) (u_rows: the summed out_p of the split layers);
// u [u_rows] fp32 out, layers in ascending order. Returns
// cudaGetLastError().
extern "C" int drt_precise_bias_grads(const float* pts, const float* ct, int n,
                                      int seed_rows, int scalar_chain,
                                      const void* W, const float* bias,
                                      const int* table, int n_layers, float* gx,
                                      double* partials, double* scratch,
                                      int tiles, int chunk, float* u,
                                      void* stream) {
  using namespace drt;
  Precise P;
  cudaError_t err = make_precise(table, n_layers, &P);
  if (err != cudaSuccess) return (int)err;
  const int need = (n + TILE - 1) / TILE;
  if (P.u_rows <= 0 || seed_rows < 1 || seed_rows > P.out_p[n_layers - 1] ||
      n < 0 || chunk < 2 || tiles < need || tiles < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) {
    err = cudaMemsetAsync(u, 0, (size_t)P.u_rows * sizeof(float), s);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  const size_t smem = precise_smem_bytes(P);
  err = cudaFuncSetAttribute(precise_bias_grads_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = persistent_grid(precise_bias_grads_kernel, smem, need);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  precise_bias_grads_kernel<<<grid, NTHREADS, smem, s>>>(
      pts, ct, n, seed_rows, scalar_chain, P, static_cast<const __nv_bfloat16*>(W),
      bias, gx, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the per-tile partials, summed in tile order, chunk by chunk
  const double* src = partials;
  double* dst = scratch;
  int count = need;
  for (;;) {
    const int chunks = (count + chunk - 1) / chunk;
    const long long threads = (long long)chunks * P.u_rows;
    const int blocks = (int)((threads + 255) / 256);
    if (chunks == 1) {
      sum_tiles_kernel<<<blocks, 256, 0, s>>>(src, count, P.u_rows, chunk, nullptr, u);
      break;
    }
    sum_tiles_kernel<<<blocks, 256, 0, s>>>(src, count, P.u_rows, chunk, dst, nullptr);
    count = chunks;
    src = dst;
    dst = dst == scratch ? partials : scratch;
  }
  return (int)cudaGetLastError();
}
