// The march step and the latent-folded MLP shared by the two march
// kernels: batched_march.cu (K1, the persistent march) and
// queue_march.cu (K2, the work-queue generations).
//
// Counterpart of the JAX package's ops/pallas/march_body.py (mlp_apply,
// march_loop). Both kernels march TILE rays per thread block; the block
// evaluates the MLP for the whole tile each step and one warp owns the
// tiles' march state (one ray per lane).
//
// Each ray's arithmetic is independent of its position in a tile and of
// the rays beside it: one thread accumulates a ray's output in a fixed k
// order with explicit fmaf, the bias comes from the ray's own frame, and
// the library is built with -fmad=false. So K1 and K2 give the same bits
// for a ray however the queue groups it.
//
// What bounds it on an H100: CUDA-core FMA throughput (about 1.6 M
// multiply-adds per full-decoder evaluation) and re-reading the bf16
// weights (3.6 MB for the 8x512 decoder, L2-resident: the card has 50 MB)
// once per tile step. A thread computes an 8-output x 8-ray micro-tile, so
// each 16-byte weight load feeds 64 FMAs and each 16-byte activation load
// (shared memory) feeds 64 more. Activations stay in shared memory
// (bf16, two [width][TILE] buffers). Tensor cores (mma/wgmma) are later
// work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drt {

constexpr int TILE = 32;        // rays per thread block
constexpr int NTHREADS = 256;   // threads per block
constexpr int RG = TILE / 8;    // 8-ray groups per tile
constexpr int MAX_LAYERS = 16;
constexpr float NEG_BIG = -3.0e38f;  // stand-ins for +-inf (the TPU kernels')
constexpr float POS_BIG = 3.0e38f;

struct Decoder {
  int n_layers, final_tanh, max_width;
  int out_p[MAX_LAYERS], in_p[MAX_LAYERS];
  int wh_off[MAX_LAYERS], wx_off[MAX_LAYERS], b_off[MAX_LAYERS];
};

struct MarchParams {
  float eps, deps, alpha, margin;
  int max_steps, salvage;
};

// The 12-float march carry (march_body.py Carry; rows of the queue state).
struct Carry {
  float d, act, hit, d_lo, f_lo, d_hi, f_hi, min_sdf, d_at_min, last_f,
      steps, unres;
};

// Host: the per-layer table (out_p, in_p, wh_off, wx_off, b_off) -> Decoder.
inline cudaError_t make_decoder(const int* table, int n_layers,
                                int final_tanh, Decoder* dec) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
  dec->n_layers = n_layers;
  dec->final_tanh = final_tanh;
  int width = 8;
  for (int l = 0; l < n_layers; ++l) {
    const int* t = table + 5 * l;
    dec->out_p[l] = t[0];
    dec->in_p[l] = t[1];
    dec->wh_off[l] = t[2];
    dec->wx_off[l] = t[3];
    dec->b_off[l] = t[4];
    if (t[0] <= 0 || t[0] % 8 || t[1] % 8 || (t[2] >= 0 && t[2] % 8) ||
        (t[3] >= 0 && t[3] % 8) || (t[2] < 0 && t[3] < 0))
      return cudaErrorInvalidValue;
    if (t[2] >= 0 && (l == 0 || t[1] != dec->out_p[l - 1]))
      return cudaErrorInvalidValue;
    if (t[0] > width) width = t[0];
  }
  dec->max_width = width;
  return cudaSuccess;
}

inline size_t march_smem_bytes(const Decoder& dec) {
  return 2 * (size_t)dec.max_width * TILE * sizeof(__nv_bfloat16);
}

// Blocks to launch for a persistent kernel: what fits on the card, at most
// `tiles` (0 = no limit). Returns 0 when the kernel cannot be resident.
template <typename K>
inline int persistent_grid(K kernel, size_t smem, long long tiles) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, NTHREADS, smem);
  long long grid = (long long)occ * sms;
  if (tiles > 0 && tiles < grid) grid = tiles;
  return (int)grid;
}

__device__ __forceinline__ void unpack8(const uint4 v, float* f) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One MLP evaluation for the tile: positions s_x [3][TILE] (bf16-rounded
// fp32) -> s_sdf [TILE]. s_h holds two [max_width][TILE] bf16 buffers.
// Every thread of the block must call it; it ends with a barrier.
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
    // the last layer only needs output row 0 (the SDF)
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

// One bracket-secant step of one ray (march_body.py march_one).
__device__ __forceinline__ void march_one(Carry& c, float f, float near_lo,
                                          float far, const MarchParams& mp) {
  const bool act = c.act > 0.5f;
  if (act && f < c.min_sdf) {
    c.min_sdf = f;
    c.d_at_min = c.d;
  }
  const bool outside = f > 0.0f;
  if (act && outside) {
    c.d_lo = c.d;
    c.f_lo = f;
  }
  if (act && !outside) {
    c.d_hi = c.d;
    c.f_hi = f;
  }
  const bool bracketed = c.d_lo > NEG_BIG / 2 && c.d_hi < POS_BIG / 2;
  const float width = c.d_hi - c.d_lo;
  bool converged = act && (fabsf(f) < mp.eps || (bracketed && width < mp.deps));

  const float d_aggr = c.d + mp.alpha * f;
  const float denom = c.f_hi - c.f_lo;
  float secant = (c.d_lo * c.f_hi - c.d_hi * c.f_lo) / (denom == 0.0f ? 1.0f : denom);
  secant = fminf(fmaxf(secant, c.d_lo + 0.05f * width), c.d_hi - 0.05f * width);
  const float d_back = c.d + f;
  const float d_next = bracketed ? secant : (outside ? d_aggr : d_back);

  c.steps = c.steps + (act ? 1.0f : 0.0f);
  const bool exhausted = c.steps >= (float)mp.max_steps;
  const bool escaped = !bracketed && (d_next > far || d_next < near_lo);
  bool missed = act && !converged && (escaped || exhausted);
  // final march: accept the bracket midpoint on exhaustion
  const bool salvaged = mp.salvage && act && !converged && exhausted && bracketed;
  missed = missed && !salvaged;
  converged = converged || salvaged;

  const bool still = act && !converged && !missed;
  c.d = still ? d_next : (salvaged ? 0.5f * (c.d_lo + c.d_hi) : c.d);
  if (act) c.last_f = f;
  c.hit = fmaxf(c.hit, converged ? 1.0f : 0.0f);
  const bool open_exh = act && !converged && exhausted && (!mp.salvage || !bracketed);
  c.unres = fmaxf(c.unres, open_exh ? 1.0f : 0.0f);
  c.act = still ? 1.0f : 0.0f;
}

// March the tile for at most kmax iterations, or until none of its rays
// is active. Threads < TILE own one ray each (carry c, geometry o/v,
// near - margin, far); the others pass an inactive carry. Every thread
// of the block must call it.
static __device__ void march_tile(const Decoder& dec, const __nv_bfloat16* __restrict__ W,
                           const float* __restrict__ bank, int bank_stride,
                           const MarchParams& mp, int kmax, Carry& c,
                           const float* o, const float* v, float near_lo,
                           float far, const int* s_frame, float* s_x,
                           __nv_bfloat16* s_h, float* s_sdf) {
  const int t = threadIdx.x;
  for (int k = 0; k < kmax; ++k) {
    if (!__syncthreads_or(t < TILE && c.act > 0.5f)) break;
    if (t < TILE) {
#pragma unroll
      for (int a = 0; a < 3; ++a) s_x[a * TILE + t] = round_bf16(o[a] + c.d * v[a]);
    }
    __syncthreads();
    mlp_tile(dec, W, bank, bank_stride, s_frame, s_x, s_h, s_sdf);
    if (t < TILE) march_one(c, s_sdf[t], near_lo, far, mp);
  }
}

__device__ __forceinline__ Carry fresh_carry(float d0, float act0) {
  Carry c;
  c.d = d0;
  c.act = act0;
  c.hit = 0.0f;
  c.d_lo = NEG_BIG;
  c.f_lo = POS_BIG;
  c.d_hi = POS_BIG;
  c.f_hi = NEG_BIG;
  c.min_sdf = POS_BIG;
  c.d_at_min = d0;
  c.last_f = POS_BIG;
  c.steps = 0.0f;
  c.unres = 0.0f;
  return c;
}

// The carry as the 12 rows of a [12][n] fp32 array, in Carry's order.
__device__ __forceinline__ void store_carry(const Carry& c, float* s, int n, int i) {
  s[0 * (size_t)n + i] = c.d;
  s[1 * (size_t)n + i] = c.act;
  s[2 * (size_t)n + i] = c.hit;
  s[3 * (size_t)n + i] = c.d_lo;
  s[4 * (size_t)n + i] = c.f_lo;
  s[5 * (size_t)n + i] = c.d_hi;
  s[6 * (size_t)n + i] = c.f_hi;
  s[7 * (size_t)n + i] = c.min_sdf;
  s[8 * (size_t)n + i] = c.d_at_min;
  s[9 * (size_t)n + i] = c.last_f;
  s[10 * (size_t)n + i] = c.steps;
  s[11 * (size_t)n + i] = c.unres;
}

__device__ __forceinline__ Carry load_carry(const float* s, int n, int i) {
  Carry c;
  c.d = s[0 * (size_t)n + i];
  c.act = s[1 * (size_t)n + i];
  c.hit = s[2 * (size_t)n + i];
  c.d_lo = s[3 * (size_t)n + i];
  c.f_lo = s[4 * (size_t)n + i];
  c.d_hi = s[5 * (size_t)n + i];
  c.f_hi = s[6 * (size_t)n + i];
  c.min_sdf = s[7 * (size_t)n + i];
  c.d_at_min = s[8 * (size_t)n + i];
  c.last_f = s[9 * (size_t)n + i];
  c.steps = s[10 * (size_t)n + i];
  c.unres = s[11 * (size_t)n + i];
  return c;
}

}  // namespace drt
