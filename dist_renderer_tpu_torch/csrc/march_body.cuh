// The march step on CUDA cores, shared by every march kernel: the
// decoder's layer table (Decoder, make_decoder), the march's parameters,
// the 12-float carry (Carry, fresh_carry, load_carry, store_carry) and one
// bracket-secant step of one ray (march_one). The decoder's evaluation of
// a step runs elsewhere: point_mlp.cuh's tensor-core body for the routed
// kernels (K1, K1-multi, K1-grid and K2, through march_mma.cuh), and the
// CUDA-core mlp_tile of march_in_order.cu for the in-order witness.
//
// Counterpart of the JAX package's ops/pallas/march_body.py (march_one,
// the carry of march_loop).
//
// Each ray's arithmetic is independent of its position in a tile and of
// the rays beside it: march_one reads the ray's own carry and its own
// sample's value, and the library is built with -fmad=false, so a step
// rounds where the plain version's rounds. What bounds a march is its
// decoder evaluations (march_mma.cuh, point_mlp.cuh); march_one is a few
// dozen flops a ray and step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drt {

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
