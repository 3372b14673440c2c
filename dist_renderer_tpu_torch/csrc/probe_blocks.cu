// The work-queue building blocks and the small products the TPU probe
// scripts timed: counterparts of scripts/diag_launch4.py's k_mm (:74),
// k_mm_in_while (:80) and k_compact (:123), scripts/diag_launch3.py's
// k_tri (:182) and k_compact (:204), and scripts/diag_launch2.py's
// f32dot_kernel (:142), roll_kernel (:171) and cumsum_kernel (:189).
//
// small_mm: [M, K] fp32 rounded to bf16 times [K, N] bf16 with fp32
//   accumulation on mma.sync m16n8k16, rows padded to 16 with zeros; a
//   warp per 8 output columns. With LOOP, the product sits in a while
//   loop of `trips` trips (k_mm_in_while: one trip). Bound: at M = 8 the
//   512 KB of weights (0.16 us at 3.35 TB/s); the launch dominates.
// compact: out[:, pos[j]] = d[:, j] for every survivor j (surv > 0.5)
//   whose position is a slot in [0, slots): an integral value for the
//   fp32-position kernel (k_compact of diag_launch3, whose float iota
//   matches only integral positions), the position truncated toward zero
//   for the int kernel (diag_launch4's astype(int32)); zeros elsewhere.
//   The TPU kernels built a one-hot matrix and ran three bf16 products on
//   a bf16x3 split of d because the TPU's MXU has no exact fp32 path;
//   here the result is written directly. Positions of survivors are
//   distinct (a compaction), as the one-hot product's exactness assumed.
// f32dot: x [R, K] times m [S, K] transposed in fp32 on CUDA cores, every
//   sum over k in order; a block per 32 output columns, operands staged
//   in shared memory (R <= 32).
// roll: out[:, j] = x[:, (j - shift) mod L] (pltpu.roll's and jnp.roll's
//   direction), shift in [0, L).
// scan: the inclusive prefix sum of each row by log-shift steps
//   (c += c shifted by 1, 2, 4, ... with zeros shifted in: the TPU
//   kernel's adds in the TPU kernel's order, so fp32 rows give its bits);
//   fp32 or bf16 in, fp32 out (k_tri's triangular product on 0/1 rows).
//   A block per row, L <= 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace drt {
namespace pb {

using drt::ms::mma_bf16_16816;
using drt::ms::pack_bf16;

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

constexpr int MM_WARPS = 4;

// A warp's 16-row tile of x at rows m0.., k0..k0+15, rounded to bf16.
__device__ __forceinline__ void load_a(const float* x, int m, int k, int m0, int k0,
                                       int g, int t, uint32_t (&a)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = m0 + g + 8 * (q & 1);
    const int col = k0 + 2 * t + 8 * (q >> 1);
    float v0 = 0.f, v1 = 0.f;
    if (row < m) {
      v0 = x[(size_t)row * k + col];
      v1 = x[(size_t)row * k + col + 1];
    }
    a[q] = pack_bf16(bf16_bits(v0), bf16_bits(v1));
  }
}

template <bool LOOP>
__global__ void small_mm_kernel(const float* x, const uint16_t* w, float* out, int m,
                                int k, int n, int trips) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x * MM_WARPS + (threadIdx.x >> 5)) * 8;
  if (n0 >= n) return;
  for (int m0 = 0; m0 < m; m0 += 16) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int n_trips = LOOP ? trips : 1;
    for (int trip = 0; trip < n_trips; ++trip) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < k; k0 += 16) {
        uint32_t a[4], b[2];
        load_a(x, m, k, m0, k0, g, t, a);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kk = k0 + 2 * t + 8 * q;
          b[q] = pack_bf16(w[(size_t)kk * n + n0 + g], w[(size_t)(kk + 1) * n + n0 + g]);
        }
        mma_bf16_16816(d, a, b);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = d[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = m0 + g + 8 * (q >> 1), col = n0 + 2 * t + (q & 1);
      if (row < m) out[(size_t)row * n + col] = acc[q];
    }
  }
}

__global__ void compact_kernel(const float* d, const float* pos, const float* surv,
                               float* out, int rows, int lanes, int slots, int int_pos) {
  for (int i = threadIdx.x; i < rows * slots; i += blockDim.x) out[i] = 0.f;
  __syncthreads();
  for (int j = threadIdx.x; j < lanes; j += blockDim.x) {
    if (!(surv[j] > 0.5f)) continue;
    const float p = pos[j];
    int slot;
    if (int_pos) {
      if (!(p > -2147483648.f && p < 2147483648.f)) continue;
      slot = (int)p;  // truncation toward zero, as astype(int32)
    } else {
      if (!(p == floorf(p)) || !(p >= 0.f && p < (float)slots)) continue;
      slot = (int)p;
    }
    if (slot < 0 || slot >= slots) continue;
    for (int r = 0; r < rows; ++r) out[(size_t)r * slots + slot] = d[(size_t)r * lanes + j];
  }
}

constexpr int DOT_COLS = 32, DOT_K = 32, DOT_THREADS = 256, DOT_ROWS = 32;
constexpr int DOT_PER = DOT_ROWS * DOT_COLS / DOT_THREADS;

__global__ void f32dot_kernel(const float* x, const float* mat, float* out, int rows, int k,
                              int s) {
  __shared__ float xs[DOT_ROWS][DOT_K];
  __shared__ float ms[DOT_COLS][DOT_K + 1];
  const int c0 = blockIdx.x * DOT_COLS;
  float acc[DOT_PER];
#pragma unroll
  for (int i = 0; i < DOT_PER; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < k; k0 += DOT_K) {
    for (int i = threadIdx.x; i < DOT_ROWS * DOT_K; i += DOT_THREADS) {
      const int r = i / DOT_K, kk = i % DOT_K;
      xs[r][kk] = (r < rows && k0 + kk < k) ? x[(size_t)r * k + k0 + kk] : 0.f;
    }
    for (int i = threadIdx.x; i < DOT_COLS * DOT_K; i += DOT_THREADS) {
      const int c = i / DOT_K, kk = i % DOT_K;
      ms[c][kk] = (c0 + c < s && k0 + kk < k) ? mat[(size_t)(c0 + c) * k + k0 + kk] : 0.f;
    }
    __syncthreads();
    const int kn = min(DOT_K, k - k0);
#pragma unroll
    for (int i = 0; i < DOT_PER; ++i) {
      const int o = threadIdx.x + i * DOT_THREADS, r = o / DOT_COLS, c = o % DOT_COLS;
      float a = acc[i];
      for (int kk = 0; kk < kn; ++kk) a = a + xs[r][kk] * ms[c][kk];
      acc[i] = a;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < DOT_PER; ++i) {
    const int o = threadIdx.x + i * DOT_THREADS, r = o / DOT_COLS, c = o % DOT_COLS;
    if (r < rows && c0 + c < s) out[(size_t)r * s + c0 + c] = acc[i];
  }
}

__global__ void roll_kernel(const float* x, float* out, int rows, int lanes, int shift) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * lanes) return;
  const int r = i / lanes, j = i % lanes;
  int src = j - shift;
  if (src < 0) src += lanes;
  out[i] = x[(size_t)r * lanes + src];
}

__global__ void scan_kernel(const void* x, float* out, int lanes, int bf16) {
  __shared__ float c[1024];
  const int j = threadIdx.x, r = blockIdx.x;
  if (j < lanes) {
    const size_t at = (size_t)r * lanes + j;
    c[j] = bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[at])
                : static_cast<const float*>(x)[at];
  }
  __syncthreads();
  for (int sh = 1; sh < lanes; sh *= 2) {
    float v = 0.f, add = 0.f;
    if (j < lanes) {
      v = c[j];
      add = j >= sh ? c[j - sh] : 0.f;
    }
    __syncthreads();
    if (j < lanes) c[j] = v + add;
    __syncthreads();
  }
  if (j < lanes) out[(size_t)r * lanes + j] = c[j];
}

}  // namespace pb
}  // namespace drt

using namespace drt::pb;

// Every entry launches on the caller's stream and returns
// cudaGetLastError().

// x [m][k] fp32, w [k][n] bf16, out [m][n] fp32; k % 16 == 0, n % 8 == 0.
// looped: k_mm_in_while's form, the product inside a `trips`-trip loop.
extern "C" int drt_probe_small_mm(const float* x, const void* w, float* out, int m, int k,
                                  int n, int looped, int trips, void* stream) {
  if (m <= 0 || k % 16 != 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n / 8 + MM_WARPS - 1) / MM_WARPS;
  const uint16_t* wb = static_cast<const uint16_t*>(w);
  if (looped)
    small_mm_kernel<true><<<blocks, 32 * MM_WARPS, 0, (cudaStream_t)stream>>>(
        x, wb, out, m, k, n, trips);
  else
    small_mm_kernel<false><<<blocks, 32 * MM_WARPS, 0, (cudaStream_t)stream>>>(
        x, wb, out, m, k, n, 1);
  return (int)cudaGetLastError();
}

// d [rows][lanes], pos [lanes], surv [lanes] fp32 -> out [rows][slots].
extern "C" int drt_probe_compact(const float* d, const float* pos, const float* surv,
                                 float* out, int rows, int lanes, int slots, int int_pos,
                                 void* stream) {
  compact_kernel<<<1, 512, 0, (cudaStream_t)stream>>>(d, pos, surv, out, rows, lanes,
                                                      slots, int_pos);
  return (int)cudaGetLastError();
}

// x [rows][k], mat [s][k] fp32 -> out [rows][s]; rows <= 32.
extern "C" int drt_probe_f32dot(const float* x, const float* mat, float* out, int rows,
                                int k, int s, void* stream) {
  if (rows <= 0 || rows > DOT_ROWS) return (int)cudaErrorInvalidValue;
  f32dot_kernel<<<(s + DOT_COLS - 1) / DOT_COLS, DOT_THREADS, 0, (cudaStream_t)stream>>>(
      x, mat, out, rows, k, s);
  return (int)cudaGetLastError();
}

// x, out [rows][lanes] fp32; 0 <= shift < lanes.
extern "C" int drt_probe_roll(const float* x, float* out, int rows, int lanes, int shift,
                              void* stream) {
  if (shift < 0 || shift >= lanes) return (int)cudaErrorInvalidValue;
  const int n = rows * lanes;
  roll_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, out, rows, lanes, shift);
  return (int)cudaGetLastError();
}

// x [rows][lanes] fp32 (bf16 = 0) or bf16 (bf16 = 1) -> out [rows][lanes]
// fp32; lanes <= 1024.
extern "C" int drt_probe_scan(const void* x, float* out, int rows, int lanes, int bf16,
                              void* stream) {
  if (lanes <= 0 || lanes > 1024) return (int)cudaErrorInvalidValue;
  const int threads = (lanes + 31) / 32 * 32;
  scan_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(x, out, lanes, bf16);
  return (int)cudaGetLastError();
}
