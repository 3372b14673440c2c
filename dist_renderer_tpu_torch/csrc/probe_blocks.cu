// The work-queue building blocks and the small products the TPU probe
// scripts timed: counterparts of scripts/diag_launch4.py's k_mm (:74),
// k_mm_in_while (:80) and k_compact (:123), scripts/diag_launch3.py's
// k_tri (:182) and k_compact (:204), and scripts/diag_launch2.py's
// f32dot_kernel (:142), roll_kernel (:171) and cumsum_kernel (:189).
//
// small_mm: [M, K] fp32 rounded to bf16 times [K, N] bf16 with fp32 sums
//   on mma.sync m16n8k16, inside a loop of `trips` trips (k_mm: one trip;
//   k_mm_in_while: its while loop, zeros after no trip). Bound: the bytes,
//   at M = 8, K = N = 512 the 512 KB of w (0.166 us at 3.35 TB/s); the
//   first version (a warp per 8 columns, 16 blocks, 32 serial
//   global-memory round trips a warp, rows padded from 8 to 16) took 14-20
//   us in a CUDA graph. Design: A and B swapped, out^T = w^T x^T, so the
//   MMA's 16 rows come from N and x's rows fill its 8-wide side (M padded
//   to 8, not 16). A block owns 16 columns of N; w's [K, 16] slice goes to
//   shared memory by 16-byte cp.async, all in flight together (the two
//   8-column halves of a row swapped every 4 rows, so that ldmatrix.trans
//   reads conflict-free A fragments); x is rounded to bf16 once, into
//   shared memory beside it (rows padded by 16 bytes: conflict-free
//   ldmatrix B fragments). The 8 warps split K (4 k-steps each of a
//   512-deep chunk) and their partials are summed in shared memory in
//   warp order: no atomics, the same bits every launch and trip count.
//   The fragments are loaded before the trip loop, which repeats only the
//   MMAs, each trip the whole product. mma.sync and not wgmma: wgmma's
//   64-row tile would be 3/4 padding at 16 columns a block, and 64
//   columns a block would leave 8 blocks for 132 SMs.
// compact: out[:, pos[j]] = d[:, j] for every survivor j (surv > 0.5)
//   whose position is a slot in [0, slots): an integral value for the
//   fp32-position kernel (k_compact of diag_launch3, whose float iota
//   matches only integral positions), the position truncated toward zero
//   for the int kernel (diag_launch4's astype(int32)); zeros elsewhere.
//   The TPU kernels built a one-hot matrix and ran three bf16 products on
//   a bf16x3 split of d because the TPU's MXU has no exact fp32 path;
//   here the result is written directly. Positions of survivors are
//   distinct (a compaction), as the one-hot product's exactness assumed.
// f32dot: x [R, K] times m [S, K] transposed in fp32 on CUDA cores (R <=
//   32), every output's sum an fmaf chain over k in order. Bound: the
//   bytes, at R = 24, K = 512, S = 1024 the 2.2 MB of x, m and out (0.67
//   us); the first version (a block per 32 columns: 32 blocks on 132 SMs,
//   each thread 4 outputs one after the other, a dependent mul and add a
//   step) took 39 us in a CUDA graph. Design: a block per 8 columns (128
//   blocks at S = 1024); its x and m slices (R + 8 rows of 512 k) go to
//   shared memory by 16-byte cp.async (4-byte ones when K % 4 != 0 or a
//   pointer is not 16-byte aligned) in four groups of 128 k, all in
//   flight together, the sums starting on a group once it lands. Thread
//   t owns row t / 4 and two adjacent columns: two interleaved chains fed
//   by 16-byte shared loads (rows padded by 16 bytes: conflict-free), the
//   next 16 k's loads issued before this 16 k's fmaf. What holds it on
//   the card (diag/f32dot_designs.cu): the shared-to-register traffic (a
//   16-byte load costs a warp 4 cycles: 6 bytes an fmaf), the 64 KB each
//   block stages (its groups land together), and the launch of 128
//   blocks with 66 KB of shared memory; a chain of 512 fmaf (~1 us) is not
//   the limit, so K is not split.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from global to shared memory, asynchronously; the bytes
// past src_bytes are zero-filled (src is not read when src_bytes is 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0-3) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Four 8x8 b16 matrices; lane l gives row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

constexpr int MM_N = 16;                       // columns of N a block owns
constexpr int MM_WARPS = 8;                    // they split K
constexpr int MM_THREADS = 32 * MM_WARPS;
constexpr int MM_KC = 512;                     // k of a staged chunk
constexpr int MM_STEPS = MM_KC / 16 / MM_WARPS;  // a warp's k-steps of a chunk
constexpr int MM_MC = 32;                      // rows of x a chunk stages
constexpr int MM_MT = MM_MC / 8;               // their 8-row tiles
constexpr int MM_XSTRIDE = MM_KC + 8;          // bf16 a staged row of x takes
constexpr int MM_SMEM = MM_KC * MM_N * 2 + MM_MC * MM_XSTRIDE * 2 +
                        MM_WARPS * MM_MT * MM_N * 8 * 4;

// The bf16 offset of w's row kk, half h (columns 8h..8h+7) in the staged
// slice: the halves trade places every 4 rows.
__device__ __forceinline__ int ws_at(int kk, int h) {
  return kk * MM_N + 8 * (h ^ ((kk >> 2) & 1));
}

__global__ void __launch_bounds__(MM_THREADS)
    small_mm_kernel(const float* x, const uint16_t* w, float* out, int m, int k, int n,
                    int trips) {
  extern __shared__ __align__(16) unsigned char mm_smem[];
  uint16_t* ws = reinterpret_cast<uint16_t*>(mm_smem);          // [MM_KC][16]
  uint16_t* xs = ws + MM_KC * MM_N;                             // [MM_MC][MM_XSTRIDE]
  float* red = reinterpret_cast<float*>(xs + MM_MC * MM_XSTRIDE);  // [warp][tile][16][8]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lq = lane >> 3, lr = lane & 7;
  const int n0 = blockIdx.x * MM_N;
  const int chunks = (k + MM_KC - 1) / MM_KC;
  for (int m0 = 0; m0 < m; m0 += MM_MC) {
    const int mc = min(MM_MC, m - m0), tiles = (mc + 7) / 8;
    float acc[MM_MT][4];
#pragma unroll
    for (int i = 0; i < MM_MT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int k0 = c * MM_KC, kn = min(MM_KC, k - k0), kq = kn / 4;
      if (m0 == 0 || chunks > 1) {  // one chunk stays staged for every m0
        for (int i = tid; i < 2 * kn; i += MM_THREADS) {
          const int kk = i >> 1, h = i & 1;
          const bool ok = n0 + 8 * h < n;
          const uint16_t* src = ok ? w + (size_t)(k0 + kk) * n + n0 + 8 * h : w;
          cp_async16(ws + ws_at(kk, h), src, ok ? 16 : 0);
        }
        cp_async_commit();
      }
      // x's rows rounded to bf16 while w's copies fly; rows up to a whole
      // tile are zeros
      for (int i = tid; i < tiles * 8 * kq; i += MM_THREADS) {
        const int row = i / kq, j = i - row * kq;
        uint2 v = make_uint2(0u, 0u);
        if (row < mc) {
          const float4 f =
              __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + row) * k + k0) + j);
          v = make_uint2(pack_bf16(bf16_bits(f.x), bf16_bits(f.y)),
                         pack_bf16(bf16_bits(f.z), bf16_bits(f.w)));
        }
        *reinterpret_cast<uint2*>(xs + row * MM_XSTRIDE + 4 * j) = v;
      }
      cp_async_wait(0);
      __syncthreads();
      const int s0 = warp * MM_STEPS, ns = max(0, min(MM_STEPS, kn / 16 - s0));
      uint32_t a[MM_STEPS][4], b[MM_STEPS][MM_MT][2];
#pragma unroll
      for (int s = 0; s < MM_STEPS; ++s) {
        if (s >= ns) continue;
        const int kb = (s0 + s) * 16;
        const int kk = kb + lr + 8 * (lq >> 1);
        ldmatrix_x4_trans(a[s], ws + ws_at(kk, lq & 1));
#pragma unroll
        for (int p = 0; p < MM_MT / 2; ++p) {
          if (2 * p >= tiles) continue;
          uint32_t r[4];
          ldmatrix_x4(r, xs + ((2 * p + (lq >> 1)) * 8 + lr) * MM_XSTRIDE + kb + 8 * (lq & 1));
          b[s][2 * p][0] = r[0];
          b[s][2 * p][1] = r[1];
          b[s][2 * p + 1][0] = r[2];
          b[s][2 * p + 1][1] = r[3];
        }
      }
      // each trip: the chunk's product on top of the earlier chunks' sums
      float d[MM_MT][4];
#pragma unroll
      for (int i = 0; i < MM_MT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[i][q] = acc[i][q];
      for (int trip = 0; trip < trips; ++trip) {
#pragma unroll
        for (int i = 0; i < MM_MT; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[i][q] = acc[i][q];
#pragma unroll
        for (int s = 0; s < MM_STEPS; ++s) {
          if (s >= ns) continue;
#pragma unroll
          for (int i = 0; i < MM_MT; ++i)
            if (i < tiles) mma_bf16_16816(d[i], a[s], b[s][i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MM_MT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = d[i][q];
      __syncthreads();  // every warp is done with the chunk before the next
    }
    // The warps' partials, out^T rows g and g+8, columns 2t and 2t+1,
    // summed in warp order.
#pragma unroll
    for (int i = 0; i < MM_MT; ++i) {
      float* p = red + ((warp * MM_MT + i) * MM_N + g) * 8 + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(p + 64) = make_float2(acc[i][2], acc[i][3]);
    }
    __syncthreads();
    for (int i = tid; i < mc * MM_N; i += MM_THREADS) {
      const int row = i / MM_N, col = i - row * MM_N;
      if (n0 + col >= n) continue;
      const float* p = red + ((row >> 3) * MM_N + col) * 8 + (row & 7);
      float v = p[0];
#pragma unroll
      for (int wp = 1; wp < MM_WARPS; ++wp) v = v + p[wp * MM_MT * MM_N * 8];
      out[(size_t)(m0 + row) * n + n0 + col] = v;
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

constexpr int DOT_COLS = 8;       // output columns a block owns
constexpr int DOT_ROWS = 32;      // the most rows of x
constexpr int DOT_THREADS = 128;  // thread t: row t / 4, columns 2 (t % 4), +1
constexpr int DOT_KC = 512;       // k of a staged chunk
constexpr int DOT_SUB = 128;      // k of one cp.async group

// Floats a staged row takes: k rounded up to 32 (at most DOT_KC) plus 4,
// so that the 8 rows a warp reads lie 16 bytes apart in the banks (and
// every 16 k the chains read lie inside the row).
inline int dot_stride(int k) { return (k < DOT_KC ? (k + 31) / 32 * 32 : DOT_KC) + 4; }

// Thread t's two chains over [lo, hi) of the staged rows (a multiple of
// 16), in k order: each next 16 k's operands loaded before this 16 k's
// fmaf, so the shared-memory loads overlap the chains.
__device__ __forceinline__ void dot_chains(const float* xr, const float* m0r,
                                           const float* m1r, int lo, int hi, float& a0,
                                           float& a1) {
  float4 cx[4], cu[4], cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cx[j] = *reinterpret_cast<const float4*>(xr + lo + 4 * j);
    cu[j] = *reinterpret_cast<const float4*>(m0r + lo + 4 * j);
    cv[j] = *reinterpret_cast<const float4*>(m1r + lo + 4 * j);
  }
  for (int kk = lo; kk < hi; kk += 16) {
    const int nk = kk + 16 < hi ? kk + 16 : kk;
    float4 nx[4], nu[4], nv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nx[j] = *reinterpret_cast<const float4*>(xr + nk + 4 * j);
      nu[j] = *reinterpret_cast<const float4*>(m0r + nk + 4 * j);
      nv[j] = *reinterpret_cast<const float4*>(m1r + nk + 4 * j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a0 = fmaf(cx[j].x, cu[j].x, a0);
      a1 = fmaf(cx[j].x, cv[j].x, a1);
      a0 = fmaf(cx[j].y, cu[j].y, a0);
      a1 = fmaf(cx[j].y, cv[j].y, a1);
      a0 = fmaf(cx[j].z, cu[j].z, a0);
      a1 = fmaf(cx[j].z, cv[j].z, a1);
      a0 = fmaf(cx[j].w, cu[j].w, a0);
      a1 = fmaf(cx[j].w, cv[j].w, a1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cx[j] = nx[j];
      cu[j] = nu[j];
      cv[j] = nv[j];
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(DOT_THREADS)
    f32dot_kernel(const float* x, const float* mat, float* out, int rows, int k, int s,
                  int stride) {
  extern __shared__ __align__(16) float dot_smem[];
  float* xs = dot_smem;                 // [rows][stride]
  float* ms = dot_smem + rows * stride;  // [DOT_COLS][stride]
  const int tid = threadIdx.x, r = tid >> 2, c = 2 * (tid & 3);
  const int warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * DOT_COLS;
  const int n_rows = rows + DOT_COLS;
  float a0 = 0.f, a1 = 0.f;
  for (int k0 = 0; k0 < k; k0 += DOT_KC) {
    const int kn = min(DOT_KC, k - k0), kq = (kn + 15) & ~15;
    const int groups = (kq + DOT_SUB - 1) / DOT_SUB;
    // every group's copies in flight together, a warp per staged row and
    // a lane per 4 k; past kn (to a whole 16 k) and past the last column,
    // zeros, which leave the chains' bits as they are (a + 0 * 0 == a)
    for (int gi = 0; gi < groups; ++gi) {
      const int kk = gi * DOT_SUB + 4 * lane;
      if (kk < kq) {
        const int avail = max(0, min(4, kn - kk));
        for (int row = warp; row < n_rows; row += DOT_THREADS / 32) {
          const bool is_x = row < rows;
          const int col = c0 + row - rows;
          const int got = is_x || col < s ? avail : 0;
          const float* src =
              (is_x ? x + (size_t)row * k : mat + (size_t)(got ? col : 0) * k) + k0 + kk;
          float* dst = (is_x ? xs + row * stride : ms + (row - rows) * stride) + kk;
          if (VEC) {
            cp_async16(dst, got ? src : mat, 4 * got);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cp_async4(dst + e, e < got ? src + e : mat, e < got ? 4 : 0);
          }
        }
      }
      cp_async_commit();
    }
    for (int gi = 0; gi < groups; ++gi) {
      cp_async_wait(groups - 1 - gi);
      __syncthreads();
      if (r < rows)
        dot_chains(xs + r * stride, ms + c * stride, ms + (c + 1) * stride, gi * DOT_SUB,
                   min(kq, (gi + 1) * DOT_SUB), a0, a1);
    }
    __syncthreads();  // every thread is done with the chunk before the next
  }
  if (r < rows) {
    if (c0 + c < s) out[(size_t)r * s + c0 + c] = a0;
    if (c0 + c + 1 < s) out[(size_t)r * s + c0 + c + 1] = a1;
  }
}

template <typename K>
inline cudaError_t opt_in(K kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

// opt_in once per device (bit d of `raised`): the attribute call costs the
// host microseconds, which an eager launch would pay every time.
template <typename K>
inline cudaError_t opt_in_once(K kernel, int smem_bytes, unsigned& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || raised >> (dev & 31) & 1u) return err;
  err = opt_in(kernel, smem_bytes);
  if (err == cudaSuccess) raised |= 1u << (dev & 31);
  return err;
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

// x [m][k] fp32, w [k][n] bf16, out [m][n] fp32; k % 16 == 0, n % 8 == 0,
// x and w 16-byte aligned. looped: k_mm_in_while's form, the product
// inside a `trips`-trip loop.
extern "C" int drt_probe_small_mm(const float* x, const void* w, float* out, int m, int k,
                                  int n, int looped, int trips, void* stream) {
  if (m <= 0 || k % 16 != 0 || n % 8 != 0 || (uintptr_t)x % 16 || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (n + MM_N - 1) / MM_N;
  static unsigned raised = 0;
  const cudaError_t err = opt_in_once(small_mm_kernel, MM_SMEM, raised);
  if (err != cudaSuccess) return (int)err;
  small_mm_kernel<<<blocks, MM_THREADS, MM_SMEM, (cudaStream_t)stream>>>(
      x, static_cast<const uint16_t*>(w), out, m, k, n, looped ? trips : 1);
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

// x [rows][k], mat [s][k] fp32 -> out [rows][s]; rows <= 32. The
// 16-byte copies when k % 4 == 0 and x and mat are 16-byte aligned.
extern "C" int drt_probe_f32dot(const float* x, const float* mat, float* out, int rows,
                                int k, int s, void* stream) {
  if (rows <= 0 || rows > DOT_ROWS || k < 0 || s < 0) return (int)cudaErrorInvalidValue;
  if (s == 0) return (int)cudaSuccess;
  const int stride = dot_stride(k), bytes = (rows + DOT_COLS) * stride * 4;
  const bool vec = k % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)mat % 16 == 0;
  auto kernel = vec ? f32dot_kernel<true> : f32dot_kernel<false>;
  static unsigned raised[2] = {0, 0};  // to the most any rows and k need
  const cudaError_t err =
      opt_in_once(kernel, (DOT_ROWS + DOT_COLS) * (DOT_KC + 4) * 4, raised[vec]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(s + DOT_COLS - 1) / DOT_COLS, DOT_THREADS, bytes, (cudaStream_t)stream>>>(
      x, mat, out, rows, k, s, stride);
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
