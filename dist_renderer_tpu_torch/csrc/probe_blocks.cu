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
//   Bound: the bytes, at [24, 512] -> [24, 1024] the 148 KB of d, pos,
//   surv and out (0.045 us); the first version (one block of 512: every
//   output zeroed by 4-byte stores, a barrier, each survivor's 24 rows by
//   4-byte stores 4 KB apart: a survivor's word written twice, all of it
//   through one SM) took 6.5 us in a CUDA graph. Design: a block per row
//   and 1,024 slots (24 blocks); a thread loads its two lanes' position,
//   flag and value together (float2 loads where it can), survivor or not,
//   before it zeroes its float4 of the tile in shared memory; after a
//   barrier the survivors land in the tile, and after another each
//   thread writes its float4 of the row once. What holds it on the card
//   (diag/block_designs.cu): a load's round trip and the stores' drain
//   behind a launch; more rows or fewer slots a block, a flat grid cut by
//   a division, or an inverse map and gather (a second round trip) were
//   each slower.
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
//   fp32 or bf16 in, fp32 out (k_tri's triangular product on 0/1 rows),
//   L <= 1024. Bound: the bytes, 4 KB at [1, 512] fp32 (0.0012 us); the
//   first version (a block per row, two barriers a step: 18 at L = 512)
//   took 1.9 us in a CUDA graph. Design: a warp per row and no barrier,
//   lane l holding c[l + 32 i]: each warp load and store is 32
//   neighbouring values, the 5 steps with sh < 32 one shuffle a value, the
//   others adds within the lane. Lanes holding contiguous values (float4
//   loads, but every step a shuffle) or strided float4s (7 shuffle steps)
//   were no faster (diag/block_designs.cu).

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

// The slot lane j's entry names, or -1 when it names none: not a
// survivor, a position that is not finite (or not integral, for fp32
// positions), or a slot outside [0, slots).
__device__ __forceinline__ int compact_slot(float p, float s, int slots, int int_pos) {
  if (!(s > 0.5f)) return -1;
  int slot;
  if (int_pos) {
    if (!(p > -2147483648.f && p < 2147483648.f)) return -1;
    slot = (int)p;  // truncation toward zero, as astype(int32)
  } else {
    if (!(p == floorf(p)) || !(p >= 0.f && p < (float)slots)) return -1;
    slot = (int)p;
  }
  return slot >= 0 && slot < slots ? slot : -1;
}

constexpr int CP_THREADS = 256;           // a block's threads
constexpr int CP_SLOTS = 4 * CP_THREADS;  // a block's slots of its row: a float4 a thread
constexpr int CP_ROUND = 2 * CP_THREADS;  // lanes a round: two a thread
constexpr int CP_ROWS = 65535;            // rows a grid (gridDim.y)

// A round's loads from lane j0 on, survivor or not (zeros past the row's
// end): a thread's two lanes' positions, flags and values in the block's
// row, adjacent lanes by 8-byte loads (PAIRS: lanes even, the rows and
// pos and surv 8-byte aligned), else lanes tid and tid + 256.
template <bool PAIRS>
__device__ __forceinline__ void compact_load(const float* __restrict__ dr,
                                             const float* __restrict__ pos,
                                             const float* __restrict__ surv, int lanes,
                                             int j0, float (&p)[2], float (&s)[2],
                                             float (&v)[2]) {
  if (PAIRS) {
    const int j = j0 + 2 * (int)threadIdx.x;
    float2 a = make_float2(0.f, 0.f), b = a, c = a;
    if (j < lanes) {
      a = __ldg(reinterpret_cast<const float2*>(pos + j));
      b = __ldg(reinterpret_cast<const float2*>(surv + j));
      c = __ldg(reinterpret_cast<const float2*>(dr + j));
    }
    p[0] = a.x, p[1] = a.y, s[0] = b.x, s[1] = b.y, v[0] = c.x, v[1] = c.y;
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + (int)threadIdx.x + e * CP_THREADS;
      const bool in = j < lanes;
      p[e] = in ? __ldg(pos + j) : 0.f;
      s[e] = in ? __ldg(surv + j) : 0.f;
      v[e] = in ? __ldg(dr + j) : 0.f;
    }
  }
}

// A block owns one row and 1,024 slots of the output (blockIdx.x the
// slots, blockIdx.y the row): it builds them in shared memory (zeros,
// then the survivors' values) and writes each output word once, a float4
// a thread where slots % 4 == 0. A round's loads are all in flight
// together, one round trip a round of 512 lanes, and the first round's
// are issued before the tile is zeroed.
template <bool PAIRS>
__global__ void __launch_bounds__(CP_THREADS)
    compact_kernel(const float* __restrict__ d, const float* __restrict__ pos,
                   const float* __restrict__ surv, float* __restrict__ out, int lanes,
                   int slots, int int_pos, int vec) {
  __shared__ __align__(16) float tile[CP_SLOTS];
  const int tid = threadIdx.x, s0 = blockIdx.x * CP_SLOTS;
  const int sn = min(CP_SLOTS, slots - s0);
  const float* dr = d + (size_t)blockIdx.y * lanes;
  float p[2], s[2], v[2];
  compact_load<PAIRS>(dr, pos, surv, lanes, 0, p, s, v);
  reinterpret_cast<float4*>(tile)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int j0 = 0;;) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int slot = compact_slot(p[e], s[e], slots, int_pos) - s0;
      if (slot >= 0 && slot < sn) tile[slot] = v[e];  // not -1, nor another block's
    }
    j0 += CP_ROUND;
    if (j0 >= lanes) break;
    compact_load<PAIRS>(dr, pos, surv, lanes, j0, p, s, v);
  }
  __syncthreads();
  float* row = out + (size_t)blockIdx.y * slots + s0;
  if (vec) {  // slots % 4 == 0: sn too
    if (4 * tid < sn) reinterpret_cast<float4*>(row)[tid] = reinterpret_cast<float4*>(tile)[tid];
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * tid + e < sn) row[4 * tid + e] = tile[4 * tid + e];
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

constexpr int SCAN_WARPS = 4;  // rows a block: a warp each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// A warp per row, no barrier: lane l holds c[l + 32 i], i < K (K a power
// of two, 32 K >= L; zeros past L), so that each load and store of the
// warp is 32 neighbouring values. Each log-shift step adds c[j - sh] to
// c[j] for every j (zero below j = sh, as the TPU kernel's masked roll
// adds +0.0), reading only the step's old values: for sh < 32 the value
// of lane l - sh (mod 32) by a shuffle, from register i, or from i - 1
// where l < sh; for sh >= 32 the lane's own register i - sh / 32. The
// steps run while sh < L, as the TPU kernel's (the values past L are read
// by no earlier element).
template <int K, typename In>
__global__ void __launch_bounds__(32 * SCAN_WARPS)
    scan_kernel(const In* __restrict__ x, float* __restrict__ out, int rows, int lanes) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // warp-uniform
  const In* xr = x + (size_t)r * lanes;
  float c[K];
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = 32 * i + lane < lanes ? to_float(xr[32 * i + lane]) : 0.f;
#pragma unroll
  for (int st = 0; st < 10; ++st) {
    const int sh = 1 << st;
    if (sh >= 32 * K || sh >= lanes) break;
    if (sh < 32) {
      float rot[K];
#pragma unroll
      for (int i = 0; i < K; ++i) rot[i] = __shfl_sync(FULL, c[i], (lane - sh) & 31);
#pragma unroll
      for (int i = 0; i < K; ++i)
        c[i] = c[i] + (lane >= sh ? rot[i] : (i ? rot[i ? i - 1 : 0] : 0.f));
    } else {
      const int di = sh / 32;
#pragma unroll
      for (int i = K - 1; i >= 0; --i) c[i] = c[i] + (i >= di ? c[i >= di ? i - di : 0] : 0.f);
    }
  }
  float* o = out + (size_t)r * lanes;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (32 * i + lane < lanes) o[32 * i + lane] = c[i];
}

// The K a row of L <= 1024 lanes needs: the least power of two with 32 K >= L.
inline int scan_k(int lanes) {
  int k = 1;
  while (32 * k < lanes) k *= 2;
  return k;
}

template <typename In>
inline void launch_scan(const In* x, float* out, int rows, int lanes, cudaStream_t st) {
  const int blocks = (rows + SCAN_WARPS - 1) / SCAN_WARPS;
  const int threads = 32 * min(rows, SCAN_WARPS);
  switch (scan_k(lanes)) {
    case 1: scan_kernel<1, In><<<blocks, threads, 0, st>>>(x, out, rows, lanes); break;
    case 2: scan_kernel<2, In><<<blocks, threads, 0, st>>>(x, out, rows, lanes); break;
    case 4: scan_kernel<4, In><<<blocks, threads, 0, st>>>(x, out, rows, lanes); break;
    case 8: scan_kernel<8, In><<<blocks, threads, 0, st>>>(x, out, rows, lanes); break;
    case 16: scan_kernel<16, In><<<blocks, threads, 0, st>>>(x, out, rows, lanes); break;
    default: scan_kernel<32, In><<<blocks, threads, 0, st>>>(x, out, rows, lanes); break;
  }
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

// d [rows][lanes], pos [lanes], surv [lanes] fp32 -> out [rows][slots]; a
// block per row and 1,024 slots, a grid per 65,535 rows, nothing
// launched for an empty output.
extern "C" int drt_probe_compact(const float* d, const float* pos, const float* surv,
                                 float* out, int rows, int lanes, int slots, int int_pos,
                                 void* stream) {
  if (rows < 0 || lanes < 0 || slots < 0) return (int)cudaErrorInvalidValue;
  const bool pairs = lanes % 2 == 0 && (uintptr_t)d % 8 == 0 && (uintptr_t)pos % 8 == 0 &&
                     (uintptr_t)surv % 8 == 0;
  const int vec = slots % 4 == 0 && (uintptr_t)out % 16 == 0;
  const int chunks = (slots + CP_SLOTS - 1) / CP_SLOTS;
  for (int r0 = 0; r0 < rows && chunks; r0 += CP_ROWS) {
    const dim3 grid(chunks, min(CP_ROWS, rows - r0));
    const float* dr = d + (size_t)r0 * lanes;
    float* o = out + (size_t)r0 * slots;
    if (pairs)
      compact_kernel<true><<<grid, CP_THREADS, 0, (cudaStream_t)stream>>>(
          dr, pos, surv, o, lanes, slots, int_pos, vec);
    else
      compact_kernel<false><<<grid, CP_THREADS, 0, (cudaStream_t)stream>>>(
          dr, pos, surv, o, lanes, slots, int_pos, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
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
// fp32; 1 <= lanes <= 1024; nothing launched for no rows.
extern "C" int drt_probe_scan(const void* x, float* out, int rows, int lanes, int bf16,
                              void* stream) {
  if (lanes <= 0 || lanes > 1024 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    launch_scan(static_cast<const __nv_bfloat16*>(x), out, rows, lanes, st);
  else
    launch_scan(static_cast<const float*>(x), out, rows, lanes, st);
  return (int)cudaGetLastError();
}
