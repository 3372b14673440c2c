// What sets compact's and scan's time on this card (P17, P22, P10, P16,
// csrc/probe_blocks.cu): the kernels as the port launches them, against
// their first versions, an empty launch, a memset of compact's output
// (what torch.zeros of it is in a graph: the least any route's output
// costs) and the designs between, at the TPU scripts' shapes: compact's d
// [24, 512] fp32 with the scripts' pos and surv (even lanes survive into
// slots 0-255, odd ones sit at 5000) -> [24, 1024], fp32 positions (P17)
// and int ones (P22); scan's [1, 512] row, seeded fp32 in [-100, 100]
// (P10) and the script's bf16 1 at every third lane (P16). Each is timed
// as a launch's device time inside a CUDA graph of 200 (graph_timing.cuh;
// the median of 5 replays), in 5 rounds over all designs in turn (the
// median and each round's time reported), and its output checked bit for
// bit against the plain version computed here on the host (compact's
// output over a buffer of 0xff bytes, NaN: a word left unwritten shows;
// scan's the TPU kernel's log-shift adds in fp32). Built and run by
// diag/block_designs.py; prints one JSON line {"compact": {design: {"us",
// "rounds", "equal"}}, "compact int": {...}, "scan": {...}, "scan bf16":
// {...}}.
//
// compact (blocks of 256 threads unless named):
//   kernel                 drt_probe_compact: a block per row and 1,024
//                          slots (a grid of 1 x 24), the tile in shared
//                          memory, a thread's two lanes 2 tid, 2 tid + 1
//                          by float2 loads before the tile is zeroed
//   empty launch           P1
//   memset node            cudaMemsetAsync of the [24, 1024] output
//   (a) first version      one block of 512: every output zeroed by 4-byte
//                          stores, a barrier, each survivor's 24 rows by
//                          4-byte stores 4 KB apart
//   (b) 4-byte loads       the kernel with lanes tid and tid + 256 (its
//                          form for odd lanes or 4-byte-aligned rows)
//   (c) flat grid          the first design: a one-dimensional grid split
//                          into rows and slots by a division, RB rows a
//                          block, rounds of LPT T lanes, the rows' float4
//                          stores in a loop; here 1 row, 24 blocks
//   (d) 2 rows a block     (c) with 2 rows: 12 blocks
//   (e) 4 rows a block     6 blocks
//   (f) 8 rows a block     3 blocks
//   (g) 512 slots a block  (c) with 128 threads, 4 lanes each a round (48
//                          blocks)
//   (h) 256 slots a block  64 threads, 8 lanes each a round (96 blocks)
//   (i) inverse map        a block per row and 1,024 slots: slot -> lane
//                          in shared memory (-1, a barrier, the
//                          survivors' lanes, a barrier), then each
//                          thread gathers its 4 slots' values from d and
//                          stores them as a float4
//   (j) one round, float2  the kernel's body for 512 lanes alone: no
//       loads              rounds loop, no ragged row
//   (k) one round, loads   (j) with lanes tid, tid + 256 loaded after the
//       after the barrier  tile's zeros and barrier
// scan (fp32 and bf16 in; a warp, lane l holding 16 values):
//   kernel                 drt_probe_scan: a warp per row, lane l holding
//                          c[l + 32 i]: each warp load and store 32
//                          neighbouring values; 5 shuffle steps (sh < 32),
//                          the 4 others within the lane; no barrier
//   empty launch           P1
//   (a) first version      a block per row of L threads, the row in
//                          shared memory, two barriers a step
//   (b) contiguous lanes   lane l holding c[16 l .. 16 l + 15], float4
//                          loads and stores: a lane's 64 bytes, so that a
//                          warp's load spans 2 KB; every step shuffles
//                          (by 1 for sh < 16)
//   (c) contiguous lanes,  (b) with 4-byte loads and stores
//       scalar loads
//   (d) strided float4s    lane l holding c[128 q + 4 l + e]: float4 (bf16:
//                          8-byte) loads and stores, coalesced; 7 shuffle
//                          steps (sh < 128)

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

#include "../csrc/probe_blocks.cu"
#include "graph_timing.cuh"

namespace {

constexpr int ROWS = 24, LANES = 512, SLOTS = 1024;  // compact
constexpr int SCAN_L = 512;                          // scan: [1, 512]
constexpr int ROUNDS = 5;

// P1's body: a launch that does nothing
__global__ void empty_kernel(const float*, float*) {}

// ---- the first versions ------------------------------------------------------

__global__ void first_compact(const float* d, const float* pos, const float* surv,
                              float* out, int rows, int lanes, int slots, int int_pos) {
  for (int i = threadIdx.x; i < rows * slots; i += blockDim.x) out[i] = 0.f;
  __syncthreads();
  for (int j = threadIdx.x; j < lanes; j += blockDim.x) {
    if (!(surv[j] > 0.5f)) continue;
    const float p = pos[j];
    int slot;
    if (int_pos) {
      if (!(p > -2147483648.f && p < 2147483648.f)) continue;
      slot = (int)p;
    } else {
      if (!(p == floorf(p)) || !(p >= 0.f && p < (float)slots)) continue;
      slot = (int)p;
    }
    if (slot < 0 || slot >= slots) continue;
    for (int r = 0; r < rows; ++r) out[(size_t)r * slots + slot] = d[(size_t)r * lanes + j];
  }
}

__global__ void first_scan(const void* x, float* out, int lanes, int bf16) {
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

// ---- the designs -------------------------------------------------------------

// A round of tiled_compact's loads: a thread's LPT lanes j = j0 + tid +
// e T, each its position, its flag and its value in the block's rn rows,
// survivor or not (zeros past the row's end).
template <int RB, int T, int LPT>
__device__ __forceinline__ void tiled_load(const float* __restrict__ d,
                                             const float* __restrict__ pos,
                                             const float* __restrict__ surv, int lanes,
                                             int r0, int rn, int j0, float (&p)[LPT],
                                             float (&s)[LPT], float (&v)[LPT][RB]) {
#pragma unroll
  for (int e = 0; e < LPT; ++e) {
    const int j = j0 + (int)threadIdx.x + e * T;
    const bool in = j < lanes;
    p[e] = in ? __ldg(pos + j) : 0.f;
    s[e] = in ? __ldg(surv + j) : 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      v[e][r] = in && r < rn ? __ldg(d + (size_t)(r0 + r) * lanes + j) : 0.f;
  }
}

// (c)-(h): the kernel's tile on a flat grid, block b owning RB rows
// (b / chunks) and 4 T slots (b % chunks), a round LPT T lanes, the
// rows' stores in a loop.
template <int RB, int T, int LPT>
__global__ void __launch_bounds__(T)
    tiled_compact(const float* __restrict__ d, const float* __restrict__ pos,
                   const float* __restrict__ surv, float* __restrict__ out, int rows,
                   int lanes, int slots, int int_pos, int chunks, int vec) {
  __shared__ __align__(16) float tile[RB][4 * T];
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % chunks, r0 = blockIdx.x / chunks * RB;
  const int s0 = chunk * 4 * T, sn = min(4 * T, slots - s0), rn = min(RB, rows - r0);
  float p[LPT], s[LPT], v[LPT][RB];
  tiled_load<RB, T, LPT>(d, pos, surv, lanes, r0, rn, 0, p, s, v);
  for (int i = tid; i < RB * T; i += T)
    reinterpret_cast<float4*>(&tile[0][0])[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int j0 = 0;;) {
#pragma unroll
    for (int e = 0; e < LPT; ++e) {
      const int slot = drt::pb::compact_slot(p[e], s[e], slots, int_pos) - s0;
      if (slot < 0 || slot >= sn) continue;  // -1, or another block's slot
#pragma unroll
      for (int r = 0; r < RB; ++r) tile[r][slot] = v[e][r];
    }
    j0 += LPT * T;
    if (j0 >= lanes) break;
    tiled_load<RB, T, LPT>(d, pos, surv, lanes, r0, rn, j0, p, s, v);
  }
  __syncthreads();
  for (int r = 0; r < rn; ++r) {
    float* row = out + (size_t)(r0 + r) * slots + s0;
    if (vec) {  // slots % 4 == 0: sn too
      for (int q = tid; q < sn / 4; q += T)
        reinterpret_cast<float4*>(row)[q] = reinterpret_cast<const float4*>(tile[r])[q];
    } else {
      for (int i = tid; i < sn; i += T) row[i] = tile[r][i];
    }
  }
}

// (j), (k): a row and 1,024 slots a block, 512 lanes (one round, no
// loop), with (j) a thread's two lanes 2 tid, 2 tid + 1 read by float2
// loads, (k) lanes tid, tid + 256 loaded after the tile's zeros and
// barrier.
template <bool PAIRS, bool EARLY>
__global__ void __launch_bounds__(256)
    compact_variant(const float* __restrict__ d, const float* __restrict__ pos,
                    const float* __restrict__ surv, float* __restrict__ out, int lanes,
                    int slots, int int_pos) {
  __shared__ __align__(16) float tile[1024];
  const int tid = threadIdx.x, r = blockIdx.x;
  float p[2], s[2], v[2];
  auto load = [&] {
    if (PAIRS) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(pos) + tid);
      const float2 b = __ldg(reinterpret_cast<const float2*>(surv) + tid);
      const float2 c = __ldg(reinterpret_cast<const float2*>(d + (size_t)r * lanes) + tid);
      p[0] = a.x, p[1] = a.y, s[0] = b.x, s[1] = b.y, v[0] = c.x, v[1] = c.y;
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = tid + 256 * e;
        p[e] = __ldg(pos + j), s[e] = __ldg(surv + j), v[e] = __ldg(d + (size_t)r * lanes + j);
      }
    }
  };
  if (EARLY) load();
  reinterpret_cast<float4*>(tile)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (!EARLY) load();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int slot = drt::pb::compact_slot(p[e], s[e], slots, int_pos);
    if (slot >= 0) tile[slot] = v[e];
  }
  __syncthreads();
  reinterpret_cast<float4*>(out + (size_t)r * slots)[tid] = reinterpret_cast<float4*>(tile)[tid];
}

// (i): a block per row and 4 T slots; inv[slot - s0] = the survivor's
// lane, -1 where none lands.
template <int T>
__global__ void __launch_bounds__(T)
    gather_compact(const float* __restrict__ d, const float* __restrict__ pos,
                   const float* __restrict__ surv, float* __restrict__ out, int rows,
                   int lanes, int slots, int int_pos, int chunks) {
  __shared__ __align__(16) int inv[4 * T];
  const int tid = threadIdx.x, chunk = blockIdx.x % chunks, r = blockIdx.x / chunks;
  const int s0 = chunk * 4 * T, sn = min(4 * T, slots - s0);
  reinterpret_cast<int4*>(inv)[tid] = make_int4(-1, -1, -1, -1);
  __syncthreads();
  for (int j = tid; j < lanes; j += T) {
    const int slot = drt::pb::compact_slot(__ldg(pos + j), __ldg(surv + j), slots, int_pos) - s0;
    if (slot >= 0 && slot < sn) inv[slot] = j;
  }
  __syncthreads();
  const float* dr = d + (size_t)r * lanes;
  const int4 at = reinterpret_cast<const int4*>(inv)[tid];
  if (4 * tid < sn)
    reinterpret_cast<float4*>(out + (size_t)r * slots + s0)[tid] =
        make_float4(at.x >= 0 ? __ldg(dr + at.x) : 0.f, at.y >= 0 ? __ldg(dr + at.y) : 0.f,
                    at.z >= 0 ? __ldg(dr + at.z) : 0.f, at.w >= 0 ? __ldg(dr + at.w) : 0.f);
}

template <int K>
__device__ __forceinline__ void scan_load(const float* x, int j0, int lanes, bool vec,
                                          float (&c)[K]) {
  if constexpr (K % 4 == 0) {
    if (vec) {  // lanes % 4 == 0: a float4 lies wholly inside the row or past it
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 f = j0 + 4 * q < lanes
                             ? __ldg(reinterpret_cast<const float4*>(x + j0) + q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        c[4 * q] = f.x;
        c[4 * q + 1] = f.y;
        c[4 * q + 2] = f.z;
        c[4 * q + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = j0 + i < lanes ? __ldg(x + j0 + i) : 0.f;
}

template <int K>
__device__ __forceinline__ void scan_load(const __nv_bfloat16* x, int j0, int lanes,
                                          bool vec, float (&c)[K]) {
  if constexpr (K % 8 == 0) {
    if (vec) {  // lanes % 8 == 0: 8 bf16 lie wholly inside the row or past it
#pragma unroll
      for (int q = 0; q < K / 8; ++q) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (j0 + 8 * q < lanes) u = __ldg(reinterpret_cast<const uint4*>(x + j0) + q);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          c[8 * q + 2 * h] = __uint_as_float(w[h] << 16);
          c[8 * q + 2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = j0 + i < lanes ? __bfloat162float(x[j0 + i]) : 0.f;
}

// (b), (c): a warp per row, lane l holding c[l K .. l K + K - 1]: each
// step's addend in the same lane (sh < K, i >= sh), in the lane before
// (sh < K, i < sh: its register K - sh + i, by __shfl_up_sync 1) or sh /
// K lanes before (sh >= K, register i); float4 loads and stores when vec.
template <int K, typename In>
__global__ void __launch_bounds__(32 * SCAN_WARPS)
    contiguous_scan(const In* __restrict__ x, float* __restrict__ out, int rows, int lanes,
                int vec) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // warp-uniform
  const int j0 = lane * K;
  float c[K];
  scan_load<K>(x + (size_t)r * lanes, j0, lanes, vec, c);
#pragma unroll
  for (int st = 0; st < 10; ++st) {
    const int sh = 1 << st;
    if (sh >= 32 * K || sh >= lanes) break;
    if (sh < K) {
      float t[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        t[i] = 0.f;
        if (i < sh) {
          const float u = __shfl_up_sync(FULL, c[K - sh + i], 1);
          t[i] = lane ? u : 0.f;
        }
      }
#pragma unroll
      for (int i = K - 1; i >= 0; --i) c[i] = c[i] + (i >= sh ? c[i >= sh ? i - sh : 0] : t[i]);
    } else {
      const int dl = sh / K;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float u = __shfl_up_sync(FULL, c[i], dl);
        c[i] = c[i] + (lane >= dl ? u : 0.f);
      }
    }
  }
  float* o = out + (size_t)r * lanes;
  if constexpr (K % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q)
        if (j0 + 4 * q < lanes)
          reinterpret_cast<float4*>(o + j0)[q] =
              make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (j0 + i < lanes) o[j0 + i] = c[i];
}

// (d): a warp per row, lane l holding c[128 q + 4 l + e], e < 4, q < K / 4:
// the loads and stores 16 bytes a lane (8 for bf16), coalesced.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <int K, typename In>
__global__ void vec_strided_scan(const In* __restrict__ x, float* __restrict__ out,
                                 int lanes) {
  constexpr int Q = K / 4;
  const int lane = threadIdx.x & 31, r = blockIdx.x;
  float c[Q][4];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (128 * q + 4 * lane < lanes) {
      load4(x + (size_t)r * lanes + 128 * q + 4 * lane, c[q]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[q][e] = 0.f;
    }
  }
#pragma unroll
  for (int st = 0; st < 10; ++st) {
    const int sh = 1 << st;
    if (sh >= 32 * K || sh >= lanes) break;
    if (sh < 4) {
      float rot[Q][4];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 4 - sh; e < 4; ++e) rot[q][e] = __shfl_sync(0xffffffffu, c[q][e], (lane - 1) & 31);
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 3; e >= 0; --e) {
          const int f = e - sh + 4;  // the lane before's register, e < sh
          const float prev = lane ? rot[q][f & 3] : (q ? rot[q ? q - 1 : 0][f & 3] : 0.f);
          c[q][e] = c[q][e] + (e >= sh ? c[q][e >= sh ? e - sh : 0] : prev);
        }
    } else if (sh < 128) {
      const int m = sh / 4;
      float rot[Q][4];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) rot[q][e] = __shfl_sync(0xffffffffu, c[q][e], (lane - m) & 31);
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[q][e] = c[q][e] + (lane >= m ? rot[q][e] : (q ? rot[q ? q - 1 : 0][e] : 0.f));
    } else {
      const int dq = sh / 128;
#pragma unroll
      for (int q = Q - 1; q >= 0; --q)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[q][e] = c[q][e] + (q >= dq ? c[q >= dq ? q - dq : 0][e] : 0.f);
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (128 * q + 4 * lane < lanes)
      *reinterpret_cast<float4*>(out + (size_t)r * lanes + 128 * q + 4 * lane) =
          make_float4(c[q][0], c[q][1], c[q][2], c[q][3]);
}

float bf16_to_float(uint16_t b) {
  uint32_t u = (uint32_t)b << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// the plain versions, on the host
std::vector<float> host_compact(const std::vector<float>& d, const std::vector<float>& pos,
                                const std::vector<float>& surv, int int_pos) {
  std::vector<float> out((size_t)ROWS * SLOTS, 0.f);
  for (int j = 0; j < LANES; ++j) {
    if (!(surv[j] > 0.5f)) continue;
    const float p = pos[j];
    long long slot;
    if (int_pos) {
      if (!(p > -2147483648.f && p < 2147483648.f)) continue;
      slot = (long long)p;
    } else {
      if (!(p == std::floor(p)) || !(p >= 0.f && p < (float)SLOTS)) continue;
      slot = (long long)p;
    }
    if (slot < 0 || slot >= SLOTS) continue;
    for (int r = 0; r < ROWS; ++r) out[(size_t)r * SLOTS + slot] = d[(size_t)r * LANES + j];
  }
  return out;
}

std::vector<float> host_scan(std::vector<float> c) {
  for (int sh = 1; sh < (int)c.size(); sh *= 2) {
    std::vector<float> n(c.size());
    for (size_t j = 0; j < c.size(); ++j) n[j] = c[j] + ((int)j >= sh ? c[j - sh] : 0.f);
    c.swap(n);
  }
  return c;
}

}  // namespace

int main() {
  // the scripts' compaction inputs
  std::vector<float> hd((size_t)ROWS * LANES), hpos(LANES), hsurv(LANES);
  for (int i = 0; i < ROWS * LANES; ++i) hd[i] = (float)i * 0.001f + 1.0f;
  for (int j = 0; j < LANES; ++j) {
    hsurv[j] = j % 2 == 0 ? 1.f : 0.f;
    hpos[j] = j % 2 == 0 ? (float)(j / 2) : 5000.f;
  }
  // scan: seeded fp32 for P10, the script's bf16 row for P16
  std::vector<float> hx(SCAN_L), hb_f(SCAN_L);
  std::vector<uint16_t> hb(SCAN_L);
  srand(3);
  for (auto& v : hx) v = 200.f * rand() / RAND_MAX - 100.f;
  for (int j = 0; j < SCAN_L; ++j) {
    hb[j] = j % 3 == 0 ? 0x3f80 : 0;  // bf16 1.0 or 0.0
    hb_f[j] = bf16_to_float(hb[j]);
  }
  const std::vector<float> want_c[2] = {host_compact(hd, hpos, hsurv, 0),
                                        host_compact(hd, hpos, hsurv, 1)};
  const std::vector<float> want_s[2] = {host_scan(hx), host_scan(hb_f)};

  float *d, *pos, *surv, *x, *out;
  uint16_t* xb;
  CK(cudaMalloc(&d, hd.size() * 4));
  CK(cudaMalloc(&pos, LANES * 4));
  CK(cudaMalloc(&surv, LANES * 4));
  CK(cudaMalloc(&x, SCAN_L * 4));
  CK(cudaMalloc(&xb, SCAN_L * 2));
  CK(cudaMalloc(&out, (size_t)ROWS * SLOTS * 4));
  CK(cudaMemcpy(d, hd.data(), hd.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(pos, hpos.data(), LANES * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(surv, hsurv.data(), LANES * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(x, hx.data(), SCAN_L * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(xb, hb.data(), SCAN_L * 2, cudaMemcpyHostToDevice));
  cudaStream_t st;
  CK(cudaStreamCreate(&st));

  struct Design {
    std::string op, name;
    std::function<void()> launch;
    bool check;
    std::vector<float> us;
    bool equal = true;
  };
  std::vector<Design> designs;
  auto add = [&](const char* op, const char* name, std::function<void()> launch,
                 bool check = true) { designs.push_back(Design{op, name, launch, check, {}}); };
  const int cbytes = ROWS * SLOTS * 4;
  for (int ip = 0; ip < 2; ++ip) {
    const char* op = ip ? "compact int" : "compact";
    add(op, "kernel", [=] {
      CK((cudaError_t)drt_probe_compact(d, pos, surv, out, ROWS, LANES, SLOTS, ip, st));
    });
    add(op, "empty launch", [=] { empty_kernel<<<1, 128, 0, st>>>(d, out); }, false);
    add(op, "memset node", [=] { CK(cudaMemsetAsync(out, 0, cbytes, st)); }, false);
    add(op, "(a) first version", [=] {
      first_compact<<<1, 512, 0, st>>>(d, pos, surv, out, ROWS, LANES, SLOTS, ip);
    });
    if (ip) continue;
    add(op, "(b) 4-byte loads", [=] {
      drt::pb::compact_kernel<false><<<dim3(1, ROWS), 256, 0, st>>>(d, pos, surv, out, LANES,
                                                                   SLOTS, 0, 1);
    });
    const struct { const char* name; void (*kernel)(const float*, const float*, const float*,
                                                    float*, int, int, int, int, int, int);
                   int blocks, threads, chunks; } tiled[] = {
        {"(c) flat grid", tiled_compact<1, 256, 2>, 24, 256, 1},
        {"(d) 2 rows a block", tiled_compact<2, 256, 2>, 12, 256, 1},
        {"(e) 4 rows a block", tiled_compact<4, 256, 2>, 6, 256, 1},
        {"(f) 8 rows a block", tiled_compact<8, 256, 2>, 3, 256, 1},
        {"(g) 512 slots a block", tiled_compact<1, 128, 4>, 48, 128, 2},
        {"(h) 256 slots a block", tiled_compact<1, 64, 8>, 96, 64, 4}};
    for (const auto& t : tiled) {
      auto kernel = t.kernel;
      const int blocks = t.blocks, threads = t.threads, chunks = t.chunks;
      add(op, t.name, [=] {
        kernel<<<blocks, threads, 0, st>>>(d, pos, surv, out, ROWS, LANES, SLOTS, 0, chunks, 1);
      });
    }
    add(op, "(i) inverse map", [=] {
      gather_compact<256><<<ROWS, 256, 0, st>>>(d, pos, surv, out, ROWS, LANES, SLOTS, 0, 1);
    });
    add(op, "(j) one round, float2 loads", [=] {
      compact_variant<true, true><<<ROWS, 256, 0, st>>>(d, pos, surv, out, LANES, SLOTS, 0);
    });
    add(op, "(k) one round, loads after the barrier", [=] {
      compact_variant<false, false><<<ROWS, 256, 0, st>>>(d, pos, surv, out, LANES, SLOTS, 0);
    });
  }
  for (int bf = 0; bf < 2; ++bf) {
    const char* op = bf ? "scan bf16" : "scan";
    const void* in = bf ? (const void*)xb : (const void*)x;
    add(op, "kernel",
        [=] { CK((cudaError_t)drt_probe_scan(in, out, 1, SCAN_L, bf, st)); });
    add(op, "empty launch", [=] { empty_kernel<<<1, 128, 0, st>>>(d, out); }, false);
    add(op, "(a) first version", [=] { first_scan<<<1, SCAN_L, 0, st>>>(in, out, SCAN_L, bf); });
    add(op, "(b) contiguous lanes", [=] {
      if (bf)
        contiguous_scan<16, __nv_bfloat16><<<1, 32, 0, st>>>(
            reinterpret_cast<const __nv_bfloat16*>(xb), out, 1, SCAN_L, 1);
      else
        contiguous_scan<16, float><<<1, 32, 0, st>>>(x, out, 1, SCAN_L, 1);
    });
    add(op, "(c) contiguous lanes, scalar loads", [=] {
      if (bf)
        contiguous_scan<16, __nv_bfloat16><<<1, 32, 0, st>>>(
            reinterpret_cast<const __nv_bfloat16*>(xb), out, 1, SCAN_L, 0);
      else
        contiguous_scan<16, float><<<1, 32, 0, st>>>(x, out, 1, SCAN_L, 0);
    });
    add(op, "(d) strided float4s", [=] {
      if (bf)
        vec_strided_scan<16, __nv_bfloat16><<<1, 32, 0, st>>>(
            reinterpret_cast<const __nv_bfloat16*>(xb), out, SCAN_L);
      else
        vec_strided_scan<16, float><<<1, 32, 0, st>>>(x, out, SCAN_L);
    });
  }
  // rounds over every design in turn, so that each sees the same card
  for (int round = 0; round < ROUNDS; ++round) {
    for (auto& ds : designs) {
      CK(cudaMemset(out, 0xff, cbytes));
      ds.us.push_back(graph_us(ds.launch, st, 200));
      CK(cudaGetLastError());
      if (!ds.check || round) continue;
      // once more over NaN, then the output against the plain version
      CK(cudaMemset(out, 0xff, cbytes));
      ds.launch();
      CK(cudaStreamSynchronize(st));
      const bool is_scan = ds.op.rfind("scan", 0) == 0;
      const std::vector<float>& want =
          is_scan ? want_s[ds.op == "scan bf16"] : want_c[ds.op == "compact int"];
      std::vector<float> h(want.size());
      CK(cudaMemcpy(h.data(), out, want.size() * 4, cudaMemcpyDeviceToHost));
      ds.equal = std::memcmp(h.data(), want.data(), want.size() * 4) == 0;
    }
  }
  printf("{");
  const char* ops[] = {"compact", "compact int", "scan", "scan bf16"};
  for (int o = 0; o < 4; ++o) {
    printf("%s\"%s\": {", o ? ", " : "", ops[o]);
    bool first = true;
    for (auto& ds : designs) {
      if (ds.op != ops[o]) continue;
      std::vector<float> sorted = ds.us;
      std::sort(sorted.begin(), sorted.end());
      printf("%s\"%s\": {\"us\": %.4f, \"rounds\": [", first ? "" : ", ", ds.name.c_str(),
             sorted[ROUNDS / 2]);
      for (int r = 0; r < ROUNDS; ++r) printf("%s%.4f", r ? ", " : "", ds.us[r]);
      printf("], \"equal\": %s}", ds.check ? (ds.equal ? "true" : "false") : "null");
      first = false;
    }
    printf("}");
  }
  printf("}\n");
  CK(cudaDeviceSynchronize());
  return 0;
}
