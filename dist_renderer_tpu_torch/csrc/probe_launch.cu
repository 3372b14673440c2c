// Launch-feature probes: what one launch costs on this card, and what a
// kernel's features add to it. Counterparts of the TPU probe kernels of
// scripts/diag_launch_cost.py (k_empty :51, k_scratch :74, k_noW :143,
// k_fori :168, k_w2 :196), scripts/diag_launch2.py (scalar_while_kernel
// :65, vec_while_kernel :119), scripts/diag_launch3.py (k_any :71,
// k_alias :85, k_scratch :101, k_smemarr :121, k_dma :145) and
// scripts/diag_launch4.py (k_copy :66, k_add :70).
//
// The TPU kernels' features map to Hopper's as follows. A Mosaic "ANY"
// operand (left in device memory) is a pointer argument; an aliased
// output is the input's own buffer (the wrapper returns the input);
// VMEM scratch is dynamic shared memory, above 48 KB only after
// cudaFuncSetAttribute, which these entries call at every launch as the
// port's real kernels do; a DMA semaphore is an mbarrier, initialised by
// one thread and fenced; an SMEM array is an int32 list staged in shared
// memory; a DMA is a cp.async.bulk (TMA) copy completing on an mbarrier.
// An SMEM scalar is on-chip, a cycle to read, and its counterpart is a
// word on chip: P7 and P15 read their trip count from device memory once,
// before the loop, into a register. The loops of P3-P6 and P11-P14, whose
// function is a loop bound read at every trip, read it on chip at every
// trip, as the TPU kernels read their SMEM scalar: one thread loads it
// from device memory into a shared-memory word, a barrier publishes it
// (__syncwarp in scalar_while, the block's in index_loop, whose list all
// threads stage), and warp 0 alone runs the trips, each a volatile shared
// load (LDS), a compare and a branch. Their first versions loaded it from
// device memory at every trip (ld_volatile: ~0.14-0.18 us a trip on the
// H100, P6's 64 trips 10.4 us in a CUDA graph, P4's 512 90.7, an empty
// launch 0.8); diag/loop_designs.cu times the designs.
//
// Bound: none of these do work but P15's and P18/P19's copies (P15: rows
// 0-7 of rays read, 16 KB, and 16 KB written; P18/P19 16 KB read and 16
// KB written at [8, 512]: 0.0098 us at 3.35 TB/s) and P6/P7's zero and
// carry stores (4 + 4 KB, 4 + 16 KB); the time is the launch's fixed
// cost and the round trips the kernel waits for in turn, and for the
// loops of P3-P6 and P11-P14 their trips, each at least one dependent
// shared load's latency (the floor trips x that latency + an empty
// launch, which diag/loop_designs.cu measures). Design: one
// block (the TPU's grid=(1,)), loops warp-uniform, but for P15, P18 and
// P19, which fill a grid: their first versions, one block of 256
// threads, waited out their round trips in series. P18/P19 ran a 16-trip
// loop whose every trip waited for its 4-byte load before its store and
// the next load (the loop's stride is blockDim.x, so the compiler does
// not unroll it, __restrict__ or not): ~3.6 us in a CUDA graph where an
// empty kernel runs ~1.0. Now each thread moves one 16-byte vector a
// trip, on a grid sized to the data: STREAM_THREADS vectors a block, at
// most STREAM_MAX_BLOCKS blocks (8 of 256 threads an SM) striding over
// the rest. At [8, 512] that is 4 blocks of 256 threads, one round trip
// each: ~1.2 us, the fastest of the grids diag/copy_designs.cu times
// (1 x 1024, 8 x 128, 16 x 64 threads; 1 x 256 and 2 x 128 at 4 vectors
// a thread, all 4 loads before the stores). At the
// probe's size the launch and one round trip are the bound: the bytes'
// share of the time is below 1% whatever the grid. P15 and P7 are
// described at their kernels; diag/dma_designs.cu times the designs they
// were chosen from.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace drt {
namespace pr {

constexpr int THREADS = 128;
constexpr int DEFAULT_SMEM = 48 * 1024;  // usable without the opt-in attribute

// A device-memory word read anew at every call (the first versions' loop
// bound; the design programs time it).
__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A shared-memory word read anew at every call (ld.volatile.shared: an
// LDS the compiler neither hoists nor merges).
__device__ __forceinline__ int lds_volatile(const int* p) {
  int v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Global -> shared bulk copy completing `bytes` on the mbarrier at bar.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Shared -> global bulk copy in the thread's bulk group.
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

// The threads' generic shared-memory writes made visible to the async
// (TMA) proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// n_bars mbarriers (arrival count 1) at the front of dynamic shared
// memory, as the TPU kernels' DMA semaphores; 16 bytes per barrier
// reserved, so what follows stays 16-byte aligned. Ends in the block's
// barrier, n_bars 0 too.
__device__ __forceinline__ void init_bars(char* smem, int n_bars) {
  if (threadIdx.x == 0 && n_bars > 0) {
    for (int i = 0; i < n_bars; ++i) mbar_init(smem_u32(smem + 16 * i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// P1 (k_empty): nothing. The operands are pointers the body never reads.
__global__ void empty_kernel(const float* in, float* out) {}

// P2 (k_scratch): dynamic shared memory with n_bars mbarriers set up,
// nothing else.
__global__ void scratch_kernel(const float* a, float* b, int n_bars) {
  extern __shared__ __align__(16) char smem[];
  init_bars(smem, n_bars);
}

// P3, P5, P6, P11-P13: a while loop whose bound, n_live[0], is read at
// every trip from a shared-memory word (the TPU kernels' SMEM scalar):
// thread 0 loads it from device memory once, and warp 0 alone runs the
// trips, a dependent chain of LDS, compare and branch that no other warp
// contends with. Only warp 0 reads the word, so __syncwarp publishes it
// (the optional scratch set ends in the block's barrier, as P2's). With
// zeros != null, an [n_zeros] zero write first (P5, P6: float4 stores,
// two a thread at [8, 128]; n_zeros % 4 == 0 and zeros 16-byte aligned).
// live, rays, bias and out are the TPU kernels' other operands: passed,
// never read.
__global__ void scalar_while_kernel(const int* n_live, const int* live, const float* rays,
                                    const float* bias, float* out, float* zeros,
                                    int n_zeros, int n_bars) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int bound;
  const int b = threadIdx.x == 0 ? *n_live : 0;  // in flight during the stores
  if (zeros != nullptr)
    for (int i = threadIdx.x; i < n_zeros / 4; i += blockDim.x)
      reinterpret_cast<float4*>(zeros)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n_bars > 0) init_bars(smem, n_bars);
  if (threadIdx.x >= 32) return;
  if (threadIdx.x == 0) bound = b;
  __syncwarp();
  int k = 0;
  while (k < lds_volatile(&bound)) ++k;
}

// P4 (k_fori) and P14 (k_smemarr): the int32 list live[n_list] staged in
// shared memory after the barriers, in one round trip where n_list % 4
// == 0 and live is 16-byte aligned (int4 loads, one a thread at 512
// entries; 4-byte loads otherwise), the bound as in scalar_while, then
// warp 0 alone:
//   mode 0: for k in [0, n_list): if k < n_live[0], ts = list[k];
//   mode 1: while k < n_live[0]: k += list[k] * 0 + 1
// (the TPU kernels' loops; ts is a shared scalar, the list read through
// volatile so that neither loop folds away). Each trip reads its list
// entry beside the bound, before the compare: read after it, the entry
// was a second shared round trip a trip, since the copy's store (and in
// mode 1 the next trip's loads) waited for it, predicated off or not
// (P4's 512 trips 22.3 us in a CUDA graph, 17.6 with the entry read
// first; mode 1 0.031 us a trip against 0.023). Mode 0's loop runs over
// the list, not the bound, and is unrolled by 4 (13.8 us). Mode 1 reads
// entry min(k, n_list): past the end of the list, ts's word, times 0
// (the TPU kernel read out of bounds).
__global__ void index_loop_kernel(const int* live, int n_list, const int* n_live,
                                  const float* rays, const float* bias, float* out,
                                  int mode, int n_bars) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int bound;
  int* list = reinterpret_cast<int*>(smem + 16 * n_bars);
  if (threadIdx.x == 0) bound = *n_live;
  if (n_list % 4 == 0 && ((uintptr_t)live & 15) == 0) {
    for (int i = threadIdx.x; i < n_list / 4; i += blockDim.x)
      reinterpret_cast<int4*>(list)[i] = __ldg(reinterpret_cast<const int4*>(live) + i);
  } else {
    for (int i = threadIdx.x; i < n_list; i += blockDim.x) list[i] = live[i];
  }
  init_bars(smem, n_bars);
  if (threadIdx.x >= 32) return;
  const volatile int* vlist = list;
  volatile int* ts = list + n_list;
  if (mode == 0) {
#pragma unroll 4
    for (int k = 0; k < n_list; ++k) {
      const int e = vlist[k];
      if (k < lds_volatile(&bound)) ts[0] = e;
    }
  } else {
    for (int k = 0;;) {
      const int b = lds_volatile(&bound);
      const int e = vlist[min(k, n_list)];
      if (k >= b) break;
      k += e * 0 + 1;
    }
  }
}

// P7 (vec_while_kernel): an [n] fp32 carry (n <= VEC_THREADS * VEC_PER)
// from zeros, c += 1 while k < trips[0] and max(c) > -1; out = c. One
// block, so the max is the whole carry's: the block votes on the test
// with __syncthreads_or every trip, each thread's vote an OR over its
// values. The count is read once, before the loop: the first version
// (128 threads x 32 values) loaded it through ld_volatile at every trip,
// ~0.17 us a trip, 2.74 us at 8 trips in a CUDA graph against
// torch.add's 2.41; read once, 2.21 (diag/dma_designs.cu). On 256
// threads x 16 values a trip takes ~0.09 us (2.07 at 8 trips; 512 x 8
// 2.10; float4 stores 2.07; the count as a shared word read every trip
// 2.52). Thread t holds elements t, t + VEC_THREADS, ...; a value past n
// starts at -inf, which stays below -1 and leaves the max as it is, so
// the loop tests no index.
constexpr int VEC_THREADS = 256, VEC_PER = 16;

__global__ void __launch_bounds__(VEC_THREADS) vec_while_kernel(const int* trips, float* out,
                                                                 int n) {
  const int n_trips = *trips;
  float c[VEC_PER];
#pragma unroll
  for (int i = 0; i < VEC_PER; ++i)
    c[i] = (int)threadIdx.x + i * VEC_THREADS < n ? 0.f : -INFINITY;
  for (int k = 0;; ++k) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < VEC_PER; ++i) any |= c[i] > -1.f;
    if (!__syncthreads_or(k < n_trips && any)) break;
#pragma unroll
    for (int i = 0; i < VEC_PER; ++i) c[i] += 1.f;
  }
#pragma unroll
  for (int i = 0; i < VEC_PER; ++i) {
    const int j = threadIdx.x + i * VEC_THREADS;
    if (j < n) out[j] = c[i];
  }
}

// P15 (k_dma): at each of trips[0] trips, rays[0:8][0:512] into shared
// memory by bulk copies on an mbarrier, + 1 in place, and back to
// out[0:8][0:512] by bulk copies. ld is both arrays' row stride. The
// first version, one block of 256 threads, copied 16 rows in (the TPU
// kernel's [16, 512] window; rows 8-15 are never used), added into a
// second buffer (49 KB of shared memory, over the 48 KB default, so an
// attribute call at every launch), re-read the count through ld_volatile
// every trip and waited for each trip's stores to reach device memory
// (cp.async.bulk.wait_group 0): 2.84 us in a CUDA graph at one trip, the
// torch add 1.39-1.58. The time is a chain of round trips each block
// waits out in turn (the count's load, the copy in, the add, the copy
// out), so the design shortens the chain (diag/dma_designs.cu, us at one
// trip): the count read once (2.70); 8 rows in place on float4s (1
// block: 2.58); the window split over DMA_BLOCKS blocks, each with its
// own mbarriers, its piece's copies and its own loop (2, 4, 8, 16
// blocks: 2.06, 1.80, 1.71, 1.68); thread 0 issuing the first trip's
// copy in before the count arrives (1.54; every block then waits for it,
// at 0 trips too: 1.29 there against 1.13); and from the second trip on,
// trip k + 1's copy in issued at trip k's start into the other of two
// stages (64 trips: 24.6 against 30.8). Together: 1.50. A trip waits
// only until its stores have read the stage (wait_group.read), before
// the stage is rewritten or the block exits; the stores reach device
// memory by the kernel's end (waiting for that instead moved nothing).
// Every trip keeps its copy in, add and copy out. Plain 16-byte loads
// and stores in place of the bulk copies take 1.33.
constexpr int DMA_COLS = 512, DMA_ROWS = 8;
constexpr int DMA_BLOCKS = 8, DMA_THREADS = 128;

__device__ __forceinline__ void bulk_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A block's piece of the window: floats [first, first + seg) of the
// flattened [8, 512], seg = 4096 / gridDim.x (whole rows, or a divisor of
// a row), copied a row's part at a time.
struct DmaPiece {
  int first, seg;
  __device__ DmaPiece() : seg(DMA_ROWS * DMA_COLS / gridDim.x) { first = blockIdx.x * seg; }
  __device__ size_t at(int i, int ld) const { return (size_t)(i / DMA_COLS) * ld + i % DMA_COLS; }
  __device__ int part() const { return seg < DMA_COLS ? seg : DMA_COLS; }
};

// Thread 0's bulk copy of the piece of rays into shared memory at dst,
// completing on the mbarrier at bar.
__device__ __forceinline__ void dma_in(uint32_t dst, const float* rays, const DmaPiece& p,
                                       int ld, uint32_t bar) {
  mbar_expect_tx(bar, p.seg * 4);
  for (int i = p.first; i < p.first + p.seg; i += p.part())
    bulk_g2s(dst + 4 * (i - p.first), rays + p.at(i, ld), 4 * p.part(), bar);
}

// Thread 0's bulk copy of shared memory at src back to the piece of out,
// waiting until the copies have read src.
__device__ __forceinline__ void dma_out(float* out, const DmaPiece& p, int ld, uint32_t src) {
  for (int i = p.first; i < p.first + p.seg; i += p.part())
    bulk_s2g(out + p.at(i, ld), src + 4 * (i - p.first), 4 * p.part());
  bulk_commit_and_wait_read();
}

// buf[0:n4] += 1 over the block's threads, then fenced for the bulk
// copies and the block synchronised.
__device__ __forceinline__ void dma_add_in_place(float4* buf, int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 v = buf[i];
    buf[i] = make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f);
  }
  fence_proxy_async();
  __syncthreads();
}

// Two mbarriers, then two stages of seg floats: dynamic shared memory
// 32 + 8 seg bytes.
__global__ void dma_loop_kernel(const int* trips, const float* rays, float* out, int ld) {
  extern __shared__ __align__(16) char smem[];
  const DmaPiece p;
  const uint32_t bar = smem_u32(smem), buf = smem_u32(smem + 32), stage = 4 * p.seg;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 16, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    dma_in(buf, rays, p, ld, bar);
  }
  const int n_trips = *trips;
  __syncthreads();
  for (int k = 0;; ++k) {
    const int s = k & 1;
    // stage s ^ 1's last reader, trip k - 1's copy out, is done
    if (threadIdx.x == 0 && k + 1 < n_trips)
      dma_in(buf + (s ^ 1) * stage, rays, p, ld, bar + 16 * (s ^ 1));
    mbar_wait(bar + 16 * s, (k >> 1) & 1);
    if (k >= n_trips) break;
    dma_add_in_place(reinterpret_cast<float4*>(smem + 32 + s * stage), p.seg / 4);
    if (threadIdx.x == 0) dma_out(out, p, ld, buf + s * stage);
    if (k + 1 >= n_trips) break;
  }
}

// P18 (k_copy), P19 (k_add): out = x, out = x + 1 over n fp32 values,
// one body. A thread takes one unit a trip (a float4 when VEC, else a
// float), striding over the grid. The copy moves bits (no arithmetic:
// -0.0, NaN payloads and denormals pass unchanged). VEC needs x and out
// on 16-byte boundaries; its n % 4 tail is one scalar each for block 0's
// first threads.
constexpr int STREAM_THREADS = 256, STREAM_MAX_BLOCKS = 132 * 8;

template <bool ADD>
__device__ __forceinline__ float bump(float v) {
  return ADD ? v + 1.f : v;
}

template <bool ADD>
__device__ __forceinline__ float4 bump(float4 v) {
  return ADD ? make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f) : v;
}

template <bool ADD, bool VEC>
__global__ void stream_kernel(const float* __restrict__ x, float* __restrict__ out,
                              long long n) {
  using T = typename std::conditional<VEC, float4, float>::type;
  const T* __restrict__ xs = reinterpret_cast<const T*>(x);
  T* __restrict__ os = reinterpret_cast<T*>(out);
  const long long units = VEC ? n / 4 : n;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < units;
       i += (long long)gridDim.x * blockDim.x)
    os[i] = bump<ADD>(__ldg(xs + i));
  if (VEC && blockIdx.x == 0 && threadIdx.x < n % 4) {
    const long long i = n - n % 4 + threadIdx.x;
    out[i] = bump<ADD>(__ldg(x + i));
  }
}

// The launch the port makes: the vector body when both pointers are
// 16-byte aligned, else the scalar one; nothing for n <= 0.
template <bool ADD>
cudaError_t launch_stream(const float* x, float* out, long long n, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const bool vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  const long long want = ((vec ? n / 4 : n) + STREAM_THREADS - 1) / STREAM_THREADS;
  const int blocks = (int)(want < 1 ? 1 : want < STREAM_MAX_BLOCKS ? want : STREAM_MAX_BLOCKS);
  if (vec)
    stream_kernel<ADD, true><<<blocks, STREAM_THREADS, 0, stream>>>(x, out, n);
  else
    stream_kernel<ADD, false><<<blocks, STREAM_THREADS, 0, stream>>>(x, out, n);
  return cudaGetLastError();
}

template <typename K>
inline cudaError_t opt_in(K kernel, int smem_bytes) {
  if (smem_bytes <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace pr
}  // namespace drt

using namespace drt::pr;

// Every entry launches on the caller's stream (one block, but for
// drt_probe_dma_loop, drt_probe_copy and drt_probe_add_one) and returns
// cudaGetLastError().

extern "C" int drt_probe_empty(const float* in, float* out, void* stream) {
  empty_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(in, out);
  return (int)cudaGetLastError();
}

// smem_bytes >= 16 * n_bars.
extern "C" int drt_probe_scratch(const float* a, float* b, int smem_bytes, int n_bars,
                                 void* stream) {
  if (smem_bytes < 16 * n_bars) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(scratch_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  scratch_kernel<<<1, THREADS, smem_bytes, (cudaStream_t)stream>>>(a, b, n_bars);
  return (int)cudaGetLastError();
}

// zeros (or null) 16-byte aligned, n_zeros % 4 == 0; smem_bytes >= 16 * n_bars.
extern "C" int drt_probe_scalar_while(const int* n_live, const int* live, const float* rays,
                                      const float* bias, float* out, float* zeros,
                                      int n_zeros, int smem_bytes, int n_bars,
                                      void* stream) {
  if (smem_bytes < 16 * n_bars || n_zeros % 4 != 0 || ((uintptr_t)zeros & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(scalar_while_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  scalar_while_kernel<<<1, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      n_live, live, rays, bias, out, zeros, n_zeros, n_bars);
  return (int)cudaGetLastError();
}

// smem_bytes >= 16 * n_bars + 4 * (n_list + 1).
extern "C" int drt_probe_index_loop(const int* live, int n_list, const int* n_live,
                                    const float* rays, const float* bias, float* out,
                                    int mode, int smem_bytes, int n_bars, void* stream) {
  if (smem_bytes < 16 * n_bars + 4 * (n_list + 1) || n_list < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(index_loop_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  index_loop_kernel<<<1, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      live, n_list, n_live, rays, bias, out, mode, n_bars);
  return (int)cudaGetLastError();
}

extern "C" int drt_probe_vec_while(const int* trips, float* out, int n, void* stream) {
  if (n > VEC_THREADS * VEC_PER) return (int)cudaErrorInvalidValue;
  vec_while_kernel<<<1, VEC_THREADS, 0, (cudaStream_t)stream>>>(trips, out, n);
  return (int)cudaGetLastError();
}

// rays [16][ld], out [8][ld] fp32, ld >= 512 and a multiple of 4 (the bulk
// copies' 16-byte alignment).
extern "C" int drt_probe_dma_loop(const int* trips, const float* rays, float* out, int ld,
                                  void* stream) {
  if (ld < DMA_COLS || ld % 4 != 0) return (int)cudaErrorInvalidValue;
  dma_loop_kernel<<<DMA_BLOCKS, DMA_THREADS, 32 + 8 * DMA_ROWS * DMA_COLS / DMA_BLOCKS,
                    (cudaStream_t)stream>>>(trips, rays, out, ld);
  return (int)cudaGetLastError();
}

// A 64-bit count; x and out must not overlap. n <= 0 launches nothing.
extern "C" int drt_probe_copy(const float* x, float* out, long long n, void* stream) {
  return (int)launch_stream<false>(x, out, n, (cudaStream_t)stream);
}

extern "C" int drt_probe_add_one(const float* x, float* out, long long n, void* stream) {
  return (int)launch_stream<true>(x, out, n, (cudaStream_t)stream);
}
