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
// one thread and fenced; an SMEM scalar read each trip of a while loop is
// a volatile load from device memory; an SMEM array is an int32 list
// staged in shared memory; a DMA is a cp.async.bulk (TMA) copy completing
// on an mbarrier.
//
// Bound: none of these do work but P15's 48 KB copy and P18/P19's 32 KB
// (16 KB read, 16 KB written at [8, 512]: 0.0098 us at 3.35 TB/s); the
// time is the launch's fixed cost. Design: one block (the TPU's
// grid=(1,)), loops warp-uniform, but for P18 and P19, which fill a grid:
// their first version, one block of 256 threads, ran a 16-trip loop
// whose every trip waited for its 4-byte load before its store and the
// next load (the loop's stride is blockDim.x, so the compiler does not
// unroll it, __restrict__ or not): ~3.6 us in a CUDA graph where an
// empty kernel runs ~1.0. Now each thread moves one 16-byte vector a
// trip, on a grid sized to the data: STREAM_THREADS vectors a block, at
// most STREAM_MAX_BLOCKS blocks (8 of 256 threads an SM) striding over
// the rest. At [8, 512] that is 4 blocks of 256 threads, one round trip
// each: ~1.2 us, the fastest of the grids diag/copy_designs.cu times
// (1 x 1024, 8 x 128, 16 x 64 threads; 1 x 256 and 2 x 128 at 4 vectors
// a thread, all 4 loads before the stores). At the
// probe's size the launch and one round trip are the bound: the bytes'
// share of the time is below 1% whatever the grid.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace drt {
namespace pr {

constexpr int THREADS = 128;
constexpr int DEFAULT_SMEM = 48 * 1024;  // usable without the opt-in attribute

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

__device__ __forceinline__ void bulk_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The threads' generic shared-memory writes made visible to the async
// (TMA) proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// n_bars mbarriers (arrival count 1) at the front of dynamic shared
// memory, as the TPU kernels' DMA semaphores; 16 bytes per barrier
// reserved, so what follows stays 16-byte aligned.
__device__ __forceinline__ void init_bars(char* smem, int n_bars) {
  if (threadIdx.x == 0) {
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

// P3, P5, P6, P11-P13: a while loop whose bound is read from device
// memory at every trip (k < n_live[0]), the optional scratch set, and
// with zeros != null an [n_zeros] zero write after the loop (P5, P6).
// live, rays, bias and out are the TPU kernels' other operands: passed,
// never read.
__global__ void scalar_while_kernel(const int* n_live, const int* live, const float* rays,
                                    const float* bias, float* out, float* zeros,
                                    int n_zeros, int n_bars) {
  extern __shared__ __align__(16) char smem[];
  if (n_bars > 0) init_bars(smem, n_bars);
  int k = 0;
  while (k < ld_volatile(n_live)) ++k;
  if (zeros != nullptr)
    for (int i = threadIdx.x; i < n_zeros; i += blockDim.x) zeros[i] = 0.f;
}

// P4 (k_fori) and P14 (k_smemarr): the int32 list live[n_list] staged in
// shared memory after the barriers, then
//   mode 0: for k in [0, n_list): if k < n_live[0], ts = list[k];
//   mode 1: while k < n_live[0]: k += list[k] * 0 + 1
// (the TPU kernels' loops; ts is a shared scalar, the list read through
// volatile so that neither loop folds away; mode 1 reads 0 past the end
// of the list, where the TPU kernel read out of bounds).
__global__ void index_loop_kernel(const int* live, int n_list, const int* n_live,
                                  const float* rays, const float* bias, float* out,
                                  int mode, int n_bars) {
  extern __shared__ __align__(16) char smem[];
  volatile int* list = reinterpret_cast<volatile int*>(smem + 16 * n_bars);
  volatile int* ts = list + n_list;
  for (int i = threadIdx.x; i < n_list; i += blockDim.x) list[i] = live[i];
  if (n_bars > 0) {
    init_bars(smem, n_bars);
  } else {
    __syncthreads();
  }
  if (mode == 0) {
#pragma unroll 1
    for (int k = 0; k < n_list; ++k)
      if (k < ld_volatile(n_live)) ts[0] = list[k];
  } else {
    int k = 0;
    while (k < ld_volatile(n_live)) k += (k < n_list ? list[k] : 0) * 0 + 1;
  }
}

// P7 (vec_while_kernel): an [n] fp32 carry (n <= THREADS * PER) from
// zeros, c += 1 while k < trips[0] and max(c) > -1; out = c.
constexpr int VEC_PER = 32;

__global__ void vec_while_kernel(const int* trips, float* out, int n) {
  float c[VEC_PER];
#pragma unroll
  for (int i = 0; i < VEC_PER; ++i) c[i] = 0.f;
  int k = 0;
  while (true) {
    int any = 0;
#pragma unroll
    for (int i = 0; i < VEC_PER; ++i)
      any |= (threadIdx.x + i * blockDim.x < n) && c[i] > -1.f;
    // the carry's max above -1 is some element above -1
    if (!__syncthreads_or(k < ld_volatile(trips) && any)) break;
#pragma unroll
    for (int i = 0; i < VEC_PER; ++i) c[i] += 1.f;
    ++k;
  }
#pragma unroll
  for (int i = 0; i < VEC_PER; ++i) {
    int j = threadIdx.x + i * blockDim.x;
    if (j < n) out[j] = c[i];
  }
}

// P15 (k_dma): at each of trips[0] trips, rays[0:16][0:512] into shared
// memory by bulk copies on an mbarrier, rows 0-7 + 1, and those back to
// out[0:8][0:512] by bulk copies. ld is both arrays' row stride.
constexpr int DMA_COLS = 512, DMA_IN_ROWS = 16, DMA_OUT_ROWS = 8;
constexpr int DMA_ROW_BYTES = DMA_COLS * 4;
constexpr int DMA_SMEM = 16 + (DMA_IN_ROWS + DMA_OUT_ROWS) * DMA_ROW_BYTES;

__global__ void dma_loop_kernel(const int* trips, const float* rays, float* out, int ld) {
  extern __shared__ __align__(16) char smem[];
  float* rv = reinterpret_cast<float*>(smem + 16);
  float* ov = rv + DMA_IN_ROWS * DMA_COLS;
  const uint32_t bar = smem_u32(smem);
  init_bars(smem, 1);
  uint32_t parity = 0;
  for (int k = 0; k < ld_volatile(trips); ++k) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, DMA_IN_ROWS * DMA_ROW_BYTES);
      for (int r = 0; r < DMA_IN_ROWS; ++r)
        bulk_g2s(smem_u32(rv + r * DMA_COLS), rays + (size_t)r * ld, DMA_ROW_BYTES, bar);
    }
    mbar_wait(bar, parity);
    parity ^= 1;
    for (int i = threadIdx.x; i < DMA_OUT_ROWS * DMA_COLS; i += blockDim.x)
      ov[i] = rv[i] + 1.f;
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < DMA_OUT_ROWS; ++r)
        bulk_s2g(out + (size_t)r * ld, smem_u32(ov + r * DMA_COLS), DMA_ROW_BYTES);
      bulk_commit_and_wait();
    }
    __syncthreads();  // ov is rewritten only after the copy has read it
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
// drt_probe_copy and drt_probe_add_one) and returns cudaGetLastError().

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

extern "C" int drt_probe_scalar_while(const int* n_live, const int* live, const float* rays,
                                      const float* bias, float* out, float* zeros,
                                      int n_zeros, int smem_bytes, int n_bars,
                                      void* stream) {
  if (smem_bytes < 16 * n_bars) return (int)cudaErrorInvalidValue;
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
  if (n > THREADS * VEC_PER) return (int)cudaErrorInvalidValue;
  vec_while_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(trips, out, n);
  return (int)cudaGetLastError();
}

// rays [16][ld], out [8][ld] fp32, ld >= 512 and a multiple of 4 (the bulk
// copies' 16-byte alignment).
extern "C" int drt_probe_dma_loop(const int* trips, const float* rays, float* out, int ld,
                                  void* stream) {
  if (ld < DMA_COLS || ld % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(dma_loop_kernel, DMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  dma_loop_kernel<<<1, 256, DMA_SMEM, (cudaStream_t)stream>>>(trips, rays, out, ld);
  return (int)cudaGetLastError();
}

// A 64-bit count; x and out must not overlap. n <= 0 launches nothing.
extern "C" int drt_probe_copy(const float* x, float* out, long long n, void* stream) {
  return (int)launch_stream<false>(x, out, n, (cudaStream_t)stream);
}

extern "C" int drt_probe_add_one(const float* x, float* out, long long n, void* stream) {
  return (int)launch_stream<true>(x, out, n, (cudaStream_t)stream);
}
