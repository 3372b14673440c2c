// K2: the work-queue fine march.
//
// Replaces the JAX package's TPU kernel
// dist_renderer_tpu/ops/pallas/queue_march.py::queue_march
// (_make_queue_kernel).
//
// Computes: one full-budget bracket-secant march (salvage on) of every
// active ray, run as generations. Rays pause at each generation's step cap
// and resume from their 12-float carry; the step is Markov in the carry,
// so the result equals K1's bit for bit.
//
// Design: the carry lives in pixel order in global memory (state [12][n]);
// a queue is a dense list of pixel indices.
//   - drt_queue_seed writes every ray's fresh carry and compacts the
//     active rays into queue 0: a warp ballot, then one atomicAdd per
//     warp reserves the warp's slots.
//   - drt_queue_generation marches the queued rays, TILE per block, up to
//     the generation's cap, writes each carry back to its pixel slot and
//     compacts the rays still active into the next queue the same way.
//     The block count is what fits on the card; each block reads the
//     queue length from device memory, so no generation waits on the host.
// A queue holds one slot per ray and cannot overflow. Regrouping the
// stragglers densely after each cap keeps a tile's march (which runs to
// its slowest ray) close to its rays' own step counts. The TPU kernel's
// one-hot bf16x3 matmul compaction was a Mosaic workaround; ballots and
// atomics are its counterpart here. What bounds the march is in
// march_body.cuh; the queue traffic is 52 bytes per ray per generation.

#include "march_body.cuh"

namespace drt {

__device__ __forceinline__ void append_warp(bool flag, int value, int* queue,
                                            int* count) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (m == 0u) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (flag) queue[base + __popc(m & ((1u << lane) - 1u))] = value;
}

__global__ void queue_seed_kernel(const float* __restrict__ rays, int n,
                                  float* __restrict__ state, int* queue,
                                  int* count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool act = false;
  if (i < n) {
    const Carry c = fresh_carry(rays[6 * n + i], rays[9 * n + i]);
    store_carry(c, state, n, i);
    act = c.act > 0.5f;
  }
  append_warp(act, i, queue, count);
}

__global__ void __launch_bounds__(NTHREADS)
queue_generation_kernel(const float* __restrict__ rays, int n,
                        int rays_per_frame, Decoder dec,
                        const __nv_bfloat16* __restrict__ W,
                        const float* __restrict__ bank, int bank_stride,
                        MarchParams mp, int kmax, float* __restrict__ state,
                        const int* __restrict__ q_in, const int* cnt_in,
                        int* __restrict__ q_out, int* cnt_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float s_x[3 * TILE];
  __shared__ float s_sdf[TILE];
  __shared__ int s_frame[TILE];
  const int t = threadIdx.x;
  const int count = *cnt_in;  // written by the previous launch on the stream
  for (long long tile = blockIdx.x; tile * TILE < count; tile += gridDim.x) {
    const int i = (int)(tile * TILE) + t;
    const bool mine = t < TILE && i < count;
    const int pix = mine ? q_in[i] : 0;
    float o[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
    float near_lo = 0.0f, far = 0.0f;
    Carry c = fresh_carry(0.0f, 0.0f);
    if (mine) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        o[a] = rays[a * n + pix];
        v[a] = rays[(3 + a) * n + pix];
      }
      c = load_carry(state, n, pix);
      near_lo = rays[7 * n + pix] - mp.margin;
      far = rays[8 * n + pix];
    }
    if (t < TILE) s_frame[t] = mine ? pix / rays_per_frame : 0;
    march_tile(dec, W, bank, bank_stride, mp, kmax, c, o, v, near_lo, far,
               s_frame, s_x, s_h, s_sdf);
    if (mine) store_carry(c, state, n, pix);
    if (t < 32) append_warp(mine && c.act > 0.5f, pix, q_out, cnt_out);
  }
}

}  // namespace drt

// rays [16][n]; state [12][n] (written); queue [n] int32; count [1] int32
// (zeroed by the caller). Returns cudaGetLastError().
extern "C" int drt_queue_seed(const float* rays, int n, float* state,
                              int* queue, int* count, void* stream) {
  using namespace drt;
  if (n <= 0) return (int)cudaGetLastError();
  const int block = 256;
  queue_seed_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      rays, n, state, queue, count);
  return (int)cudaGetLastError();
}

// One generation: march the rays listed in q_in[0:*cnt_in] for at most
// kmax steps (salvage on, budget max_steps), append survivors to q_out
// (*cnt_out zeroed by the caller). Returns cudaGetLastError().
extern "C" int drt_queue_generation(
    const float* rays, int n, int rays_per_frame, const void* W,
    const int* table, int n_layers, const float* bank, int bank_stride,
    int final_tanh, float eps, float deps, float alpha, float margin,
    int max_steps, int kmax, float* state, const int* q_in, const int* cnt_in,
    int* q_out, int* cnt_out, void* stream) {
  using namespace drt;
  Decoder dec;
  cudaError_t err = make_decoder(table, n_layers, final_tanh, &dec);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (rays_per_frame <= 0 || kmax <= 0) return (int)cudaErrorInvalidValue;
  const MarchParams mp{eps, deps, alpha, margin, max_steps, 1};
  const size_t smem = march_smem_bytes(dec);
  err = cudaFuncSetAttribute(queue_generation_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = persistent_grid(queue_generation_kernel, smem,
                                   (n + TILE - 1) / TILE);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  queue_generation_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      rays, n, rays_per_frame, dec, static_cast<const __nv_bfloat16*>(W), bank,
      bank_stride, mp, kmax, state, q_in, cnt_in, q_out, cnt_out);
  return (int)cudaGetLastError();
}
