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
//     warp reserves the warp's slots (CUDA cores: no MLP work).
//   - drt_queue_generation is march_mma.cuh's tensor-core tile march over
//     the queue: 64 queued pixels a tile, each carry loaded from its pixel
//     slot, marched up to the generation's cap, stored back, and the rays
//     still active compacted into the next queue the same way. A
//     persistent grid (what fits on the card, each block striding over
//     the queue's tiles); each block reads the queue's length from device
//     memory, so no generation waits on the host.
// A queue holds one slot per ray and cannot overflow. Regrouping the
// stragglers densely after each cap keeps a tile's march (which runs to
// its slowest ray) close to its rays' own step counts. A queue tile may
// hold rays of any number of frames; each reads its own frame's biases. A
// ray's bits depend on its own carry and frame only, never on the rays
// beside it in a tile or on the queue's order, which the atomics leave
// open. The TPU kernel's one-hot bf16x3 matmul compaction was a Mosaic
// workaround; ballots and atomics are its counterpart here. What bounds
// the march is in march_mma.cuh; the queue traffic is 52 bytes per ray per
// generation.

#include "march_mma.cuh"

namespace drt {

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
  mm::append_warp(act, i, queue, count);
}

// One generation: the queue's pixels, a persistent grid.
__global__ void __launch_bounds__(pm::THREADS, 1)
queue_generation_kernel(const __grid_constant__ mm::MarchArgs a) {
  mm::march_tiles<true, true>(a);
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
// (*cnt_out zeroed by the caller). W, tiles, wrows, wscale and table as
// for K1 (batched_march.cu); bank [total][bank_stride] fp32, pixel p
// reading column p / rays_per_frame. A decoder whose plan does not fit a
// block is refused before launch. Returns cudaGetLastError().
extern "C" int drt_queue_generation(
    const float* rays, int n, int rays_per_frame, const void* W, const void* tiles,
    const void* wrows, const float* wscale, const int* table, int n_layers,
    const float* bank, int bank_stride, int final_tanh, float eps, float deps, float alpha,
    float margin, int max_steps, int kmax, float* state, const int* q_in, const int* cnt_in,
    int* q_out, int* cnt_out, void* stream) {
  using namespace drt;
  mm::MarchArgs a;
  cudaError_t err = mm::march_args(rays, n, rays_per_frame, W, tiles, wrows, wscale, table,
                                   n_layers, bank, bank_stride, final_tanh, eps, deps, alpha,
                                   margin, max_steps, 1, &a);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (rays_per_frame <= 0 || kmax <= 0) return (int)cudaErrorInvalidValue;
  a.kmax = kmax;
  a.state = state;
  a.q_in = q_in;
  a.cnt_in = cnt_in;
  a.q_out = q_out;
  a.cnt_out = cnt_out;
  return mm::launch(queue_generation_kernel, true, (n + pm::M - 1) / pm::M, a, stream);
}
