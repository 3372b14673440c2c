// What sets dma_loop's and vec_while's time on this card (P15, P7,
// csrc/probe_launch.cu): the kernels as the port launches them, against
// their first versions, an empty launch and the designs they were chosen
// from, at the TPU scripts' shapes (P15: rays [16, 262144], out
// [8, 262144], kernel_times.py's and diag_launch3's; P7: an [8, 512]
// carry). Each is timed as a launch's device time inside a CUDA graph of
// 200 (graph_timing.cuh), in 5 rounds over all designs in turn (the
// median and each round's time reported), at P15's 0, 1 and 64 trips and
// P7's 0 and 8, and its output checked bit for bit against the plain
// versions computed on the host: P15 at 0, 1, 2 and 64 trips (rays' rows
// 0-7 + 1 in out's first 512 columns after a trip or more, every other
// value of out as it was), P7 at 0, 1, 8 and 2^20 trips (every value the
// trip count). Built and run by diag/dma_designs.py; prints one JSON line
// {"dma_loop": {design: {"us": {trips: us}, "rounds": {trips: [us]},
// "equal"}}, "vec_while": {...}}.
//
// dma_loop (blocks x threads):
//   kernel                 drt_probe_dma_loop
//   empty launch           one block of 128 threads doing nothing (P1)
//   (a) first version      1 x 256: 16 rows in, the add into a second
//                          buffer (49 KB, the attribute call at every
//                          launch), the count through ld_volatile every
//                          trip, cp.async.bulk.wait_group 0 every trip
//   (b) wait_group.read    (a) waiting only until the stores have read
//                          the buffer
//   (c) count once         (a) with the count read once, before the loop
//   (b) + (c)
//   (d) 1 x 256            one stage: 8 rows in, the add in place on
//   (e) 2 x 256 .. 16 x 64 float4s, (b) and (c), the window split over
//                          1, 2, 4, 8, 16 blocks, each with its piece's
//                          copies and its own mbarrier
//   (f) two stages         (e) 8 x 128 with trip k + 1's copy in issued at
//                          trip k's start into a second stage
//   (h) copy in first      (e) 8 x 128 with the first trip's copy in
//                          issued before the count is read (every block
//                          then waits for it, at 0 trips too)
//   (f) + (h) 4 x 256 .. 32 x 32  the kernel's body on other grids
//   (g) plain loads        yardstick, not shipped: P19's body (a float4 a
//                          thread, __ldg, 4 x 256) over the same rows, the
//                          count read once; no bulk copy
// vec_while (threads x values a thread):
//   kernel                 drt_probe_vec_while
//   empty launch
//   (a) first version      128 x 32, the count through ld_volatile every
//                          trip, the test an OR over the values below n
//   (a') count each trip   the kernel's body (values past n at -inf, no
//                          index test) with (a)'s ld_volatile count
//   (b) count in a register  the kernel's body on 128 threads x 32
//                          values, 4-byte stores
//   (c) count in shared    (b) with one thread's load published by the
//                          barrier, the shared word read every trip
//   (d) 256 x 16, 512 x 8  (b) on more threads (256 x 16: the kernel)
//   (e) 128 x 32, float4   (b) with 16-byte stores
//   (e) 256 x 16, float4

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

#include "../csrc/probe_launch.cu"
#include "graph_timing.cuh"

using namespace drt::pr;

namespace {

constexpr int LD = 512 * 512;
constexpr int CARRY = 8 * 512;              // P7's values
constexpr int WINDOW = DMA_ROWS * DMA_COLS;  // P15's floats a trip
constexpr int ROUNDS = 5;
constexpr int TRIPS[] = {0, 1, 2, 8, 64, 1 << 20};  // device words, in this order

// ---- dma_loop ---------------------------------------------------------------

constexpr int FIRST_IN_ROWS = 16, ROW_BYTES = DMA_COLS * 4;
constexpr int FIRST_SMEM = 16 + (FIRST_IN_ROWS + DMA_ROWS) * ROW_BYTES;

// The first version, with (b) and (c) as switches.
template <bool READ_WAIT, bool ONCE>
__global__ void first_dma(const int* trips, const float* rays, float* out, int ld) {
  extern __shared__ __align__(16) char smem[];
  float* rv = reinterpret_cast<float*>(smem + 16);
  float* ov = rv + FIRST_IN_ROWS * DMA_COLS;
  const uint32_t bar = smem_u32(smem);
  init_bars(smem, 1);
  const int once = ONCE ? *trips : 0;
  uint32_t parity = 0;
  for (int k = 0; k < (ONCE ? once : ld_volatile(trips)); ++k) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, FIRST_IN_ROWS * ROW_BYTES);
      for (int r = 0; r < FIRST_IN_ROWS; ++r)
        bulk_g2s(smem_u32(rv + r * DMA_COLS), rays + (size_t)r * ld, ROW_BYTES, bar);
    }
    mbar_wait(bar, parity);
    parity ^= 1;
    for (int i = threadIdx.x; i < DMA_ROWS * DMA_COLS; i += blockDim.x) ov[i] = rv[i] + 1.f;
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < DMA_ROWS; ++r)
        bulk_s2g(out + (size_t)r * ld, smem_u32(ov + r * DMA_COLS), ROW_BYTES);
      if (READ_WAIT)
        bulk_commit_and_wait_read();
      else
        asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // ov is rewritten only after the copy has read it
  }
}

// (d), (e): one stage; shared memory 16 + 4 seg.
__global__ void one_stage_dma(const int* trips, const float* rays, float* out, int ld) {
  extern __shared__ __align__(16) char smem[];
  const int n_trips = *trips;
  if (n_trips <= 0) return;
  const DmaPiece p;
  const uint32_t bar = smem_u32(smem), buf = smem_u32(smem + 16);
  init_bars(smem, 1);
  for (int k = 0; k < n_trips; ++k) {
    if (threadIdx.x == 0) dma_in(buf, rays, p, ld, bar);
    mbar_wait(bar, k & 1);
    dma_add_in_place(reinterpret_cast<float4*>(smem + 16), p.seg / 4);
    if (threadIdx.x == 0) dma_out(out, p, ld, buf);
  }
}

// (f): two stages, the count read first; shared memory 32 + 8 seg.
__global__ void two_stage_dma(const int* trips, const float* rays, float* out, int ld) {
  extern __shared__ __align__(16) char smem[];
  const int n_trips = *trips;
  if (n_trips <= 0) return;
  const DmaPiece p;
  const uint32_t bar = smem_u32(smem), buf = smem_u32(smem + 32), stage = 4 * p.seg;
  init_bars(smem, 2);
  if (threadIdx.x == 0) dma_in(buf, rays, p, ld, bar);
  for (int k = 0; k < n_trips; ++k) {
    const int s = k & 1;
    if (threadIdx.x == 0 && k + 1 < n_trips)
      dma_in(buf + (s ^ 1) * stage, rays, p, ld, bar + 16 * (s ^ 1));
    mbar_wait(bar + 16 * s, (k >> 1) & 1);
    dma_add_in_place(reinterpret_cast<float4*>(smem + 32 + s * stage), p.seg / 4);
    if (threadIdx.x == 0) dma_out(out, p, ld, buf + s * stage);
  }
}

// (h): one stage, the first copy in issued before the count is read;
// shared memory 16 + 4 seg.
__global__ void copy_first_dma(const int* trips, const float* rays, float* out, int ld) {
  extern __shared__ __align__(16) char smem[];
  const DmaPiece p;
  const uint32_t bar = smem_u32(smem), buf = smem_u32(smem + 16);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    dma_in(buf, rays, p, ld, bar);
  }
  const int n_trips = *trips;
  __syncthreads();
  for (int k = 0;; ++k) {
    mbar_wait(bar, k & 1);
    if (k >= n_trips) break;
    dma_add_in_place(reinterpret_cast<float4*>(smem + 16), p.seg / 4);
    if (threadIdx.x == 0) {
      dma_out(out, p, ld, buf);
      if (k + 1 < n_trips) dma_in(buf, rays, p, ld, bar);
    }
    if (k + 1 >= n_trips) break;
  }
}

// (g): plain loads and stores, a float4 a thread over the [8, 512] window.
__global__ void plain_rows(const int* trips, const float* __restrict__ rays,
                           float* __restrict__ out, int ld) {
  const int n_trips = *trips;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t at = (size_t)(i / (DMA_COLS / 4)) * ld + 4 * (i % (DMA_COLS / 4));
  for (int k = 0; k < n_trips; ++k)
    *reinterpret_cast<float4*>(out + at) =
        bump<true>(__ldg(reinterpret_cast<const float4*>(rays + at)));
}

// ---- vec_while --------------------------------------------------------------

// The first version.
__global__ void first_vec_while(const int* trips, float* out, int n) {
  float c[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.f;
  int k = 0;
  while (true) {
    int any = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) any |= (threadIdx.x + i * blockDim.x < n) && c[i] > -1.f;
    if (!__syncthreads_or(k < ld_volatile(trips) && any)) break;
#pragma unroll
    for (int i = 0; i < 32; ++i) c[i] += 1.f;
    ++k;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int j = threadIdx.x + i * blockDim.x;
    if (j < n) out[j] = c[i];
  }
}

enum Count { VOLATILE, REGISTER, SHARED };

// The kernel's body on T threads with the count read as COUNT says and
// 16-byte (V4) or 4-byte stores (value i of thread t: element t + i T).
template <int T, Count COUNT, bool V4>
__global__ void __launch_bounds__(T) vec_while_design(const int* trips, float* out, int n) {
  constexpr int PER = CARRY / T;
  __shared__ int word;
  int count = 0;
  if (COUNT == REGISTER) count = *trips;
  if (COUNT == SHARED) {
    if (threadIdx.x == 0) word = *trips;
    __syncthreads();
  }
  auto at = [](int i) {
    return V4 ? 4 * ((int)threadIdx.x + i / 4 * T) + i % 4 : (int)threadIdx.x + i * T;
  };
  float c[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) c[i] = at(i) < n ? 0.f : -INFINITY;
  for (int k = 0;; ++k) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < PER; ++i) any |= c[i] > -1.f;
    const int bound = COUNT == VOLATILE ? ld_volatile(trips)
                      : COUNT == REGISTER ? count
                                          : *reinterpret_cast<volatile int*>(&word);
    if (!__syncthreads_or(k < bound && any)) break;
#pragma unroll
    for (int i = 0; i < PER; ++i) c[i] += 1.f;
  }
  if (V4) {
#pragma unroll
    for (int q = 0; q < PER / 4; ++q)
      reinterpret_cast<float4*>(out)[at(4 * q) / 4] =
          make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) out[at(i)] = c[i];
  }
}

struct Design {
  std::string op, name;
  std::function<void(const int*)> launch;
  bool check;
  std::vector<std::vector<float>> us;  // [timed trip count][round]
  bool equal = true;
};

}  // namespace

int main() {
  const size_t n_rays = (size_t)16 * LD, n_out = (size_t)8 * LD;
  std::vector<float> hr(n_rays);
  srand(1);
  for (auto& v : hr) v = 2.f * rand() / RAND_MAX - 1.f;
  const int n_trips = sizeof(TRIPS) / sizeof(TRIPS[0]);
  float *rays, *out, *carry;
  int* trips;
  CK(cudaMalloc(&rays, n_rays * 4));
  CK(cudaMalloc(&out, n_out * 4));
  CK(cudaMalloc(&carry, CARRY * 4));
  CK(cudaMalloc(&trips, sizeof(TRIPS)));
  CK(cudaMemcpy(rays, hr.data(), n_rays * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(trips, TRIPS, sizeof(TRIPS), cudaMemcpyHostToDevice));
  auto word = [&](int t) {
    for (int i = 0; i < n_trips; ++i)
      if (TRIPS[i] == t) return (const int*)trips + i;
    exit(2);
  };
  cudaStream_t st;
  CK(cudaStreamCreate(&st));

  std::vector<Design> designs;
  auto d = [&](const char* op, std::string name, std::function<void(const int*)> launch,
               bool check = true) {
    designs.push_back(Design{op, name, launch, check, {}});
  };
  auto first = [&](auto kernel) {
    return [=](const int* t) {
      CK(opt_in(kernel, FIRST_SMEM));
      kernel<<<1, 256, FIRST_SMEM, st>>>(t, rays, out, LD);
    };
  };
  auto grid = [&](auto kernel, int blocks, int threads, int smem) {
    return [=](const int* t) { kernel<<<blocks, threads, smem, st>>>(t, rays, out, LD); };
  };
  const int seg = WINDOW / DMA_BLOCKS;
  d("dma_loop", "kernel",
    [=](const int* t) { CK((cudaError_t)drt_probe_dma_loop(t, rays, out, LD, st)); });
  d("dma_loop", "empty launch", [=](const int*) { empty_kernel<<<1, THREADS, 0, st>>>(rays, out); },
    false);
  d("dma_loop", "(a) first version", first(first_dma<false, false>));
  d("dma_loop", "(b) wait_group.read", first(first_dma<true, false>));
  d("dma_loop", "(c) count once", first(first_dma<false, true>));
  d("dma_loop", "(b) + (c)", first(first_dma<true, true>));
  const struct { const char* name; int blocks, threads; } one[] = {
      {"(d) 1 x 256", 1, 256}, {"(e) 2 x 256", 2, 256}, {"(e) 4 x 256", 4, 256},
      {"(e) 8 x 128", 8, 128}, {"(e) 16 x 64", 16, 64}};
  for (const auto& g : one)
    d("dma_loop", g.name, grid(one_stage_dma, g.blocks, g.threads, 16 + 4 * WINDOW / g.blocks));
  d("dma_loop", "(f) two stages", grid(two_stage_dma, DMA_BLOCKS, DMA_THREADS, 32 + 8 * seg));
  d("dma_loop", "(h) copy in first",
    grid(copy_first_dma, DMA_BLOCKS, DMA_THREADS, 16 + 4 * seg));
  const struct { const char* name; int blocks, threads; } both[] = {
      {"(f) + (h) 4 x 256", 4, 256}, {"(f) + (h) 8 x 128", 8, 128},
      {"(f) + (h) 16 x 64", 16, 64}, {"(f) + (h) 32 x 32", 32, 32}};
  for (const auto& g : both)
    d("dma_loop", g.name, grid(dma_loop_kernel, g.blocks, g.threads, 32 + 8 * WINDOW / g.blocks));
  d("dma_loop", "(g) plain loads", grid(plain_rows, 4, 256, 0));

  auto vw = [&](auto kernel, int threads) {
    return [=](const int* t) { kernel<<<1, threads, 0, st>>>(t, carry, CARRY); };
  };
  d("vec_while", "kernel",
    [=](const int* t) { CK((cudaError_t)drt_probe_vec_while(t, carry, CARRY, st)); });
  d("vec_while", "empty launch",
    [=](const int*) { empty_kernel<<<1, THREADS, 0, st>>>(carry, carry); }, false);
  d("vec_while", "(a) first version", vw(first_vec_while, 128));
  d("vec_while", "(a') count each trip", vw(vec_while_design<128, VOLATILE, false>, 128));
  d("vec_while", "(b) count in a register", vw(vec_while_design<128, REGISTER, false>, 128));
  d("vec_while", "(c) count in shared", vw(vec_while_design<128, SHARED, false>, 128));
  d("vec_while", "(d) 256 x 16", vw(vec_while_design<256, REGISTER, false>, 256));
  d("vec_while", "(d) 512 x 8", vw(vec_while_design<512, REGISTER, false>, 512));
  d("vec_while", "(e) 128 x 32, float4", vw(vec_while_design<128, REGISTER, true>, 128));
  d("vec_while", "(e) 256 x 16, float4", vw(vec_while_design<256, REGISTER, true>, 256));

  // the checks: every design at each of its op's trip counts, bit for bit
  const std::vector<int> dma_checked = {0, 1, 2, 64}, vec_checked = {0, 1, 8, 1 << 20};
  std::vector<uint32_t> got(n_out);
  for (auto& ds : designs) {
    if (!ds.check) continue;
    const bool dma = ds.op == "dma_loop";
    for (int t : dma ? dma_checked : vec_checked) {
      if (dma) {
        CK(cudaMemset(out, 0xff, n_out * 4));
      } else {
        CK(cudaMemset(carry, 0xff, CARRY * 4));
      }
      ds.launch(word(t));
      CK(cudaGetLastError());
      CK(cudaStreamSynchronize(st));
      if (dma) {
        CK(cudaMemcpy(got.data(), out, n_out * 4, cudaMemcpyDeviceToHost));
        for (size_t i = 0; i < n_out; ++i) {
          const size_t r = i / LD, c = i % LD;
          uint32_t want = 0xffffffffu;
          if (t >= 1 && c < (size_t)DMA_COLS) {
            const float v = hr[r * LD + c] + 1.f;
            std::memcpy(&want, &v, 4);
          }
          if (got[i] != want) {
            ds.equal = false;
            break;
          }
        }
      } else {
        CK(cudaMemcpy(got.data(), carry, CARRY * 4, cudaMemcpyDeviceToHost));
        const float v = (float)t;
        uint32_t want;
        std::memcpy(&want, &v, 4);
        for (int i = 0; i < CARRY; ++i) ds.equal = ds.equal && got[i] == want;
      }
    }
  }

  // rounds over every design in turn, so that each sees the same card
  const std::vector<int> dma_timed = {0, 1, 64}, vec_timed = {0, 8};
  for (int round = 0; round < ROUNDS; ++round) {
    for (auto& ds : designs) {
      const std::vector<int>& timed = ds.op == "dma_loop" ? dma_timed : vec_timed;
      ds.us.resize(timed.size());
      for (size_t j = 0; j < timed.size(); ++j) {
        const int* t = word(timed[j]);
        ds.us[j].push_back(graph_us([&] { ds.launch(t); }, st));
        CK(cudaGetLastError());
      }
    }
  }

  printf("{");
  const char* ops[] = {"dma_loop", "vec_while"};
  for (int o = 0; o < 2; ++o) {
    printf("%s\"%s\": {", o ? ", " : "", ops[o]);
    const std::vector<int>& timed = o ? vec_timed : dma_timed;
    bool first_row = true;
    for (auto& ds : designs) {
      if (ds.op != ops[o]) continue;
      printf("%s\"%s\": {\"us\": {", first_row ? "" : ", ", ds.name.c_str());
      for (size_t j = 0; j < timed.size(); ++j) {
        std::vector<float> sorted = ds.us[j];
        std::sort(sorted.begin(), sorted.end());
        printf("%s\"%d\": %.4f", j ? ", " : "", timed[j], sorted[ROUNDS / 2]);
      }
      printf("}, \"rounds\": {");
      for (size_t j = 0; j < timed.size(); ++j) {
        printf("%s\"%d\": [", j ? ", " : "", timed[j]);
        for (int r = 0; r < ROUNDS; ++r) printf("%s%.4f", r ? ", " : "", ds.us[j][r]);
        printf("]");
      }
      printf("}, \"equal\": %s}", ds.check ? (ds.equal ? "true" : "false") : "null");
      first_row = false;
    }
    printf("}");
  }
  printf("}\n");
  CK(cudaDeviceSynchronize());
  return 0;
}
