// What sets copy's and add_one's time on this card (P18, P19,
// csrc/probe_launch.cu): the kernels as the port launches them, against
// their first version, an empty launch and the grids they were chosen
// from, at the TPU script's [8, 512] fp32. Each is timed as a launch's
// device time inside a CUDA graph of 200 (the median of 5 replays), in
// 5 rounds over all designs in turn (the median and each round's time
// reported), and its output checked bit for bit (copy: x's bits; add_one:
// x + 1.0f computed on the host). Built and run by diag/copy_designs.py;
// prints one JSON line {"copy": {design: {"us", "rounds", "equal"}},
// "add_one": {...}}.
//
//   kernel                 drt_probe_copy / drt_probe_add_one
//   kernel, a new output each launch  the same, each of the graph's 200
//                          launches into its own output (as a graph of
//                          PyTorch calls allocates them)
//   empty launch           one block of 128 threads doing nothing (P1)
//   first version          one block of 256, 4-byte accesses, no
//                          __restrict__ (the kernel before this design)
//   first version, restrict  the same with __restrict__ pointers
//   1 x 1024 x 1           blocks x threads x float4s a thread, every
//   4 x 256 x 1            load issued before any store
//   8 x 128 x 1
//   16 x 64 x 1
//   1 x 256 x 4
//   2 x 128 x 4
//   memcpy node            cudaMemcpyAsync device to device (copy only:
//                          what a contiguous clone() becomes in a graph),
//                          also into a new output each launch

#include <algorithm>
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

constexpr int N = 8 * 512;
constexpr int POOL = 200;  // launches a graph, and outputs for the fresh-output designs
constexpr int ROUNDS = 5;

__global__ void first_copy(const float* x, float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i];
}

__global__ void first_add(const float* x, float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i] + 1.f;
}

__global__ void first_copy_restrict(const float* __restrict__ x, float* __restrict__ out,
                                    int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i];
}

__global__ void first_add_restrict(const float* __restrict__ x, float* __restrict__ out,
                                   int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i] + 1.f;
}

// PER float4s a thread, every load issued before any store (the
// kernel's body at PER = 1, without its grid stride and its tail)
template <bool ADD, int PER>
__global__ void per_thread(const float* __restrict__ x, float* __restrict__ out) {
  const float4* __restrict__ xs = reinterpret_cast<const float4*>(x);
  float4* __restrict__ os = reinterpret_cast<float4*>(out);
  const int base = blockIdx.x * blockDim.x * PER + threadIdx.x;
  float4 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = __ldg(xs + base + j * blockDim.x);
#pragma unroll
  for (int j = 0; j < PER; ++j) os[base + j * blockDim.x] = bump<ADD>(v[j]);
}

}  // namespace

int main() {
  std::vector<float> hx(N), want_add(N);
  srand(1);
  for (auto& v : hx) v = 2.f * rand() / RAND_MAX - 1.f;
  for (int i = 0; i < N; ++i) want_add[i] = hx[i] + 1.f;
  float *x, *pool;
  CK(cudaMalloc(&x, N * 4));
  CK(cudaMalloc(&pool, (size_t)POOL * N * 4));
  CK(cudaMemcpy(x, hx.data(), N * 4, cudaMemcpyHostToDevice));
  cudaStream_t st;
  CK(cudaStreamCreate(&st));
  struct Design {
    std::string op, name;
    std::function<void(float*)> launch;
    bool fresh, check;
    std::vector<float> us;
    bool equal = true;
  };
  std::vector<Design> designs;
  const struct { const char* name; int blocks, threads, per; } grids[] = {
      {"1 x 1024 x 1", 1, 1024, 1}, {"4 x 256 x 1", 4, 256, 1},
      {"8 x 128 x 1", 8, 128, 1},   {"16 x 64 x 1", 16, 64, 1},
      {"1 x 256 x 4", 1, 256, 4},   {"2 x 128 x 4", 2, 128, 4}};
  for (int add = 0; add < 2; ++add) {
    const std::string op = add ? "add_one" : "copy";
    auto d = [&](const char* name, std::function<void(float*)> launch, bool fresh = false,
                 bool check = true) {
      designs.push_back(Design{op, name, launch, fresh, check, {}});
    };
    auto kernel = [=](float* o) {
      CK((cudaError_t)(add ? drt_probe_add_one(x, o, N, st) : drt_probe_copy(x, o, N, st)));
    };
    d("kernel", kernel);
    d("kernel, a new output each launch", kernel, true);
    d("empty launch", [=](float* o) { empty_kernel<<<1, THREADS, 0, st>>>(x, o); }, false,
      false);
    void (*v1)(const float*, float*, int) = add ? first_add : first_copy;
    void (*v1r)(const float*, float*, int) = add ? first_add_restrict : first_copy_restrict;
    d("first version", [=](float* o) { v1<<<1, 256, 0, st>>>(x, o, N); });
    d("first version, restrict", [=](float* o) { v1r<<<1, 256, 0, st>>>(x, o, N); });
    for (const auto& gr : grids) {
      void (*body)(const float*, float*) =
          gr.per == 1 ? (add ? &per_thread<true, 1> : &per_thread<false, 1>)
                      : (add ? &per_thread<true, 4> : &per_thread<false, 4>);
      const int blocks = gr.blocks, threads = gr.threads;
      d(gr.name, [=](float* o) { body<<<blocks, threads, 0, st>>>(x, o); });
    }
    if (!add) {
      auto memcpy_node = [=](float* o) {
        CK(cudaMemcpyAsync(o, x, N * 4, cudaMemcpyDeviceToDevice, st));
      };
      d("memcpy node", memcpy_node);
      d("memcpy node, a new output each launch", memcpy_node, true);
    }
  }
  // rounds over every design in turn, so that each sees the same card
  for (int round = 0; round < ROUNDS; ++round) {
    for (auto& ds : designs) {
      CK(cudaMemset(pool, 0xff, (size_t)POOL * N * 4));
      int k = 0;
      ds.us.push_back(graph_us([&] { ds.launch(pool + (ds.fresh ? k++ % POOL : 0) * N); }, st,
                               POOL));
      CK(cudaGetLastError());
      if (!ds.check || round) continue;
      const std::vector<float>& want = ds.op == "add_one" ? want_add : hx;
      std::vector<float> h(N);
      for (int i = 0; i < (ds.fresh ? POOL : 1); ++i) {
        CK(cudaMemcpy(h.data(), pool + (size_t)i * N, N * 4, cudaMemcpyDeviceToHost));
        ds.equal = ds.equal && std::memcmp(h.data(), want.data(), N * 4) == 0;
      }
    }
  }
  printf("{");
  for (int add = 0; add < 2; ++add) {
    printf("%s\"%s\": {", add ? ", " : "", add ? "add_one" : "copy");
    bool first = true;
    for (auto& ds : designs) {
      if (ds.op != (add ? "add_one" : "copy")) continue;
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
