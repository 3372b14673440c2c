// What sets scalar_while's and index_loop's time on this card (P3-P6,
// P11-P14, csrc/probe_launch.cu): the kernels as the port launches them,
// against their first versions, an empty launch and the designs between,
// at the TPU scripts' shapes: P6's body (scalar_while with the [8, 128]
// zero write, no scratch), P14's (index_loop mode 1 on a 512-entry list)
// and P4's (index_loop mode 0 on a 512-entry list, three mbarriers and
// the march kernels' shared-memory plan, the program's argument). Each is
// timed as a launch's device time inside a CUDA graph (graph_timing.cuh;
// 200 launches, 20 at 16,384 trips), in 5 rounds over all designs in turn
// (the median and each round's time reported), P6's and P14's bodies at
// 0, 1, 64, 512, 1,024 and 16,384 trips, P4's at n_live 0 and 512, and
// each is checked at every count it is timed at against its plain
// version: the zeros written (bit for bit, over a buffer of 0xff bytes),
// every input and the never-written output as they were. Then the card's
// dependent shared-load latency: one thread chasing indices through
// shared memory, in a graph at 0 and 16,384 loads and in SM cycles
// (clock64). Built and run by diag/loop_designs.py; prints one JSON line
// {"scalar_while": {design: {"us": {trips: us}, "rounds": {trips: [us]},
// "equal"}}, "index_loop mode 1": {...}, "index_loop mode 0": {...},
// "chase": {"us": {loads: us}, "cycles_per_load"}, "clock_khz"}.
//
// Designs (one block of 128 threads):
//   kernel                 drt_probe_scalar_while, drt_probe_index_loop
//   empty launch           P1
//   (a) first version      the bound through ld_volatile (device memory)
//                          at every trip, all four warps looping; P6's
//                          zeros after the loop by 4-byte stores, the list
//                          staged by 4-byte loads
//   (b) shared bound       the bound loaded once by thread 0 into a shared
//                          word, published by the barrier, read at every
//                          trip by a volatile shared load; four warps loop
//   (c) one warp           (b) with warp 0 alone looping (scalar_while's
//                          kernel, which publishes the word by __syncwarp,
//                          not the block's barrier)
//   (c) 4-byte zeros       (c) with P6's zeros by 4-byte stores
//   (d) int4 staging       (c) with the list staged by int4 loads, one a
//                          thread
//   (e) register bound     yardstick, not shipped: (d) with the bound in a
//                          register and k stepped in an asm statement by
//                          blockDim.y (a loop that reads no bound would
//                          otherwise fold into k = max(n, 0)): the loop
//                          machinery alone
//   (h) entry read with    (d) with the list entry read beside the bound,
//       the bound          before the compare (mode 1 at min(k, n_list));
//                          mode 0's copy to ts under the compare (mode 1:
//                          index_loop's kernel)
//   (i) two inner loops    mode 0: (d) with the trips that copy and those
//                          that do not in two loops, the copy's read only
//                          where it is stored
//   (j) (h) unrolled by 4  mode 0: (h) with its fixed trip loop (over the
//                          list, not the bound) unrolled by 4 (index_loop's
//                          kernel)
//   kernel, no scratch set P4's body without its three mbarriers and the
//                          march plan's shared memory

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

constexpr int LIST = 512;                 // the scripts' list
constexpr int ZEROS = 8 * 128;            // P5/P6's output
constexpr int OUT = 8 * 512;              // an output no body writes
constexpr int ROUNDS = 5;
constexpr int TRIPS[] = {0, 1, 64, 512, 1024, 16384};  // device words, in this order
constexpr int LONG = 16384;               // timed in a graph of 20
constexpr int CHASE_WORDS = 1024;

// ---- the first versions ------------------------------------------------------

__global__ void first_scalar_while(const int* n_live, float* zeros, int n_zeros) {
  int k = 0;
  while (k < ld_volatile(n_live)) ++k;
  for (int i = threadIdx.x; i < n_zeros; i += blockDim.x) zeros[i] = 0.f;
}

__global__ void first_index_loop(const int* live, int n_list, const int* n_live, int mode,
                                 int n_bars) {
  extern __shared__ __align__(16) char smem[];
  volatile int* list = reinterpret_cast<volatile int*>(smem + 16 * n_bars);
  volatile int* ts = list + n_list;
  for (int i = threadIdx.x; i < n_list; i += blockDim.x) list[i] = live[i];
  init_bars(smem, n_bars);
  if (mode == 0) {
#pragma unroll 1
    for (int k = 0; k < n_list; ++k)
      if (k < ld_volatile(n_live)) ts[0] = list[k];
  } else {
    int k = 0;
    while (k < ld_volatile(n_live)) k += (k < n_list ? list[k] : 0) * 0 + 1;
  }
}

// ---- the designs -------------------------------------------------------------

enum Bound { SHARED, REGISTER };

template <Bound B>
__device__ __forceinline__ int bound_at(const int* word, int reg) {
  return B == SHARED ? lds_volatile(word) : reg;
}

// k += by; with the bound in a register, by times blockDim.y (1 at run
// time, unknown to the compiler) in an asm statement, so that neither
// nvcc nor ptxas can close the loop's form.
template <Bound B>
__device__ __forceinline__ void step(int& k, int by = 1) {
  if (B == REGISTER)
    asm volatile("add.s32 %0, %0, %1;\n" : "+r"(k) : "r"(by * (int)blockDim.y));
  else
    k += by;
}

// Loads the bound: thread 0 into the shared word, or every thread into
// its register.
template <Bound B>
__device__ __forceinline__ int load_bound(const int* n_live, int* word) {
  if (B == REGISTER) return *n_live;
  if (threadIdx.x == 0) *word = *n_live;
  return 0;
}

// (b), (c), (e) of scalar_while with P6's zeros (float4 or 4-byte
// stores) before the loop.
template <Bound B, bool ONE_WARP, bool V4>
__global__ void while_design(const int* n_live, float* zeros, int n_zeros) {
  __shared__ int word;
  const int reg = load_bound<B>(n_live, &word);
  if (V4) {
    for (int i = threadIdx.x; i < n_zeros / 4; i += blockDim.x)
      reinterpret_cast<float4*>(zeros)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < n_zeros; i += blockDim.x) zeros[i] = 0.f;
  }
  __syncthreads();
  if (ONE_WARP && threadIdx.x >= 32) return;
  int k = 0;
  while (k < bound_at<B>(&word, reg)) step<B>(k);
  if (B == REGISTER) *reinterpret_cast<volatile int*>(&word) = k;  // k stays live
}

// The trip bodies of index_design: as the kernel's; EAGER, the list entry
// read beside the bound (mode 1: at min(k, n_list), within the list and
// ts) before the compare, mode 0's copy to ts under it; SPLIT (mode 0),
// the trips that copy and those that do not in two inner loops, each
// reading the bound once a trip (twice where one gives way to the other).
enum Body { AS_KERNEL, EAGER, SPLIT, EAGER4 };

// (b)-(e), (h), (i) of index_loop: the list staged by int4 (V4) or 4-byte
// loads.
template <Bound B, bool ONE_WARP, bool V4, Body BODY = AS_KERNEL>
__global__ void index_design(const int* live, int n_list, const int* n_live, int mode,
                             int n_bars) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int word;
  int* list = reinterpret_cast<int*>(smem + 16 * n_bars);
  const int reg = load_bound<B>(n_live, &word);
  if (V4) {
    for (int i = threadIdx.x; i < n_list / 4; i += blockDim.x)
      reinterpret_cast<int4*>(list)[i] = __ldg(reinterpret_cast<const int4*>(live) + i);
  } else {
    for (int i = threadIdx.x; i < n_list; i += blockDim.x) list[i] = live[i];
  }
  init_bars(smem, n_bars);
  if (ONE_WARP && threadIdx.x >= 32) return;
  const volatile int* vlist = list;
  volatile int* ts = list + n_list;
  if (BODY == EAGER && mode == 0) {
#pragma unroll 1
    for (int k = 0; k < n_list; ++k) {
      const int e = vlist[k];
      if (k < lds_volatile(&word)) ts[0] = e;
    }
  } else if (BODY == EAGER4 && mode == 0) {
#pragma unroll 4
    for (int k = 0; k < n_list; ++k) {
      const int e = vlist[k];
      if (k < lds_volatile(&word)) ts[0] = e;
    }
  } else if (BODY == EAGER || BODY == EAGER4) {
    for (int k = 0;; ++k) {
      const int b = lds_volatile(&word);
      const int e = vlist[min(k, n_list)];
      if (k >= b) break;
      k += e * 0;
    }
  } else if (BODY == SPLIT && mode == 0) {
    int k = 0;
    while (k < n_list) {
      if (k < lds_volatile(&word)) {
        do ts[0] = vlist[k++];
        while (k < n_list && k < lds_volatile(&word));
      } else {
        do ++k;
        while (k < n_list && k >= lds_volatile(&word));
      }
    }
  } else if (mode == 0) {
#pragma unroll 1
    for (int k = 0; k < n_list; step<B>(k))
      if (k < bound_at<B>(&word, reg)) ts[0] = vlist[k];
  } else {
    int k = 0;
    while (k < bound_at<B>(&word, reg)) step<B>(k, (k < n_list ? vlist[k] : 0) * 0 + 1);
  }
}

// The dependent shared-load latency: thread 0 walks a cycle through
// CHASE_WORDS shared words, steps[0] volatile loads, each one's address
// the value of the one before; the SM cycles it took into out[0], where
// it ended into out[1].
__global__ void chase(const int* steps, long long* out) {
  __shared__ int next[CHASE_WORDS];
  for (int i = threadIdx.x; i < CHASE_WORDS; i += blockDim.x)
    next[i] = (i + 97) % CHASE_WORDS;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int n = *steps;
  int p = 0;
  const long long t0 = clock64();
  for (int s = 0; s < n; ++s) p = lds_volatile(next + p);
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = p;
}

struct Design {
  std::string op, name;
  std::function<void(const int*)> launch;
  bool check;
  std::vector<std::vector<float>> us;  // [timed count][round]
  bool equal = true;
};

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: loop_designs <P4's shared-memory bytes>\n");
    return 2;
  }
  const int plan = atoi(argv[1]);
  const int n_trips = sizeof(TRIPS) / sizeof(TRIPS[0]);
  std::vector<int> hlive(LIST);
  srand(1);
  for (auto& v : hlive) v = 1 + rand() % (LIST - 1);
  std::vector<float> hout(OUT);
  for (auto& v : hout) v = 2.f * rand() / RAND_MAX - 1.f;
  int *trips, *live;
  float *zeros, *out;
  long long* chase_out;
  CK(cudaMalloc(&trips, sizeof(TRIPS)));
  CK(cudaMalloc(&live, LIST * 4));
  CK(cudaMalloc(&zeros, ZEROS * 4));
  CK(cudaMalloc(&out, OUT * 4));
  CK(cudaMalloc(&chase_out, 16));
  CK(cudaMemcpy(trips, TRIPS, sizeof(TRIPS), cudaMemcpyHostToDevice));
  CK(cudaMemcpy(live, hlive.data(), LIST * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(out, hout.data(), OUT * 4, cudaMemcpyHostToDevice));
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
  const char* SW = "scalar_while";
  d(SW, "kernel", [=](const int* t) {
    CK((cudaError_t)drt_probe_scalar_while(t, nullptr, nullptr, nullptr, nullptr, zeros,
                                           ZEROS, 0, 0, st));
  });
  d(SW, "empty launch", [=](const int*) { empty_kernel<<<1, THREADS, 0, st>>>(zeros, zeros); },
    false);
  auto sw = [&](auto kernel) {
    return [=](const int* t) { kernel<<<1, THREADS, 0, st>>>(t, zeros, ZEROS); };
  };
  d(SW, "(a) first version", sw(first_scalar_while));
  d(SW, "(b) shared bound", sw(while_design<SHARED, false, true>));
  d(SW, "(c) one warp", sw(while_design<SHARED, true, true>));
  d(SW, "(c) 4-byte zeros", sw(while_design<SHARED, true, false>));
  d(SW, "(e) register bound", sw(while_design<REGISTER, true, true>));

  // index_loop: mode 1 (P14: no scratch) and mode 0 (P4: three mbarriers
  // and the plan's shared memory)
  const char* OPS[] = {"index_loop mode 1", "index_loop mode 0"};
  for (int mode = 1; mode >= 0; --mode) {
    const char* op = OPS[1 - mode];
    const int n_bars = mode ? 0 : 3, smem = mode ? 4 * (LIST + 1) : plan;
    d(op, "kernel", [=](const int* t) {
      CK((cudaError_t)drt_probe_index_loop(live, LIST, t, nullptr, nullptr, out, mode, smem,
                                           n_bars, st));
    });
    d(op, "empty launch",
      [=](const int*) { empty_kernel<<<1, THREADS, 0, st>>>(zeros, zeros); }, false);
    auto il = [&](auto kernel) {
      return [=](const int* t) {
        CK(opt_in(kernel, smem));
        kernel<<<1, THREADS, smem, st>>>(live, LIST, t, mode, n_bars);
      };
    };
    d(op, "(a) first version", il(first_index_loop));
    d(op, "(b) shared bound", il(index_design<SHARED, false, false>));
    d(op, "(c) one warp", il(index_design<SHARED, true, false>));
    d(op, "(d) int4 staging", il(index_design<SHARED, true, true>));
    d(op, "(e) register bound", il(index_design<REGISTER, true, true>));
    d(op, "(h) entry read with the bound", il(index_design<SHARED, true, true, EAGER>));
    if (mode == 0) {
      d(op, "(i) two inner loops", il(index_design<SHARED, true, true, SPLIT>));
      d(op, "(j) (h) unrolled by 4", il(index_design<SHARED, true, true, EAGER4>));
    }
    if (mode == 0)
      d(op, "kernel, no scratch set", [=](const int* t) {
        CK((cudaError_t)drt_probe_index_loop(live, LIST, t, nullptr, nullptr, out, 0,
                                             4 * (LIST + 1), 0, st));
      });
  }
  auto timed = [&](const std::string& op) {
    return op == "index_loop mode 0" ? std::vector<int>{0, 512}
                                     : std::vector<int>{0, 1, 64, 512, 1024, LONG};
  };

  // the checks: every design at each of its timed counts
  std::vector<uint32_t> got(OUT);
  std::vector<int> gi(LIST);
  for (auto& ds : designs) {
    if (!ds.check) continue;
    for (int t : timed(ds.op)) {
      CK(cudaMemset(zeros, 0xff, ZEROS * 4));
      ds.launch(word(t));
      CK(cudaGetLastError());
      CK(cudaStreamSynchronize(st));
      if (ds.op == SW) {
        CK(cudaMemcpy(got.data(), zeros, ZEROS * 4, cudaMemcpyDeviceToHost));
        for (int i = 0; i < ZEROS; ++i) ds.equal = ds.equal && got[i] == 0u;
      }
      CK(cudaMemcpy(got.data(), out, OUT * 4, cudaMemcpyDeviceToHost));
      ds.equal = ds.equal && std::memcmp(got.data(), hout.data(), OUT * 4) == 0;
      CK(cudaMemcpy(gi.data(), live, LIST * 4, cudaMemcpyDeviceToHost));
      ds.equal = ds.equal && gi == hlive;
      CK(cudaMemcpy(gi.data(), trips, sizeof(TRIPS), cudaMemcpyDeviceToHost));
      ds.equal = ds.equal && std::memcmp(gi.data(), TRIPS, sizeof(TRIPS)) == 0;
    }
  }

  // rounds over every design in turn, so that each sees the same card
  for (int round = 0; round < ROUNDS; ++round) {
    for (auto& ds : designs) {
      const std::vector<int> ts = timed(ds.op);
      ds.us.resize(ts.size());
      for (size_t j = 0; j < ts.size(); ++j) {
        const int* t = word(ts[j]);
        ds.us[j].push_back(graph_us([&] { ds.launch(t); }, st, ts[j] == LONG ? 20 : 200));
        CK(cudaGetLastError());
      }
    }
  }

  // the chase: in a graph at 0 and LONG loads, and in SM cycles at LONG
  std::vector<float> chase_us;
  for (int t : {0, LONG})
    chase_us.push_back(graph_us([&] { chase<<<1, THREADS, 0, st>>>(word(t), chase_out); }, st,
                                t == LONG ? 20 : 200));
  long long hc[2];
  chase<<<1, THREADS, 0, st>>>(word(LONG), chase_out);
  CK(cudaGetLastError());
  CK(cudaMemcpy(hc, chase_out, 16, cudaMemcpyDeviceToHost));
  int clock_khz = 0;
  CK(cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0));

  printf("{");
  const char* ops[] = {"scalar_while", "index_loop mode 1", "index_loop mode 0"};
  for (int o = 0; o < 3; ++o) {
    printf("%s\"%s\": {", o ? ", " : "", ops[o]);
    const std::vector<int> ts = timed(ops[o]);
    bool first_row = true;
    for (auto& ds : designs) {
      if (ds.op != ops[o]) continue;
      printf("%s\"%s\": {\"us\": {", first_row ? "" : ", ", ds.name.c_str());
      for (size_t j = 0; j < ts.size(); ++j) {
        std::vector<float> sorted = ds.us[j];
        std::sort(sorted.begin(), sorted.end());
        printf("%s\"%d\": %.4f", j ? ", " : "", ts[j], sorted[ROUNDS / 2]);
      }
      printf("}, \"rounds\": {");
      for (size_t j = 0; j < ts.size(); ++j) {
        printf("%s\"%d\": [", j ? ", " : "", ts[j]);
        for (int r = 0; r < ROUNDS; ++r) printf("%s%.4f", r ? ", " : "", ds.us[j][r]);
        printf("]");
      }
      printf("}, \"equal\": %s}", ds.check ? (ds.equal ? "true" : "false") : "null");
      first_row = false;
    }
    printf("}");
  }
  printf(", \"chase\": {\"us\": {\"0\": %.4f, \"%d\": %.4f}, \"cycles_per_load\": %.3f, "
         "\"end\": %lld}, \"clock_khz\": %d}\n",
         chase_us[0], LONG, chase_us[1], (double)hc[0] / LONG, hc[1], clock_khz);
  CK(cudaDeviceSynchronize());
  return 0;
}
