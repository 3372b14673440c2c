// What sets the MLP chains' time on this card (P23, P24,
// csrc/mlp_chain.cu): the kernels as the port launches them, against their
// first version and the design steps between, at diag_int8's defaults (8
// layers of 512 x 512, 32 steps, 32,768 columns), in both precisions; the
// parts of the shipped design alone; and the L2 read rate the weight
// stream draws on. Each design is timed with CUDA events around one
// launch (the median of 3 after a warm-up) and its output compared with
// the plain version's (computed by diag/chain_designs.py on the card and
// passed in files): the largest |difference| and whether it is bit for
// bit. Built and run by diag/chain_designs.py:
//
//   chain_designs DIR    (DIR holds x, wb, wi, ref_bf16, ref_int8 as raw arrays)
//
// prints one JSON line {"bf16": {design: {"ms", "max_abs_err", "equal"}},
// "int8": {...}, "l2": {probe: {"ms", "tb_s"}}}.
//
//   (a) first version      the first kernel: a block per 64 columns, 8 warps
//                          of mma.sync, the weights' A fragments straight
//                          from L2, the fp32 carry in shared memory
//   (b) ring, mma.sync     the shipped ring and producer (64 columns a
//                          block), 4 warps of mma.sync reading the weights
//                          from the ring with ldmatrix
//   (c) ring, wgmma        64 columns a block (one consumer warpgroup)
//   (d) clusters of 2, 4   (c) with each tile multicast to the cluster
//   (e) 128 columns        two consumer warpgroups a block, the second
//                          starting LAG tiles behind the first; alone
//                          (shipped) and in clusters of 2 and 4; the two in
//                          lockstep; chunks of 256 output rows, not 128
//   (f) overlap            (e) alone with each chunk's epilogue run under
//                          the next chunk's first MMAs
//   parts                  (e) alone with only the ring's copies
//                          and waits; the MMAs and epilogues on a ring that
//                          is never filled; the MMAs alone (their sums kept
//                          by one compare a chunk); the epilogues alone on
//                          zero sums (their outputs are not the chain's)
//   l2: ldg                every SM's block reads one 4 MB weight set 8
//                          times, 16 bytes a thread a load (1024 threads)
//   l2: bulk               the same with cp.async.bulk, 32 KB a copy, 4 in
//                          flight a block

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "../csrc/mlp_chain.cu"
#include "../csrc/mma_sync.cuh"
#include "graph_timing.cuh"

namespace {

constexpr int LAYERS = 8, WIDTH = 512, COLUMNS = 32768, STEPS = 32;

// ---- (a) the first version -------------------------------------------------

namespace first {

using drt::ms::ld32;

constexpr int COLS = 64;    // columns a block owns
constexpr int WARPS = 8;    // each owns width / 8 output rows
constexpr int THREADS = 32 * WARPS;
constexpr int NT = COLS / 8;  // n-tiles of 8 columns

__host__ __device__ constexpr int act_stride(int width, bool int8) {
  return int8 ? width + 16 : width + 8;  // elements; 16 bytes of padding
}

__host__ __device__ constexpr int carry_stride(int width) { return width + 1; }

__host__ __device__ constexpr int smem_bytes(int width, bool int8) {
  return COLS * act_stride(width, int8) * (int8 ? 1 : 2) + COLS * carry_stride(width) * 4;
}

__device__ __forceinline__ float carry_step(float h0, float hf) {
  return h0 + drt::mc::increment(hf);
}

template <bool INT8, int MT>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_chain_kernel(const float* x, const void* w, float* out, int cols, int n_layers,
                     int steps) {
  constexpr int WIDTH = 128 * MT;
  constexpr int AS = act_stride(WIDTH, INT8), CS = carry_stride(WIDTH);
  constexpr int KS = INT8 ? 32 : 16;  // k per mma
  constexpr int ESIZE = INT8 ? 1 : 2;
  extern __shared__ __align__(16) char smem[];
  char* act = smem;
  float* carry = reinterpret_cast<float*>(smem + COLS * AS * ESIZE);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16 * MT;
  const int col0 = blockIdx.x * COLS;

  for (int i = threadIdx.x; i < WIDTH * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    carry[c * CS + r] = x[(size_t)r * cols + col0 + c];
  }
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    for (int i = threadIdx.x; i < WIDTH * COLS; i += THREADS) {
      const int c = i / WIDTH, r = i % WIDTH;
      const float h0 = carry[c * CS + r];
      if constexpr (INT8) {
        const float q = fminf(fmaxf(rintf(h0 * 16.f), -127.f), 127.f);
        reinterpret_cast<int8_t*>(act)[c * AS + r] = (int8_t)q;
      } else {
        reinterpret_cast<__nv_bfloat16*>(act)[c * AS + r] = __float2bfloat16_rn(h0);
      }
    }
    __syncthreads();
    for (int layer = 0; layer < n_layers; ++layer) {
      const char* wl = static_cast<const char*>(w) + (size_t)layer * WIDTH * WIDTH * ESIZE;
      float accf[MT][NT][4];
      int acci[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            accf[mt][nt][q] = 0.f;
            acci[mt][nt][q] = 0;
          }
#pragma unroll 1
      for (int k0 = 0; k0 < WIDTH; k0 += KS) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = row0 + mt * 16 + g + 8 * (q & 1);
            const int k = k0 + (INT8 ? 4 * t + 16 * (q >> 1) : 2 * t + 8 * (q >> 1));
            a[mt][q] = ld32(wl + ((size_t)row * WIDTH + k) * ESIZE);
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b[2];
          const char* col = act + (size_t)(nt * 8 + g) * AS * ESIZE;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int k = k0 + (INT8 ? 4 * t + 16 * q : 2 * t + 8 * q);
            b[q] = ld32(col + k * ESIZE);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (INT8)
              drt::ms::mma_s8_16832(acci[mt][nt], a[mt], b);
            else
              drt::ms::mma_bf16_16816(accf[mt][nt], a[mt], b);
          }
        }
      }
      __syncthreads();  // every warp has read this layer's input
      const bool last = layer == n_layers - 1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = row0 + mt * 16 + g + 8 * (q >> 1);
            const int c = nt * 8 + 2 * t + (q & 1);
            float hf;
            if constexpr (INT8) {
              const float f = (float)acci[mt][nt][q] * (1.f / 512.f);
              hf = fminf(fmaxf(rintf(f), 0.f), 127.f);
              if (!last) reinterpret_cast<int8_t*>(act)[c * AS + r] = (int8_t)hf;
            } else {
              const __nv_bfloat16 h = __float2bfloat16_rn(fmaxf(accf[mt][nt][q], 0.f));
              hf = __bfloat162float(h);
              if (!last) reinterpret_cast<__nv_bfloat16*>(act)[c * AS + r] = h;
            }
            if (last) carry[c * CS + r] = carry_step(carry[c * CS + r], hf);
          }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < WIDTH * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    out[(size_t)r * cols + col0 + c] = carry[c * CS + r];
  }
}

template <bool INT8, int MT>
int launch_first(const float* x, const void* w, float* out, int cols, int n_layers, int steps,
           void* stream) {
  const int bytes = smem_bytes(128 * MT, INT8);
  auto kernel = mlp_chain_kernel<INT8, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<cols / COLS, THREADS, bytes, (cudaStream_t)stream>>>(x, w, out, cols, n_layers,
                                                                steps);
  return (int)cudaGetLastError();
}

}  // namespace first

// ---- (b) the ring with mma.sync ---------------------------------------------

using drt::mc::Args;
using drt::mc::Ring;
template <bool INT8>
using CfgB = drt::mc::Cfg<INT8, WIDTH, 1, 1, 256>;  // the shipped ring, chunks of 256 rows

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The layer's value and, after the last layer, the carry update of one
// accumulator element; returns the next layer's (or step's) input as its
// bits.
template <bool INT8, typename T>
__device__ __forceinline__ uint32_t sync_value(T v, bool last, float h0, float* dst, bool live) {
  float h = INT8 ? fminf(fmaxf(rintf((float)v * (1.f / 512.f)), 0.f), 127.f)
                 : __bfloat162float(__float2bfloat16_rn(fmaxf((float)v, 0.f)));
  if (last) {
    h = h0 + drt::mc::increment(h);
    if (live) *dst = h;
    return drt::mc::quantize<INT8>(h);
  }
  return INT8 ? (uint32_t)(uint8_t)(int8_t)h : drt::mc::quantize<false>(h);
}

template <bool INT8>
__device__ __forceinline__ void put_one(unsigned char* act, int c, int k, uint32_t v) {
  if constexpr (INT8)
    act[drt::mc::act_off<true>(c, k)] = (unsigned char)v;
  else
    *reinterpret_cast<uint16_t*>(act + drt::mc::act_off<false>(c, k)) = (uint16_t)v;
}

// Warp w of the consumer warpgroup: output rows n0 + 64 w .. + 64 of a
// 256-row chunk for the block's 64 columns, m16n8k16 (bf16) or m16n8k32
// (int8) with the weights as A (ldmatrix from the swizzled ring tile) and
// the activations as B (32-bit shared loads).
template <bool INT8>
__device__ void sync_consume(const Args& a, unsigned char* act, Ring ring) {
  using C = CfgB<INT8>;
  using T = typename std::conditional<INT8, int, float>::type;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const size_t col = (size_t)blockIdx.x * 64;
  const bool live = col < (size_t)a.cols;
  for (int i = t; i < WIDTH * 64; i += 128) {
    const int k = i / 64, c = i % 64;
    put_one<INT8>(act, c, k, drt::mc::quantize<INT8>(live ? a.x[(size_t)k * a.cols + col + c] : 0.f));
  }
  drt::mc::wg_sync(0);
  for (int step = 0; step < a.steps; ++step) {
    const float* src = step == 0 ? a.x : a.out;
    for (int layer = 0; layer < a.n_layers; ++layer) {
      const bool last = layer == a.n_layers - 1;
      uint32_t hold[4][8][2];
      for (int chunk = 0; chunk < 2; ++chunk) {
        T acc[4][8][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
#pragma unroll 1
        for (int kb = 0; kb < C::KB; ++kb) {
          drt::mc::mbar_wait(ring.full + 8 * ring.stage, ring.phase);
          const uint32_t tile = ring.base + ring.stage * C::STAGE;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t af[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              const int row = 64 * warp + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
              const int ch = 2 * kk + (lane >> 4);
              ldmatrix_x4(af[mt], tile + row * 128 + ((ch ^ (row & 7)) << 4));
            }
            const int kbyte = (4 * kb + kk) * 32;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int c = 8 * nt + g;  // act_off<true> takes a byte of k
              const uint32_t b[2] = {drt::ms::ld32(act + drt::mc::act_off<true>(c, kbyte + 4 * q)),
                                     drt::ms::ld32(act + drt::mc::act_off<true>(c, kbyte + 16 + 4 * q))};
#pragma unroll
              for (int mt = 0; mt < 4; ++mt) {
                if constexpr (INT8)
                  drt::ms::mma_s8_16832(acc[mt][nt], af[mt], b);
                else
                  drt::ms::mma_bf16_16816(acc[mt][nt], af[mt], b);
              }
            }
          }
          drt::pm::mbar_arrive(ring.empty + 8 * ring.stage, lane == 0);
          if (++ring.stage == C::STAGES) {
            ring.stage = 0;
            ring.phase ^= 1u;
          }
        }
        // element (mt, nt, e): output row n0 + 64 warp + 16 mt + g + 8 (e >> 1),
        // column 8 nt + 2 q + (e & 1)
        const int n0 = 256 * chunk;
        if (chunk == 1) drt::mc::wg_sync(0);  // every warp has read this layer's input
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = n0 + 64 * warp + 16 * mt + g + 8 * h, c = 8 * nt + 2 * q;
              uint32_t v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const size_t at = (size_t)o * a.cols + col + c + e;
                v[e] = sync_value<INT8>(acc[mt][nt][2 * h + e], last,
                                        last && live ? src[at] : 0.f, a.out + at, live);
              }
              if (chunk == 0) {
                hold[mt][nt][h] = v[0] | v[1] << 16;
              } else {
                put_one<INT8>(act, c, o, v[0]);
                put_one<INT8>(act, c + 1, o, v[1]);
                const int o0 = o - 256;
                put_one<INT8>(act, c, o0, hold[mt][nt][h] & 0xffffu);
                put_one<INT8>(act, c + 1, o0, hold[mt][nt][h] >> 16);
              }
            }
      }
      drt::mc::wg_sync(0);
    }
  }
}

template <bool INT8>
__global__ void __launch_bounds__(CfgB<INT8>::THREADS, 1) sync_chain(const __grid_constant__ Args a) {
  using C = CfgB<INT8>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (drt::pm::smem_u32(smem_raw) & 1023)) & 1023);
  Ring ring;
  ring.base = drt::pm::smem_u32(smem);
  ring.full = drt::pm::smem_u32(smem + C::STAGES * C::STAGE + C::ACT);
  ring.empty = ring.full + 8 * C::STAGES;
  ring.stage = 0;
  ring.phase = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      drt::pm::mbar_init(ring.full + 8 * s, 1);
      drt::pm::mbar_init(ring.empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) drt::mc::produce<CfgB<INT8>>(a, ring);
  } else {
    sync_consume<INT8>(a, smem + C::STAGES * C::STAGE, ring);
  }
}

template <bool INT8>
cudaError_t launch_sync(const float* x, const void* w, float* out, cudaStream_t st) {
  using C = CfgB<INT8>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      sync_chain<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  Args a;
  cudaError_t err = drt::mc::weight_map(&a.wmap, w, INT8, WIDTH, LAYERS, 1);
  if (err != cudaSuccess) return err;
  a.x = x;
  a.out = out;
  a.cols = COLUMNS;
  a.n_layers = LAYERS;
  a.steps = STEPS;
  sync_chain<INT8><<<COLUMNS / 64, C::THREADS, C::SMEM, st>>>(a);
  return cudaGetLastError();
}

// ---- the L2 read rate ---------------------------------------------------------

constexpr int L2_PASSES = 8;
constexpr size_t L2_BYTES = (size_t)LAYERS * WIDTH * WIDTH * 2;  // 4 MB

// Every block reads the whole set, starting at a block-staggered offset.
__global__ void __launch_bounds__(1024) l2_ldg(const uint4* w, unsigned* sink) {
  constexpr size_t n = L2_BYTES / 16;
  uint32_t acc = 0;
  const size_t off = (size_t)blockIdx.x * (n / gridDim.x);
  for (int p = 0; p < L2_PASSES; ++p)
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
      const uint4 v = __ldg(w + (i + off) % n);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  if (acc == 0x9e3779b9u) sink[0] = acc;  // keeps the loads
}

// The same with one thread's bulk copies into a ring of 4 x 32 KB.
__global__ void l2_bulk(const char* w) {
  constexpr int ST = 4, CH = 32768;
  constexpr int n = (int)(L2_BYTES / CH);
  extern __shared__ __align__(1024) unsigned char sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + ST * CH);
  if (threadIdx.x != 0) return;
  for (int s = 0; s < ST; ++s) drt::pm::mbar_init(drt::pm::smem_u32(bars + s), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const int off = blockIdx.x * (n / gridDim.x);
  for (int i = 0; i < L2_PASSES * n; ++i) {
    const int s = i % ST;
    const uint32_t bar = drt::pm::smem_u32(bars + s);
    if (i >= ST) drt::pm::mbar_wait(bar, (uint32_t)((i / ST - 1) & 1));
    drt::pm::mbar_expect_tx(bar, CH);
    drt::pm::bulk_copy(drt::pm::smem_u32(sm + s * CH), w + (size_t)((i + off) % n) * CH, CH, bar);
  }
  for (int i = L2_PASSES * n; i < L2_PASSES * n + ST; ++i)
    drt::pm::mbar_wait(drt::pm::smem_u32(bars + i % ST), (uint32_t)((i / ST - 1) & 1));
}

// ---- main -------------------------------------------------------------------------

std::vector<char> read_file(const std::string& path, size_t bytes) {
  std::vector<char> v(bytes);
  FILE* f = fopen(path.c_str(), "rb");
  if (f == nullptr || fread(v.data(), 1, bytes, f) != bytes) {
    fprintf(stderr, "cannot read %s\n", path.c_str());
    exit(1);
  }
  fclose(f);
  return v;
}

// One launch's ms: the median of 3 after a warm-up (whose output is checked).
template <typename F>
float launch_ms(F launch, cudaStream_t st) {
  CK(launch());
  CK(cudaStreamSynchronize(st));
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  std::vector<float> ts;
  for (int rep = 0; rep < 3; ++rep) {
    CK(cudaEventRecord(a, st));
    CK(launch());
    CK(cudaEventRecord(b, st));
    CK(cudaEventSynchronize(b));
    float ms;
    CK(cudaEventElapsedTime(&ms, a, b));
    ts.push_back(ms);
  }
  CK(cudaEventDestroy(a));
  CK(cudaEventDestroy(b));
  std::sort(ts.begin(), ts.end());
  return ts[1];
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: chain_designs DIR\n");
    return 2;
  }
  const std::string dir = argv[1];
  const size_t nx = (size_t)WIDTH * COLUMNS, nw = (size_t)LAYERS * WIDTH * WIDTH;
  const auto hx = read_file(dir + "/x", nx * 4);
  const auto hwb = read_file(dir + "/wb", nw * 2);
  const auto hwi = read_file(dir + "/wi", nw);
  const auto hrb = read_file(dir + "/ref_bf16", nx * 4);
  const auto hri = read_file(dir + "/ref_int8", nx * 4);
  float *x, *out;
  void *wb, *wi;
  CK(cudaMalloc(&x, nx * 4));
  CK(cudaMalloc(&out, nx * 4));
  CK(cudaMalloc(&wb, nw * 2));
  CK(cudaMalloc(&wi, nw));
  CK(cudaMemcpy(x, hx.data(), nx * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(wb, hwb.data(), nw * 2, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(wi, hwi.data(), nw, cudaMemcpyHostToDevice));
  cudaStream_t st;
  CK(cudaStreamCreate(&st));
  std::vector<float> got(nx);

  printf("{");
  for (int kind = 0; kind < 2; ++kind) {
    const bool int8 = kind == 1;
    const void* w = int8 ? wi : wb;
    const float* ref = reinterpret_cast<const float*>(int8 ? hri.data() : hrb.data());
    printf("%s\"%s\": {", kind ? ", " : "", int8 ? "int8" : "bf16");
    bool first_row = true;
    auto row = [&](const char* name, bool check, auto launch) {
      CK(cudaMemset(out, 0, nx * 4));
      const float ms = launch_ms(launch, st);
      double e = 0;
      bool equal = true;
      if (check) {
        CK(cudaMemcpy(got.data(), out, nx * 4, cudaMemcpyDeviceToHost));
        for (size_t i = 0; i < nx; ++i) {
          const double d = std::fabs((double)got[i] - (double)ref[i]);
          if (!(d <= e)) e = std::isnan(d) ? INFINITY : d;
          equal = equal && memcmp(&got[i], &ref[i], 4) == 0;
        }
      }
      printf("%s\"%s\": {\"ms\": %.4f", first_row ? "" : ", ", name, ms);
      if (check) printf(", \"max_abs_err\": %.4e, \"equal\": %s", e, equal ? "true" : "false");
      printf("}");
      first_row = false;
      fflush(stdout);
    };
    namespace mc = drt::mc;
    const int C = COLUMNS, L = LAYERS, S = STEPS;
#define DESIGN(WGS, CL, BN, PH)                                                          \
  [&] {                                                                                  \
    return (cudaError_t)(int8 ? mc::launch<mc::Cfg<true, WIDTH, WGS, CL, BN>, PH>(        \
                                    x, w, out, C, L, S, st)                              \
                              : mc::launch<mc::Cfg<false, WIDTH, WGS, CL, BN>, PH>(       \
                                    x, w, out, C, L, S, st));                            \
  }
    row("kernel", true, [&] {
      return (cudaError_t)(int8 ? drt_mlp_chain_int8(x, w, out, WIDTH, C, L, S, st)
                                : drt_mlp_chain_bf16(x, w, out, WIDTH, C, L, S, st));
    });
    row("(a) first version", true, [&] {
      return (cudaError_t)(int8 ? first::launch_first<true, 4>(x, w, out, C, L, S, st)
                                : first::launch_first<false, 4>(x, w, out, C, L, S, st));
    });
    row("(b) ring, mma.sync, 64 columns", true,
        [&] { return int8 ? launch_sync<true>(x, w, out, st) : launch_sync<false>(x, w, out, st); });
    row("(c) ring, wgmma, 64 columns", true, DESIGN(1, 1, 128, mc::BOTH));
    row("(d) 64 columns, cluster of 2", true, DESIGN(1, 2, 128, mc::BOTH));
    row("(d) 64 columns, cluster of 4", true, DESIGN(1, 4, 128, mc::BOTH));
    row("(e) 128 columns", true, DESIGN(2, 1, 128, mc::BOTH));
    row("(e) 128 columns, warpgroups in lockstep", true,
        [&] {
          return (cudaError_t)(int8 ? mc::launch<mc::Cfg<true, WIDTH, 2, 1, 128, false, false>>(
                                          x, w, out, C, L, S, st)
                                    : mc::launch<mc::Cfg<false, WIDTH, 2, 1, 128, false, false>>(
                                          x, w, out, C, L, S, st));
        });
    row("(e) 128 columns, cluster of 2", true, DESIGN(2, 2, 128, mc::BOTH));
    row("(e) 128 columns, cluster of 4", true, DESIGN(2, 4, 128, mc::BOTH));
    row("(e) 128 columns, chunks of 256 rows", true, DESIGN(2, 1, 256, mc::BOTH));
    row("(f) 128 columns, epilogue under the next chunk", true,
        [&] {
          return (cudaError_t)(int8 ? mc::launch<mc::Cfg<true, WIDTH, 2, 1, 128, true>>(
                                          x, w, out, C, L, S, st)
                                    : mc::launch<mc::Cfg<false, WIDTH, 2, 1, 128, true>>(
                                          x, w, out, C, L, S, st));
        });
    row("(e) 128 columns, copies only", false, DESIGN(2, 1, 128, mc::RING));
    row("(e) 128 columns, MMAs and epilogues", false, DESIGN(2, 1, 128, mc::MATH));
    row("(e) 128 columns, MMAs only", false, DESIGN(2, 1, 128, mc::MMA));
    row("(e) 128 columns, epilogues only", false, DESIGN(2, 1, 128, mc::EPI));
#undef DESIGN
    printf("}");
  }
  unsigned* sink;
  CK(cudaMalloc(&sink, 4));
  int sms = 0;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  const double bytes = (double)sms * L2_BYTES * L2_PASSES;
  const float ldg = launch_ms([&] {
    l2_ldg<<<sms, 1024, 0, st>>>(reinterpret_cast<const uint4*>(wb), sink);
    return cudaGetLastError();
  }, st);
  const int bulk_smem = 4 * 32768 + 64;
  CK(cudaFuncSetAttribute(l2_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, bulk_smem));
  const float bulk = launch_ms([&] {
    l2_bulk<<<sms, 32, bulk_smem, st>>>(reinterpret_cast<const char*>(wb));
    return cudaGetLastError();
  }, st);
  printf(", \"l2\": {\"ldg\": {\"ms\": %.4f, \"tb_s\": %.4f}, \"bulk\": {\"ms\": %.4f, \"tb_s\": %.4f}}",
         ldg, bytes / (ldg * 1e-3) / 1e12, bulk, bytes / (bulk * 1e-3) / 1e12);
  printf("}\n");
  CK(cudaDeviceSynchronize());
  return 0;
}
