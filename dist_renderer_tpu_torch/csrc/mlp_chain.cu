// The MLP chain probe: STEPS chained evaluations of an n_layers x width
// ReLU MLP on every column of x, in bf16 (P23) and in int8 (P24).
// Counterparts of scripts/diag_int8.py's make_bf16_kernel (:59) and
// make_int8_kernel (:82), both launched at :129.
//
// Per step, with h0 the fp32 carry of a column:
//   bf16: h = bf16(h0); per layer h = bf16(relu(W_l . h)), fp32 sums;
//   int8: h = int8(clip(rint(16 h0), -127, 127)); per layer, int32 sums,
//         h = int8(clip(rint(acc / 512), 0, 127));
//   then h0 = h0 + 0.125 h / (1 + |h|) in fp32 (IEEE division; the build's
//   -fmad=false keeps the multiply and the add apart, as the plain
//   version computes them).
// The int8 chain is exact: its sums are integers below 2^24, and the
// requantization and carry are fp32 operations the plain version repeats,
// so the two agree bit for bit. The bf16 chain sums in the tensor cores'
// order, and a sum near a bf16 rounding boundary can round the other way.
//
// Design: each block owns a [width, 64] column tile for all steps; its
// carry (fp32) and its activations (bf16 or int8, each column's values
// contiguous, rows padded so that the warps' fragment loads hit distinct
// banks) stay in shared memory (198 KB at width 512 in bf16, 165 KB in
// int8). Eight warps each produce 16 * MT output rows for the 64 columns
// with mma.sync (m16n8k16 bf16 or m16n8k32 s8: the same instruction
// family, so the two chains compare like for like), the weights' A
// fragments read straight from L2 (8 x 512 KB in bf16 at width 512, read
// by every block). Bound: at the defaults (8 layers of 512 x 512, 32
// steps, 32,768 columns) 2.2e12 multiply-adds: 4.45 ms at the bf16 dense
// peak, 2.22 ms at the int8 one; bytes are far below (0.04 ms). wgmma and
// a shared weight ring are later work, as they were for K1-K6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace drt {
namespace mc {

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
  return h0 + 0.125f * hf / (1.f + fabsf(hf));
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
int launch(const float* x, const void* w, float* out, int cols, int n_layers, int steps,
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

template <bool INT8>
int launch_width(const float* x, const void* w, float* out, int width, int cols,
                 int n_layers, int steps, void* stream) {
  if (cols <= 0 || cols % COLS != 0 || n_layers <= 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  switch (width) {
    case 128: return launch<INT8, 1>(x, w, out, cols, n_layers, steps, stream);
    case 256: return launch<INT8, 2>(x, w, out, cols, n_layers, steps, stream);
    case 384: return launch<INT8, 3>(x, w, out, cols, n_layers, steps, stream);
    case 512: return launch<INT8, 4>(x, w, out, cols, n_layers, steps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mc
}  // namespace drt

// x, out [width][cols] fp32; w [n_layers][width][width] (bf16 for P23,
// int8 for P24), W[o][i] multiplying input row i into output row o;
// width in {128, 256, 384, 512}, cols a multiple of 64. Launches on the
// caller's stream and returns cudaGetLastError().
extern "C" int drt_mlp_chain_bf16(const float* x, const void* w, float* out, int width,
                                  int cols, int n_layers, int steps, void* stream) {
  return drt::mc::launch_width<false>(x, w, out, width, cols, n_layers, steps, stream);
}

extern "C" int drt_mlp_chain_int8(const float* x, const void* w, float* out, int width,
                                  int cols, int n_layers, int steps, void* stream) {
  return drt::mc::launch_width<true>(x, w, out, width, cols, n_layers, steps, stream);
}

// The dynamic shared memory a block of either chain asks for.
extern "C" int drt_mlp_chain_smem(int width, int int8) {
  return drt::mc::smem_bytes(width, int8 != 0);
}
