// What sets f32dot's time on this card (P8, csrc/probe_blocks.cu): the
// kernel against its own phases and against the designs it was chosen
// over, at the TPU script's shape, x [24, 512] times m [1024, 512]^T in
// fp32. Each is timed as a launch's device time inside a CUDA graph of
// 200 (the median of 5 replays) and checked against an fp64 sum of the
// same seeded operands. Built and run by diag/f32dot_designs.py; prints
// one JSON line {design: {"us": ..., "max_abs_err": ...}}.
//
//   kernel                 drt_probe_f32dot, as the port launches it
//   launch only            its grid and shared memory, no copies, no sums
//   copies only            its cp.async staging, no sums
//   sums only              its chains on unstaged shared memory
//   sums unrolled by the compiler  the chains 4 k a step, a fixed trip
//                          count left to the compiler to schedule (the
//                          kernel issues each next 16 k's loads by hand)
//   copies a division each the staging one (row, 4 k) item a thread at a
//                          time, a runtime division each (the first
//                          staging of this design)
//   ring of 2              two 128-k stages, one in flight while one is summed
//   bulk copies            the staging as cp.async.bulk rows on 4 mbarriers
//   x multicast 2          the same, x's rows multicast to a cluster of 2
//   split K, 8 warps       each warp 64 k of 24 x 8 outputs (rows g + 8i,
//                          columns 2t, 2t + 1), partials summed in warp order
//   split K, cluster of 4  each CTA of a cluster 128 k of 24 x 32 outputs,
//                          partials summed in rank order over distributed
//                          shared memory
//
// The designs other than the kernel take the one shape (K = 512, S a
// multiple of 32) and check nothing else.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../csrc/probe_blocks.cu"
#include "graph_timing.cuh"

using namespace drt::pb;

namespace {

constexpr int R = 24, K = 512, S = 1024;
constexpr int ST = K + 4;  // the kernel's row stride at K = 512

// The chains one 4 k at a time over a whole 128-k group, a fixed trip
// count the compiler unrolls and schedules (the kernel prefetches by hand).
__device__ __forceinline__ void chains_unrolled(const float* xr, const float* m0r,
                                                const float* m1r, int lo, float& a0,
                                                float& a1) {
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int kk = lo + 4 * j;
    const float4 xv = *reinterpret_cast<const float4*>(xr + kk);
    const float4 u = *reinterpret_cast<const float4*>(m0r + kk);
    const float4 v = *reinterpret_cast<const float4*>(m1r + kk);
    a0 = fmaf(xv.x, u.x, a0);
    a1 = fmaf(xv.x, v.x, a1);
    a0 = fmaf(xv.y, u.y, a0);
    a1 = fmaf(xv.y, v.y, a1);
    a0 = fmaf(xv.z, u.z, a0);
    a1 = fmaf(xv.z, v.z, a1);
    a0 = fmaf(xv.w, u.w, a0);
    a1 = fmaf(xv.w, v.w, a1);
  }
}

// The kernel's loop at K = 512 with its phases switched on and off
// (LOAD: the copies, SUM: the chains), with the chains left to the
// compiler (UNROLLED), or with the copies indexed one (row, 4 k) item a
// thread at a time, a division each (DIVIDE: the staging the kernel had
// first).
template <bool LOAD, bool SUM, bool UNROLLED, bool DIVIDE>
__global__ void __launch_bounds__(DOT_THREADS) phases(const float* x, const float* mat,
                                                      float* out, int quads) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;
  float* ms = sm + R * ST;
  const int tid = threadIdx.x, r = tid >> 2, c = 2 * (tid & 3), c0 = blockIdx.x * 8;
  const int warp = tid >> 5, lane = tid & 31;
  for (int gi = 0; gi < 4; ++gi) {
    if (LOAD && DIVIDE) {
      for (int i = tid; i < (R + 8) * quads; i += DOT_THREADS) {
        const int row = i / quads, kk = gi * 128 + 4 * (i - row * quads);
        const float* src = row < R ? x + row * K + kk : mat + (size_t)(c0 + row - R) * K + kk;
        cp_async16(sm + row * ST + kk, src, 16);
      }
    } else if (LOAD) {
      const int kk = gi * 128 + 4 * lane;
      for (int row = warp; row < R + 8; row += DOT_THREADS / 32) {
        const float* src = row < R ? x + row * K + kk : mat + (size_t)(c0 + row - R) * K + kk;
        cp_async16(sm + row * ST + kk, src, 16);
      }
    }
    cp_async_commit();
  }
  float a0 = 0.f, a1 = 0.f;
  const float* xr = xs + r * ST;
  const float* m0r = ms + c * ST;
  const float* m1r = m0r + ST;
  for (int gi = 0; gi < 4; ++gi) {
    cp_async_wait(3 - gi);
    __syncthreads();
    if (!SUM || r >= R) continue;
    if (UNROLLED)
      chains_unrolled(xr, m0r, m1r, gi * 128, a0, a1);
    else
      dot_chains(xr, m0r, m1r, gi * 128, gi * 128 + 128, a0, a1);
  }
  if (!SUM) a0 = a1 = xr[0];
  if (r < R) {
    out[r * S + c0 + c] = a0;
    out[r * S + c0 + c + 1] = a1;
  }
}

// Two 128-k stages: group g + 1 in flight while group g is summed.
__global__ void __launch_bounds__(DOT_THREADS) ring2(const float* x, const float* mat,
                                                     float* out) {
  constexpr int GS = 128 + 4;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, r = tid >> 2, c = 2 * (tid & 3), c0 = blockIdx.x * 8;
  auto issue = [&](int g) {
    float* base = sm + (g & 1) * (R + 8) * GS;
    for (int i = tid; i < (R + 8) * 32; i += DOT_THREADS) {
      const int row = i >> 5, kk = 4 * (i & 31);
      const float* src = row < R ? x + row * K + g * 128 + kk
                                 : mat + (size_t)(c0 + row - R) * K + g * 128 + kk;
      cp_async16(base + row * GS + kk, src, 16);
    }
    cp_async_commit();
  };
  issue(0);
  float a0 = 0.f, a1 = 0.f;
  for (int g = 0; g < 4; ++g) {
    __syncthreads();
    if (g < 3) issue(g + 1);
    else cp_async_commit();
    cp_async_wait(1);
    __syncthreads();
    const float* base = sm + (g & 1) * (R + 8) * GS;
    if (r < R)
      dot_chains(base + r * GS, base + (R + c) * GS, base + (R + c + 1) * GS, 0, 128, a0, a1);
  }
  if (r < R) {
    out[r * S + c0 + c] = a0;
    out[r * S + c0 + c + 1] = a1;
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The staging as one bulk copy per row and 128-k group, completing on
// the group's mbarrier; with CL > 1, x's rows multicast to a cluster of
// CL blocks (block `rank` issues the rows r % CL == rank).
template <int CL>
__global__ void __launch_bounds__(DOT_THREADS) bulk(const float* x, const float* mat,
                                                    float* out) {
  extern __shared__ __align__(16) float sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  float* xs = sm + 16;
  float* ms = xs + R * ST;
  const int tid = threadIdx.x, r = tid >> 2, c = 2 * (tid & 3), c0 = blockIdx.x * 8;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  if (tid == 0) {
    for (int g = 0; g < 4; ++g) mbar_init(smem_u32(bars + g));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (CL > 1) cluster_sync();
  if (tid < 32) {
    if (tid == 0)
      for (int g = 0; g < 4; ++g) mbar_expect_tx(smem_u32(bars + g), (R + 8) * 512);
    __syncwarp();
    for (int i = tid; i < 4 * (R + 8); i += 32) {
      const int g = i / (R + 8), row = i - g * (R + 8);
      const uint32_t bar = smem_u32(bars + g);
      if (row < R) {
        if (row % CL != rank) continue;
        const uint32_t dst = smem_u32(xs + row * ST + g * 128);
        const float* src = x + row * K + g * 128;
        if (CL > 1)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
              ".multicast::cluster [%0], [%1], 512, [%2], %3;\n" ::"r"(dst),
              "l"(src), "r"(bar), "h"((uint16_t)((1 << CL) - 1))
              : "memory");
        else
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
              "[%0], [%1], 512, [%2];\n" ::"r"(dst),
              "l"(src), "r"(bar)
              : "memory");
      } else {
        const int cc = row - R;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], 512, [%2];\n" ::"r"(smem_u32(ms + cc * ST + g * 128)),
            "l"(mat + (size_t)(c0 + cc) * K + g * 128), "r"(bar)
            : "memory");
      }
    }
  }
  float a0 = 0.f, a1 = 0.f;
  for (int g = 0; g < 4; ++g) {
    mbar_wait(smem_u32(bars + g));
    if (r < R) dot_chains(xs + r * ST, ms + c * ST, ms + (c + 1) * ST, g * 128, g * 128 + 128, a0, a1);
  }
  if (r < R) {
    out[r * S + c0 + c] = a0;
    out[r * S + c0 + c + 1] = a1;
  }
  if (CL > 1) cluster_sync();
}

// K split over the block's 8 warps: warp w stages and sums k in [64 w,
// 64 w + 64) for all 24 x 8 outputs, lane (g, t) rows g, g + 8, g + 16
// and columns 2t, 2t + 1; the partials summed in warp order.
__global__ void __launch_bounds__(256) split_warps(const float* x, const float* mat,
                                                   float* out) {
  constexpr int SL = 64, SS = SL + 4;
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * 8;
  float* xs = sm + warp * (R + 8) * SS;
  float* ms = xs + R * SS;
  for (int row = 0; row < R + 8; ++row)
    if (lane < SL / 4) {
      const int kk = warp * SL + 4 * lane;
      const float* src = row < R ? x + row * K + kk : mat + (size_t)(c0 + row - R) * K + kk;
      cp_async16(xs + row * SS + 4 * lane, src, 16);
    }
  cp_async_commit();
  cp_async_wait(0);
  __syncwarp();
  float acc[3][2] = {};
  for (int kk = 0; kk < SL; kk += 4) {
    const float4 u = *reinterpret_cast<const float4*>(ms + (2 * t) * SS + kk);
    const float4 v = *reinterpret_cast<const float4*>(ms + (2 * t + 1) * SS + kk);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + (g + 8 * i) * SS + kk);
      acc[i][0] = fmaf(xv.x, u.x, acc[i][0]);
      acc[i][1] = fmaf(xv.x, v.x, acc[i][1]);
      acc[i][0] = fmaf(xv.y, u.y, acc[i][0]);
      acc[i][1] = fmaf(xv.y, v.y, acc[i][1]);
      acc[i][0] = fmaf(xv.z, u.z, acc[i][0]);
      acc[i][1] = fmaf(xv.z, v.z, acc[i][1]);
      acc[i][0] = fmaf(xv.w, u.w, acc[i][0]);
      acc[i][1] = fmaf(xv.w, v.w, acc[i][1]);
    }
  }
  __syncthreads();
  float* red = sm;  // [8 warps][24][8]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    red[(warp * R + g + 8 * i) * 8 + 2 * t] = acc[i][0];
    red[(warp * R + g + 8 * i) * 8 + 2 * t + 1] = acc[i][1];
  }
  __syncthreads();
  if (threadIdx.x < R * 8) {
    const int o = threadIdx.x;
    float v = red[o];
    for (int w = 1; w < 8; ++w) v = v + red[w * R * 8 + o];
    out[(o >> 3) * S + c0 + (o & 7)] = v;
  }
}

// K split over a cluster of 4 CTAs: CTA (column group of 32, rank q) sums
// k in [128 q, 128 q + 128) for 24 x 32 outputs (thread t: columns
// 2 (t % 16), +1, rows t / 16 + 8 i), and the ranks' partials are summed
// in rank order, each rank a quarter of the outputs, over distributed
// shared memory.
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(128)
    split_cluster(const float* x, const float* mat, float* out) {
  constexpr int QC = 32, QS = 128 + 4;
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;
  float* ms = sm + R * QS;
  float* part = ms + QC * QS;
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int rank = (int)cluster_rank(), c0 = (blockIdx.x >> 2) * QC, lo = rank * 128;
  for (int i = tid; i < (R + QC) * 32; i += 128) {
    const int row = i >> 5, kk = 4 * (i & 31);
    const float* src = row < R ? x + row * K + lo + kk : mat + (size_t)(c0 + row - R) * K + lo + kk;
    cp_async16(xs + row * QS + kk, src, 16);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  float acc[3][2] = {};
  const float* m0r = ms + (2 * cp) * QS;
  const float* m1r = m0r + QS;
  for (int kk = 0; kk < 128; kk += 4) {
    const float4 u = *reinterpret_cast<const float4*>(m0r + kk);
    const float4 v = *reinterpret_cast<const float4*>(m1r + kk);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + (rg + 8 * i) * QS + kk);
      acc[i][0] = fmaf(xv.x, u.x, acc[i][0]);
      acc[i][1] = fmaf(xv.x, v.x, acc[i][1]);
      acc[i][0] = fmaf(xv.y, u.y, acc[i][0]);
      acc[i][1] = fmaf(xv.y, v.y, acc[i][1]);
      acc[i][0] = fmaf(xv.z, u.z, acc[i][0]);
      acc[i][1] = fmaf(xv.z, v.z, acc[i][1]);
      acc[i][0] = fmaf(xv.w, u.w, acc[i][0]);
      acc[i][1] = fmaf(xv.w, v.w, acc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    part[(rg + 8 * i) * QC + 2 * cp] = acc[i][0];
    part[(rg + 8 * i) * QC + 2 * cp + 1] = acc[i][1];
  }
  cluster_sync();
  const uint32_t pa = smem_u32(part);
  for (int o = rank * 128 + tid; o < R * QC; o += 4 * 128) {
    float v = 0.f;
    for (int q = 0; q < 4; ++q) {
      uint32_t at;
      float pv;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(at) : "r"(pa + 4 * o), "r"(q));
      asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(pv) : "r"(at) : "memory");
      v = q ? v + pv : pv;
    }
    out[(o / QC) * S + c0 + o % QC] = v;
  }
  cluster_sync();
}

template <typename KER>
cudaError_t launch_cluster(KER kernel, int blocks, int threads, int smem, int cl,
                           cudaStream_t st, const float* x, const float* m, float* o) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, m, o);
}

}  // namespace

int main() {
  std::vector<float> hx(R * K), hm(S * K);
  srand(1);
  for (auto& v : hx) v = 2.f * rand() / RAND_MAX - 1.f;
  for (auto& v : hm) v = 2.f * rand() / RAND_MAX - 1.f;
  std::vector<double> ref(R * S);
  for (int r = 0; r < R; ++r)
    for (int s = 0; s < S; ++s) {
      double a = 0;
      for (int k = 0; k < K; ++k) a += (double)hx[r * K + k] * hm[s * K + k];
      ref[r * S + s] = a;
    }
  float *x, *m, *o;
  CK(cudaMalloc(&x, hx.size() * 4));
  CK(cudaMalloc(&m, hm.size() * 4));
  CK(cudaMalloc(&o, R * S * 4));
  CK(cudaMemcpy(x, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(m, hm.data(), hm.size() * 4, cudaMemcpyHostToDevice));
  cudaStream_t st;
  CK(cudaStreamCreate(&st));
  bool first = true;
  printf("{");
  auto row = [&](const char* name, float us) {
    std::vector<float> h(R * S);
    CK(cudaMemcpy(h.data(), o, h.size() * 4, cudaMemcpyDeviceToHost));
    double e = 0;
    for (size_t i = 0; i < h.size(); ++i) e = std::max(e, std::fabs(h[i] - ref[i]));
    printf("%s\"%s\": {\"us\": %.4f, \"max_abs_err\": %.4e}", first ? "" : ", ", name, us, e);
    first = false;
  };
  const int bytes = (R + 8) * ST * 4, blocks = S / 8;
  row("kernel", graph_us([&] { CK((cudaError_t)drt_probe_f32dot(x, m, o, R, K, S, st)); }, st));
  auto phase = [&](const char* name, auto kernel) {
    CK(opt_in(kernel, bytes));
    row(name, graph_us([&] { kernel<<<blocks, DOT_THREADS, bytes, st>>>(x, m, o, 32); }, st));
  };
  phase("launch only", phases<false, false, false, false>);
  phase("copies only", phases<true, false, false, false>);
  phase("sums only", phases<false, true, false, false>);
  phase("sums unrolled by the compiler", phases<true, true, true, false>);
  phase("copies a division each", phases<true, true, false, true>);
  const int rb = 2 * (R + 8) * (128 + 4) * 4;
  row("ring of 2", graph_us([&] { ring2<<<blocks, DOT_THREADS, rb, st>>>(x, m, o); }, st));
  const int bb = bytes + 64;
  CK(opt_in(bulk<1>, bb));
  CK(opt_in(bulk<2>, bb));
  row("bulk copies", graph_us([&] { CK(launch_cluster(bulk<1>, blocks, DOT_THREADS, bb, 1, st, x, m, o)); }, st));
  row("x multicast 2", graph_us([&] { CK(launch_cluster(bulk<2>, blocks, DOT_THREADS, bb, 2, st, x, m, o)); }, st));
  const int sb = 8 * (R + 8) * (64 + 4) * 4;
  CK(opt_in(split_warps, sb));
  row("split K, 8 warps", graph_us([&] { split_warps<<<blocks, 256, sb, st>>>(x, m, o); }, st));
  const int cb = ((R + 32) * 132 + R * 32) * 4;
  row("split K, cluster of 4", graph_us([&] { split_cluster<<<S / 32 * 4, 128, cb, st>>>(x, m, o); }, st));
  printf("}\n");
  CK(cudaDeviceSynchronize());
  return 0;
}
