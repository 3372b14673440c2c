// The in-order product: a verification aid, not a port of a TPU kernel.
//
// out [n][m] = sum_k a[n][k] * b[k][m] in fp32, the k sum taken in order
// from 0 with one rounding per product and one per add: the order in
// which the march kernels (march_body.cuh) sum each ray's products. In
// place of the plain versions' GEMM (models/decoder.py dot_f32) it makes a
// plain version give the kernels' bits on work far too large for a loop
// over k in PyTorch (a whole multi-frame render).
//
// Design: a 64x64 output tile per block, 256 threads of 4x4 outputs each,
// operand tiles of 16 k staged in shared memory; every thread walks k in
// order, so tiling changes nothing of an output's sum.

#include <cuda_runtime.h>

namespace drt {

constexpr int DOT_BM = 64, DOT_BN = 64, DOT_BK = 16, DOT_T = 4;
constexpr int DOT_THREADS = (DOT_BM / DOT_T) * (DOT_BN / DOT_T);

__global__ void __launch_bounds__(DOT_THREADS)
dot_in_order_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int n, int k, int m) {
  __shared__ float sa[DOT_BK][DOT_BM + 1];  // the a tile, transposed
  __shared__ float sb[DOT_BK][DOT_BN];
  const int row0 = blockIdx.x * DOT_BM, col0 = blockIdx.y * DOT_BN;
  const int tr = (threadIdx.x / (DOT_BN / DOT_T)) * DOT_T;
  const int tc = (threadIdx.x % (DOT_BN / DOT_T)) * DOT_T;
  float acc[DOT_T][DOT_T];
#pragma unroll
  for (int i = 0; i < DOT_T; ++i)
#pragma unroll
    for (int j = 0; j < DOT_T; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += DOT_BK) {
    for (int e = threadIdx.x; e < DOT_BM * DOT_BK; e += DOT_THREADS) {
      const int r = e / DOT_BK, c = e % DOT_BK;
      const int gr = row0 + r, gc = k0 + c;
      sa[c][r] = (gr < n && gc < k) ? a[(size_t)gr * k + gc] : 0.0f;
    }
    for (int e = threadIdx.x; e < DOT_BK * DOT_BN; e += DOT_THREADS) {
      const int r = e / DOT_BN, c = e % DOT_BN;
      const int gr = k0 + r, gc = col0 + c;
      sb[r][c] = (gr < k && gc < m) ? b[(size_t)gr * m + gc] : 0.0f;
    }
    __syncthreads();
    const int kend = min(DOT_BK, k - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float av[DOT_T], bv[DOT_T];
#pragma unroll
      for (int i = 0; i < DOT_T; ++i) av[i] = sa[kk][tr + i];
#pragma unroll
      for (int j = 0; j < DOT_T; ++j) bv[j] = sb[kk][tc + j];
#pragma unroll
      for (int i = 0; i < DOT_T; ++i)
#pragma unroll
        for (int j = 0; j < DOT_T; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < DOT_T; ++i) {
    const int gr = row0 + tr + i;
    if (gr >= n) break;
#pragma unroll
    for (int j = 0; j < DOT_T; ++j) {
      const int gc = col0 + tc + j;
      if (gc < m) out[(size_t)gr * m + gc] = acc[i][j];
    }
  }
}

}  // namespace drt

// a [n][k], b [k][m], out [n][m], all fp32 and contiguous. Returns
// cudaGetLastError().
extern "C" int drt_dot_in_order(const float* a, const float* b, float* out,
                                int n, int k, int m, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  if (k <= 0) return (int)cudaMemsetAsync(out, 0, (size_t)n * m * sizeof(float),
                                          (cudaStream_t)stream);
  const dim3 grid((n + drt::DOT_BM - 1) / drt::DOT_BM,
                  (m + drt::DOT_BN - 1) / drt::DOT_BN);
  drt::dot_in_order_kernel<<<grid, drt::DOT_THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, n, k, m);
  return (int)cudaGetLastError();
}
