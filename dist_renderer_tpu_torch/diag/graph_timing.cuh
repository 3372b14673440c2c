// The design programs' timer (copy_designs.cu, dma_designs.cu,
// f32dot_designs.cu): a launch's device time inside a CUDA graph of n
// launches, the median of 5 timed replays over n, in us; and CK, which
// exits the program on a CUDA error.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>

#define CK(e)                                                                  \
  do {                                                                         \
    cudaError_t err_ = (e);                                                    \
    if (err_ != cudaSuccess) {                                                 \
      fprintf(stderr, "CUDA error %s at line %d\n", cudaGetErrorString(err_), \
              __LINE__);                                                       \
      exit(1);                                                                 \
    }                                                                          \
  } while (0)

template <typename F>
float graph_us(F launch, cudaStream_t st, int n = 200) {
  launch();
  CK(cudaStreamSynchronize(st));
  cudaGraph_t g;
  cudaGraphExec_t ge;
  CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal));
  for (int i = 0; i < n; ++i) launch();
  CK(cudaStreamEndCapture(st, &g));
  CK(cudaGraphInstantiate(&ge, g, 0));
  CK(cudaGraphLaunch(ge, st));
  CK(cudaStreamSynchronize(st));
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  std::vector<float> ts;
  for (int rep = 0; rep < 5; ++rep) {
    CK(cudaEventRecord(a, st));
    CK(cudaGraphLaunch(ge, st));
    CK(cudaEventRecord(b, st));
    CK(cudaEventSynchronize(b));
    float ms;
    CK(cudaEventElapsedTime(&ms, a, b));
    ts.push_back(ms);
  }
  CK(cudaEventDestroy(a));
  CK(cudaEventDestroy(b));
  CK(cudaGraphExecDestroy(ge));
  CK(cudaGraphDestroy(g));
  std::sort(ts.begin(), ts.end());
  return ts[2] * 1e3f / n;
}
