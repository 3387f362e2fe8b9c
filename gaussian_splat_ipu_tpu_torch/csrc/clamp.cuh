// torch.clamp_min / clamp_max / clamp with float bounds, as PyTorch's CUDA
// kernels compute them: NaN stays NaN. Shared by kernels G, G-bwd
// (project_common.cuh) and H (adam.cu).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_nan(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

}  // namespace
