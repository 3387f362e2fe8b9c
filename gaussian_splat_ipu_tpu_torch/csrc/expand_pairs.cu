// Kernel F: ascending row gather of the packed per-gaussian table into the
// feature-major pair table.
//
// Replaces gaussian_splat_ipu_tpu/render/kernels/expand.py::expand_pairs
// (its Pallas body `_kernel`). Plain version:
// gaussian_splat_ipu_tpu_torch/render/kernels/expand.py::expand_pairs_torch.
//
// For each pair slot s in [0, P): column s of the (16, P) output is row
// gid[s] of the row-major (N+1, 16) packed table (row N is the zero row
// that pad slots name). The binning's gather paths (expand_kernel=False,
// presort_depth, the exact two-pass sort) compute gid by a scatter-max and
// cummax and run this gather once per frame.
//
// Bound on the H100: 68 B of traffic per slot (the 4 B gid read, 64 B of
// columns written); the row reads mostly hit L1/L2, because gid ascends and
// neighbouring slots share a row. Memory-bound: about 0.04 ms at P = 1.8M
// from the 3.35 TB/s datasheet rate. Design: one thread per slot, four
// 16-byte row loads through the read-only cache, and coalesced stores:
// consecutive threads write consecutive slots of each of the 16 output
// rows. The TPU kernel's 4096-row source windows, their scalar-prefetched
// starts and the span precondition have no counterpart: a GPU thread can
// read any row.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void expand_pairs_kernel(const float4* __restrict__ packed,
                                    const int* __restrict__ gid, int p,
                                    float* __restrict__ cols) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p) return;
  const float4* row = packed + (size_t)__ldg(gid + s) * 4;
  const size_t ps = (size_t)p;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldg(row + q);
    cols[(4 * q + 0) * ps + s] = v.x;
    cols[(4 * q + 1) * ps + s] = v.y;
    cols[(4 * q + 2) * ps + s] = v.z;
    cols[(4 * q + 3) * ps + s] = v.w;
  }
}

}  // namespace

extern "C" int gsplat_expand_pairs(const float* packed, const int* gid, int p,
                                   float* cols, void* stream) {
  const int threads = 256;
  if (p > 0) {
    expand_pairs_kernel<<<(p + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(packed), gid, p, cols);
  }
  return (int)cudaGetLastError();
}
