// Kernel E: exclusive cumsum along each row of an (R, N) i32 matrix.
//
// Replaces gaussian_splat_ipu_tpu/render/kernels/scan.py::
// row_cumsum_exclusive (its Pallas body `_kernel`). Plain version:
// gaussian_splat_ipu_tpu_torch/render/kernels/scan.py::
// row_cumsum_exclusive_torch.
//
// The row-bucket segmented binning scans its (R, N) per-bucket pair counts
// (R buckets, N gaussians) into per-bucket slot offsets. The TPU kernel
// walks 2048-lane blocks in grid order and carries each row's running total
// in scratch from one grid step to the next. GPU blocks run in no order, so
// here the carry lives in a register of one CTA per row instead: the CTA
// loops over its row in tiles of kThreads * kPerThread elements, scans each
// tile (a shuffle scan inside each warp, then one warp scans the 32 warp
// totals through shared memory) and adds the running total of the earlier
// tiles.
//
// Bound on the H100: 8 B of traffic per element (one read, one write),
// 8 MB per row at N = 2^20. With one CTA per row only R SMs work (R is
// about 8-16 in the segmented binning), so a row streams at the rate one
// SM can sustain, not at the card's 3.35 TB/s. A decoupled look-back or a
// reduce-then-scan over many CTAs per row would use the whole card; that is
// later work (ROADMAP.md).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;   // 32: one warp scans the warp totals
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    row_scan_kernel(const int* __restrict__ x, int n,
                    int* __restrict__ out) {
  __shared__ int warp_prefix[kWarps];
  __shared__ int tile_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* xr = x + (size_t)blockIdx.x * n;
  int* orow = out + (size_t)blockIdx.x * n;
  int carry = 0;   // sum of the row's earlier tiles
  for (int base = 0; base < n; base += kTile) {
    const int i0 = base + threadIdx.x * kPerThread;
    int v[kPerThread];
    int local = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      v[k] = (i0 + k < n) ? __ldg(xr + i0 + k) : 0;
      local += v[k];
    }
    const int incl = warp_inclusive_scan(local, lane);
    if (lane == 31) warp_prefix[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_prefix[lane];
      const int wi = warp_inclusive_scan(w, lane);
      warp_prefix[lane] = wi - w;
      if (lane == 31) tile_total = wi;
    }
    __syncthreads();
    int run = carry + warp_prefix[warp] + incl - local;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (i0 + k < n) orow[i0 + k] = run;
      run += v[k];
    }
    carry += tile_total;
    __syncthreads();   // warp_prefix and tile_total are rewritten next tile
  }
}

}  // namespace

extern "C" int gsplat_row_cumsum_exclusive(const int* x, int r, int n,
                                           int* out, void* stream) {
  if (r > 0 && n > 0) {
    row_scan_kernel<<<r, kThreads, 0, (cudaStream_t)stream>>>(x, n, out);
  }
  return (int)cudaGetLastError();
}
