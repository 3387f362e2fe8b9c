// Kernel B: stream expansion of gaussians into (gaussian, tile) pair slots.
//
// Replaces gaussian_splat_ipu_tpu/render/kernels/expand.py::stream_expand
// (its Pallas body `_make_kernel_v4`): the flat path (one offsets row) and
// the segmented path (`two_offs`: R offsets rows and their rank rows).
// Plain versions: gaussian_splat_ipu_tpu_torch/render/kernels/expand.py::
// stream_expand_torch and stream_expand_seg_torch.
//
// For each output slot s in [0, P): gid = the rightmost g in [0, N] with
// offsets_ext[g] <= s, rank = s - offsets_ext[gid], and the 16 columns of
// packed[gid] go to column s of the feature-major (16, P) output. Empty
// gaussians repeat their successor's offset, so the rightmost match never
// selects them; slots past the live total resolve to the sentinel g = N
// (offsets_ext[N] = total), which gives the reference's pad rule
// (gid = N, rank = s - total, the zero row N) with no special case.
//
// Bound on the H100: about 72 B written per slot (64 B of columns, 8 B of
// gid and rank), so it is memory-bound: about 0.1 ms at P = 4M from the
// 3.35 TB/s datasheet rate. Design: one thread per slot. The binary search
// (log2(N+1) steps) reads the offsets through the read-only cache; its
// first steps hit the same few entries for every thread, and neighbouring
// slots mostly share a gid, so the search and the four 16-byte row loads
// stay in L1/L2. Stores are coalesced: consecutive threads write
// consecutive slots of each of the 16 output rows. The TPU kernel's
// source-window tiling and its span-check fallback have no counterpart:
// a GPU thread can read any row.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void stream_expand_kernel(const float4* __restrict__ packed,
                                     const int* __restrict__ offs, int n,
                                     int p, float* __restrict__ cols,
                                     int* __restrict__ gid,
                                     int* __restrict__ rank) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p) return;
  // Invariant: offs[lo] <= s (offs[0] == 0) and hi == n + 1 or offs[hi] > s.
  int lo = 0, hi = n + 1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offs + mid) <= s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  gid[s] = lo;
  rank[s] = s - __ldg(offs + lo);
  const float4* row = packed + (size_t)lo * 4;
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

// Segmented path (row-bucket binning): slot s lies in bucket r = s / cap,
// whose slots are [r * cap, (r + 1) * cap). Slots from live_end[r] on are
// pads (gid = N, rank = s - live_end[r], the zero row). A live slot takes
// the rightmost g < N with offs[r, g] <= s; offs[r, :] ascends and
// offs[r, 0] = r * cap <= s, so the same binary search as the flat path
// finds it. Its rank addresses the gaussian's whole footprint:
// s - offs2[r, gid], where offs2 subtracts the gaussian's pairs in earlier
// buckets. Same bound and design as the flat kernel, plus one 4 B read of
// live_end per slot (cached: a bucket spans many blocks).
__global__ void stream_expand_seg_kernel(
    const float4* __restrict__ packed, const int* __restrict__ offs,
    const int* __restrict__ offs2, const int* __restrict__ live_end, int n,
    int cap, int p, float* __restrict__ cols, int* __restrict__ gid,
    int* __restrict__ rank) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p) return;
  const int r = s / cap;
  const int end = __ldg(live_end + r);
  int g = n, rk = s - end;
  if (s < end) {
    const int* row = offs + (size_t)r * n;
    // Invariant: row[lo] <= s and hi == n or row[hi] > s.
    int lo = 0, hi = n;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(row + mid) <= s) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    g = lo;
    rk = s - __ldg(offs2 + (size_t)r * n + lo);
  }
  gid[s] = g;
  rank[s] = rk;
  const float4* src = packed + (size_t)g * 4;
  const size_t ps = (size_t)p;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldg(src + q);
    cols[(4 * q + 0) * ps + s] = v.x;
    cols[(4 * q + 1) * ps + s] = v.y;
    cols[(4 * q + 2) * ps + s] = v.z;
    cols[(4 * q + 3) * ps + s] = v.w;
  }
}

}  // namespace

extern "C" int gsplat_stream_expand(const float* packed, const int* offs,
                                    int n, int p, float* cols, int* gid,
                                    int* rank, void* stream) {
  const int threads = 256;
  stream_expand_kernel<<<(p + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), offs, n, p, cols, gid, rank);
  return (int)cudaGetLastError();
}

extern "C" int gsplat_stream_expand_seg(const float* packed, const int* offs,
                                        const int* offs2,
                                        const int* live_end, int n, int r,
                                        int cap, float* cols, int* gid,
                                        int* rank, void* stream) {
  const int threads = 256;
  const int p = r * cap;
  if (p > 0) {
    stream_expand_seg_kernel<<<(p + threads - 1) / threads, threads, 0,
                               (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(packed), offs, offs2, live_end, n,
        cap, p, cols, gid, rank);
  }
  return (int)cudaGetLastError();
}
