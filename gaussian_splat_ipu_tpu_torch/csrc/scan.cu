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
// in scratch from one grid step to the next. GPU blocks run in no order and
// a row is far too long for one SM to stream at the card's rate, so here
// every row is cut into tiles of kTile elements, one CTA a tile, and the
// carry between tiles is a single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016):
//   - a CTA takes its tile from a global ticket (atomicAdd), not from
//     blockIdx, so tiles of a row start in order and a CTA only ever waits
//     on tiles that have already started: progress holds whatever order
//     the blocks are scheduled in;
//   - it loads its tile in warp-contiguous 512-B runs (16 B a lane where
//     the row is 16-B aligned, scalar otherwise), scans it by warp
//     shuffles (one scan per 4-element chunk of a lane) and one warp over
//     the warp totals, and publishes the tile's aggregate in its 64-bit
//     status word (flag in the high half, the u32 value in the low half,
//     one store); the first tile of a row publishes its inclusive prefix;
//   - one warp looks back over the predecessors' status words, 32 at a
//     time, adding aggregates until it meets an inclusive prefix, then
//     publishes its own inclusive prefix and writes the tile.
// Sums are taken in u32, so they wrap as the plain version's i64 -> i32
// cast does. The status words and the ticket live in a scratch buffer the
// wrapper allocates; the entry zeroes it with one cudaMemsetAsync on the
// same stream before each launch.
//
// Bound on the H100: 8 B of traffic per element (one read, one write), so
// 75.5 MB at the rowseg 1M shape (R = 9, N = 2^20): 0.0225 ms at 3.35
// TB/s. The status words add 16 B per tile (R * N / kTile tiles).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Threads per CTA and elements per thread; -D overrides let a tuning build
// (scan_ab.py) try other tiles without editing the source. 128 x 64 (8192
// elements a tile, 95 registers, 5 CTAs an SM) was the fastest of the
// twelve shapes tried on an H100 at (9, 2^20): more loads in flight per
// thread beat more threads (PERF.md).
#ifndef GSPLAT_SCAN_THREADS
#define GSPLAT_SCAN_THREADS 128
#endif
#ifndef GSPLAT_SCAN_ITEMS
#define GSPLAT_SCAN_ITEMS 64
#endif

namespace {

constexpr int kThreads = GSPLAT_SCAN_THREADS;
constexpr int kItems = GSPLAT_SCAN_ITEMS;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr int kChunks = kItems / 4;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "1-32 warps a CTA");
static_assert(kItems % 4 == 0, "whole int4 chunks a thread");

constexpr unsigned kFull = 0xffffffffu;
// Status word: flag << 32 | u32 value. 0 = not published yet.
constexpr unsigned kAggregate = 1u;   // the tile's own sum
constexpr unsigned kPrefix = 2u;      // the row's sum up to and with the tile

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned flag,
                                        unsigned value) {
  __threadfence();
  const unsigned long long v = (unsigned long long)flag << 32 | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The sum of the row's tiles before `tile`, read from their status words by
// one warp. Every tile before it has taken its ticket already, so each
// word it waits on is published without waiting on anything.
__device__ unsigned look_back(const unsigned long long* status_row, int tile,
                              int lane) {
  unsigned prefix = 0;
  for (int pos = tile - 1;; pos -= 32) {
    const int p = pos - lane;
    // Before the row's first tile: an inclusive prefix of 0.
    unsigned long long s = p >= 0 ? load_status(status_row + p)
                                  : (unsigned long long)kPrefix << 32;
    while (__any_sync(kFull, (s >> 32) == 0)) {
      if ((s >> 32) == 0) s = load_status(status_row + p);
    }
    const unsigned done = __ballot_sync(kFull, (s >> 32) == kPrefix);
    // Lane 0 is the nearest predecessor: sum the lanes up to the first
    // inclusive prefix, or all 32 aggregates and step back.
    const int stop = done ? __ffs(done) - 1 : 31;
    prefix += warp_sum(lane <= stop ? (unsigned)s : 0u);
    if (done) return prefix;
  }
}

__global__ void __launch_bounds__(kThreads)
    row_scan_lookback_kernel(const int* __restrict__ x, int n,
                             int tiles_per_row, unsigned* __restrict__ ticket,
                             unsigned long long* __restrict__ status,
                             int* __restrict__ out) {
  __shared__ unsigned warp_prefix[kWarps];
  __shared__ int s_ticket;
  __shared__ unsigned s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int row = s_ticket / tiles_per_row;
  const int tile = s_ticket - row * tiles_per_row;
  const int* xr = x + (size_t)row * n;
  int* orow = out + (size_t)row * n;
  const bool aligned = (((uintptr_t)xr | (uintptr_t)orow) & 15) == 0;
  // Each warp owns 32 * kItems consecutive elements, read in kChunks
  // chunks of 128: lane l holds elements 4l .. 4l + 3 of each chunk, so a
  // warp's 16-B loads and stores cover whole 512-B runs.
  const int seg = tile * kTile + warp * 32 * kItems + lane * 4;

  unsigned v[kItems];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = seg + c * 128;
    if (aligned && i + 4 <= n) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(xr + i));
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[4 * c + e] = i + e < n ? (unsigned)__ldg(xr + i + e) : 0u;
      }
    }
  }
  // The sum of the warp's elements before each of this lane's chunks.
  unsigned before[kChunks];
  unsigned warp_total = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned s = v[4 * c] + v[4 * c + 1] + v[4 * c + 2] + v[4 * c + 3];
    const unsigned incl = warp_inclusive_scan(s, lane);
    before[c] = warp_total + incl - s;
    warp_total += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) warp_prefix[warp] = warp_total;
  __syncthreads();

  if (warp == 0) {
    const unsigned w = lane < kWarps ? warp_prefix[lane] : 0u;
    const unsigned wi = warp_inclusive_scan(w, lane);
    const unsigned aggregate = __shfl_sync(kFull, wi, 31);
    unsigned long long* status_row = status + (size_t)row * tiles_per_row;
    if (lane == 0) {
      publish(status_row + tile, tile == 0 ? kPrefix : kAggregate, aggregate);
    }
    unsigned prefix = 0;
    if (tile > 0) {
      prefix = look_back(status_row, tile, lane);
      if (lane == 0) publish(status_row + tile, kPrefix, prefix + aggregate);
    }
    if (lane == 0) s_prefix = prefix;
    if (lane < kWarps) warp_prefix[lane] = wi - w;
  }
  __syncthreads();

  const unsigned base = s_prefix + warp_prefix[warp];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = seg + c * 128;
    unsigned run = base + before[c];
    unsigned o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = run;
      run += v[4 * c + e];
    }
    if (aligned && i + 4 <= n) {
      reinterpret_cast<int4*>(orow + i)[0] =
          make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < n) orow[i + e] = (int)o[e];
      }
    }
  }
}

int tiles_per_row(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

// 64-bit words of scratch that gsplat_row_cumsum_exclusive needs for an
// (r, n) matrix: the ticket, then one status word per tile.
extern "C" int gsplat_row_cumsum_scratch_words(int r, int n) {
  return 1 + r * tiles_per_row(n);
}

extern "C" int gsplat_row_cumsum_exclusive(const int* x, int r, int n,
                                           int* out, void* scratch,
                                           void* stream) {
  if (r > 0 && n > 0) {
    const int t = tiles_per_row(n);
    const cudaStream_t s = (cudaStream_t)stream;
    unsigned long long* words = (unsigned long long*)scratch;
    const cudaError_t e = cudaMemsetAsync(
        words, 0, sizeof(unsigned long long) * (1 + (size_t)r * t), s);
    if (e != cudaSuccess) return (int)e;
    row_scan_lookback_kernel<<<r * t, kThreads, 0, s>>>(
        x, n, t, (unsigned*)words, words + 1, out);
  }
  return (int)cudaGetLastError();
}
