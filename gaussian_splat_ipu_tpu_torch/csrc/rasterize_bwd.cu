// Kernel D: backward compositing. Gradient of the strict forward with
// respect to the (16, P) pair table, by replaying each tile's range back
// to front.
//
// Replaces gaussian_splat_ipu_tpu/render/kernels/rasterize.py::
// _pallas_backward -> _bwd_kernel. Plain version:
// gaussian_splat_ipu_tpu_torch/render/tile_raster.py::
// rasterize_backward_torch.
//
// Inputs: the pair table, the tile ranges, the cotangent gout (T, NPIX, 4)
// of the tile buffers, and what the strict forward saved: t_n = 1 - alpha
// and the contributor count nc, both (T, NPIX) f32. Per pixel, walking
// the range from its end: a pair is live while pos < start + nc; T before
// it is recovered by division, T_i = T_{i+1} / (1 - a_i), from T_n;
// sigma suffix-accumulates a_j T_j (c_j . u);
//   dL/da_i = T_i (c_i . u) - (sigma + g_T T_n) / (1 - a_i),
//   g_T = bg . u - dL/dalpha_out,
// and the power derivative dpow = dL/da_i * a_i is taken only where alpha
// is unclamped. Per pair the CTA needs nine pixel sums: dpow, dpow dx,
// dpow dy, dpow dx^2, dpow dy^2, dpow dx dy (direct products: the TPU
// kernel's note at :482-485 on pixel-basis moments cancelling in f32
// holds here too) and w u for the three colours, w = a_i T_i. From them
// the pair's gradient rows are
//   x: -(A sdx + B sdy)   y: -(C sdy + B sdx)
//   conic a: -sdxx / 2    conic b: -sdxy    conic c: -sdyy / 2
//   rgb: sum w u          opacity: sum dpow / max(op, alpha_min).
//
// Bound on the H100: about 40 flops and one expf per (pair, pixel), as
// the forward, plus the reduction of nine values over the CTA's pixels
// for every pair that touches any of them; the table is read once per
// tile, so it is compute- and reduction-bound. Design, simple and right
// first: one CTA per tile (tile-group member) and one thread per pixel.
// The walk is clipped at start + the CTA's largest nc (later pairs had no
// weight in the forward, as the TPU kernel's clip at :370-372). The CTA
// stages the 9 rows it reads of each chunk into shared memory, chunks in
// reverse order, and each thread runs the serial recurrence of its pixel
// from the chunk's last pair to its first. A warp whose lanes all skip a
// pair contributes nothing to it; otherwise its nine values are summed by
// shuffles and lane 0 adds them into a per-chunk shared accumulator
// (9 x chunk floats). When the chunk is done, one thread per pair turns
// the nine sums into the nine gradient rows and adds each non-zero one to
// dfeat with one global atomicAdd. The TPU kernel owned chunks by
// read-modify-write in a sequential grid (:509-552), which is where the
// tile-group bug of its round 5 lived; here every member tile of a group
// adds into the shared range with atomics, so no member can overwrite
// another's sums. The caller zeroes dfeat; rows 9-15 stay zero. Atomics
// make the summation order vary from run to run, so the kernel is held to
// its plain version with a tolerance scaled to each row, not equality.
// The per-pixel arithmetic follows the plain version operation for
// operation (and -fmad=false keeps nvcc from fusing it), so the live
// decisions and the recovered T agree; only the sums are reordered.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRows = 9;   // FEAT_X .. FEAT_OPACITY of the pair table
constexpr int kSums = 9;   // pixel sums reduced per pair
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(1024)
rasterize_bwd_kernel(const float* __restrict__ feats, int p,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const float4* __restrict__ gout,
                     const float* __restrict__ t_n,
                     const float* __restrict__ nc, int tiles_x, int tile_w,
                     int tile_h, int chunk, int max_pairs, float alpha_clamp,
                     float alpha_min, float bg0, float bg1, float bg2,
                     float* __restrict__ dfeat) {
  extern __shared__ float sm[];  // kRows x chunk table, kSums x chunk sums
  __shared__ int s_max_nc;
  const int tid = blockIdx.x;
  const int pix = threadIdx.x;
  const int npix = blockDim.x;
  const int lane = pix & 31;
  const float px = (float)((tid % tiles_x) * tile_w + pix % tile_w);
  const float py = (float)((tid / tiles_x) * tile_h + pix / tile_w);
  const size_t me = (size_t)tid * npix + pix;
  const float4 u = gout[me];
  const int my_nc = (int)nc[me];
  const int start = starts[tid];

  if (pix == 0) s_max_nc = 0;
  __syncthreads();
  int wmax = my_nc;
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(kFull, wmax, o));
  }
  if (lane == 0) atomicMax(&s_max_nc, wmax);
  __syncthreads();
  const int end = (int)min(min((long long)ends[tid],
                               (long long)start + max_pairs),
                           (long long)start + s_max_nc);
  if (end <= start) return;  // the same for the whole CTA

  const float g_tn = ((bg0 * u.x + bg1 * u.y + bg2 * u.z) - u.w) * t_n[me];
  const int live_limit = start + my_nc;
  float t = t_n[me];
  float sigma = 0.0f;

  float* const srow = sm;                  // the table rows, row f at f*chunk
  float* const acc = sm + kRows * chunk;   // the sums, sum f at f*chunk
  const float* sx = srow;
  const float* sy = srow + chunk;
  const float* sa = srow + 2 * chunk;
  const float* sb = srow + 3 * chunk;
  const float* sc = srow + 4 * chunk;
  const float* sr = srow + 5 * chunk;
  const float* sg = srow + 6 * chunk;
  const float* sbl = srow + 7 * chunk;
  const float* so = srow + 8 * chunk;

  const int nchunks = (end - start + chunk - 1) / chunk;
  for (int k = nchunks - 1; k >= 0; --k) {
    const int base = start + k * chunk;
    const int m = min(chunk, end - base);
    __syncthreads();  // the previous chunk is flushed
    for (int j = pix; j < m; j += npix) {
#pragma unroll
      for (int f = 0; f < kRows; ++f) {
        srow[f * chunk + j] = __ldg(feats + (size_t)f * p + base + j);
      }
#pragma unroll
      for (int f = 0; f < kSums; ++f) acc[f * chunk + j] = 0.0f;
    }
    __syncthreads();
    for (int j = m - 1; j >= 0; --j) {
      const float dx = sx[j] - px;
      const float dy = sy[j] - py;
      const float power =
          -0.5f * (sa[j] * dx * dx + sc[j] * dy * dy) - sb[j] * dx * dy;
      const float a_raw = so[j] * expf(power);
      const float alpha = fminf(alpha_clamp, a_raw);
      const bool use = !(power > 0.0f || alpha < alpha_min) &&
                       base + j < live_limit;
      float v[kSums];
#pragma unroll
      for (int f = 0; f < kSums; ++f) v[f] = 0.0f;
      if (use) {
        const float one_minus = 1.0f - alpha;
        t = t / one_minus;  // T before this pair
        const float cu = sr[j] * u.x + sg[j] * u.y + sbl[j] * u.z;
        const float w = alpha * t;
        const float d_alpha = t * cu - (sigma + g_tn) / one_minus;
        sigma = sigma + w * cu;
        const float dpow = a_raw < alpha_clamp ? d_alpha * alpha : 0.0f;
        v[0] = dpow;
        v[1] = dpow * dx;
        v[2] = dpow * dy;
        v[3] = dpow * dx * dx;
        v[4] = dpow * dy * dy;
        v[5] = dpow * dx * dy;
        v[6] = w * u.x;
        v[7] = w * u.y;
        v[8] = w * u.z;
      }
      if (__any_sync(kFull, use)) {
#pragma unroll
        for (int f = 0; f < kSums; ++f) {
          for (int o = 16; o > 0; o >>= 1) {
            v[f] += __shfl_down_sync(kFull, v[f], o);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < kSums; ++f) atomicAdd(&acc[f * chunk + j], v[f]);
        }
      }
    }
    __syncthreads();
    for (int j = pix; j < m; j += npix) {
      const float m1 = acc[j];
      const float sdx = acc[chunk + j];
      const float sdy = acc[2 * chunk + j];
      const float sdxx = acc[3 * chunk + j];
      const float sdyy = acc[4 * chunk + j];
      const float sdxy = acc[5 * chunk + j];
      const float ca = sa[j], cb = sb[j], cc = sc[j];
      float grow[kRows];
      grow[0] = -(ca * sdx + cb * sdy);
      grow[1] = -(cc * sdy + cb * sdx);
      grow[2] = -0.5f * sdxx;
      grow[3] = -sdxy;
      grow[4] = -0.5f * sdyy;
      grow[5] = acc[6 * chunk + j];
      grow[6] = acc[7 * chunk + j];
      grow[7] = acc[8 * chunk + j];
      grow[8] = m1 / fmaxf(so[j], alpha_min);
#pragma unroll
      for (int f = 0; f < kRows; ++f) {
        if (grow[f] != 0.0f) {
          atomicAdd(dfeat + (size_t)f * p + base + j, grow[f]);
        }
      }
    }
  }
}

}  // namespace

// dfeat must hold zeros on entry; gout is (T, NPIX) float4, t_n and nc
// (T, NPIX) f32. The block is one thread per pixel: tile_w * tile_h must
// be a multiple of 32 and at most 1024.
extern "C" int gsplat_rasterize_bwd(const float* feats, int p,
                                    const int* starts, const int* ends,
                                    const float* gout, const float* t_n,
                                    const float* nc, int num_tiles,
                                    int tiles_x, int tile_w, int tile_h,
                                    int chunk, int max_pairs,
                                    float alpha_clamp, float alpha_min,
                                    float bg0, float bg1, float bg2,
                                    float* dfeat, void* stream) {
  const dim3 grid(num_tiles);
  const dim3 block(tile_w * tile_h);
  const size_t smem = (size_t)(kRows + kSums) * chunk * sizeof(float);
  rasterize_bwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      feats, p, starts, ends, reinterpret_cast<const float4*>(gout), t_n, nc,
      tiles_x, tile_w, tile_h, chunk, max_pairs, alpha_clamp, alpha_min, bg0,
      bg1, bg2, dfeat);
  return (int)cudaGetLastError();
}
