// Kernel C: forward compositing of each framebuffer tile's depth-sorted
// pair range: strict, relaxed, and strict with the contributor count.
//
// Replaces gaussian_splat_ipu_tpu/render/kernels/rasterize.py::
// _pallas_forward -> _kernel in all three of its uses: the inference
// primal of rasterize_tiles (need_aux=False; relaxed = not
// cfg.strict_termination) and the differentiated forward raster_fwd
// (need_aux=True, always strict), which also writes each pixel's
// contributor count nc = min(first trigger position, end) - start as f32
// (:278-284) for the backward replay (csrc/rasterize_bwd.cu). Plain
// version: gaussian_splat_ipu_tpu_torch/render/tile_raster.py::
// rasterize_tiles_torch (need_aux=True for the third mode).
//
// Per (pair, pixel): power = -0.5 (A dx^2 + C dy^2) - B dx dy,
// alpha = min(alpha_clamp, op * exp(power)); skipped when power > 0 or
// alpha < alpha_min. Work per range is capped at max_pairs; pixel centres
// sit at integer coordinates; the background is added with weight T and
// the alpha channel is 1 - T.
//   strict:  a pixel stops before blending the first pair with
//            T * (1 - alpha) < eps; its T freezes there.
//   relaxed: a pair is blended only when T * (1 - alpha) >= eps, but T
//            takes the factor (1 - alpha) of every pair until the whole
//            tile stops, at a chunk boundary, once every T < eps (the TPU
//            kernel's tile-level exit, so the alpha channel matches it).
//
// Bound on the H100: about 15 flops and one expf per (pair, pixel) against
// 36 B per pair staged once per tile, so it is compute-bound. Design: one
// CTA per tile and one thread per pixel (1024 threads for 32x32 tiles).
// The CTA stages chunks of `chunk` pairs, only the 9 rows it reads
// (x, y, conic a/b/c, r, g, b, opacity), from the (16, P) table into
// shared memory with coalesced loads; each thread then composites its
// pixel serially, front to back, from shared memory (every thread reads
// the same address: a broadcast). The CTA exits when no pixel is live
// (__syncthreads_count) or the range is exhausted, so the work per tile
// follows its own occupancy, as the TPU kernel's early exit does. The
// plain version composites each chunk in the same serial order with the
// same f32 operations (and -fmad=false keeps nvcc from fusing them), so
// the two make the same near-threshold break decisions; the check is
// atol 1e-5, and nc exactly (the same break decisions give the same
// trigger positions). The TPU's doubling scan rounds differently.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRows = 9;  // FEAT_X .. FEAT_OPACITY of the pair table

enum Mode { kStrict = 0, kRelaxedMode = 1, kStrictAux = 2 };

template <int kMode>
__global__ void __launch_bounds__(1024)
rasterize_fwd_kernel(const float* __restrict__ feats, int p,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int tiles_x,
                     int tile_w, int tile_h, int chunk, int max_pairs,
                     float eps, float alpha_clamp,
                     float alpha_min, float bg0, float bg1, float bg2,
                     float4* __restrict__ out, float* __restrict__ nc) {
  constexpr bool kRelaxed = kMode == kRelaxedMode;
  extern __shared__ float sm[];  // kRows x chunk
  const int tid = blockIdx.x;  // flat tile id of the whole grid
  const int pix = threadIdx.x;
  const int npix = blockDim.x;
  const float px = (float)((tid % tiles_x) * tile_w + pix % tile_w);
  const float py = (float)((tid / tiles_x) * tile_h + pix / tile_w);
  const int start = starts[tid];
  const int end =
      (int)min((long long)ends[tid], (long long)start + max_pairs);

  const float* sx = sm;
  const float* sy = sm + chunk;
  const float* sa = sm + 2 * chunk;
  const float* sb = sm + 3 * chunk;
  const float* sc = sm + 4 * chunk;
  const float* sr = sm + 5 * chunk;
  const float* sg = sm + 6 * chunk;
  const float* sbl = sm + 7 * chunk;
  const float* so = sm + 8 * chunk;

  float t = 1.0f, cr = 0.0f, cg = 0.0f, cbl = 0.0f;
  bool done = false;
  int stop = end;  // position of this pixel's break pair (strict modes)
  for (int base = start; base < end; base += chunk) {
    const int m = min(chunk, end - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = pix; j < m; j += npix) {
#pragma unroll
      for (int f = 0; f < kRows; ++f) {
        sm[f * chunk + j] = __ldg(feats + (size_t)f * p + base + j);
      }
    }
    __syncthreads();
    // Relaxed pixels below eps keep decaying until the whole tile stops.
    if (kRelaxed || !done) {
      for (int j = 0; j < m; ++j) {
        const float dx = sx[j] - px;
        const float dy = sy[j] - py;
        const float power =
            -0.5f * (sa[j] * dx * dx + sc[j] * dy * dy) - sb[j] * dx * dy;
        const float alpha = fminf(alpha_clamp, so[j] * expf(power));
        if (power > 0.0f || alpha < alpha_min) continue;
        const float t_next = t * (1.0f - alpha);
        if (kRelaxed) {
          if (t_next >= eps) {
            const float w = alpha * t;
            cr += w * sr[j];
            cg += w * sg[j];
            cbl += w * sbl[j];
          }
        } else {
          if (t_next < eps) {
            done = true;
            stop = base + j;
            break;
          }
          const float w = alpha * t;
          cr += w * sr[j];
          cg += w * sg[j];
          cbl += w * sbl[j];
        }
        t = t_next;
      }
      if (kRelaxed) done = t < eps;
    }
    if (__syncthreads_count(!done) == 0) break;
  }
  out[(size_t)tid * npix + pix] =
      make_float4(cr + t * bg0, cg + t * bg1, cbl + t * bg2, 1.0f - t);
  if (kMode == kStrictAux) {
    nc[(size_t)tid * npix + pix] = (float)(stop - start);
  }
}

template <int kMode>
void launch(const dim3& grid, const dim3& block, size_t smem, cudaStream_t s,
            const float* feats, int p, const int* starts, const int* ends,
            int tiles_x, int tile_w, int tile_h, int chunk, int max_pairs,
            float eps, float alpha_clamp, float alpha_min, float bg0,
            float bg1, float bg2, float* out, float* nc) {
  rasterize_fwd_kernel<kMode><<<grid, block, smem, s>>>(
      feats, p, starts, ends, tiles_x, tile_w, tile_h, chunk, max_pairs, eps,
      alpha_clamp, alpha_min, bg0, bg1, bg2, reinterpret_cast<float4*>(out),
      nc);
}

}  // namespace

// mode: 0 strict, 1 relaxed, 2 strict + contributor count into nc (which
// the other modes leave unread and may be null).
extern "C" int gsplat_rasterize_fwd(const float* feats, int p,
                                    const int* starts, const int* ends,
                                    int num_tiles, int tiles_x,
                                    int tile_w, int tile_h, int chunk,
                                    int max_pairs, float eps,
                                    float alpha_clamp, float alpha_min,
                                    float bg0, float bg1, float bg2,
                                    int mode, float* out, float* nc,
                                    void* stream) {
  const dim3 grid(num_tiles);
  const dim3 block(tile_w * tile_h);
  const size_t smem = (size_t)kRows * chunk * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const decltype(&launch<kStrict>) fn =
      mode == kRelaxedMode ? &launch<kRelaxedMode>
      : mode == kStrictAux ? &launch<kStrictAux>
                           : &launch<kStrict>;
  fn(grid, block, smem, s, feats, p, starts, ends, tiles_x, tile_w, tile_h,
     chunk, max_pairs, eps, alpha_clamp, alpha_min, bg0, bg1, bg2, out, nc);
  return (int)cudaGetLastError();
}
