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
// the alpha channel is 1 - T. The ranges may be those of a row strip of the
// grid (the distributed renderer): local tile t lies at global flat id
// tile_offset + t, which places its pixels; starts, ends and the outputs are
// indexed by t.
//   strict:  a pixel stops before blending the first pair with
//            T * (1 - alpha) < eps; its T freezes there.
//   relaxed: a pair is blended only when T * (1 - alpha) >= eps, but T
//            takes the factor (1 - alpha) of every pair until the whole
//            tile stops, at a chunk boundary, once every T < eps (the TPU
//            kernel's tile-level exit, so the alpha channel matches it).
//
// Bound on the H100: the work depends on the data. A live evaluation
// (power <= 0, alpha >= alpha_min, before the pixel's stop) costs 27
// operations as written below (dx, dy, 9 for power, 2 compares, expf and
// its product, the clamp, the alpha test, 1 - alpha, T (1 - alpha), the
// eps test, the weight, 6 for the colour); the bytes are the 9 table rows
// of every pair read once and 16 B (+ 4 B nc) written per pixel. At the
// 1M frame both give a few hundredths of a millisecond, far below what a
// CTA that walks whole group ranges at every pixel takes: the kernel is
// bound by the evaluations it executes, of which only a small share is
// live (chip_smoke.py counts them).
//
// Design (raster_stage.cuh has the layout, the cull and its proof):
// one CTA per tile, each thread kPpt (at most 2) pixels of a column, each
// warp a compact pixel rectangle. The range is walked in chunks at the original
// positions start + k * chunk. Staging threads load the chunk's 9 rows
// (coalesced), cull each pair against the tile's pixel-centre rectangle
// with a conservative box of its alpha >= alpha_min ellipse and compact
// the survivors into shared memory (four 16-byte words a pair). A warp
// skips a survivor whose box misses its own rectangle (warp-uniform); a
// pixel skips expf below the pair's threshold; one shared read of a pair
// serves kPpt pixels. Chunk k + 1's loads are issued into registers
// before chunk k composites and are culled into the other stage after
// it, so the load latency hides behind the compositing and one barrier
// (__syncthreads_count, which also decides the tile's exit) ends a chunk.
// A register prefetch and not cp.async: the cull needs the values in
// registers anyway, and cp.async would add a shared-memory round trip.
// Every skip drops only pairs the pixel would have skipped, the per-pixel
// arithmetic is the plain version's operation for operation (-fmad=false
// keeps nvcc from fusing it), and stop positions come from each pair's
// original position, so the outputs equal the plain version's and nc is
// exactly equal.

#include "raster_stage.cuh"

namespace {

using namespace gsplat_raster;

enum Mode { kStrict = 0, kRelaxedMode = 1, kStrictAux = 2 };

template <int kMode, int kPpt>
__global__ void __launch_bounds__(kMaxThreads)
rasterize_fwd_kernel(const float* __restrict__ feats, int p,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int tile_offset,
                     int tiles_x, int tile_w, int tile_h, int ww, int chunk,
                     int max_pairs, float eps,
                     float alpha_clamp, float alpha_min, float bg0, float bg1,
                     float bg2, float4* __restrict__ out,
                     float* __restrict__ nc) {
  constexpr bool kRelaxed = kMode == kRelaxedMode;
  extern __shared__ __align__(16) char smem[];
  const int tid = blockIdx.x;          // local tile: ranges and outputs
  const int gtid = tid + tile_offset;  // global flat tile id: pixels
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lpc = 32 / ww;         // lanes per column
  const int wh = lpc * kPpt;
  const int wx0 = (warp % (tile_w / ww)) * ww;
  const int wy0 = (warp / (tile_w / ww)) * wh;
  const int lx = wx0 + lane % ww;
  const int ly0 = wy0 + lane / ww;  // pixel k sits at row ly0 + k * lpc
  const float tx0 = (float)((gtid % tiles_x) * tile_w);
  const float ty0 = (float)((gtid / tiles_x) * tile_h);
  const float px = tx0 + (float)lx;
  float py[kPpt];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) py[k] = ty0 + (float)(ly0 + k * lpc);
  // Pixel-centre rectangles of the warp and of the tile.
  const float wrx0 = tx0 + (float)wx0, wrx1 = wrx0 + (float)(ww - 1);
  const float wry0 = ty0 + (float)wy0, wry1 = wry0 + (float)(wh - 1);
  const float crx1 = tx0 + (float)(tile_w - 1);
  const float cry1 = ty0 + (float)(tile_h - 1);
  const int start = starts[tid];
  const int end =
      (int)min((long long)ends[tid], (long long)start + max_pairs);

  float t[kPpt], cr[kPpt], cg[kPpt], cbl[kPpt];
  int stop[kPpt];  // position of each pixel's break pair (strict modes)
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    t[k] = 1.0f;
    cr[k] = cg[k] = cbl[k] = 0.0f;
    stop[k] = end;
  }
  unsigned live = (1u << kPpt) - 1u;  // strict: pixels not yet stopped

  const int nchunks = end > start ? (end - start + chunk - 1) / chunk : 0;
  float v[kRounds][kRows];
  if (nchunks > 0) {
    const int m = min(chunk, end - start);
    load_chunk(feats, p, start, m, v);
    compact_chunk(v, start, m, chunk, alpha_min, tx0, crx1, ty0, cry1,
                  stage_at(smem, chunk, 0));
  }
  __syncthreads();
  const int nseg = (chunk + 31) / 32;
  for (int kc = 0; kc < nchunks; ++kc) {
    const Stage cur = stage_at(smem, chunk, kc & 1);
    const int nbase = start + (kc + 1) * chunk;
    const bool more = kc + 1 < nchunks;
    if (more) load_chunk(feats, p, nbase, min(chunk, end - nbase), v);
    // Relaxed pixels below eps keep decaying until the whole tile stops.
    if (kRelaxed || __any_sync(kFull, live != 0u)) {
      for (int s = 0; s < nseg; ++s) {
        const int n = cur.cnt[s];
        for (int i = 0; i < n; ++i) {
          const int slot = (s << 5) + i;
          if (misses(cur.box[slot], wrx0, wrx1, wry0, wry1)) continue;
          const float4 g0 = cur.g0[slot];  // x, y, conic a, conic b
          const float4 g1 = cur.g1[slot];  // conic c, r, g, b
          const float4 g2 = cur.g2[slot];  // op, position, -tau_m
          const float dx = g0.x - px;
#pragma unroll
          for (int k = 0; k < kPpt; ++k) {
            if (!kRelaxed && !((live >> k) & 1u)) continue;
            const float dy = g0.y - py[k];
            const float power =
                -0.5f * (g0.z * dx * dx + g1.x * dy * dy) - g0.w * dx * dy;
            if (power > 0.0f || power < g2.z) continue;
            const float alpha = fminf(alpha_clamp, g2.x * expf(power));
            if (alpha < alpha_min) continue;
            const float t_next = t[k] * (1.0f - alpha);
            if (kRelaxed) {
              if (t_next >= eps) {
                const float w = alpha * t[k];
                cr[k] += w * g1.y;
                cg[k] += w * g1.z;
                cbl[k] += w * g1.w;
              }
            } else {
              if (t_next < eps) {
                live &= ~(1u << k);
                stop[k] = __float_as_int(g2.y);
                continue;
              }
              const float w = alpha * t[k];
              cr[k] += w * g1.y;
              cg[k] += w * g1.z;
              cbl[k] += w * g1.w;
            }
            t[k] = t_next;
          }
        }
      }
    }
    if (more) {
      compact_chunk(v, nbase, min(chunk, end - nbase), chunk, alpha_min,
                    tx0, crx1, ty0, cry1, stage_at(smem, chunk, (kc + 1) & 1));
    }
    bool alive = live != 0u;
    if (kRelaxed) {
      alive = false;
#pragma unroll
      for (int k = 0; k < kPpt; ++k) alive |= t[k] >= eps;
    }
    if (__syncthreads_count(alive) == 0) break;
  }
  const size_t npix = (size_t)tile_w * tile_h;
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const size_t me = tid * npix + (size_t)(ly0 + k * lpc) * tile_w + lx;
    out[me] = make_float4(cr[k] + t[k] * bg0, cg[k] + t[k] * bg1,
                          cbl[k] + t[k] * bg2, 1.0f - t[k]);
    if (kMode == kStrictAux) nc[me] = (float)(stop[k] - start);
  }
}

using Kernel = void (*)(const float*, int, const int*, const int*, int, int,
                        int, int, int, int, int, float, float, float, float,
                        float, float, float4*, float*);

template <int kMode>
Kernel pick(int ppt) {
  return ppt == 2 ? &rasterize_fwd_kernel<kMode, 2>
                  : &rasterize_fwd_kernel<kMode, 1>;
}

}  // namespace

// mode: 0 strict, 1 relaxed, 2 strict + contributor count into nc (which
// the other modes leave unread and may be null). tile_offset: the global
// flat id of local tile 0. The tile and chunk must
// admit a layout (raster_stage.cuh: choose_layout), else
// cudaErrorInvalidConfiguration.
extern "C" int gsplat_rasterize_fwd(const float* feats, int p,
                                    const int* starts, const int* ends,
                                    int num_tiles, int tile_offset,
                                    int tiles_x, int tile_w, int tile_h,
                                    int chunk,
                                    int max_pairs, float eps,
                                    float alpha_clamp, float alpha_min,
                                    float bg0, float bg1, float bg2,
                                    int mode, float* out, float* nc,
                                    void* stream) {
  Layout lay;
  if (!choose_layout(tile_w, tile_h, chunk, kFwdMaxPpt, &lay)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const Kernel fn = mode == kRelaxedMode ? pick<kRelaxedMode>(lay.ppt)
                    : mode == kStrictAux ? pick<kStrictAux>(lay.ppt)
                                         : pick<kStrict>(lay.ppt);
  const size_t smem = stage_bytes(chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<num_tiles, lay.threads, smem, (cudaStream_t)stream>>>(
      feats, p, starts, ends, tile_offset, tiles_x, tile_w, tile_h, lay.ww,
      chunk,
      max_pairs, eps, alpha_clamp, alpha_min, bg0, bg1, bg2,
      reinterpret_cast<float4*>(out), nc);
  return (int)cudaGetLastError();
}
