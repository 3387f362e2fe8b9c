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
// Bound on the H100: the work depends on the data. A live evaluation
// costs 54 operations as written below (dx, dy, 9 for power, 3 tests,
// expf and its product, the clamp, the alpha test, 1 - alpha, the T
// division, 5 for c . u, the weight, 4 for dL/da, 2 for sigma, 2 for
// dpow, 20 for the nine running sums); the bytes are the 9 table rows of
// every pair read once, 24 B per pixel read (gout, t_n, nc) and the
// (16, P) dfeat written once. Both give a few hundredths of a millisecond
// at the 1M step; the kernel is bound by the evaluations it executes and
// by the per-pair reductions.
//
// Design: the staging, cull and warp rectangles of kernel C
// (raster_stage.cuh), recomputed here (the forward stores nothing new),
// on the reverse walk clipped at start + the CTA's largest nc (later
// pairs had no weight in the forward, as the TPU kernel's clip at
// :370-372). Chunks are taken last to first at the original positions,
// segments and their survivors back to front. A warp skips a survivor
// whose box misses its rectangle or that lies past every one of its
// pixels' nc (both warp-uniform). Each thread runs the serial recurrence
// of its kPpt (at most 4) pixels and adds their nine terms in registers;
// a warp that used the pair sums them by shuffles (9 x 5 per pair and
// warp, however many pixels a thread holds; a transposed reduction of 16
// shuffles measured slower on the H100) and lane 0 writes them to the
// warp's own slots of a [warp][9][chunk] shared array and sets the pair's
// bit in the warp's mask of the segment: no shared atomics. After a
// barrier, one thread per surviving pair adds the slots of the warps
// whose bit is set, in warp order (so the sum inside a CTA is
// deterministic), turns the nine sums into the nine gradient rows and
// adds each non-zero one to dfeat: with a global atomicAdd where the
// member tiles of a tile group share the range (a neighbour tile has the
// same non-empty range), with a plain store otherwise (then the CTA owns
// the range). Chunk k - 1's
// loads are issued into registers before chunk k composites and culled
// into the other stage during chunk k's sums; two barriers a chunk. The
// caller zeroes dfeat; rows 9-15 stay zero. Where groups share ranges the
// atomics make the summation order vary from run to run, so the kernel is
// held to its plain version with a tolerance scaled to each row, not
// equality. The per-pixel arithmetic follows the plain version operation
// for operation (-fmad=false keeps nvcc from fusing it), so the live
// decisions and the recovered T agree; only the sums are reordered.

#include "raster_stage.cuh"

namespace {

using namespace gsplat_raster;

constexpr int kSums = 9;  // pixel sums reduced per pair

__host__ __device__ inline size_t acc_offset(int chunk) {
  return (stage_bytes(chunk) + 15) / 16 * 16;
}

__host__ __device__ inline size_t bwd_smem_bytes(int chunk, int warps) {
  const int nseg = (chunk + 31) / 32;
  return acc_offset(chunk) + (size_t)warps * kSums * chunk * sizeof(float) +
         (size_t)warps * nseg * sizeof(unsigned);
}

// True when a neighbouring tile composites the same non-empty range (the
// member tiles of a tile group).
__device__ bool range_is_shared(const int* __restrict__ starts,
                                const int* __restrict__ ends, int tid,
                                int tiles_x, int num_tiles) {
  const int s = starts[tid], e = ends[tid];
  if (e <= s) return false;
  const int col = tid % tiles_x;
  const int nb[4] = {col > 0 ? tid - 1 : -1,
                     col + 1 < tiles_x ? tid + 1 : -1, tid - tiles_x,
                     tid + tiles_x};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = nb[i];
    if (n >= 0 && n < num_tiles && starts[n] == s && ends[n] == e) {
      return true;
    }
  }
  return false;
}

template <int kPpt>
__global__ void __launch_bounds__(kMaxThreads)
rasterize_bwd_kernel(const float* __restrict__ feats, int p,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const float4* __restrict__ gout,
                     const float* __restrict__ t_n,
                     const float* __restrict__ nc, int tiles_x, int tile_w,
                     int tile_h, int ww, int chunk, int max_pairs,
                     float alpha_clamp, float alpha_min, float bg0, float bg1,
                     float bg2, float* __restrict__ dfeat) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_max_nc;
  const int nwarps = blockDim.x >> 5;
  const int nseg = (chunk + 31) / 32;
  float* const acc = reinterpret_cast<float*>(smem + acc_offset(chunk));
  unsigned* const used_mask =
      reinterpret_cast<unsigned*>(acc + (size_t)nwarps * kSums * chunk);

  const int tid = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lpc = 32 / ww;
  const int wh = lpc * kPpt;
  const int wx0 = (warp % (tile_w / ww)) * ww;
  const int wy0 = (warp / (tile_w / ww)) * wh;
  const int lx = wx0 + lane % ww;
  const int ly0 = wy0 + lane / ww;
  const float tx0 = (float)((tid % tiles_x) * tile_w);
  const float ty0 = (float)((tid / tiles_x) * tile_h);
  const float px = tx0 + (float)lx;
  const float wrx0 = tx0 + (float)wx0, wrx1 = wrx0 + (float)(ww - 1);
  const float wry0 = ty0 + (float)wy0, wry1 = wry0 + (float)(wh - 1);
  const float crx1 = tx0 + (float)(tile_w - 1);
  const float cry1 = ty0 + (float)(tile_h - 1);
  const int start = starts[tid];
  const size_t npix = (size_t)tile_w * tile_h;

  float py[kPpt], t[kPpt], sigma[kPpt], g_tn[kPpt];
  float ux[kPpt], uy[kPpt], uz[kPpt];
  int live_limit[kPpt];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int ly = ly0 + k * lpc;
    py[k] = ty0 + (float)ly;
    const size_t me = tid * npix + (size_t)ly * tile_w + lx;
    const float4 u = gout[me];
    const int my_nc = (int)nc[me];
    ux[k] = u.x;
    uy[k] = u.y;
    uz[k] = u.z;
    t[k] = t_n[me];
    g_tn[k] = ((bg0 * u.x + bg1 * u.y + bg2 * u.z) - u.w) * t_n[me];
    sigma[k] = 0.0f;
    live_limit[k] = start + my_nc;
    my_max = max(my_max, my_nc);
  }
  if (threadIdx.x == 0) s_max_nc = 0;
  __syncthreads();
  for (int o = 16; o > 0; o >>= 1) {
    my_max = max(my_max, __shfl_xor_sync(kFull, my_max, o));
  }
  const int warp_live_end = start + my_max;  // no pixel of the warp past it
  if (lane == 0) atomicMax(&s_max_nc, my_max);
  __syncthreads();
  const int end = (int)min(min((long long)ends[tid],
                               (long long)start + max_pairs),
                           (long long)start + s_max_nc);
  if (end <= start) return;  // the same for the whole CTA
  const bool shared_range =
      range_is_shared(starts, ends, tid, tiles_x, gridDim.x);

  const int nchunks = (end - start + chunk - 1) / chunk;
  float v[kRounds][kRows];
  {
    const int base = start + (nchunks - 1) * chunk;
    load_chunk(feats, p, base, end - base, v);
    compact_chunk(v, base, end - base, chunk, alpha_min, tx0, crx1, ty0,
                  cry1, stage_at(smem, chunk, 0));
  }
  __syncthreads();
  for (int it = 0; it < nchunks; ++it) {
    const int kc = nchunks - 1 - it;
    const Stage cur = stage_at(smem, chunk, it & 1);
    const int nbase = start + (kc - 1) * chunk;  // the next chunk, if any
    if (kc > 0) load_chunk(feats, p, nbase, chunk, v);
    for (int s = nseg - 1; s >= 0; --s) {
      unsigned used = 0u;
      for (int i = cur.cnt[s] - 1; i >= 0; --i) {
        const int slot = (s << 5) + i;
        const float4 g2 = cur.g2[slot];  // op, position, -tau_m
        const int pos = __float_as_int(g2.y);
        if (pos >= warp_live_end ||
            misses(cur.box[slot], wrx0, wrx1, wry0, wry1)) {
          continue;  // warp-uniform
        }
        const float4 g0 = cur.g0[slot];  // x, y, conic a, conic b
        const float4 g1 = cur.g1[slot];  // conic c, r, g, b
        const float dx = g0.x - px;
        float sum[kSums];
#pragma unroll
        for (int f = 0; f < kSums; ++f) sum[f] = 0.0f;
        bool any = false;
#pragma unroll
        for (int k = 0; k < kPpt; ++k) {
          const float dy = g0.y - py[k];
          const float power =
              -0.5f * (g0.z * dx * dx + g1.x * dy * dy) - g0.w * dx * dy;
          if (power > 0.0f || power < g2.z || pos >= live_limit[k]) continue;
          const float a_raw = g2.x * expf(power);
          const float alpha = fminf(alpha_clamp, a_raw);
          if (alpha < alpha_min) continue;
          const float one_minus = 1.0f - alpha;
          t[k] = t[k] / one_minus;  // T before this pair
          const float cu = g1.y * ux[k] + g1.z * uy[k] + g1.w * uz[k];
          const float w = alpha * t[k];
          const float d_alpha = t[k] * cu - (sigma[k] + g_tn[k]) / one_minus;
          sigma[k] = sigma[k] + w * cu;
          const float dpow = a_raw < alpha_clamp ? d_alpha * alpha : 0.0f;
          sum[0] += dpow;
          sum[1] += dpow * dx;
          sum[2] += dpow * dy;
          sum[3] += dpow * dx * dx;
          sum[4] += dpow * dy * dy;
          sum[5] += dpow * dx * dy;
          sum[6] += w * ux[k];
          sum[7] += w * uy[k];
          sum[8] += w * uz[k];
          any = true;
        }
        if (__any_sync(kFull, any)) {
#pragma unroll
          for (int f = 0; f < kSums; ++f) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              sum[f] += __shfl_down_sync(kFull, sum[f], o);
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int f = 0; f < kSums; ++f) {
              acc[((size_t)warp * kSums + f) * chunk + slot] = sum[f];
            }
            used |= 1u << i;
          }
        }
      }
      if (lane == 0) used_mask[warp * nseg + s] = used;
    }
    __syncthreads();  // the chunk's sums and masks are complete
    for (int slot = threadIdx.x; slot < nseg * 32; slot += blockDim.x) {
      const int s = slot >> 5, i = slot & 31;
      if (i >= cur.cnt[s]) continue;
      float sm[kSums];
#pragma unroll
      for (int f = 0; f < kSums; ++f) sm[f] = 0.0f;
      for (int w = 0; w < nwarps; ++w) {
        if ((used_mask[w * nseg + s] >> i) & 1u) {
#pragma unroll
          for (int f = 0; f < kSums; ++f) {
            sm[f] += acc[((size_t)w * kSums + f) * chunk + slot];
          }
        }
      }
      const float4 g0 = cur.g0[slot];
      const float4 g1 = cur.g1[slot];
      const float4 g2 = cur.g2[slot];
      const float ca = g0.z, cb = g0.w, cc = g1.x;
      float grow[kRows];
      grow[0] = -(ca * sm[1] + cb * sm[2]);
      grow[1] = -(cc * sm[2] + cb * sm[1]);
      grow[2] = -0.5f * sm[3];
      grow[3] = -sm[5];
      grow[4] = -0.5f * sm[4];
      grow[5] = sm[6];
      grow[6] = sm[7];
      grow[7] = sm[8];
      grow[8] = sm[0] / fmaxf(g2.x, alpha_min);
      const size_t pos = (size_t)__float_as_int(g2.y);
#pragma unroll
      for (int f = 0; f < kRows; ++f) {
        if (grow[f] != 0.0f) {
          float* dst = dfeat + (size_t)f * p + pos;
          if (shared_range) {
            atomicAdd(dst, grow[f]);
          } else {
            *dst = grow[f];
          }
        }
      }
    }
    if (kc > 0) {
      compact_chunk(v, nbase, chunk, chunk, alpha_min, tx0, crx1, ty0, cry1,
                    stage_at(smem, chunk, (it + 1) & 1));
    }
    __syncthreads();  // the next stage is ready; acc and masks are free
  }
}

using Kernel = void (*)(const float*, int, const int*, const int*,
                        const float4*, const float*, const float*, int, int,
                        int, int, int, int, float, float, float, float, float,
                        float*);

}  // namespace

// dfeat must hold zeros on entry; gout is (T, NPIX) float4, t_n and nc
// (T, NPIX) f32. The tile and chunk must admit a layout (raster_stage.cuh:
// choose_layout), else cudaErrorInvalidConfiguration.
extern "C" int gsplat_rasterize_bwd(const float* feats, int p,
                                    const int* starts, const int* ends,
                                    const float* gout, const float* t_n,
                                    const float* nc, int num_tiles,
                                    int tiles_x, int tile_w, int tile_h,
                                    int chunk, int max_pairs,
                                    float alpha_clamp, float alpha_min,
                                    float bg0, float bg1, float bg2,
                                    float* dfeat, void* stream) {
  Layout lay;
  if (!choose_layout(tile_w, tile_h, chunk, kBwdMaxPpt, &lay)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const Kernel fn = lay.ppt == 4   ? &rasterize_bwd_kernel<4>
                    : lay.ppt == 2 ? &rasterize_bwd_kernel<2>
                                   : &rasterize_bwd_kernel<1>;
  const size_t smem = bwd_smem_bytes(chunk, lay.threads / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<num_tiles, lay.threads, smem, (cudaStream_t)stream>>>(
      feats, p, starts, ends, reinterpret_cast<const float4*>(gout), t_n, nc,
      tiles_x, tile_w, tile_h, lay.ww, chunk, max_pairs, alpha_clamp,
      alpha_min, bg0, bg1, bg2, dfeat);
  return (int)cudaGetLastError();
}
