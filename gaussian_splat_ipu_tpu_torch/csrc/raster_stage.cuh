// Staging shared by kernels C (rasterize.cu) and D (rasterize_bwd.cu): the
// thread layout, the per-pair tile cull and the compaction of each chunk
// of a tile's pair range into shared memory.
//
// Layout. A CTA holds one framebuffer tile; each thread owns kPpt pixels
// of one column, and each warp a compact ww x wh pixel rectangle:
// ww = min(16, lowest set bit of tile_w), 32 / ww lanes per column, and
// wh = (32 / ww) * kPpt rows. choose_layout takes the largest kPpt in
// {4, 2, 1}, up to the kernel's cap, whose warp rectangles tile the tile,
// with at most kMaxThreads threads and a chunk that the threads stage in
// at most kRounds rounds. The caps were measured on an H100 at 32x32
// tiles: kernel C runs best at 2 pixels a thread (64 registers, 512
// threads, twice the resident warps of 4 pixels at 87 registers), kernel
// D at 4 (its per-pair warp reduction is shared by more pixels). The
// plain twin of the rule is render/kernels/rasterize.py::_layout.
//
// Cull. A pair contributes to a pixel only when power <= 0 and
// alpha = min(alpha_clamp, op exp(power)) >= alpha_min. With
// Q = A dx^2 + 2B dx dy + C dy^2 (power = -Q / 2), det = AC - B^2 > 0 and
// A > 0, the set Q <= 2 tau_m is an ellipse whose half-extents are
// sqrt(2 tau_m C / det) in x and sqrt(2 tau_m A / det) in y, so a pixel
// outside that box has Q > 2 tau_m. pair_box takes
//   tau_m = 1.05 ln(op / alpha_min) + 0.05,
//   r = sqrt(2 tau_m (C or A) / det) * 1.01 + 0.5,
// and the box [x - rx, x + rx] x [y - ry, y + ry]. Why a pixel outside it
// is skipped in f32 too: the kernels' power (-0.5 (A dx dx + C dy dy)
// - B dx dy, dx = x - px) carries at most about 6u of rounding of
// T = A dx^2 + C dy^2 + 2|B dx dy| (u = 2^-24), and for a positive
// definite conic T <= 2 (A dx^2 + C dy^2) <= 4 kappa Q with
// kappa = AC / det. The box is used only when kappa <= kKappaMax = 1e4
// (det itself then rounds by under 0.3%), so the computed Q is at least
// 0.985 Q > 0.985 * 2 tau_m >= 2 tau + 0.098: op expf(power) is below
// alpha_min e^-0.049, far more than expf's and the product's few ulps.
// The 1.01 factor covers the rounding of r, and the 0.5 pixel that of
// x +- r at pixel coordinates under 2^22 (4096 tiles of at most 1024
// pixels). The same bound lets a pixel skip expf when power < -tau_m.
// Pairs with op < alpha_min are always culled: for power <= 0,
// expf(power) <= 1, so op expf(power) <= op < alpha_min (alpha_min > 0).
// A pair with a non-finite value, A <= 0, det <= 0 or kappa > kKappaMax,
// or any pair when alpha_min <= 0, is never culled (an infinite box, and
// -inf as its expf threshold). A culled pair is one every pixel of the
// rectangle would have skipped, so culling changes no output bit. The
// plain twin is render/tile_raster.py::tile_cull_torch.
//
// Compaction. A chunk's pairs are cut into segments of 32 consecutive
// positions; one warp stages a segment (one pair a lane), tests it
// against the CTA's pixel-centre rectangle and writes the survivors, in
// their original order, to the segment's slots with a ballot and a
// popcount; lane 0 writes the survivor count. Segments are walked in
// order, so no prefix across warps is needed. Per surviving pair four
// 16-byte words: box (x0, x1, y0, y1), g0 (x, y, A, B), g1 (C, r, g, b),
// g2 (op, position as int bits, -tau_m, 0): one LDS.128 to test the box
// for a warp, three more to composite it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace gsplat_raster {

constexpr int kRows = 9;          // FEAT_X .. FEAT_OPACITY of the pair table
constexpr int kRounds = 2;        // staging rounds: chunk <= 2 x threads
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kKappaMax = 1.0e4f;

struct Layout {
  int ppt = 0;      // pixels per thread
  int ww = 0;       // warp rectangle width
  int threads = 0;
};

constexpr int kFwdMaxPpt = 2;
constexpr int kBwdMaxPpt = 4;

inline bool choose_layout(int tile_w, int tile_h, int chunk, int max_ppt,
                          Layout* out) {
  if (tile_w <= 0 || tile_h <= 0 || chunk <= 0) return false;
  const int low = tile_w & -tile_w;
  const int ww = low < 16 ? low : 16;
  for (int ppt = max_ppt; ppt >= 1; ppt /= 2) {
    const int wh = (32 / ww) * ppt;
    const int threads = tile_w * tile_h / ppt;
    if (tile_h % wh == 0 && threads <= kMaxThreads &&
        chunk <= kRounds * threads) {
      out->ppt = ppt;
      out->ww = ww;
      out->threads = threads;
      return true;
    }
  }
  return false;
}

// Shared buffers of one stage: four float4 words per slot, one survivor
// count per segment.
struct Stage {
  float4* box;
  float4* g0;
  float4* g1;
  float4* g2;
  int* cnt;
};

// Two stages, then the counts, in one dynamic shared block.
__host__ __device__ inline size_t stage_bytes(int chunk) {
  const int nseg = (chunk + 31) / 32;
  return 2 * (size_t)chunk * 4 * sizeof(float4) +
         2 * (size_t)nseg * sizeof(int);
}

__device__ inline Stage stage_at(char* base, int chunk, int which) {
  const int nseg = (chunk + 31) / 32;
  float4* words = reinterpret_cast<float4*>(base) + (size_t)which * 4 * chunk;
  int* cnt = reinterpret_cast<int*>(reinterpret_cast<float4*>(base) +
                                    (size_t)8 * chunk) + which * nseg;
  return Stage{words, words + chunk, words + 2 * chunk, words + 3 * chunk,
               cnt};
}

// The cull box of one pair and its expf threshold (see the note above).
__device__ __forceinline__ void pair_box(const float (&v)[kRows],
                                         float alpha_min, float4* box,
                                         float* neg_tau) {
  const float x = v[0], y = v[1], a = v[2], b = v[3], c = v[4], op = v[8];
  if (alpha_min > 0.0f && op < alpha_min) {
    *box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
    *neg_tau = INFINITY;
    return;
  }
  const float ac = a * c;
  const float det = ac - b * b;
  const bool ok = alpha_min > 0.0f && isfinite(x) && isfinite(y) &&
                  isfinite(a) && isfinite(b) && isfinite(c) &&
                  isfinite(op) && isfinite(ac) && a > 0.0f && det > 0.0f &&
                  ac <= kKappaMax * det;
  if (!ok) {
    *box = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
    *neg_tau = -INFINITY;
    return;
  }
  const float tau = 1.05f * logf(op / alpha_min) + 0.05f;
  const float rx = sqrtf(2.0f * tau * c / det) * 1.01f + 0.5f;
  const float ry = sqrtf(2.0f * tau * a / det) * 1.01f + 0.5f;
  *box = make_float4(x - rx, x + rx, y - ry, y + ry);
  *neg_tau = -tau;
}

// True when the box misses the pixel-centre rectangle [x0, x1] x [y0, y1].
__device__ __forceinline__ bool misses(const float4& box, float x0,
                                       float x1, float y0, float y1) {
  return box.y < x0 || box.x > x1 || box.w < y0 || box.z > y1;
}

// Issue the global loads of the pairs [base, base + m) that this thread
// stages: pair j = threadIdx.x + r * blockDim.x in round r.
__device__ __forceinline__ void load_chunk(const float* __restrict__ feats,
                                           int p, int base, int m,
                                           float (&v)[kRounds][kRows]) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int j = threadIdx.x + r * blockDim.x;
    if (j < m) {
#pragma unroll
      for (int f = 0; f < kRows; ++f) {
        v[r][f] = __ldg(feats + (size_t)f * p + base + j);
      }
    }
  }
}

// Cull the loaded pairs against the CTA rectangle and compact the
// survivors of each segment into `st`. Every thread of the CTA calls it;
// segments at or past ceil(chunk / 32) do not exist.
__device__ __forceinline__ void compact_chunk(
    const float (&v)[kRounds][kRows], int base, int m, int chunk,
    float alpha_min, float x0, float x1, float y0, float y1,
    const Stage& st) {
  const int nseg = (chunk + 31) / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int j = threadIdx.x + r * blockDim.x;
    const int seg = j >> 5;
    if (seg >= nseg) continue;  // warp-uniform: whole segments
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    float neg_tau = 0.0f;
    bool keep = false;
    if (j < m) {
      pair_box(v[r], alpha_min, &box, &neg_tau);
      keep = !misses(box, x0, x1, y0, y1);
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (keep) {
      const int slot = (seg << 5) + __popc(ballot & ((1u << lane) - 1u));
      st.box[slot] = box;
      st.g0[slot] = make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
      st.g1[slot] = make_float4(v[r][4], v[r][5], v[r][6], v[r][7]);
      st.g2[slot] = make_float4(v[r][8], __int_as_float(base + j), neg_tau,
                                0.0f);
    }
    if (lane == 0) st.cnt[seg] = __popc(ballot);
  }
}

}  // namespace gsplat_raster
