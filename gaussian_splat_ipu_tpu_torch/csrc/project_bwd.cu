// Kernel G-bwd: the backward of the projection stage, the gradients of
// kernel G's differentiable outputs (xy, depth, conic, colour, opacity)
// with respect to the gaussians' parameters, in one pass over them.
//
// Replaces no TPU kernel: the JAX package leaves projection and its
// derivative to XLA (gaussian_splat_ipu_tpu/render/projection.py). Plain
// twin: render/kernels/project.py::project_gaussians_bwd_torch, written
// from the same formulas; on the card it is held to PyTorch's autograd
// of render/projection.py::project_gaussians_torch, which it replaces on
// the fit steps' path (some 250 elementwise kernels, and the SH slices'
// full-size zero gradients summed 16 times).
//
// Per gaussian: the forward again, with G's functions (project_common.cuh),
// so that every branch is G's; then reverse mode through it in the order
// autograd takes: the colour's clamp at 0, the SH bands up to the active
// degree (higher bands get 0) and the view direction (the environment
// rotation, the division by the norm floored at 1e-8); the sigmoid and the
// antialias factor; the conic (no gradient through 1 / det where
// det <= 1e-12); the EWA projection with the 1.3 tan_fov clamp (the clamped
// side passes nothing through tx / tz); the 3D covariance, exp of the
// log-scales and the quaternion's normalisation (no floor, as
// ops/transforms.quat_to_rotmat); the clip and view transforms. Masks act
// on gradients as autograd's where() does, and products by a forward value
// are taken unconditionally, so a non-finite intermediate spreads as it
// does in autograd (a zero quaternion's NaN); a quotient's gradient by its
// divisor is autograd's -g (x / y) / y, which stays finite where y * y
// would overflow (a gaussian at the camera's origin). The extents and the
// cull have no gradient (ceil; radius is not differentiable).
//
// A gaussian whose ten cotangents are all zero (culled, off screen, a dead
// slot of a density-control buffer) gets exact zeros in every field
// without reading its parameters: Adam's eps of 1e-15 would turn any
// residue into a full step. A block with no such gaussian reads nothing
// but its cotangents and writes zeros.
//
// The view matrix's gradient (project_bwd_view_kernel, launched only where
// a gradient is asked for the view: pose refinement). The view enters
// three places, and each live gaussian adds to each: the view transform
// vh = V [m, 1] (through xy, depth and the EWA Jacobian's tx, ty, tz),
// whose term is vh's cotangent times [m, 1]; W = V[:3, :3] in U = J W,
// whose term is U's cotangent times the Jacobian; and the camera origin
// -(R^T t) in the SH view direction, reduced here as the 3-vector sum of
// the direction's cotangents and chained to R and t after the launch
// (render/kernels/project.py::view_grad). Each block writes its kViewParts
// sums (a shuffle tree per warp, then the warps in order) to its own row
// of the partials; one torch.sum over the rows follows: no atomics, the
// same bits on every run. A block without a live gaussian writes a row of
// zeros. The camera-free kernel (project_bwd_kernel) is the same body
// without these sums.
//
// Bound on the H100: bytes. Read per gaussian: 236 B of parameters at SH 3
// and the 40 B of cotangents given; written: 236 B of gradients and, with
// an xy probe, its 8 B: about 545 MB at 2^20, 0.16 ms at 3.35 TB/s. The
// view kernel adds 112 B of partials a block of 128: 0.9 MB at 2^20. Some
// 800 flops per gaussian stay far below the FP32 rate. Design: one thread
// per gaussian, kThreads a block; the SH coefficients come in through
// shared memory as in G, and the (N, K, 3) SH gradient, 81% of the bytes
// written, goes out the same way: each thread writes its row into shared
// memory, then the block stores its rows' one contiguous span with
// coalesced 16-byte stores. The cotangents may be column views of a wider
// row (the pair table's VJP hands them so): each comes with a row stride.

#include "project_common.cuh"

namespace {

// Writes `rows` rows of `width` floats from src (row r at r * stride) to
// the contiguous span dst (row r at r * width), 16 bytes a store where dst
// is aligned.
__device__ void unstage_rows(float* __restrict__ dst, const float* src,
                             int rows, int width, int stride) {
  const int total = rows * width;
  int done = 0;
  if (((uintptr_t)dst & 15) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const int vecs = total >> 2;
    for (int v = threadIdx.x; v < vecs; v += kThreads) {
      int r = (4 * v) / width;
      int c = 4 * v - r * width;
      float vals[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        vals[k] = src[r * stride + c];
        if (++c == width) {
          c = 0;
          ++r;
        }
      }
      dst4[v] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    }
    done = 4 * vecs;
  }
  for (int e = done + threadIdx.x; e < total; e += kThreads) {
    const int r = e / width;
    dst[e] = src[r * stride + e - r * width];
  }
}

// Zeros `count` floats from dst on, 16 bytes a store where dst is aligned.
__device__ void zero_span(float* __restrict__ dst, int count) {
  int done = 0;
  if (((uintptr_t)dst & 15) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const int vecs = count >> 2;
    for (int v = threadIdx.x; v < vecs; v += kThreads) {
      dst4[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    done = 4 * vecs;
  }
  for (int e = done + threadIdx.x; e < count; e += kThreads) dst[e] = 0.0f;
}

// The SH basis (coefficient k's factor in eval_sh) at (x, y, z), bands up
// to `degree`.
__device__ __forceinline__ void sh_basis(int degree, float x, float y,
                                         float z, float b[kMaxCoeffs]) {
  b[0] = kC0;
  if (degree >= 1) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if (degree >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[4] = kC2[0] * (x * y);
    b[5] = kC2[1] * (y * z);
    b[6] = kC2[2] * ((2.0f * zz - xx) - yy);
    b[7] = kC2[3] * (x * z);
    b[8] = kC2[4] * (xx - yy);
    if (degree >= 3) {
      b[9] = (kC3[0] * y) * (3.0f * xx - yy);
      b[10] = (kC3[1] * (x * y)) * z;
      b[11] = (kC3[2] * y) * ((4.0f * zz - xx) - yy);
      b[12] = (kC3[3] * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      b[13] = (kC3[4] * x) * ((4.0f * zz - xx) - yy);
      b[14] = (kC3[5] * z) * (xx - yy);
      b[15] = (kC3[6] * x) * (xx - 3.0f * yy);
    }
  }
}

// Adds g times the gradient of eval_sh(f, degree, x, y, z) with respect to
// the direction to (gx, gy, gz); coefficient k at f[3 * k].
__device__ __forceinline__ void sh_dir_grad(const float* f, int degree,
                                            float x, float y, float z,
                                            float g, float& gx, float& gy,
                                            float& gz) {
  float dx = -kC1 * f[9], dy = -kC1 * f[3], dz = kC1 * f[6];
  if (degree >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    dx += kC2[0] * y * f[12] - 2.0f * kC2[2] * x * f[18]
          + kC2[3] * z * f[21] + 2.0f * kC2[4] * x * f[24];
    dy += kC2[0] * x * f[12] + kC2[1] * z * f[15]
          - 2.0f * kC2[2] * y * f[18] - 2.0f * kC2[4] * y * f[24];
    dz += kC2[1] * y * f[15] + 4.0f * kC2[2] * z * f[18]
          + kC2[3] * x * f[21];
    if (degree >= 3) {
      dx += kC3[0] * (6.0f * x * y) * f[27] + kC3[1] * (y * z) * f[30]
            - kC3[2] * (2.0f * x * y) * f[33]
            - kC3[3] * (6.0f * x * z) * f[36]
            + kC3[4] * ((4.0f * zz - 3.0f * xx) - yy) * f[39]
            + kC3[5] * (2.0f * x * z) * f[42]
            + kC3[6] * (3.0f * xx - 3.0f * yy) * f[45];
      dy += kC3[0] * (3.0f * xx - 3.0f * yy) * f[27]
            + kC3[1] * (x * z) * f[30]
            + kC3[2] * ((4.0f * zz - xx) - 3.0f * yy) * f[33]
            - kC3[3] * (6.0f * y * z) * f[36]
            - kC3[4] * (2.0f * x * y) * f[39]
            - kC3[5] * (2.0f * y * z) * f[42]
            - kC3[6] * (6.0f * x * y) * f[45];
      dz += kC3[1] * (x * y) * f[30] + kC3[2] * (8.0f * y * z) * f[33]
            + kC3[3] * ((6.0f * zz - 3.0f * xx) - 3.0f * yy) * f[36]
            + kC3[4] * (8.0f * x * z) * f[39]
            + kC3[5] * (xx - yy) * f[42];
    }
  }
  gx += g * dx;
  gy += g * dy;
  gz += g * dz;
}

// The cotangent at row i of a column view with row stride s (column 0 at
// p), or 0 without one.
__device__ __forceinline__ float cot(const float* __restrict__ p, int s,
                                     int i, int col) {
  return p ? p[(size_t)i * s + col] : 0.0f;
}

// The view gradient's partial sums, in this order: the view transform's
// term (16, row-major as V), the EWA W term (9, row-major as W), the sum of
// the SH view direction's cotangents (3).
constexpr int kViewParts = 28;
constexpr int kWarps = kThreads / 32;

// The block's sum of each thread's `part` (every thread calls this), in
// `out` (its row of the partials) by threads 0..kViewParts-1.
__device__ __forceinline__ void reduce_view_parts(float part[kViewParts],
                                                  float* __restrict__ out) {
  __shared__ float warp_sums[kWarps][kViewParts];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kViewParts; ++j) {
    float v = part[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) warp_sums[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kViewParts) {
    float s = warp_sums[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

template <bool kView>
__device__ __forceinline__ void project_bwd_body(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ opacities,
    const float* __restrict__ sh, int n, int sh_row, int degree,
    const float* __restrict__ view, const float* __restrict__ proj,
    const float* __restrict__ env_rot, float width, float height,
    float lowpass, int flags, const float* __restrict__ g_xy, int s_xy,
    const float* __restrict__ g_depth, int s_depth,
    const float* __restrict__ g_conic, int s_conic,
    const float* __restrict__ g_color, int s_color,
    const float* __restrict__ g_opacity, int s_opacity,
    float* __restrict__ d_means, float* __restrict__ d_log_scales,
    float* __restrict__ d_quats, float* __restrict__ d_opacities,
    float* __restrict__ d_sh, float2* __restrict__ d_probe,
    float* __restrict__ d_view_part) {
  __shared__ CameraConsts cam;
  __shared__ float sh_s[kThreads * kMaxStride];
  const int b0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - b0);
  const int t = threadIdx.x;
  const int i = b0 + t;
  const bool in_range = t < rows;

  float gxy[2] = {0.0f, 0.0f}, gd = 0.0f, gcon[3] = {0.0f, 0.0f, 0.0f};
  float gcol[3] = {0.0f, 0.0f, 0.0f}, gop = 0.0f;
  if (in_range) {
    for (int k = 0; k < 2; ++k) gxy[k] = cot(g_xy, s_xy, i, k);
    gd = cot(g_depth, s_depth, i, 0);
    for (int k = 0; k < 3; ++k) {
      gcon[k] = cot(g_conic, s_conic, i, k);
      gcol[k] = cot(g_color, s_color, i, k);
    }
    gop = cot(g_opacity, s_opacity, i, 0);
    // xy = G's xy + probe: the probe's gradient is xy's cotangent.
    if (d_probe) d_probe[i] = make_float2(gxy[0], gxy[1]);
  }
  const bool live = in_range
                    && (gxy[0] != 0.0f || gxy[1] != 0.0f || gd != 0.0f
                        || gcon[0] != 0.0f || gcon[1] != 0.0f
                        || gcon[2] != 0.0f || gcol[0] != 0.0f
                        || gcol[1] != 0.0f || gcol[2] != 0.0f
                        || gop != 0.0f);
  if (!__syncthreads_or(live)) {
    zero_span(d_means + 3 * (size_t)b0, 3 * rows);
    zero_span(d_log_scales + 3 * (size_t)b0, 3 * rows);
    zero_span(d_quats + 4 * (size_t)b0, 4 * rows);
    zero_span(d_opacities + b0, rows);
    zero_span(d_sh + (size_t)b0 * sh_row, rows * sh_row);
    if constexpr (kView) {
      if (t < kViewParts) d_view_part[blockIdx.x * kViewParts + t] = 0.0f;
    }
    return;
  }

  float m[3], ls[3], q[4], op_raw = 0.0f;
  if (live) {
    for (int k = 0; k < 3; ++k) {
      m[k] = means[3 * (size_t)i + k];
      ls[k] = log_scales[3 * (size_t)i + k];
    }
    for (int k = 0; k < 4; ++k) q[k] = quats[4 * (size_t)i + k];
    op_raw = opacities[i];
  }
  if (t == 0) {
    load_camera(cam, view, proj, env_rot, 0.5f * width, 0.5f * height);
  }
  const int nb = (degree + 1) * (degree + 1);
  const int stride_in = (3 * nb) | 1;
  stage_sh(sh_s, sh, b0, rows, sh_row, 3 * nb, stride_in);
  __syncthreads();

  float dm[3] = {0.0f, 0.0f, 0.0f}, dls[3] = {0.0f, 0.0f, 0.0f};
  float dq[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dop = 0.0f;
  float graw[3] = {0.0f, 0.0f, 0.0f};
  float x = 0.0f, y = 0.0f, z = 0.0f;
  float vpart[kView ? kViewParts : 1];
  if constexpr (kView) {
    for (int j = 0; j < kViewParts; ++j) vpart[j] = 0.0f;
  }
  if (live) {
    const float* v = cam.view;
    const float* p = cam.proj;
    // The extents are not differentiated: alpha_min and the cap are moot.
    Projected g;
    project_one(cam, m, ls, q, op_raw, width, height, lowpass, 1.0f, 0.0f,
                flags & (kSigmoid | kAntialias), g);

    // The colour: clamp at 0, the SH bands, the view direction.
    ViewDir dir;
    if (degree >= 1) {
      view_dir(cam, m, dir);
      x = dir.x;
      y = dir.y;
      z = dir.z;
    }
    const float* f = sh_s + t * stride_in;
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
    for (int ch = 0; ch < 3; ++ch) {
      const float raw = eval_sh(f + ch, degree, x, y, z) + 0.5f;
      graw[ch] = raw >= 0.0f ? gcol[ch] : 0.0f;
      if (degree >= 1) sh_dir_grad(f + ch, degree, x, y, z, graw[ch], gx, gy,
                                   gz);
    }
    if (degree >= 1) {
      const float* rot = cam.rot;
      float ge[3];
      for (int j = 0; j < 3; ++j) {
        ge[j] = (gx * rot[j] + gy * rot[3 + j]) + gz * rot[6 + j];
      }
      const float g_nrm = -((ge[0] * (dir.e[0] / dir.nrm)
                             + ge[1] * (dir.e[1] / dir.nrm))
                            + ge[2] * (dir.e[2] / dir.nrm));
      const float g_raw = dir.nrm_raw >= (float)1e-8 ? g_nrm : 0.0f;
      const float scale = dir.nrm_raw == 0.0f ? 0.0f : g_raw / dir.nrm_raw;
      for (int j = 0; j < 3; ++j) dm[j] = ge[j] / dir.nrm + dir.d[j] * scale;
      // d = m - origin: the direction's cotangent, summed for the origin.
      if constexpr (kView) {
        for (int j = 0; j < 3; ++j) vpart[25 + j] = dm[j];
      }
    }

    // Opacity: the antialias factor, the sigmoid.
    float g_act = gop, g_aa = 0.0f;
    if (flags & kAntialias) {
      g_act = gop * g.aa;
      g_aa = gop * g.op_act;
    }
    dop = (flags & kSigmoid) ? g_act * (1.0f - g.op_act) * g.op_act : g_act;

    // The 2D covariance (a, b, c): the antialias factor's two
    // determinants, then the conic's.
    float ga = 0.0f, gb = 0.0f, gc = 0.0f;
    if (flags & kAntialias) {
      const float g_clamped = g_aa / (2.0f * g.aa);
      const float g_ratio = (g.aa_ratio >= 0.0f && g.aa_ratio <= 1.0f)
                            ? g_clamped : 0.0f;
      const float num = clamp_min_nan(g.det_before, 0.0f);
      const float den = clamp_min_nan(g.det, (float)1e-12);
      const float g_before = g.det_before >= 0.0f ? g_ratio / den : 0.0f;
      const float g_after = g.det >= (float)1e-12
                            ? -g_ratio * ((num / den) / den) : 0.0f;
      ga = g_before * (g.c - lowpass) + g_after * g.c;
      gc = g_before * (g.a - lowpass) + g_after * g.a;
      gb = -(2.0f * g.b * g_before) - 2.0f * g.b * g_after;
    }
    const float g_det_inv = (gcon[0] * g.c - gcon[1] * g.b) + gcon[2] * g.a;
    const float gdet = g.valid ? -g_det_inv * (g.det_inv * g.det_inv)
                               : 0.0f;
    ga += gcon[2] * g.det_inv + gdet * g.c;
    gc += gcon[0] * g.det_inv + gdet * g.a;
    gb -= gcon[1] * g.det_inv + 2.0f * g.b * gdet;

    // EWA: a = u0 S u0 + lp, b = u0 S u1, c = u1 S u1 + lp, with
    // V = U S held as vv (v0 = S u0, v1 = S u1).
    const float* u = g.u;
    const float* vv = g.vv;
    const float S[9] = {g.cxx, g.cxy, g.cxz, g.cxy, g.cyy, g.cyz,
                        g.cxz, g.cyz, g.czz};
    float gv0[3], gv1[3], gu0[3], gu1[3];
    for (int k = 0; k < 3; ++k) {
      gv0[k] = ga * u[k] + gb * u[3 + k];
      gv1[k] = gc * u[3 + k];
    }
    for (int k = 0; k < 3; ++k) {
      gu0[k] = ga * vv[k] + ((gv0[0] * S[3 * k] + gv0[1] * S[3 * k + 1])
                             + gv0[2] * S[3 * k + 2]);
      gu1[k] = (gb * vv[k] + gc * vv[3 + k])
               + ((gv1[0] * S[3 * k] + gv1[1] * S[3 * k + 1])
                  + gv1[2] * S[3 * k + 2]);
    }
    const float g_cxx = gv0[0] * u[0] + gv1[0] * u[3];
    const float g_cxy = (gv0[0] * u[1] + gv0[1] * u[0])
                        + (gv1[0] * u[4] + gv1[1] * u[3]);
    const float g_cxz = (gv0[0] * u[2] + gv0[2] * u[0])
                        + (gv1[0] * u[5] + gv1[2] * u[3]);
    const float g_cyy = gv0[1] * u[1] + gv1[1] * u[4];
    const float g_cyz = (gv0[1] * u[2] + gv0[2] * u[1])
                        + (gv1[1] * u[5] + gv1[2] * u[4]);
    const float g_czz = gv0[2] * u[2] + gv1[2] * u[5];

    // U = J W: the Jacobian's entries, then tz and the clamped tx, ty.
    const float g_j00 = (gu0[0] * v[0] + gu0[1] * v[1]) + gu0[2] * v[2];
    const float g_j02 = (gu0[0] * v[8] + gu0[1] * v[9]) + gu0[2] * v[10];
    const float g_j11 = (gu1[0] * v[4] + gu1[1] * v[5]) + gu1[2] * v[6];
    const float g_j12 = (gu1[0] * v[8] + gu1[1] * v[9]) + gu1[2] * v[10];
    const float g_inv_tz2 = g_j02 * (-cam.fx * g.tx)
                            + g_j12 * (-cam.fy * g.ty);
    const float g_inv_tz = (g_j00 * cam.fx + g_j11 * cam.fy)
                           + 2.0f * g.inv_tz * g_inv_tz2;
    const float g_tx = g_j02 * g.inv_tz2 * (-cam.fx);
    const float g_ty = g_j12 * g.inv_tz2 * (-cam.fy);
    const float tz = g.vh[2];
    float g_tz = -g_inv_tz * (g.inv_tz * g.inv_tz);
    float g_vh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float lim[2] = {cam.limx, cam.limy};
    const float ratio[2] = {g.ratio_x, g.ratio_y};
    const float g_t[2] = {g_tx, g_ty};
    for (int k = 0; k < 2; ++k) {
      // t = clamp(vh[k] / tz, -lim, lim) * tz.
      g_tz += g_t[k] * clamp_nan(ratio[k], -lim[k], lim[k]);
      const float g_ratio = (ratio[k] >= -lim[k] && ratio[k] <= lim[k])
                            ? g_t[k] * tz : 0.0f;
      g_vh[k] = g_ratio / tz;
      g_tz -= g_ratio * (ratio[k] / tz);
    }
    g_vh[2] = g_tz - gd;   // depth = -tz

    // The pixel centre: (clip * ((1 / w) * 0.5) + 0.5) * size.
    const float g_px = gxy[0] * width, g_py = gxy[1] * height;
    const float g_half = g_px * g.cl[0] + g_py * g.cl[1];
    const float r_w = 1.0f / g.cl[3];
    const float g_cl[4] = {g_px * g.half_inv_w, g_py * g.half_inv_w, 0.0f,
                           -(g_half * 0.5f) * (r_w * r_w)};
    for (int k = 0; k < 4; ++k) {
      g_vh[k] += ((g_cl[0] * p[k] + g_cl[1] * p[4 + k])
                  + g_cl[2] * p[8 + k]) + g_cl[3] * p[12 + k];
    }
    for (int k = 0; k < 3; ++k) {
      dm[k] += ((g_vh[0] * v[k] + g_vh[1] * v[4 + k]) + g_vh[2] * v[8 + k])
               + g_vh[3] * v[12 + k];
    }
    if constexpr (kView) {
      // vh = V [m, 1]; u0 = j00 W[0] + j02 W[2], u1 = j11 W[1] + j12 W[2].
      for (int r = 0; r < 4; ++r) {
        for (int c = 0; c < 3; ++c) vpart[4 * r + c] = g_vh[r] * m[c];
        vpart[4 * r + 3] = g_vh[r];
      }
      for (int k = 0; k < 3; ++k) {
        vpart[16 + k] = gu0[k] * g.j00;
        vpart[19 + k] = gu1[k] * g.j11;
        vpart[22 + k] = gu0[k] * g.j02 + gu1[k] * g.j12;
      }
    }

    // Sigma = M M^T, M = R S: M's gradient, then R's, the scales' and the
    // log-scales'.
    const float* mm = g.mm;
    float gr[9];
    float gs[3] = {0.0f, 0.0f, 0.0f};
    for (int j = 0; j < 3; ++j) {
      const float gm0 = (2.0f * g_cxx * mm[j] + g_cxy * mm[3 + j])
                        + g_cxz * mm[6 + j];
      const float gm1 = (g_cxy * mm[j] + 2.0f * g_cyy * mm[3 + j])
                        + g_cyz * mm[6 + j];
      const float gm2 = (g_cxz * mm[j] + g_cyz * mm[3 + j])
                        + 2.0f * g_czz * mm[6 + j];
      gr[j] = gm0 * g.s[j];
      gr[3 + j] = gm1 * g.s[j];
      gr[6 + j] = gm2 * g.s[j];
      gs[j] = (gm0 * g.r[j] + gm1 * g.r[3 + j]) + gm2 * g.r[6 + j];
      dls[j] = gs[j] * g.s[j];
    }
    // R from the normalised quaternion (w, x, y, z), then the norm.
    const float qw = g.qw, qx = g.qx, qy = g.qy, qz = g.qz;
    const float gqn[4] = {
        2.0f * (((-qz * gr[1] + qy * gr[2]) + (qz * gr[3] - qx * gr[5]))
                + (-qy * gr[6] + qx * gr[7])),
        2.0f * (((qy * gr[1] + qz * gr[2]) + (qy * gr[3] - 2.0f * qx * gr[4]))
                + ((-qw * gr[5] + qz * gr[6])
                   + (qw * gr[7] - 2.0f * qx * gr[8]))),
        2.0f * (((-2.0f * qy * gr[0] + qx * gr[1]) + (qw * gr[2] + qx * gr[3]))
                + ((qz * gr[5] - qw * gr[6])
                   + (qz * gr[7] - 2.0f * qy * gr[8]))),
        2.0f * (((-2.0f * qz * gr[0] - qw * gr[1]) + (qx * gr[2] + qw * gr[3]))
                + ((-2.0f * qz * gr[4] + qy * gr[5])
                   + (qx * gr[6] + qy * gr[7])))};
    const float g_n = -(((gqn[0] * (qw / g.qn) + gqn[1] * (qx / g.qn))
                         + gqn[2] * (qy / g.qn)) + gqn[3] * (qz / g.qn));
    const float n_scale = g.qn == 0.0f ? 0.0f : g_n / g.qn;
    for (int k = 0; k < 4; ++k) dq[k] = gqn[k] / g.qn + q[k] * n_scale;
  }
  if (in_range) {
    for (int k = 0; k < 3; ++k) {
      d_means[3 * (size_t)i + k] = dm[k];
      d_log_scales[3 * (size_t)i + k] = dls[k];
    }
    for (int k = 0; k < 4; ++k) d_quats[4 * (size_t)i + k] = dq[k];
    d_opacities[i] = dop;
  }
  if constexpr (kView) {
    reduce_view_parts(vpart, d_view_part + blockIdx.x * kViewParts);
  }

  // The SH gradient: basis times the clamped colour's cotangent for the
  // active bands, 0 above them; each row through shared memory.
  const int stride_out = sh_row | 1;
  __syncthreads();   // every thread is done reading sh_s
  if (in_range) {
    float* row = sh_s + t * stride_out;
    float b[kMaxCoeffs];
    sh_basis(degree, x, y, z, b);
    for (int k = 0; k < sh_row / 3; ++k) {
      for (int ch = 0; ch < 3; ++ch) {
        row[3 * k + ch] = (live && k < nb) ? b[k] * graw[ch] : 0.0f;
      }
    }
  }
  __syncthreads();
  unstage_rows(d_sh + (size_t)b0 * sh_row, sh_s, rows, sh_row, stride_out);
}

__global__ void __launch_bounds__(kThreads) project_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ opacities,
    const float* __restrict__ sh, int n, int sh_row, int degree,
    const float* __restrict__ view, const float* __restrict__ proj,
    const float* __restrict__ env_rot, float width, float height,
    float lowpass, int flags, const float* __restrict__ g_xy, int s_xy,
    const float* __restrict__ g_depth, int s_depth,
    const float* __restrict__ g_conic, int s_conic,
    const float* __restrict__ g_color, int s_color,
    const float* __restrict__ g_opacity, int s_opacity,
    float* __restrict__ d_means, float* __restrict__ d_log_scales,
    float* __restrict__ d_quats, float* __restrict__ d_opacities,
    float* __restrict__ d_sh, float2* __restrict__ d_probe) {
  project_bwd_body<false>(
      means, log_scales, quats, opacities, sh, n, sh_row, degree, view, proj,
      env_rot, width, height, lowpass, flags, g_xy, s_xy, g_depth, s_depth,
      g_conic, s_conic, g_color, s_color, g_opacity, s_opacity, d_means,
      d_log_scales, d_quats, d_opacities, d_sh, d_probe, nullptr);
}

__global__ void __launch_bounds__(kThreads) project_bwd_view_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ opacities,
    const float* __restrict__ sh, int n, int sh_row, int degree,
    const float* __restrict__ view, const float* __restrict__ proj,
    const float* __restrict__ env_rot, float width, float height,
    float lowpass, int flags, const float* __restrict__ g_xy, int s_xy,
    const float* __restrict__ g_depth, int s_depth,
    const float* __restrict__ g_conic, int s_conic,
    const float* __restrict__ g_color, int s_color,
    const float* __restrict__ g_opacity, int s_opacity,
    float* __restrict__ d_means, float* __restrict__ d_log_scales,
    float* __restrict__ d_quats, float* __restrict__ d_opacities,
    float* __restrict__ d_sh, float2* __restrict__ d_probe,
    float* __restrict__ d_view_part) {
  project_bwd_body<true>(
      means, log_scales, quats, opacities, sh, n, sh_row, degree, view, proj,
      env_rot, width, height, lowpass, flags, g_xy, s_xy, g_depth, s_depth,
      g_conic, s_conic, g_color, s_color, g_opacity, s_opacity, d_means,
      d_log_scales, d_quats, d_opacities, d_sh, d_probe, d_view_part);
}

}  // namespace

// The parameters and camera as gsplat_project_gaussians takes them (sh
// rows of sh_row = 3 K floats, K at most 16); the cotangents of xy (N, 2),
// depth (N,), conic (N, 3), color (N, 3) and opacity (N,), each a column
// view with row stride s_* floats, or NULL for a zero cotangent. Outputs
// (N, 3) d_means and d_log_scales, (N, 4) d_quats, (N,) d_opacities,
// (N, K, 3) d_sh and, unless NULL, the (N, 2) gradient of an xy probe.
// d_view_part: NULL, or the view gradient's partials, one row of
// kViewParts floats for each block of kThreads gaussians.
extern "C" int gsplat_project_gaussians_bwd(
    const float* means, const float* log_scales, const float* quats,
    const float* opacities, const float* sh, int n, int sh_row, int degree,
    const float* view, const float* proj, const float* env_rot, float width,
    float height, float lowpass, int flags, const float* g_xy, int s_xy,
    const float* g_depth, int s_depth, const float* g_conic, int s_conic,
    const float* g_color, int s_color, const float* g_opacity, int s_opacity,
    float* d_means, float* d_log_scales, float* d_quats, float* d_opacities,
    float* d_sh, float* d_probe, float* d_view_part, void* stream) {
  if (degree < 0 || degree > 3 || 3 * (degree + 1) * (degree + 1) > sh_row
      || sh_row > 3 * kMaxCoeffs || sh_row % 3 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    float2* probe = reinterpret_cast<float2*>(d_probe);
    if (d_view_part) {
      project_bwd_view_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          means, log_scales, quats, opacities, sh, n, sh_row, degree, view,
          proj, env_rot, width, height, lowpass, flags, g_xy, s_xy, g_depth,
          s_depth, g_conic, s_conic, g_color, s_color, g_opacity, s_opacity,
          d_means, d_log_scales, d_quats, d_opacities, d_sh, probe,
          d_view_part);
    } else {
      project_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          means, log_scales, quats, opacities, sh, n, sh_row, degree, view,
          proj, env_rot, width, height, lowpass, flags, g_xy, s_xy, g_depth,
          s_depth, g_conic, s_conic, g_color, s_color, g_opacity, s_opacity,
          d_means, d_log_scales, d_quats, d_opacities, d_sh, probe);
    }
  }
  return (int)cudaGetLastError();
}
