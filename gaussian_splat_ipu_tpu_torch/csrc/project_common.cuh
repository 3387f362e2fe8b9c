// What kernel G (project.cu) and its backward G-bwd (project_bwd.cu)
// share: the camera's per-frame constants, the SH staging through shared
// memory, the SH colour and the per-gaussian forward math, each in the
// plain version's order of operations (project.cu's header says how that
// order was found). G-bwd recomputes the forward with these same
// functions, so its branches (clamps, conic validity, the colour clamp)
// are G's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "clamp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCoeffs = 16;               // SH degree 3
constexpr int kMaxStride = 3 * kMaxCoeffs + 1;
constexpr int kLoadsInFlight = 4;            // 16-byte SH loads per thread

enum Flags { kSigmoid = 1, kAntialias = 2, kCapQ = 4 };

// ops/sh.py's constants, as PyTorch casts the Python floats.
constexpr float kC0 = (float)0.28209479177387814;
constexpr float kC1 = (float)0.4886025119029199;
__constant__ float kC2[5] = {
    (float)1.0925484305920792, (float)-1.0925484305920792,
    (float)0.31539156525252005, (float)-1.0925484305920792,
    (float)0.5462742152960396};
__constant__ float kC3[7] = {
    (float)-0.5900435899266435, (float)2.890611442640554,
    (float)-0.4570457994644658, (float)0.3731763325901154,
    (float)-0.4570457994644658, (float)1.445305721320277,
    (float)-0.5900435899266435};

// The camera's per-frame constants (models/camera.py, ops/transforms.py).
struct CameraConsts {
  float view[16];
  float proj[16];
  float fx, fy, limx, limy;   // focals and 1.3 * tan(half fov)
  float origin[3];            // cam_origin = -(R^T t)
  float rot[9];               // rotate_y(env_rot[1]) @ rotate_x(env_rot[0])
};

__device__ void load_camera(CameraConsts& cam, const float* __restrict__ view,
                            const float* __restrict__ proj,
                            const float* __restrict__ env_rot, float half_w,
                            float half_h) {
  for (int k = 0; k < 16; ++k) {
    cam.view[k] = view[k];
    cam.proj[k] = proj[k];
  }
  const float* v = cam.view;
  // Camera.focals: proj[0,0] * (W / 2), 1 / proj[0,0]; the clamp 1.3 tan.
  cam.fx = cam.proj[0] * half_w;
  cam.fy = cam.proj[5] * half_h;
  cam.limx = (1.0f / cam.proj[0]) * (float)1.3;
  cam.limy = (1.0f / cam.proj[5]) * (float)1.3;
  // Camera.cam_origin: -(view[:3,:3]^T @ view[:3,3]).
  for (int c = 0; c < 3; ++c) {
    cam.origin[c] = -((v[c] * v[3] + v[4 + c] * v[7]) + v[8 + c] * v[11]);
  }
  // rotate_y(b)[:3,:3] @ rotate_x(a)[:3,:3]; every other term of the
  // product is a product with 0, so each entry is one rounded product.
  const float ca = cosf(env_rot[0]), sa = sinf(env_rot[0]);
  const float cb = cosf(env_rot[1]), sb = sinf(env_rot[1]);
  const float r[9] = {cb, sb * sa, sb * ca, 0.0f, ca, -sa,
                      -sb, cb * sa, cb * ca};
  for (int k = 0; k < 9; ++k) cam.rot[k] = r[k];
}

// Copies the `rows` SH rows from row b0 on (`width` floats of each, of
// row_stride in the tensor) to dst, row r at r * stride.
__device__ void stage_sh(float* dst, const float* __restrict__ sh, int b0,
                         int rows, int row_stride, int width, int stride) {
  const float* src = sh + (size_t)b0 * row_stride;
  const int total = rows * width;
  if (width == row_stride && ((uintptr_t)src & 15) == 0) {
    // The rows are one contiguous, aligned span.
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int vecs = total >> 2;
    for (int v0 = threadIdx.x; v0 < vecs; v0 += kLoadsInFlight * kThreads) {
      float4 q[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int v = v0 + u * kThreads;
        if (v < vecs) q[u] = src4[v];
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int v = v0 + u * kThreads;
        if (v >= vecs) break;
        int r = (4 * v) / width;
        int c = 4 * v - r * width;
        const float vals[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dst[r * stride + c] = vals[k];
          if (++c == width) {
            c = 0;
            ++r;
          }
        }
      }
    }
    for (int e = 4 * vecs + threadIdx.x; e < total; e += kThreads) {
      const int r = e / width;
      dst[r * stride + e - r * width] = src[e];
    }
  } else {
    // Fewer coefficients than the row holds, or a row start off 16 bytes.
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int r = e / width;
      const int c = e - r * width;
      dst[r * stride + c] = src[(size_t)r * row_stride + c];
    }
  }
}

// ops/sh.py::eval_sh of one channel (coefficient k at f[3 * k]) at the
// unit direction (x, y, z), before the + 0.5 and the clamp.
__device__ __forceinline__ float eval_sh(const float* f, int degree, float x,
                                         float y, float z) {
  float result = kC0 * f[0];
  if (degree >= 1) {
    result = result + kC1 * (((-y) * f[3] + z * f[6]) - x * f[9]);
  }
  if (degree >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    result = result + (((((kC2[0] * xy) * f[12] + (kC2[1] * yz) * f[15])
                         + (kC2[2] * ((2.0f * zz - xx) - yy)) * f[18])
                        + (kC2[3] * xz) * f[21])
                       + (kC2[4] * (xx - yy)) * f[24]);
    if (degree >= 3) {
      result = result + ((((((((kC3[0] * y) * (3.0f * xx - yy)) * f[27]
                              + ((kC3[1] * xy) * z) * f[30])
                             + ((kC3[2] * y) * ((4.0f * zz - xx) - yy))
                                   * f[33])
                            + ((kC3[3] * z)
                               * ((2.0f * zz - 3.0f * xx) - 3.0f * yy))
                                  * f[36])
                           + ((kC3[4] * x) * ((4.0f * zz - xx) - yy))
                                 * f[39])
                          + ((kC3[5] * z) * (xx - yy)) * f[42])
                         + ((kC3[6] * x) * (xx - 3.0f * yy)) * f[45]);
    }
  }
  return result;
}

// One gaussian's projection up to the colour: every value G writes but the
// colour, and the intermediates G-bwd differentiates through.
struct Projected {
  float vh[4], cl[4];            // view-space and clip-space position
  float half_inv_w, px, py;      // (1 / w) * 0.5; the pixel centre
  float s[3];                    // exp(log-scales)
  float qn, qw, qx, qy, qz;      // the quaternion's norm; normalised
  float r[9], mm[9];             // R; R S
  float cxx, cxy, cxz, cyy, cyz, czz;
  float ratio_x, ratio_y;        // tx / tz, ty / tz before the clamp
  float tx, ty, inv_tz, inv_tz2;
  float j00, j02, j11, j12;
  float u[6], vv[6];             // U = J W (rows u0, u1); V = U Sigma
  float a, b, c, det, det_inv;
  bool valid;
  float op_act;                  // the opacity after the sigmoid
  float det_before, aa_ratio, aa; // antialias: ratio and its factor
  float op;                      // the opacity written
  float rx, ry;
};

__device__ __forceinline__ void project_one(
    const CameraConsts& cam, const float m[3], const float ls[3],
    const float q[4], float op_raw, float width, float height,
    float lowpass, float inv_alpha_min, float q_cap, int flags,
    Projected& o) {
  const float* v = cam.view;
  const float* p = cam.proj;

  // transform_points(view, means), transform_points(proj, view_h).
  for (int r = 0; r < 4; ++r) {
    o.vh[r] = fmaf(m[2], v[4 * r + 2], fmaf(m[1], v[4 * r + 1],
                                            m[0] * v[4 * r])) + v[4 * r + 3];
  }
  for (int r = 0; r < 4; ++r) {
    o.cl[r] = fmaf(o.vh[3], p[4 * r + 3], fmaf(o.vh[2], p[4 * r + 2],
                   fmaf(o.vh[1], p[4 * r + 1], o.vh[0] * p[4 * r])));
  }
  // clip_to_screen: (clip * (0.5 / w) + 0.5) * size.
  o.half_inv_w = (1.0f / o.cl[3]) * 0.5f;
  o.px = (o.cl[0] * o.half_inv_w + 0.5f) * width;
  o.py = (o.cl[1] * o.half_inv_w + 0.5f) * height;
  const float tz = o.vh[2];

  // covariance_3d: R S S^T R^T from the normalised quaternion (w, x, y, z).
  for (int k = 0; k < 3; ++k) o.s[k] = expf(ls[k]);
  o.qn = sqrtf((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]));
  o.qw = q[0] / o.qn;
  o.qx = q[1] / o.qn;
  o.qy = q[2] / o.qn;
  o.qz = q[3] / o.qn;
  const float qw = o.qw, qx = o.qx, qy = o.qy, qz = o.qz;
  const float r[9] = {
      1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy - qw * qz),
      2.0f * (qx * qz + qw * qy),        2.0f * (qx * qy + qw * qz),
      1.0f - 2.0f * (qx * qx + qz * qz), 2.0f * (qy * qz - qw * qx),
      2.0f * (qx * qz - qw * qy),        2.0f * (qy * qz + qw * qx),
      1.0f - 2.0f * (qx * qx + qy * qy)};
  for (int k = 0; k < 9; ++k) {
    o.r[k] = r[k];
    o.mm[k] = r[k] * o.s[k % 3];
  }
  const float* mm = o.mm;
  // torch.sum over 3 elements adds the first and the third first.
  o.cxx = (mm[0] * mm[0] + mm[2] * mm[2]) + mm[1] * mm[1];
  o.cxy = (mm[0] * mm[3] + mm[2] * mm[5]) + mm[1] * mm[4];
  o.cxz = (mm[0] * mm[6] + mm[2] * mm[8]) + mm[1] * mm[7];
  o.cyy = (mm[3] * mm[3] + mm[5] * mm[5]) + mm[4] * mm[4];
  o.cyz = (mm[3] * mm[6] + mm[5] * mm[8]) + mm[4] * mm[7];
  o.czz = (mm[6] * mm[6] + mm[8] * mm[8]) + mm[7] * mm[7];

  // ewa_project.
  o.ratio_x = o.vh[0] / tz;
  o.ratio_y = o.vh[1] / tz;
  o.tx = clamp_nan(o.ratio_x, -cam.limx, cam.limx) * tz;
  o.ty = clamp_nan(o.ratio_y, -cam.limy, cam.limy) * tz;
  o.inv_tz = 1.0f / tz;
  o.inv_tz2 = o.inv_tz * o.inv_tz;
  o.j00 = cam.fx * o.inv_tz;
  o.j02 = (-cam.fx * o.tx) * o.inv_tz2;
  o.j11 = cam.fy * o.inv_tz;
  o.j12 = (-cam.fy * o.ty) * o.inv_tz2;
  float* u = o.u;
  u[0] = o.j00 * v[0] + o.j02 * v[8];
  u[1] = o.j00 * v[1] + o.j02 * v[9];
  u[2] = o.j00 * v[2] + o.j02 * v[10];
  u[3] = o.j11 * v[4] + o.j12 * v[8];
  u[4] = o.j11 * v[5] + o.j12 * v[9];
  u[5] = o.j11 * v[6] + o.j12 * v[10];
  float* vv = o.vv;
  vv[0] = (u[0] * o.cxx + u[1] * o.cxy) + u[2] * o.cxz;
  vv[1] = (u[0] * o.cxy + u[1] * o.cyy) + u[2] * o.cyz;
  vv[2] = (u[0] * o.cxz + u[1] * o.cyz) + u[2] * o.czz;
  vv[3] = (u[3] * o.cxx + u[4] * o.cxy) + u[5] * o.cxz;
  vv[4] = (u[3] * o.cxy + u[4] * o.cyy) + u[5] * o.cyz;
  vv[5] = (u[3] * o.cxz + u[4] * o.cyz) + u[5] * o.czz;
  o.a = ((vv[0] * u[0] + vv[1] * u[1]) + vv[2] * u[2]) + lowpass;
  o.b = (vv[0] * u[3] + vv[1] * u[4]) + vv[2] * u[5];
  o.c = ((vv[3] * u[3] + vv[4] * u[4]) + vv[5] * u[5]) + lowpass;

  // conic.
  o.det = o.a * o.c - o.b * o.b;
  o.valid = o.det > (float)1e-12;
  o.det_inv = o.valid ? 1.0f / o.det : 0.0f;

  // Opacity: sigmoid, antialias compensation.
  float op = op_raw;
  if (flags & kSigmoid) op = 1.0f / (1.0f + expf(-op));
  o.op_act = op;
  if (flags & kAntialias) {
    o.det_before = (o.a - lowpass) * (o.c - lowpass) - o.b * o.b;
    o.aa_ratio = clamp_min_nan(o.det_before, 0.0f)
                 / clamp_min_nan(o.det, (float)1e-12);
    o.aa = sqrtf(clamp_nan(o.aa_ratio, 0.0f, 1.0f));
    op = op * o.aa;
  }
  o.op = op;

  // splat_extent, alpha-aware.
  float qv = 2.0f * logf(clamp_min_nan(op, (float)1e-12) * inv_alpha_min);
  if (flags & kCapQ) qv = clamp_max_nan(qv, q_cap);
  qv = clamp_min_nan(qv, 0.0f);
  o.rx = ceilf(sqrtf(qv * clamp_min_nan(o.a, 0.0f)));
  o.ry = ceilf(sqrtf(qv * clamp_min_nan(o.c, 0.0f)));
}

// The SH view direction of a gaussian at m: the unit vector from the
// camera's origin (norm floored at 1e-8), rotated by the environment.
// d: the unnormalised direction; nrm_raw: its norm.
struct ViewDir {
  float d[3], nrm_raw, nrm, e[3], x, y, z;
};

__device__ __forceinline__ void view_dir(const CameraConsts& cam,
                                         const float m[3], ViewDir& o) {
  for (int k = 0; k < 3; ++k) o.d[k] = m[k] - cam.origin[k];
  o.nrm_raw = sqrtf((o.d[0] * o.d[0] + o.d[2] * o.d[2]) + o.d[1] * o.d[1]);
  o.nrm = clamp_min_nan(o.nrm_raw, (float)1e-8);
  for (int k = 0; k < 3; ++k) o.e[k] = o.d[k] / o.nrm;
  const float* g = cam.rot;
  o.x = fmaf(o.e[2], g[2], fmaf(o.e[1], g[1], o.e[0] * g[0]));
  o.y = fmaf(o.e[2], g[5], fmaf(o.e[1], g[4], o.e[0] * g[3]));
  o.z = fmaf(o.e[2], g[8], fmaf(o.e[1], g[7], o.e[0] * g[6]));
}

}  // namespace
