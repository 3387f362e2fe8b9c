// Kernel G: the projection stage, every output of project_gaussians in one
// pass over the gaussians.
//
// Replaces no TPU kernel: the JAX package leaves projection to XLA, which
// fuses it (gaussian_splat_ipu_tpu/render/projection.py). Plain version:
// gaussian_splat_ipu_tpu_torch/render/projection.py::project_gaussians,
// some 220 PyTorch launches at SH degree 3, each reading and writing (N, k)
// f32 intermediates.
//
// Per gaussian: the view and clip transforms and the viewport mapping; the
// 3D covariance from exp(log-scales) and the normalised quaternion; the EWA
// projection with the 1.3 tan_fov clamp and the low-pass; the conic and its
// validity; the sigmoid opacity and the antialias compensation when asked;
// the alpha-aware extents; the SH colour at the active degree; the frustum
// cull, radius (0, 0) where the plain version culls.
//
// Bound on the H100: bytes. 236 B read (means 12, log-scales 12, quaternion
// 16, opacity 4, SH 192 at degree 3) and 48 B written per gaussian: 298 MB
// at 2^20, 0.089 ms at 3.35 TB/s; a few hundred flops per gaussian are far
// below the FP32 rate. Design: one thread per gaussian, kThreads a block.
// SH is 81% of the bytes, so each block stages its rows' coefficients in
// shared memory, the block's rows being one contiguous span read with
// coalesced 16-byte loads, several in flight per thread, into rows of an
// odd stride, so that threads reading their own row hit distinct banks.
// The camera stays on the device (a replayed CUDA graph then needs no host
// work): one thread of each block reads view, proj and env_rot and derives
// the focals, the fov clamps, the camera origin and the environment
// rotation into shared memory while the others stage SH.
//
// Arithmetic: f32, in the plain version's order of operations, with the
// same math library calls (expf, logf, sqrtf, ceilf, cosf, sinf; the
// sigmoid as 1 / (1 + expf(-x)), PyTorch's CUDA sigmoid) and no fast-math;
// the library is built with -fmad=false. Clamps propagate NaN as PyTorch's
// do. A division by a Python float, which PyTorch's CUDA division turns
// into a product with the reciprocal (taken in double, then rounded to
// f32), is that product here too, the reciprocal from the host. The 4x4
// and 3x3 products that PyTorch hands to cuBLAS are summed in column order
// with explicit FMAs, and the sums and norms that PyTorch reduces (over 3
// and 4 elements) in its reduction's order: of all orders tried, those that
// reproduce PyTorch's results bit for bit on the H100. The camera origin's
// 3x3 product (one per frame) matched in none and may differ by an ulp.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

// torch.clamp_min / clamp_max / clamp with float bounds: NaN stays NaN.
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_nan(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

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

__global__ void __launch_bounds__(kThreads) project_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ opacities,
    const float* __restrict__ sh, int n, int sh_row, int degree,
    const float* __restrict__ view, const float* __restrict__ proj,
    const float* __restrict__ env_rot, float width, float height,
    float lowpass, float alpha_min, float inv_alpha_min, float q_cap,
    int flags, float2* __restrict__ xy_out, float* __restrict__ depth_out,
    float* __restrict__ conic_out, float* __restrict__ color_out,
    float* __restrict__ opacity_out, float2* __restrict__ radius_out) {
  __shared__ CameraConsts cam;
  __shared__ float sh_s[kThreads * kMaxStride];
  const int b0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - b0);
  const int t = threadIdx.x;
  const int i = b0 + t;
  const bool live = t < rows;
  // This gaussian's inputs, loaded before the staging so that they are in
  // flight with it.
  float m[3], ls[3], q[4], op = 0.0f;
  if (live) {
    for (int k = 0; k < 3; ++k) {
      m[k] = means[3 * (size_t)i + k];
      ls[k] = log_scales[3 * (size_t)i + k];
    }
    for (int k = 0; k < 4; ++k) q[k] = quats[4 * (size_t)i + k];
    op = opacities[i];
  }
  if (t == 0) {
    load_camera(cam, view, proj, env_rot, 0.5f * width, 0.5f * height);
  }
  const int width_sh = 3 * (degree + 1) * (degree + 1);
  const int stride = width_sh | 1;
  stage_sh(sh_s, sh, b0, rows, sh_row, width_sh, stride);
  __syncthreads();
  if (!live) return;
  const float* v = cam.view;
  const float* p = cam.proj;

  // transform_points(view, means), transform_points(proj, view_h).
  float vh[4], cl[4];
  for (int r = 0; r < 4; ++r) {
    vh[r] = fmaf(m[2], v[4 * r + 2], fmaf(m[1], v[4 * r + 1],
                                          m[0] * v[4 * r])) + v[4 * r + 3];
  }
  for (int r = 0; r < 4; ++r) {
    cl[r] = fmaf(vh[3], p[4 * r + 3], fmaf(vh[2], p[4 * r + 2],
                 fmaf(vh[1], p[4 * r + 1], vh[0] * p[4 * r])));
  }
  // clip_to_screen: (clip * (0.5 / w) + 0.5) * size.
  const float w = cl[3];
  const float half_inv_w = (1.0f / w) * 0.5f;
  const float px = (cl[0] * half_inv_w + 0.5f) * width;
  const float py = (cl[1] * half_inv_w + 0.5f) * height;
  const float tz = vh[2];

  // covariance_3d: R S S^T R^T from the normalised quaternion (w, x, y, z).
  const float s[3] = {expf(ls[0]), expf(ls[1]), expf(ls[2])};
  const float qn = sqrtf((q[0] * q[0] + q[2] * q[2])
                         + (q[1] * q[1] + q[3] * q[3]));
  const float qw = q[0] / qn, qx = q[1] / qn, qy = q[2] / qn, qz = q[3] / qn;
  const float r[9] = {
      1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy - qw * qz),
      2.0f * (qx * qz + qw * qy),        2.0f * (qx * qy + qw * qz),
      1.0f - 2.0f * (qx * qx + qz * qz), 2.0f * (qy * qz - qw * qx),
      2.0f * (qx * qz - qw * qy),        2.0f * (qy * qz + qw * qx),
      1.0f - 2.0f * (qx * qx + qy * qy)};
  float mm[9];
  for (int k = 0; k < 9; ++k) mm[k] = r[k] * s[k % 3];
  // torch.sum over 3 elements adds the first and the third first.
  const float cxx = (mm[0] * mm[0] + mm[2] * mm[2]) + mm[1] * mm[1];
  const float cxy = (mm[0] * mm[3] + mm[2] * mm[5]) + mm[1] * mm[4];
  const float cxz = (mm[0] * mm[6] + mm[2] * mm[8]) + mm[1] * mm[7];
  const float cyy = (mm[3] * mm[3] + mm[5] * mm[5]) + mm[4] * mm[4];
  const float cyz = (mm[3] * mm[6] + mm[5] * mm[8]) + mm[4] * mm[7];
  const float czz = (mm[6] * mm[6] + mm[8] * mm[8]) + mm[7] * mm[7];

  // ewa_project.
  const float tx = clamp_nan(vh[0] / tz, -cam.limx, cam.limx) * tz;
  const float ty = clamp_nan(vh[1] / tz, -cam.limy, cam.limy) * tz;
  const float inv_tz = 1.0f / tz;
  const float inv_tz2 = inv_tz * inv_tz;
  const float j00 = cam.fx * inv_tz;
  const float j02 = (-cam.fx * tx) * inv_tz2;
  const float j11 = cam.fy * inv_tz;
  const float j12 = (-cam.fy * ty) * inv_tz2;
  const float u00 = j00 * v[0] + j02 * v[8];
  const float u01 = j00 * v[1] + j02 * v[9];
  const float u02 = j00 * v[2] + j02 * v[10];
  const float u10 = j11 * v[4] + j12 * v[8];
  const float u11 = j11 * v[5] + j12 * v[9];
  const float u12 = j11 * v[6] + j12 * v[10];
  const float v00 = (u00 * cxx + u01 * cxy) + u02 * cxz;
  const float v01 = (u00 * cxy + u01 * cyy) + u02 * cyz;
  const float v02 = (u00 * cxz + u01 * cyz) + u02 * czz;
  const float v10 = (u10 * cxx + u11 * cxy) + u12 * cxz;
  const float v11 = (u10 * cxy + u11 * cyy) + u12 * cyz;
  const float v12 = (u10 * cxz + u11 * cyz) + u12 * czz;
  const float a = ((v00 * u00 + v01 * u01) + v02 * u02) + lowpass;
  const float b = (v00 * u10 + v01 * u11) + v02 * u12;
  const float c = ((v10 * u10 + v11 * u11) + v12 * u12) + lowpass;

  // conic.
  const float det = a * c - b * b;
  const bool valid = det > (float)1e-12;
  const float det_inv = valid ? 1.0f / det : 0.0f;

  // Opacity: sigmoid, antialias compensation.
  if (flags & kSigmoid) op = 1.0f / (1.0f + expf(-op));
  if (flags & kAntialias) {
    const float det_before = (a - lowpass) * (c - lowpass) - b * b;
    const float ratio = clamp_min_nan(det_before, 0.0f)
                        / clamp_min_nan(det, (float)1e-12);
    op = op * sqrtf(clamp_nan(ratio, 0.0f, 1.0f));
  }

  // splat_extent, alpha-aware.
  float qv = 2.0f * logf(clamp_min_nan(op, (float)1e-12) * inv_alpha_min);
  if (flags & kCapQ) qv = clamp_max_nan(qv, q_cap);
  qv = clamp_min_nan(qv, 0.0f);
  const float rx = ceilf(sqrtf(qv * clamp_min_nan(a, 0.0f)));
  const float ry = ceilf(sqrtf(qv * clamp_min_nan(c, 0.0f)));

  // SH colour at the unit view direction, rotated by the environment.
  const float* f = sh_s + t * stride;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (degree >= 1) {
    const float d0 = m[0] - cam.origin[0];
    const float d1 = m[1] - cam.origin[1];
    const float d2 = m[2] - cam.origin[2];
    const float nrm = clamp_min_nan(sqrtf((d0 * d0 + d2 * d2) + d1 * d1),
                                    (float)1e-8);
    const float e0 = d0 / nrm, e1 = d1 / nrm, e2 = d2 / nrm;
    const float* g = cam.rot;
    x = fmaf(e2, g[2], fmaf(e1, g[1], e0 * g[0]));
    y = fmaf(e2, g[5], fmaf(e1, g[4], e0 * g[3]));
    z = fmaf(e2, g[8], fmaf(e1, g[7], e0 * g[6]));
  }
  float color[3];
  for (int ch = 0; ch < 3; ++ch) {
    color[ch] = clamp_min_nan(eval_sh(f + ch, degree, x, y, z) + 0.5f, 0.0f);
  }

  // The frustum cull.
  const bool visible = w > (float)1e-6 && px + rx >= 0.0f
                       && px - rx <= width && py + ry >= 0.0f
                       && py - ry <= height && valid && rx > 0.0f
                       && ry > 0.0f && op >= alpha_min;

  xy_out[i] = make_float2(px, py);
  depth_out[i] = -tz;
  conic_out[3 * (size_t)i] = c * det_inv;
  conic_out[3 * (size_t)i + 1] = -b * det_inv;
  conic_out[3 * (size_t)i + 2] = a * det_inv;
  for (int ch = 0; ch < 3; ++ch) color_out[3 * (size_t)i + ch] = color[ch];
  opacity_out[i] = op;
  radius_out[i] = visible ? make_float2(rx, ry) : make_float2(0.0f, 0.0f);
}

}  // namespace

// means (N, 3), log_scales (N, 3), quats (N, 4), opacities (N,), sh with
// rows of sh_row floats ((N, K, 3): sh_row = 3 K), degree the active SH
// degree ((degree + 1)^2 <= K, at most 3); view, proj (4, 4), env_rot (2,),
// all f32 on the device. inv_alpha_min: 1 / alpha_min rounded to f32 from
// double. flags: 1 sigmoid opacity, 2 antialias, 4 cap q at q_cap. Outputs
// xy (N, 2), depth (N,), conic (N, 3), color (N, 3), opacity (N,), radius
// (N, 2).
extern "C" int gsplat_project_gaussians(
    const float* means, const float* log_scales, const float* quats,
    const float* opacities, const float* sh, int n, int sh_row, int degree,
    const float* view, const float* proj, const float* env_rot, float width,
    float height, float lowpass, float alpha_min, float inv_alpha_min,
    float q_cap, int flags, float* xy, float* depth, float* conic,
    float* color, float* opacity, float* radius, void* stream) {
  if (degree < 0 || degree > 3 || 3 * (degree + 1) * (degree + 1) > sh_row) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    project_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
        means, log_scales, quats, opacities,
        sh, n, sh_row, degree, view, proj, env_rot, width, height, lowpass,
        alpha_min, inv_alpha_min, q_cap, flags, reinterpret_cast<float2*>(xy),
        depth, conic, color, opacity, reinterpret_cast<float2*>(radius));
  }
  return (int)cudaGetLastError();
}
