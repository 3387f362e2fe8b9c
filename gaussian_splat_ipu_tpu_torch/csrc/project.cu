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
// That per-gaussian math lives in project_common.cuh, which the backward,
// G-bwd (project_bwd.cu), shares.
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

#include "project_common.cuh"

namespace {

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

  Projected g;
  project_one(cam, m, ls, q, op, width, height, lowpass, inv_alpha_min,
              q_cap, flags, g);

  // SH colour at the unit view direction, rotated by the environment.
  const float* f = sh_s + t * stride;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (degree >= 1) {
    ViewDir dir;
    view_dir(cam, m, dir);
    x = dir.x;
    y = dir.y;
    z = dir.z;
  }
  float color[3];
  for (int ch = 0; ch < 3; ++ch) {
    color[ch] = clamp_min_nan(eval_sh(f + ch, degree, x, y, z) + 0.5f, 0.0f);
  }

  // The frustum cull.
  const bool visible = g.cl[3] > (float)1e-6 && g.px + g.rx >= 0.0f
                       && g.px - g.rx <= width && g.py + g.ry >= 0.0f
                       && g.py - g.ry <= height && g.valid && g.rx > 0.0f
                       && g.ry > 0.0f && g.op >= alpha_min;

  xy_out[i] = make_float2(g.px, g.py);
  depth_out[i] = -g.vh[2];
  conic_out[3 * (size_t)i] = g.c * g.det_inv;
  conic_out[3 * (size_t)i + 1] = -g.b * g.det_inv;
  conic_out[3 * (size_t)i + 2] = g.a * g.det_inv;
  for (int ch = 0; ch < 3; ++ch) color_out[3 * (size_t)i + ch] = color[ch];
  opacity_out[i] = g.op;
  radius_out[i] = visible ? make_float2(g.rx, g.ry)
                          : make_float2(0.0f, 0.0f);
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
