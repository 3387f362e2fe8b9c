"""Kernel G: the projection stage in one pass over the gaussians
(csrc/project.cu), and its backward G-bwd (csrc/project_bwd.cu).

`project` launches G on CUDA tensors and returns every output of
render/projection.py::project_gaussians, whose plain PyTorch body is G's
plain version and stays the CPU path (projection.py chooses between
them). `project_bwd` launches G-bwd: the gradients of G's differentiable
outputs with respect to the gaussians' parameters and, where asked (pose
refinement), the view matrix, the backward of projection.py's autograd
Function. The view's gradient is a sum over every gaussian: G-bwd writes
one row of partial sums a block (VIEW_PARTS), and `assemble_view_grad`
adds the rows and chains the camera origin's term to the view, in a few
device ops after the launch. Its plain twin,
`project_gaussians_bwd_torch`, computes the same from the same formulas
in PyTorch ops, in the inputs' dtype (the CPU tests hold it to autograd
of the plain version in float64). No TPU kernel corresponds: the JAX
package leaves projection and its derivative to XLA, which fuses them.

`compare` holds G's outputs to the plain version's: the values within
RTOL relative or ATOL absolute, the radii equal except where the plain
version's ceil or cull argument lies within MARGIN of its threshold. G
follows the plain version's rounding (csrc/project.cu), but the camera
origin's product matched no order tried and may differ by an ulp.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.ops import sh as sh_ops
from gaussian_splat_ipu_tpu_torch.ops import transforms
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

_SIGMOID, _ANTIALIAS, _CAP_Q = 1, 2, 4
RTOL, ATOL, MARGIN = 1e-5, 1e-6, 1e-4
OUTPUTS = ("xy", "depth", "conic", "color", "opacity", "radius")
COTANGENTS = ("g_xy", "g_depth", "g_conic", "g_color", "g_opacity")
GRADS = ("d_means", "d_log_scales", "d_quats", "d_opacities", "d_sh",
         "d_probe")
# compare_bwd: G-bwd's error from the float64 gradient, per gaussian and
# gradient (the row's norm), may be ACC_FACTOR times that of PyTorch's
# f32 autograd of the plain version, an error under ACC_FLOOR of the
# row's norm counting as ACC_FLOOR (a few hundred f32 roundings of the
# same terms; the twin in f32 reads at most 6 times autograd's on the
# CPU tests' scenes).
ACC_FACTOR, ACC_FLOOR = 16.0, 1e-5
# G-bwd's gaussians a block (csrc/project_common.cuh kThreads), and the
# view gradient's partial sums a block (csrc/project_bwd.cu kViewParts):
# the view transform's term (16, as V), the EWA W term (9, as W), the sum
# of the SH view direction's cotangents (3).
THREADS = 128
VIEW_TRANSFORM, VIEW_W, VIEW_ORIGIN = (slice(0, 16), slice(16, 25),
                                       slice(25, 28))
VIEW_PARTS = 28


def project(means, log_scales, quats, opacities, sh, view, proj, env_rot,
            cfg: RasterConfig, degree: int) -> tuple:
    """(xy (N, 2), depth (N,), conic (N, 3), color (N, 3), opacity (N,),
    radius (N, 2)) f32, as project_gaussians computes them, the colour at
    SH degree `degree` of the (N, K, 3) coefficients ((degree + 1)^2 <= K).
    Every input a contiguous f32 tensor on one CUDA device: view and proj
    (4, 4), env_rot (2,); anything else raises."""
    dev, n, k = _check_inputs(means, log_scales, quats, opacities, sh, view,
                              proj, env_rot, degree)
    f32 = torch.float32
    outs = tuple(torch.empty(shape, dtype=f32, device=dev) for shape in (
        (n, 2), (n,), (n, 3), (n, 3), (n,), (n, 2)))
    if n:
        lib = cuda_lib.library()
        cuda_lib.check("project_gaussians", lib.gsplat_project_gaussians(
            means.data_ptr(), log_scales.data_ptr(), quats.data_ptr(),
            opacities.data_ptr(), sh.data_ptr(), n, 3 * k, degree,
            view.data_ptr(), proj.data_ptr(), env_rot.data_ptr(),
            float(cfg.image_width), float(cfg.image_height), cfg.lowpass,
            cfg.alpha_min, 1.0 / cfg.alpha_min,
            cfg.extent_sigma * cfg.extent_sigma, _flags(cfg),
            *(o.data_ptr() for o in outs), cuda_lib.stream_handle(dev)))
        cuda_lib.launches["project_gaussians"] += 1
    return outs


def _check_inputs(means, log_scales, quats, opacities, sh, view, proj,
                  env_rot, degree: int, max_coeffs: int | None = None):
    """(device, N, K) of G's and G-bwd's inputs: contiguous f32 tensors on
    one CUDA device, (N, K, 3) SH (K at most max_coeffs), degree 0-3 with
    (degree + 1)^2 <= K; anything else raises."""
    cuda_lib.require_cuda(means, "means")
    dev = means.device
    n = means.shape[0]
    if sh.dim() != 3 or (max_coeffs is not None and sh.shape[1] > max_coeffs):
        raise ValueError(f"sh: shape {tuple(sh.shape)}, expected (N, K, 3)"
                         + ("" if max_coeffs is None
                            else f" with K at most {max_coeffs}"))
    k = sh.shape[1]
    if not 0 <= degree <= 3 or (degree + 1) ** 2 > k:
        raise ValueError(f"SH degree {degree}: the kernel takes 0-3, at "
                         f"most the {k} coefficients held")
    for t, name, shape in ((means, "means", (n, 3)),
                           (log_scales, "log_scales", (n, 3)),
                           (quats, "quats", (n, 4)),
                           (opacities, "opacities", (n,)),
                           (sh, "sh", (n, k, 3)), (view, "view", (4, 4)),
                           (proj, "proj", (4, 4)),
                           (env_rot, "env_rot", (2,))):
        cuda_lib.require(t, name, torch.float32, shape, dev)
    return dev, n, k


def _flags(cfg: RasterConfig) -> int:
    return ((_SIGMOID if cfg.sigmoid_opacity else 0)
            | (_ANTIALIAS if cfg.antialias else 0)
            | (_CAP_Q if cfg.extent_sigma > 0.0 else 0))


def project_bwd(means, log_scales, quats, opacities, sh, view, proj,
                env_rot, cfg: RasterConfig, degree: int, cotangents,
                probe: bool = False, view_grad: bool = False) -> tuple:
    """(d_means (N, 3), d_log_scales (N, 3), d_quats (N, 4), d_opacities
    (N,), d_sh (N, K, 3), d_probe (N, 2) or None): the gradients, through
    `project`'s outputs, of the cotangents (g_xy (N, 2), g_depth (N,),
    g_conic (N, 3), g_color (N, 3), g_opacity (N,)), each an f32 tensor
    whose columns are adjacent (a column view of a wider row will do) or
    None for zeros; with `probe`, also the gradient of an xy probe added to
    xy; with `view_grad`, a seventh entry, the (4, 4) gradient of the view
    matrix (G-bwd's view kernel, counted in cuda_lib.launches under
    "project_gaussians_bwd_view" too, and in the recorder's counter
    "project.view_grad" on every replay of a captured step). The inputs
    as `project` takes them, K at most 16; anything else raises."""
    dev, n, k = _check_inputs(means, log_scales, quats, opacities, sh, view,
                              proj, env_rot, degree, max_coeffs=16)
    f32 = torch.float32
    cots = []
    for t, name, shape in zip(cotangents, COTANGENTS, ((n, 2), (n,), (n, 3),
                                                       (n, 3), (n,))):
        if t is None:
            cots += [None, 0]
            continue
        if t.device != dev or t.dtype != f32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected f32 {shape} on {dev}")
        if t.dim() == 2 and t.stride(1) != 1:
            raise ValueError(f"{name}: columns not adjacent (strides "
                             f"{t.stride()})")
        cots += [t.data_ptr(), t.stride(0)]
    grads = tuple(torch.empty_like(t) for t in (means, log_scales, quats,
                                                 opacities, sh))
    d_probe = torch.empty((n, 2), dtype=f32, device=dev) if probe else None
    parts = (torch.empty((-(-n // THREADS), VIEW_PARTS), dtype=f32,
                         device=dev) if view_grad else None)
    if n:
        lib = cuda_lib.library()
        cuda_lib.check("project_gaussians_bwd",
                       lib.gsplat_project_gaussians_bwd(
            means.data_ptr(), log_scales.data_ptr(), quats.data_ptr(),
            opacities.data_ptr(), sh.data_ptr(), n, 3 * k, degree,
            view.data_ptr(), proj.data_ptr(), env_rot.data_ptr(),
            float(cfg.image_width), float(cfg.image_height), cfg.lowpass,
            _flags(cfg), *cots, *(g.data_ptr() for g in grads),
            None if d_probe is None else d_probe.data_ptr(),
            None if parts is None else parts.data_ptr(),
            cuda_lib.stream_handle(dev)))
        cuda_lib.launches["project_gaussians_bwd"] += 1
        if view_grad:
            cuda_lib.launches["project_gaussians_bwd_view"] += 1
    if not view_grad:
        return (*grads, d_probe)
    if profiling.active is not None:
        profiling.count("project.view_grad",
                        torch.ones((), dtype=torch.int64, device=dev))
    return (*grads, d_probe, assemble_view_grad(parts, view))


def assemble_view_grad(parts: torch.Tensor, view: torch.Tensor
                       ) -> torch.Tensor:
    """The (4, 4) gradient of the view matrix V = [R | t] from rows of
    partial sums (B, VIEW_PARTS): their sum's view-transform term, plus its
    W term on R, plus the camera origin's: origin = -(R^T t) enters the SH
    view direction d = m - origin, so with G the summed cotangents of d,
    R gets t G^T and t gets R G. Device ops only: no host read."""
    s = parts.sum(0)
    g = s[VIEW_TRANSFORM].reshape(4, 4)
    g_dir = s[VIEW_ORIGIN]
    r, t = view[:3, :3].to(s.dtype), view[:3, 3].to(s.dtype)
    g_r = g[:3, :3] + s[VIEW_W].reshape(3, 3) + t[:, None] * g_dir[None, :]
    g_t = g[:3, 3] + (r * g_dir[None, :]).sum(1)
    return torch.cat([torch.cat([g_r, g_t[:, None]], 1), g[3:]], 0)


def _sh_basis(degree: int, x, y, z) -> tuple:
    """Each active coefficient's factor in ops/sh.eval_sh at (x, y, z) and
    its derivatives by x, y and z: (basis, d/dx, d/dy, d/dz), lists of
    (N,) tensors (or 0.0)."""
    c1, c2, c3 = sh_ops.SH_C1, sh_ops.SH_C2, sh_ops.SH_C3
    b, bx, by, bz = [sh_ops.SH_C0], [0.0], [0.0], [0.0]
    if degree >= 1:
        b += [-c1 * y, c1 * z, -c1 * x]
        bx += [0.0, 0.0, -c1]
        by += [-c1, 0.0, 0.0]
        bz += [0.0, c1, 0.0]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        b += [c2[0] * x * y, c2[1] * y * z, c2[2] * (2 * zz - xx - yy),
              c2[3] * x * z, c2[4] * (xx - yy)]
        bx += [c2[0] * y, 0.0, -2 * c2[2] * x, c2[3] * z, 2 * c2[4] * x]
        by += [c2[0] * x, c2[1] * z, -2 * c2[2] * y, 0.0, -2 * c2[4] * y]
        bz += [0.0, c2[1] * y, 4 * c2[2] * z, c2[3] * x, 0.0]
    if degree >= 3:
        b += [c3[0] * y * (3 * xx - yy), c3[1] * x * y * z,
              c3[2] * y * (4 * zz - xx - yy),
              c3[3] * z * (2 * zz - 3 * xx - 3 * yy),
              c3[4] * x * (4 * zz - xx - yy), c3[5] * z * (xx - yy),
              c3[6] * x * (xx - 3 * yy)]
        bx += [c3[0] * 6 * x * y, c3[1] * y * z, -c3[2] * 2 * x * y,
               -c3[3] * 6 * x * z, c3[4] * (4 * zz - 3 * xx - yy),
               c3[5] * 2 * x * z, c3[6] * (3 * xx - 3 * yy)]
        by += [c3[0] * (3 * xx - 3 * yy), c3[1] * x * z,
               c3[2] * (4 * zz - xx - 3 * yy), -c3[3] * 6 * y * z,
               -c3[4] * 2 * x * y, -c3[5] * 2 * y * z, -c3[6] * 6 * x * y]
        bz += [0.0, c3[1] * x * y, c3[2] * 8 * y * z,
               c3[3] * (6 * zz - 3 * xx - 3 * yy), c3[4] * 8 * x * z,
               c3[5] * (xx - yy), 0.0]
    return b, bx, by, bz


def project_gaussians_bwd_torch(means, log_scales, quats, opacities, sh,
                                view, proj, env_rot, cfg: RasterConfig,
                                degree: int, cotangents,
                                probe: bool = False,
                                view_grad: bool = False) -> tuple:
    """G-bwd's plain twin: project_bwd's gradients in PyTorch ops, on any
    device, in the dtype of `means` (f32 or f64), from G-bwd's formulas:
    reverse mode through projection.py::project_gaussians_torch as
    autograd takes it, with exact zeros for a gaussian whose cotangents are
    all zero (and nothing from it in the view's gradient)."""
    n, dt = means.shape[0], means.dtype
    zero = means.new_zeros(n)

    def cot(t, cols):
        if t is None:
            return (zero,) * cols
        t = t.to(dt)
        return t.unbind(-1) if cols > 1 else (t,)

    (gx, gy), (gd,), gcon, gcol, (gop,) = (
        cot(t, c) for t, c in zip(cotangents, (2, 1, 3, 3, 1)))
    live = torch.stack([gx, gy, gd, *gcon, *gcol, gop], -1).ne(0).any(-1)
    v, p = view.to(dt), proj.to(dt)
    w_img, h_img, lp = float(cfg.image_width), float(cfg.image_height), \
        cfg.lowpass

    # The forward again (csrc/project_common.cuh::project_one).
    m = means.to(dt)
    vh = m @ v[:, :3].T + v[:, 3]                                 # (N, 4)
    cl = vh @ p.T
    r_w = 1.0 / cl[:, 3]
    half_inv_w = r_w * 0.5
    tz = vh[:, 2]
    s = torch.exp(log_scales.to(dt))
    q = quats.to(dt)
    qn = torch.linalg.vector_norm(q, dim=-1)
    qw, qx, qy, qz = (q / qn[:, None]).unbind(-1)
    r = torch.stack([
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
        2 * (qx * qz + qw * qy), 2 * (qx * qy + qw * qz),
        1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx),
        2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
        1 - 2 * (qx * qx + qy * qy)], -1).reshape(n, 3, 3)
    mm = r * s[:, None, :]
    sig = mm @ mm.transpose(1, 2)                                 # (N, 3, 3)
    fx, fy = p[0, 0] * (w_img * 0.5), p[1, 1] * (h_img * 0.5)
    lim = (1.0 / p[0, 0] * 1.3, 1.0 / p[1, 1] * 1.3)
    ratio = (vh[:, 0] / tz, vh[:, 1] / tz)
    clamped = tuple(torch.clamp(ratio[k], -lim[k], lim[k]) for k in (0, 1))
    tx, ty = clamped[0] * tz, clamped[1] * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00, j02 = fx * inv_tz, -fx * tx * inv_tz2
    j11, j12 = fy * inv_tz, -fy * ty * inv_tz2
    w3 = v[:3, :3]
    u0 = j00[:, None] * w3[0] + j02[:, None] * w3[2]              # (N, 3)
    u1 = j11[:, None] * w3[1] + j12[:, None] * w3[2]
    v0 = (sig @ u0[..., None])[..., 0]
    v1 = (sig @ u1[..., None])[..., 0]
    a = (v0 * u0).sum(-1) + lp
    b = (v0 * u1).sum(-1)
    c = (v1 * u1).sum(-1) + lp
    det = a * c - b * b
    valid = det > 1e-12
    det_inv = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    op = opacities.to(dt)
    op_act = torch.sigmoid(op) if cfg.sigmoid_opacity else op

    # The colour.
    nb = (degree + 1) ** 2
    coeffs = sh[:, :nb].to(dt)                                    # (N, nb, 3)
    x = y = z = zero
    if degree >= 1:
        origin = -(v[:3, :3].T @ v[:3, 3])
        d = m - origin
        nrm_raw = torch.linalg.vector_norm(d, dim=-1)
        nrm = torch.clamp_min(nrm_raw, 1e-8)
        e = d / nrm[:, None]
        er = env_rot.to(dt)
        rot = (transforms.rotate_y(er[1])[:3, :3]
               @ transforms.rotate_x(er[0])[:3, :3])
        x, y, z = (e @ rot.T).unbind(-1)
    basis, bx, by, bz = _sh_basis(degree, x, y, z)
    raw = sum(bk * coeffs[:, k] if isinstance(bk, float)
              else bk[:, None] * coeffs[:, k]
              for k, bk in enumerate(basis)) + 0.5
    graw = torch.where(raw >= 0.0, torch.stack(gcol, -1), 0.0)   # (N, 3)
    d_sh = torch.zeros_like(sh, dtype=dt)
    d_sh[:, :nb] = torch.stack([
        bk * graw if isinstance(bk, float) else bk[:, None] * graw
        for bk in basis], 1)
    dm = torch.zeros_like(m)
    d_sum = zero.new_zeros(3)
    if degree >= 1:
        per_k = (coeffs * graw[:, None, :]).sum(-1)               # (N, nb)
        g_dir = torch.stack([sum(dk * per_k[:, k] for k, dk in enumerate(dd))
                             for dd in (bx, by, bz)], -1)
        ge = g_dir @ rot
        g_nrm = -(ge * (e / nrm[:, None])).sum(-1)
        g_raw = torch.where(nrm_raw >= 1e-8, g_nrm, 0.0)
        scale = torch.where(nrm_raw == 0, 0.0, g_raw / nrm_raw)
        dm = ge / nrm[:, None] + d * scale[:, None]
        d_sum = torch.where(live[:, None], dm, 0.0).sum(0)

    # Opacity: the antialias factor, the sigmoid.
    g_act, ga, gb, gc = gop, zero, zero, zero
    if cfg.antialias:
        det_before = (a - lp) * (c - lp) - b * b
        num = torch.clamp_min(det_before, 0.0)
        den = torch.clamp_min(det, 1e-12)
        aa_ratio = num / den
        aa = torch.sqrt(torch.clamp(aa_ratio, 0.0, 1.0))
        g_act, g_aa = gop * aa, gop * op_act
        g_ratio = torch.where((aa_ratio >= 0.0) & (aa_ratio <= 1.0),
                              g_aa / (2.0 * aa), 0.0)
        g_before = torch.where(det_before >= 0.0, g_ratio / den, 0.0)
        g_after = torch.where(det >= 1e-12, -g_ratio * (aa_ratio / den),
                              0.0)
        ga = g_before * (c - lp) + g_after * c
        gc = g_before * (a - lp) + g_after * a
        gb = -(2.0 * b * g_before) - 2.0 * b * g_after
    d_op = g_act * (1.0 - op_act) * op_act if cfg.sigmoid_opacity else g_act

    # The conic (C, -B, A) * det_inv, then det = a c - b^2.
    g_det_inv = gcon[0] * c - gcon[1] * b + gcon[2] * a
    gdet = torch.where(valid, -g_det_inv * det_inv * det_inv, 0.0)
    ga = ga + (gcon[2] * det_inv + gdet * c)
    gc = gc + (gcon[0] * det_inv + gdet * a)
    gb = gb - (gcon[1] * det_inv + 2.0 * b * gdet)

    # EWA: v0 = S u0, v1 = S u1; a = u0.v0 + lp, b = u1.v0, c = u1.v1 + lp.
    gv0 = ga[:, None] * u0 + gb[:, None] * u1
    gv1 = gc[:, None] * u1
    gu0 = ga[:, None] * v0 + (sig @ gv0[..., None])[..., 0]
    gu1 = gb[:, None] * v0 + gc[:, None] * v1 + (sig @ gv1[..., None])[..., 0]
    g_sig = (u0[:, :, None] * gv0[:, None, :]
             + u1[:, :, None] * gv1[:, None, :])                  # (N, 3, 3)
    g_j00, g_j02 = gu0 @ w3[0], gu0 @ w3[2]
    g_j11, g_j12 = gu1 @ w3[1], gu1 @ w3[2]
    g_inv_tz2 = g_j02 * (-fx * tx) + g_j12 * (-fy * ty)
    g_inv_tz = g_j00 * fx + g_j11 * fy + 2.0 * inv_tz * g_inv_tz2
    g_t = (g_j02 * inv_tz2 * -fx, g_j12 * inv_tz2 * -fy)
    g_tz = -g_inv_tz * inv_tz * inv_tz
    g_vh = [None, None]
    for k in (0, 1):
        g_tz = g_tz + g_t[k] * clamped[k]
        g_ratio = torch.where((ratio[k] >= -lim[k]) & (ratio[k] <= lim[k]),
                              g_t[k] * tz, 0.0)
        g_vh[k] = g_ratio / tz
        g_tz = g_tz - g_ratio * (ratio[k] / tz)
    g_vh = torch.stack([*g_vh, g_tz - gd, zero], -1)

    # The pixel centre, the clip and view transforms.
    g_px, g_py = gx * w_img, gy * h_img
    g_half = g_px * cl[:, 0] + g_py * cl[:, 1]
    g_cl = torch.stack([g_px * half_inv_w, g_py * half_inv_w, zero,
                        -(g_half * 0.5) * r_w * r_w], -1)
    g_vh = g_vh + g_cl @ p
    dm = dm + g_vh @ v[:, :3]

    # Sigma = M M^T, M = R S; exp; the rotation and the quaternion's norm.
    g_mm = (g_sig + g_sig.transpose(1, 2)) @ mm
    g_r = g_mm * s[:, None, :]
    d_ls = (g_mm * r).sum(1) * s
    g = g_r.reshape(n, 9).unbind(-1)
    gqn = torch.stack([
        2 * (-qz * g[1] + qy * g[2] + qz * g[3] - qx * g[5] - qy * g[6]
             + qx * g[7]),
        2 * (qy * g[1] + qz * g[2] + qy * g[3] - 2 * qx * g[4] - qw * g[5]
             + qz * g[6] + qw * g[7] - 2 * qx * g[8]),
        2 * (-2 * qy * g[0] + qx * g[1] + qw * g[2] + qx * g[3] + qz * g[5]
             - qw * g[6] + qz * g[7] - 2 * qy * g[8]),
        2 * (-2 * qz * g[0] - qw * g[1] + qx * g[2] + qw * g[3]
             - 2 * qz * g[4] + qy * g[5] + qx * g[6] + qy * g[7])], -1)
    g_n = -(gqn * (q / qn[:, None] / qn[:, None])).sum(-1)
    n_scale = torch.where(qn == 0, 0.0, g_n / qn)
    d_q = gqn / qn[:, None] + q * n_scale[:, None]

    def keep(t):
        return torch.where(live.reshape((n,) + (1,) * (t.dim() - 1)), t, 0.0)

    d_probe = None
    if probe:
        d_probe = torch.stack([gx, gy], -1)
    out = (keep(dm), keep(d_ls), keep(d_q), keep(d_op), keep(d_sh), d_probe)
    if not view_grad:
        return out
    # The view: vh = V [m, 1]; u0 = j00 W[0] + j02 W[2], u1 = j11 W[1] +
    # j12 W[2]; the SH direction's origin (assemble_view_grad).
    mh = torch.cat([m, torch.ones_like(m[:, :1])], -1)
    g_transform = (keep(g_vh)[:, :, None] * mh[:, None, :]).sum(0)
    g_w = torch.stack([keep(gu0 * j00[:, None]).sum(0),
                       keep(gu1 * j11[:, None]).sum(0),
                       keep(gu0 * j02[:, None] + gu1 * j12[:, None]).sum(0)])
    parts = torch.cat([g_transform.reshape(16), g_w.reshape(9), d_sum])
    return (*out, assemble_view_grad(parts[None], v))


def compare_bwd(got, plain, exact, live) -> dict:
    """G-bwd's gradients `got` against PyTorch's f32 autograd of the plain
    version, `plain`, both against the float64 gradient `exact` (sequences
    in GRADS order; a None in got is skipped); live: (N,) bool, the
    gaussians with a nonzero cotangent. Per gradient: `_ratio`, the worst
    live gaussian's error from exact over its bound (ACC_FACTOR times
    autograd's, floored at ACC_FLOOR of the row's norm; 1 passes), over
    the gaussians finite in both plain and exact; `_nan_differ`, live
    entries NaN in one of got and plain only; `_zeros_lost`, structural
    zeros of plain and exact that got misses (row by row for the
    per-gaussian vectors, whose components may cancel to zero in one order
    and not another; entry by entry for the opacity and SH, single
    products); `_dead_nonzero`, nonzero entries of gaussians with zero
    cotangents."""
    out = {}
    for name, g, p, e in zip(GRADS, got, plain, exact):
        if g is None:
            continue
        n = g.shape[0]
        g, p, e = (t.reshape(n, -1) for t in (g, p, e.double()))
        zero = (p == 0) & (e == 0)
        if name in ("d_opacities", "d_sh"):
            lost = zero & (g != 0)
        else:
            lost = zero.all(-1) & (g != 0).any(-1)
        gl, pl, el = g[live].double(), p[live].double(), e[live]
        ok = torch.isfinite(pl).all(-1) & torch.isfinite(el).all(-1)
        err_g = (gl - el)[ok].norm(dim=-1)
        floor = ACC_FLOOR * el[ok].norm(dim=-1)
        bound = ACC_FACTOR * torch.maximum((pl - el)[ok].norm(dim=-1),
                                           floor)
        ratio = torch.where(err_g == 0, 0.0, err_g / bound)
        out[f"{name}_ratio"] = float(ratio.max()) if ratio.numel() else 0.0
        out[f"{name}_nan_differ"] = int(
            (torch.isnan(gl) != torch.isnan(pl)).sum())
        out[f"{name}_zeros_lost"] = int(lost.sum())
        out[f"{name}_dead_nonzero"] = int((g[~live] != 0).sum())
    return out


def compare_bwd_failures(res: dict) -> dict:
    """The readings of compare_bwd outside what it allows."""
    return {k: v for k, v in res.items()
            if (v > 1.0 if k.endswith("_ratio") else v != 0)}


def threshold_margins(want, cfg: RasterConfig) -> torch.Tensor:
    """(N,) f64: for each gaussian, the least distance of the plain
    version's ceil and cull arguments from their thresholds, each over
    max(1, |threshold|): the extents sqrt(q a), sqrt(q c) from the nearest
    integer; the depth (the clip w of the port's cameras) from the near
    plane, x +- rx and y +- ry from the screen's edges, the opacity from
    alpha_min. a and c come back from the conic, q from the opacity."""
    d = {k: getattr(want, k).double() for k in OUTPUTS}
    ca, cb, cc = d["conic"].unbind(-1)
    inv_det = ca * cc - cb * cb
    op = d["opacity"]
    q = 2.0 * torch.log(torch.clamp_min(op, 1e-12) / cfg.alpha_min)
    if cfg.extent_sigma > 0.0:
        q = torch.clamp_max(q, cfg.extent_sigma ** 2)
    q = torch.clamp_min(q, 0.0)
    args = torch.sqrt(q[:, None] * torch.clamp_min(
        torch.stack([cc, ca], -1) / inv_det[:, None], 0.0))
    r = torch.ceil(args)
    x, y = d["xy"].unbind(-1)
    w, h = float(cfg.image_width), float(cfg.image_height)

    def rel(v, thr):
        return (v - thr).abs() / max(1.0, abs(thr))

    return torch.stack([
        (args - torch.round(args)).abs().amin(-1),
        rel(d["depth"], 1e-6), rel(x + r[:, 0], 0.0), rel(x - r[:, 0], w),
        rel(y + r[:, 1], 0.0), rel(y - r[:, 1], h),
        rel(op, cfg.alpha_min)], -1).amin(-1)


def compare(got, want, cfg: RasterConfig) -> dict:
    """G's outputs `got` against the plain version's `want` (both
    ProjectedSplats): per output the max abs error and the entries outside
    RTOL / ATOL (NaN matching NaN); the gaussians whose radius differs, and
    those of them not within MARGIN of a threshold (threshold_margins)."""
    out = {}
    for k in OUTPUTS[:-1]:
        a, b = getattr(got, k).double(), getattr(want, k).double()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        err = torch.where(same, 0.0, (a - b).abs())
        out[f"{k}_max_abs_err"] = float(err.max()) if err.numel() else 0.0
        out[f"{k}_outside"] = int((err > RTOL * b.abs() + ATOL).sum())
    flips = (got.radius != want.radius).any(-1)
    margins = threshold_margins(want, cfg)
    out["radius_differ"] = int(flips.sum())
    out["radius_differ_off_threshold"] = int(
        (flips & ~(margins <= MARGIN)).sum())
    out["visible_differ"] = int(((got.radius[:, 0] > 0)
                                 != (want.radius[:, 0] > 0)).sum())
    return out
