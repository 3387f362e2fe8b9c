"""Kernel G: the projection stage in one pass over the gaussians
(csrc/project.cu).

`project` launches the kernel on CUDA tensors and returns every output of
render/projection.py::project_gaussians, whose plain PyTorch body is G's
plain version and stays the CPU path and the autograd path (projection.py
chooses between them). No TPU kernel corresponds: the JAX package leaves
projection to XLA, which fuses it.

`compare` holds G's outputs to the plain version's: the values within
RTOL relative or ATOL absolute, the radii equal except where the plain
version's ceil or cull argument lies within MARGIN of its threshold. G
follows the plain version's rounding (csrc/project.cu), but the camera
origin's product matched no order tried and may differ by an ulp.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

_SIGMOID, _ANTIALIAS, _CAP_Q = 1, 2, 4
RTOL, ATOL, MARGIN = 1e-5, 1e-6, 1e-4
OUTPUTS = ("xy", "depth", "conic", "color", "opacity", "radius")


def project(means, log_scales, quats, opacities, sh, view, proj, env_rot,
            cfg: RasterConfig, degree: int) -> tuple:
    """(xy (N, 2), depth (N,), conic (N, 3), color (N, 3), opacity (N,),
    radius (N, 2)) f32, as project_gaussians computes them, the colour at
    SH degree `degree` of the (N, K, 3) coefficients ((degree + 1)^2 <= K).
    Every input a contiguous f32 tensor on one CUDA device: view and proj
    (4, 4), env_rot (2,); anything else raises."""
    cuda_lib.require_cuda(means, "means")
    dev = means.device
    n = means.shape[0]
    if sh.dim() != 3:
        raise ValueError(f"sh: shape {tuple(sh.shape)}, expected (N, K, 3)")
    k = sh.shape[1]
    if not 0 <= degree <= 3 or (degree + 1) ** 2 > k:
        raise ValueError(f"SH degree {degree}: the kernel takes 0-3, at "
                         f"most the {k} coefficients held")
    f32 = torch.float32
    for t, name, shape in ((means, "means", (n, 3)),
                           (log_scales, "log_scales", (n, 3)),
                           (quats, "quats", (n, 4)),
                           (opacities, "opacities", (n,)),
                           (sh, "sh", (n, k, 3)), (view, "view", (4, 4)),
                           (proj, "proj", (4, 4)),
                           (env_rot, "env_rot", (2,))):
        cuda_lib.require(t, name, f32, shape, dev)
    outs = tuple(torch.empty(shape, dtype=f32, device=dev) for shape in (
        (n, 2), (n,), (n, 3), (n, 3), (n,), (n, 2)))
    if n:
        flags = ((_SIGMOID if cfg.sigmoid_opacity else 0)
                 | (_ANTIALIAS if cfg.antialias else 0)
                 | (_CAP_Q if cfg.extent_sigma > 0.0 else 0))
        lib = cuda_lib.library()
        cuda_lib.check("project_gaussians", lib.gsplat_project_gaussians(
            means.data_ptr(), log_scales.data_ptr(), quats.data_ptr(),
            opacities.data_ptr(), sh.data_ptr(), n, 3 * k, degree,
            view.data_ptr(), proj.data_ptr(), env_rot.data_ptr(),
            float(cfg.image_width), float(cfg.image_height), cfg.lowpass,
            cfg.alpha_min, 1.0 / cfg.alpha_min,
            cfg.extent_sigma * cfg.extent_sigma, flags,
            *(o.data_ptr() for o in outs), cuda_lib.stream_handle(dev)))
        cuda_lib.launches["project_gaussians"] += 1
    return outs


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
