"""Dense reference renderer (torch port of
gaussian_splat_ipu_tpu/render/oracle.py): the port's independent spec of
the tiled rasterizer.

No tiles, no binning, no pair table: a global depth sort, then every
splat over every pixel, front to back, with the blend loop's rules

    power = -0.5*(A dx^2 + C dy^2) - B dx dy        (skip if power > 0)
    alpha = min(alpha_clamp, opacity * exp(power))   (skip if < alpha_min)
    break when T*(1-alpha) < transmittance_eps       (before blending;
                                                      sticky per pixel)
    color += rgb * alpha * T;  T *= (1-alpha)

and the background composited under the final transmittance. Culled
splats (radius 0) get zero opacity. This is the strict termination of
kernel C; the relaxed weight gate (RasterConfig.strict_termination=False)
is not the oracle's semantics.

A plain loop over the sorted splats, O(N * pixels): small scenes only
(about 6k splats at 160x128 on a card). It runs on whatever device its
inputs are on and is differentiable by autograd, so it also gives the
gradients that kernel D is held to. It has no kernel.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.projection import (ProjectedSplats,
                                                            project_gaussians)
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig


def composite_dense(splats: ProjectedSplats, cfg: RasterConfig,
                    width: int | None = None,
                    height: int | None = None) -> torch.Tensor:
    """Composite the depth-sorted splats over every pixel, in sequence.
    Returns (H, W, 4): RGB composited over cfg.background, alpha = 1 - the
    final transmittance."""
    width = cfg.image_width if width is None else width
    height = cfg.image_height if height is None else height
    dev = splats.xy.device

    order = torch.argsort(splats.depth, stable=True)
    xy = splats.xy[order]
    conic = splats.conic[order]
    color = splats.color[order]
    opacity = torch.where(splats.radius[order, 0] > 0.0,
                          splats.opacity[order], 0.0)

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    t = torch.ones((height, width), dtype=torch.float32, device=dev)
    rgb = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    stopped = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for i in range(xy.shape[0]):
        dx = xy[i, 0] - px
        dy = xy[i, 1] - py
        power = (-0.5 * (conic[i, 0] * dx * dx + conic[i, 2] * dy * dy)
                 - conic[i, 1] * dx * dy)
        alpha = torch.clamp_max(opacity[i] * torch.exp(power),
                                cfg.alpha_clamp)
        skip = (power > 0.0) | (alpha < cfg.alpha_min)
        alpha = torch.where(skip, 0.0, alpha)
        # Once the would-be transmittance dips below eps, this splat and
        # every later one are dropped for the pixel.
        stopped = stopped | (t * (1.0 - alpha) < cfg.transmittance_eps)
        alpha = torch.where(stopped, 0.0, alpha)
        rgb = rgb + color[i] * (alpha * t)[..., None]
        t = t * (1.0 - alpha)

    bg = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
    rgb = rgb + t[..., None] * bg
    return torch.cat([rgb, (1.0 - t)[..., None]], -1)


def render_oracle(model: GaussianModel, camera: Camera,
                  cfg: RasterConfig) -> torch.Tensor:
    """Project with the port's projection, then composite densely: (H, W,
    4) f32 on the model's device."""
    return composite_dense(project_gaussians(model, camera, cfg), cfg)
