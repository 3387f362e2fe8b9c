"""Point-splat renderer: the positional sanity path (torch port of
gaussian_splat_ipu_tpu/render/points.py).

Every gaussian centre is projected with the view-projection matrix,
perspective-divided to the viewport and rounded to a pixel (half to even,
as jnp.round); each on-screen point adds 1.0 to its pixel. Also the
per-tile histogram of point centres that the UI streams. The reference
leaves the scatter to XLA; here it is one `index_add_`, whose float adds
of 1.0 and integer adds are exact in any order, so the CPU and the card
give the same image and histogram.

The projection is four products summed in order, one op at a time
(`Camera.view_proj` and `_clip` below), so that the CPU and CUDA round the
same way: a matmul sums in another order on each device, and a last-bit
difference moves a point that sits on a pixel's rounding boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.ops import transforms
from gaussian_splat_ipu_tpu_torch.render.binning import _to_i32
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig


class PointRenderOutput(NamedTuple):
    image: torch.Tensor  # (H, W, 4) f32
    count: torch.Tensor  # () i32 on-screen points


def _clip(view_proj: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """(N, 4) clip coordinates of the (N, 3) means."""
    m = view_proj
    p = means.to(torch.float32)
    return (p[:, 0:1] * m[:, 0] + p[:, 1:2] * m[:, 1]
            + p[:, 2:3] * m[:, 2] + m[:, 3])


def _pixels(model: GaussianModel, camera: Camera, cfg: RasterConfig):
    """Rounded pixel (x, y) i32 of every centre and its visibility: in
    front of the camera and inside the viewport (the reference's
    cpu_rasteriser.cpp:38-55 test)."""
    h, w = cfg.image_height, cfg.image_width
    clip = _clip(camera.view_proj, model.means)
    xy = transforms.clip_to_screen(clip, w, h)
    # XLA's saturating f32 -> i32 conversion (points far off screen).
    x = _to_i32(torch.round(xy[:, 0]))
    y = _to_i32(torch.round(xy[:, 1]))
    vis = (clip[:, 3] > 1e-6) & (x >= 0) & (x < w) & (y >= 0) & (y < h)
    return x, y, vis


def render_points(model: GaussianModel, camera: Camera, cfg: RasterConfig,
                  color=(1.0, 1.0, 1.0)) -> PointRenderOutput:
    """1-px additive point splat of every gaussian centre."""
    h, w = cfg.image_height, cfg.image_width
    x, y, vis = _pixels(model, camera, cfg)
    flat = torch.where(vis, y * w + x, 0).long()
    img = torch.zeros(h * w, dtype=torch.float32, device=x.device)
    img.index_add_(0, flat, vis.to(torch.float32))  # hidden points add 0
    lit = torch.clamp(img, 0.0, 1.0)
    out = torch.stack([lit * float(c) for c in color] + [lit], dim=-1)
    return PointRenderOutput(image=out.reshape(h, w, 4),
                             count=vis.sum(dtype=torch.int32))


def tile_histogram(model: GaussianModel, camera: Camera,
                   cfg: RasterConfig) -> torch.Tensor:
    """(T,) i32 count of point centres per framebuffer tile, with the
    rounding and bounds rule of render_points, so that its total equals
    the splatted count (the reference's buildTileHistogram,
    cpu_rasteriser.cpp:65-92)."""
    h, w = cfg.image_height, cfg.image_width
    x, y, vis = _pixels(model, camera, cfg)
    x = torch.clamp(x, 0, w - 1)
    y = torch.clamp(y, 0, h - 1)
    tid = (y // cfg.tile_height) * cfg.tiles_x + x // cfg.tile_width
    hist = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=x.device)
    return hist.index_add_(0, torch.where(vis, tid, 0).long(),
                           vis.to(torch.int32))
