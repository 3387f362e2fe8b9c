"""Full render pipeline: project -> bin -> rasterize -> image (torch port of
gaussian_splat_ipu_tpu/render/pipeline.py). On CUDA tensors binning and
rasterization run the port's CUDA kernels; on CPU tensors their plain
versions. Differentiable end to end in the model's parameters when they
require grad (GaussianModel.trainable())."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render import binning
from gaussian_splat_ipu_tpu_torch.render.kernels import rasterize
from gaussian_splat_ipu_tpu_torch.render.projection import project_gaussians
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig


class RenderOutput(NamedTuple):
    image: torch.Tensor       # (H, W, 4) f32 RGBA (alpha = coverage)
    # (T,) i32 pairs composited per tile; with cfg.tile_group > 1 every
    # member tile reports its GROUP's range, and `truncated` is deduped to
    # one tally per group.
    tile_counts: torch.Tensor
    overflow: torch.Tensor    # () i32 dropped pairs (capacity exceeded)
    num_pairs: torch.Tensor   # () i32 live (gaussian, tile) pairs
    visible: torch.Tensor     # (N,) bool, gaussian survived frustum cull
    # Pairs past the per-range work bound max_chunks_per_range * chunk_size
    # (the farthest splats of a range drop). Nonzero: raise
    # max_chunks_per_tile.
    truncated: torch.Tensor   # () i32


def _untile_crop(tiles: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(T, NPIX, 4) tile buffers -> (H, W, 4) cropped raster image."""
    c = tiles.shape[-1]
    x = tiles.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile_height,
                      cfg.tile_width, c)
    x = x.permute(0, 2, 1, 3, 4).reshape(cfg.padded_height,
                                         cfg.padded_width, c)
    return x[:cfg.image_height, :cfg.image_width]


def render(model: GaussianModel, camera: Camera, cfg: RasterConfig,
           xy_probe: torch.Tensor | None = None) -> RenderOutput:
    """Render one frame on the model's device."""
    splats = project_gaussians(model, camera, cfg, xy_probe=xy_probe)
    binned = binning.bin_splats(splats, cfg)
    tiles = rasterize.rasterize_tiles(binned, cfg)
    image = _untile_crop(tiles, cfg)
    counts = binned.tile_ends - binned.tile_starts
    return RenderOutput(image=image, tile_counts=counts,
                        overflow=binned.overflow, num_pairs=binned.num_pairs,
                        visible=splats.radius[:, 0] > 0.0,
                        truncated=truncated_pairs(counts, cfg))


def truncated_pairs(counts: torch.Tensor, cfg: RasterConfig,
                    row_lo: int = 0) -> torch.Tensor:
    """() i32 pairs past the per-range work bound max_chunks_per_range *
    chunk_size, one tally per tile group, of the per-tile pair counts of
    tile rows from row_lo on (a row strip of the distributed renderer)."""
    over = torch.clamp_min(
        counts - cfg.max_chunks_per_range * cfg.chunk_size, 0)
    g = cfg.tile_group
    if g > 1:
        idx = torch.arange(counts.shape[0], device=counts.device)
        rep = (((row_lo + idx // cfg.tiles_x) % g == 0)
               & ((idx % cfg.tiles_x) % g == 0))
        over = torch.where(rep, over, 0)
    return over.sum(dtype=torch.int32)


def render_image(model: GaussianModel, camera: Camera,
                 cfg: RasterConfig) -> torch.Tensor:
    """(H, W, 4) image only: the differentiable entry point for
    training."""
    return render(model, camera, cfg).image


def render_depth(model: GaussianModel, camera: Camera, cfg: RasterConfig):
    """Alpha-composited depth through the same tiled pipeline: each splat's
    colour becomes (depth, depth^2, 0), so the compositor accumulates the
    first two depth moments. Returns (mean_depth, depth_var, alpha), each
    (H, W), zero where alpha ~ 0."""
    if cfg.background != (0.0, 0.0, 0.0):
        cfg = dataclasses.replace(cfg, background=(0.0, 0.0, 0.0))
    splats = project_gaussians(model, camera, cfg)
    d = splats.depth
    depth_splats = splats._replace(
        color=torch.stack([d, d * d, torch.zeros_like(d)], dim=-1))
    binned = binning.bin_splats(depth_splats, cfg)
    img = _untile_crop(rasterize.rasterize_tiles(binned, cfg), cfg)
    alpha = img[..., 3]
    safe = torch.clamp_min(alpha, 1e-8)
    mean = img[..., 0] / safe
    var = torch.clamp_min(img[..., 1] / safe - mean * mean, 0.0)
    hit = alpha > 1e-6
    return (torch.where(hit, mean, 0.0), torch.where(hit, var, 0.0), alpha)
