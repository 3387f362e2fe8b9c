"""Tiled framebuffer model: image <-> tile coordinate algebra (torch port of
gaussian_splat_ipu_tpu/utils/tiling.py).

The reference keeps the tile routing helpers of its source system
(TiledFramebuffer, tile_config.hpp:19-139) for tests and telemetry; so
does the port. Every method takes Python numbers, numpy arrays or tensors
and returns tensors; integer division rounds toward minus infinity, as
jnp.floor_divide and jnp.divmod do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

# Direction encoding, reference include/splat/ipu_geometry.hpp:94-100.
LEFT, RIGHT, UP, DOWN, NONE = 0, 1, 2, 3, 4


def _i32(v) -> torch.Tensor:
    return torch.as_tensor(v).to(torch.int32)


def _divmod(a: torch.Tensor, b: int):
    q = torch.div(a, b, rounding_mode="floor")
    return q, a - q * b


@dataclasses.dataclass(frozen=True)
class TiledFramebuffer:
    """Pixel <-> tile arithmetic for a statically tiled framebuffer:
    pix_coord_to_tile, tile_bounds, nearby_tile, best_direction,
    check_image_boundaries."""

    width: int
    height: int
    tile_width: int
    tile_height: int

    @classmethod
    def from_config(cls, cfg: RasterConfig) -> "TiledFramebuffer":
        return cls(cfg.padded_width, cfg.padded_height, cfg.tile_width,
                   cfg.tile_height)

    @property
    def tiles_x(self) -> int:
        return self.width // self.tile_width

    @property
    def tiles_y(self) -> int:
        return self.height // self.tile_height

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def pix_coord_to_tile(self, y, x) -> torch.Tensor:
        """Row-major tile index of pixel (y, x); -1 if out of bounds."""
        y, x = torch.as_tensor(y), torch.as_tensor(x)
        tx = torch.div(_i32(x), self.tile_width, rounding_mode="floor")
        ty = torch.div(_i32(y), self.tile_height, rounding_mode="floor")
        ok = (x >= 0) & (x < self.width) & (y >= 0) & (y < self.height)
        return torch.where(ok, ty * self.tiles_x + tx, -1)

    def tile_bounds(self, tid):
        """(x0, y0, x1, y1) pixel bounds of tile tid (exclusive max)."""
        ty, tx = _divmod(_i32(tid), self.tiles_x)
        x0 = tx * self.tile_width
        y0 = ty * self.tile_height
        return x0, y0, x0 + self.tile_width, y0 + self.tile_height

    def tile_centroid(self, tid):
        x0, y0, x1, y1 = self.tile_bounds(tid)
        return (x0 + x1) * 0.5, (y0 + y1) * 0.5

    def nearby_tile(self, tid, direction) -> torch.Tensor:
        """The neighbour of tid in `direction`; tid itself at the edge."""
        tid, direction = _i32(tid), _i32(direction)
        ty, tx = _divmod(tid, self.tiles_x)
        dx = torch.where(direction == LEFT, -1,
                         torch.where(direction == RIGHT, 1, 0))
        dy = torch.where(direction == UP, -1,
                         torch.where(direction == DOWN, 1, 0))
        nx, ny = tx + dx, ty + dy
        ok = (nx >= 0) & (nx < self.tiles_x) & (ny >= 0) & (ny < self.tiles_y)
        return torch.where(ok, ny * self.tiles_x + nx, tid)

    def best_direction(self, src_xy, dst_xy) -> torch.Tensor:
        """Direction of the largest axis gap from src pixel centre to dst,
        (..., 2) float (x, y) each; NONE within half a tile on both axes
        (greedy Manhattan routing, tile_config.hpp:92-110)."""
        src = torch.as_tensor(src_xy, dtype=torch.float32)
        dst = torch.as_tensor(dst_xy, dtype=torch.float32)
        dx = dst[..., 0] - src[..., 0]
        dy = dst[..., 1] - src[..., 1]
        horiz = torch.where(dx < 0, LEFT, RIGHT)
        vert = torch.where(dy < 0, UP, DOWN)
        d = torch.where(dx.abs() >= dy.abs(), horiz, vert)
        same = (dx.abs() < self.tile_width / 2) & (
            dy.abs() < self.tile_height / 2)
        return torch.where(same, NONE, d)

    def check_image_boundaries(self, tid):
        """(at_left, at_right, at_top, at_bottom) bool tensors."""
        ty, tx = _divmod(_i32(tid), self.tiles_x)
        return (tx == 0, tx == self.tiles_x - 1, ty == 0,
                ty == self.tiles_y - 1)


def tile_image(img: torch.Tensor, fb: TiledFramebuffer) -> torch.Tensor:
    """(H, W, C) raster image -> (num_tiles, tile_h*tile_w, C) tile order."""
    c = img.shape[-1]
    x = img.reshape(fb.tiles_y, fb.tile_height, fb.tiles_x, fb.tile_width, c)
    return x.permute(0, 2, 1, 3, 4).reshape(
        fb.num_tiles, fb.tile_height * fb.tile_width, c)


def untile_image(tiles: torch.Tensor, fb: TiledFramebuffer) -> torch.Tensor:
    """(num_tiles, tile_h*tile_w, C) -> (H, W, C) raster image."""
    c = tiles.shape[-1]
    x = tiles.reshape(fb.tiles_y, fb.tiles_x, fb.tile_height, fb.tile_width,
                      c)
    return x.permute(0, 2, 1, 3, 4).reshape(fb.height, fb.width, c)


def tile_histogram(counts, fb: TiledFramebuffer) -> np.ndarray:
    """Per-tile workload as a (tiles_y, tiles_x) numpy grid (the per-tile
    counters the reference streams to its UI)."""
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    return np.asarray(counts).reshape(fb.tiles_y, fb.tiles_x)
