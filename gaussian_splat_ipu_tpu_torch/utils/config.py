"""Renderer configuration: the port's own `RasterConfig`, a copy of the
reference's (gaussian_splat_ipu_tpu/utils/config.py:25-221) with the same
fields in the same order, the same defaults and the same derived
properties, plus the check that rejects the settings the reference
rejects. Tests move a config between the packages field by field
(`dataclasses.asdict`)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

DEFAULT_IMAGE_WIDTH = 1280
DEFAULT_IMAGE_HEIGHT = 720


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static configuration of the tiled rasterizer (frozen, hashable)."""

    image_width: int = DEFAULT_IMAGE_WIDTH
    image_height: int = DEFAULT_IMAGE_HEIGHT
    # Framebuffer tile; the kernels run one CTA per tile.
    tile_width: int = 32
    tile_height: int = 32
    # Pairs staged and composited per step of a tile's range.
    chunk_size: int = 128
    # Capacity of the (gaussian, tile) pair table; pairs past it are
    # dropped and counted (RenderOutput.overflow).
    pair_capacity: int = 1 << 18
    # Max tiles a footprint may cover per axis (reference clipSize).
    max_tiles_per_axis: int = 16
    # Max chunks any one tile composites (kernels and plain versions cut
    # identically).
    max_chunks_per_tile: int = 128
    # Early termination threshold on transmittance (codelets.cpp:405-408).
    transmittance_eps: float = 1e-4
    # Alpha handling (codelets.cpp:400-403).
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    # EWA low-pass added to the 2D covariance diagonal.
    lowpass: float = 0.3
    # Scale opacity by sqrt(det(cov) / det(cov + lowpass)) (Mip-Splatting).
    antialias: bool = False
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Sigmoid on the raw opacity (standard 3DGS).
    sigmoid_opacity: bool = True
    # One i32 (tile | quantized depth) sort key; False: the exact two-pass
    # (tile, full depth) sort.
    fused_sort_key: bool = True
    # Stream expansion kernel for the fused path; False: the row gather.
    expand_kernel: bool = True
    # Sort gaussians by depth first, then a tile-only stable pair sort.
    presort_depth: bool = False
    # Footprint bound in sigmas (0.0: the full alpha_min radius).
    extent_sigma: float = 3.0
    # Exact tile-ellipse coverage masks during binning.
    exact_tile_test: bool = False
    # Bin (gaussian, tile group) pairs over g x g super-tiles; each tile
    # composites its group's range. 1 = off.
    tile_group: int = 1
    # Row-bucket segmented binning: R tile-row buckets. 1 = off.
    rowseg_buckets: int = 1
    # (R+1,) ascending local group-row bounds of the buckets; empty =
    # equal row split.
    rowseg_bounds: tuple = ()
    # Strict (reference break) termination in the inference forward;
    # False: the relaxed weight gate. Training is always strict.
    strict_termination: bool = True
    # Cap on the SH band evaluated (-1 = the model's full degree).
    active_sh_degree: int = -1

    @property
    def max_chunks_per_range(self) -> int:
        """Per-range compositing work bound: a tile's range is its whole
        group's, so the cap scales with tile_group^2."""
        return self.max_chunks_per_tile * self.tile_group * self.tile_group

    @property
    def tiles_x(self) -> int:
        return -(-self.image_width // self.tile_width)

    @property
    def tiles_y(self) -> int:
        return -(-self.image_height // self.tile_height)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_width

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_height

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_width * self.tile_height


def tile_bits(cfg: RasterConfig) -> int:
    """Bits of the fused sort key taken by the tile (or tile-group) id.

    The bound is the global grid's, doubled for the phantom rows of an
    uneven row sharding, exactly as the reference computes it
    (render/binning.py:896-900), so the key's depth quantization is the
    same in both packages."""
    g = cfg.tile_group
    if g > 1:
        max_query = 2 * (-(-cfg.tiles_y // g)) * (-(-cfg.tiles_x // g))
    else:
        max_query = 2 * cfg.tiles_y * cfg.tiles_x
    return (max_query + 1).bit_length()


def check_supported(cfg: RasterConfig) -> None:
    """Raise ValueError for a setting the JAX package refuses too: its
    bin_splats asserts footprints of at most 32 cells per axis and tile
    axes of at most 4096 tiles (render/binning.py:836-837), the bit
    budget of the packed geometry (x0, y0: 12 bits; nx: 6 bits)."""
    bad = []
    if cfg.max_tiles_per_axis > 32:
        bad.append(f"max_tiles_per_axis={cfg.max_tiles_per_axis} > 32")
    if cfg.tiles_x > 4096 or cfg.tiles_y > 4096:
        bad.append(f"a {cfg.tiles_x}x{cfg.tiles_y} tile grid (an axis over "
                   "4096 tiles)")
    if bad:
        raise ValueError("; ".join(bad) + ": outside the packed binning "
                         "geometry, which the JAX package refuses too "
                         "(render/binning.py:836-837)")
