"""Renderer configuration: the reference's jax-free `RasterConfig`, shared
so that one config drives both packages in every parity test, plus the
check that rejects the settings the reference rejects."""

from __future__ import annotations

from gaussian_splat_ipu_tpu.utils.config import RasterConfig


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
