"""Renderer configuration: the reference's jax-free `RasterConfig`, shared
so that one config drives both packages in every parity test, plus the
check that rejects the options this port does not carry yet."""

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
    """Raise NotImplementedError for a setting this port does not carry.

    Each of these is a path of the JAX package that is still to be ported
    (ROADMAP.md); nothing here is declared unnecessary."""
    unported = []
    if cfg.rowseg_buckets > 1:
        unported.append(f"rowseg_buckets={cfg.rowseg_buckets} (row-bucket "
                        "segmented binning)")
    if cfg.presort_depth:
        unported.append("presort_depth=True (depth-presorted binning)")
    if not cfg.fused_sort_key:
        unported.append("fused_sort_key=False (exact two-pass sort)")
    if not cfg.expand_kernel:
        unported.append("expand_kernel=False (gather expansion A/B)")
    if cfg.max_tiles_per_axis > 32:
        unported.append(f"max_tiles_per_axis={cfg.max_tiles_per_axis} > 32")
    if cfg.tiles_x > 4096 or cfg.tiles_y > 4096:
        unported.append(f"a {cfg.tiles_x}x{cfg.tiles_y} tile grid (an axis "
                        "over 4096 tiles)")
    if 31 - tile_bits(cfg) < 16:
        unported.append(f"a tile grid needing {tile_bits(cfg)} key bits "
                        "(fewer than 16 depth bits left: the reference's "
                        "exact two-pass sort)")
    if unported:
        raise NotImplementedError(
            "gaussian_splat_ipu_tpu_torch does not port "
            + "; ".join(unported) + " yet")
