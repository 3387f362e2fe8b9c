"""Row strips of the distributed renderer against the JAX package:
bin_splats with row_lo / num_rows / pair_capacity on every binning path
(bit for bit, an uneven last strip with a phantom row and grouped strips
with exact tiles included), and the plain compositing forward and backward
at a tile offset. Two guards of the port's own, with no parity to take: the
phantom tiles of a degenerate mesh get empty ranges, and the row buckets of
a strip that does not start on a group row drop no pair."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.render import binning as jbin
from gaussian_splat_ipu_tpu.render import tile_raster as jraster
from gaussian_splat_ipu_tpu_torch.render import binning
from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
    rasterize_backward_torch, rasterize_tiles_torch)
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig, tile_bits
from tests.test_torch_binning import assert_binned_equal, jax_splats, to_torch
from tests.test_torch_config import jax_config
from tests.test_torch_rasterize import to_torch as binned_to_torch

torch.set_num_threads(1)

# 10 x 7 tiles of 16 px: two strips of 4 rows leave one phantom row, and
# grouped strips of 6 rows (tile_group 3) leave five.
CFG = RasterConfig(image_width=160, image_height=112, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 13,
                   max_chunks_per_tile=16)
PATHS = {"stream": {}, "gather": dict(expand_kernel=False),
         "presort": dict(presort_depth=True),
         "exact": dict(fused_sort_key=False)}


def strips(cfg, d):
    """(row_lo, num_rows) of each of d strips, rows rounded up to whole
    group rows (parallel/distributed.py::_rows_per_device)."""
    g = cfg.tile_group
    rows = -(-(-(-cfg.tiles_y // d)) // g) * g
    return [(j * rows, rows) for j in range(d)]


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("group", [dict(), dict(tile_group=3,
                                                exact_tile_test=True)])
def test_strips_bit_identical(path, group):
    cfg = dataclasses.replace(CFG, **PATHS[path], **group)
    js = jax_splats(0, 1000, cfg)
    ts = to_torch(js)
    total = 0
    for row_lo, num_rows in strips(cfg, 2):
        want = jbin.bin_splats(js, jax_config(cfg), row_lo=row_lo,
                               num_rows=num_rows, pair_capacity=4096)
        got = binning.bin_splats(ts, cfg, row_lo, num_rows, 4096)
        assert_binned_equal(want, got)
        assert got.tile_starts.shape == (num_rows * cfg.tiles_x,)
        assert int(got.overflow) == 0
        total += int(got.num_pairs)
    # With whole group rows per strip, no pair is binned twice.
    assert total == int(binning.bin_splats(ts, cfg).num_pairs) > 500


@pytest.mark.parametrize("buckets", [2, 3])
def test_rowseg_strips_bit_identical(buckets, monkeypatch):
    """The reference segments on the CPU only with FORCE_EXPAND_KERNEL
    and its interpreter's 256-slot buckets (tests/test_torch_rowseg.py);
    each strip's buckets split its own group rows."""
    monkeypatch.setattr(jbin, "FORCE_EXPAND_KERNEL", True)
    monkeypatch.setattr(binning, "SEG_ALIGN", 256)
    cfg = dataclasses.replace(CFG, rowseg_buckets=buckets,
                              exact_tile_test=True)
    js = jax_splats(1, 800, cfg)
    ts = to_torch(js)
    for row_lo, num_rows in strips(cfg, 2):
        want = jbin.bin_splats(js, jax_config(cfg), row_lo=row_lo,
                               num_rows=num_rows, pair_capacity=4096)
        got = binning.bin_splats(ts, cfg, row_lo, num_rows, 4096)
        assert_binned_equal(want, got)
        assert int(got.tile_starts.max()) > int(got.num_pairs)  # segments


def test_overflowing_strip_bit_identical():
    cfg = dataclasses.replace(CFG, exact_tile_test=True)
    js = jax_splats(2, 1000, cfg)
    want = jbin.bin_splats(js, jax_config(cfg), row_lo=4, num_rows=4,
                           pair_capacity=256)
    got = binning.bin_splats(to_torch(js), cfg, 4, 4, 256)
    assert_binned_equal(want, got)
    assert int(got.overflow) > 0 and int(got.num_pairs) == 256


def _strip_binned(cfg, seed, row_lo, num_rows, **kw):
    js = jax_splats(seed, 1000, cfg, **kw)
    return jbin.bin_splats(js, jax_config(cfg), row_lo=row_lo,
                           num_rows=num_rows, pair_capacity=4096)


@pytest.mark.parametrize("tile_group", [1, 3])
def test_plain_forward_at_an_offset_matches_jnp_spec(tile_group):
    """The second strip at global offset row_lo * tiles_x, strict and
    relaxed, against rasterize_tiles_jnp(tile_offset=); atol 1e-5 as the
    whole-grid forward's."""
    cfg = dataclasses.replace(CFG, tile_group=tile_group,
                              background=(0.1, 0.2, 0.3))
    row_lo, num_rows = strips(cfg, 2)[1]
    jb = _strip_binned(cfg, 3, row_lo, num_rows)
    off = row_lo * cfg.tiles_x
    want = np.asarray(jraster.rasterize_tiles_jnp(jb, jax_config(cfg),
                                                  tile_offset=off))
    for strict in (True, False):
        got = rasterize_tiles_torch(
            binned_to_torch(jb),
            dataclasses.replace(cfg, strict_termination=strict),
            tile_offset=off).numpy()
        assert got.shape == (num_rows * cfg.tiles_x, cfg.pixels_per_tile, 4)
        np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-5)
        if strict:
            np.testing.assert_allclose(got, want, atol=1e-5)
    assert want[..., 3].max() > 0.5
    # At offset 0 the same ranges would light other pixels.
    at_zero = rasterize_tiles_torch(binned_to_torch(jb), cfg).numpy()
    assert np.abs(at_zero - want).max() > 0.1


@pytest.mark.parametrize("tile_group", [1, 3])
def test_plain_backward_at_an_offset_matches_jnp_spec_grad(tile_group):
    """jax.grad of rasterize_tiles_jnp(tile_offset=) against the plain
    backward at the same offset; the whole-grid backward's bar (atol 2e-4,
    rtol 1e-3)."""
    cfg = dataclasses.replace(CFG, tile_group=tile_group)
    row_lo, num_rows = strips(cfg, 2)[1]
    jb = _strip_binned(cfg, 4, row_lo, num_rows)
    off = row_lo * cfg.tiles_x
    cot = np.random.default_rng(5).normal(
        size=(num_rows * cfg.tiles_x, cfg.pixels_per_tile, 4)).astype(
            np.float32)

    def f(features):
        return jnp.sum(jraster.rasterize_tiles_jnp(
            jb._replace(features=features), jax_config(cfg),
            tile_offset=off) * cot)

    want = np.asarray(jax.grad(f)(jb.features))
    tb = binned_to_torch(jb)
    tiles, nc = rasterize_tiles_torch(tb, cfg, need_aux=True,
                                      tile_offset=off)
    got = rasterize_backward_torch(tb.features, tb.tile_starts, tb.tile_ends,
                                   torch.tensor(cot), 1.0 - tiles[..., 3], nc,
                                   cfg, off).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    assert np.abs(want).max() > 1.0


def test_phantom_tiles_of_a_degenerate_mesh_are_empty():
    """tiles_y = 8, tile_group = 3 over 8 strips: strips of 3 rows, the
    last at group row 7, past the global bound 2 * ceil(8 / 3) = 6 group
    rows that sizes the key. A phantom group row's id can then reach the
    pad sentinel 2^tile_bits - 1, whose range in the reference spans the
    pad tail. The port's phantom tiles query the first key past the grid:
    every one has an empty range, and every strip's pairs together are
    the whole grid's."""
    cfg = RasterConfig(image_width=64, image_height=128, tile_width=16,
                       tile_height=16, chunk_size=32, pair_capacity=4096,
                       tile_group=3, exact_tile_test=True)
    assert cfg.tiles_y == 8
    ntx_key = -(-cfg.tiles_x // 3)
    sentinel = (1 << tile_bits(cfg)) - 1
    js = jax_splats(6, 600, cfg)
    ts = to_torch(js)
    total = 0
    collides = False
    for row_lo, num_rows in strips(cfg, 8):
        got = binning.bin_splats(ts, cfg, row_lo, num_rows, 4096)
        rows = row_lo + np.arange(num_rows * cfg.tiles_x) // cfg.tiles_x
        cols = np.arange(num_rows * cfg.tiles_x) % cfg.tiles_x
        keys = (rows // 3) * ntx_key + cols // 3
        collides |= bool((keys == sentinel).any())
        counts = (got.tile_ends - got.tile_starts).numpy()
        phantom = rows >= cfg.tiles_y
        assert (counts[phantom & (rows // 3 >= 3)] == 0).all()
        total += int(got.num_pairs)
    assert collides   # the reference's bound is reached on this mesh
    assert total == int(binning.bin_splats(ts, cfg).num_pairs) > 100


def test_rowseg_strip_off_group_rows_drops_no_pair(monkeypatch):
    """Tile rows 1-6 with tile_group 3 touch group rows 0-2, one more than
    ceil(6 / 3); the buckets cover all three, so the segmented strip keeps
    the flat strip's pairs, tile for tile."""
    monkeypatch.setattr(binning, "SEG_ALIGN", 256)
    cfg = dataclasses.replace(CFG, tile_group=3, exact_tile_test=True)
    seg = dataclasses.replace(cfg, rowseg_buckets=2)
    ts = to_torch(jax_splats(7, 1000, cfg))
    assert binning.strip_group_rows(cfg, 1, 6) == (0, 3)
    flat = binning.bin_splats(ts, cfg, 1, 6, 4096)
    got = binning.bin_splats(ts, seg, 1, 6, 4096)
    assert int(got.overflow) == 0
    assert int(got.num_pairs) == int(flat.num_pairs) > 100
    assert int(got.tile_starts.max()) > int(got.num_pairs)  # segments
    for s0, e0, s1, e1 in zip(flat.tile_starts, flat.tile_ends,
                              got.tile_starts, got.tile_ends):
        np.testing.assert_array_equal(got.features[:, s1:e1].numpy(),
                                      flat.features[:, s0:e0].numpy())
