"""Binning parity: the torch port's bin_splats on every path, its plain
expansion and its plain coverage masks against the JAX package, bit for
bit, on the same projected splats."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.render import binning as jbin
from gaussian_splat_ipu_tpu.render.kernels import coverage as jcov
from gaussian_splat_ipu_tpu.render.kernels import expand as jexp
from gaussian_splat_ipu_tpu.render.projection import (
    project_gaussians as j_project)
from gaussian_splat_ipu_tpu_torch.render import binning
from gaussian_splat_ipu_tpu_torch.render.kernels import coverage, expand
from gaussian_splat_ipu_tpu_torch.render.projection import ProjectedSplats
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                       check_supported)
from tests.test_torch_config import jax_config

torch.set_num_threads(1)

CFG = RasterConfig(image_width=160, image_height=96, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 14,
                   max_chunks_per_tile=16)
BB = np.ones(3, np.float32)


def jax_splats(seed, n, cfg, rot=30.0, log_scale=(-4.5, -2.5)):
    rng = np.random.default_rng(seed)
    model = JModel(
        means=jnp.asarray(rng.uniform(-1, 1, (n, 3)), jnp.float32),
        log_scales=jnp.asarray(rng.uniform(*log_scale, (n, 3)), jnp.float32),
        quats=jnp.asarray(rng.normal(size=(n, 4)), jnp.float32),
        opacities=jnp.asarray(rng.uniform(-2, 4, n), jnp.float32),
        sh=jnp.asarray(rng.uniform(-1, 1, (n, 1, 3)), jnp.float32))
    cam = JCamera.orbit(-BB, BB, np.radians(40.0),
                        cfg.image_width / cfg.image_height, rot_y_deg=rot)
    return j_project(model, cam, jax_config(cfg))


def to_torch(splats):
    return ProjectedSplats(*(torch.tensor(np.asarray(x)) for x in splats))


def assert_binned_equal(want, got):
    # array_equal: -0.0 == +0.0, the one allowed difference
    # (tests/test_binning.py:133-135).
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("tile_group", [1, 3])
@pytest.mark.parametrize("exact", [False, True])
def test_bin_splats_bit_identical(tile_group, exact):
    cfg = dataclasses.replace(CFG, tile_group=tile_group,
                              exact_tile_test=exact)
    js = jax_splats(0, 1500, cfg)
    want = jbin.bin_splats(js, jax_config(cfg))
    got = binning.bin_splats(to_torch(js), cfg)
    assert_binned_equal(want, got)
    assert int(got.num_pairs) > 1000 and int(got.overflow) == 0


def test_bin_splats_overflow_bit_identical():
    cfg = dataclasses.replace(CFG, pair_capacity=512, exact_tile_test=True)
    js = jax_splats(1, 600, cfg)
    want = jbin.bin_splats(js, jax_config(cfg))
    got = binning.bin_splats(to_torch(js), cfg)
    assert_binned_equal(want, got)
    assert int(got.overflow) > 0
    assert int(got.num_pairs) == 512


def test_empty_scene_bins_nothing():
    js = jax_splats(2, 40, CFG)
    js = js._replace(radius=jnp.zeros_like(js.radius))
    want = jbin.bin_splats(js, jax_config(CFG))
    got = binning.bin_splats(to_torch(js), CFG)
    assert_binned_equal(want, got)
    assert int(got.num_pairs) == 0
    assert int((got.tile_ends - got.tile_starts).sum()) == 0


def test_stream_expand_plain_matches_pallas_interpret():
    """The plain expansion against the reference's stream_expand kernel in
    interpret mode, driven as bin_splats drives it (chunk 256, win 512);
    culled gaussians interleave with covered ones, and the table has a
    pad tail. Pad columns of the TPU kernel are unspecified (bin_splats
    zeroes them after the sort), so only live columns compare."""
    cfg = dataclasses.replace(CFG, pair_capacity=2048)
    ts = to_torch(jax_splats(3, 700, cfg))
    packed, offs = binning.pack_gaussians(ts, cfg)
    n, p = packed.shape[0] - 1, cfg.pair_capacity
    total = int(offs[n])
    assert 0 < total < p
    cols, gid, rank = expand.stream_expand_torch(packed, offs, p)

    offs_j = jnp.asarray(offs.numpy())
    los, span = jexp.window_starts_from_offsets(offs_j, p, n, chunk=256)
    assert int(span) <= 512
    nblocks = -(-p // 256)
    jcols, jgid, jrank = jexp.stream_expand(
        jexp.pad_packed_cols(jnp.asarray(packed.numpy()), win=512),
        jnp.concatenate([offs_j, jnp.full((512 + 256,), 0x7FFFFFFF,
                                          jnp.int32)])[None],
        los, jnp.zeros((nblocks,), jnp.int32),
        jnp.broadcast_to(offs_j[n], (nblocks,)),
        jnp.full((1,), n, jnp.int32), p, chunk=256, win=512, interpret=True)
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(cols.numpy()[:, :total],
                                  np.asarray(jcols)[:, :total])
    np.testing.assert_array_equal(cols.numpy()[:, total:], 0.0)
    assert (gid.numpy()[total:] == n).all()


@pytest.mark.parametrize("tile_group", [1, 2])
def test_coverage_plain_matches_pallas_interpret(tile_group):
    """The plain coverage masks against the reference's coverage kernel in
    interpret mode (tests/test_exact_tile.py:163), footprints of every size
    up to and beyond the 8x8 window."""
    cfg = dataclasses.replace(CFG, image_width=320, image_height=192,
                              exact_tile_test=True, tile_group=tile_group)
    ts = to_torch(jax_splats(4, 2000, cfg, rot=75.0, log_scale=(-5, -1.5)))
    x0, y0, nx, ny = binning.cell_footprints(ts, cfg)
    testable, geomf, geomi = binning.coverage_inputs(ts, x0, y0, nx, ny)
    assert bool(testable.any())
    kw = dict(tw=float(tile_group * cfg.tile_width),
              th=float(tile_group * cfg.tile_height),
              alpha_min=float(cfg.alpha_min))
    got = coverage.coverage_masks(geomf, geomi, **kw)
    want = jcov.coverage_masks_tpu(jnp.asarray(geomf.numpy()),
                                   jnp.asarray(geomi.numpy()),
                                   interpret=True, **kw)
    for name, a, b in zip(("mlo", "mhi", "count"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert int(got[2].sum()) > 0


def test_decode_tiles_matches_jax():
    """Rank -> tile decode over random 64-bit masks (bit 31 and bit 63
    included) and unmasked rectangles, against the reference."""
    rng = np.random.default_rng(5)
    m = 4000
    mlo = rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32)
    mhi = rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32)
    mlo[:8] = np.int32(-2**31)                # only bit 31
    mhi[8:16] = np.int32(-2**31)              # only bit 63
    masked = rng.integers(0, 2, m).astype(np.int32)
    pop = np.array([bin(int(a) & 0xFFFFFFFF).count("1")
                    + bin(int(b) & 0xFFFFFFFF).count("1")
                    for a, b in zip(mlo, mhi)])
    gnx = rng.integers(1, 33, m).astype(np.int32)
    rank = np.where(masked == 1, rng.integers(0, 1 << 20, m) % np.maximum(
        pop, 1), rng.integers(0, 32 * 32, m)).astype(np.int32)
    gx0 = rng.integers(0, 4096, m).astype(np.int32)
    gy0 = rng.integers(0, 4096, m).astype(np.int32)
    jtx, jty = jbin._decode_tiles(*(jnp.asarray(a) for a in (
        gx0, gy0, gnx, masked, mlo, mhi, rank)))

    def t64(a):
        return torch.tensor(a.astype(np.int64))
    ttx, tty = binning._decode_tiles(
        t64(gx0), t64(gy0), t64(gnx), t64(masked),
        t64(mlo) & 0xFFFFFFFF, t64(mhi) & 0xFFFFFFFF, t64(rank))
    np.testing.assert_array_equal(ttx.numpy(), np.asarray(jtx))
    np.testing.assert_array_equal(tty.numpy(), np.asarray(jty))


@pytest.mark.parametrize("change", [
    dict(rowseg_buckets=2), dict(presort_depth=True),
    dict(fused_sort_key=False), dict(expand_kernel=False),
    dict(image_width=4096, image_height=1024, tile_width=8, tile_height=8)])
def test_other_binning_paths_bit_identical(change, monkeypatch):
    """Row-bucket segmented binning, the depth presort, the exact two-pass
    sort (asked for, or forced by a 512x128 tile grid that leaves 13 depth
    bits, tests/test_binning.py:233) and the gather expansion, each
    bit-identical to the JAX package. The reference bins rowseg on the
    CPU only under FORCE_EXPAND_KERNEL, with its interpreter's 256-slot
    bucket alignment (binning.py:495-496)."""
    monkeypatch.setattr(jbin, "FORCE_EXPAND_KERNEL", True)
    monkeypatch.setattr(binning, "SEG_ALIGN", 256)
    cfg = dataclasses.replace(CFG, **change)
    js = jax_splats(0, 1500, cfg)
    want = jbin.bin_splats(js, jax_config(cfg))
    got = binning.bin_splats(to_torch(js), cfg)
    assert_binned_equal(want, got)
    assert int(got.num_pairs) > 1000


@pytest.mark.parametrize("change", [
    dict(max_tiles_per_axis=33), dict(image_width=4097 * 32)])
def test_unported_options_are_rejected(change):
    """What the JAX package refuses too (binning.py:836-837)."""
    cfg = dataclasses.replace(CFG, **change)
    with pytest.raises(ValueError, match="JAX package refuses"):
        check_supported(cfg)


def test_supported_defaults_pass_the_check():
    for cfg in (RasterConfig(), dataclasses.replace(
            CFG, tile_group=3, exact_tile_test=True,
            strict_termination=False, antialias=True),
            RasterConfig(rowseg_buckets=4),
            RasterConfig(presort_depth=True),
            RasterConfig(fused_sort_key=False),
            RasterConfig(expand_kernel=False)):
        check_supported(cfg)
