"""Rasterizer parity: the port's plain rasterizer (the CPU spec of the CUDA
kernel) against the JAX jnp spec and the JAX Pallas kernel in interpret
mode, strict and relaxed, on the same BinnedSplats."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.render import binning as jbin
from gaussian_splat_ipu_tpu.render import tile_raster as jraster
from gaussian_splat_ipu_tpu.render.kernels import rasterize as jkernel
from gaussian_splat_ipu_tpu.render.projection import (
    project_gaussians as j_project)
from gaussian_splat_ipu_tpu.utils.config import RasterConfig
from gaussian_splat_ipu_tpu_torch.render import binning
from gaussian_splat_ipu_tpu_torch.render.kernels import rasterize
from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
    rasterize_tiles_torch)

torch.set_num_threads(1)

CFG = RasterConfig(image_width=160, image_height=96, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 14,
                   max_chunks_per_tile=16)
# Tiny grid for the Pallas interpreter: 2 tiles of 16x16.
TINY = RasterConfig(image_width=32, image_height=16, tile_width=16,
                    tile_height=16, chunk_size=16, pair_capacity=1024,
                    max_chunks_per_tile=16)


def jax_binned(seed, n, cfg, opacity_shift=0.0, scale_shift=0.0, z=0.0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3))
    means[:, 2] += z
    model = JModel(
        means=jnp.asarray(means, jnp.float32),
        log_scales=jnp.asarray(rng.uniform(-4.5, -2.5, (n, 3))
                               + scale_shift, jnp.float32),
        quats=jnp.asarray(rng.normal(size=(n, 4)), jnp.float32),
        opacities=jnp.asarray(rng.uniform(-2, 4, n) + opacity_shift,
                              jnp.float32),
        sh=jnp.asarray(rng.uniform(-1, 1, (n, 1, 3)), jnp.float32))
    bb = np.ones(3, np.float32)
    cam = JCamera.orbit(-bb, bb, np.radians(40.0),
                        cfg.image_width / cfg.image_height, rot_y_deg=20.0)
    return jbin.bin_splats(j_project(model, cam, cfg), cfg)


def to_torch(binned):
    return binning.BinnedSplats(*(torch.tensor(np.asarray(x))
                                  for x in binned))


@pytest.mark.parametrize("tile_group", [1, 3])
def test_strict_plain_matches_jnp_spec(tile_group):
    cfg = dataclasses.replace(CFG, tile_group=tile_group,
                              background=(0.1, 0.2, 0.3))
    jb = jax_binned(0, 1500, cfg)
    want = np.asarray(jraster.rasterize_tiles_jnp(jb, cfg))
    got = rasterize.rasterize_tiles(to_torch(jb), cfg).numpy()
    assert got.shape == (cfg.num_tiles, cfg.pixels_per_tile, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert want[..., 3].max() > 0.5


def test_truncated_ranges_match_jnp_spec():
    """max_chunks_per_tile = 1: every range longer than one chunk is cut,
    identically in both."""
    cfg = dataclasses.replace(CFG, max_chunks_per_tile=1)
    jb = jax_binned(1, 1500, cfg)
    counts = np.asarray(jb.tile_ends - jb.tile_starts)
    assert (counts > cfg.chunk_size).any()
    want = np.asarray(jraster.rasterize_tiles_jnp(jb, cfg))
    got = rasterize_tiles_torch(to_torch(jb), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_empty_scene_is_background():
    cfg = dataclasses.replace(CFG, background=(0.1, 0.2, 0.3))
    jb = jax_binned(2, 50, cfg, z=-100.0)   # all behind the camera
    assert int(jb.num_pairs) == 0
    got = rasterize_tiles_torch(to_torch(jb), cfg).numpy()
    np.testing.assert_allclose(got[..., :3], np.broadcast_to(
        [0.1, 0.2, 0.3], got[..., :3].shape), atol=1e-7)
    np.testing.assert_array_equal(got[..., 3], 0.0)
    np.testing.assert_allclose(
        got, np.asarray(jraster.rasterize_tiles_jnp(jb, cfg)), atol=1e-7)


def test_strict_plain_matches_pallas_interpret():
    jb = jax_binned(3, 60, TINY)
    want = np.asarray(jkernel.rasterize_tiles(jb, TINY, interpret=True))
    got = rasterize_tiles_torch(to_torch(jb), TINY).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_relaxed_plain_matches_pallas_interpret_and_bounds():
    """Dense, opaque scene so termination engages. The relaxed plain
    rasterizer matches the reference's relaxed kernel (its only JAX
    home); its colour equals the strict colour and its alpha exceeds the
    strict alpha by at most eps / (1 - alpha_clamp)
    (tests/test_pallas_rasterize.py:88-104)."""
    strict_cfg = TINY
    relaxed_cfg = dataclasses.replace(TINY, strict_termination=False)
    jb = jax_binned(4, 200, TINY, opacity_shift=4.0, scale_shift=0.8)
    tb = to_torch(jb)
    want = np.asarray(jkernel.rasterize_tiles(jb, relaxed_cfg,
                                              interpret=True))
    fast = rasterize_tiles_torch(tb, relaxed_cfg).numpy()
    np.testing.assert_allclose(fast, want, atol=1e-5)
    strict = rasterize_tiles_torch(tb, strict_cfg).numpy()
    assert (strict[..., 3] > 0.99).any()
    np.testing.assert_allclose(fast[..., :3], strict[..., :3], atol=1e-6)
    da = fast[..., 3] - strict[..., 3]
    assert da.min() >= -1e-6
    assert da.max() <= TINY.transmittance_eps / (1 - TINY.alpha_clamp) + 1e-6
    assert da.max() > 0.0    # the relaxed alpha did decay past the strict


def test_wrapper_on_cpu_is_the_plain_version():
    cfg = dataclasses.replace(CFG, strict_termination=False)
    tb = to_torch(jax_binned(5, 300, cfg))
    a = rasterize.rasterize_tiles(tb, cfg)
    b = rasterize_tiles_torch(tb, cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("need_aux", [False, True])
def test_plain_windows_past_the_table_end(need_aux):
    """A table full to its last slot: tile 0 holds all P = 64 pairs (two
    chunks), tile 1 is empty and starts at P, so its chunk-1 window lies
    past the one zero chunk the plain version appends (row-bucket tables
    put empty tiles there too). The result equals the same table with
    room to spare."""
    rng = np.random.default_rng(7)
    p = 64
    feats = np.zeros((16, p), np.float32)
    feats[0] = rng.uniform(0, 16, p)
    feats[1] = rng.uniform(0, 16, p)
    feats[2] = feats[4] = 0.05
    feats[5:8] = rng.uniform(0, 1, (3, p))
    feats[8] = 0.3
    feats[9] = np.sort(rng.uniform(1, 2, p))
    tight = binning.BinnedSplats(
        torch.tensor(feats), torch.zeros(p, dtype=torch.int32),
        torch.tensor([0, p], dtype=torch.int32),
        torch.tensor([p, p], dtype=torch.int32),
        torch.tensor(p, dtype=torch.int32), torch.tensor(0, dtype=torch.int32))
    roomy = tight._replace(features=torch.cat(
        [tight.features, torch.zeros((16, 4 * TINY.chunk_size))], dim=1))
    got = rasterize_tiles_torch(tight, TINY, need_aux=need_aux)
    want = rasterize_tiles_torch(roomy, TINY, need_aux=need_aux)
    for a, b in zip(*((got, want) if need_aux else ((got,), (want,)))):
        assert torch.equal(a, b)
    assert float(want[0][0, :, 3].max() if need_aux
                 else want[0, :, 3].max()) > 0.5
