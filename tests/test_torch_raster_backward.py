"""The port's plain backward rasterizer (the CPU spec of kernel D) and its
strict aux forward against the JAX package: jax.grad of the jnp spec, the
Pallas backward and aux forward in interpret mode, and central
differences; and the autograd.Function around them on CPU tensors."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.render import tile_raster as jraster
from gaussian_splat_ipu_tpu.render.kernels import rasterize as jkernel
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib, rasterize
from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
    rasterize_backward_torch, rasterize_tiles_torch)
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests.test_backward_kernel import _binned as ref_binned
from tests.test_torch_config import jax_config
from tests.test_torch_rasterize import CFG, TINY, jax_binned, to_torch

torch.set_num_threads(1)


def cotangent(cfg, seed):
    shape = (cfg.num_tiles, cfg.pixels_per_tile, 4)
    if seed is None:
        return np.ones(shape, np.float32)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def jax_grad(jb, cfg, cot, pallas=False):
    def f(features):
        b = jb._replace(features=features)
        jcfg = jax_config(cfg)
        tiles = (jkernel.rasterize_tiles(b, jcfg, interpret=True) if pallas
                 else jraster.rasterize_tiles_jnp(b, jcfg))
        return jnp.sum(tiles * cot)
    return np.asarray(jax.grad(f)(jb.features))


def port_grad(tb, cfg, cot):
    tiles, nc = rasterize_tiles_torch(tb, cfg, need_aux=True)
    return rasterize_backward_torch(
        tb.features, tb.tile_starts, tb.tile_ends, torch.tensor(cot),
        1.0 - tiles[..., 3], nc, cfg).numpy()


@pytest.mark.parametrize("tile_group,opacity_shift,cot_seed", [
    (1, 0.0, 1), (3, 0.0, 2),
    # Opaque splats: the T < eps break engages; a ones cotangent, as the
    # reference's test_matches_with_early_termination.
    (1, 6.0, None)])
def test_plain_backward_matches_jnp_spec_grad(tile_group, opacity_shift,
                                              cot_seed):
    cfg = dataclasses.replace(CFG, tile_group=tile_group)
    jb = jax_binned(0, 1500, cfg, opacity_shift=opacity_shift)
    tb = to_torch(jb)
    cot = cotangent(cfg, cot_seed)
    want = jax_grad(jb, cfg, cot)
    got = port_grad(tb, cfg, cot)
    assert got.shape == (16, cfg.pair_capacity)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(got[9:], 0.0)
    assert np.abs(want).max() > 1.0
    if opacity_shift:
        _, nc = rasterize_tiles_torch(tb, cfg, need_aux=True)
        full = (tb.tile_ends - tb.tile_starts).to(torch.float32)[:, None]
        assert bool((nc < full).any())   # some pixels did break


def test_truncated_ranges_and_empty_scene_match_jnp_spec_grad():
    """max_chunks_per_tile = 1 cuts every longer range at one chunk, and
    the cut pairs get no gradient, as in the spec; a scene with no pair
    has an all-zero gradient."""
    cfg = dataclasses.replace(CFG, max_chunks_per_tile=1)
    jb = jax_binned(1, 1500, cfg)
    assert (np.asarray(jb.tile_ends - jb.tile_starts)
            > cfg.chunk_size).any()
    cot = cotangent(cfg, 4)
    np.testing.assert_allclose(port_grad(to_torch(jb), cfg, cot),
                               jax_grad(jb, cfg, cot), atol=2e-4, rtol=1e-3)
    jb = jax_binned(2, 50, CFG, z=-100.0)   # all behind the camera
    assert int(jb.num_pairs) == 0
    got = port_grad(to_torch(jb), CFG, cotangent(CFG, 5))
    np.testing.assert_array_equal(got, 0.0)


def test_background_and_alpha_cotangent_match_reference():
    """A nonzero background routes dL/dT through the colour and the alpha
    channel; the cotangent is random in all four channels. On the
    reference's own scene for this case (test_backward_kernel.py:103-117)
    against the jnp spec; on a dense 1500-splat scene against the
    reference's Pallas backward, whose division-based T recovery the port
    shares (there both differ from the spec's cumprod by up to 1.6x the
    bar at a few of 262,144 entries)."""
    cfg = RasterConfig(image_width=64, image_height=64,
                       pair_capacity=1 << 12, max_chunks_per_tile=4,
                       background=(0.2, 0.5, 0.9))
    jb = ref_binned(seed=2, cfg=jax_config(cfg))
    cot = np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (cfg.num_tiles, cfg.pixels_per_tile, 4),
        jnp.float32))
    np.testing.assert_allclose(port_grad(to_torch(jb), cfg, cot),
                               jax_grad(jb, cfg, cot), atol=2e-4, rtol=1e-3)

    cfg = dataclasses.replace(CFG, background=(0.2, 0.5, 0.9))
    jb = jax_binned(2, 1500, cfg)
    cot = cotangent(cfg, 7)
    np.testing.assert_allclose(port_grad(to_torch(jb), cfg, cot),
                               jax_grad(jb, cfg, cot, pallas=True),
                               atol=2e-4, rtol=1e-3)


def test_plain_backward_matches_pallas_interpret():
    jb = jax_binned(3, 60, TINY)
    cot = cotangent(TINY, 3)
    want = jax_grad(jb, TINY, cot, pallas=True)
    np.testing.assert_allclose(port_grad(to_torch(jb), TINY, cot), want,
                               atol=2e-4, rtol=1e-3)
    assert np.abs(want).max() > 0.1


def test_aux_forward_matches_pallas_aux_interpret():
    """nc exactly, t_n = 1 - alpha to 1e-6, against the reference kernel's
    need_aux=True output, on an opaque scene where pixels break."""
    jb = jax_binned(4, 200, TINY, opacity_shift=4.0, scale_shift=0.8)
    tiles_j, nc_j = jkernel._pallas_forward(
        jb.features, jb.tile_starts, jb.tile_ends,
        jnp.zeros((1,), jnp.int32), jax_config(TINY), interpret=True)
    tiles, nc = rasterize_tiles_torch(to_torch(jb), TINY, need_aux=True)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(nc_j)[:, 0])
    np.testing.assert_allclose(1.0 - tiles[..., 3].numpy(),
                               1.0 - np.asarray(tiles_j)[:, 3], atol=1e-6)
    full = np.asarray(jb.tile_ends - jb.tile_starts)[:, None]
    assert (nc.numpy() < full).any() and (nc.numpy() == full).any()


def test_tile_group_multichunk_ranges_match_spec():
    """Port of the reference's round-5 regression test: with tile_group > 1
    every member tile replays the SAME group range, and a range longer
    than one chunk must keep every member's interior-chunk gradients."""
    cfg = dataclasses.replace(CFG, tile_group=2)
    jb = jax_binned(4, 1500, cfg)
    counts = np.asarray(jb.tile_ends - jb.tile_starts)
    assert counts.max() > 4 * cfg.chunk_size
    cot = cotangent(cfg, 11)
    np.testing.assert_allclose(port_grad(to_torch(jb), cfg, cot),
                               jax_grad(jb, cfg, cot), atol=5e-4, rtol=2e-3)


def test_colour_rows_match_central_differences():
    """The output is linear in the colour rows, so central differences are
    exact there (the reference's test_finite_difference)."""
    jb = jax_binned(6, 300, CFG)
    tb = to_torch(jb)
    cot = torch.full((CFG.num_tiles, CFG.pixels_per_tile, 4), 0.5)

    def f(features):
        return float(torch.sum(rasterize_tiles_torch(
            tb._replace(features=features), CFG) * cot).double())

    g = port_grad(tb, CFG, cot.numpy())
    v = torch.zeros_like(tb.features)
    v[5:8] = torch.tensor(np.random.default_rng(8).normal(
        size=(3, v.shape[1])).astype(np.float32))
    eps = 1e-2
    fd = (f(tb.features + eps * v) - f(tb.features - eps * v)) / (2 * eps)
    an = float(np.vdot(g.astype(np.float64), v.numpy().astype(np.float64)))
    assert abs(an) > 1.0
    assert fd == pytest.approx(an, rel=1e-3, abs=1e-3)


@pytest.mark.parametrize("strict", [True, False])
def test_autograd_function_on_cpu_is_the_plain_pair(strict):
    """Differentiated, rasterize_tiles runs the strict aux forward whatever
    cfg says, and its backward is the plain backward; CPU tensors launch
    nothing."""
    cfg = dataclasses.replace(CFG, strict_termination=strict)
    tb = to_torch(jax_binned(5, 600, cfg, opacity_shift=2.0))
    cuda_lib.launches.clear()
    feats = tb.features.clone().requires_grad_()
    tiles = rasterize.rasterize_tiles(tb._replace(features=feats), cfg)
    want, nc = rasterize_tiles_torch(tb, cfg, need_aux=True)
    assert torch.equal(tiles.detach(), want)
    cot = torch.tensor(cotangent(cfg, 9))
    tiles.backward(cot)
    assert torch.equal(feats.grad, rasterize_backward_torch(
        tb.features, tb.tile_starts, tb.tile_ends, cot, 1.0 - want[..., 3],
        nc, cfg))
    assert torch.equal(rasterize.rasterize_tiles_aux(tb, cfg)[1], nc)
    assert sum(cuda_lib.launches.values()) == 0
