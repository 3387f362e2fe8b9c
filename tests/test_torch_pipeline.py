"""The whole forward slice: the torch port's render / render_depth against
the JAX package's render(use_pallas=False) on identical weights and
cameras."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.render import pipeline as jpipe
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render import pipeline
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests.test_torch_config import jax_config

torch.set_num_threads(1)

CFG = RasterConfig(image_width=160, image_height=96, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 14,
                   max_chunks_per_tile=16)


def scene(seed, n, sh_degree=0):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    params = dict(
        means=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        log_scales=rng.uniform(-4.5, -2.5, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(-2, 4, n).astype(np.float32),
        sh=rng.uniform(-1, 1, (n, k, 3)).astype(np.float32))
    jm = JModel(**{k: jnp.asarray(v) for k, v in params.items()})
    bb = np.ones(3, np.float32)
    jc = JCamera.orbit(-bb, bb, np.radians(40.0), 160 / 96, rot_y_deg=40.0)
    return (jm, jc, GaussianModel.from_numpy(params, device="cpu"),
            Camera.from_numpy(np.asarray(jc.view), np.asarray(jc.proj),
                              device="cpu"))


@pytest.mark.parametrize("tile_group,exact,sh_degree", [
    (1, False, 0), (3, True, 0), (1, True, 3)])
def test_render_matches_jax(tile_group, exact, sh_degree):
    cfg = dataclasses.replace(CFG, tile_group=tile_group,
                              exact_tile_test=exact)
    jm, jc, tm, tc = scene(0, 2000, sh_degree)
    want = jpipe.render(jm, jc, jax_config(cfg), use_pallas=False)
    got = pipeline.render(tm, tc, cfg)
    assert got.image.shape == (96, 160, 4)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=3e-5, rtol=1e-4)
    assert int(got.num_pairs) == int(want.num_pairs) > 0
    np.testing.assert_array_equal(got.visible.numpy(),
                                  np.asarray(want.visible))
    np.testing.assert_array_equal(got.tile_counts.numpy(),
                                  np.asarray(want.tile_counts))
    assert int(got.overflow) == int(want.overflow) == 0
    assert int(got.truncated) == int(want.truncated)


# The settings the projection branches on (queue 3 of ROADMAP.md), end to
# end: the footprint bound in sigmas (0.0 = the full alpha_min radius),
# the SH band cap (0, 1, and the model's degree 3), raw opacities.
SETTINGS = [dict(extent_sigma=0.0), dict(extent_sigma=2.0),
            dict(active_sh_degree=0), dict(active_sh_degree=1),
            dict(active_sh_degree=3), dict(sigmoid_opacity=False)]


@pytest.mark.parametrize("change", SETTINGS,
                         ids=lambda c: ",".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_render_settings_match_jax(change):
    cfg = dataclasses.replace(CFG, **change)
    jm, jc, tm, tc = scene(4, 1500, sh_degree=3)
    if not cfg.sigmoid_opacity:   # raw opacities: activated values
        opac = np.random.default_rng(5).uniform(0.0, 1.0, 1500).astype(
            np.float32)
        jm = JModel(jm.means, jm.log_scales, jm.quats, jnp.asarray(opac),
                    jm.sh)
        tm = GaussianModel.from_numpy({**tm.to_numpy(), "opacities": opac},
                                      device="cpu")
    want = jpipe.render(jm, jc, jax_config(cfg), use_pallas=False)
    got = pipeline.render(tm, tc, cfg)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=3e-5, rtol=1e-4)
    assert int(got.num_pairs) == int(want.num_pairs) > 0
    np.testing.assert_array_equal(got.visible.numpy(),
                                  np.asarray(want.visible))
    np.testing.assert_array_equal(got.tile_counts.numpy(),
                                  np.asarray(want.tile_counts))
    assert int(got.overflow) == int(want.overflow) == 0


def test_truncated_telemetry_deduped_per_group():
    cfg = dataclasses.replace(CFG, tile_group=2, max_chunks_per_tile=1)
    jm, jc, tm, tc = scene(1, 2000)
    want = jpipe.render(jm, jc, jax_config(cfg), use_pallas=False)
    got = pipeline.render(tm, tc, cfg)
    assert int(got.truncated) == int(want.truncated) > 0
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=3e-5, rtol=1e-4)


def test_render_depth_matches_jax():
    cfg = dataclasses.replace(CFG, background=(0.2, 0.2, 0.2))
    jm, jc, tm, tc = scene(2, 1500)
    want = jpipe.render_depth(jm, jc, jax_config(cfg), use_pallas=False)
    got = pipeline.render_depth(tm, tc, cfg)
    for name, a, b in zip(("mean", "var", "alpha"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    assert float(got[2].max()) > 0.5


def test_render_image_is_render_image_field():
    _, _, tm, tc = scene(3, 300)
    torch.testing.assert_close(pipeline.render_image(tm, tc, CFG),
                               pipeline.render(tm, tc, CFG).image)
