"""Projection parity: the torch port against the JAX package on identical
numpy inputs (cameras, transforms, ops and project_gaussians)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.render.projection import (
    project_gaussians as j_project)
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.projection import project_gaussians
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests.test_torch_config import jax_config

torch.set_num_threads(1)

CFG = RasterConfig(image_width=160, image_height=96, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 14)
BB = np.ones(3, np.float32)


def scene_params(seed, n, sh_degree):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    return dict(
        means=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        log_scales=rng.uniform(-4.5, -2.5, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(-2, 4, n).astype(np.float32),
        sh=rng.uniform(-1, 1, (n, k, 3)).astype(np.float32))


def both_models(params):
    return (JModel(**{k: jnp.asarray(v) for k, v in params.items()}),
            GaussianModel.from_numpy(params, device="cpu"))


@pytest.mark.parametrize("sh_degree,antialias,env_rot", [
    (0, False, None), (3, False, (0.3, -0.7)), (3, True, None)])
def test_projected_splats_match_jax(sh_degree, antialias, env_rot):
    import dataclasses
    cfg = dataclasses.replace(CFG, antialias=antialias)
    jm, tm = both_models(scene_params(1, 800, sh_degree))
    jc = JCamera.orbit(-BB, BB, np.radians(40.0), 160 / 96, rot_y_deg=30.0,
                       env_rot=env_rot)
    tc = Camera.from_numpy(np.asarray(jc.view), np.asarray(jc.proj),
                           np.asarray(jc.env_rot), device="cpu")
    want = j_project(jm, jc, jax_config(cfg))
    got = project_gaussians(tm, tc, cfg)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    vis_j = np.asarray(want.radius[:, 0] > 0)
    np.testing.assert_array_equal(got.radius[:, 0].numpy() > 0, vis_j)
    assert 0 < vis_j.sum() < len(vis_j)   # some culled, some kept


# The settings the projection branches on: the footprint bound in sigmas
# (0.0 = the full alpha_min radius), the SH band cap (0, 1, and the
# model's degree 3) and raw opacities (no sigmoid).
SETTINGS = [dict(extent_sigma=0.0), dict(extent_sigma=2.0),
            dict(active_sh_degree=0), dict(active_sh_degree=1),
            dict(active_sh_degree=3), dict(sigmoid_opacity=False)]


@pytest.mark.parametrize("change", SETTINGS,
                         ids=lambda c: ",".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_projection_settings_match_jax(change):
    cfg = dataclasses.replace(CFG, **change)
    params = scene_params(4, 800, 3)
    if not cfg.sigmoid_opacity:   # raw opacities: activated values
        params["opacities"] = np.random.default_rng(5).uniform(
            0.0, 1.0, 800).astype(np.float32)
    jm, tm = both_models(params)
    jc = JCamera.orbit(-BB, BB, np.radians(40.0), 160 / 96, rot_y_deg=-50.0,
                       env_rot=(0.2, 0.4))
    tc = Camera.from_numpy(np.asarray(jc.view), np.asarray(jc.proj),
                           np.asarray(jc.env_rot), device="cpu")
    want = j_project(jm, jc, jax_config(cfg))
    got = project_gaussians(tm, tc, cfg)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    vis_j = np.asarray(want.radius[:, 0] > 0)
    np.testing.assert_array_equal(got.radius[:, 0].numpy() > 0, vis_j)
    assert 0 < vis_j.sum() < len(vis_j)
    # Each setting changes what the default computes.
    base = project_gaussians(tm, tc, CFG)
    assert any(not torch.equal(getattr(got, f), getattr(base, f))
               for f in got._fields) != (change == dict(active_sh_degree=3))


def test_xy_probe_shifts_screen_position():
    _, tm = both_models(scene_params(2, 64, 0))
    tc = Camera.orbit(-BB, BB, np.radians(40.0), 160 / 96, device="cpu")
    probe = torch.full((64, 2), 0.25)
    base = project_gaussians(tm, tc, CFG)
    shifted = project_gaussians(tm, tc, CFG, xy_probe=probe)
    torch.testing.assert_close(shifted.xy, base.xy + 0.25)


@pytest.mark.parametrize("ctor", ["orbit", "look_at", "from_intrinsics"])
def test_camera_constructors_match_jax(ctor):
    if ctor == "orbit":
        args = (-BB, 2 * BB, np.radians(50.0), 16 / 9)
        kw = dict(rot_x_deg=10.0, rot_y_deg=-35.0, translation=(0.1, 0, .2))
    elif ctor == "look_at":
        args = ([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                np.radians(50.0), 4 / 3)
        kw = {}
    else:
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, 3] = [0.2, -0.1, 3.0]
        args = (300.0, 310.0, 80.0, 50.0, 160, 96, w2c)
        kw = {}
    jc = getattr(JCamera, ctor)(*args, **kw)
    tc = getattr(Camera, ctor)(*args, **kw, device="cpu")
    np.testing.assert_allclose(tc.view.numpy(), np.asarray(jc.view),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tc.proj.numpy(), np.asarray(jc.proj),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tc.cam_origin.numpy(),
                               np.asarray(jc.cam_origin), atol=1e-4,
                               rtol=1e-5)
    for a, b in zip(tc.focals(160, 96), jc.focals(160, 96)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_model_helpers():
    params = scene_params(3, 10, 1)
    jm, tm = both_models(params)
    assert tm.num_gaussians == 10 and tm.sh_degree == 1
    for k, v in tm.pad_to(16).to_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm.pad_to(16),
                                                            k)))
    for deg in (0, 3):
        np.testing.assert_array_equal(tm.with_sh_degree(deg).sh.numpy(),
                                      np.asarray(jm.with_sh_degree(deg).sh))
    g = torch.Generator().manual_seed(0)
    rnd = GaussianModel.random(5000, generator=g, device="cpu", sh_degree=2,
                               extent=2.0)
    assert rnd.sh.shape == (5000, 9, 3)
    assert float(rnd.means.abs().max()) <= 2.0
    assert -2.0 <= float(rnd.opacities.min()) < float(
        rnd.opacities.max()) <= 4.0
    np.testing.assert_allclose(float(rnd.log_scales.min()),
                               -5.5 + np.log(2.0), atol=0.01)
