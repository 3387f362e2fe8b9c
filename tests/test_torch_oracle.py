"""The port's dense oracle (render/oracle.py): equal to the JAX package's
render_oracle on tests/test_oracle.py's five scenes (1e-6); the port's
tiled render (plain path) held to it on tests/test_tile_raster.py:34-45's
scenes, also with exact tiles and tile_group 3 (atol 2e-5 / rtol 1e-4);
and the model gradients of the tiled render's plain backward held to
autograd through the oracle at tests/test_backward_kernel.py:53-61's
density on a black background (atol 2e-4 / rtol 1e-3). Kernels C and D
are held to the oracle on a card by tests/test_torch_wrappers.py (marked
`cuda`) and chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.render.oracle import \
    render_oracle as j_render_oracle
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render import pipeline
from gaussian_splat_ipu_tpu_torch.render.oracle import (composite_dense,
                                                        render_oracle)
from gaussian_splat_ipu_tpu_torch.render.projection import project_gaussians
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests import test_oracle as jt
from tests.test_torch_config import jax_config

torch.set_num_threads(1)

RENDER_TOL = dict(atol=2e-5, rtol=1e-4)   # tests/test_tile_raster.py:45
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)     # tests/test_backward_kernel.py:61


def port_model(jm) -> GaussianModel:
    return GaussianModel.from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in FIELDS}, device="cpu")


def port_camera(jc) -> Camera:
    return Camera.from_numpy(np.asarray(jc.view), np.asarray(jc.proj),
                             device="cpu")


def _near_far():
    return (jt.single_gaussian((0.0, 0.0, 1.0), color=(0.0, 1.0, 0.0),
                               opacity=10.0, log_scale=-1.0),
            jt.single_gaussian((0.0, 0.0, -1.0), color=(1.0, 0.0, 0.0),
                               opacity=10.0, log_scale=-1.0))


def _oracle_scenes():
    front = jt.single_gaussian((0.0, 0.0, 1.0), color=(0.0, 0.0, 1.0),
                               opacity=30.0, log_scale=-0.5)
    back = jt.single_gaussian((0.0, 0.0, -2.0), color=(1.0, 0.0, 0.0),
                              opacity=30.0, log_scale=-0.5)
    bg_cfg = RasterConfig(image_width=32, image_height=32,
                          background=(0.2, 0.4, 0.6))
    cfg = RasterConfig(image_width=64, image_height=64)
    return {
        "peak": (jt.single_gaussian(), jt.simple_camera(), cfg),
        "depth_order": (jt.merge(*_near_far()), jt.simple_camera(), cfg),
        "saturation": (jt.merge(front, back), jt.simple_camera(), cfg),
        "background": (jt.single_gaussian(log_scale=-3.0),
                       jt.simple_camera(32, 32), bg_cfg),
        "behind_camera": (jt.single_gaussian((0.0, 0.0, 50.0)),
                          jt.simple_camera(), cfg),
    }


@pytest.mark.parametrize("name", list(_oracle_scenes()))
def test_oracle_matches_jax(name):
    jm, jc, cfg = _oracle_scenes()[name]
    want = np.asarray(j_render_oracle(jm, jc, jax_config(cfg)))
    got = render_oracle(port_model(jm), port_camera(jc), cfg).numpy()
    assert got.shape == want.shape == (cfg.image_height, cfg.image_width, 4)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if name == "depth_order":
        # The depth sort decides, not the order of the rows.
        swapped = jt.merge(*reversed(_near_far()))
        np.testing.assert_allclose(
            render_oracle(port_model(swapped), port_camera(jc), cfg).numpy(),
            got, atol=1e-6)
        assert got[32, 32, 1] > 0.9 and got[32, 32, 0] < 0.1


def test_composite_dense_takes_the_size():
    jm, jc, cfg = _oracle_scenes()["peak"]
    splats = project_gaussians(port_model(jm), port_camera(jc), cfg)
    full = composite_dense(splats, cfg)
    part = composite_dense(splats, cfg, width=40, height=24)
    assert part.shape == (24, 40, 4)
    torch.testing.assert_close(part, full[:24, :40], atol=0, rtol=0)


def _tile_raster_scene():
    """tests/test_tile_raster.py:34-45's random_scene and camera."""
    from tests.test_tile_raster import camera, random_scene
    return port_model(random_scene(200)), port_camera(camera(128, 96))


@pytest.mark.parametrize("tile,exact,group", [
    ((32, 32), False, 1), ((16, 64), False, 1), ((32, 32), True, 3)],
    ids=["32x32", "16x64", "exact-group3"])
def test_tiled_render_matches_the_oracle(tile, exact, group):
    th, tw = tile
    cfg = RasterConfig(image_width=128, image_height=96, tile_width=tw,
                       tile_height=th, chunk_size=32, pair_capacity=8192,
                       max_chunks_per_tile=16, exact_tile_test=exact,
                       tile_group=group)
    model, cam = _tile_raster_scene()
    ref = render_oracle(model, cam, cfg)
    out = pipeline.render(model, cam, cfg)
    assert int(out.overflow) == 0 and int(out.truncated) == 0
    np.testing.assert_allclose(out.image.numpy(), ref.numpy(), **RENDER_TOL)


def _grad_scene(seed):
    """tests/test_backward_kernel.py:29-37's scene and camera (192
    gaussians at 64x64), with numpy-seeded pixel weights."""
    jm = JModel.random(jax.random.PRNGKey(seed), 192)
    cam = Camera.orbit(np.array([-1.0, -1.0, -1.0], np.float32),
                       np.array([1.0, 1.0, 1.0], np.float32),
                       fov_radians=float(np.radians(40.0)), aspect=1.0,
                       device="cpu")
    w = np.random.default_rng(100 + seed).normal(size=(64, 64, 4))
    return port_model(jm), cam, torch.tensor(w, dtype=torch.float32)


GRAD_CFG = RasterConfig(image_width=64, image_height=64,
                        pair_capacity=1 << 12, max_chunks_per_tile=4)


def model_grads(model, camera, cfg, weights, render_fn):
    """d sum(render * weights) / d each model field."""
    m = model.trainable()
    loss = torch.sum(render_fn(m, camera, cfg) * weights)
    return dict(zip(FIELDS, torch.autograd.grad(loss, tuple(m.parameters()))))


def _tiled(m, cam, cfg):
    return pipeline.render(m, cam, cfg).image


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_backward_matches_oracle_autograd(seed):
    model, cam, w = _grad_scene(seed)
    got = model_grads(model, cam, GRAD_CFG, w, _tiled)
    want = model_grads(model, cam, GRAD_CFG, w, render_oracle)
    for k in FIELDS:
        assert float(want[k].abs().max()) > 0.0, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD_TOL)
