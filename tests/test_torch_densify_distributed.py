"""Density control on the port's sharded trainer against the JAX package's
on its 8-device CPU mesh (tests/test_densify_distributed.py's layout):
the sharded densify step's statistics and update, an event on the sharded
state (fed the reference's own split noise, as tests/test_torch_densify.py
does) and the sharded slot-buffer growth, its refusal of capacities that
do not split over the mesh included. Bars: the step's loss rtol 1e-5, the
visibility counts equal, the screen gradients rtol 1e-4 (the reference's
own bar between its sharded and single-device steps), parameters atol
1e-5; the growth bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.parallel import distributed as jdist
from gaussian_splat_ipu_tpu.parallel import mesh as jmesh
from gaussian_splat_ipu_tpu.train import densify as jdensify
from gaussian_splat_ipu_tpu.train import trainer as jtrainer
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.parallel import distributed, mesh
from gaussian_splat_ipu_tpu_torch.train import densify, trainer
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests._torch_extras import jax_train_state, leaves_of
from tests.test_torch_config import jax_config
from tests.test_torch_densify import jax_dstate
from tests.test_torch_train import params_np

torch.set_num_threads(1)

# 2x8 tiles of 32 px: one tile row per shard of 8.
CFG = RasterConfig(image_width=64, image_height=256, pair_capacity=1 << 12,
                   max_chunks_per_tile=4)
TC = trainer.TrainConfig(ssim_weight=0.0)
JTC = jtrainer.TrainConfig(ssim_weight=0.0)


def setup(capacity=64, n_alive=48):
    """A port state on the 8-shard CPU mesh, its density statistics, the
    JAX copies, both cameras and a target."""
    p = params_np(0, n_alive, log_scale=(-3.0, -2.0))
    state = trainer.init_state(densify.pad_model(
        GaussianModel.from_numpy(p, "cpu"), capacity).trainable(), TC)
    d = densify.init_state(n_alive, capacity, np.array([0, 1], np.uint32),
                           device="cpu")
    bb = np.ones(3, np.float32)
    jc = JCamera.orbit(-bb, bb, fov_radians=np.radians(45.0), aspect=0.25)
    tc = Camera.from_numpy(np.asarray(jc.view), np.asarray(jc.proj),
                           device="cpu")
    target = np.random.default_rng(1).uniform(
        0, 1, (256, 64, 4)).astype(np.float32)
    return state, d, jc, tc, target


def jax_sharded(state, d, jmsh):
    js = jax_train_state(state.to_numpy())
    js = jtrainer.TrainState(jmesh.shard_model(js.params, jmsh),
                             js.opt_state, js.step)
    return js, jax_dstate(d)


def test_sharded_densify_step_matches_jax():
    state, d, jc, tc, target = setup()
    jmsh, tmsh = jmesh.make_mesh(8), mesh.make_mesh(8, device="cpu")
    js, jd = jax_sharded(state, d, jmsh)
    jstep = jdist.make_sharded_densify_train_step(
        jmsh, jax_config(CFG), JTC, use_pallas=False, pair_capacity=1 << 12)
    step = distributed.make_sharded_densify_train_step(
        tmsh, CFG, TC, pair_capacity=1 << 12)
    for _ in range(2):
        js, jd, jl = jstep(js, jd, jc, jnp.asarray(target))
        loss = step(state, d.grad_sum, d.vis_count, tc, torch.tensor(target))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(d.vis_count.numpy(),
                                  np.asarray(jd.vis_count))
    assert int(d.vis_count.sum()) > 40
    np.testing.assert_allclose(d.grad_sum.numpy(), np.asarray(jd.grad_sum),
                               rtol=1e-4, atol=1e-7)
    # The alive slots. The reference's sharded step writes NaN into the
    # dead slots' means, log-scales and quaternions (a zero cotangent of
    # the wire's radius column through their infinite extents); the port
    # sends the radius detached (parallel/distributed.py::_pack_splats).
    for i, (a, b) in enumerate(zip(state.to_numpy()[:5], leaves_of(js)[:5])):
        np.testing.assert_allclose(a[:48], b[:48], atol=1e-5,
                                   err_msg=FIELDS[i])
        assert np.isfinite(a).all(), FIELDS[i]


def test_densify_event_on_the_sharded_state_matches_jax():
    """Three sharded steps, then the event on the whole slot buffer: the
    reference's densify_and_prune on its sharded state and the port's on
    its mesh's tensors, fed the reference's split noise, give the same
    alive mask and parameters; the sharded step runs on after it."""
    state, d, jc, tc, target = setup()
    jmsh, tmsh = jmesh.make_mesh(8), mesh.make_mesh(8, device="cpu")
    js, jd = jax_sharded(state, d, jmsh)
    jstep = jdist.make_sharded_densify_train_step(
        jmsh, jax_config(CFG), JTC, use_pallas=False, pair_capacity=1 << 12)
    step = distributed.make_sharded_densify_train_step(
        tmsh, CFG, TC, pair_capacity=1 << 12)
    for _ in range(3):
        js, jd, _ = jstep(js, jd, jc, jnp.asarray(target))
        step(state, d.grad_sum, d.vis_count, tc, torch.tensor(target))
    kw = dict(grad_threshold=1e-7, scene_extent=1.5)
    js, jd = jdensify.densify_and_prune(js, jd, jdensify.DensifyConfig(**kw))
    _, ka, kb = jax.random.split(jnp.asarray(d.key), 3)
    eps = [np.asarray(jax.random.normal(k, (64, 3), jnp.float32))
           for k in (ka, kb)]
    n_alive = int(d.alive.sum())
    densify.densify_and_prune_core(state, d, densify.DensifyConfig(**kw),
                                   *map(torch.tensor, eps))
    alive = d.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(jd.alive))
    assert int(d.alive.sum()) > n_alive
    # The alive slots (the reference's dead ones hold NaN, as above).
    for i, (a, b) in enumerate(zip(state.to_numpy()[:5], leaves_of(js)[:5])):
        np.testing.assert_allclose(a[alive], b[alive], atol=1e-5,
                                   err_msg=FIELDS[i])
    loss = step(state, d.grad_sum, d.vis_count, tc, torch.tensor(target))
    assert np.isfinite(float(loss)) and state.params.num_gaussians == 64


def test_grow_capacity_sharded_matches_jax():
    state, d, jc, tc, target = setup()
    jmsh, tmsh = jmesh.make_mesh(8), mesh.make_mesh(8, device="cpu")
    d.grad_sum.copy_(torch.arange(64.0))
    d.vis_count.copy_(torch.arange(64, dtype=torch.int32))
    js, jd = jax_sharded(state, d, jmsh)
    js, jd = jdist.grow_capacity_sharded(jmsh, js, jd, 128)
    gs, gd = distributed.grow_capacity_sharded(tmsh, state, d, 128)
    assert gs.params.means.requires_grad and gs.params.num_gaussians == 128
    want = leaves_of((js, jd))
    got = gs.to_numpy() + gd.to_numpy()
    assert len(got) == len(want) == 26
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    # Each shard's 16 slots: its 8 old ones, then 8 dead ones.
    assert gd.alive.view(8, 16)[:, 8:].sum() == 0
    # Dead slots render as nothing: the same loss at the new capacity.
    step = distributed.make_sharded_densify_train_step(tmsh, CFG, TC)
    before = step(*_copies(state, d), tc, torch.tensor(target))
    after = step(gs, gd.grad_sum, gd.vis_count, tc, torch.tensor(target))
    np.testing.assert_allclose(float(after), float(before), rtol=1e-6)
    for bad in (130, 32):
        with pytest.raises(ValueError, match="multiples of the mesh"):
            distributed.grow_capacity_sharded(tmsh, state, d, bad)
    assert distributed.grow_capacity_sharded(tmsh, state, d, 64) == (state,
                                                                     d)


def _copies(state, d):
    """(state, grad_sum, vis_count) copies: the step updates in place."""
    s = trainer.TrainState.from_numpy(state.to_numpy(), "cpu")
    return s, d.grad_sum.clone(), d.vis_count.clone()
