"""Pose refinement of the port (train/pose_opt.py) against the JAX
package's: the SE(3) exponential at zero, at 1e-5 rad and at 1 rad, its
gradient at zero (finite, equal to JAX's), the corrected camera, and one
joint step (scene parameters, deltas and every Adam state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.train import pose_opt as jpose
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.train import pose_opt, trainer
from tests._torch_extras import (CFG, JTC, TC, jax_copy, jax_train_state,
                                 leaves_of, scene)
from tests.test_torch_config import jax_config
from tests.test_torch_train import cameras

torch.set_num_threads(1)

W = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)


@pytest.mark.parametrize("theta", [0.0, 1e-5, 1.0])
def test_se3_exp_matches_jax(theta):
    axis = np.array([0.3, -0.5, 0.81], np.float32)
    axis /= np.linalg.norm(axis)
    delta = np.concatenate([theta * axis, [0.02, -0.01, 0.03]]).astype(
        np.float32)
    want = np.asarray(jpose.se3_exp(jnp.asarray(delta)))
    got = pose_opt.se3_exp(torch.tensor(delta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    r = got[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)


def test_se3_exp_gradient_at_zero_is_finite_and_matches_jax():
    want = np.asarray(jax.grad(lambda d: jnp.sum(jpose.se3_exp(d) * W))(
        jnp.zeros(6, jnp.float32)))
    d = torch.zeros(6, requires_grad=True)
    (g,) = torch.autograd.grad((pose_opt.se3_exp(d) * torch.tensor(W)).sum(),
                               (d,))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy(), want, atol=1e-6)


def test_apply_delta_matches_jax():
    jc, tcam = cameras(CFG, 40.0)
    delta = np.array([0.01, -0.02, 0.005, 0.03, 0.0, -0.01], np.float32)
    want = jpose.apply_delta(jc, jnp.asarray(delta))
    got = pose_opt.apply_delta(tcam, torch.tensor(delta))
    np.testing.assert_allclose(got.view.numpy(), np.asarray(want.view),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.proj.numpy(), np.asarray(want.proj))
    cams = pose_opt.corrected_cameras([tcam, tcam], torch.tensor(
        np.stack([delta, 0 * delta])))
    np.testing.assert_array_equal(cams[1].view.numpy(), tcam.view.numpy())


def test_pose_joint_step_matches_jax():
    p, jc, tcam, target = scene()
    state = trainer.init_state(
        GaussianModel.from_numpy(p, "cpu").trainable(), TC)
    pstate = pose_opt.init_pose_state(3, device="cpu")
    with torch.no_grad():
        pstate.deltas.copy_(torch.tensor(np.random.default_rng(1).normal(
            0, 0.01, (3, 6)).astype(np.float32)))
    before = pstate.deltas.numpy().copy()
    jp = jpose.PoseState(jax_copy(before),
                         jpose.make_pose_optimizer(5e-4).init(
                             jax_copy(before)))
    step = jax.jit(jpose.joint_step, static_argnums=(5, 6, 7, 8))
    js, jp, jl = step(jax_train_state(state.to_numpy()), jp, jnp.int32(1),
                      jc, jnp.asarray(target), jax_config(CFG), JTC, 5e-4,
                      False)
    _, _, loss = pose_opt.joint_step(state, pstate, torch.tensor(1), tcam,
                                     torch.tensor(target), CFG, TC, 5e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = leaves_of((js, jp))
    got = state.to_numpy() + pstate.to_numpy()
    assert len(got) == len(want) == 26
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        name = FIELDS[i] if i < 5 else f"leaf {i}"
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    # Only view 1's delta had a gradient; the other rows' Adam steps are 0.
    moved = np.abs(got[22] - before).max(axis=1)
    assert moved[1] > 0.0 and moved[0] == moved[2] == 0.0
