"""The composed aux step of the port (train/aux_opt.py) against the JAX
package's make_aux_step over every subset of pose, exposure and depth,
each module alone equal to its standalone joint step, and the
(TrainState, AuxState) checkpoint leaves in JAX's flatten order."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.train import aux_opt as jaux
from gaussian_splat_ipu_tpu.train import checkpoint as jcheckpoint
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.train import (appearance, aux_opt,
                                                checkpoint, pose_opt,
                                                trainer)
from tests._torch_extras import (CFG, JTC, TC, jax_copy, jax_train_state,
                                 leaves_of, scene)
from tests.test_torch_config import jax_config

torch.set_num_threads(1)

POSE_LR, EXPOSURE_LR, DEPTH_W = 5e-4, 1e-2, 0.1
SUBSETS = [s for s in itertools.product((0, 1), repeat=3) if any(s)]


def _obs():
    rng = np.random.default_rng(8)
    obs = rng.uniform([0, 0, 2.0], [64, 48, 5.0], (30, 3)).astype(np.float32)
    return obs, np.arange(30) < 24


def _aux_state(pose, expo, views=3):
    """A port AuxState with nonzero deltas and non-identity maps, and the
    reference's from copies of the same values."""
    aux = aux_opt.init_aux_state(views, POSE_LR * pose, EXPOSURE_LR * expo,
                                 device="cpu")
    rng = np.random.default_rng(4)
    if pose:
        aux.pose.deltas.copy_(torch.tensor(rng.normal(
            0, 0.01, (views, 6)).astype(np.float32)))
    if expo:
        aux.exposure.mats.add_(torch.tensor(rng.normal(
            0, 0.05, (views, 3, 4)).astype(np.float32)))
    ref = jaux.init_aux_state(views, POSE_LR * pose, EXPOSURE_LR * expo)
    treedef = jax.tree_util.tree_structure(ref)
    return aux, jax.tree_util.tree_unflatten(
        treedef, [jax_copy(x) for x in aux.to_numpy()])


@pytest.mark.parametrize("pose,expo,depth", SUBSETS)
def test_aux_step_matches_jax(pose, expo, depth):
    p, jc, tcam, target = scene()
    obs, mask = _obs()
    lrs = (POSE_LR * pose, EXPOSURE_LR * expo, DEPTH_W * depth)
    state = trainer.init_state(
        GaussianModel.from_numpy(p, "cpu").trainable(), TC)
    aux, jaux_state = _aux_state(pose, expo)
    jstep = jax.jit(jaux.make_aux_step(jax_config(CFG), JTC, *lrs,
                                       use_pallas=False))
    js, ja, jl = jstep(jax_train_state(state.to_numpy()), jaux_state,
                       jnp.int32(1), jc, jnp.asarray(target),
                       jnp.asarray(obs), jnp.asarray(mask))
    loss = aux_opt.make_aux_step(CFG, TC, *lrs)(
        state, aux, torch.tensor(1), tcam, torch.tensor(target),
        torch.tensor(obs), torch.tensor(mask))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = leaves_of((js, ja))
    got = state.to_numpy() + aux.to_numpy()
    assert len(got) == len(want) == 22 + 4 * (pose + expo)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        name = FIELDS[i] if i < 5 else f"leaf {i}"
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("module", ["pose", "exposure"])
def test_one_module_equals_its_standalone_step(module):
    p, _, tcam, target = scene()
    states, auxes = [], []
    for _ in range(2):
        states.append(trainer.init_state(
            GaussianModel.from_numpy(p, "cpu").trainable(), TC))
        auxes.append(_aux_state(module == "pose", module == "exposure")[0])
    args = (torch.tensor(2), tcam, torch.tensor(target))
    if module == "pose":
        _, _, want = pose_opt.joint_step(states[0], auxes[0].pose, *args,
                                         CFG, TC, POSE_LR)
        got = aux_opt.make_aux_step(CFG, TC, pose_lr=POSE_LR)(
            states[1], auxes[1], *args, None, None)
    else:
        _, _, want = appearance.joint_step(states[0], auxes[0].exposure,
                                           *args, CFG, TC, EXPOSURE_LR)
        got = aux_opt.make_aux_step(CFG, TC, exposure_lr=EXPOSURE_LR)(
            states[1], auxes[1], *args, None, None)
    assert torch.equal(got, want)
    for a, b in zip(states[1].to_numpy() + auxes[1].to_numpy(),
                    states[0].to_numpy() + auxes[0].to_numpy()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pose,expo", [(1, 0), (0, 1), (1, 1)])
def test_aux_checkpoint_round_trips_with_jax(pose, expo, tmp_path):
    p, _, _, _ = scene(n=20)
    state = trainer.init_state(
        GaussianModel.from_numpy(p, "cpu").trainable(), TC)
    aux, jaux_state = _aux_state(pose, expo)
    path = str(tmp_path / "aux.npz")
    checkpoint.save_checkpoint(path, (state, aux))
    template = (jax_train_state(state.to_numpy()),
                jaux.init_aux_state(3, POSE_LR * pose, EXPOSURE_LR * expo))
    back = jcheckpoint.restore_checkpoint(path, template)
    want = leaves_of((jax_train_state(state.to_numpy()), jaux_state))
    assert len(leaves_of(back)) == len(want) == 22 + 4 * (pose + expo)
    for a, b in zip(leaves_of(back), want):
        np.testing.assert_array_equal(a, b)
    fresh = aux_opt.init_aux_state(3, POSE_LR * pose, EXPOSURE_LR * expo,
                                   device="cpu")
    s2, a2 = checkpoint.restore_checkpoint(path, (trainer.init_state(
        GaussianModel.from_numpy(p, "cpu").trainable(), TC), fresh))
    for a, b in zip(s2.to_numpy() + a2.to_numpy(),
                    state.to_numpy() + aux.to_numpy()):
        np.testing.assert_array_equal(a, b)
