"""Exposure compensation of the port (train/appearance.py) against the JAX
package's: the identity maps, the affine colour map, and one joint step
(scene parameters, exposure maps and every Adam state)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussian_splat_ipu_tpu.train import appearance as japp
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.train import appearance, trainer
from tests._torch_extras import (CFG, JTC, TC, jax_copy, jax_train_state,
                                 leaves_of, scene)
from tests.test_torch_config import jax_config

torch.set_num_threads(1)


def _mats(seed, v):
    rng = np.random.default_rng(seed)
    m = np.tile(np.eye(3, 4, dtype=np.float32), (v, 1, 1))
    return (m + rng.normal(0, 0.05, m.shape)).astype(np.float32)


def test_identity_and_apply_exposure_match_jax():
    np.testing.assert_array_equal(
        appearance.identity_mats(4, device="cpu").numpy(),
        np.asarray(japp.identity_mats(4)))
    rng = np.random.default_rng(1)
    mat = _mats(2, 1)[0]
    for c in (3, 4):
        img = rng.uniform(0, 1, (12, 10, c)).astype(np.float32)
        want = np.asarray(japp.apply_exposure(jnp.asarray(img),
                                              jnp.asarray(mat)))
        got = appearance.apply_exposure(torch.tensor(img),
                                        torch.tensor(mat)).numpy()
        assert got.shape == img.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        if c == 4:
            np.testing.assert_array_equal(got[..., 3], img[..., 3])


def test_exposure_joint_step_matches_jax():
    p, jc, tcam, target = scene()
    state = trainer.init_state(
        GaussianModel.from_numpy(p, "cpu").trainable(), TC)
    estate = appearance.init_exposure_state(3, device="cpu")
    before = _mats(3, 3)
    estate.mats.copy_(torch.tensor(before))
    je = japp.ExposureState(jax_copy(before),
                            japp.make_exposure_optimizer(1e-2).init(
                                jax_copy(before)))
    step = jax.jit(japp.joint_step, static_argnums=(5, 6, 7, 8))
    js, je, jl = step(jax_train_state(state.to_numpy()), je, jnp.int32(2),
                      jc, jnp.asarray(target), jax_config(CFG), JTC, 1e-2,
                      False)
    _, _, loss = appearance.joint_step(state, estate, torch.tensor(2), tcam,
                                       torch.tensor(target), CFG, TC, 1e-2)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = leaves_of((js, je))
    got = state.to_numpy() + estate.to_numpy()
    assert len(got) == len(want) == 26
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        name = FIELDS[i] if i < 5 else f"leaf {i}"
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    moved = np.abs(got[22] - before).max(axis=(1, 2))
    assert moved[2] > 0.0 and moved[0] == moved[1] == 0.0
