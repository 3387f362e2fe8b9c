"""Sparse-depth supervision of the port (train/depth.py) against the JAX
package's: packing equal, the loss and its gradients (rtol 1e-4), one
depth train step, and the packed rows picked by a view-index tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussian_splat_ipu_tpu.train import depth as jdepth
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.train import depth, trainer
from tests._torch_extras import (CFG, JTC, TC, jax_train_state, leaves_of,
                                 scene)
from tests.test_torch_config import jax_config
from tests.test_torch_train import jmodel

torch.set_num_threads(1)


def _observations(seed, n):
    rng = np.random.default_rng(seed)
    return rng.uniform([-2, -2, 1.5], [66, 50, 5.0], (n, 3)).astype(
        np.float32)


def test_pack_observations_equal_the_reference():
    per_view = [_observations(0, 7), _observations(1, 0),
                _observations(2, 13), _observations(3, 5)]
    for cap in (4096, 9):
        jo, jm = jdepth.pack_observations(per_view, max_per_view=cap)
        obs, mask = depth.pack_observations(per_view, max_per_view=cap,
                                            device="cpu")
        assert obs.dtype == torch.float32 and mask.dtype == torch.bool
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    o, m = (trainer.select_row(x, torch.tensor(2)) for x in (obs, mask))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo)[2])
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm)[2])


def test_sparse_depth_loss_and_gradients_match_jax():
    p, jc, tcam, _ = scene()
    obs = _observations(4, 60)
    mask = np.arange(60) < 50
    jcfg = jax_config(CFG)

    def jloss(params):
        return jdepth.sparse_depth_loss(params, jc, jnp.asarray(obs),
                                        jnp.asarray(mask), jcfg,
                                        use_pallas=False)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jmodel(p))
    model = GaussianModel.from_numpy(p, "cpu").trainable()
    loss = depth.sparse_depth_loss(model, tcam, torch.tensor(obs),
                                   torch.tensor(mask), CFG)
    # The depth pass replaces the colours: sh gets no gradient.
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        model.parameters(), torch.autograd.grad(
            loss, tuple(model.parameters()), allow_unused=True))]
    assert float(want) > 0.0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    for k, g, jg in zip(FIELDS, grads, leaves_of(jgrads)):
        scale = np.abs(jg).max()
        assert scale > 0.0 or k == "sh", k
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


def test_depth_train_step_matches_jax():
    p, jc, tcam, target = scene()
    obs, mask = _observations(5, 40), np.arange(40) < 30
    jstep = jdepth.make_depth_train_step(jax_config(CFG), JTC, 0.1,
                                         use_pallas=False)
    state = trainer.init_state(
        GaussianModel.from_numpy(p, "cpu").trainable(), TC)
    js, jl = jstep(jax_train_state(state.to_numpy()), jc,
                   jnp.asarray(target), jnp.asarray(obs), jnp.asarray(mask))
    step = depth.make_depth_train_step(CFG, TC, 0.1)
    _, loss = step(state, tcam, torch.tensor(target), torch.tensor(obs),
                   torch.tensor(mask))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = leaves_of(js)
    got = state.to_numpy()
    for i in range(5):
        np.testing.assert_allclose(got[i], want[i], atol=1e-5,
                                   err_msg=FIELDS[i])
    for i in range(5, 22):
        scale = np.abs(want[i]).max() if want[i].size else 0.0
        np.testing.assert_allclose(got[i], want[i], rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=f"leaf {i}")
