"""Density control of the port (train/densify.py) against the JAX
package's on identical states: the slot-buffer helpers equal, the densify
step's statistics, the event fed the reference's own split noise (prune,
clone, split, a full buffer, tied priorities, the moment rows), the
opacity reset, the loss-mix scale and a fit's alive counts. The reference
renders with use_pallas=False, as its own tests run on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.train import densify as jdensify
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.train import densify, trainer
from tests._torch_extras import (CFG, JTC, TC, jax_copy, jax_train_state,
                                 leaves_of, port_state, scene)
from tests.test_torch_config import jax_config
from tests.test_torch_train import jmodel, params_np

torch.set_num_threads(1)


def jax_dstate(d: densify.DensifyState):
    return jdensify.DensifyState(*(jax_copy(x) for x in d.to_numpy()))


def test_init_pad_grow_compact_equal_the_reference():
    want = leaves_of(jdensify.init_state(5, 9, jax.random.PRNGKey(0)))
    got = densify.init_state(5, 9, device="cpu").to_numpy()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    p = params_np(1, 5, sh_degree=1)
    padded = densify.pad_model(GaussianModel.from_numpy(p, "cpu"), 9)
    for k, b in zip(FIELDS, leaves_of(jdensify.pad_model(jmodel(p), 9))):
        np.testing.assert_array_equal(getattr(padded, k).numpy(), b,
                                      err_msg=k)

    state = port_state(params_np(2, 9, sh_degree=1))
    d = densify.init_state(5, 9, np.array([3, 4], np.uint32), device="cpu")
    d.grad_sum.copy_(torch.arange(9.0))
    d.vis_count.copy_(torch.arange(9, dtype=torch.int32))
    js, jd = jdensify.grow_capacity(jax_train_state(state.to_numpy()),
                                    jax_dstate(d), 14)
    gs, gd = densify.grow_capacity(state, d, 14)
    assert gs.params.means.requires_grad
    want = leaves_of((js, jd))
    got = gs.to_numpy() + gd.to_numpy()
    assert len(got) == len(want) == 26
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")

    alive = torch.tensor([True, False, True, True, False, False, True, False,
                          True])
    d = d._replace(alive=alive)
    p9 = params_np(4, 9)
    want = leaves_of(jdensify.compact(jmodel(p9), jax_dstate(d)))
    got = densify.compact(GaussianModel.from_numpy(p9, "cpu"), d)
    assert got.num_gaussians == 5
    for k, b in zip(FIELDS, want):
        np.testing.assert_array_equal(getattr(got, k).numpy(), b, err_msg=k)


@pytest.mark.parametrize("depth_weight", [0.0, 0.1])
def test_densify_step_statistics_match_jax(depth_weight):
    """One densify step from one state: the loss, the accumulated screen
    gradient (rtol 1e-4) and the visibility counts (exact), with and
    without the sparse depth term."""
    p, jc, tcam, target = scene()
    cap = 180
    state = trainer.init_state(densify.pad_model(
        GaussianModel.from_numpy(p, "cpu"), cap).trainable(), TC)
    d = densify.init_state(150, cap, device="cpu")
    d.grad_sum.fill_(0.5)
    d.vis_count.fill_(2)
    js, jd = jax_train_state(state.to_numpy()), jax_dstate(d)
    obs = np.random.default_rng(5).uniform(
        [0, 0, 2.0], [64, 48, 5.0], (40, 3)).astype(np.float32)
    mask = np.arange(40) < 33
    extra = (obs, mask) if depth_weight else ()
    jstep = jdensify.make_train_step(jax_config(CFG), JTC, use_pallas=False,
                                     depth_weight=depth_weight)
    js, jd, jl = jstep(js, jd, jc, jnp.asarray(target),
                       *(jnp.asarray(x) for x in extra))
    step = densify.make_train_step(CFG, TC, depth_weight)
    loss = step(state, d.grad_sum, d.vis_count, tcam, torch.tensor(target),
                *(torch.tensor(x) for x in extra))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(d.vis_count.numpy(),
                                  np.asarray(jd.vis_count))
    assert int((d.vis_count > 2).sum()) > 20
    np.testing.assert_allclose(d.grad_sum.numpy(), np.asarray(jd.grad_sum),
                               rtol=1e-4, atol=1e-9)
    assert int(state.step) == 1
    for i, (a, b) in enumerate(zip(state.to_numpy()[:5], leaves_of(js)[:5])):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=FIELDS[i])


def _event_case(kind: str):
    """(port TrainState, DensifyState, config kwargs) for one event case.
    Slots past `alive` are dead; the accumulated statistics pick which
    alive slots are clone or split candidates."""
    rng = np.random.default_rng({"prune": 1, "clone": 2, "split": 3,
                                 "full": 4, "ties": 5}[kind])
    cap, n = dict(prune=(16, 10), clone=(16, 8), split=(16, 8),
                  full=(12, 10), ties=(32, 20))[kind]
    p = params_np(7, cap, sh_degree=1, log_scale=(-6.0, -5.0))
    p["opacities"][:] = rng.uniform(0.5, 3.0, cap).astype(np.float32)
    avg = np.zeros(cap, np.float32)
    if kind == "prune":
        p["opacities"][[1, 4, 6, 9]] = -8.0
    elif kind == "clone":
        avg[[0, 2, 3, 5, 7]] = [3e-4, 5e-4, 4e-4, 9e-4, 6e-4]
    elif kind == "split":
        avg[[1, 2, 4, 6, 7]] = [3e-4, 5e-4, 4e-4, 9e-4, 6e-4]
        p["log_scales"][:n] = rng.uniform(-2.5, -1.5, (n, 3))
    elif kind == "full":
        avg[:8] = rng.uniform(3e-4, 1e-3, 8)
        p["log_scales"][:4] = rng.uniform(-2.5, -1.5, (4, 3))
        p["opacities"][9] = -8.0
    else:   # tied priorities, every kind of slot, a world-scale prune
        avg[:n] = rng.choice([0.0, 3e-4, 3e-4, 7e-4], n)
        big = rng.random(n) < 0.5
        p["log_scales"][:n][big] = rng.uniform(-2.5, -1.5, (big.sum(), 3))
        p["log_scales"][3] = 0.5
        p["opacities"][[2, 11]] = -8.0
    p["opacities"][n:] = -30.0
    p["log_scales"][n:] = -30.0
    state = port_state(p, seed=cap + n)
    d = densify.init_state(n, cap, np.array([7, 11], np.uint32),
                           device="cpu")
    vis = rng.integers(1, 5, cap).astype(np.int32)
    d.vis_count.copy_(torch.tensor(vis))
    d.grad_sum.copy_(torch.tensor(avg * vis))
    kw = dict(scene_extent=1.5)
    if kind == "ties":
        kw["max_world_scale"] = 1.0
    return state, d, kw


@pytest.mark.parametrize("kind", ["prune", "clone", "split", "full", "ties"])
def test_densify_and_prune_matches_jax(kind):
    """The event fed the reference's own split noise: the alive mask and
    the slot each birth lands in equal, the parameters and the Adam
    moments within 1e-6, the statistics zeroed."""
    state, d, kw = _event_case(kind)
    cfg = densify.DensifyConfig(**kw)
    cap = state.params.num_gaussians
    key = jnp.asarray(d.key)
    _, ka, kb = jax.random.split(key, 3)
    eps = [np.asarray(jax.random.normal(k, (cap, 3), jnp.float32))
           for k in (ka, kb)]
    js, jd = jdensify.densify_and_prune(jax_train_state(state.to_numpy()),
                                        jax_dstate(d),
                                        jdensify.DensifyConfig(**kw))
    # The kept slots and candidates, from the state before the event.
    with torch.no_grad():
        avg = d.grad_sum / torch.clamp_min(d.vis_count, 1).float()
        smax = torch.exp(state.params.log_scales).amax(-1)
        keep = d.alive & ~(torch.sigmoid(state.params.opacities)
                           < cfg.min_opacity)
        if cfg.max_world_scale > 0:
            keep &= ~(smax > cfg.max_world_scale * cfg.scene_extent)
        n_birth = int((keep & (avg > cfg.grad_threshold)).sum())
        n_keep, n_alive = int(keep.sum()), int(d.alive.sum())
    densify.densify_and_prune_core(state, d, cfg, *map(torch.tensor, eps))
    want = leaves_of((js, jd))
    got = state.to_numpy() + d.to_numpy()
    np.testing.assert_array_equal(got[24], want[24])          # alive
    for i in range(22):
        np.testing.assert_allclose(got[i], want[i], atol=1e-6, rtol=0,
                                   err_msg=f"leaf {i}")
    assert not got[22].any() and not got[23].any()
    births = int(d.alive.sum()) - n_keep
    assert births == min(n_birth, cap - n_keep)
    if kind == "prune":
        assert int(d.alive.sum()) == n_alive - 4
    elif kind == "full":
        assert n_birth > cap - n_keep and bool(d.alive.all())
    else:
        assert births > 0


def test_densify_and_prune_advances_its_key():
    state, d, kw = _event_case("clone")
    cfg = densify.DensifyConfig(**kw)
    _, d1 = densify.densify_and_prune(state, d, cfg)
    assert d1.key.dtype == np.uint32 and d1.key.shape == (2,)
    assert not np.array_equal(d1.key, d.key)
    assert d1.alive is d.alive          # written in place, not rebound


def test_reset_opacity_matches_jax_exactly():
    state, d, _ = _event_case("ties")
    with torch.no_grad():
        state.params.opacities[:5] = torch.tensor([-6.0, -4.6, -4.5, 0.0,
                                                   3.0])
    js = jdensify.reset_opacity(jax_train_state(state.to_numpy()),
                                jax_dstate(d), jdensify.DensifyConfig())
    densify.reset_opacity(state, d, densify.DensifyConfig())
    for i, (a, b) in enumerate(zip(state.to_numpy(), leaves_of(js))):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert float(state.params.opacities[3].detach()) < -4.59


def test_loss_mix_scale_matches_jax():
    p, jc, tcam, target = scene()
    want = jdensify.loss_mix_scale(jmodel(p), jc, jnp.asarray(target),
                                   jax_config(CFG), 0.2, use_pallas=False)
    got = densify.loss_mix_scale(GaussianModel.from_numpy(p, "cpu"), tcam,
                                 torch.tensor(target), CFG, 0.2)
    assert got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert densify.loss_mix_scale(GaussianModel.from_numpy(p, "cpu"), tcam,
                                  torch.tensor(target), CFG, 0.0) == 1.0


def test_fit_densify_alive_counts_match_jax():
    """A short fit with events at steps 2 and 4 and a threshold of 1e-7
    (every visible alive gaussian a candidate): the alive count after
    every step equals the reference's."""
    p, jc, tcam, target = scene(n=80)
    dcfg = dict(grad_threshold=1e-7, densify_every=2, densify_from_step=2,
                reset_opacity_every=0, scene_extent=1.5)
    _, jhist = jdensify.fit_densify(
        jmodel(p), [jc], [jnp.asarray(target)], jax_config(CFG), JTC,
        jdensify.DensifyConfig(**dcfg), capacity=112, num_steps=5,
        use_pallas=False, log_every=1)
    model, hist = densify.fit_densify(
        GaussianModel.from_numpy(p, "cpu"), [tcam], [torch.tensor(target)],
        CFG, TC, densify.DensifyConfig(**dcfg), capacity=112, num_steps=5,
        log_every=1)
    assert [h[2] for h in hist] == [h[2] for h in jhist]
    assert hist[0][2] == 80 and hist[-1][2] > 80
    assert model.num_gaussians == hist[-1][2]
    np.testing.assert_allclose([h[1] for h in hist[:2]],
                               [h[1] for h in jhist[:2]], rtol=1e-5)
