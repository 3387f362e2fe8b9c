"""The training chain of the port against the JAX package on identical
weights: the binning VJP, model gradients through the whole render, the
losses, the per-group Adam update and three whole train steps; and that
training lowers the loss."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.render import binning as jbin
from gaussian_splat_ipu_tpu.render import pipeline as jpipe
from gaussian_splat_ipu_tpu.train import losses as jlosses
from gaussian_splat_ipu_tpu.train import trainer as jtrainer
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
from gaussian_splat_ipu_tpu_torch.train import losses, trainer
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests.test_torch_config import jax_config
from tests.test_torch_binning import jax_splats, to_torch

torch.set_num_threads(1)

CFG = RasterConfig(image_width=64, image_height=48, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 12,
                   max_chunks_per_tile=16)


def params_np(seed, n, sh_degree=0, log_scale=(-4.0, -2.5)):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    return dict(
        means=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        log_scales=rng.uniform(*log_scale, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(-2, 4, n).astype(np.float32),
        sh=rng.uniform(-1, 1, (n, k, 3)).astype(np.float32))


def cameras(cfg, rot=40.0):
    bb = np.ones(3, np.float32)
    jc = JCamera.orbit(-bb, bb, np.radians(40.0),
                       cfg.image_width / cfg.image_height, rot_y_deg=rot)
    return jc, Camera.from_numpy(np.asarray(jc.view), np.asarray(jc.proj),
                                 device="cpu")


def jmodel(p):
    return JModel(**{k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("tile_group,exact", [(1, False), (3, True)])
def test_binning_vjp_matches_fused_table_bwd(tile_group, exact):
    """The pair-table cotangent carried back to the splat fields by the
    port's _PairTable (one index_add_ by sorted gid) and by the JAX
    package's custom VJP (fused_table_bwd scatter-add)."""
    cfg = dataclasses.replace(CFG, image_width=160, image_height=96,
                              pair_capacity=1 << 14, tile_group=tile_group,
                              exact_tile_test=exact)
    js = jax_splats(0, 1500, cfg)
    cot = np.random.default_rng(1).normal(
        size=(16, cfg.pair_capacity)).astype(np.float32)
    names = ("xy", "depth", "conic", "color", "opacity")

    def jf(*fields):
        s = js._replace(**dict(zip(names, fields)))
        return jnp.sum(jbin.bin_splats(s, jax_config(cfg)).features * cot)

    want = jax.grad(jf, argnums=tuple(range(5)))(
        *(getattr(js, k) for k in names))
    ts = to_torch(js)
    leaves = [getattr(ts, k).clone().requires_grad_() for k in names]
    feats = binning.bin_splats(ts._replace(**dict(zip(names, leaves))),
                               cfg).features
    torch.sum(feats * torch.tensor(cot)).backward()
    for name, leaf, w in zip(names, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    assert float(leaves[0].grad.abs().max()) > 1.0


@pytest.mark.parametrize("tile_group,exact,sh_degree,antialias", [
    (1, False, 0, False), (3, True, 1, True)])
def test_model_grads_match_jax(tile_group, exact, sh_degree, antialias):
    """Port of test_end_to_end_model_grads: loss -> image -> rasterize
    backward -> binning VJP -> projection autograd, all five fields,
    against jax.grad of the same loss on the JAX package's spec path."""
    cfg = dataclasses.replace(CFG, tile_group=tile_group,
                              exact_tile_test=exact, antialias=antialias)
    p = params_np(5, 300, sh_degree)
    jc, tc = cameras(cfg)
    w = np.random.default_rng(2).normal(
        size=(cfg.image_height, cfg.image_width, 4)).astype(np.float32)

    def jloss(m):
        return jnp.sum(jpipe.render_image(m, jc, jax_config(cfg), False) * w)

    want = jax.grad(jloss)(jmodel(p))
    model = GaussianModel.from_numpy(p, device="cpu").trainable()
    loss = torch.sum(pipeline.render_image(model, tc, cfg)
                     * torch.tensor(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(jloss(jmodel(p))), rtol=1e-5)
    for name in FIELDS:
        got = getattr(model, name).grad.numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(want, name)),
                                   atol=2e-4, rtol=1e-3, err_msg=name)
        assert np.isfinite(got).all() and np.abs(got).max() > 1e-3, name


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (48, 64, 4)).astype(np.float32)
    pred = np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1).astype(
        np.float32)
    jp, jt = jnp.asarray(pred), jnp.asarray(base)
    tp, tt = torch.tensor(pred), torch.tensor(base)
    for name in ("l1", "l2", "psnr", "ssim", "dssim"):
        np.testing.assert_allclose(
            float(getattr(losses, name)(tp[..., :3], tt[..., :3])),
            float(getattr(jlosses, name)(jp[..., :3], jt[..., :3])),
            atol=1e-6, rtol=1e-6, err_msg=name)
    for weight in (0.0, 0.2):
        np.testing.assert_allclose(
            float(losses.render_loss(tp, tt, weight)),
            float(jlosses.render_loss(jp, jt, weight)), atol=1e-6)


def test_optimizer_updates_match_optax():
    """Four updates from given gradients against make_optimizer(cfg).update
    + apply_param_updates: a 2-step means decay (so the schedule moves
    and reaches its floor), the SH-rest scale and the quaternion
    renormalisation; every leaf of the state, counts included."""
    p = params_np(0, 16, sh_degree=2)
    rng = np.random.default_rng(1)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p.items()} for _ in range(4)]
    kw = dict(lr_means_decay_steps=2, scene_extent=2.0)
    jcfg, tcfg = jtrainer.TrainConfig(**kw), trainer.TrainConfig(**kw)
    tx = jtrainer.make_optimizer(jcfg)
    jm, jopt = jmodel(p), tx.init(jmodel(p))
    state = trainer.init_state(
        GaussianModel.from_numpy(p, device="cpu").trainable(), tcfg)
    for g in grads:
        jm, jopt = jtrainer.apply_param_updates(tx, jm, jmodel(g), jopt)
        trainer.apply_param_updates(
            state.params, {k: torch.tensor(v) for k, v in g.items()},
            state.opt_state, tcfg)
    want = jax.tree_util.tree_leaves(
        jtrainer.TrainState(jm, jopt, jnp.zeros((), jnp.int32)))
    got = state.to_numpy()
    assert len(got) == len(want) == 22
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.asarray(b).dtype and a.shape == b.shape, i
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-7, rtol=1e-6,
                                   err_msg=f"leaf {i}")
    lr = [float(trainer.means_lr(torch.tensor(c, dtype=torch.int32), tcfg))
          for c in range(4)]
    assert lr[0] > lr[1] > lr[2] == lr[3]


def test_sh_rest_lr_scale():
    """Port of tests/test_train.py::test_sh_rest_lr_scale: bands >= 1 step
    at sh_rest_lr_scale of the dc band's rate."""
    p = params_np(0, 16, sh_degree=2)
    tcfg = trainer.TrainConfig()
    model = GaussianModel.from_numpy(p, device="cpu").trainable()
    before = model.sh.detach().clone()
    state = trainer.init_state(model, tcfg)
    trainer.apply_param_updates(
        model, {k: torch.ones_like(getattr(model, k)) for k in FIELDS},
        state.opt_state, tcfg)
    u = (model.sh.detach() - before).numpy()
    ratio = np.abs(u[:, 1:]).mean() / np.abs(u[:, 0]).mean()
    np.testing.assert_allclose(ratio, tcfg.sh_rest_lr_scale, rtol=1e-4)


def _scene_and_target(cfg):
    p = params_np(0, 200, sh_degree=1, log_scale=(-3.5, -2.0))
    target_p = params_np(3, 200, sh_degree=1, log_scale=(-3.5, -2.0))
    jc, tc = cameras(cfg)
    target = np.asarray(jpipe.render_image(jmodel(target_p), jc,
                                           jax_config(cfg),
                                           False))
    return p, jc, tc, target


def test_three_train_steps_match_jax():
    """Three train_steps from one state against the JAX package's
    train_step (use_pallas=True: the Pallas kernels in interpret mode), L1
    + SSIM loss. Parameters, Adam moments and counts are compared. The
    bar on the parameters is atol 1e-5, a hundredth of one step at the
    smallest group rate (lr_quats 1e-3); the moments, which carry the
    gradients' f32 reassociation differences, are held to 1e-3 of each
    leaf's largest magnitude. Counts are equal."""
    cfg = CFG
    p, jc, tc, target = _scene_and_target(cfg)
    jtc = jtrainer.TrainConfig(ssim_weight=0.2)
    ttc = trainer.TrainConfig(ssim_weight=0.2)
    step = jax.jit(jtrainer.train_step, static_argnums=(3, 4, 5))
    jstate = jtrainer.init_state(jmodel(p), jtc)
    tstate = trainer.init_state(
        GaussianModel.from_numpy(p, device="cpu").trainable(), ttc)
    jt, tt = jnp.asarray(target), torch.tensor(target)
    for _ in range(3):
        jstate, jl = step(jstate, jc, jt, jax_config(cfg), jtc, True)
        tstate, tl = trainer.train_step(tstate, tc, tt, cfg, ttc)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    got = tstate.to_numpy()
    for i in range(5):                                      # parameters
        np.testing.assert_allclose(got[i], want[i], atol=1e-5,
                                   err_msg=FIELDS[i])
    for i in range(5, 22):                                  # optimizer
        scale = np.abs(want[i]).max() if want[i].size else 0.0
        np.testing.assert_allclose(got[i], want[i], rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=f"leaf {i}")
    assert int(tstate.step) == 3


def test_training_lowers_the_loss_and_keeps_quats_normalised():
    cfg = CFG
    p, _, tc, target = _scene_and_target(cfg)
    model = GaussianModel.from_numpy(p, device="cpu")
    trained, history = trainer.fit(model, [tc], [torch.tensor(target)], cfg,
                                   trainer.TrainConfig(), num_steps=8)
    assert len(history) == 8 and np.isfinite(history).all()
    assert history[-1] < history[0]
    norms = torch.linalg.vector_norm(trained.quats.detach(), dim=-1)
    assert float((norms - 1.0).abs().max()) < 1e-5
    # fit trains a copy: the model it was given is unchanged.
    np.testing.assert_array_equal(model.means.numpy(), p["means"])
