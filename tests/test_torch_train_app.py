"""Checkpoints, PLY export and the port's train CLI
(gaussian_splat_ipu_tpu_torch.app.train) on the CPU: checkpoints load in
either package, PLY export round-trips, a tiny distill run trains,
checkpoints and resumes, and unported flags are refused."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.train import checkpoint as jcheckpoint
from gaussian_splat_ipu_tpu.train import trainer as jtrainer
from gaussian_splat_ipu_tpu_torch.app import train as app
from gaussian_splat_ipu_tpu_torch.io.scene import write_ply
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.train import checkpoint, trainer

torch.set_num_threads(1)


def jax_state(seed=0, n=24, k=4):
    """A reference TrainState with every leaf distinct from its init: one
    optimizer update from random gradients, and a nonzero step."""
    rng = np.random.default_rng(seed)
    shapes = dict(means=(n, 3), log_scales=(n, 3), quats=(n, 4),
                  opacities=(n,), sh=(n, k, 3))

    def model():
        return JModel(**{f: jnp.asarray(rng.normal(size=s), jnp.float32)
                         for f, s in shapes.items()})

    cfg = jtrainer.TrainConfig()
    params = model()
    tx = jtrainer.make_optimizer(cfg)
    params, opt = jtrainer.apply_param_updates(tx, params, model(),
                                               tx.init(params))
    return jtrainer.TrainState(params, opt, jnp.asarray(5, jnp.int32))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    js = jax_state()
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(path, js)
    template = trainer.init_state(GaussianModel.from_numpy(
        {k: np.zeros(np.shape(getattr(js.params, k)), np.float32)
         for k in FIELDS}, device="cpu").trainable())
    state = checkpoint.restore_checkpoint(path, template)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    got = state.to_numpy()
    assert len(got) == len(want) == 22
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert int(state.step) == 5
    assert int(state.opt_state.means_lr_count) == 1
    assert all(t.requires_grad for t in state.params.parameters())


def test_port_checkpoint_restores_in_jax(tmp_path):
    js = jax_state(seed=1)
    state = trainer.TrainState.from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(js)], "cpu")
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, state)
    template = jtrainer.init_state(JModel(*(
        jnp.zeros_like(x) for x in jax.tree_util.tree_leaves(js.params))))
    back = jcheckpoint.restore_checkpoint(path, template)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(back),
                                   jax.tree_util.tree_leaves(js))):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not (tmp_path / "port.npz.tmp").exists()


def test_restore_refuses_a_mismatched_checkpoint(tmp_path):
    js = jax_state(n=24)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(path, js)
    template = trainer.init_state(GaussianModel.random(
        10, generator=torch.Generator().manual_seed(0),
        device="cpu").with_sh_degree(1).trainable())
    with pytest.raises(ValueError, match="leaf 0"):
        checkpoint.restore_checkpoint(path, template)


def test_export_import_ply_round_trip(tmp_path):
    model = GaussianModel.random(50, generator=torch.Generator().manual_seed(
        2), device="cpu", sh_degree=2)
    path = str(tmp_path / "m.ply")
    checkpoint.export_ply(path, model)
    back = checkpoint.import_ply(path, device="cpu")
    assert back.sh_degree == 2
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      getattr(model, k).detach().numpy())


@pytest.fixture
def ply(tmp_path):
    path = str(tmp_path / "scene.ply")
    model = GaussianModel.random(300, generator=torch.Generator().manual_seed(
        7), device="cpu")
    with torch.no_grad():
        model.log_scales += 1.0     # larger splats for a tiny image
    write_ply(path, model)
    return path


def test_distill_run_trains_checkpoints_and_resumes(ply, tmp_path, capsys):
    ckpt = str(tmp_path / "c.npz")
    out_ply = str(tmp_path / "out.ply")
    common = ["--input", ply, "--width", "64", "--height", "48",
              "--views", "2", "--device", "cpu", "--log-level", "warn",
              "--init-gaussians", "200", "--seed", "3"]
    stats = app.run(common + ["--steps", "6", "--checkpoint", ckpt,
                              "--export-ply", out_ply])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("final_loss=") and " psnr=" in line
    assert stats["step"] == 6 and len(stats["losses"]) == 6
    assert len(stats["step_ms"]) == 6
    assert np.isfinite(stats["losses"]).all() and np.isfinite(stats["psnr"])
    # Each view's loss fell from its first visit to its last.
    assert stats["losses"][4] < stats["losses"][0]
    assert stats["losses"][5] < stats["losses"][1]
    assert stats["target_overflow"] == [0, 0]
    assert stats["final_overflow"] == 0
    assert checkpoint.import_ply(out_ply, device="cpu").num_gaussians == 200

    resumed = app.run(common + ["--steps", "1", "--resume", ckpt])
    assert resumed["step"] == 7
    # The resumed step continues from the checkpointed parameters: view 0
    # again, so its loss keeps falling.
    assert resumed["losses"][0] < stats["losses"][4]


def test_self_mode_with_sh_bands_and_shuffle(ply, tmp_path):
    """--mode self trains the loaded scene itself (its own renders are the
    targets, so the loss starts at 0); --sh-degree adds zero bands, which
    the checkpoint carries; --shuffle visits the views in a new order."""
    ckpt = str(tmp_path / "s.npz")
    stats = app.run(["--input", ply, "--mode", "self", "--width", "64",
                     "--height", "48", "--views", "2", "--steps", "3",
                     "--device", "cpu", "--log-level", "warn",
                     "--sh-degree", "1", "--shuffle", "--checkpoint", ckpt])
    assert stats["losses"][0] == 0.0 and stats["step"] == 3
    assert np.isfinite(stats["losses"]).all()
    with np.load(ckpt) as data:
        assert data["leaf_4"].shape == (300, 4, 3)     # sh, degree 1
        assert int(data["leaf_21"]) == 3               # step


@pytest.mark.parametrize("flags", [
    ["--dataset", "d"], ["--downscale", "2"], ["--holdout-every", "4"],
    ["--densify"], ["--capacity", "10"], ["--densify-every", "5"],
    ["--densify-grad-threshold", "1e-3"], ["--densify-from", "1"],
    ["--densify-until", "9"], ["--auto-grow"], ["--distributed"],
    ["--view-batch", "2"], ["--pose-opt", "1e-3"],
    ["--exposure-opt", "1e-2"], ["--depth-loss", "0.1"], ["--rowseg", "4"],
    ["--export-splat", "x.splat"], ["--sh-step-every", "100"],
    ["--max-device-views", "2"]])
def test_unported_flags_are_refused(flags, capsys):
    with pytest.raises(SystemExit):
        app.parse_args(["--input", "x.ply", *flags])
    err = capsys.readouterr().err
    assert "not ported to the torch package yet" in err
    assert "ROADMAP.md" in err


def test_input_is_required():
    with pytest.raises(SystemExit):
        app.parse_args([])
