"""Checkpoints, PLY export and the port's train CLI
(gaussian_splat_ipu_tpu_torch.app.train) on the CPU: checkpoints load in
either package, PLY export round-trips, a tiny distill run trains,
checkpoints and resumes, --rowseg trains as the flat path does, a COLMAP
--dataset epoch from the SfM points matches the JAX train CLI on the same
files, a transforms.json RGBA set trains over a white background, and
unported flags are refused."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.app import train as japp
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.train import checkpoint as jcheckpoint
from gaussian_splat_ipu_tpu.train import trainer as jtrainer
from gaussian_splat_ipu_tpu_torch.app import train as app
from gaussian_splat_ipu_tpu_torch.io.scene import write_ply
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.train import checkpoint, trainer
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

from _torch_posed import orbit_w2c, write_colmap, write_transforms

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


def test_rowseg_run_trains_like_the_flat_path(ply):
    """--rowseg 2 bins every target, step and final render into two row
    buckets: the run trains, drops no pair, and follows the flat run's
    losses (the same pairs in the same order per tile; gradients agree to
    reassociation, rtol 1e-5)."""
    common = ["--input", ply, "--width", "64", "--height", "48", "--views",
              "2", "--steps", "4", "--device", "cpu", "--log-level", "warn",
              "--init-gaussians", "200", "--seed", "3", "--exact-tiles"]
    flat = app.run(common)
    seg = app.run(common + ["--rowseg", "2"])
    assert seg["target_overflow"] == [0, 0] and seg["final_overflow"] == 0
    assert np.isfinite(seg["losses"]).all() and seg["step"] == 4
    assert seg["losses"][2] < seg["losses"][0]
    np.testing.assert_allclose(seg["losses"], flat["losses"], rtol=1e-5)


def _posed_renders(w2cs, width, height, intr, rgba=False, seed=11):
    """Renders of a seeded 300-gaussian model at OpenCV poses (RGB, or
    straight-alpha RGBA), and the model."""
    g = torch.Generator().manual_seed(seed)
    src = GaussianModel.random(300, generator=g, device="cpu")
    with torch.no_grad():
        src.log_scales += 1.0
    cfg = RasterConfig(image_width=width, image_height=height,
                       pair_capacity=1 << 13)
    out = []
    for w2c in w2cs:
        cam = Camera.from_intrinsics(*intr, width, height,
                                     w2c.astype(np.float32), device="cpu")
        with torch.no_grad():
            img = render(src, cam, cfg).image.numpy()
        if rgba:
            a = img[..., 3:4]
            img = np.concatenate([img[..., :3] / np.maximum(a, 1e-6), a], -1)
        out.append(np.clip(img if rgba else img[..., :3], 0.0, 1.0))
    return out, src


# The COLMAP epoch against the JAX CLI: test_torch_train.py holds three
# train steps to JAX within rtol 1e-5 on the loss; from_points' log-scales
# agree to 2e-4 at worst (test_torch_colmap.py) and to about 1e-6 on this
# cloud, so the last loss is held to rtol 1e-4. JAX prints the loss to 6
# decimals and the PSNRs to 0.01 dB, hence the rounding terms.
LOSS_RTOL, PSNR_ATOL = 1e-4, 0.01


def _printed(line):
    return {k: float(v) for k, v in (kv.split("=") for kv in line.split())}


def test_colmap_epoch_from_sfm_points_matches_jax(tmp_path, capsys):
    w, h, intr = 64, 48, (52.0, 53.0, 32.0, 24.0)
    w2cs = orbit_w2c(4, radius=3.0)
    images, src = _posed_renders(w2cs, w, h, intr)
    xyz = src.means.detach().numpy()[::5]
    rgb = np.random.default_rng(2).integers(0, 256, (len(xyz), 3))
    cap = write_colmap(str(tmp_path / "cap"), images, w2cs, [intr] * 4, xyz,
                       rgb)
    argv = ["--dataset", cap, "--holdout-every", "4", "--steps", "3",
            "--pair-capacity", "8192", "--log-level", "off"]
    assert japp.main(argv) == 0
    want = _printed(capsys.readouterr().out.strip().splitlines()[-1])
    got = app.run(argv + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(_printed(line)) == {"final_loss", "psnr", "eval_psnr"}
    assert got["init"] == f"{len(xyz)} SfM points"
    assert got["views"] == 3 and got["holdout_views"] == 1
    assert got["step"] == 3 and got["num_gaussians"] == len(xyz)
    assert got["target_overflow"] == [0, 0, 0]
    assert got["holdout_overflow"] == [0] and got["final_overflow"] == 0
    assert abs(got["final_loss"] - want["final_loss"]) <= (
        LOSS_RTOL * want["final_loss"] + 5e-7)
    for k in ("psnr", "eval_psnr"):
        assert abs(got[k] - want[k]) <= PSNR_ATOL + 0.005, k


def test_shuffled_epochs_match_jax(tmp_path, capsys):
    """--shuffle draws a fresh permutation of the views each epoch, as the
    reference does; shuffling the previous epoch's order instead composes
    the permutations and departs from the reference from epoch 2 on. Three
    epochs over three views from the SfM points, against the JAX CLI."""
    w, h, intr = 64, 48, (52.0, 53.0, 32.0, 24.0)
    w2cs = orbit_w2c(3, radius=3.0)
    images, src = _posed_renders(w2cs, w, h, intr)
    xyz = src.means.detach().numpy()[::5]
    rgb = np.random.default_rng(2).integers(0, 256, (len(xyz), 3))
    cap = write_colmap(str(tmp_path / "cap"), images, w2cs, [intr] * 3, xyz,
                       rgb)
    argv = ["--dataset", cap, "--shuffle", "--steps", "9",
            "--pair-capacity", "8192", "--log-level", "off"]
    assert japp.main(argv) == 0
    want = _printed(capsys.readouterr().out.strip().splitlines()[-1])
    got = app.run(argv + ["--device", "cpu"])
    assert got["step"] == 9 and got["views"] == 3
    assert abs(got["final_loss"] - want["final_loss"]) <= (
        LOSS_RTOL * want["final_loss"] + 5e-7)
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_ATOL + 0.005


def test_transforms_rgba_white_background_random_init(tmp_path):
    w = h = 48
    intr = (40.0, 40.0, 24.0, 24.0)
    w2cs = orbit_w2c(3, radius=3.0)
    images, _ = _posed_renders(w2cs, w, h, intr, rgba=True)
    root = write_transforms(str(tmp_path / "ds"), images, w2cs,
                            fov_x=float(2.0 * np.arctan(0.5 * w / 40.0)))
    stats = app.run(["--dataset", root, "--background", "white", "--steps",
                     "6", "--init-gaussians", "200", "--device", "cpu",
                     "--pair-capacity", "8192", "--log-level", "warn"])
    assert stats["init"] == "200 random gaussians"
    assert stats["views"] == 3 and stats["eval_psnr"] is None
    assert np.isfinite(stats["losses"]).all() and stats["step"] == 6
    # Each view's loss fell from its first visit to its second.
    assert all(stats["losses"][k + 3] < stats["losses"][k]
               for k in range(3))
    assert stats["target_overflow"] == [0, 0, 0]


@pytest.mark.parametrize("flags", [["--distributed"], ["--view-batch", "2"]])
def test_multi_process_flags_are_accepted(flags, monkeypatch):
    """A multi-process run (the GSPLAT_COORDINATOR environment) takes the
    distributed flags (tests/test_torch_multihost_train.py trains one)."""
    monkeypatch.setenv("GSPLAT_COORDINATOR", "127.0.0.1:29500")
    args = app.parse_args(["--input", "x.ply", *flags])
    assert args.input == "x.ply"
    assert args.distributed == -1 or args.view_batch == 2


def test_multi_process_resume_exits(tmp_path, monkeypatch):
    """--resume is single-process only, as in the reference
    (gaussian_splat_ipu_tpu/app/train.py:586-590): a run of two processes
    exits with its message before it loads anything."""
    from gaussian_splat_ipu_tpu_torch.parallel import multihost
    monkeypatch.setattr(multihost, "initialize", lambda **kw: True)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(SystemExit, match="--resume is single-process only"):
        app.run(["--input", str(tmp_path / "missing.ply"), "--resume",
                 str(tmp_path / "ck.npz"), "--device", "cpu",
                 "--log-level", "off"])


@pytest.mark.parametrize("flags,dest,value", [
    (["--densify"], "densify", True), (["--capacity", "10"], "capacity", 10),
    (["--densify-every", "5"], "densify_every", 5),
    (["--densify-grad-threshold", "1e-3"], "densify_grad_threshold", 1e-3),
    (["--densify-from", "1"], "densify_from", 1),
    (["--densify-until", "9"], "densify_until", 9),
    (["--auto-grow"], "auto_grow", True),
    (["--pose-opt", "1e-3"], "pose_opt", 1e-3),
    (["--exposure-opt", "1e-2"], "exposure_opt", 1e-2),
    (["--depth-loss", "0.1"], "depth_loss", 0.1),
    (["--sh-step-every", "100"], "sh_step_every", 100),
    (["--max-device-views", "2"], "max_device_views", 2)])
def test_training_extras_flags_are_accepted(flags, dest, value):
    assert getattr(app.parse_args(["--input", "x.ply", *flags]),
                   dest) == value


def test_input_is_required(capsys):
    with pytest.raises(SystemExit):
        app.parse_args([])
    assert "one of --input / --dataset is required" in capsys.readouterr().err
    assert app.parse_args(["--dataset", "d"]).dataset == "d"
