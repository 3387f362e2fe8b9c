"""The training extras of the port's train CLI against the JAX train CLI on
one 64x48 COLMAP capture of 3 views with SfM tracks: density control
(alive count, checkpoint restored by the JAX package, resume), pose +
exposure + depth, the progressive SH schedule, target streaming with a
wrapped duplicate, and --auto-grow, which only the port is asked about."""

import jax
import numpy as np
import pytest

from gaussian_splat_ipu_tpu.app import train as japp
from gaussian_splat_ipu_tpu.train import checkpoint as jcheckpoint
from gaussian_splat_ipu_tpu.train import densify as jdensify
from gaussian_splat_ipu_tpu_torch.app import train as app
from tests._torch_extras import jax_copy, jax_train_state
from tests.test_torch_train_app import (LOSS_RTOL, PSNR_ATOL, _posed_renders,
                                        _printed)

from _torch_posed import orbit_w2c, project_tracks, write_colmap

W, H, INTR = 64, 48, (52.0, 53.0, 32.0, 24.0)
COMMON = ["--pair-capacity", "8192", "--log-level", "off"]
DENSIFY = ["--densify", "--capacity", "64", "--densify-from", "2",
           "--densify-every", "2", "--densify-grad-threshold", "1e-7"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """3 views of a seeded scene, 60 SfM points, each view's tracks."""
    w2cs = orbit_w2c(3, radius=3.0)
    images, src = _posed_renders(w2cs, W, H, INTR)
    xyz = src.means.detach().numpy()[::5]
    rgb = np.random.default_rng(2).integers(0, 256, (len(xyz), 3))
    return write_colmap(str(tmp_path_factory.mktemp("cap")), images, w2cs,
                        [INTR] * 3, xyz, rgb,
                        pts2d=project_tracks(xyz, w2cs, [INTR] * 3, W, H))


def _close(got, want):
    assert abs(got["final_loss"] - want["final_loss"]) <= (
        LOSS_RTOL * want["final_loss"] + 5e-7)
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_ATOL + 0.005


def _leaves(path):
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def test_densify_cli_matches_jax_and_checkpoints_across(capture, tmp_path,
                                                        capsys):
    """Events at the epoch boundaries 3 and 6 (--densify-every 2 rounds to
    one epoch of 3 views): the alive count equals the JAX CLI's, the
    port's (state, dstate) checkpoint restores in the JAX package, and a
    resume continues from it."""
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    argv = ["--dataset", capture, "--steps", "6", *DENSIFY, *COMMON]
    assert japp.main(argv + ["--checkpoint", theirs]) == 0
    got = app.run(argv + ["--device", "cpu", "--checkpoint", ours])
    want, mine = _leaves(theirs), _leaves(ours)
    assert len(mine) == len(want) == 26
    assert mine[24].shape == (64,) and mine[24].dtype == bool
    assert int(mine[24].sum()) == int(want[24].sum()) == got["final_alive"]
    assert got["final_alive"] > 60 and got["step"] == int(mine[21]) == 6
    assert [e["step"] for e in got["events"]] == [3, 6]
    template = (jax_train_state(want[:22]),
                jdensify.DensifyState(*(jax_copy(x) for x in want[22:])))
    back = jcheckpoint.restore_checkpoint(ours, template)
    for a, b in zip(jax.tree_util.tree_leaves(back), mine):
        np.testing.assert_array_equal(np.asarray(a), b)
    resumed = app.run(argv[:2] + ["--steps", "3", *DENSIFY[:5], *COMMON,
                                  "--device", "cpu", "--resume", ours])
    assert resumed["step"] == 9 and resumed["events"] == []
    assert resumed["final_alive"] == got["final_alive"]


def test_pose_exposure_depth_cli_matches_jax(capture, capsys):
    """One aux program over all three modules: an epoch, then a tail step;
    the loss and the pose-corrected view-0 PSNR as the JAX CLI's."""
    argv = ["--dataset", capture, "--steps", "4", "--pose-opt", "5e-4",
            "--exposure-opt", "1e-2", "--depth-loss", "0.1", *COMMON]
    assert japp.main(argv) == 0
    want = _printed(capsys.readouterr().out.strip().splitlines()[-1])
    got = app.run(argv + ["--device", "cpu"])
    _close(got, want)
    assert got["step"] == 4
    assert np.abs(got["pose_deltas"]).max() > 0.0
    assert np.abs(got["exposure_mats"] - np.eye(3, 4)).max() > 0.0
    assert [r["program"] for r in got["registrations"]] == ["render",
                                                            "aux_step"]


def test_depth_only_cli_matches_jax(capture, tmp_path, capsys):
    """--depth-loss alone: the aux program with both modules off, whose
    checkpoint is the bare state's 22 leaves, as the JAX CLI's."""
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    argv = ["--dataset", capture, "--steps", "4", "--depth-loss", "0.1",
            *COMMON]
    assert japp.main(argv + ["--checkpoint", theirs]) == 0
    want = _printed(capsys.readouterr().out.strip().splitlines()[-1])
    got = app.run(argv + ["--device", "cpu", "--checkpoint", ours])
    _close(got, want)
    assert len(_leaves(ours)) == len(_leaves(theirs)) == 22
    assert got["pose_deltas"] is None and got["exposure_mats"] is None
    assert [r["program"] for r in got["registrations"]] == ["render",
                                                            "aux_step"]


def test_sh_schedule_cli_matches_jax(capture, capsys):
    """--sh-step-every 2 over two epochs: band 0, then degree 1 from step
    3 (the bump lands on the epoch boundary, as the reference's)."""
    argv = ["--dataset", capture, "--steps", "6", "--sh-step-every", "2",
            *COMMON]
    assert japp.main(argv) == 0
    want = _printed(capsys.readouterr().out.strip().splitlines()[-1])
    got = app.run(argv + ["--device", "cpu"])
    _close(got, want)
    steps = [(r["step"], r["active_sh_degree"])
             for r in got["registrations"] if r["program"] == "train_step"]
    assert steps == [(0, 0), (3, 1)] and got["active_sh_degree"] == 1


def test_max_device_views_cli_matches_jax(capture, tmp_path, capsys):
    """Targets streamed 2 views at a time over 3 shuffled views: each epoch
    is [a, b], [c, a] (the last piece wraps the epoch's first view), 4
    steps, so 2 epochs are 8 steps, as the JAX CLI's."""
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    argv = ["--dataset", capture, "--steps", "6", "--max-device-views", "2",
            "--shuffle", *COMMON]
    assert japp.main(argv + ["--checkpoint", theirs]) == 0
    want = _printed(capsys.readouterr().out.strip().splitlines()[-1])
    got = app.run(argv + ["--device", "cpu", "--checkpoint", ours])
    _close(got, want)
    assert got["step"] == int(_leaves(theirs)[21]) == 8
    assert got["device_views"] == 2 and len(got["losses"]) == 8


def test_auto_grow_doubles_the_capacity(capture):
    """Above 90% alive after an event the slot buffer doubles, and both
    programs are registered again at the new size."""
    got = app.run(["--dataset", capture, "--steps", "6", *DENSIFY,
                   "--auto-grow", "--device", "cpu", *COMMON])
    assert [e["slots"] for e in got["events"]] == [64, 128]
    assert got["num_gaussians"] == 256 and got["final_alive"] > 0.9 * 128
    regs = [(r["program"], r["slots"]) for r in got["registrations"]]
    assert regs == [("render", 64), ("densify_step", 64), ("render", 128),
                    ("densify_step", 128), ("render", 256),
                    ("densify_step", 256)]
