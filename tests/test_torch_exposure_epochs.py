"""The exposure rate over several epochs: the port's train CLI against the
JAX train CLI on a 21-view 64x48 COLMAP capture whose written poses carry a
small SE(3) perturbation and whose images a per-view affine exposure error
(chip_smoke.py phase 14 (b)'s recipe and view count, at 64x48).

Adam runs over the whole (V, 3, 4) exposure tensor, as optax does, so each
view's map moves on its momentum through the V - 1 steps between its
visits. At --exposure-opt 1e-2 that drift stalls the loss in the second
epoch, where at 1e-3 it falls. The JAX CLI's per-epoch losses are the
port's at both rates, so the stall is the reference's too. (The maps
themselves part by up to 3.4e-3 at 1e-2, so they are not compared.)"""

import jax
import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.app import train as japp
from gaussian_splat_ipu_tpu.train import aux_opt as jaux
from gaussian_splat_ipu_tpu_torch.app import train as app
from gaussian_splat_ipu_tpu_torch.train import pose_opt
from tests.test_torch_train_app import (LOSS_RTOL, PSNR_ATOL, _posed_renders,
                                        _printed)

from _torch_posed import orbit_w2c, project_tracks, write_colmap

W, H, INTR = 64, 48, (52.0, 53.0, 32.0, 24.0)
VIEWS, EPOCHS = 21, 4
# Epoch means: the first two agree to 1e-6; the maps' 3.4e-3 parting moves
# the later ones by up to 1.8e-4 (relative), ten times under the stall's
# 1% that the test reads.
EPOCH_RTOL = 1e-3


@pytest.fixture(scope="module")
def perturbed(tmp_path_factory):
    """The capture: poses written with a normal SE(3) error (0.004 rad,
    0.01 per axis), images with a uniform gain 1 +- 0.1 and bias +- 0.03
    per view and channel, 60 SfM points with their tracks."""
    w2cs = orbit_w2c(VIEWS, radius=3.0)
    images, src = _posed_renders(w2cs, W, H, INTR)
    rng = np.random.default_rng(7)
    err = np.concatenate([rng.normal(0, 0.004, (VIEWS, 3)),
                          rng.normal(0, 0.01, (VIEWS, 3))], 1)
    written = [(pose_opt.se3_exp(torch.tensor(d, dtype=torch.float64))
                .numpy() @ w).astype(np.float32) for d, w in zip(err, w2cs)]
    gain = rng.uniform(0.9, 1.1, (VIEWS, 3))
    bias = rng.uniform(-0.03, 0.03, (VIEWS, 3))
    exposed = [np.clip(im * g + b, 0.0, 1.0)
               for im, g, b in zip(images, gain, bias)]
    xyz = src.means.detach().numpy()[::5]
    rgb = np.random.default_rng(2).integers(0, 256, (len(xyz), 3))
    return write_colmap(str(tmp_path_factory.mktemp("perturbed")), exposed,
                        written, [INTR] * VIEWS, xyz, rgb,
                        pts2d=project_tracks(xyz, w2cs, [INTR] * VIEWS, W,
                                             H))


def _record_jax_losses(monkeypatch) -> list:
    """The JAX CLI's loss at each step, in order: its aux step, wrapped to
    hand each loss to the host as the CLI's epoch programs run it."""
    seen, make = [], jaux.make_aux_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(*step_args):
            state, aux, loss = step(*step_args)
            jax.debug.callback(lambda x: seen.append(float(x)), loss,
                               ordered=True)
            return state, aux, loss
        return wrapped

    monkeypatch.setattr(jaux, "make_aux_step", recording)
    return seen


def _epoch_means(losses) -> np.ndarray:
    return np.asarray(losses).reshape(EPOCHS, VIEWS).mean(1)


@pytest.mark.parametrize("lr, stalls", [(1e-2, True), (1e-3, False)])
def test_exposure_rate_epochs_match_jax(perturbed, capsys, monkeypatch, lr,
                                        stalls):
    """4 epochs of pose + exposure + depth: each epoch's mean loss, the
    final loss and the PSNR as the JAX CLI's; in both, the second epoch's
    mean within 1% of the first's at 1e-2, at least 5% below it at 1e-3."""
    argv = ["--dataset", perturbed, "--steps", str(VIEWS * EPOCHS),
            "--pose-opt", "5e-4", "--exposure-opt", str(lr), "--depth-loss",
            "0.1", "--pair-capacity", "8192", "--log-level", "off"]
    seen = _record_jax_losses(monkeypatch)
    assert japp.main(argv) == 0
    want = _printed(capsys.readouterr().out.strip().splitlines()[-1])
    got = app.run(argv + ["--device", "cpu"])
    assert abs(got["final_loss"] - want["final_loss"]) <= (
        LOSS_RTOL * want["final_loss"] + 5e-7)
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_ATOL + 0.005
    ours, theirs = _epoch_means(got["losses"]), _epoch_means(seen)
    np.testing.assert_allclose(ours, theirs, rtol=EPOCH_RTOL)
    for means in (ours, theirs):
        fall = 1.0 - means[1] / means[0]
        assert (fall < 0.01) if stalls else (fall > 0.05), means
