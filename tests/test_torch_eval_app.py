"""The port's eval CLI (gaussian_splat_ipu_tpu_torch.app.eval) against the
JAX package's (`--device jnp`, its plain render path) on the same PLY and
posed images, on the CPU: a COLMAP capture's holdout and train splits, a
transforms.json set whose transforms_test.json is preferred, RGBA targets
over a white background. Per-view PSNR within 0.01 dB and SSIM within
1e-4 of JAX's (the renders agree to about 1e-6); the dumped PNGs within
one level. And select_split against JAX's."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.app import eval as jeval
from gaussian_splat_ipu_tpu_torch.app import eval as eval_app
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.train import checkpoint
from gaussian_splat_ipu_tpu_torch.utils import image as image_util
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

from _torch_posed import orbit_w2c, write_colmap, write_transforms

torch.set_num_threads(1)

W, H = 64, 48
INTR = (55.0, 56.0, 31.5, 24.5)
PSNR_TOL, SSIM_TOL = 0.01, 1e-4


def _model(seed, n=250):
    g = torch.Generator().manual_seed(seed)
    m = GaussianModel.random(n, generator=g, device="cpu", sh_degree=1)
    with torch.no_grad():
        m.log_scales += 1.3
    return m


def _renders(model, w2cs, rgba=False):
    cfg = RasterConfig(image_width=W, image_height=H, pair_capacity=1 << 13)
    out = []
    for w2c in w2cs:
        cam = Camera.from_intrinsics(*INTR, W, H, w2c.astype(np.float32),
                                     device="cpu")
        with torch.no_grad():
            img = render(model, cam, cfg).image.numpy()
        if rgba:    # straight alpha, as a NeRF-synthetic PNG holds it
            a = img[..., 3:4]
            img = np.concatenate([img[..., :3] / np.maximum(a, 1e-6), a], -1)
        out.append(np.clip(img if rgba else img[..., :3], 0.0, 1.0))
    return out


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A trained-scene stand-in (PLY) and a COLMAP capture of a nearby
    model, so the PSNRs are finite and differ per view."""
    root = tmp_path_factory.mktemp("eval")
    ply = str(root / "scene.ply")
    checkpoint.export_ply(ply, _model(0))
    w2cs = orbit_w2c(6, radius=3.0)
    cap = write_colmap(str(root / "colmap"), _renders(_model(1), w2cs),
                       w2cs, [INTR] * 6, np.zeros((1, 3)), [[9, 9, 9]])
    return ply, cap


def _both(argv, caplog):
    """(port summary with per-view rows, JAX summary, JAX per-view rows)."""
    caplog.clear()
    got = eval_app.run(argv + ["--device", "cpu", "--log-level", "warn"])
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="gsplat"):
        assert jeval.main(argv + ["--device", "jnp"]) == 0
    rows = [r.args for r in caplog.records
            if r.getMessage().startswith("view ")]
    return got, rows


def _check(got, jrows, capsys):
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(got["rows"]) == len(jrows) == want["views"] > 0
    for (i, p, s), (ji, jp, js) in zip(got["rows"], jrows):
        assert i == ji
        assert abs(p - jp) <= PSNR_TOL and abs(s - js) <= SSIM_TOL, (i, p, jp)
    for k in ("mean_psnr", "min_psnr"):
        assert abs(got[k] - want[k]) <= PSNR_TOL, k
    assert abs(got["mean_ssim"] - want["mean_ssim"]) <= SSIM_TOL
    assert (got["split"], got["gaussians"]) == (want["split"],
                                                want["gaussians"])


@pytest.mark.parametrize("split", ["holdout", "train"])
def test_colmap_splits_match_jax(scene, split, caplog, capsys):
    ply, cap = scene
    argv = ["--input", ply, "--dataset", cap, "--split", split,
            "--holdout-every", "2", "--pair-capacity", "8192"]
    got, jrows = _both(argv, caplog)
    assert [r[0] for r in got["rows"]] == (
        [0, 2, 4] if split == "holdout" else [1, 3, 5])
    _check(got, jrows, capsys)


def test_transforms_test_json_white_background_and_dumps(tmp_path, caplog,
                                                         capsys):
    ply = str(tmp_path / "scene.ply")
    checkpoint.export_ply(ply, _model(2))
    w2cs = orbit_w2c(4, radius=3.0)
    imgs = _renders(_model(3), w2cs, rgba=True)
    fov_x = 2.0 * np.arctan(0.5 * W / INTR[0])
    write_transforms(str(tmp_path / "ds"), imgs[:2], w2cs[:2],
                     fov_x=fov_x, name="transforms_train.json")
    write_transforms(str(tmp_path / "ds"), imgs[2:], w2cs[2:], fov_x=fov_x,
                     name="transforms_test.json", stem="t")
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    argv = ["--input", ply, "--dataset", str(tmp_path / "ds"),
            "--background", "white", "--pair-capacity", "8192",
            "--dump-depth"]
    got = eval_app.run(argv + ["--dump", ours, "--device", "cpu",
                               "--log-level", "warn"])
    with caplog.at_level(logging.INFO, logger="gsplat"):
        assert jeval.main(argv + ["--dump", theirs, "--device", "jnp"]) == 0
    jrows = [r.args for r in caplog.records
             if r.getMessage().startswith("view ")]
    assert got["split"] == "all" and got["views"] == 2
    _check(got, jrows, capsys)
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names == [
        "depth_00000.png", "depth_00001.png", "eval_00000.png",
        "eval_00001.png"]
    for name in names:
        a, b = (image_util.decode_png(open(os.path.join(d, name), "rb")
                                      .read()).astype(int)
                for d in (ours, theirs))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name


def test_points_device_needs_a_card(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ply, cap = scene
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_app.run(["--input", ply, "--dataset", cap, "--device",
                      "points", "--log-level", "warn"])


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("split", ["holdout", "train", "all"])
@pytest.mark.parametrize("n", [0, 1, 7, 16])
def test_select_split_matches_jax(n, split, k):
    assert eval_app.select_split(n, split, k) == jeval.select_split(
        n, split, k)
