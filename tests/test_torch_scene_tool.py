"""The port's scene tool (gaussian_splat_ipu_tpu_torch.app.scene_tool)
against the JAX package's: every case of tests/test_scene_tool.py on the
port, each held to the JAX tool on the same weights where the JAX case
has a result, and the two CLIs on one seeded PLY with every flag: the
--stats lines equal as strings, the PLY columns bit-equal and the .splat
bytes equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.app import scene_tool as jtool
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.train import checkpoint as jcheckpoint
from gaussian_splat_ipu_tpu_torch.app import scene_tool
from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
from gaussian_splat_ipu_tpu_torch.io import splat as splat_io
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render.pipeline import render_image
from gaussian_splat_ipu_tpu_torch.train import checkpoint
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

torch.set_num_threads(1)


def _models(n=64, sh_degree=2, seed=0):
    """The JAX test's random model, and the port's copy of its weights."""
    jm = JModel.random(jax.random.PRNGKey(seed), n, sh_degree=sh_degree)
    p = {f: np.asarray(getattr(jm, f)) for f in FIELDS}
    return GaussianModel.from_numpy(p, "cpu"), jm


def _jmodel(p):
    return JModel(**{f: jnp.asarray(p[f]) for f in FIELDS})


def _same(model, jmodel):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(model, f).detach().numpy(),
                                      np.asarray(getattr(jmodel, f)),
                                      err_msg=f)


def test_process_prune_opacity():
    m, jm = _models()
    opac = 1.0 / (1.0 + np.exp(-m.opacities.numpy()))
    thresh = float(np.median(opac))
    out, report = scene_tool.process(m, prune_opacity=thresh)
    expect = int((opac >= thresh).sum())
    assert out.num_gaussians == expect
    assert report["pruned"] == 64 - expect
    idx = int(np.flatnonzero(opac >= thresh)[0])
    np.testing.assert_array_equal(out.means[0].numpy(), m.means[idx].numpy())
    jout, jreport = jtool.process(jm, prune_opacity=thresh)
    assert report == jreport
    _same(out, jout)


def test_process_prune_scale_and_sh_cap():
    m, _ = _models()
    p = m.to_numpy()
    p["log_scales"] = p["log_scales"].copy()
    p["log_scales"][3] = 10.0                 # one giant floater
    m = GaussianModel.from_numpy(p, "cpu")
    out, report = scene_tool.process(m, prune_scale=1.0, max_sh=0)
    assert out.num_gaussians == 63
    assert report["pruned"] == 1
    assert out.sh_degree == 0 and out.sh.shape[1] == 1
    jout, jreport = jtool.process(_jmodel(p), prune_scale=1.0, max_sh=0)
    assert report == jreport
    _same(out, jout)


def test_cli_roundtrip(tmp_path, capsys):
    m, _ = _models()
    src = str(tmp_path / "in.ply")
    dst = str(tmp_path / "out.ply")
    splat = str(tmp_path / "out.splat")
    checkpoint.export_ply(src, m)
    rc = scene_tool.main([
        "--input", src, "--output", dst, "--output-splat", splat,
        "--max-sh", "1", "--stats", "--log-level", "off",
    ], device="cpu")
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["gaussians"] == 64 and stats["sh_degree"] == 1
    back = checkpoint.import_ply(dst, device="cpu")
    assert back.num_gaussians == 64 and back.sh_degree == 1
    assert splat_io.count_records(splat) == 64


def test_center_flip():
    # The bounding-box midpoint goes to the origin and z is negated
    # (reference preprocessing, splat.cpp:92-100); quats and SH bands are
    # mirrored with it, as the JAX tool does.
    m, jm = _models()
    out, _ = scene_tool.process(m, center_flip=True)
    pts = out.means.numpy()
    np.testing.assert_allclose((pts.min(0) + pts.max(0)) * 0.5, 0.0,
                               atol=1e-5)
    src = m.means.numpy()
    centred = src - (src.min(0) + src.max(0)) * 0.5
    np.testing.assert_allclose(pts[:, 2], -centred[:, 2], atol=1e-6)
    jout, _ = jtool.process(jm, center_flip=True)
    _same(out, jout)


def test_cli_does_not_recentre_input(tmp_path):
    """The file tool loads raw: outputs stay in the input's frame."""
    m, _ = _models()
    p = m.to_numpy()
    p["means"] = p["means"] + np.array([10.0, 0.0, 5.0], np.float32)
    shifted = GaussianModel.from_numpy(p, "cpu")
    src = str(tmp_path / "in.ply")
    dst = str(tmp_path / "out.ply")
    checkpoint.export_ply(src, shifted)
    rc = scene_tool.main(["--input", src, "--output", dst,
                          "--log-level", "off"], device="cpu")
    assert rc == 0
    back = checkpoint.import_ply(dst, device="cpu")
    np.testing.assert_allclose(back.means.numpy(), p["means"], atol=1e-5)


def test_center_flip_preserves_appearance():
    """Mirroring the scene through z (means + quats + SH) and viewing it
    with the mirrored camera reproduces the original image: this fails if
    quats or SH bands are left as they were."""
    m, _ = _models(n=48, sh_degree=2, seed=3)
    cam = Camera.look_at([0.4, 0.3, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                         np.radians(50.0), 1.0, device="cpu")
    cfg = RasterConfig(image_width=32, image_height=32,
                       pair_capacity=1 << 11, max_chunks_per_tile=4,
                       sigmoid_opacity=True)
    ref = render_image(m, cam, cfg)
    out, _ = scene_tool.process(m, center_flip=True)
    # The tool's world map is x' = F (x - c), F = diag(1, 1, -1), c the
    # bbox midpoint: view the mirrored scene through V' = V @ [[F, c],
    # [0, 1]].
    src = m.means.numpy()
    c = (src.min(0) + src.max(0)) * 0.5
    minv = np.eye(4, dtype=np.float32)
    minv[:3, :3] = np.diag([1.0, 1.0, -1.0])
    minv[:3, 3] = c
    cam2 = Camera.from_numpy(cam.view.numpy() @ minv, cam.proj.numpy(),
                             device="cpu")
    got = render_image(out, cam2, cfg)
    assert float(ref[..., 3].max()) > 0.1
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


def test_stats_empty_after_prune(tmp_path, capsys):
    m, _ = _models()
    p = m.to_numpy()
    p["opacities"] = np.full((64,), -20.0, np.float32)   # sigmoid ~ 0
    src = str(tmp_path / "in.ply")
    checkpoint.export_ply(src, GaussianModel.from_numpy(p, "cpu"))
    rc = scene_tool.main(["--input", src, "--prune-opacity", "0.5",
                          "--stats", "--log-level", "off"], device="cpu")
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["gaussians"] == 0
    assert jtool.main(["--input", src, "--prune-opacity", "0.5",
                       "--stats", "--log-level", "off"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == line


@pytest.mark.parametrize("flags", [
    ["--prune-opacity", "0.3", "--prune-scale", "0.5", "--max-sh", "1",
     "--center-flip"],
    ["--prune-opacity", "0.2", "--max-sh", "3", "--center-flip"],
    ["--prune-scale", "0.013", "--max-sh", "-1"],
])
def test_cli_matches_jax(tmp_path, capsys, flags):
    """Both CLIs on one seeded SH-degree-2 PLY with every flag: the stats
    lines equal as strings, the PLYs' columns bit-equal (the same names in
    the same order) and the .splat files byte-equal."""
    m, _ = _models(n=500, sh_degree=2, seed=7)
    src = str(tmp_path / "in.ply")
    checkpoint.export_ply(src, m)
    lines, plys, splats = [], [], []
    for tag, run in (("port", lambda a: scene_tool.main(a, device="cpu")),
                     ("jax", jtool.main)):
        plys.append(str(tmp_path / f"{tag}.ply"))
        splats.append(str(tmp_path / f"{tag}.splat"))
        assert run(["--input", src, *flags, "--output", plys[-1],
                    "--output-splat", splats[-1], "--stats",
                    "--log-level", "off"]) == 0
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines[0] == lines[1]
    stats = json.loads(lines[0])
    assert 0 < stats["gaussians"] < 500
    got, want = (ply_io.read_ply(p)["vertex"] for p in plys)
    assert [n for n, _ in got.properties] == [n for n, _ in want.properties]
    for name, _ in got.properties:
        np.testing.assert_array_equal(got.column(name), want.column(name),
                                      err_msg=name)
    with open(splats[0], "rb") as a, open(splats[1], "rb") as b:
        assert a.read() == b.read()
    assert splat_io.count_records(splats[0]) == stats["gaussians"]
    # The JAX package reads the port's PLY back to the same model.
    back = checkpoint.import_ply(plys[0], device="cpu")
    _same(back, jcheckpoint.import_ply(plys[1]))


def test_process_keeps_the_model_on_its_device():
    m, _ = _models(n=16, sh_degree=1)
    for kw in (dict(), dict(prune_opacity=0.5), dict(max_sh=0),
               dict(center_flip=True)):
        out, _ = scene_tool.process(m, **kw)
        assert out.device == m.device
        assert all(not getattr(out, f).requires_grad for f in FIELDS)
