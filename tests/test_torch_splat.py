"""The port's .splat IO (gaussian_splat_ipu_tpu_torch.io.splat) against the
JAX package's: write_splat writes the same bytes for the same model
(importance order and u8 quantisation included), read_splat (whole and a
row range), count_records, and load_scene of a .splat equal JAX's exactly;
the train CLI's --export-splat writes what the app then loads."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_splat_ipu_tpu.io import scene as jscene
from gaussian_splat_ipu_tpu.io import splat as jsplat
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu_torch.app import train as train_app
from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
from gaussian_splat_ipu_tpu_torch.io import splat
from gaussian_splat_ipu_tpu_torch.io.scene import load_scene, write_ply
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)

torch.set_num_threads(1)


def _model(n, sh_degree, seed):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    p = dict(means=rng.normal(size=(n, 3)),
             log_scales=rng.uniform(-5.0, -1.0, (n, 3)),
             quats=rng.normal(size=(n, 4)),
             opacities=rng.uniform(-6.0, 6.0, (n,)),
             sh=rng.uniform(-2.5, 2.5, (n, k, 3)))
    p = {f: v.astype(np.float32) for f, v in p.items()}
    p["quats"][0] = 0.0                 # a zero quaternion is written too
    return (GaussianModel.from_numpy(p, "cpu"),
            JModel(**{f: jnp.asarray(v) for f, v in p.items()}))


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("n,sh_degree", [(1, 0), (257, 0), (300, 2)])
def test_write_splat_bytes_match_jax(tmp_path, n, sh_degree, sort):
    model, jmodel = _model(n, sh_degree, seed=n)
    ours, theirs = str(tmp_path / "t.splat"), str(tmp_path / "j.splat")
    splat.write_splat(ours, model, sort_by_importance=sort)
    jsplat.write_splat(theirs, jmodel, sort_by_importance=sort)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        got, want = a.read(), b.read()
    assert len(got) == n * splat.RECORD_BYTES
    assert got == want
    assert splat.count_records(ours) == jsplat.count_records(theirs) == n


@pytest.mark.parametrize("row_range", [None, (0, 10), (37, 120),
                                       (250, 400)])
def test_read_splat_matches_jax(tmp_path, row_range):
    _, jmodel = _model(300, 1, seed=3)
    path = str(tmp_path / "m.splat")
    jsplat.write_splat(path, jmodel)
    got = splat.read_splat(path, row_range)
    want = jsplat.read_splat(path, row_range)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_read_splat_refuses_bad_input(tmp_path):
    path = tmp_path / "bad.splat"
    path.write_bytes(b"\0" * 33)
    with pytest.raises(ValueError, match="not a .splat file"):
        splat.read_splat(str(path))
    path.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="bad row_range"):
        splat.read_splat(str(path), (3, 1))


def test_load_scene_of_a_splat_matches_jax(tmp_path):
    _, jmodel = _model(400, 0, seed=9)
    path = str(tmp_path / "scene.splat")
    jsplat.write_splat(path, jmodel)
    got = load_scene(path, device="cpu")
    want = jscene.load_scene(path)
    assert got.num_gaussians == want.num_gaussians == 400
    np.testing.assert_array_equal(got.bb_min, want.bb_min)
    np.testing.assert_array_equal(got.bb_max, want.bb_max)
    for k, v in got.model.to_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want.model, k)),
                                      err_msg=k)
    fields = ply_io.load_points(path)
    assert set(fields) == {"means", "log_scales", "quats", "opacity",
                           "f_dc"}


def test_train_cli_exports_a_splat_the_app_loads(tmp_path):
    ply = str(tmp_path / "scene.ply")
    model = GaussianModel.random(200, generator=torch.Generator().manual_seed(
        1), device="cpu")
    with torch.no_grad():
        model.log_scales += 1.0
    write_ply(ply, model)
    out = str(tmp_path / "out.splat")
    stats = train_app.run(["--input", ply, "--width", "48", "--height",
                           "32", "--views", "2", "--steps", "2", "--device",
                           "cpu", "--log-level", "warn", "--init-gaussians",
                           "150", "--export-splat", out])
    assert stats["step"] == 2 and splat.count_records(out) == 150
    back = load_scene(out, device="cpu")
    assert back.num_gaussians == 150
    assert all(np.isfinite(getattr(back.model, k).numpy()).all()
               for k in FIELDS)
