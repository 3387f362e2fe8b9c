"""The port's COLMAP loader (gaussian_splat_ipu_tpu_torch.io.colmap) and
GaussianModel.from_points against the JAX package on the same files:
binary and text models in every layout, pre-downscaled images_K
directories and loader resizing, every camera model's pinhole block, the
distortion warning, the mixed-resolution error and the SfM depth
observations. Cameras within 1e-6 of JAX's, images and points equal;
from_points equal field by field except log_scales (LOG_SCALE_ATOL)."""

import logging
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from PIL import Image

from gaussian_splat_ipu_tpu.io import colmap as jcolmap
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.models.gaussians import (
    mean_knn_distance as j_knn)
from gaussian_splat_ipu_tpu_torch.io import colmap
from gaussian_splat_ipu_tpu_torch.models.gaussians import (
    FIELDS, GaussianModel, mean_knn_distance)

from _torch_posed import orbit_w2c, write_colmap

W, H = 24, 18


def _capture(root, n=4, seed=0, w=W, h=H, **kw):
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for _ in range(n)]
    intr = [(20.0 + i, 21.0 - i, w / 2 + 0.25 * i, h / 2 - 0.5)
            for i in range(n)]
    xyz = rng.uniform(-1.0, 1.0, (9, 3))
    rgb = rng.integers(0, 256, (9, 3))
    return write_colmap(str(root), images, orbit_w2c(n, radius=3.0), intr,
                        xyz, rgb, **kw)


def _same(got, want, downscale=1):
    fs, xyz, rgb = got
    jfs, jxyz, jrgb = want
    assert len(fs) == len(jfs) and (fs.width, fs.height) == (jfs.width,
                                                             jfs.height)
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)
    for a, b in zip(fs.cameras, jfs.cameras):
        assert np.isfinite(a.view.numpy()).all()
        np.testing.assert_allclose(a.view.numpy(), np.asarray(b.view),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(a.proj.numpy(), np.asarray(b.proj),
                                   atol=1e-6, rtol=0)
    for a, b in zip(fs.images, jfs.images):
        if downscale == 1:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1.0 / 255.0 + 1e-7)


@pytest.mark.parametrize("layout", ["sparse0", "sparse", "flat"])
@pytest.mark.parametrize("binary", [True, False])
def test_capture_matches_jax(tmp_path, binary, layout):
    root = _capture(tmp_path, binary=binary, layout=layout)
    assert colmap.is_colmap_dir(root) and jcolmap.is_colmap_dir(root)
    got = colmap.load_colmap(root, device="cpu")
    _same(got, jcolmap.load_colmap(root))
    assert len(got[0]) == 4 and got[1].shape == (9, 3)


def test_sparse_dir_given_directly_and_detection(tmp_path):
    root = _capture(tmp_path)
    sparse = os.path.join(root, "sparse", "0")
    _same(colmap.load_colmap(sparse, device="cpu"),
          jcolmap.load_colmap(sparse))
    assert colmap.find_sparse_dir(root) == jcolmap.find_sparse_dir(root)
    assert not colmap.is_colmap_dir(str(tmp_path / "images"))


def test_text_equals_binary(tmp_path):
    fb, xb, cb = colmap.load_colmap(_capture(tmp_path / "b"), device="cpu")
    ft, xt, ct = colmap.load_colmap(_capture(tmp_path / "t", binary=False),
                                    device="cpu")
    np.testing.assert_array_equal(xb, xt)
    np.testing.assert_array_equal(cb, ct)
    for a, b in zip(fb.cameras, ft.cameras):
        np.testing.assert_allclose(a.view.numpy(), b.view.numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("predownscaled", [True, False])
def test_downscale_matches_jax(tmp_path, predownscaled):
    root = _capture(tmp_path, w=25, h=19)
    if predownscaled:
        pre = os.path.join(root, "images_2")
        os.makedirs(pre)
        for name in sorted(os.listdir(os.path.join(root, "images"))):
            Image.fromarray(np.full((9, 12, 3), 200, np.uint8)).save(
                os.path.join(pre, name))
    got = colmap.load_colmap(root, downscale=2, device="cpu")
    _same(got, jcolmap.load_colmap(root, downscale=2), downscale=2)
    assert (got[0].width, got[0].height) == (12, 9)
    if predownscaled:
        np.testing.assert_allclose(got[0].images[0], 200 / 255.0,
                                   atol=1e-6)


@pytest.mark.parametrize("model_id", sorted(colmap._CAMERA_MODELS))
def test_every_camera_model_matches_jax(model_id):
    name, n = colmap._CAMERA_MODELS[model_id]
    params = np.arange(1.0, n + 1.0) * 3.5
    assert colmap._pinhole(name, params) == jcolmap._pinhole(name, params)
    block = 3 if name in colmap._SINGLE_FOCAL else 4
    assert colmap._pinhole(name, params).has_distortion == (n > block)


def test_distortion_warns_once_and_matches_jax(tmp_path, caplog):
    models = [("OPENCV", [20.0, 21.0, 12.0, 9.0, 0.01, 0.0, 0.0, 0.0]),
              ("SIMPLE_RADIAL", [19.0, 12.0, 9.0, 0.02]),
              ("SIMPLE_PINHOLE", [19.0, 12.0, 9.0]),
              ("RADIAL", [18.0, 12.0, 9.0, 0.0, 0.0])]
    root = _capture(tmp_path, models=models)
    with caplog.at_level(logging.WARNING):
        got = colmap.load_colmap(root, device="cpu")
    warned = [r for r in caplog.records if "distortion" in r.getMessage()
              and r.name == colmap.__name__]
    assert len(warned) == 1 and "OPENCV" in warned[0].getMessage()
    _same(got, jcolmap.load_colmap(root))


def test_mixed_resolutions_are_refused(tmp_path):
    root = _capture(tmp_path)
    Image.fromarray(np.zeros((H + 2, W, 3), np.uint8)).save(
        os.path.join(root, "images", "view_002.png"))
    with pytest.raises(ValueError, match="mixed image resolutions"):
        colmap.load_colmap(root, device="cpu")
    with pytest.raises(ValueError, match="mixed image resolutions"):
        jcolmap.load_colmap(root)


@pytest.mark.parametrize("binary", [True, False])
def test_depth_observations_match_jax(tmp_path, binary):
    """with_depth: the SfM tracks each view observes as [u, v, z], at the
    decoded resolution (downscale 2 here), -1 and unknown ids dropped."""
    rng = np.random.default_rng(4)
    pts2d = [[(float(rng.uniform(0, W)), float(rng.uniform(0, H)), pid)
              for pid in (1, -1, 3, 42, 9, 5)] for _ in range(4)]
    root = _capture(tmp_path, binary=binary, pts2d=pts2d)
    fs, xyz, rgb, obs = colmap.load_colmap(root, downscale=2,
                                           with_depth=True, device="cpu")
    jfs, jxyz, jrgb, jobs = jcolmap.load_colmap(root, downscale=2,
                                                with_depth=True)
    _same((fs, xyz, rgb), (jfs, jxyz, jrgb), downscale=2)
    assert len(obs) == len(jobs) == 4
    for a, b in zip(obs, jobs):
        assert a.dtype == np.float32 and a.shape[1] == 3
        np.testing.assert_array_equal(a, b)
    assert sum(len(o) for o in obs) > 0
    imgs = colmap.read_model(colmap.find_sparse_dir(root),
                             with_points2d=True)[1]
    for im in imgs.values():
        assert -1 not in im.point3d_ids.tolist()


# -- from_points ----------------------------------------------------------
# The k-nn squared distances are |a|^2 + |b|^2 - 2 a.b in f32, summed by
# XLA in one order and by torch in another: each term of size |x|^2 <= 3
# rounds at 2^-24 |x|^2, so a squared distance d^2 carries an error of a
# few 1e-7 and log(d) = log(d^2) / 2 one of about 1e-7 / d^2. The nearest
# neighbours of these clouds lie at d >= 0.03, hence the 2e-4 bound.
LOG_SCALE_ATOL = 2e-4


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
            rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("n,sh_degree", [(1, 0), (2, 1), (70, 3),
                                         (1500, 2)])
def test_from_points_matches_jax(n, sh_degree):
    xyz, rgb = _cloud(n, seed=n)
    got = GaussianModel.from_points(xyz, rgb, sh_degree=sh_degree,
                                    device="cpu").to_numpy()
    want = JModel.from_points(xyz, rgb, sh_degree=sh_degree)
    for k in FIELDS:
        ref = np.asarray(getattr(want, k))
        assert got[k].shape == ref.shape and got[k].dtype == ref.dtype, k
        if k == "log_scales":
            np.testing.assert_allclose(got[k], ref, atol=LOG_SCALE_ATOL,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(got[k], ref, err_msg=k)
    assert np.isfinite(got["log_scales"]).all()


def test_knn_distance_matches_jax_and_brute_force():
    xyz, _ = _cloud(300, seed=5)
    got = mean_knn_distance(torch.tensor(xyz), k=3, chunk=64).numpy()
    want = np.asarray(j_knn(jnp.asarray(xyz), k=3, chunk=64))
    full = np.linalg.norm(xyz[:, None].astype(np.float64)
                          - xyz[None, :], axis=-1)
    np.fill_diagonal(full, np.inf)
    exact = np.sort(full, axis=1)[:, :3].mean(axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5)


def test_from_points_refuses_an_empty_cloud():
    with pytest.raises(ValueError, match="empty point cloud"):
        GaussianModel.from_points(np.zeros((0, 3)), np.zeros((0, 3)),
                                  device="cpu")


def test_rotmat_to_qvec_inverts_qvec_to_rotmat():
    """The writer's pose conversion, at random rotations and at the half
    turns where a trace-based formula divides by zero."""
    rng = np.random.default_rng(6)
    qs = [q / np.linalg.norm(q) for q in rng.normal(size=(20, 4))]
    qs += [np.array(v, float) for v in ((0, 1, 0, 0), (0, 0, 1, 0),
                                         (0, 0, 0, 1), (1, 0, 0, 0))]
    for q in qs:
        q = q * np.sign(q[0]) if q[0] != 0 else q
        r = colmap.qvec_to_rotmat(q)
        back = colmap.rotmat_to_qvec(r)
        np.testing.assert_allclose(colmap.qvec_to_rotmat(back), r,
                                   atol=1e-12)
        np.testing.assert_allclose(jcolmap.qvec_to_rotmat(back), r,
                                   atol=1e-12)
