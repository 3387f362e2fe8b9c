"""The port's small public helpers against their JAX counterparts on seeded
numpy inputs: ops/covariance.eigenvalues_2d and splat_radius (1e-6
relative), ops/sh.num_sh_coeffs, GaussianModel.astype, FrameSet.stacked
(with Camera.unbind) and train/checkpoint.gaussian_columns (exact), and
GaussianModel.clustered against the JAX draw by its statistics (torch
draws other bits, and each of its draws has a stream of its own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.io import dataset as jdataset
from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.ops import covariance as jcov
from gaussian_splat_ipu_tpu.ops import sh as jsh
from gaussian_splat_ipu_tpu.train import checkpoint as jcheckpoint
from gaussian_splat_ipu_tpu_torch.io import dataset
from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.ops import covariance, sh
from gaussian_splat_ipu_tpu_torch.parallel import distributed
from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
from gaussian_splat_ipu_tpu_torch.train import checkpoint
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

torch.set_num_threads(1)


def _abc(n=4096, seed=0):
    """2x2 covariances: positive definite ones, and some whose
    discriminant falls under the 0.1 floor."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 400.0, n).astype(np.float32)
    c = rng.uniform(0.3, 400.0, n).astype(np.float32)
    b = (rng.uniform(-0.95, 0.95, n) * np.sqrt(a * c)).astype(np.float32)
    a[:64] = c[:64] = rng.uniform(0.3, 2.0, 64).astype(np.float32)
    b[:64] = 0.0                       # isotropic: the floor decides
    return a, b, c


@pytest.mark.parametrize("floor", [0.1, 0.0, 2.5])
def test_eigenvalues_2d_matches_jax(floor):
    a, b, c = _abc()
    got = covariance.eigenvalues_2d(*(torch.from_numpy(x) for x in (a, b, c)),
                                    floor=floor)
    want = jcov.eigenvalues_2d(*(jnp.asarray(x) for x in (a, b, c)),
                               floor=floor)
    l1 = np.asarray(want[0])
    assert got[0].dtype == got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), l1, rtol=1e-6, atol=0)
    # The smaller one, mid - disc, cancels where disc is near mid: 1e-6
    # relative to the larger (the matrix's scale), as the two packages
    # round the last bit of disc apart.
    np.testing.assert_array_less(
        np.abs(got[1].numpy() - np.asarray(want[1])), 1e-6 * np.abs(l1))
    assert bool((got[0] >= got[1]).all())


def test_splat_radius_matches_jax():
    a, b, c = _abc(seed=1)
    got = covariance.splat_radius(*(torch.from_numpy(x) for x in (a, b, c)))
    want = np.asarray(jcov.splat_radius(*(jnp.asarray(x) for x in (a, b,
                                                                   c))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert bool((got == torch.ceil(got)).all()) and bool((got >= 1).all())


def test_num_sh_coeffs_matches_jax():
    for degree in range(5):
        assert sh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)
    assert [sh.num_sh_coeffs(d) for d in range(4)] == [1, 4, 9, 16]


def _params(n=300, sh_degree=2, seed=2):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    p = dict(means=rng.normal(size=(n, 3)),
             log_scales=rng.uniform(-5.0, -1.0, (n, 3)),
             quats=rng.normal(size=(n, 4)),
             opacities=rng.uniform(-6.0, 6.0, (n,)),
             sh=rng.uniform(-2.5, 2.5, (n, k, 3)))
    return {f: v.astype(np.float32) for f, v in p.items()}


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float16, jnp.float16),
                                          (torch.float32, jnp.float32)])
def test_astype_matches_jax(dtype, jdtype):
    p = _params()
    model = GaussianModel.from_numpy(p, "cpu")
    got = model.astype(dtype)
    want = JModel(**{f: jnp.asarray(p[f]) for f in FIELDS}).astype(jdtype)
    for f in FIELDS:
        t = getattr(got, f)
        assert t.dtype == dtype and not t.requires_grad
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(getattr(want, f).astype(
                jnp.float32)), err_msg=f)
    assert model.means.dtype == torch.float32       # the source is kept


def test_gaussian_columns_matches_jax():
    p = _params(sh_degree=3)
    got = checkpoint.gaussian_columns(GaussianModel.from_numpy(p, "cpu"))
    want = jcheckpoint.gaussian_columns(JModel(**{f: jnp.asarray(p[f])
                                                  for f in FIELDS}))
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    assert list(got) == list(scene_io.gaussian_columns(
        GaussianModel.from_numpy(p, "cpu")))


def _frame_sets(n=4, h=12, w=16, seed=3):
    rng = np.random.default_rng(seed)
    views = rng.normal(size=(n, 4, 4)).astype(np.float32)
    projs = rng.normal(size=(n, 4, 4)).astype(np.float32)
    rots = rng.normal(size=(n, 2)).astype(np.float32)
    images = [rng.random((h, w, 4)).astype(np.float32) for _ in range(n)]
    ours = dataset.FrameSet(
        cameras=[Camera.from_numpy(v, p, r, device="cpu")
                 for v, p, r in zip(views, projs, rots)],
        images=images, width=w, height=h)
    theirs = jdataset.FrameSet(
        cameras=[JCamera(jnp.asarray(v), jnp.asarray(p), jnp.asarray(r))
                 for v, p, r in zip(views, projs, rots)],
        images=images, width=w, height=h)
    return ours, theirs


def test_stacked_matches_jax():
    ours, theirs = _frame_sets()
    cams, images = ours.stacked("cpu")
    jcams, jimages = theirs.stacked()
    for name in ("view", "proj", "env_rot"):
        np.testing.assert_array_equal(getattr(cams, name).numpy(),
                                      np.asarray(getattr(jcams, name)),
                                      err_msg=name)
    assert images.dtype == torch.float32 and images.shape == (4, 12, 16, 4)
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
    # unbind gives back each frame's camera.
    views = cams.unbind()
    assert len(views) == 4
    for got, want in zip(views, ours.cameras):
        for name in ("view", "proj", "env_rot"):
            assert torch.equal(getattr(got, name), getattr(want, name))


def test_stacked_cameras_drive_the_view_batch_render():
    """FrameSet.stacked's cameras, unbound, render the view batch as the
    per-frame cameras do."""
    g = torch.Generator().manual_seed(4)
    model = GaussianModel.random(150, generator=g, device="cpu")
    cams = [Camera.orbit(-np.ones(3), np.ones(3), 0.7, 1.5, rot_y_deg=a,
                         device="cpu") for a in (0.0, 30.0)]
    fs = dataset.FrameSet(cameras=cams, images=[np.zeros((16, 24, 3),
                                                         np.float32)] * 2,
                          width=24, height=16)
    stacked, targets = fs.stacked("cpu")
    cfg = RasterConfig(image_width=24, image_height=16, tile_width=8,
                       tile_height=8, chunk_size=32, pair_capacity=4096)
    msh = mesh_lib.make_mesh_2d(2, 1, device="cpu")
    sm = mesh_lib.shard_model(model, msh)
    got = distributed.render_views_sharded(sm, stacked.unbind(), cfg, msh)
    want = distributed.render_views_sharded(sm, cams, cfg, msh)
    assert got.shape == (2, 16, 24, 4) and targets.shape == (2, 16, 24, 3)
    assert torch.equal(got, want)
    assert float(got[..., 3].max()) > 0.0


def _stats(means, log_scales, quats, opac, shc, centers, spread, assign,
           extent):
    """The statistics the test compares: log-scale mean and std, the
    opacity range and mean, the SH range, quaternion moments, and each
    populated cluster's spread (its offsets' rms) over its drawn spread."""
    off = means - centers[assign]
    ratio = []
    for k in range(centers.shape[0]):
        sel = assign == k
        if sel.sum() >= 400:
            ratio.append(np.sqrt(np.mean(off[sel] ** 2)) / spread[k])
    return dict(ls_mean=log_scales.mean(), ls_std=log_scales.std(),
                op_min=opac.min(), op_max=opac.max(), op_mean=opac.mean(),
                sh_min=shc.min(), sh_max=shc.max(), q_mean=quats.mean(),
                q_std=quats.std(), spread_min=spread.min() / extent,
                spread_max=spread.max() / extent,
                ratio=np.asarray(ratio))


def test_clustered_matches_the_jax_distributions():
    n, extent, k = 1 << 17, 2.0, 64
    g = torch.Generator().manual_seed(5)
    m = GaussianModel.clustered(n, generator=g, device="cpu", sh_degree=1,
                                extent=extent)
    assert m.sh.shape == (n, 4, 3) and m.num_gaussians == n
    # The centres, spreads and assignment are its first three draws.
    g = torch.Generator().manual_seed(5)
    centers = torch.rand((k, 3), generator=g) * 1.6 * extent - 0.8 * extent
    lo, hi = np.log(0.02 * extent), np.log(0.3 * extent)
    spread = torch.exp(torch.rand((k,), generator=g) * (hi - lo) + lo)
    assign = torch.randint(0, k, (n,), generator=g)
    p = m.to_numpy()
    got = _stats(p["means"], p["log_scales"], p["quats"], p["opacities"],
                 p["sh"], centers.numpy(), spread.numpy(), assign.numpy(),
                 extent)

    key = jax.random.PRNGKey(5)
    jm = JModel.clustered(key, n, n_clusters=k, sh_degree=1, extent=extent)
    k1, k2, k3 = jax.random.split(key, 7)[:3]
    jcenters = jax.random.uniform(k1, (k, 3), jnp.float32, -0.8 * extent,
                                  0.8 * extent)
    jspread = jnp.exp(jax.random.uniform(k2, (k,), jnp.float32,
                                         float(jnp.log(0.02 * extent)),
                                         float(jnp.log(0.3 * extent))))
    jassign = jax.random.randint(k3, (n,), 0, k)
    want = _stats(*(np.asarray(getattr(jm, f)) for f in FIELDS),
                  np.asarray(jcenters), np.asarray(jspread),
                  np.asarray(jassign), extent)

    # Tolerances: 5 standard errors of the difference of two independent
    # draws of this size (log-scales 3n samples of sd 0.6, opacities n of
    # sd 10/sqrt(12), quats 4n of sd 1).
    se = lambda sd, m: 5.0 * sd * np.sqrt(2.0 / m)
    assert abs(got["ls_mean"] - want["ls_mean"]) < se(0.6, 3 * n)
    assert abs(got["ls_mean"] - (-4.5 + np.log(extent))) < se(0.6, 3 * n)
    assert abs(got["ls_std"] - want["ls_std"]) < se(0.6 / np.sqrt(2), 3 * n)
    assert abs(got["ls_std"] - 0.6) < se(0.6 / np.sqrt(2), 3 * n)
    assert abs(got["op_mean"] - want["op_mean"]) < se(10 / np.sqrt(12), n)
    assert abs(got["q_mean"] - want["q_mean"]) < se(1.0, 4 * n)
    assert abs(got["q_std"] - want["q_std"]) < se(1 / np.sqrt(2), 4 * n)
    for s in (got, want):
        assert -4.0 <= s["op_min"] < -3.99 and 5.99 < s["op_max"] < 6.0
        assert -1.0 <= s["sh_min"] < -0.999 and 0.999 < s["sh_max"] < 1.0
        assert 0.02 - 1e-6 <= s["spread_min"] and s["spread_max"] <= 0.3 + 1e-6
        # Each populated cluster's rms offset is its spread, within the
        # sampling error of at least 1200 squared normals (sd sqrt(2)).
        assert len(s["ratio"]) >= 20
        assert np.abs(s["ratio"] - 1.0).max() < 5.0 * np.sqrt(2.0 / 1200)
