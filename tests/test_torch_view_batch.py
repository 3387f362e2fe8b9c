"""The view-batch path of the port (parallel/distributed.py::
render_views_sharded and make_view_batch_train_step) against the JAX
package's on a (2 view groups, 4 shards) mesh, the reference's own test
layout (tests/test_view_batch.py): the batch of images, the summed drop
counters, one batched step, and the batched gradient against the mean of
the port's per-view single-device gradients. Bars as in
tests/test_torch_distributed.py: images atol 1e-5, counters equal, the
step's loss rtol 1e-5 and parameters atol 1e-5, gradients atol 2e-4 /
rtol 1e-3."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.parallel import distributed as jdist
from gaussian_splat_ipu_tpu.parallel import mesh as jmesh
from gaussian_splat_ipu_tpu.train import trainer as jtrainer
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.parallel import distributed, mesh
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.train import losses, trainer
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests.test_torch_config import jax_config

torch.set_num_threads(1)

# 2x4 tiles of 32 px: one tile row per shard.
CFG = RasterConfig(image_width=64, image_height=128, pair_capacity=1 << 12,
                   max_chunks_per_tile=4)


def scene(n=128, seed=0):
    """The reference's 4-view scene in both packages."""
    jm = JModel.random(jax.random.PRNGKey(seed), n)
    bb = np.ones(3, np.float32)
    jcams = [JCamera.orbit(-bb, bb, fov_radians=np.radians(40.0), aspect=0.5,
                           rot_y_deg=90.0 * i) for i in range(4)]
    tm = GaussianModel.from_numpy({k: np.asarray(getattr(jm, k))
                                   for k in FIELDS}, device="cpu")
    tcams = [Camera.from_numpy(np.asarray(c.view), np.asarray(c.proj),
                               device="cpu") for c in jcams]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *jcams)
    return jm, batch, tm, tcams


def meshes():
    return (jmesh.make_mesh_2d(num_views=2, num_shards=4),
            mesh.make_mesh_2d(2, 4, device="cpu"))


def test_view_batch_render_matches_jax_and_per_view_renders():
    jm, batch, tm, tcams = scene()
    jmsh, tmsh = meshes()
    want, jstats = jdist.render_views_sharded(
        jmesh.shard_model(jm, jmsh), batch, jax_config(CFG), jmsh,
        use_pallas=False, pair_capacity=1 << 12, with_stats=True)
    got, stats = distributed.render_views_sharded(
        mesh.shard_model(tm, tmsh), tcams, CFG, tmsh, pair_capacity=1 << 12,
        with_stats=True)
    assert got.shape == (4, 128, 64, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for k in ("exchange_overflow", "overflow"):
        assert int(stats[k]) == int(jstats[k]) == 0, k
    assert int(stats["truncated"]) == 0
    for i, cam in enumerate(tcams):
        np.testing.assert_allclose(got[i].numpy(),
                                   render(tm, cam, CFG).image.numpy(),
                                   atol=1e-5, err_msg=f"view {i}")


def test_view_batch_drop_counters_match_jax():
    """A starved pair table (128 per shard) and exchange bucket (128 rows,
    1024 splats on each of 4 shards): the counters add up over both mesh
    axes and every view, as the reference's psum does."""
    jm, batch, tm, tcams = scene(n=4096, seed=2)
    jmsh, tmsh = meshes()
    kw = dict(pair_capacity=128, exchange_capacity=128)
    _, jstats = jdist.render_views_sharded(
        jmesh.shard_model(jm, jmsh), batch, jax_config(CFG), jmsh,
        use_pallas=False, with_stats=True, **kw)
    _, stats = distributed.render_views_sharded(
        mesh.shard_model(tm, tmsh), tcams, CFG, tmsh, with_stats=True, **kw)
    assert int(stats["overflow"]) == int(jstats["overflow"]) > 0
    assert int(stats["exchange_overflow"]) == int(
        jstats["exchange_overflow"]) > 0


def test_view_batch_step_matches_jax():
    jm, batch, tm, tcams = scene(seed=1)
    jmsh, tmsh = meshes()
    targets = np.random.default_rng(0).uniform(
        0, 1, (4, 128, 64, 4)).astype(np.float32)
    jtc = jtrainer.TrainConfig(ssim_weight=0.2)
    ttc = trainer.TrainConfig(ssim_weight=0.2)
    jstep = jdist.make_view_batch_train_step(jmsh, jax_config(CFG), jtc,
                                             use_pallas=False,
                                             pair_capacity=1 << 12)
    jstate = jtrainer.init_state(jmesh.shard_model(jm, jmsh), jtc)
    jstate, jl, jstats = jstep(jstate, batch, jnp.asarray(targets))
    tstate = trainer.init_state(mesh.shard_model(tm, tmsh).trainable(), ttc)
    step = distributed.make_view_batch_train_step(tmsh, CFG, ttc,
                                                  pair_capacity=1 << 12)
    loss, stats = step(tstate, tcams, torch.tensor(targets))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert stats.tolist() == [0, 0, 0]
    assert int(jstats["exchange_overflow"]) == int(jstats["overflow"]) == 0
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    got = tstate.to_numpy()
    for i in range(5):
        np.testing.assert_allclose(got[i], want[i], atol=1e-5,
                                   err_msg=FIELDS[i])
    assert int(tstate.step) == 1


def test_view_batch_grads_are_the_mean_of_per_view_grads():
    """The view groups read one set of parameters, so autograd sums their
    gradients once: the batch gradient is the mean of the four views'
    single-device gradients."""
    _, _, tm, tcams = scene(n=64, seed=3)
    _, tmsh = meshes()
    targets = torch.zeros((4, 128, 64, 4))
    single = tm.trainable()
    per_view = [torch.autograd.grad(
        losses.render_loss(render(single, c, CFG).image, t, 0.0),
        tuple(single.parameters())) for c, t in zip(tcams, targets)]
    sm = mesh.shard_model(tm, tmsh).trainable()
    images = distributed.render_views_sharded(sm, tcams, CFG, tmsh,
                                              pair_capacity=1 << 12)
    loss = torch.mean(torch.stack([losses.render_loss(im, t, 0.0)
                                   for im, t in zip(images, targets)]))
    got = torch.autograd.grad(loss, tuple(sm.parameters()))
    for name, g, *gv in zip(FIELDS, got, *per_view):
        np.testing.assert_allclose(g.numpy(), (sum(gv) / 4.0).numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=name)
    assert float(got[0].abs().max()) > 1e-4
