"""The port's sharded renderer and train step (parallel/distributed.py)
against the JAX package's on its 4-device CPU mesh, on the same weights:
both exchanges, uneven rows, grouped strips, a forced exchange overflow on
a 1-shard mesh (as tests/test_distributed.py:110-145), the port's
single-device render, the gradients of the sharded render and one sharded
train step. The port's shards all sit on the CPU (parallel/mesh.py).

Bars: images atol 1e-5 (the reference's own for its sharded frame against
its single-device one); pair counts, tile counts, visibility and overflow
counters equal; gradients atol 2e-4 / rtol 1e-3 (the whole-chain bar of
tests/test_torch_train.py); a train step's loss rtol 1e-5 and parameters
atol 1e-5, as the single-device steps there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.parallel import distributed as jdist
from gaussian_splat_ipu_tpu.parallel import mesh as jmesh
from gaussian_splat_ipu_tpu.render import binning as jbin
from gaussian_splat_ipu_tpu.render.projection import (
    project_gaussians as j_project)
from gaussian_splat_ipu_tpu.train import losses as jlosses
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

# 3x3 tiles of 32 px (tests/test_distributed.py's CFG); on 4 shards one
# strip is phantom.
CFG = RasterConfig(image_width=96, image_height=96, pair_capacity=1 << 13,
                   max_chunks_per_tile=8)
# 6x6 tiles of 16 px in groups of 3 with exact tiles: strips of 3 rows,
# two of the four phantom.
GROUPED = RasterConfig(image_width=96, image_height=96, tile_width=16,
                       tile_height=16, chunk_size=32, pair_capacity=1 << 13,
                       max_chunks_per_tile=8, tile_group=3,
                       exact_tile_test=True)
# 2 tile rows over 4 shards: two shards own only phantom rows.
UNEVEN = RasterConfig(image_width=64, image_height=64, pair_capacity=1 << 12,
                      max_chunks_per_tile=4)
ATOL = 1e-5


def scene(seed=0, n=256, extent=1.0, cfg=CFG):
    """The reference's test scene (tests/test_distributed.py::_scene) in
    both packages."""
    jm = JModel.random(jax.random.PRNGKey(seed), n, extent=extent)
    bb = np.ones(3, np.float32) * extent
    jc = JCamera.orbit(-bb, bb, fov_radians=np.radians(40.0),
                       aspect=cfg.image_width / cfg.image_height)
    tm = GaussianModel.from_numpy({k: np.asarray(getattr(jm, k))
                                   for k in FIELDS}, device="cpu")
    tc = Camera.from_numpy(np.asarray(jc.view), np.asarray(jc.proj),
                           device="cpu")
    return jm, jc, tm, tc


def both_meshes(d):
    return jmesh.make_mesh(d), mesh.make_mesh(d, device="cpu")


def assert_outputs_match(want, got):
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=ATOL)
    for name in ("tile_counts", "overflow", "num_pairs", "visible",
                 "exchange_overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("cfg", [CFG, GROUPED, UNEVEN],
                         ids=["even", "grouped", "uneven"])
@pytest.mark.parametrize("exchange", distributed.EXCHANGES)
def test_render_sharded_matches_jax(cfg, exchange):
    jm, jc, tm, tc = scene(seed=5, n=256, cfg=cfg)
    jmsh, tmsh = both_meshes(4)
    want = jdist.render_sharded(jmesh.shard_model(jm, jmsh), jc,
                                jax_config(cfg), jmsh, use_pallas=False,
                                pair_capacity=cfg.pair_capacity,
                                exchange=exchange)
    got = distributed.render_sharded(mesh.shard_model(tm, tmsh), tc, cfg,
                                     tmsh, pair_capacity=cfg.pair_capacity,
                                     exchange=exchange)
    assert_outputs_match(want, got)
    assert int(got.num_pairs) > 100 and int(got.truncated) == 0
    # And the port's single-device frame: the same pairs, the same image.
    single = render(tm, tc, cfg)
    np.testing.assert_allclose(got.image.numpy(), single.image.numpy(),
                               atol=ATOL)
    assert int(got.num_pairs) == int(single.num_pairs)
    np.testing.assert_array_equal(got.tile_counts[:cfg.num_tiles].numpy(),
                                  single.tile_counts.numpy())


def test_exchange_overflow_is_counted_on_a_one_shard_mesh():
    """tests/test_distributed.py:130-145: every splat routes to the one
    bucket of 128 rows, so the rows past it drop, counted exactly."""
    jm, jc, tm, tc = scene(seed=13, n=512, extent=0.2)
    jmsh, tmsh = both_meshes(1)
    kw = dict(pair_capacity=1 << 13, exchange_capacity=128)
    want = jdist.render_sharded(jmesh.shard_model(jm, jmsh), jc,
                                jax_config(CFG), jmsh, use_pallas=False,
                                **kw)
    got = distributed.render_sharded(mesh.shard_model(tm, tmsh), tc, CFG,
                                     tmsh, **kw)
    assert_outputs_match(want, got)
    sp = j_project(jm, jc, jax_config(CFG))
    _, _, nx, ny = jbin.tile_ranges_of(sp, jax_config(CFG))
    routed = int(np.sum(np.asarray((nx > 0) & (ny > 0))))
    assert routed > 128
    assert int(got.exchange_overflow) == routed - 128


def test_route_buckets_keep_gaussian_order():
    """A shard's send buffer: bucket j holds the rows bound for shard j in
    ascending gaussian order (pad rows zero), a splat spanning k strips in
    k buckets; rows past a bucket's cap, and pairs past the d * cap
    expansion table, are dropped and counted."""
    packed = torch.arange(1, 7, dtype=torch.float32)[:, None].repeat(1, 12)
    dest_lo = torch.tensor([0, 1, 1, 2, 1, 0], dtype=torch.int32)
    span = torch.tensor([2, 1, 1, 1, 2, 1], dtype=torch.int32)
    send, ovf = distributed._route_all_to_all(packed, dest_lo, span, 3, 3)
    # bucket 0: gaussians 0, 5; bucket 1: 0, 1, 2 (4 dropped); 2: 3, 4.
    assert send[:, 0].tolist() == [1, 6, 0, 1, 2, 3, 4, 5, 0]
    assert int(ovf) == 1
    # cap 2: the table keeps the first 6 of the 8 pairs, and bucket 1
    # keeps 2 of its 3.
    send, ovf = distributed._route_all_to_all(packed, dest_lo, span, 3, 2)
    assert send[:, 0].tolist() == [1, 0, 1, 2, 4, 0]
    assert int(ovf) == 4


def test_route_backward_is_the_gather_transpose():
    """_RouteGather's backward (each splat sums its send rows' cotangents
    by gathers) equals autograd's transpose of the plain row gather, with
    dropped pairs (cap 2 and a short table) and splats on 3 strips."""
    rng = np.random.default_rng(3)
    n, d = 40, 3
    dest_lo = torch.tensor(rng.integers(0, d, n), dtype=torch.int32)
    span = torch.tensor(np.minimum(rng.integers(0, 4, n),
                                   d - dest_lo.numpy()), dtype=torch.int32)
    base = torch.tensor(rng.normal(size=(n, 12)).astype(np.float32))
    for cap in (128, 8):
        packed = base.clone().requires_grad_()
        send, ovf = distributed._route_all_to_all(packed, dest_lo, span, d,
                                                  cap)
        with torch.no_grad():
            plain, _ = distributed._route_all_to_all(base, dest_lo, span, d,
                                                     cap)
        assert torch.equal(send.detach(), plain)
        cot = torch.tensor(rng.normal(size=send.shape).astype(np.float32))
        (got,) = torch.autograd.grad((send * cot).sum(), packed)
        # The transpose by brute force: each send row is one splat's row.
        match = (plain[:, None, :] == base[None, :, :]).all(-1)  # (P, n)
        want = match.to(torch.float32).T @ cot
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        assert (int(ovf) > 0) == (cap == 8)


@pytest.mark.parametrize("cap", [128, 8])
def test_demand_sized_route_is_the_fixed_route_without_pads(cap):
    """_route_by_demand (a process mesh's buckets, each as long as the
    rows it keeps) sends the fixed buckets' kept rows, in their order,
    without the pad rows, from the splats' columns or the packed rows; its
    transpose is the fixed route's, bit for bit,
    so also autograd's transpose of the plain row gather. Splats on up to
    3 of 4 strips; at cap 8 rows are dropped, as many as the fixed route
    counts."""
    rng = np.random.default_rng(4)
    n, d = 60, 4
    dest_lo = torch.tensor(rng.integers(0, d, n), dtype=torch.int32)
    span = torch.tensor(np.minimum(rng.integers(0, 4, n),
                                   d - dest_lo.numpy()), dtype=torch.int32)
    base = torch.tensor(rng.normal(size=(n, 12)).astype(np.float32))
    demand = distributed._bucket_demand(dest_lo, span, d)
    want_demand = [int(((dest_lo <= j) & (j < dest_lo + span)).sum())
                   for j in range(d)]
    assert demand.tolist() == want_demand
    sizes = [min(m, cap) for m in want_demand]

    fixed = base.clone().requires_grad_()
    fsend, fovf = distributed._route_all_to_all(fixed, dest_lo, span, d,
                                                max(want_demand))
    kept = torch.cat([b[:m] for b, m in zip(fsend.chunk(d), sizes)])
    sized = base.clone().requires_grad_()
    cols = list(sized.split([2, 1, 3, 3, 1, 2], dim=1))
    send = distributed._route_by_demand(cols, dest_lo, span, demand,
                                        want_demand, cap)
    assert torch.equal(send.detach(), kept.detach())
    assert int(fovf) == 0
    cot = torch.tensor(rng.normal(size=send.shape).astype(np.float32))
    (got,) = torch.autograd.grad((send * cot).sum(), sized)
    (want,) = torch.autograd.grad((kept * cot).sum(), fixed)
    assert torch.equal(got, want)
    assert (int(torch.clamp_min(demand - cap, 0).sum()) > 0) == (cap == 8)
    with torch.no_grad():
        plain = distributed._route_by_demand([base], dest_lo, span, demand,
                                             want_demand, cap)
    assert torch.equal(plain, send.detach())


def test_sharded_gradients_match_jax_and_single_device():
    jm, jc, tm, tc = scene(seed=6, n=64, cfg=UNEVEN)
    jmsh, tmsh = both_meshes(4)
    target = np.random.default_rng(0).uniform(
        0, 1, (64, 64, 4)).astype(np.float32)

    def jloss(m):
        img = jdist.render_image_sharded(m, jc, jax_config(UNEVEN), jmsh,
                                         use_pallas=False,
                                         pair_capacity=1 << 12)
        return jlosses.render_loss(img, jnp.asarray(target), 0.2)

    want = jax.grad(jloss)(jmesh.shard_model(jm, jmsh))
    sm = mesh.shard_model(tm, tmsh).trainable()
    loss = losses.render_loss(distributed.render_image_sharded(
        sm, tc, UNEVEN, tmsh, pair_capacity=1 << 12), torch.tensor(target),
        0.2)
    got = torch.autograd.grad(loss, tuple(sm.parameters()))
    single = tm.trainable()
    loss1 = losses.render_loss(render(single, tc, UNEVEN).image,
                               torch.tensor(target), 0.2)
    got1 = torch.autograd.grad(loss1, tuple(single.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss1.detach()),
                               rtol=1e-6)
    for name, g, g1 in zip(FIELDS, got, got1):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), g1.numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=name)
    assert float(got[0].abs().max()) > 1e-3


def test_one_sharded_train_step_matches_jax():
    jm, jc, tm, tc = scene(seed=8, n=128, cfg=UNEVEN)
    jmsh, tmsh = both_meshes(4)
    target = np.random.default_rng(1).uniform(
        0, 1, (64, 64, 4)).astype(np.float32)
    jtc = jtrainer.TrainConfig(ssim_weight=0.2)
    ttc = trainer.TrainConfig(ssim_weight=0.2)
    jstep = jdist.make_sharded_train_step(jmsh, jax_config(UNEVEN), jtc,
                                          use_pallas=False,
                                          pair_capacity=1 << 12)
    jstate = jtrainer.init_state(jmesh.shard_model(jm, jmsh), jtc)
    tstate = trainer.init_state(mesh.shard_model(tm, tmsh).trainable(), ttc)
    tstep = distributed.make_sharded_train_step(tmsh, UNEVEN, ttc,
                                                pair_capacity=1 << 12)
    for _ in range(2):
        jstate, jl = jstep(jstate, jc, jnp.asarray(target))
        tstate, tl = tstep(tstate, tc, torch.tensor(target))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    got = tstate.to_numpy()
    for i in range(5):
        np.testing.assert_allclose(got[i], want[i], atol=1e-5,
                                   err_msg=FIELDS[i])
    assert int(tstate.step) == 2


def test_mesh_helpers():
    m = mesh.make_mesh(3, device="cpu")
    assert m.shape == {"shard": 3} and m.size == 3
    assert not m.spans_devices and m.device == torch.device("cpu")
    m2 = mesh.make_mesh_2d(2, 2, device="cpu")
    assert m2.shape == {"view": 2, "shard": 2}
    assert m2.group(1).size == 2
    model = GaussianModel.random(10, generator=torch.Generator().manual_seed(
        0), device="cpu")
    sm = mesh.shard_model(model, m)
    assert sm.num_gaussians == 12
    assert float(sm.opacities[10:].max()) == -30.0
    with pytest.raises(ValueError, match="shard the model first"):
        distributed.render_sharded(model, Camera.orbit(
            -np.ones(3), np.ones(3), 0.7, 1.0, device="cpu"), CFG, m)
    g = m.group()
    xs = [torch.full((6, 2), float(i)) for i in range(3)]
    recv = g.all_to_all(xs)
    assert [r[:, 0].tolist() for r in recv] == [[0, 0, 1, 1, 2, 2]] * 3
    assert g.all_gather(xs)[2].shape == (18, 2)
    assert float(g.psum([torch.tensor(1.0)] * 3)) == 3.0
