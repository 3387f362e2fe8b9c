"""The city-sharded4-fit cell's step on the CPU, small: four processes in a
gloo group (tests/_city_sharded_child.py, each under its own time limit)
each draw their shard of the rubble-40m city from the seed, render it
sharded and run one step of the sharded train step the benchmark's
sharded_fit driver registers, on a drone view. Held to the plain
reference on the whole model (splatbench/reference/sharded_fit.py): the
target and the start's image, the loss, and each field's gradient. A
second case holds each shard a process drew to the rows of the whole
model's draw. The process mesh sizes each exchange bucket by its demand:
its frames, loss and gradients are held to the bit to the in-process
4-shard mesh's, whose buckets are fixed and mostly pads, and its counters
show that it sends and receives no pad row."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from tests.test_torch_multihost import REPO, _free_port

sys.path.insert(0, REPO)
from splatbench import city  # noqa: E402
from splatbench.drivers import fit  # noqa: E402
from splatbench.reference import sharded_fit as refs  # noqa: E402

CHILD = os.path.join(REPO, "tests", "_city_sharded_child.py")
TIMEOUT_S = 240
WORLD = 4
SEED = 2_200_000_031
VIEW = 1
# The frame: the program's kernels' plain versions composite one gaussian
# at a time, the reference by a cumulative product over blocks (its
# docstring): pixels agree to rounding, as the one-card frames do in
# splatbench/tests/test_splatbench_reference.py (1e-5).
IMAGE_ATOL = 1e-5
# The loss: a mean over the frame of those pixels (the same test's 1e-5).
LOSS_RTOL = 1e-5
# The gradients: the same sums in other orders (the exchange's transpose
# adds a splat's strips, the pair table adds its pairs), elementwise as
# the one-card step is held there.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-7


def _small():
    """rubble-40m's config and city-fit's traffic at 4 x 4,096 gaussians,
    SH 3, 256x192 in 16 px tiles (12 tile rows: a strip of 3 per
    process), the scales raised so that each splat covers pixels."""
    with open(os.path.join(REPO, "splatbench", "configs",
                           "rubble-40m.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "splatbench", "traffic",
                           "city-fit.json")) as f:
        traffic = json.load(f)
    config = copy.deepcopy(config)
    config["scene"].update(gaussians=WORLD * 4096, clusters=256,
                           scale_shift=0.5)
    config["raster"].update(image_width=256, image_height=192,
                            tile_width=16, tile_height=16)
    traffic["views_per_ring"] = 2
    return config, traffic


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("city")
    config, traffic = _small()
    conf = tmp / "conf.json"
    conf.write_text(json.dumps(dict(config=config, traffic=traffic,
                                    seed=SEED, view=VIEW)))
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp / f"rank{r}.pt") for r in range(WORLD)]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(r), str(WORLD), coord, outs[r],
         str(conf)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1][-2000:] for p in procs]
        pytest.fail(f"a process outlived {TIMEOUT_S} s: {errs}")
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0 and out.strip().endswith("OK"), err[-3000:]
    return config, traffic, [torch.load(o) for o in outs]


@pytest.fixture(scope="module")
def reference(children):
    config, traffic, _ = children
    rc = config["raster"]
    cam = city.drone_cameras(config, traffic, "cpu")[VIEW]
    gt = city.make_scene(config["scene"], SEED, "cpu")
    init = city.make_scene(config["scene"], SEED, "cpu",
                           start=traffic["perturb"])
    target = refs.render(gt, *cam, rc)["image"]
    image = refs.render(init, *cam, rc)["image"]
    tc = fit.train_settings(config, traffic)
    loss, grads, _ = refs.loss_and_grads(init, *cam, target, rc,
                                         tc["ssim_weight"])
    return dict(target=target, image=image, loss=float(loss), grads=grads)


@pytest.fixture(scope="module")
def in_process(children):
    """The children's renders and step on the in-process 4-shard mesh
    (parallel/mesh.py: fixed buckets of nloc rows) over the whole model,
    one thread as the children."""
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.parallel import distributed, mesh
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    from splatbench import harness
    from splatbench.drivers import sharded_fit
    config, traffic, outs = children
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        msh = mesh.make_mesh(WORLD, device="cpu")
        cam = Camera(*city.drone_cameras(config, traffic, "cpu")[VIEW])
        cfg = harness.raster_config(config, outs[0]["pair_capacity"])
        gt = city.make_scene(config["scene"], SEED, "cpu")
        init = city.make_scene(config["scene"], SEED, "cpu",
                               start=traffic["perturb"])
        with torch.no_grad():
            target, image = (distributed.render_sharded(
                GaussianModel(*(m[k] for k in city.FIELDS)), cam, cfg,
                msh).image for m in (gt, init))
        tcfg = trainer.TrainConfig(**fit.train_settings(config, traffic))
        state = trainer.init_state(GaussianModel(
            *(init[k].clone() for k in city.FIELDS), requires_grad=True),
            tcfg)
        engine = RenderEngine(RuntimeConfig(device="cpu"))
        trainer.register_step(engine, state, cam, target, cfg, tcfg,
                              step_fn=sharded_fit.build_step(msh, cfg, tcfg),
                              eager=sharded_fit.EAGER)
        loss, stats = engine.run(trainer.STEP_PROGRAM, state, cam, target)
        grads = {k: state.opt_state.adam[k].mu / (1.0 - fit.B1)
                 for k in city.FIELDS}
    finally:
        torch.set_num_threads(threads)
    return dict(target=target, image=image, loss=float(loss),
                stats=stats.tolist(), grads=grads)


def test_frames_and_loss_match_the_reference(children, reference):
    _, _, outs = children
    for o in outs:
        assert o["stats"] == [0, 0, 0]
        for key in ("target", "image"):
            err = float((o[key] - reference[key]).abs().max())
            assert err < IMAGE_ATOL, (key, err)
        assert abs(o["loss"] - reference["loss"]) \
            <= LOSS_RTOL * reference["loss"]
    assert float(reference["image"][..., 3].mean()) > 0.05


@pytest.mark.parametrize("field", city.FIELDS)
def test_gradient_matches_the_reference(children, reference, field):
    _, _, outs = children
    got = torch.cat([o["grads"][field] for o in outs])
    want = reference["grads"][field]
    assert float(want.abs().max()) > 0.0
    assert torch.allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL), \
        float((got - want).abs().max())


def test_frames_and_loss_equal_the_in_process_mesh(children, in_process):
    """Buckets sized by the demand change no number: the received rows
    are the fixed buckets' rows without their pads, in the same order."""
    _, _, outs = children
    assert in_process["stats"] == [0, 0, 0]
    for o in outs:
        for key in ("target", "image"):
            assert torch.equal(o[key], in_process[key]), key
        assert o["loss"] == in_process["loss"]


@pytest.mark.parametrize("field", city.FIELDS)
def test_gradient_equals_the_in_process_mesh(children, in_process, field):
    _, _, outs = children
    got = torch.cat([o["grads"][field] for o in outs])
    assert torch.equal(got, in_process["grads"][field])


@pytest.mark.parametrize("run", ["render", "step"])
def test_exchange_sends_and_bins_no_pad_row(children, run):
    """On the process mesh every send row carries a splat (bucket rows
    equal rows sent, on every rank), every row sent is received, and each
    strip receives fewer rows than one fixed bucket of nloc rows from each
    shard would hold."""
    config, _, outs = children
    n = city.shard_rows(config["scene"])
    counts = [o["counters"][run] for o in outs]
    for c in counts:
        assert c["exchange.bucket_rows"] == c["exchange.rows_sent"] > 0
        assert 0 < c["exchange.recv_rows"] < WORLD * n
    assert sum(c["exchange.recv_rows"] for c in counts) \
        == sum(c["exchange.rows_sent"] for c in counts)


def test_shards_drawn_apart_equal_the_whole_draw(children):
    config, traffic, outs = children
    scene = config["scene"]
    n = city.shard_rows(scene)
    whole = city.make_scene(scene, SEED, "cpu")
    start = city.make_scene(scene, SEED, "cpu", start=traffic["perturb"])
    for r, o in enumerate(outs):
        for k in city.FIELDS:
            assert torch.equal(o["gt"][k], whole[k][r * n:(r + 1) * n]), k
            assert torch.equal(o["init"][k], start[k][r * n:(r + 1) * n]), k
    assert not torch.equal(outs[0]["gt"]["means"], outs[1]["gt"]["means"])


def test_capacity_is_the_whole_model_rule(children):
    """The capacity the processes agree on from their shards' demands is
    harness.probe_capacity's on the whole model, scene and start."""
    from splatbench import harness
    config, traffic, outs = children
    cams = city.drone_cameras(config, traffic, "cpu")
    whole = [city.make_scene(config["scene"], SEED, "cpu"),
             city.make_scene(config["scene"], SEED, "cpu",
                             start=traffic["perturb"])]
    want = harness.probe_capacity(config, whole, cams)
    assert [o["pair_capacity"] for o in outs] == [want] * WORLD


def _tile_order_splats(n, live, gen):
    """Splats of which only the rows `live` are visible: 8 px footprints
    on a 96x64 frame, depths within 1e-3 of each other (so that pairs of a
    group differ in the lowest depth bits the key keeps)."""
    k = live.numel()
    xy = torch.zeros(n, 2)
    xy[live] = torch.rand(k, 2, generator=gen) * torch.tensor([96.0, 64.0])
    depth = torch.ones(n)
    depth[live] = 1.0 + torch.rand(k, generator=gen) * 1e-3
    conic = torch.zeros(n, 3)
    conic[live] = torch.tensor([0.05, 0.0, 0.05])
    opacity = torch.zeros(n)
    opacity[live] = 0.9
    radius = torch.zeros(n, 2)
    radius[live] = 8.0
    return dict(xy=xy, depth=depth, conic=conic, opacity=opacity,
                radius=radius, color=torch.zeros(n, 3))


def test_reference_tile_order_holds_past_2_21_gaussians():
    """reference/sharded_fit.tile_lists gives render.tile_lists' lists
    where that one is right, and keeps each tile's (depth key, gaussian
    index) order with visible gaussians past index 2^21, where
    render.tile_lists' packed key does not."""
    from splatbench.reference import render as ref
    rc = dict(image_width=96, image_height=64, tile_width=16,
              tile_height=16, tile_group=3, exact_tile_test=True,
              max_tiles_per_axis=16, alpha_min=1.0 / 255.0)
    gen = torch.Generator().manual_seed(5)
    small = _tile_order_splats(5000, torch.arange(0, 5000, 3), gen)
    want, got = ref.tile_lists(small, rc), refs.tile_lists(small, rc)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert want[2] == got[2]
    n = (1 << 21) + 4096
    big = _tile_order_splats(
        n, torch.cat([torch.arange(2000), torch.arange(1 << 21, n)]), gen)
    dq = big["depth"].view(torch.int32).long() >> ref.grid(rc)["depth_shift"]

    def ordered(lists):
        tile, gid = lists[0], lists[1]
        key = tile * (1 << 50) + dq[gid] * (1 << 30) + gid
        return bool((key[1:] > key[:-1]).all())

    assert ordered(refs.tile_lists(big, rc))
    assert not ordered(ref.tile_lists(big, rc))
