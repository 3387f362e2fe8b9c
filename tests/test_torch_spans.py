"""The span recorder (utils/profiling.py) and the spans of the engine, the
frame program and the train step. On the CPU: host and device spans
(the log's plain stamp) nest with their parents, items and self times on
a fake clock; device times map through the anchors; the Chrome export's
shape; the order of pipeline.render's and trainer.train_step's spans with
mark's backward firing; nothing recorded, no mark node and no kernel call
with recording off; the log's overflow; the readings of spans, and the
benchmark's reader of the engine's register time. On a CUDA card (marked
`cuda`, skipped without one): no stamp is captured with recording off;
with it on, a replayed frame's and step's stamps increase in order, their
named stages cover at least 80% of a frame's engine.run device span and
90% of a step's, the anchor's error is under 20 us, and kernels C and D
fall inside the "raster" and "backward" spans. The profiler's own
conversion of device time to the host's clock strays from the anchors by
up to about 0.1 ms within a short profile on some runs (its stamp kernels
show it), so its kernels are put on the log's clock by the stamp kernels
it records beside them; the raw shares are printed."""

import bisect
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.app import main as app
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render import pipeline
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
from gaussian_splat_ipu_tpu_torch.train import trainer
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RasterConfig(image_width=48, image_height=32, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 12)
FRAME = ["project", "bin", "raster", "untile"]


class FakeClock:
    """Unix nanoseconds that step by 10 at each reading."""

    def __init__(self, t0=1_000):
        self.t = t0 - 10

    def __call__(self):
        self.t += 10
        return self.t


@pytest.fixture
def recording():
    """Start a recorder (the arguments of profiling.start) and stop it
    whatever the test does."""
    def go(*args, **kw):
        return profiling.start(*args, **kw)

    assert profiling.active is None
    yield go
    profiling.stop()


def _scene(seed=0, n=120):
    g = torch.Generator().manual_seed(seed)
    model = GaussianModel.random(n, generator=g, device="cpu")
    cam = Camera.orbit(-np.ones(3), np.ones(3), 0.8, 48 / 32,
                       rot_y_deg=30.0, device="cpu")
    return model, cam


def _by_track(spans, track):
    return [s for s in spans if s.track == track]


def _names(spans):
    return [s.name for s in spans]


def test_host_spans_nest_with_parents_items_and_self_time(recording):
    rec = recording(clock=FakeClock())
    with profiling.span("outer", item=3):          # start 1000
        with profiling.span("a"):                 # 1010 .. 1020
            pass
        with profiling.span("b"):                 # 1030 .. 1060
            with profiling.span("c"):             # 1040 .. 1050
                pass
    with profiling.span("top"):                   # end of outer 1070
        pass
    spans = rec.collect()
    assert _names(spans) == ["outer", "a", "b", "c", "top"]
    outer, a, b, c, top = spans
    assert (outer.start_ns, outer.end_ns) == (1000, 1070)
    assert (a.start_ns, a.end_ns, b.start_ns, b.end_ns) == (1010, 1020,
                                                            1030, 1060)
    assert [s.parent for s in spans] == [-1, 0, 0, 2, -1]
    assert [s.item for s in spans] == [3, 3, 3, 3, -1]
    assert outer.self_ns == 70 - 10 - 30
    assert b.self_ns == 30 - 10 and c.self_ns == 10
    assert all(s.track == "host" for s in spans)


def test_device_spans_decode_from_the_plain_stamps(recording):
    """A recorder of the CPU logs its stamps with the plain version: the
    device track nests by stream order and inherits the item."""
    rec = recording("cpu", clock=FakeClock())
    with profiling.span("engine.run", "cpu", item=7):
        with profiling.span("x", "cpu"):
            pass
        with profiling.span("host_only"):
            pass
        with profiling.span("y", "cpu"):
            pass
    dev = _by_track(rec.collect(), "device")
    assert _names(dev) == ["engine.run", "x", "y"]
    run, x, y = dev
    assert [s.item for s in dev] == [7, 7, 7]
    assert [s.parent for s in dev][1:] == [rec.spans.index(run)] * 2
    assert run.start_ns < x.start_ns < x.end_ns < y.start_ns < y.end_ns \
        < run.end_ns
    assert run.self_ns == (run.end_ns - run.start_ns) - (
        x.end_ns - x.start_ns) - (y.end_ns - y.start_ns)
    assert rec.entries == 6 and rec.overflow == 0
    # The fake clock steps by 10: each anchor's bracket is 20.
    assert rec.anchor_error_ns == 10


def test_device_readings_map_between_the_anchors_around_them():
    rec = profiling.SpanRecorder(clock=FakeClock())
    rec.anchors = [profiling.Anchor(1_000, 10, 5),
                   profiling.Anchor(3_000, 1_010, 7),
                   profiling.Anchor(3_500, 2_010, 3)]
    assert rec.to_host(510) == 2_000        # two host ns per device ns
    assert rec.to_host(1_510) == 3_250      # half a host ns per one
    assert rec.to_host(2_110) == 3_550      # past the last: its segment
    assert rec.to_host(0) == 980            # before the first: its own
    assert rec.anchor_error_ns == 7
    rec.anchors = rec.anchors[:1]
    assert rec.to_host(510) == 1_500


def test_export_writes_chrome_trace_on_two_tracks(recording, tmp_path):
    rec = recording("cpu", clock=FakeClock())
    with profiling.span("engine.run", "cpu", item=0):
        with profiling.span("project", "cpu"):
            pass
    path = profiling.export_spans(str(tmp_path / "sub" / "spans.json"))
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    assert {(e["pid"], e["args"]["name"]) for e in meta} == {
        (0, "host"), (1, "device (cpu)")}
    spans = [e for e in events if e["ph"] == "X"]
    assert sorted((e["pid"], e["name"]) for e in spans) == [
        (0, "engine.run"), (0, "project"), (1, "engine.run"),
        (1, "project")]
    origin = trace["otherData"]["origin_unix_ns"]
    assert origin == rec.anchors[0].host_ns
    for e, s in zip(spans, rec.spans):
        assert e["name"] == s.name
        assert e["ts"] == pytest.approx((s.start_ns - origin) / 1e3)
        assert e["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3)
        assert e["args"] == {"index": spans.index(e), "item": 0,
                             "parent": s.parent, "self_us": s.self_ns / 1e3}
    counters = trace["otherData"]["counters"]
    assert counters["log_entries"] == 4 and counters["log_overflow"] == 0
    assert trace["otherData"]["clock"] == "unix_ns"


def test_render_spans_in_order(recording):
    model, cam = _scene()
    rec = recording("cpu")
    with torch.no_grad():
        pipeline.render(model, cam, CFG)
    spans = rec.collect()
    for track in ("host", "device"):
        got = _by_track(spans, track)
        assert _names(got) == FRAME
        assert all(s.parent == -1 and s.item == -1 for s in got)
        assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))


def test_train_step_spans_in_order_with_the_marks_backward(recording):
    model, cam = _scene()
    state = trainer.init_state(model.trainable())
    with torch.no_grad():
        target = pipeline.render(_scene(seed=1)[0], cam, CFG).image
    rec = recording("cpu")
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    trainer.register_step(eng, state, cam, target, CFG,
                          trainer.TrainConfig())
    eng.run(trainer.STEP_PROGRAM, state, cam, target)
    assert eng.last_item == 0
    dev = _by_track(rec.collect(), "device")
    assert _names(dev) == ["engine.run", "render", *FRAME, "loss.fwd",
                           "loss", "backward", "loss.bwd", "adam"]
    idx = {s.name: rec.spans.index(s) for s in dev}
    parent = {s.name: s.parent for s in dev}
    assert parent["render"] == parent["loss"] == parent["backward"] \
        == parent["adam"] == idx["engine.run"]
    assert all(parent[n] == idx["render"] for n in FRAME)
    assert parent["loss.bwd"] == idx["backward"]
    assert all(s.item == 0 for s in dev)
    spans = {s.name: s for s in dev}
    bwd, lbwd = spans["backward"], spans["loss.bwd"]
    # loss.bwd runs from backward's start to the gradient reaching the
    # image: it ended inside backward.
    assert lbwd.start_ns == bwd.start_ns < lbwd.end_ns < bwd.end_ns
    assert spans["loss.fwd"].start_ns == spans["loss.fwd"].end_ns
    host = _by_track(rec.spans, "host")
    assert _names(host)[:2] == ["engine.register", "engine.run"]
    assert rec.summary()["items"] == 1


def _has_mark_node(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if "Mark" in type(fn).__name__:
            return True
        todo.extend(f for f, _ in fn.next_functions)
    return False


def test_recording_off_records_nothing_marks_nothing_calls_no_kernel(
        monkeypatch):
    def no_kernels():
        raise AssertionError("cuda_lib called")

    monkeypatch.setattr(cuda_lib, "library", no_kernels)
    assert profiling.active is None
    assert profiling.span("project", "cpu") is profiling.span("adam")
    x = torch.ones(3, requires_grad=True)
    assert profiling.mark(x, "loss") is x
    model, cam = _scene()
    state = trainer.init_state(model.trainable())
    target = torch.zeros(32, 48, 4)
    loss = trainer.loss_fn(state.params, cam, target, CFG,
                           trainer.TrainConfig())
    assert not _has_mark_node(loss)
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    trainer.register_step(eng, state, cam, target, CFG,
                          trainer.TrainConfig())
    eng.run(trainer.STEP_PROGRAM, state, cam, target)
    assert eng.last_item is None
    assert profiling.collect() == []
    # Recording on the CPU calls no kernel either; the mark is a node.
    rec = profiling.start("cpu")
    try:
        loss = trainer.loss_fn(state.params, cam, target, CFG,
                               trainer.TrainConfig())
        assert _has_mark_node(loss)
        assert rec.collect()
    finally:
        profiling.stop()


def test_log_overflow_is_counted_and_never_wraps(recording):
    rec = recording("cpu", capacity=4, clock=FakeClock())
    for name in ("a", "b", "c"):
        with profiling.span(name, "cpu"):
            pass
    first = rec.log.clone()
    assert int(rec.state[0]) == 6 and int(rec.state[1]) == 2
    dev = _by_track(rec.collect(), "device")
    assert _names(dev) == ["a", "b"]
    assert (rec.entries, rec.overflow) == (4, 2)
    assert torch.equal(rec.log, first)     # nothing past slot 3 wrapped
    # collect reset the cursor: the log takes new stamps from slot 0.
    assert int(rec.state[0]) == 0
    with profiling.span("d", "cpu"):
        pass
    assert _names(_by_track(rec.collect(), "device")) == ["a", "b", "d"]


def test_clear_drops_spans_and_an_end_without_its_begin(recording):
    rec = recording("cpu", clock=FakeClock())
    with profiling.span("kept", "cpu"):
        pass
    rec.collect()
    with profiling.span("open", "cpu"):
        profiling.clear()        # the begin stamp is dropped with the log
    with profiling.span("after", "cpu"):
        pass
    assert _names(rec.collect()) == ["open", "after", "after"]
    assert _names(_by_track(rec.spans, "device")) == ["after"]


def test_only_takes_the_named_spans_and_no_mark(recording):
    rec = recording("cpu", only=("engine.run",))
    model, cam = _scene()
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    eng.register("project", app.splat_program(CFG),
                 (model, cam.view, cam.proj, cam.env_rot))
    x = torch.ones(2, requires_grad=True)
    assert profiling.mark(x, "loss") is x
    for _ in range(3):
        eng.run("project", model, cam.view, cam.proj, cam.env_rot)
    spans = rec.collect()
    assert {s.name for s in spans} == {"engine.run"}
    ms = profiling.item_ms(spans, "engine.run")
    assert sorted(ms) == [0, 1, 2] and all(v > 0 for v in ms.values())


def _span(name, start, end, item=0, track="device", parent=-1, self_ns=0):
    return profiling.Span(name, track, start, end, parent, item, self_ns)


def test_readings_of_spans():
    spans = [_span("engine.run", 0, 100, item=0, self_ns=20),
             _span("raster", 10, 50, item=0, parent=0),
             _span("raster", 60, 80, item=0, parent=0),
             _span("engine.run", 150, 250, item=1, self_ns=50),
             _span("raster", 160, 210, item=1, parent=3),
             _span("raster", 0, 10, item=-1),
             _span("raster", 0, 999, item=2, track="host")]
    assert profiling.item_ms(spans, "raster") == pytest.approx(
        {0: 60e-6, 1: 50e-6})
    assert profiling.item_ms(spans, "raster", "host") == pytest.approx(
        {2: 999e-6})
    assert profiling.coverage(spans) == {0: 0.8, 1: 0.5}
    # The window [50, 200]: engine.run covers 50..100 and 150..200.
    assert profiling.union_ns(spans, ["engine.run"], 50, 200) == 100
    assert profiling.union_ns(spans, ["engine.run", "raster"], 0, 300) \
        == 200


def _reader(name):
    path = os.path.join(REPO, "splatbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_register_s_reads_the_engines_register_channel(monkeypatch):
    reader = _reader("register_s")
    assert (reader.LAYER, reader.MOVES, reader.UNIT) == (
        "runtime/engine.py", "setup_s", "s")
    r = dict(kind="view", enqueue_s=[0.1], profile={}, work=[{}], items=1,
             rc={}, scene={}, ssim_weight=0.0)
    monkeypatch.setattr(profiling, "_channel_totals", {})
    monkeypatch.setattr(profiling, "_channel_counts", {})
    assert reader.read(r) is None           # no register in this process
    profiling._channel_totals["engine.register"] = 1.25
    profiling._channel_counts["engine.register"] = 2
    assert reader.read(r) == 1.25
    assert reader.read(dict(r, items=0)) is None   # no run's reading


def test_register_is_a_tracepoint_with_its_stages(recording):
    model, cam = _scene()
    before = profiling.tracepoint_summary().get(
        "engine.register", {"count": 0})["count"]
    rec = recording("cpu")
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    eng.register("project", app.splat_program(CFG),
                 (model, cam.view, cam.proj, cam.env_rot))
    assert profiling.tracepoint_summary()["engine.register"]["count"] \
        == before + 1
    assert _names(rec.collect()) == ["engine.register"]


# -- on the card ----------------------------------------------------------------

def _inside(intervals, spans, offsets=None):
    """The share of the intervals' length inside the union of spans; with
    `offsets` ((profiler start, offset ns) of each stamp kernel), each
    interval first moved onto the log's clock by the offset of the last
    stamp the profiler saw start before it."""
    spans = sorted(spans)
    total = covered = 0
    for s, e in intervals:
        if offsets:
            j = max(bisect.bisect([a for a, _ in offsets], s) - 1, 0)
            s, e = s - offsets[j][1], e - offsets[j][1]
        total += e - s
        for a, b in spans:
            covered += max(0, min(e, b) - max(s, a))
    return covered / total


def _kernels(prof, key):
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type().name == "CUDA" and not e.is_user_annotation()
            and key in e.name()]


def _stamp_offsets(rec, prof):
    """(the profiler's start of each stamp kernel, that less the log's
    reading of the same stamp on the host's clock in ns), the block's
    stamps being the log's last ones, in order. Read before collect()."""
    n = min(int(rec.state[0]), rec.capacity)
    mapped = [rec.to_host(t) for t in rec.log[:n, 1].tolist()]
    starts = sorted(a for a, _ in _kernels(prof, "stamp_kernel"))
    assert 0 < len(starts) <= n
    return [(a, a - b) for a, b in zip(starts, mapped[-len(starts):])]


def _us(offsets):
    us = [o / 1e3 for _, o in offsets]
    return float(np.median(us)), min(us), max(us)


def _stamps_increase(dev, item, names):
    """The device spans of `item` are engine.run and then `names`, each
    after the one before it: their stamps, in log order, never go back."""
    got = [s for s in dev if s.item == item]
    assert _names(got) == ["engine.run", *names]
    run, inner = got[0], got[1:]
    times = [run.start_ns]
    for s in inner:
        times += [s.start_ns, s.end_ns]
    times.append(run.end_ns)
    return all(a <= b for a, b in zip(times, times[1:]))


@pytest.mark.cuda
def test_stamps_on_the_card_cover_frames_and_steps_on_one_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU mode "
                    "(the CPU tests above use its plain version)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = RasterConfig(image_width=1280, image_height=720, tile_width=32,
                       tile_height=32, chunk_size=128, pair_capacity=1 << 20,
                       strict_termination=True)
    g = torch.Generator(device=dev).manual_seed(5)
    model = GaussianModel.random(37_941, generator=g, device=dev)
    cams = [Camera.orbit(-np.ones(3), np.ones(3), 0.7, 1280 / 720,
                         rot_y_deg=float(a), device="cpu")
            for a in range(0, 360, 10)]

    def frame_args(cam):
        return (model, cam.view.to(dev), cam.proj.to(dev),
                cam.env_rot.to(dev))

    eng = RenderEngine(RuntimeConfig(device="cuda"))
    cuda_lib.library()
    cuda_lib.launches.clear()
    eng.register("off", app.splat_program(cfg), frame_args(cams[0]))
    assert cuda_lib.launches["stamp"] == 0      # recording off: no stamp
    eng.release("off")

    rec = profiling.start(dev)
    try:
        cuda_lib.launches.clear()
        eng.register("project", app.splat_program(cfg), frame_args(cams[0]))
        # 4 spans of 2 stamps, in each warm-up and the captured call.
        assert cuda_lib.launches["stamp"] == 8 * (engine_lib.WARMUP_CALLS
                                                  + 1)
        assert rec.counters["captures.project"] == 1
        rec.collect()
        rec.clear()
        for cam in cams:
            eng.run("project", *frame_args(cam))
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for cam in cams[:12]:
                eng.run("project", *frame_args(cam))
            torch.cuda.synchronize()
        rec.anchor()
        offsets = _stamp_offsets(rec, prof)
        print("frame stamp offsets us (median, min, max)", _us(offsets))
        spans = rec.collect()
        devs = _by_track(spans, "device")
        items = sorted({s.item for s in devs})
        assert len(items) == len(cams) + 12
        for k in items:
            assert _stamps_increase(devs, k, FRAME), k
        cover = profiling.coverage(spans)
        steady = [cover[k] for k in items[2:len(cams)]]
        print("frame coverage min/median", min(steady),
              float(np.median(steady)), "anchor error ns",
              rec.anchor_error_ns)
        assert min(steady) >= 0.8
        assert 0 < rec.anchor_error_ns < 20_000
        raster = [(s.start_ns, s.end_ns) for s in devs if s.name == "raster"]
        c_kernels = _kernels(prof, "rasterize_fwd_kernel")
        c_in = _inside(c_kernels, raster, offsets)
        print("C inside raster", _inside(c_kernels, raster),
              "aligned by the stamps", c_in)
        assert c_in >= 0.99
        assert rec.counters["replays.project"] == len(cams) + 12
        eng.release("project")

        # The train step at 640x360.
        tcfg = RasterConfig(image_width=640, image_height=360, tile_width=16,
                            tile_height=16, chunk_size=128,
                            pair_capacity=1 << 20)
        state = trainer.init_state(model.trainable(), trainer.TrainConfig())
        tcams = [Camera.orbit(-np.ones(3), np.ones(3), 0.7, 640 / 360,
                              rot_y_deg=float(a), device="cpu").to(dev)
                 for a in range(0, 360, 30)]
        with torch.no_grad():
            truth = GaussianModel.random(37_941, generator=g, device=dev)
            targets = [pipeline.render(truth, c, tcfg).image for c in tcams]
        trainer.register_step(eng, state, tcams[0], targets[0], tcfg,
                              trainer.TrainConfig())
        rec.collect()
        rec.clear()
        for c, t in zip(tcams, targets):
            eng.run(trainer.STEP_PROGRAM, state, c, t)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for c, t in zip(tcams[:6], targets):
                eng.run(trainer.STEP_PROGRAM, state, c, t)
            torch.cuda.synchronize()
        rec.anchor()
        offsets = _stamp_offsets(rec, prof)
        print("step stamp offsets us (median, min, max)", _us(offsets))
        spans = rec.collect()
        devs = _by_track(spans, "device")
        items = sorted({s.item for s in devs})
        assert len(items) == len(tcams) + 6
        step = ["render", *FRAME, "loss.fwd", "loss", "backward", "loss.bwd",
                "adam"]
        for k in items:
            got = [s for s in devs if s.item == k]
            assert _names(got) == ["engine.run", *step], k
            assert all(a.start_ns <= b.start_ns
                       for a, b in zip(got, got[1:])), k
        cover = profiling.coverage(spans)
        steady = [cover[k] for k in items[2:len(tcams)]]
        print("step coverage min/median", min(steady),
              float(np.median(steady)))
        assert min(steady) >= 0.9
        backward = [(s.start_ns, s.end_ns) for s in devs
                    if s.name == "backward"]
        raster = [(s.start_ns, s.end_ns) for s in devs if s.name == "raster"]
        d_kernels = _kernels(prof, "rasterize_bwd_kernel")
        c_kernels = _kernels(prof, "rasterize_fwd_kernel")
        d_in = _inside(d_kernels, backward, offsets)
        c_in = _inside(c_kernels, raster, offsets)
        print("D inside backward", _inside(d_kernels, backward),
              "C inside raster", _inside(c_kernels, raster),
              "aligned by the stamps", d_in, c_in)
        assert d_in >= 0.99 and c_in >= 0.99
        assert rec.overflow == 0
    finally:
        profiling.stop()
