"""The port's profiling module (utils/profiling.py), as the JAX package's
tests/test_profiling.py holds its own: Tracepoint totals and counts, the
Tracepoint's record_function range in a CPU trace()'s Chrome file,
FrameMeter's log line, and two_point_time on a fake clock (time.sleep
made the reference's wall-clock test flaky)."""

import json
import logging
import os

import torch

from gaussian_splat_ipu_tpu_torch.utils import profiling


def fake_clock(monkeypatch, readings):
    """time.perf_counter returns these readings in turn (then the last)."""
    it = iter(readings)
    last = [readings[0]]

    def perf_counter():
        last[0] = next(it, last[0])
        return last[0]

    monkeypatch.setattr(profiling.time, "perf_counter", perf_counter)


def test_tracepoints_sum_and_count(monkeypatch):
    fake_clock(monkeypatch, [10.0, 10.25, 20.0, 20.5, 30.0, 30.125])
    profiling.reset_tracepoints()
    with profiling.Tracepoint("render"):
        torch.arange(4).sum()
    with profiling.Tracepoint("render"):
        pass
    with profiling.Tracepoint("ui"):
        pass
    assert profiling.tracepoint_summary() == {
        "render": {"total_s": 0.75, "count": 2},
        "ui": {"total_s": 0.125, "count": 1}}
    profiling.reset_tracepoints()
    assert profiling.tracepoint_summary() == {}


def test_trace_writes_the_tracepoint_range(tmp_path):
    profiling.reset_tracepoints()
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        with profiling.Tracepoint("splat_frame"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "splat_frame" in names
    assert "splat_frame" in {e.key for e in prof.key_averages()}
    assert profiling.tracepoint_summary()["splat_frame"]["count"] == 1
    profiling.reset_tracepoints()


def test_frame_meter_logs_rate(monkeypatch, caplog):
    fake_clock(monkeypatch, [0.0, 1.0, 2.0, 4.0])
    meter = profiling.FrameMeter(2_000_000, log_every_s=2.0)   # t = 0
    with caplog.at_level(logging.INFO, logger="gsplat"):
        meter.tick()       # t = 1: under the interval, silent
        meter.tick()       # t = 2: 2 frames in 2 s
        meter.tick()       # t = 4: 1 frame in 2 s
    lines = [r.getMessage() for r in caplog.records]
    assert lines == ["1.00 fps, 2.00 Msplats/s (2 frames)",
                     "0.50 fps, 1.00 Msplats/s (3 frames)"]


def test_two_point_time_cancels_the_fixed_cost(monkeypatch):
    """run_k(k) advances a fake clock by 5 ms + 2 ms per iteration: the
    method returns the 2 ms and runs 1, 9, 1, 9."""
    now = [100.0]
    calls = []

    def run_k(k):
        calls.append(k)
        now[0] += 0.005 + 0.002 * k

    monkeypatch.setattr(profiling.time, "perf_counter", lambda: now[0])
    per = profiling.two_point_time(run_k, k1=1, k2=9)
    assert calls == [1, 9, 1, 9]
    assert abs(per - 0.002) < 1e-12
    # A second run no slower than the first: the floor, not a negative.
    assert profiling.two_point_time(lambda k: None, 1, 9) == 1e-12
