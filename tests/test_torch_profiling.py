"""The port's profiling module (utils/profiling.py), as the JAX package's
tests/test_profiling.py holds its own: Tracepoint totals and counts on a
fake clock (time.sleep made the reference's wall-clock test flaky) and
the Tracepoint's record_function range in a CPU trace()'s Chrome file.
The span recorder's tests are in tests/test_torch_spans.py."""

import json
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
