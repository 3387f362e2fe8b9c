"""Tracing, profiling and throughput instrumentation (torch port of
gaussian_splat_ipu_tpu/utils/profiling.py).

  * Tracepoint: a named region that shows in torch.profiler traces
    (torch.profiler.record_function, where the reference used
    jax.named_scope) and adds its host wall-clock seconds to a per-channel
    total.
  * trace(): a context manager around torch.profiler.profile (CPU activity,
    and CUDA activity when a card is present) that writes a Chrome trace
    into a directory, where the reference wrapped jax.profiler.
  * FrameMeter: rolling frames/s and Msplats/s, logged every few seconds.
  * two_point_time: per-iteration seconds from a K1- and a K2-iteration
    run, their difference cancelling the fixed dispatch and transfer cost.

The per-channel totals are module state, as the reference's: one process
has one set (reset_tracepoints clears it).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from typing import Callable, Dict

import torch

log = logging.getLogger("gsplat")

_channel_totals: Dict[str, float] = collections.defaultdict(float)
_channel_counts: Dict[str, int] = collections.defaultdict(int)


@contextlib.contextmanager
def Tracepoint(channel: str):
    """A region named `channel` in profiler traces; its host seconds and
    one count are added to the channel's totals."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(channel):
        yield
    _channel_totals[channel] += time.perf_counter() - t0
    _channel_counts[channel] += 1


def tracepoint_summary() -> Dict[str, Dict[str, float]]:
    """{channel: {"total_s": host seconds, "count": regions}}."""
    return {ch: {"total_s": _channel_totals[ch],
                 "count": _channel_counts[ch]}
            for ch in _channel_totals}


def reset_tracepoints() -> None:
    _channel_totals.clear()
    _channel_counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CUDA activity too when a
    card is present) and write its Chrome trace (view with Perfetto or
    chrome://tracing) into log_dir as trace.json. Yields the profiler,
    whose key_averages() sums the block's events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameMeter:
    """Rolling throughput logger: every log_every_s seconds, the frames
    per second since the last line and the splats per second they make."""

    def __init__(self, num_primitives: int, log_every_s: float = 3.0):
        self.n = num_primitives
        self.log_every_s = log_every_s
        self._count = 0
        self._t_last = time.perf_counter()
        self._frames_last = 0

    def tick(self) -> None:
        self._count += 1
        now = time.perf_counter()
        dt = now - self._t_last
        if dt >= self.log_every_s:
            frames = self._count - self._frames_last
            fps = frames / dt
            log.info("%.2f fps, %.2f Msplats/s (%d frames)", fps,
                     fps * self.n / 1e6, self._count)
            self._t_last = now
            self._frames_last = self._count


def two_point_time(run_k: Callable[[int], None], k1: int = 1,
                   k2: int = 16) -> float:
    """Seconds per iteration by the two-point method.

    run_k(k) runs k iterations and must synchronise the device before it
    returns (torch.cuda.synchronize(), or reading a small result back):
    CUDA work is queued asynchronously, so the host clock would otherwise
    time the enqueue. Both sizes run once to warm up, then once each
    timed; their difference cancels the fixed launch and transfer cost."""
    run_k(k1)
    run_k(k2)
    t0 = time.perf_counter()
    run_k(k1)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_k(k2)
    t2 = time.perf_counter() - t0
    return max((t2 - t1) / (k2 - k1), 1e-12)
