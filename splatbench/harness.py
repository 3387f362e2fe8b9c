"""The harness's common parts: finding a cell's files by name, the port's
configuration and capacity from a config file, host spans, the profiled
stretch and its reading, and the comparison's bookkeeping.

Everything of one configuration, one traffic mix or one per-layer metric
lives in a file of its own, found by the name BENCHMARK.json gives it:
configs/<config>.json, traffic/<mix>.json (whose "driver" names
drivers/<driver>.py), metrics/<metric>.py and limits/<cell>.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BLOCKED_MODULES = ("jax", "jaxlib", "flax", "gaussian_splat_ipu_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """Import the file at `path` as module `name` (file names may hold
    dots, so not by import path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    driver: object
    e2e: list          # BENCHMARK.json end_to_end entries of this cell
    per_layer: list    # per_layer entries of this cell
    chips: int


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None,
              root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files loaded."""
    bench = bench or benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has "
                       f"{sorted(cells)})")
    w = cells[name]
    here = os.path.join(root, "splatbench")
    config = load_json(os.path.join(here, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(here, "limits", name + ".json"))
    driver = load_module(os.path.join(here, "drivers",
                                      traffic["driver"] + ".py"),
                         "splatbench_driver_" + traffic["driver"])
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                driver=driver,
                e2e=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                chips=int(w["chips"]))


def metric_reader(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "splatbench", "metrics",
                                    name + ".py"),
                       "splatbench_metric_" + name.replace(".", "_"))


def raster_config(config: dict, capacity: int):
    """The port's RasterConfig for a config file's raster settings."""
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    r = dict(config["raster"])
    r["background"] = tuple(r["background"])
    return RasterConfig(pair_capacity=int(capacity), **r)


def probe_capacity(config: dict, param_sets, cameras) -> int:
    """The config's capacity rule: the worst (gaussian, tile) pair demand
    of every parameter set at every camera (view, proj, env_rot), counted
    by the program's own footprints, times the config's factor,
    chunk-aligned."""
    import torch

    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from splatbench.inputs import FIELDS
    cfg = raster_config(config, 1 << 24)
    worst = None
    with torch.no_grad():
        for params in param_sets:
            model = GaussianModel(*(params[k] for k in FIELDS))
            for v, p, e in cameras:
                fp = binning.footprints(project_gaussians(
                    model, Camera(v, p, e), cfg), cfg)
                n = fp.ncov.sum(dtype=torch.int64)
                worst = n if worst is None else torch.maximum(worst, n)
    chunk = config["raster"]["chunk_size"]
    cap = max(int(int(worst) * config["capacity"]["factor"]), 4 * chunk)
    return -(-cap // chunk) * chunk


# -- spans -------------------------------------------------------------------

class Spans:
    """Host spans of the harness: a duration list by name and, while
    `marks` is a list (in a profiled stretch), each span's (start, end,
    name) in Unix nanoseconds, the clock of the profiler's events."""

    def __init__(self):
        self.times = {}
        self.marks = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0, n0 = time.perf_counter(), time.time_ns()
        yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        if self.marks is not None:
            self.marks.append((n0, time.time_ns(), name))


# -- the profiled stretch ----------------------------------------------------

def read_profile(events, marks, t_begin_ns: int, t_end_ns: int) -> dict:
    """Device activity of a profiled stretch from the profiler's events
    (prof.profiler.kineto_results.events()): seconds by kernel name, the
    busy seconds (union of kernels, copies and fills), the traced window,
    and the longest idle gaps labelled by the harness span (`marks`) the
    host was in. The ranges that record_function or NVTX mirror onto the
    device's timeline (user annotations) span gaps and kernels alike and
    are no work: only kernels, copies and fills count."""
    device = []
    for e in events:
        if e.device_type().name == "CUDA" and not e.is_user_annotation():
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), e.name()))
    device.sort()
    by_name = {}
    for s, e, n in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    lo = t_begin_ns
    for s, e, _ in device:
        s, e = max(s, t_begin_ns), min(e, t_end_ns)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += (cur_e - cur_s) * 1e-9
                gaps.append((cur_e, s))
            else:
                gaps.append((lo, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += (cur_e - cur_s) * 1e-9
        gaps.append((cur_e, t_end_ns))
    labelled = {}
    for gs, ge in gaps:
        if ge <= gs:
            continue
        mid = (gs + ge) // 2
        inner = [m for m in marks if m[0] <= mid <= m[1]]
        label = min(inner, key=lambda m: m[1] - m[0])[2] if inner \
            else "outside the harness's spans"
        labelled[label] = labelled.get(label, 0.0) + (ge - gs) * 1e-9
    return dict(kernel_s=by_name, busy_s=busy,
                window_s=(t_end_ns - t_begin_ns) * 1e-9,
                top_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                idle_gaps=sorted(labelled.items(),
                                 key=lambda kv: -kv[1])[:10])


@contextlib.contextmanager
def profiled(out: dict, spans: Spans):
    """Run the block under torch.profiler, tracing the device's activity
    alone (tracing the host's operations as well slows a host-bound loop
    further). On exit `out` holds read_profile's reading of the block,
    from the synchronisation before it to the one after, with the host's
    side from `spans`. The device is idle at both ends, so the busy
    seconds are all of the block's device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans.marks = []
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        sync()
        t0 = time.time_ns()
        yield
        sync()
        t1 = time.time_ns()
    marks, spans.marks = spans.marks, None
    out.update(read_profile(prof.profiler.kineto_results.events(), marks,
                            t0, t1))


# -- the comparison ----------------------------------------------------------

def rel_l2(got, ref) -> float:
    d = (got.double() - ref.double()).norm()
    return float(d / ref.double().norm().clamp_min(1e-30))


def max_abs(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def judge(readings: dict, limits: dict):
    """{name: {"value", "limit"}} of every number compared, and whether
    each is within its limit (NaN never is)."""
    checks = {}
    ok = True
    for name, value in readings.items():
        limit = float(limits[name])
        checks[name] = {"value": value, "limit": limit}
        if not (value <= limit):
            ok = False
    return checks, ok


# -- device facts -------------------------------------------------------------

def power_limit_w() -> Optional[float]:
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def blocked_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in BLOCKED_MODULES})


def per_second(times, t0) -> list:
    """How many of `times` (host seconds) fall in each whole second from
    t0 on: the window's rate second by second, for reading its noise."""
    counts = {}
    for t in times:
        if t >= t0:
            counts[int(t - t0)] = counts.get(int(t - t0), 0) + 1
    return [counts.get(i, 0) for i in range(max(counts, default=-1) + 1)]


def percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))
