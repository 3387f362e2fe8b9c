"""The harness's common parts: finding a cell's files by name, the port's
configuration and capacity from a config file, host spans, the profiled
stretch and its reading, the comparison's bookkeeping, and the ranks of a
cell on several cards with the merge of their results.

Everything of one configuration, one traffic mix or one per-layer metric
lives in a file of its own, found by the name BENCHMARK.json gives it,
under the benchmark's first path (splatbench/): configs/<config>.json,
traffic/<mix>.json (whose "driver" names drivers/<driver>.py),
metrics/<metric>.py and limits/<cell>.json.

A cell with "chips" W > 1 runs as W processes, one per card: the process
the benchmark's command starts is rank 0 and starts ranks 1..W-1 with
torch.multiprocessing (`Ranks`). Every rank sets the program's own
multi-process contract (`rank_env`: GSPLAT_COORDINATOR, GSPLAT_NUM_PROCESSES,
GSPLAT_PROCESS_ID) and runs on cuda:<rank>, the card
parallel/multihost.process_device() picks under NCCL; the cell's driver
joins the group through multihost.initialize(), and the harness opens no
group of its own. Each rank hands its result object and its traced reading
back over a pipe of its own, never through a collective, so a hung
collective cannot also hang the bookkeeping.
`merge_results` makes the one line rank 0 prints:

- correct: every rank's numbers within their limits, and at least one
  rank that checked something; checks: each number's worst value over
  the ranks, beside its limit;
- attempted: rank 0's; failed: the sum over the ranks, at most attempted
  (an item that fails on two cards counts twice: the sum errs towards
  more failures);
- metrics: rank 0's (the end-to-end metrics are rank 0's host clock);
  info.by_rank: each rank's metrics, counts, checks, card and info;
- device: count W, memory_peak_bytes the fullest card's, power_limit_w
  the lowest, busy_s and window_s the means over the cards, with the
  by-card lists beside them; breakdown: rank 0's. busy_s counts NCCL's
  kernels, also while they wait for a slower peer: collective_s_by_card
  gives each card's seconds in kernels whose name holds "nccl", so that
  a reader can tell a card's compute from its waits on the others;
- per-layer readers get rank 0's reading, as with one card, plus
  by_rank, the list of every rank's.

With one card none of this runs: no other process, no GSPLAT_* variable,
and the line is the rank's own.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading
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
    home: str          # the directory of its files


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None,
              root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`) with its files
    loaded from the benchmark's first path."""
    bench = bench or benchmark(root)
    w = workload(bench, name)
    here = os.path.join(root, bench["paths"][0])
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
                chips=int(w["chips"]), home=here)


def workload(bench: dict, name: str) -> dict:
    """The workloads entry `name` of a benchmark."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has "
                       f"{sorted(cells)})")
    return cells[name]


def metric_reader(name: str, home: str = HERE):
    return load_module(os.path.join(home, "metrics", name + ".py"),
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

def card_facts(index: int) -> dict:
    """CUDA card `index`'s PCI bus id (torch's) and power limit
    (nvidia-smi's; None where it gives none). nvidia-smi's row is the one
    with the card's bus id, or else its row `index` (its only row on one
    card; some machines' nvidia-smi reads no bus ids)."""
    import torch
    props = torch.cuda.get_device_properties(index)
    ids = [getattr(props, a, None)
           for a in ("pci_domain_id", "pci_bus_id", "pci_device_id")]
    bus = (f"{ids[0]:08X}:{ids[1]:02X}:{ids[2]:02X}.0"
           if None not in ids else None)
    try:
        rows = [[x.strip() for x in line.split(",")]
                for line in subprocess.run(
                    ["nvidia-smi", "--query-gpu=pci.bus_id,power.limit",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.splitlines()
                if line.strip()]
    except (OSError, subprocess.TimeoutExpired):
        rows = []
    row = next((r for r in rows if bus and r[0].upper() == bus), None)
    if row is None and index < len(rows):
        row = rows[index]
    try:
        power = float(row[1]) if row else None
    except (ValueError, IndexError):
        power = None
    return {"pci_bus_id": bus or (row[0] if row else None),
            "power_limit_w": power}


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


# -- several cards ------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on the loopback address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(coordinator: str, world: int, rank: int) -> None:
    """The program's multi-process contract for rank `rank` of `world`, in
    this process's environment (parallel/multihost.initialize reads it)."""
    os.environ["GSPLAT_COORDINATOR"] = coordinator
    os.environ["GSPLAT_NUM_PROCESSES"] = str(world)
    os.environ["GSPLAT_PROCESS_ID"] = str(rank)


class RankFailed(RuntimeError):
    pass


class Ranks:
    """Ranks 1..world-1 of a cell on several cards, started by rank 0 (the
    calling process) with torch.multiprocessing.start_processes (spawn):
    each runs `target(index, parent_pid, world, coordinator, ends, *args)`
    as rank index + 1, and `rank_process(rank, parent_pid, ends)` gives it
    the end of a pipe of its own to send its result over (send_result).
    Its standard output and error go to this process's standard error,
    each line prefixed "rank r: ", never to its standard output. A watchdog
    thread joins the ranks every POLL_S: one that ends with a code other
    than 0 ends every rank and this process (exit code 5), also while this
    process's main thread waits in a collective that rank will never join."""

    POLL_S = 0.5

    def __init__(self, target, args: tuple, world: int):
        import multiprocessing

        import torch.multiprocessing as mp
        pipe = multiprocessing.get_context("spawn").Pipe
        self.coordinator = f"127.0.0.1:{free_port()}"
        results = [pipe(duplex=False) for _ in range(1, world)]
        outputs = [pipe(duplex=False) for _ in range(1, world)]
        ends = [(r[1], o[1]) for r, o in zip(results, outputs)]
        self._stop = threading.Event()
        self._clean = threading.Event()
        self.ctx = mp.start_processes(
            target, args=(os.getpid(), world, self.coordinator, ends, *args),
            nprocs=world - 1, join=False, start_method="spawn")
        for end in ends:
            for conn in end:
                conn.close()
        self._recv = [r[0] for r in results]
        self._forwards = []
        for i, ((out, _), pid) in enumerate(zip(outputs, self.ctx.pids())):
            self._say(f"splatbench: rank {i + 1} started, pid {pid}")
            t = threading.Thread(target=self._forward, args=(i + 1, out),
                                 daemon=True)
            t.start()
            self._forwards.append(t)
        self._watchdog = threading.Thread(target=self._watch, daemon=True)
        self._watchdog.start()

    @staticmethod
    def _say(line: str):
        sys.stderr.write(line + "\n")
        sys.stderr.flush()

    def _forward(self, rank, conn):
        with conn, os.fdopen(os.dup(conn.fileno()), "rb") as src:
            for line in src:
                self._say(f"rank {rank}: "
                          + line.decode(errors="replace").rstrip("\n"))

    def _watch(self):
        try:
            while not self._stop.is_set():
                if self.ctx.join(self.POLL_S, grace_period=0):
                    self._clean.set()
                    return
        except Exception as e:  # a rank raised or ended with a code
            rank = getattr(e, "error_index", -1) + 1
            code = getattr(e, "exit_code", None)
            how = f"ended with code {code}" if code is not None \
                else f"raised:{e}"
            self._say(f"splatbench: rank {rank} {how}: ending every rank")
            self.close()
            os._exit(5)

    def collect(self, timeout_s: float = 240.0) -> list:
        """Each rank's payload (send_result's), in rank order, once every
        rank has ended with code 0. Raises RankFailed where a rank sends
        nothing or does not end within timeout_s."""
        deadline = time.monotonic() + timeout_s
        out = []
        for i, conn in enumerate(self._recv):
            try:
                if not conn.poll(max(deadline - time.monotonic(), 0.0)):
                    raise RankFailed(f"rank {i + 1} sent no result within "
                                     f"{timeout_s:.0f} s of rank 0")
                out.append(json.loads(conn.recv_bytes()))
            except EOFError:
                raise RankFailed(f"rank {i + 1} ended and sent no result") \
                    from None
        if not self._clean.wait(max(deadline - time.monotonic(), 0.0)):
            raise RankFailed(f"the ranks did not end within {timeout_s:.0f} s"
                             f" of rank 0")
        for t in self._forwards:
            t.join(30)
        return out

    def close(self):
        """Kill every rank's session (the rank and whatever it started),
        wait for each rank, and stop multiprocessing's resource tracker,
        which spawning started."""
        self._stop.set()
        if threading.current_thread() is not self._watchdog:
            self._watchdog.join()
        for p in self.ctx.processes:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(p.pid, signal.SIGKILL)
            p.kill()  # a rank that has no session of its own yet
        for p in self.ctx.processes:
            p.join(30)
        from multiprocessing import resource_tracker
        resource_tracker._resource_tracker._stop()


def rank_process(rank: int, parent_pid: int, ends: list):
    """Set up the process of rank `rank` > 0 (a Ranks target calls this
    first) and return the pipe to send its result over: the rank dies with
    rank 0 (PR_SET_PDEATHSIG, and at once where rank 0 is gone already),
    leads a session of its own for Ranks.close, and writes its standard
    output and error into the pipe rank 0 forwards to its standard error."""
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != parent_pid:
        os._exit(1)
    os.setsid()
    result, output = ends[rank - 1]
    os.dup2(output.fileno(), 1)
    os.dup2(output.fileno(), 2)
    for end in ends:
        for conn in end:
            if conn is not result:
                conn.close()
    return result


def _plain(o):
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def send_result(conn, payload: dict) -> None:
    """Send `payload` (JSON; tensors and arrays as lists) to rank 0 over
    the pipe `conn`, and close it."""
    conn.send_bytes(json.dumps(payload, default=_plain).encode())
    conn.close()


def _worse(a, b):
    """The worse of two readings compared by `value <= limit`: the larger,
    and NaN where either is NaN (it never passes)."""
    if a != a or b != b:
        return float("nan")
    return max(a, b)


def merge_results(per_rank: list) -> dict:
    """The one result line of a run from each rank's result object, in rank
    order, by the rules in this module's docstring. A run on one card
    gives its rank's result back unchanged."""
    if len(per_rank) == 1:
        return per_rank[0]
    r0 = per_rank[0]
    checks = {}
    for res in per_rank:
        for name, c in res["checks"].items():
            prev = checks.get(name)
            checks[name] = {"value": c["value"] if prev is None
                            else _worse(prev["value"], c["value"]),
                            "limit": c["limit"]}
    within = all(c["value"] <= c["limit"]
                 for res in per_rank for c in res["checks"].values())
    attempted = int(r0["attempted"])
    out = {"correct": bool(within and any(res["correct"]
                                          for res in per_rank)),
           "attempted": attempted,
           "failed": min(sum(int(res["failed"]) for res in per_rank),
                         attempted),
           "metrics": r0["metrics"]}
    if "breakdown" in r0:
        out["breakdown"] = r0["breakdown"]
    devs = [res["device"] for res in per_rank]
    powers = [d["power_limit_w"] for d in devs
              if d.get("power_limit_w") is not None]
    dev = {"platform": devs[0]["platform"], "kind": devs[0]["kind"],
           "count": len(per_rank),
           "memory_peak_bytes": max(int(d["memory_peak_bytes"])
                                    for d in devs),
           "power_limit_w": min(powers) if powers else None,
           "memory_peak_bytes_by_card": [int(d["memory_peak_bytes"])
                                         for d in devs]}
    if all("busy_s" in d for d in devs):
        busy = [d["busy_s"] for d in devs]
        window = [d["window_s"] for d in devs]
        dev.update(busy_s=sum(busy) / len(busy),
                   window_s=sum(window) / len(window),
                   busy_s_by_card=busy, window_s_by_card=window,
                   collective_s_by_card=[d.get("collective_s", 0.0)
                                         for d in devs])
    out["device"] = dev
    by_rank = []
    for rank, res in enumerate(per_rank):
        entry = {"rank": rank, "correct": res["correct"],
                 "attempted": res["attempted"], "failed": res["failed"],
                 "metrics": {k: m["value"]
                             for k, m in res["metrics"].items()},
                 "checks": {k: c["value"] for k, c in res["checks"].items()},
                 "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        if "pci_bus_id" in res["device"]:
            entry["pci_bus_id"] = res["device"]["pci_bus_id"]
        entry["info"] = res["info"]
        by_rank.append(entry)
    out["info"] = dict(r0["info"], by_rank=by_rank)
    out["checks"] = checks
    return out
