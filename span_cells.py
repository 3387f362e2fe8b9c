#!/usr/bin/env python3
"""The program's spans in the benchmark's cells, and what recording them
costs, on one NVIDIA GPU.

    python3 span_cells.py [--cells c1,c2] [--seeds s1,s2] [--seconds 10] \
        [--out span_cells.jsonl]

For each cell of BENCHMARK.json and each seed, the benchmark's driver
(splatbench/run.py's run_one, in this process) runs the cell four times
with --trace 0, span recording off, on, on, off (utils/profiling.py; on:
started before the driver registers its program, so the captures hold
the stamps), and then once with --trace 1 and recording on. The harness's
own spans "to_host" (orbit) and "retire" (fit) are stamped on the device
track too; they are the benchmark's, not the program's.

From each recorded run, over the window's items (engine runs whose device
span lies between the window's start, when the driver clears its span
times, and the end of its last span before the traced stretch):
  - the median device ms per item of "project", "bin", "loss" +
    "loss.bwd" and "adam";
  - stream idle %: 100 x (1 - the union of the device spans engine.run
    and to_host / retire over the window); gaps inside a graph are busy;
  - the share of each item's engine.run device span its direct children
    cover (min and median);
  - each second's median device ms of engine.run and of each stage
    beside the frames or steps the host retired in that second;
  - the median host ms of engine.run, copy_in, replay, clone_out and the
    harness's to_host / retire;
  - register_s: the Tracepoint channel engine.register; the anchor's
    error, the log's entries and overflow;
and from the traced run: the profiler's idle gaps labelled by the
harness's spans with the program's host spans merged in, the share of
kernel C's (D's) device time inside "raster" ("backward") spans, the
profiler's start of each stamp kernel less the log's reading of it on the
host's clock, fitted as a line over the stretch (its value at the
stretch's start in us, its drift in ppm: the profiler's own conversion of
device time drifts while nothing synchronises), and the stamp kernel's
device ms per item. Anchors are also taken where the window starts and
around the traced stretch. Every line holds the median host ms of the
harness's own spans in the window (enqueue, to_host, retire), recording
on or off. One JSON line per run, then a summary per cell (the e2e
medians off and on), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STAMPED = ("to_host", "retire")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", default="")
    p.add_argument("--seeds", default="3000000019")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default="span_cells.jsonl")
    return p.parse_args(argv)


def _window_spans(harness, profiling, device):
    """A harness.Spans that stamps the harness's own to_host / retire on
    the device track and keeps the window's bounds on the host clock."""

    class Times(dict):
        def clear(self):
            if profiling.active is not None:
                profiling.active.anchor()
            spans.window = [time.time_ns(), None]
            super().clear()

    class WindowSpans(harness.Spans):
        def __init__(self):
            super().__init__()
            self.times, self.window, self.last_end = Times(), None, None
            self._marks = None

        @property
        def marks(self):
            return self._marks

        @marks.setter
        def marks(self, value):
            if value is not None and self.window and self.window[1] is None:
                self.window[1] = self.last_end
            if value is not None and profiling.active is not None:
                profiling.active.anchor()     # the traced stretch starts
            self._marks = value

        @contextlib.contextmanager
        def __call__(self, name):
            stamp = (profiling.span(name, device) if name in STAMPED
                     else contextlib.nullcontext())
            with stamp, super().__call__(name):
                yield
            self.last_end = time.time_ns()

    spans = WindowSpans()
    return spans


def _offsets(mapped, starts, t0):
    """The profiler's start of each stamp kernel less the nearest log
    reading on the host's clock, fitted as a line over the time since the
    stretch began (t0): [at the start in us, drift in ppm, median |residual|
    in us]."""
    import bisect
    xs, ys = [], []
    for c in starts:
        j = bisect.bisect(mapped, c)
        near = [mapped[k] for k in (j - 1, j) if 0 <= k < len(mapped)]
        xs.append((c - t0) * 1e-9)
        ys.append(min((c - r for r in near), key=abs) * 1e-3)
    n, mx, my = len(xs), statistics.fmean(xs), statistics.fmean(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx \
        if n > 1 and sxx > 0 else 0.0
    at0 = my - slope * mx
    resid = statistics.median(abs(y - at0 - slope * x)
                              for x, y in zip(xs, ys))
    return [round(at0, 3), round(slope, 2), round(resid, 3)]


def _readings(profiling, rec, spans, kind, captured):
    """The readings of one recorded run (module docstring)."""
    n = min(int(rec.state[0]), rec.capacity)
    raw = rec.log[:n, 1].tolist()
    allspans = rec.collect()
    t0, t1 = spans.window[0], spans.window[1] or spans.last_end
    dev = [s for s in allspans if s.track == "device"]
    runs = {s.item: s for s in dev if s.name == "engine.run"
            and t0 <= s.start_ns and s.end_ns <= t1}

    def med(names):
        per = {}
        for name in names:
            for k, ms in profiling.item_ms(dev, name).items():
                if k in runs:
                    per[k] = per.get(k, 0.0) + ms
        return statistics.median(per.values()) if per else None

    cover = [c for k, c in profiling.coverage(dev).items() if k in runs]
    busy = profiling.union_ns(dev, ("engine.run",) + STAMPED, t0, t1)
    per_second = {}
    for s in runs.values():
        per_second.setdefault(int((s.start_ns - t0) // 1e9), []).append(
            s.item)

    def second_ms(names):
        out = []
        for _, ks in sorted(per_second.items()):
            per = {}
            for name in names:
                for k, ms in stage[name].items():
                    if k in ks:
                        per[k] = per.get(k, 0.0) + ms
            out.append(round(statistics.median(per.values()), 4)
                       if per else None)
        return out

    stage = {name: profiling.item_ms(dev, name) for name in (
        "engine.run", "project", "bin", "raster", "render", "loss",
        "loss.bwd", "backward", "adam")}
    out = dict(
        items=len(runs),
        project_ms=med(["project"]) if kind == "view" else None,
        binning_ms=med(["bin"]) if kind == "view" else None,
        loss_ms=med(["loss", "loss.bwd"]) if kind == "train" else None,
        adam_ms=med(["adam"]) if kind == "train" else None,
        raster_ms=med(["raster"]), render_ms=med(["render"]),
        backward_ms=med(["backward"]), engine_run_ms=med(["engine.run"]),
        stream_idle=100.0 * (1.0 - busy / (t1 - t0)),
        coverage_min=min(cover) if cover else None,
        coverage_median=statistics.median(cover) if cover else None,
        ms_per_second={name: second_ms([name]) for name in stage},
        host_ms={name: round(statistics.median(v), 4) for name in (
            "engine.run", "copy_in", "replay", "clone_out") + STAMPED
            if (v := [(s.end_ns - s.start_ns) / 1e6 for s in allspans
                      if s.track == "host" and s.name == name
                      and t0 <= s.start_ns <= t1])},
        register_s=profiling.tracepoint_summary().get(
            "engine.register", {}).get("total_s"),
        anchor_error_us=rec.anchor_error_ns / 1e3,
        log_entries=rec.entries, log_overflow=rec.overflow,
        counters={k: v for k, v in rec.summary().items()
                  if k.startswith(("captures", "replays"))})
    if captured:
        events, merged, items = captured["events"], captured["merged"], \
            captured["items"]

        def kernels(key):
            return [(e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if e.device_type().name == "CUDA"
                    and not e.is_user_annotation() and key in e.name()]

        def inside(ivs, name):
            sp = [(s.start_ns, s.end_ns) for s in dev if s.name == name]
            tot = sum(b - a for a, b in ivs)
            cov = sum(max(0, min(b, d) - max(a, c)) for a, b in ivs
                      for c, d in sp)
            return cov / tot if tot else None

        stamps = kernels("stamp_kernel")
        stamp_s = sum(b - a for a, b in stamps) * 1e-9
        mapped = sorted(rec.to_host(t) for t in raw)
        out.update(
            clock_offset_us=_offsets(mapped, sorted(a for a, _ in stamps),
                                     captured["t0"]) if stamps else None,
            idle_gaps_merged=merged["idle_gaps"],
            c_in_raster=inside(kernels("rasterize_fwd_kernel"), "raster"),
            d_in_backward=inside(kernels("rasterize_bwd_kernel"),
                                 "backward"),
            stamp_ms_per_item=stamp_s * 1e3 / items if items else None,
            stretch_busy_ms_per_item=merged["busy_s"] * 1e3 / items)
    return out


def run_cell(cell, seed, seconds, trace, record, device):
    """One run of `cell` (harness.Cell) with recording on or off: its
    line (module docstring)."""
    import torch

    from gaussian_splat_ipu_tpu_torch.utils import profiling
    from splatbench import harness
    from splatbench import run as sb_run

    name, traffic = cell.name, cell.traffic
    kind = "view" if traffic["driver"] == "orbit" else "train"
    spans = _window_spans(harness, profiling, device)
    captured = {}
    orig = harness.read_profile

    def read_profile(events, marks, t_begin, t_end):
        events = list(events)
        rec = profiling.active
        prog = [(s.start_ns, s.end_ns, s.name) for s in rec.spans
                if s.track == "host"] if rec else []
        if rec is not None:
            rec.anchor()
        captured.update(events=events, t0=t_begin,
                        merged=orig(events, list(marks) + prog, t_begin,
                                    t_end))
        return orig(events, marks, t_begin, t_end)

    profiling.reset_tracepoints()
    rec = profiling.start(device) if record else None
    harness.read_profile = read_profile
    real_spans = harness.Spans
    harness.Spans = lambda: spans
    try:
        t = time.perf_counter()
        res = sb_run.run_one(cell, seed, seconds, trace, device, t)
        out = dict(cell=name, seed=seed, trace=int(trace),
                   record=bool(record), correct=res["correct"],
                   e2e={k: v["value"] for k, v in res["metrics"].items()},
                   per_second=res["info"].get("per_second"),
                   harness_ms={k: round(statistics.median(v) * 1e3, 4)
                               for k, v in spans.times.items() if v})
        if record:
            if captured:
                captured["items"] = traffic["profiled_frames"] \
                    if kind == "view" else traffic["views_per_ring"] * len(
                        traffic["ring_pitch_deg"])
            out["spans"] = _readings(profiling, rec, spans, kind,
                                     captured if trace else None)
        if trace:
            out["breakdown"] = res.get("breakdown")
    finally:
        harness.read_profile = orig
        harness.Spans = real_spans
        profiling.stop()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, HERE)
    import torch

    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from splatbench import harness
    if not torch.cuda.is_available():
        raise SystemExit("span_cells.py measures on a CUDA card only")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cuda_lib.library()
    cells = args.cells.split(",") if args.cells else [
        w["name"] for w in harness.benchmark()["workloads"]]
    seeds = [int(s) for s in args.seeds.split(",")]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows = []
    with open(args.out, "a") as f:
        for name in cells:
            cell = harness.find_cell(name)
            for seed in seeds:
                for record in (False, True, True, False):
                    rows.append(run_cell(cell, seed, args.seconds, False,
                                         record, device))
                    print(json.dumps(rows[-1]), flush=True)
                    f.write(json.dumps(rows[-1]) + "\n")
            rows.append(run_cell(cell, seeds[0], args.seconds, True, True,
                                 device))
            print(json.dumps(rows[-1]), flush=True)
            f.write(json.dumps(rows[-1]) + "\n")
            key = "frame_ms" if name.endswith("orbit") else "step_ms"
            summary = {"cell": name, "metric": key}
            for record in (False, True):
                vals = [r["e2e"][key] for r in rows if r["cell"] == name
                        and not r["trace"] and r["record"] == record]
                summary["on" if record else "off"] = vals
                summary[("on" if record else "off") + "_median"] = \
                    statistics.median(vals)
            summary["cost"] = summary["on_median"] / summary["off_median"] - 1
            print(json.dumps(summary), flush=True)
            f.write(json.dumps(summary) + "\n")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
