"""Run one cell of the benchmark once, on the machine it is started on.

    python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the end-to-end metrics (--trace 0) or
the per-layer metrics (--trace 1) as the last line of standard output, a
JSON object with correct, attempted, failed, metrics, device, breakdown
(traced runs) and, last, checks: each number the comparison with the
plain reference judged, beside its limit (also the last lines of standard
error). The program under test is the checkout's gaussian_splat_ipu_tpu_torch.

A cell with "chips" W > 1 runs one process per card: this process is rank
0, on cuda:0; it starts ranks 1..W-1 with torch.multiprocessing (spawn,
harness.Ranks), rank r on cuda:r. Every rank sets GSPLAT_COORDINATOR
(127.0.0.1:<a free port>), GSPLAT_NUM_PROCESSES and GSPLAT_PROCESS_ID, the
program's own multi-process contract, through which the cell's driver
joins the group (parallel/multihost.initialize). Each rank resets and
reads the peak memory of its own card and, traced, profiles its own card.
The ranks hand their results to rank 0 over pipes, and rank 0 prints the
one line, merged as harness.py's docstring sets out: device.count W, the
fullest card's memory_peak_bytes, the by-card lists, rank 0's end-to-end
metrics and each rank's in info.by_rank. A rank that ends with a code
other than 0, or in which JAX is loaded, ends every rank: the run exits
non-zero and prints no result. With one card there is no other process
and no GSPLAT_* variable.

Exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), without the program's package in the
checkout, or when JAX or the JAX package is loaded once the window has
closed.

For setting the limits of the comparison (no run of the benchmark passes
these): --control bfloat16 runs the cell's control instead, the plain
reference in bfloat16 in the program's place, judged as a run is;
--fault plants one of the faults a cell can have under the timed path (a
step that leaves its state unchanged, half the image's rows left out, an
answer altered). --bench runs a cell of another benchmark file (the
harness's tests' fixtures) in place of the checkout's BENCHMARK.json.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--control", default="", choices=("", "bfloat16"))
    p.add_argument("--fault", default=None,
                   choices=("step_unchanged", "half_batch", "answer"))
    p.add_argument("--bench", default=os.path.join(ROOT, "BENCHMARK.json"))
    return p.parse_args(argv)


def _env():
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = os.path.join(CACHE, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def fail(code: int, msg: str):
    print(f"splatbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def run_rank(cell, seed, seconds, trace, device, t_start, control="",
             fault=None, rank=0, world=1):
    """Run `cell` once in this process, as rank `rank` of `world` on
    `device`: this rank's result object (per-layer metrics not yet read)
    and its traced reading for the per-layer readers (None untraced)."""
    import torch

    from splatbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    ctx = types.SimpleNamespace(cell=cell, seed=seed, seconds=seconds,
                                trace=trace, device=device, t_start=t_start,
                                control=control, fault=fault, rank=rank,
                                world=world, spans=harness.Spans())
    out = cell.driver.run(ctx)
    checks, ok = harness.judge(out["readings"], cell.limits)
    result = {"correct": bool(ok and out["checked"] > 0),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    metrics = {}
    if not trace and not control:
        for m in cell.e2e:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    result["metrics"] = metrics
    card = harness.card_facts(device.index or 0) \
        if device.type == "cuda" else {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"]),
           "power_limit_w": card.get("power_limit_w")}
    if world > 1:
        dev["pci_bus_id"] = card.get("pci_bus_id")
    prof = (out.get("layer") or {}).get("profile") or {}
    if trace and prof:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        if world > 1:
            dev["collective_s"] = sum(s for k, s in prof["kernel_s"].items()
                                      if "nccl" in k.lower())
        result["breakdown"] = {"device_ops": [list(x)
                                              for x in prof["top_ops"]],
                               "idle_gaps": [list(x)
                                             for x in prof["idle_gaps"]]}
    result["device"] = dev
    result["info"] = out.get("info", {})
    result["checks"] = checks
    return result, (out.get("layer") if trace and not control else None)


def finish(cell, results, layers, trace, control="") -> dict:
    """The printed result of a run from its ranks' results and traced
    readings (rank order): merged, and traced, with the per-layer metrics
    read from rank 0's reading and, under by_rank, every rank's."""
    from splatbench import harness

    result = harness.merge_results(results)
    if trace and not control:
        power = result["device"]["power_limit_w"]
        r = dict(layers[0], rc=cell.config.get("raster"),
                 scene=cell.config.get("scene"), by_rank=layers)
        r.setdefault("ssim_weight", 0.0)
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"], cell.home).read(r)
            if value is None or not math.isfinite(value):
                continue
            entry = {"value": value, "unit": m["unit"]}
            if "roofline" in m["name"] or "mfu" in m["name"]:
                entry["power_limit_w"] = power
            result["metrics"][m["name"]] = entry
    return result


def run_one(cell, seed, seconds, trace, device, t_start, control="",
            fault=None) -> dict:
    """Run `cell` once in this one process and return its result object."""
    result, layer = run_rank(cell, seed, seconds, trace, device, t_start,
                             control=control, fault=fault)
    return finish(cell, [result], [layer], trace, control)


def rank_main(index, parent_pid, world, coordinator, ends, args, bench,
              device_type):
    """Rank index + 1 of a cell on `world` cards, in a process of its own
    (harness.Ranks starts it): runs the cell and sends its result and
    traced reading to rank 0."""
    from splatbench import harness

    rank = index + 1
    conn = harness.rank_process(rank, parent_pid, ends)
    harness.rank_env(coordinator, world, rank)
    result, layer = run_rank(harness.find_cell(args.workload, bench),
                             args.seed, args.seconds, bool(args.trace),
                             _device(device_type, rank), T_START,
                             control=args.control, fault=args.fault,
                             rank=rank, world=world)
    blocked = harness.blocked_modules()
    if blocked:
        fail(4, f"JAX or the JAX package is loaded in rank {rank}: {blocked}")
    harness.send_result(conn, {"result": result, "layer": layer})


def _device(device_type: str, rank: int):
    import torch
    return torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device(device_type)


def run_cell(args, bench: dict, device_type: str) -> int:
    """Run the cell as rank 0, on cuda:0 or on `device_type` "cpu" (the
    harness's tests), with the other ranks its `chips` asks for, and print
    the result."""
    from splatbench import harness

    world = int(harness.workload(bench, args.workload)["chips"])
    ranks = None
    if world > 1:
        ranks = harness.Ranks(rank_main, (args, bench, device_type), world)
        harness.rank_env(ranks.coordinator, world, 0)
    try:
        cell = harness.find_cell(args.workload, bench)
        result, layer = run_rank(cell, args.seed, args.seconds,
                                 bool(args.trace), _device(device_type, 0),
                                 T_START, control=args.control,
                                 fault=args.fault, world=world)
        results, layers = [result], [layer]
        if ranks is not None:
            for other in ranks.collect():
                results.append(other["result"])
                layers.append(other["layer"])
        result = finish(cell, results, layers, bool(args.trace),
                        args.control)
    except harness.RankFailed as e:
        fail(5, f"{e}: ending every rank")
    finally:
        if ranks is not None:
            ranks.close()
    blocked = harness.blocked_modules()
    if blocked:
        fail(4, f"JAX or the JAX package is loaded: {blocked}")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    _env()
    if not os.path.isfile(os.path.join(ROOT, "gaussian_splat_ipu_tpu_torch",
                                       "__init__.py")):
        fail(2, f"the program's package gaussian_splat_ipu_tpu_torch is not "
                f"in the checkout at {ROOT}")
    import torch

    from splatbench import harness

    bench = harness.load_json(args.bench)
    chips = int(harness.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available():
        fail(3, "no CUDA device is available: the benchmark runs only on "
                "the card")
    if torch.cuda.device_count() < chips:
        fail(3, f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} are visible")
    return run_cell(args, bench, "cuda")


if __name__ == "__main__":
    raise SystemExit(main())
