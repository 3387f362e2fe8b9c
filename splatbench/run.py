"""Run one cell of the benchmark once, on the machine it is started on.

    python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the end-to-end metrics (--trace 0) or
the per-layer metrics (--trace 1) as the last line of standard output, a
JSON object with correct, attempted, failed, metrics, device, breakdown
(traced runs) and, last, checks: each number the comparison with the
plain reference judged, beside its limit (also the last lines of standard
error). The program under test is the checkout's gaussian_splat_ipu_tpu_torch.

Exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), without the program's package in the
checkout, or when JAX or the JAX package is loaded once the window has
closed.

For setting the limits of the comparison (no run of the benchmark passes
these): --control bfloat16 runs the cell's control instead, the plain
reference in bfloat16 in the program's place, judged as a run is;
--fault plants one of the faults a cell can have under the timed path (a
step that leaves its state unchanged, half the image's rows left out, an
answer altered).
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


def run_one(cell, seed, seconds, trace, device, t_start, control="",
            fault=None) -> dict:
    """Run `cell` once in this process and return its result object."""
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
                                control=control, fault=fault,
                                spans=harness.Spans())
    out = cell.driver.run(ctx)
    checks, ok = harness.judge(out["readings"], cell.limits)
    result = {"correct": bool(ok and out["checked"] > 0),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    metrics = {}
    power = harness.power_limit_w() if device.type == "cuda" else None
    if trace and not control:
        r = dict(out["layer"], rc=cell.config["raster"],
                 scene=cell.config["scene"])
        r.setdefault("ssim_weight", 0.0)
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"]).read(r)
            if value is None or not math.isfinite(value):
                continue
            entry = {"value": value, "unit": m["unit"]}
            if "roofline" in m["name"] or "mfu" in m["name"]:
                entry["power_limit_w"] = power
            metrics[m["name"]] = entry
    elif not control:
        for m in cell.e2e:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"]),
           "power_limit_w": power}
    prof = (out.get("layer") or {}).get("profile") or {}
    if trace and prof:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": [list(x)
                                              for x in prof["top_ops"]],
                               "idle_gaps": [list(x)
                                             for x in prof["idle_gaps"]]}
    result["device"] = dev
    result["info"] = out.get("info", {})
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    _env()
    if not os.path.isfile(os.path.join(ROOT, "gaussian_splat_ipu_tpu_torch",
                                       "__init__.py")):
        fail(2, f"the program's package gaussian_splat_ipu_tpu_torch is not "
                f"in the checkout at {ROOT}")
    import torch

    from splatbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        fail(3, "no CUDA device is available: the benchmark runs only on "
                "the card")
    if torch.cuda.device_count() < cell.chips:
        fail(3, f"the cell asks for {cell.chips} cards, "
                f"{torch.cuda.device_count()} are visible")
    device = torch.device("cuda", 0)
    result = run_one(cell, args.seed, args.seconds, bool(args.trace), device,
                     T_START, control=args.control, fault=args.fault)
    blocked = harness.blocked_modules()
    if blocked:
        fail(4, f"JAX or the JAX package is loaded: {blocked}")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
