#!/usr/bin/env python3
"""Where a step of the benchmark's capture1m-densify cell goes, on one NVIDIA
GPU.

    python3 densify_split.py [--seed N] [--out densify_split.json]

On the cell's scene and start (splatbench: the config capture-1m-densify,
the densify traffic's views and perturbation, drawn from the seed), it times
by CUDA events, as the median of 3 runs of 16 replays each:
  - the densify step (train/densify.register_step) and the plain step
    (train/trainer.register_step) and one frame of the render program
    (app/main.splat_program), on the start in 2^21 slots, in 2^20 slots
    (no dead slot), and in 2^20 slots at capture1m-fit's 1.15x pair
    capacity instead of the cell's 2.5x;
and then, on the 2^21-slot buffer, rounds of one epoch of steps (64 views),
one event (densify.densify_and_prune, device ms by CUDA events) and the
pair-demand guard (densify.pair_demand_guard, host ms): two rounds at the
cell's threshold, then every visible gaussian a candidate until the buffer
is full, each round's counts and pair demand printed as one JSON line. The
summary, with the card's name and power limit, is the last line and goes
to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "capture1m-densify"


def timed_ms(fn, n: int = 16) -> float:
    """Median over 3 runs of the device ms of one of n back-to-back calls,
    after 2 warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(3):
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / n)
    return statistics.median(runs)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=1_000_077)
    p.add_argument("--out", default="densify_split.json")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("densify_split.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from splatbench import harness, inputs
    from gaussian_splat_ipu_tpu_torch.app.main import splat_program
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import pipeline
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.train import densify, trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig

    cell = harness.find_cell(CELL)
    drv = cell.driver
    config, traffic = cell.config, cell.traffic
    dev = torch.device("cuda", 0)
    cams = drv.fit._cameras(config, traffic, dev)
    cam_objs = [Camera(*c) for c in cams]
    gt = inputs.make_scene(config["scene"], args.seed, dev)
    init = inputs.perturb(gt, traffic["perturb"], args.seed)
    cap = harness.probe_capacity(config, [gt, init], cams)
    cap115 = harness.probe_capacity(dict(config, capacity={"factor": 1.15}),
                                    [gt, init], cams)
    cfg = harness.raster_config(config, cap)
    with torch.no_grad():
        truth = GaussianModel(*(gt[k] for k in inputs.FIELDS))
        targets = [pipeline.render(truth, c, cfg).image for c in cam_objs]
        del truth
    tc = drv.fit.train_settings(config, traffic)
    tcfg = trainer.TrainConfig(**tc)
    n0, slots = config["scene"]["gaussians"], config["slots"]
    cam0, t0 = cam_objs[0], targets[0]

    def start():
        return GaussianModel(*(init[k].clone() for k in inputs.FIELDS))

    out = dict(seed=args.seed, card=card(), pair_capacity=cap,
               pair_capacity_115=cap115, ms={})
    for label, n, c in (("2^21", slots, cfg), ("2^20", n0, cfg),
                        ("2^20 1.15x", n0,
                         harness.raster_config(config, cap115))):
        st = trainer.init_state(densify.pad_model(start(), n).trainable(),
                                tcfg)
        d = densify.init_state(n0, n, device=dev)
        eng = RenderEngine(RuntimeConfig(device="cuda"))
        densify.register_step(eng, st, d, cam0, t0, c, tcfg)
        trainer.register_step(eng, st, cam0, t0, c, tcfg)
        eng.register("render", splat_program(c), (
            st.params, cam0.view.clone(), cam0.proj.clone(),
            cam0.env_rot.clone()))
        out["ms"]["densify_step " + label] = timed_ms(lambda: eng.run(
            densify.STEP_PROGRAM, st, d.grad_sum, d.vis_count, cam0, t0))
        out["ms"]["train_step " + label] = timed_ms(lambda: eng.run(
            trainer.STEP_PROGRAM, st, cam0, t0))
        out["ms"]["render " + label] = timed_ms(lambda: eng.run(
            "render", st.params, cam0.view, cam0.proj, cam0.env_rot))
        if label == "2^21":
            kept = (st, d, eng)
        del st, d, eng
        torch.cuda.empty_cache()
    print(json.dumps(out["ms"]), flush=True)

    st, d, eng = kept
    scale = densify.loss_mix_scale(start(), cam0, t0, cfg, tc["ssim_weight"])
    ecfg = drv.event_config(config, scale, tc["scene_extent"])
    dcfg = densify.DensifyConfig(**ecfg)
    counts = densify.new_counts(dev)
    out["rounds"] = []
    for rnd in range(8):
        d.grad_sum.zero_()
        d.vis_count.zero_()
        for k, cam in enumerate(cam_objs):
            eng.run(densify.STEP_PROGRAM, st, d.grad_sum, d.vis_count, cam,
                    targets[k])
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, d = densify.densify_and_prune(st, d, dcfg, counts)
        b.record()
        b.synchronize()
        t = time.perf_counter()
        g = densify.pair_demand_guard(eng, st.params, cam_objs, cap,
                                      "render", counts)
        row = dict(round=rnd, threshold=dcfg.grad_threshold,
                   event_ms=a.elapsed_time(b),
                   guard_ms=(time.perf_counter() - t) * 1e3,
                   demand=g.demand, overflow=g.overflow, closes=g.closes,
                   **g.counts)
        out["rounds"].append(row)
        print(json.dumps(row), flush=True)
        if rnd == 1:
            dcfg = densify.DensifyConfig(**dict(ecfg, grad_threshold=0.0))
        if rnd >= 3 and g.counts["alive"] >= slots:
            break
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
