#!/usr/bin/env python3
"""Kernel G, the projection stage in one pass, against the plain
projection on one NVIDIA GPU, over the poses of the benchmark's orbit
cells.

    python3 project_ab.py [--cells capture1m-orbit,demo38k-orbit] \
        [--seed 3000000019] [--poses 360] [--out chiprun_out/project_ab.jsonl]

For each cell: its scene drawn from --seed and its camera at --poses yaws
a degree apart from the seed's first yaw (splatbench's inputs, as the
orbit driver makes them), its raster config at the cell's probed
capacity. At each pose, under inference mode: G
(render/projection.project_gaussians) against the plain version
(project_gaussians_torch) by render/kernels/project.compare, and a frame
through render() both ways (the plain one with pipeline's
project_gaussians replaced), its img_rel_l2 and img_max_abs. Then, at the
first pose, chip_smoke.project_row: the device time of G and of the plain
version (chip_smoke.DeviceTimer), G's byte bound (each input byte it needs
read once, each output byte written once, at 3.35 TB/s) and its share of
it. One JSON line per cell (the worst over the poses), then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess

import chip_smoke as smoke


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", default="capture1m-orbit,demo38k-orbit")
    p.add_argument("--seed", type=int, default=3000000019)
    p.add_argument("--poses", type=int, default=360)
    p.add_argument("--out", default="chiprun_out/project_ab.jsonl")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import pipeline, projection
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from gaussian_splat_ipu_tpu_torch.render.kernels import project as kernel
    from splatbench import harness, inputs
    if not torch.cuda.is_available():
        smoke.fail("project_ab.py measures on a CUDA card only")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.library()
    timer = smoke.DeviceTimer()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for name in args.cells.split(","):
        cell = harness.find_cell(name)
        config, rc = cell.config, cell.config["raster"]
        params = inputs.make_scene(config["scene"], args.seed, dev)
        model = GaussianModel(*(params[k] for k in inputs.FIELDS))
        start = inputs.orbit_start_yaw(args.seed)
        cams = [tuple(t.to(dev) for t in inputs.orbit_camera(
            config["scene"]["box_min"], config["scene"]["box_max"],
            math.radians(config["fov_deg"]),
            rc["image_width"] / rc["image_height"],
            float(cell.traffic["pitch_deg"]), float((start + k) % 360)))
            for k in range(args.poses)]
        cfg = harness.raster_config(config, harness.probe_capacity(
            config, [params], cams))
        cuda_lib.launches.clear()
        projection.plain_calls.clear()
        worst, flips, rel, mx = {}, [], [], []
        with torch.inference_mode():
            for v, p, e in cams:
                cam = Camera(v, p, e)
                res = kernel.compare(
                    projection.project_gaussians(model, cam, cfg),
                    projection.project_gaussians_torch(model, cam, cfg), cfg)
                for k, val in res.items():
                    worst[k] = max(worst.get(k, 0), val)
                flips.append(res["radius_differ"])
                img = pipeline.render(model, cam, cfg).image
                pipeline.project_gaussians = \
                    projection.project_gaussians_torch
                try:
                    ref = pipeline.render(model, cam, cfg).image
                finally:
                    pipeline.project_gaussians = projection.project_gaussians
                rel.append(harness.rel_l2(img, ref))
                mx.append(harness.max_abs(img, ref))
            launches = dict(cuda_lib.launches)
            timed = smoke.project_row(name, model, Camera(*cams[0]), cfg,
                                      timer.ms)
        row = dict(cell=name, seed=args.seed, gaussians=model.num_gaussians,
                   poses=len(cams), pair_capacity=cfg.pair_capacity,
                   **worst, radius_differ_total=sum(flips),
                   poses_with_radius_differ=sum(f > 0 for f in flips),
                   img_rel_l2=max(rel), img_max_abs=max(mx),
                   **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "bytes")},
                   share=timed["bound_ms"] / timed["ms"], launches=launches,
                   plain_calls=dict(projection.plain_calls))
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        del model, params
        torch.cuda.empty_cache()
    print(json.dumps(timer.summary()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
