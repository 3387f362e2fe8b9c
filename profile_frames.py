#!/usr/bin/env python3
"""Where a frame's and a train step's time goes, on one NVIDIA GPU.

    python3 profile_frames.py [--iters 8]

For four cells of chip_smoke.py (the app frame: 37,941 seeded gaussians,
1280x720, relaxed; the 1M frame: 2^20 gaussians, tile_group=3, exact
tiles, strict; the 1M train step, L1, against the model's own angle-0
render; the train app's step: its 640x360 initial model against the
scene's render, L1 + 0.2 SSIM) it runs 3 warm-up iterations, then
  - pipelined ms: host wall time per iteration of --iters enqueued back
    to back and synchronised once; enqueue ms: the host time to issue
    them;
  - with torch.profiler over 3 iterations: device kernel ms per
    iteration (the sum of every CUDA kernel's time), the busy share
    (device ms over pipelined ms), the kernel count, and the time and
    share of kernels C (rasterize_fwd_kernel) and D (rasterize_bwd_kernel).
One JSON line per cell, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as smoke


def profile(fn, iters: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    reps = 3
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us, kernels, by_name = 0.0, 0, {}
    for ev in prof.key_averages():
        us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        if us <= 0.0 or ev.device_type.name != "CUDA":
            continue
        device_us += us
        kernels += ev.count
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us
    pipelined = (t2 - t0) * 1e3 / iters
    device = device_us / 1e3 / reps
    out = dict(pipelined_ms=pipelined, enqueue_ms=(t1 - t0) * 1e3 / iters,
               device_ms=device, busy_share=device / pipelined,
               kernels_per_iter=kernels / reps)
    for label, key in (("C", "rasterize_fwd_kernel"),
                       ("D", "rasterize_bwd_kernel")):
        ms = sum(v for k, v in by_name.items() if key in k) / 1e3 / reps
        out[f"{label}_ms"] = ms
        out[f"{label}_share_of_device"] = ms / device if device else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["largest"] = [(k[:60], v / 1e3 / reps) for k, v in top]
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("no CUDA GPU")
    from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    fov = float(np.radians(40.0))
    ply = os.path.join(tempfile.mkdtemp(prefix="gsplat_prof_"), "scene.ply")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    scene_io.write_ply(ply, GaussianModel.random(
        smoke.APP_GAUSSIANS, generator=gen, device=dev))
    app = scene_io.load_scene(ply, device=dev)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    model_1m = GaussianModel.random(smoke.N_1M, generator=gen, device=dev)
    bb = np.ones(3, np.float32)
    cam_1m = Camera.orbit(-bb, bb, fov, 1280 / 720, device=dev)
    cam_app = Camera.orbit(app.bb_min, app.bb_max, fov, 1280 / 720,
                           device=dev)

    cfg_app = RasterConfig(pair_capacity=1 << 19, strict_termination=False)
    cfg_1m = RasterConfig(pair_capacity=1 << 22, tile_group=3,
                          exact_tile_test=True)
    with torch.inference_mode():
        b = binning.bin_splats(project_gaussians(model_1m, cam_1m, cfg_1m),
                               cfg_1m)
        cfg_1m = dataclasses.replace(cfg_1m, pair_capacity=max(
            -(-int(1.15 * int(b.num_pairs + b.overflow)) // 128) * 128,
            512))
        target_1m = pipeline.render(model_1m, cam_1m, cfg_1m).image
    target_1m = target_1m.clone()   # a normal tensor for autograd
    del b

    def app_frame():
        with torch.inference_mode():
            pipeline.render(app.model, cam_app, cfg_app)

    def frame_1m():
        with torch.inference_mode():
            pipeline.render(model_1m, cam_1m, cfg_1m)

    tc_1m = trainer.TrainConfig(ssim_weight=0.0)
    state_1m = trainer.init_state(model_1m.trainable(), tc_1m)

    def step_1m():
        trainer.train_step(state_1m, cam_1m, target_1m, cfg_1m, tc_1m)

    cfg_t = RasterConfig(image_width=smoke.TRAIN_W,
                         image_height=smoke.TRAIN_H)
    cam_t = Camera.orbit(app.bb_min, app.bb_max, fov,
                         smoke.TRAIN_W / smoke.TRAIN_H, device=dev)
    with torch.inference_mode():
        target_t = pipeline.render(app.model, cam_t, cfg_t).image
    target_t = target_t.clone()
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    init = GaussianModel.random(
        smoke.APP_GAUSSIANS, generator=gen, device=dev,
        extent=float(np.linalg.norm(app.bb_max - app.bb_min) * 0.5))
    tc_t = trainer.TrainConfig()
    state_t = trainer.init_state(init.trainable(), tc_t)

    def step_app():
        trainer.train_step(state_t, cam_t, target_t, cfg_t, tc_t)

    for cell, fn in (("app 37.9k relaxed frame", app_frame),
                     ("1M frame", frame_1m), ("train 1M step", step_1m),
                     ("train app 640x360 step", step_app)):
        smoke.say("profile", cell=cell, **profile(fn, args.iters))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
