#!/usr/bin/env python3
"""Where a frame's and a train step's time goes, on one NVIDIA GPU.

    python3 profile_frames.py [--iters 8]

For nine cells of chip_smoke.py (the app frame: 37,941 seeded
gaussians, 1280x720, relaxed; the 1M frame: 2^20 gaussians,
tile_group=3, exact tiles, strict; each of the two replayed as a CUDA
graph by the app's RenderEngine, with the camera copied in from the host
each call; the 1M train step, L1, against the model's own angle-0
render; the train app's step: its 640x360 initial model against the
scene's render, L1 + 0.2 SSIM; each of the two steps replayed as the
train program of trainer.register_step, with the camera and the target
copied in each call; the rowseg 1M frame: chip_smoke.py's rowseg_config,
tile_group=2, exact tiles, strict) it runs 3 warm-up iterations, then
  - pipelined ms: host wall time per iteration of --iters enqueued back
    to back and synchronised once; enqueue ms: the host time to issue
    them;
  - with torch.profiler over 3 iterations: device kernel ms per
    iteration (the sum of every CUDA kernel's time), the busy share
    (device ms over pipelined ms), the kernel count, and the largest
    kernels; then, on a line each, the time, share of device time and
    launches per iteration of each of the port's kernels A-F that ran.
One JSON line per cell and one per kernel of it, then the card's name and
power limit.
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

# The port's kernels by a part of their CUDA name, as torch.profiler
# reports them.
PORT_KERNELS = (("A coverage_masks", "coverage_masks_kernel"),
                ("B stream_expand", "stream_expand_kernel"),
                ("B stream_expand_seg", "stream_expand_seg_kernel"),
                ("C rasterize_fwd", "rasterize_fwd_kernel"),
                ("D rasterize_bwd", "rasterize_bwd_kernel"),
                ("E row_scan", "row_scan"),
                ("F expand_pairs", "expand_pairs_kernel"))


def profile(fn, iters: int) -> tuple:
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
    device_us, kernels, by_name, counts = 0.0, 0, {}, {}
    for ev in prof.key_averages():
        us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        if us <= 0.0 or ev.device_type.name != "CUDA":
            continue
        device_us += us
        kernels += ev.count
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us
        counts[ev.key] = counts.get(ev.key, 0) + ev.count
    pipelined = (t2 - t0) * 1e3 / iters
    device = device_us / 1e3 / reps
    out = dict(pipelined_ms=pipelined, enqueue_ms=(t1 - t0) * 1e3 / iters,
               device_ms=device, busy_share=device / pipelined,
               kernels_per_iter=kernels / reps)
    port = {}
    for label, key in PORT_KERNELS:
        names = [k for k in by_name if key in k]
        if names:
            ms = sum(by_name[k] for k in names) / 1e3 / reps
            port[label] = dict(
                ms=ms, share_of_device=ms / device,
                launches_per_iter=sum(counts[k] for k in names) / reps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["largest"] = [(k[:60], v / 1e3 / reps) for k, v in top]
    return out, port


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
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                          RuntimeConfig)
    import gaussian_splat_ipu_tpu_torch.app.main as app_main

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

    with torch.inference_mode():
        cfg_rs, rs_info = smoke.rowseg_config(
            binning, project_gaussians, model_1m,
            lambda a: Camera.orbit(-bb, bb, fov, 1280 / 720, rot_y_deg=a,
                                   device=dev),
            RasterConfig(pair_capacity=1 << 22, tile_group=2,
                         exact_tile_test=True))

    def frame_rowseg():
        with torch.inference_mode():
            pipeline.render(model_1m, cam_1m, cfg_rs)

    # The same two frames replayed as CUDA graphs by the app's engine,
    # each call copying a camera made on the host, as the app does.
    engine = RenderEngine(RuntimeConfig(device="cuda"))
    replays = {}
    for name, model, cfg, bb_min, bb_max in (
            ("app", app.model, cfg_app, app.bb_min, app.bb_max),
            ("1m", model_1m, cfg_1m, -bb, bb)):
        cam = Camera.orbit(bb_min, bb_max, fov, 1280 / 720, device="cpu")
        host = (model, cam.view, cam.proj, cam.env_rot)
        engine.register(name, app_main.splat_program(cfg),
                        (model, *(t.to(dev) for t in host[1:])))
        replays[name] = (lambda name=name, host=host:
                         engine.run(name, *host))
    # The two train steps replayed as captured train programs.
    for name, state, cam, target, cfg, tc in (
            ("train 1m", state_1m, cam_1m, target_1m, cfg_1m, tc_1m),
            ("train app", state_t, cam_t, target_t, cfg_t, tc_t)):
        trainer.register_step(engine, state, cam, target, cfg, tc,
                              name=name)
        replays[name] = (lambda name=name, state=state, cam=cam,
                         target=target: engine.run(name, state, cam, target))

    for cell, fn in (("app 37.9k relaxed frame", app_frame),
                     ("app 37.9k relaxed frame, replayed", replays["app"]),
                     ("1M frame", frame_1m),
                     ("1M frame, replayed", replays["1m"]),
                     ("train 1M step", step_1m),
                     ("train 1M step, replayed", replays["train 1m"]),
                     ("train app 640x360 step", step_app),
                     ("train app 640x360 step, replayed",
                      replays["train app"]),
                     (f"rowseg 1M frame (R={rs_info['R']})", frame_rowseg)):
        out, port = profile(fn, args.iters)
        smoke.say("profile", cell=cell, **out)
        for kernel, kv in port.items():
            smoke.say("kernel_in_cell", cell=cell, kernel=kernel, **kv)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
