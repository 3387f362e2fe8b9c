#!/usr/bin/env python3
"""Kernels C and D of the PyTorch + CUDA port against an earlier version
of their sources, in turns, on one NVIDIA GPU.

    python3 raster_ab.py --old DIR [--reps 20]

DIR holds an earlier `rasterize.cu` and `rasterize_bwd.cu` with the same
C interface (for example a `git show` of them into a git-ignored
directory). The script builds them into a library of their own with the
port's nvcc flags, makes the frames that chip_smoke.py times (the 1M
config at angle 0: 2^20 seeded gaussians, tile_group=3, exact tiles,
1280x720; the 37,941-gaussian app frame, relaxed, 1280x720; the train
app's first frame, 640x360), holds the old and the new kernels to each
other (C: equal outputs and equal nc; D: the row-scaled bound of
chip_smoke.py) and times each kernel old, new, new, old (medians of
--reps launches by chip_smoke.DeviceTimer: device time, the wrapper's host
work not counted). It prints one JSON line per kernel and frame, the
compositing work of each frame, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke as smoke


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("no CUDA GPU")

    from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning
    from gaussian_splat_ipu_tpu_torch.render.kernels import (cuda_lib,
                                                             rasterize)
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

    dev = torch.device("cuda", 0)
    timer = smoke.DeviceTimer()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    new_lib = cuda_lib.library()
    names = ("gsplat_rasterize_fwd", "gsplat_rasterize_bwd")
    old_lib, log = smoke.build_lib(
        [os.path.join(args.old, f) for f in ("rasterize.cu",
                                             "rasterize_bwd.cu")],
        tempfile.mkdtemp(prefix="gsplat_ab_"),
        {k: cuda_lib._SIGNATURES[k] for k in names})
    smoke.say("build",
              new_ptxas=smoke.ptxas_lines(cuda_lib.BuildInfo.log,
                                          "rasterize"),
              old_ptxas=smoke.ptxas_lines(log, "rasterize"))

    def on(lib, fn):
        saved, cuda_lib._lib = cuda_lib._lib, lib
        try:
            return fn()
        finally:
            cuda_lib._lib = saved

    fov = float(np.radians(40.0))
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    model_1m = GaussianModel.random(smoke.N_1M, generator=gen, device=dev)
    # chip_smoke.py's app scene (a seeded PLY, loaded as the app loads
    # it) and its train app's initial model.
    ply = os.path.join(tempfile.mkdtemp(prefix="gsplat_ab_"), "scene.ply")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    scene_io.write_ply(ply, GaussianModel.random(
        smoke.APP_GAUSSIANS, generator=gen, device=dev))
    app = scene_io.load_scene(ply, device=dev)
    app_bb = app.bb_min, app.bb_max
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    init = GaussianModel.random(
        smoke.APP_GAUSSIANS, generator=gen, device=dev,
        extent=float(np.linalg.norm(app.bb_max - app.bb_min) * 0.5))
    bb = np.ones(3, np.float32)
    frames = []
    with torch.inference_mode():
        cfg = RasterConfig(pair_capacity=1 << 22, tile_group=3,
                           exact_tile_test=True)
        cam = Camera.orbit(-bb, bb, fov, 1280 / 720, device=dev)
        b = binning.bin_splats(project_gaussians(model_1m, cam, cfg), cfg)
        cap = max(-(-int(1.15 * int(b.num_pairs)) // 128) * 128, 512)
        cfg = dataclasses.replace(cfg, pair_capacity=cap)
        frames.append(("1M g=3", binning.bin_splats(
            project_gaussians(model_1m, cam, cfg), cfg), cfg))
        cfg = RasterConfig(pair_capacity=1 << 19, strict_termination=False)
        cam = Camera.orbit(*app_bb, fov, 1280 / 720, device=dev)
        frames.append(("app 1280x720 g=1", binning.bin_splats(
            project_gaussians(app.model, cam, cfg), cfg), cfg))
        cfg = RasterConfig(image_width=smoke.TRAIN_W,
                           image_height=smoke.TRAIN_H)
        cam = Camera.orbit(*app_bb, fov, smoke.TRAIN_W / smoke.TRAIN_H,
                           device=dev)
        frames.append(("app 640x360 g=1", binning.bin_splats(
            project_gaussians(init, cam, cfg), cfg), cfg))

        for label, b, cfg in frames:
            tiles_aux, nc = rasterize.rasterize_tiles_aux(b, cfg)
            smoke.say("compositing_work", frame=label,
                      pairs=int(b.num_pairs),
                      **smoke.raster_work(b, cfg, nc))
            gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 5)
            bargs = (b.features, b.tile_starts, b.tile_ends,
                     torch.randn(tiles_aux.shape, generator=gen, device=dev),
                     1.0 - tiles_aux[..., 3], nc, cfg)
            kernels = {
                "rasterize_strict": lambda b=b, cfg=cfg: rasterize._forward(
                    b, dataclasses.replace(cfg, strict_termination=True),
                    rasterize._STRICT),
                "rasterize_relaxed": lambda b=b, cfg=cfg: rasterize._forward(
                    b, cfg, rasterize._RELAXED),
                "rasterize_strict_aux": lambda b=b, cfg=cfg: rasterize
                ._forward(b, cfg, rasterize._STRICT_AUX),
                "rasterize_bwd": lambda bargs=bargs: rasterize
                .rasterize_backward(*bargs),
            }
            for name, fn in kernels.items():
                old = on(old_lib, fn)
                new = on(new_lib, fn)
                torch.cuda.synchronize()
                if name == "rasterize_bwd":
                    err = smoke.bwd_err(f"{label} {name} old vs new", new,
                                        old)
                else:
                    old = old if isinstance(old, tuple) else (old,)
                    new = new if isinstance(new, tuple) else (new,)
                    err = smoke.exact_err(f"{label} {name} old vs new",
                                          ("tiles", "nc")[:len(new)], new,
                                          old)
                turns = []
                for lib in (old_lib, new_lib, new_lib, old_lib):
                    turns.append(on(lib, lambda: timer.ms(
                        fn, reps=args.reps, label=f"{label} {name}")))
                smoke.say("ab", frame=label, kernel=name,
                          old_ms=[turns[0], turns[3]],
                          new_ms=[turns[1], turns[2]],
                          speedup=(turns[0] + turns[3])
                          / (turns[1] + turns[2]),
                          max_abs_diff_old_new=err)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
