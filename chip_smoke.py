#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gaussian_splat_ipu_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: card name and power limit, torch and CUDA versions, the
     kernel build (nvcc, sm_90a) and its time, TF32 off;
  2. each CUDA kernel against its plain PyTorch version on the card, on
     inputs the port's own projection and binning make at main-path
     shapes: coverage masks and stream expansion exactly equal, the
     rasterizer (strict and relaxed) within 1e-5; CUDA-event medians of
     both; then the CUDA binning and rasterizer against the CPU spec on a
     small scene;
  3. the app's render loop (app/main.py) on a seeded 37,941-gaussian PLY
     at 1280x720, 8 orbit frames, demand-probed capacity, its default
     relaxed termination;
  4. the 1M-gaussian config: 2^20 random gaussians, tile_group=3,
     exact_tile_test, strict termination, 3 orbit frames at a
     demand-probed capacity.
The launch counters are zeroed before phase 3 and read after phase 4:
every kernel must have carried those frames. Then one JSON line of
per-kernel results, the card line, and last the status line
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL_RASTER = 1e-5
APP_GAUSSIANS = 37_941          # the reference demo scene's size
N_1M = 1 << 20
WIDTH, HEIGHT = 1280, 720
SEED = 0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(phase: str, **kv):
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def exact_err(kernel: str, names, got, ref) -> float:
    """Max abs difference over the outputs; fails unless all are equal."""
    import torch
    for name, a, b in zip(names, got, ref):
        if not torch.equal(a, b):
            fail(f"{kernel} {name}: {int((a != b).sum())} of {a.numel()} "
                 "differ from the plain version")
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, ref))


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() over `reps` runs after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "one CUDA GPU")

    from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
    from gaussian_splat_ipu_tpu_torch.render.kernels import (
        coverage, cuda_lib, expand, rasterize)
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
        rasterize_tiles_torch)
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    import gaussian_splat_ipu_tpu_torch.app.main as app_main

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    cuda_lib.library()
    ptxas = [ln.strip() for ln in cuda_lib.BuildInfo.log.splitlines()
             if "Used" in ln or "spill" in ln]
    say("environment", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        build_seconds=cuda_lib.BuildInfo.seconds,
        library=os.path.relpath(cuda_lib.BuildInfo.path),
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32, ptxas=ptxas)

    fov = float(np.radians(40.0))
    aspect = WIDTH / HEIGHT
    tmp = tempfile.mkdtemp(prefix="gsplat_smoke_")
    ply_path = os.path.join(tmp, "scene.ply")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scene_io.write_ply(ply_path, GaussianModel.random(
        APP_GAUSSIANS, generator=gen, device=dev))
    app_scene = scene_io.load_scene(ply_path, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model_1m = GaussianModel.random(N_1M, generator=gen, device=dev)
    bb1 = np.ones(3, np.float32)
    angles_1m = (0.0, 45.0, 90.0)

    def cam_1m(angle):
        return Camera.orbit(-bb1, bb1, fov, aspect, rot_y_deg=angle,
                            device=dev)

    cfg_1m = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                          pair_capacity=1 << 22, tile_group=3,
                          exact_tile_test=True)
    with torch.inference_mode():
        # One demand probe over the frames the 1M phase renders (the count
        # is exact at any capacity: num_pairs + overflow).
        worst = max(int(b.num_pairs + b.overflow) for b in (
            binning.bin_splats(project_gaussians(model_1m, cam_1m(a),
                                                 cfg_1m), cfg_1m)
            for a in angles_1m))
        c = cfg_1m.chunk_size
        cfg_1m = dataclasses.replace(
            cfg_1m, pair_capacity=max(-(-int(1.15 * worst) // c) * c, 4 * c))

        # -- 2. kernels against their plain versions ------------------------
        results = []
        splats_1m = project_gaussians(model_1m, cam_1m(0.0), cfg_1m)
        x0, y0, nx, ny = binning.cell_footprints(splats_1m, cfg_1m)
        _, geomf, geomi = binning.coverage_inputs(splats_1m, x0, y0, nx, ny)
        kw = dict(tw=3.0 * cfg_1m.tile_width, th=3.0 * cfg_1m.tile_height,
                  alpha_min=float(cfg_1m.alpha_min))
        got = coverage.coverage_masks(geomf, geomi, **kw)
        ref = coverage.coverage_masks_torch(geomf, geomi, **kw)
        torch.cuda.synchronize()
        results.append(dict(
            name="coverage_masks", route="cuda",
            source="gaussian_splat_ipu_tpu_torch/csrc/coverage.cu",
            replaces="gaussian_splat_ipu_tpu/render/kernels/coverage.py:106",
            max_abs_err=exact_err("coverage_masks", ("mlo", "mhi", "count"),
                                  got, ref),
            ms=cuda_ms(lambda: coverage.coverage_masks(geomf, geomi, **kw)),
            plain_ms=cuda_ms(lambda: coverage.coverage_masks_torch(
                geomf, geomi, **kw))))

        packed, offs = binning.pack_gaussians(splats_1m, cfg_1m)
        p = cfg_1m.pair_capacity
        got = expand.stream_expand(packed, offs, p)
        ref = expand.stream_expand_torch(packed, offs, p)
        torch.cuda.synchronize()
        results.append(dict(
            name="stream_expand", route="cuda",
            source="gaussian_splat_ipu_tpu_torch/csrc/expand.cu",
            replaces="gaussian_splat_ipu_tpu/render/kernels/expand.py:338",
            max_abs_err=exact_err("stream_expand", ("cols", "gid", "rank"),
                                  got, ref),
            ms=cuda_ms(lambda: expand.stream_expand(packed, offs, p)),
            plain_ms=cuda_ms(lambda: expand.stream_expand_torch(
                packed, offs, p))))

        cfg_app = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                               pair_capacity=1 << 19,
                               strict_termination=False)
        cam_app = Camera.orbit(app_scene.bb_min, app_scene.bb_max, fov,
                               aspect, device=dev)
        binned_app = binning.bin_splats(
            project_gaussians(app_scene.model, cam_app, cfg_app), cfg_app)
        binned_1m = binning.bin_splats(splats_1m, cfg_1m)
        for name, binned, cfg in (("rasterize_strict", binned_1m, cfg_1m),
                                  ("rasterize_relaxed", binned_app,
                                   cfg_app)):
            got = rasterize.rasterize_tiles(binned, cfg)
            ref = rasterize_tiles_torch(binned, cfg)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not (torch.isfinite(got).all() and err <= TOL_RASTER):
                fail(f"{name}: max abs error {err} against the plain "
                     f"version (tolerance {TOL_RASTER})")
            results.append(dict(
                name=name, route="cuda",
                source="gaussian_splat_ipu_tpu_torch/csrc/rasterize.cu",
                replaces="gaussian_splat_ipu_tpu/render/kernels/"
                         "rasterize.py:287",
                max_abs_err=err,
                ms=cuda_ms(lambda: rasterize.rasterize_tiles(binned, cfg)),
                plain_ms=cuda_ms(lambda: rasterize_tiles_torch(binned, cfg),
                                 reps=3 if name.endswith("strict") else 5)))
        shapes = (f"N={geomf.shape[1]}", f"N={packed.shape[0] - 1},P={p}",
                  f"T={binned_1m.tile_starts.shape[0]},"
                  f"pairs={int(binned_1m.num_pairs)},g=3",
                  f"T={binned_app.tile_starts.shape[0]},"
                  f"pairs={int(binned_app.num_pairs)},g=1")
        for r, shape in zip(results, shapes):
            say("kernel", shape=shape, **r)

        # The CUDA binning and rasterizer on a small scene against the CPU
        # spec (which the CPU tests hold to the JAX package), from the same
        # projected splats: tables bit-identical, images within 1e-5.
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        small = GaussianModel.random(2000, generator=gen, device=dev)
        for g, exact in ((1, False), (3, True)):
            cfg_s = RasterConfig(image_width=160, image_height=96,
                                 tile_width=16, tile_height=16,
                                 chunk_size=32, pair_capacity=1 << 14,
                                 tile_group=g, exact_tile_test=exact)
            cam_s = Camera.orbit(-np.ones(3), np.ones(3), fov, 160 / 96,
                                 rot_y_deg=30.0, device=dev)
            sp = project_gaussians(small, cam_s, cfg_s)
            sp_cpu = type(sp)(*(x.cpu() for x in sp))
            b_gpu = binning.bin_splats(sp, cfg_s)
            b_cpu = binning.bin_splats(sp_cpu, cfg_s)
            for f in b_gpu._fields:
                if not torch.equal(getattr(b_gpu, f).cpu(),
                                   getattr(b_cpu, f)):
                    fail(f"small scene g={g}: BinnedSplats.{f} on CUDA "
                         "differs from the CPU spec")
            err = float((rasterize.rasterize_tiles(b_gpu, cfg_s).cpu()
                         - rasterize_tiles_torch(b_cpu, cfg_s)).abs().max())
            if err > TOL_RASTER:
                fail(f"small scene g={g}: CUDA image differs from the CPU "
                     f"spec by {err}")
            say("small_scene_vs_cpu", tile_group=g, exact_tile_test=exact,
                pairs=int(b_cpu.num_pairs), binned_identical=True,
                max_abs_err=err)

    # -- 3. the app ---------------------------------------------------------
    cuda_lib.launches.clear()
    out_png = os.path.join(tmp, "app.png")
    t0 = time.perf_counter()
    stats = app_main.run([
        "--input", ply_path, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--frames", "8", "--pair-capacity", "0", "--device", "cuda",
        "--output", out_png, "--log-level", "warn"])
    app_s = time.perf_counter() - t0
    app_launches = dict(cuda_lib.launches)
    img = image_util.decode_png(open(out_png, "rb").read())
    if img.shape != (HEIGHT, WIDTH, 4) or img[..., :3].max() == 0:
        fail(f"app PNG is blank or misshapen: {img.shape}")
    for k in ("stream_expand", "rasterize_relaxed"):
        if app_launches.get(k, 0) < 8:
            fail(f"app run launched {k} {app_launches.get(k, 0)} times "
                 "for 8 frames")
    if stats["overflow"] or stats["truncated"]:
        fail(f"app run dropped pairs: {stats}")
    say("app", gaussians=APP_GAUSSIANS, frames=stats["frames"],
        pair_capacity=stats["pair_capacity"], num_pairs=stats["num_pairs"],
        overflow=stats["overflow"], truncated=stats["truncated"],
        median_frame_ms=stats["median_ms"], frame_ms=stats["frame_ms"],
        wall_s=app_s, launches=app_launches,
        lit_pixels=int((img[..., 3] > 0).sum()))

    # -- 4. the 1M config ---------------------------------------------------
    before = dict(cuda_lib.launches)
    frame_ms, out = [], None
    with torch.inference_mode():
        for a in angles_1m:
            cam = cam_1m(a)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = pipeline.render(model_1m, cam, cfg_1m)
            end.record()
            end.synchronize()
            frame_ms.append(start.elapsed_time(end))
            if int(out.overflow) or not bool(torch.isfinite(out.image).all()):
                fail(f"1M frame at {a} deg: overflow {int(out.overflow)} "
                     "or non-finite pixels")
    launches = dict(cuda_lib.launches)
    for k in ("coverage_masks", "stream_expand", "rasterize_strict"):
        if launches.get(k, 0) - before.get(k, 0) < len(angles_1m):
            fail(f"1M run launched {k} too few times: {launches}")
    if tuple(out.image.shape) != (HEIGHT, WIDTH, 4) or float(
            out.image[..., 3].max()) <= 0.0:
        fail("1M frame is blank or misshapen")
    say("1m", gaussians=N_1M, frames=len(angles_1m), tile_group=3,
        exact_tile_test=True, strict=True,
        pair_capacity=cfg_1m.pair_capacity, num_pairs=int(out.num_pairs),
        overflow=int(out.overflow), truncated=int(out.truncated),
        frame_ms=frame_ms, median_frame_ms=float(np.median(frame_ms)))

    for r in results:
        r["launches"] = launches.get(r["name"], 0)
        if r["launches"] == 0:
            fail(f"{r['name']} was not launched on the main path")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported: the port must run without it")
    print(json.dumps({"kernels": results}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
