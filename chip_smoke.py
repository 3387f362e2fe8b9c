#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gaussian_splat_ipu_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: card name and power limit, torch and CUDA versions, the
     kernel build (one nvcc per source, in parallel, sm_90a) and its time,
     TF32 off;
  2. each CUDA kernel against its plain PyTorch version on the card, on
     inputs the port's own projection and binning make at main-path
     shapes: coverage masks, stream expansion (flat, and segmented at the
     rowseg 1M config), the row scan (rowseg 1M) and expand_pairs (the
     1M table through the gather expansion) exactly equal; the forward
     rasterizer (strict, relaxed, strict with contributor counts) within
     1e-5, the counts exactly equal; the backward rasterizer within a
     bound scaled to each gradient row (TOL_BWD_*); CUDA-event medians of
     each kernel and each plain version, each kernel's bound on the H100
     (PEAK_*: bytes or operations, for C and D from the live evaluations
     that tile_raster.live_evaluations counts), and for E and F the time
     of one PyTorch call for the same function (never called by the
     port); the walked, kept and live evaluations of C and D on the 1M
     and app frames. Then, on a small scene, the CUDA
     binning (flat, rowseg R = 2 and 3, the three gather paths; tables
     bit-identical), rasterizer, pair-table gradient and model gradients
     against the CPU path;
  3. the app's render loop (app/main.py) on a seeded 37,941-gaussian PLY
     at 1280x720, 8 orbit frames, demand-probed capacity, its default
     relaxed termination;
  4. the 1M-gaussian config: 2^20 random gaussians, tile_group=3,
     exact_tile_test, strict termination, 3 orbit frames at a
     demand-probed capacity;
  5. the 1M train step: train_step against a target rendered from the
     same model at angle 0, capacity 1.15x that view's demand, L1 loss;
  6. the train app (app/train.py) in distill mode on the 37,941-gaussian
     PLY at 640x360 over 8 orbit views, with a checkpoint that a second
     run resumes for one more step;
  7. rowseg 1M: benchmarks/bench_1m.py's balanced row-bucket config
     (tile_group=2, exact_tile_test, strict; bounds from balance_bounds
     over the worst bucket demands of 4 orbit views, R and per-bucket
     capacity by its recipe): 3 orbit frames, held to the flat path's
     images, then 2 train steps;
  8. the app with --rowseg 4 at its default --pair-capacity, 8 frames;
  9. the gather paths at 1M: one frame each with presort_depth,
     fused_sort_key=False (the exact two-pass sort) and
     expand_kernel=False.
The launch counters are zeroed just before each of phases 3-9 and read
just after it: every kernel must have carried the path that uses it.
Neither jax nor the JAX package (gaussian_splat_ipu_tpu) may be imported.
Then one JSON line of per-kernel results, the card line, and last the
status line {"ok": true, "device": {...}}. Any failure exits non-zero
before it.
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
# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): 3.35
# TB/s of HBM and 67 TFLOP/s of FP32 outside the tensor cores. Integer
# operations are counted at the FP32 rate. A kernel's bound is the larger
# of its bytes (each input read once, each output written once) over the
# first and its operations over the second.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
OPS_COVERAGE_CELL = 40      # csrc/coverage.cu, per window cell tested
OPS_FWD_LIVE = 27           # csrc/rasterize.cu, per live evaluation
OPS_BWD_LIVE = 54           # csrc/rasterize_bwd.cu, per live evaluation
# Backward bound, per element: |got - ref| <= TOL_BWD_ROW * max|ref row|
# + TOL_BWD_REL * |ref|. Atomics (kernel) and tensor reductions (plain)
# sum each pair's pixel terms in different orders; terms of both signs
# cancel, so an entry's error follows the size of its terms, which the
# row's scale bounds, not its own (possibly cancelled) value.
TOL_BWD_ROW = 1e-4
TOL_BWD_REL = 1e-3
APP_GAUSSIANS = 37_941          # the reference demo scene's size
N_1M = 1 << 20
WIDTH, HEIGHT = 1280, 720
TRAIN_W, TRAIN_H = 640, 360     # the train CLI's default resolution
TRAIN_VIEWS = 8
TRAIN_STEPS_APP = 3 * TRAIN_VIEWS
TRAIN_STEPS_1M = 4
SEED = 0
# benchmarks/bench_1m.py:135-171, the balanced rowseg recipe: bucket
# demands probed at orbit steps 0, 4, 8, 12 of 11.25 deg; buckets under
# the batched sort's 2^18 pow2 step with 8% slack; no bucket lighter than
# min_sum (the TPU kernel's source-window bound, kept for the same layout).
RS_PROBE_ANGLES = (0.0, 45.0, 90.0, 135.0)
RS_CAP_TARGET = 1 << 18
RS_SLACK = 1.08
RS_FRAMES = 3
RS_TRAIN_STEPS = 2
KERNEL_SOURCES = {
    "coverage_masks": ("coverage.cu", "render/kernels/coverage.py:106"),
    "stream_expand": ("expand.cu", "render/kernels/expand.py:338"),
    "rasterize_strict": ("rasterize.cu", "render/kernels/rasterize.py:287"),
    "rasterize_relaxed": ("rasterize.cu",
                          "render/kernels/rasterize.py:287"),
    "rasterize_strict_aux": ("rasterize.cu",
                             "render/kernels/rasterize.py:287"),
    "rasterize_bwd": ("rasterize_bwd.cu", "render/kernels/rasterize.py:573"),
    "row_cumsum_exclusive": ("scan.cu", "render/kernels/scan.py:51"),
    "stream_expand_seg": ("expand.cu", "render/kernels/expand.py:338"),
    "expand_pairs": ("expand_pairs.cu", "render/kernels/expand.py:121"),
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(phase: str, **kv):
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def result(name: str, **kv) -> dict:
    src, replaces = KERNEL_SOURCES[name]
    kv.setdefault("library_ms", None)
    return dict(name=name, route="cuda",
                source=f"gaussian_splat_ipu_tpu_torch/csrc/{src}",
                replaces=f"gaussian_splat_ipu_tpu/{replaces}", **kv)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the FP32 rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(n_bytes), operations=int(ops))


def raster_work(binned, cfg, nc) -> dict:
    """What kernels C and D walk on one frame (nc from the strict aux
    forward): pairs of the walk (each range cut at start + the tile's
    largest nc), those the tile cull keeps, and the live evaluations;
    evaluations = pairs x pixels of a tile."""
    from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
        live_evaluations, surviving_pairs)
    walked, kept = surviving_pairs(binned, cfg, nc)
    npix = cfg.pixels_per_tile
    return dict(walked_pairs=walked, kept_pairs=kept,
                walked_evaluations=walked * npix,
                kept_evaluations=kept * npix,
                live_evaluations=live_evaluations(binned, cfg, nc))


def raster_bytes(binned, cfg, per_pixel: int, table_rows_out: int = 0):
    """Kernel C / D traffic: the 9 staged rows of every pair, the ranges,
    `per_pixel` bytes for each pixel and `table_rows_out` f32 rows of
    the whole table written (D's dfeat)."""
    t = binned.tile_starts.shape[0]
    return (9 * 4 * int(binned.num_pairs) + 8 * t
            + per_pixel * t * cfg.pixels_per_tile
            + table_rows_out * 4 * binned.features.shape[1])


def exact_err(kernel: str, names, got, ref) -> float:
    """Max abs difference over the outputs; fails unless all are equal."""
    import torch
    for name, a, b in zip(names, got, ref):
        if not torch.equal(a, b):
            fail(f"{kernel} {name}: {int((a != b).sum())} of {a.numel()} "
                 "differ from the plain version")
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, ref))


def bwd_err(kernel: str, got, ref) -> float:
    """Max abs difference; fails unless every element is within the
    row-scaled bound (TOL_BWD_*) and finite."""
    import torch
    bound = (TOL_BWD_ROW * ref.abs().amax(dim=-1, keepdim=True)
             + TOL_BWD_REL * ref.abs())
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        fail(f"{kernel}: {int((err > bound).sum())} of {err.numel()} "
             f"outside the bound; max abs error {float(err.max())}")
    return float(err.max())


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


def counted(cuda_lib, fn):
    """Run fn() with the launch counters zeroed just before it; return
    (fn's result, the launches it made)."""
    cuda_lib.launches.clear()
    out = fn()
    return out, dict(cuda_lib.launches)


def need_launches(path: str, launches: dict, names, least: int):
    for k in names:
        if launches.get(k, 0) < least:
            fail(f"{path} launched {k} {launches.get(k, 0)} times, fewer "
                 f"than {least}: {launches}")


def check_aux_and_bwd(binned, cfg, seed: int, plain_reps: int):
    """The strict aux forward and the backward kernel against their plain
    versions on one binned frame: returns a dict of errors and times."""
    import torch
    from gaussian_splat_ipu_tpu_torch.render.kernels import rasterize
    from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
        rasterize_backward_torch, rasterize_tiles_torch)
    tiles, nc = rasterize.rasterize_tiles_aux(binned, cfg)
    ref_tiles, ref_nc = rasterize_tiles_torch(binned, cfg, need_aux=True)
    torch.cuda.synchronize()
    aux_err = float((tiles - ref_tiles).abs().max())
    if not (torch.isfinite(tiles).all() and aux_err <= TOL_RASTER):
        fail(f"rasterize_strict_aux: max abs error {aux_err} (tolerance "
             f"{TOL_RASTER})")
    exact_err("rasterize_strict_aux", ("nc",), (nc,), (ref_nc,))
    gen = torch.Generator(device=tiles.device).manual_seed(seed)
    args = (binned.features, binned.tile_starts, binned.tile_ends,
            torch.randn(tiles.shape, generator=gen, device=tiles.device),
            1.0 - ref_tiles[..., 3], ref_nc, cfg)
    got = rasterize.rasterize_backward(*args)
    ref = rasterize_backward_torch(*args)
    torch.cuda.synchronize()
    return dict(
        aux_err=aux_err, bwd_err=bwd_err("rasterize_bwd", got, ref),
        broke_pixels=int((ref_nc < (binned.tile_ends - binned.tile_starts)
                          [:, None].float()).sum()),
        aux_ms=cuda_ms(lambda: rasterize.rasterize_tiles_aux(binned, cfg)),
        aux_plain_ms=cuda_ms(lambda: rasterize_tiles_torch(
            binned, cfg, need_aux=True), reps=plain_reps),
        bwd_ms=cuda_ms(lambda: rasterize.rasterize_backward(*args)),
        bwd_plain_ms=cuda_ms(lambda: rasterize_backward_torch(*args),
                             reps=plain_reps))


def rowseg_config(binning, project, model, cam_of, cfg0):
    """bench_1m.py's `_rowseg_balanced` (:135-171) on the port: the worst
    per-group-row demand over RS_PROBE_ANGLES, the fewest buckets R whose
    balanced partition keeps every bucket within RS_CAP_TARGET / RS_SLACK,
    and a per-bucket capacity of the worst bucket's demand x RS_SLACK,
    2048-aligned. Returns (cfg, info). If no R under 17 meets the target
    the largest R tried is kept and info says so."""
    import torch
    rd = torch.stack([binning.bucket_demands(project(model, cam_of(a), cfg0),
                                             cfg0)
                      for a in RS_PROBE_ANGLES]).amax(0).cpu().numpy()
    total = int(rd.sum())
    min_sum = int(2048 * model.num_gaussians / 16384 * 1.25)
    r_first = max(2, -(-int(total * RS_SLACK) // RS_CAP_TARGET))
    tried = None
    for r_try in range(r_first, min(len(rd), 17)):
        b = binning.balance_bounds(rd, r_try, min_sum=min_sum)
        sums = [int(rd[b[i]:b[i + 1]].sum()) for i in range(r_try)]
        tried = (r_try, b, sums)
        if int(max(sums) * RS_SLACK) <= RS_CAP_TARGET:
            break
    if tried is None:
        fail(f"rowseg 1M: {len(rd)} group rows leave no bucket count to try")
    r_seg, bounds, sums = tried
    cap = max(-(-int(max(sums) * RS_SLACK) // 2048) * 2048, 2048)
    cfg = dataclasses.replace(cfg0, rowseg_buckets=r_seg,
                              rowseg_bounds=bounds, pair_capacity=r_seg * cap)
    return cfg, dict(
        R=r_seg, bounds=list(bounds), row_demands=[int(x) for x in rd],
        bucket_demands=sums, total_demand=total, min_sum=min_sum,
        cap_seg=cap, cap_target_met=int(max(sums) * RS_SLACK)
        <= RS_CAP_TARGET)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "one CUDA GPU")

    from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import (
        FIELDS, GaussianModel)
    from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
    from gaussian_splat_ipu_tpu_torch.render.kernels import (
        coverage, cuda_lib, expand, rasterize, scan)
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
        rasterize_backward_torch, rasterize_tiles_torch)
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    import gaussian_splat_ipu_tpu_torch.app.train as app_train

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
    ptxas = [ln.split(":", 1)[-1].strip()
             for ln in cuda_lib.BuildInfo.log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
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

    def capacity(demand: int, c: int) -> int:
        return max(-(-int(1.15 * demand) // c) * c, 4 * c)

    cfg_1m = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                          pair_capacity=1 << 22, tile_group=3,
                          exact_tile_test=True)
    with torch.inference_mode():
        # One demand probe per frame the 1M phases render (the count is
        # exact at any capacity: num_pairs + overflow).
        demand = [int(b.num_pairs + b.overflow) for b in (
            binning.bin_splats(project_gaussians(model_1m, cam_1m(a),
                                                 cfg_1m), cfg_1m)
            for a in angles_1m)]
        c = cfg_1m.chunk_size
        # Frames: the worst of the orbit; training: its camera (angle 0).
        cfg_train_1m = dataclasses.replace(
            cfg_1m, pair_capacity=capacity(demand[0], c))
        cfg_1m = dataclasses.replace(cfg_1m,
                                     pair_capacity=capacity(max(demand), c))
        cfg_rs, rs_info = rowseg_config(
            binning, project_gaussians, model_1m, cam_1m,
            RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                         pair_capacity=1 << 22, tile_group=2,
                         exact_tile_test=True))
        say("rowseg_1m_config", **rs_info)

        # -- 2. kernels against their plain versions ------------------------
        results = {}
        splats_1m = project_gaussians(model_1m, cam_1m(0.0), cfg_1m)
        x0, y0, nx, ny = binning.cell_footprints(splats_1m, cfg_1m)
        _, geomf, geomi = binning.coverage_inputs(splats_1m, x0, y0, nx, ny)
        kw = dict(tw=3.0 * cfg_1m.tile_width, th=3.0 * cfg_1m.tile_height,
                  alpha_min=float(cfg_1m.alpha_min))
        got = coverage.coverage_masks(geomf, geomi, **kw)
        ref = coverage.coverage_masks_torch(geomf, geomi, **kw)
        torch.cuda.synchronize()
        results["coverage_masks"] = result(
            "coverage_masks",
            max_abs_err=exact_err("coverage_masks", ("mlo", "mhi", "count"),
                                  got, ref),
            ms=cuda_ms(lambda: coverage.coverage_masks(geomf, geomi, **kw)),
            plain_ms=cuda_ms(lambda: coverage.coverage_masks_torch(
                geomf, geomi, **kw)),
            **bound(nbytes(geomf, geomi, *got), OPS_COVERAGE_CELL * int(
                torch.where(geomi[4] != 0, geomi[2] * geomi[3], 0).sum())))

        packed, offs = binning.pack_gaussians(splats_1m, cfg_1m)
        p = cfg_1m.pair_capacity
        got = expand.stream_expand(packed, offs, p)
        ref = expand.stream_expand_torch(packed, offs, p)
        torch.cuda.synchronize()
        results["stream_expand"] = result(
            "stream_expand",
            max_abs_err=exact_err("stream_expand", ("cols", "gid", "rank"),
                                  got, ref),
            ms=cuda_ms(lambda: expand.stream_expand(packed, offs, p)),
            plain_ms=cuda_ms(lambda: expand.stream_expand_torch(
                packed, offs, p)),
            **bound(nbytes(packed, offs, *got), 0))

        # The three kernels of the rowseg and gather paths: the row scan
        # and the segmented expansion at the rowseg 1M config's angle-0
        # frame, expand_pairs on the 1M g=3 table through the gather
        # expansion (expand_kernel=False).
        splats_rs = project_gaussians(model_1m, cam_1m(0.0), cfg_rs)
        lay = binning.rowseg_layout(binning.footprints(splats_rs, cfg_rs),
                                    cfg_rs)
        got = scan.row_cumsum_exclusive(lay.counts)
        ref = scan.row_cumsum_exclusive_torch(lay.counts)
        torch.cuda.synchronize()
        results["row_cumsum_exclusive"] = result(
            "row_cumsum_exclusive",
            max_abs_err=exact_err("row_cumsum_exclusive", ("excl",), (got,),
                                  (ref,)),
            ms=cuda_ms(lambda: scan.row_cumsum_exclusive(lay.counts)),
            plain_ms=cuda_ms(lambda: scan.row_cumsum_exclusive_torch(
                lay.counts)),
            library_ms=cuda_ms(lambda: torch.cumsum(lay.counts, dim=1)),
            library_call="torch.cumsum(x, dim=1) (inclusive scan)",
            **bound(nbytes(lay.counts, got), lay.counts.numel()))
        seg_args = (binning.pack_gaussians(splats_rs, cfg_rs)[0], lay.offs,
                    lay.offs2, lay.live_end, lay.cap)
        got = expand.stream_expand_seg(*seg_args)
        ref = expand.stream_expand_seg_torch(*seg_args)
        torch.cuda.synchronize()
        results["stream_expand_seg"] = result(
            "stream_expand_seg",
            max_abs_err=exact_err("stream_expand_seg", ("cols", "gid",
                                                        "rank"), got, ref),
            ms=cuda_ms(lambda: expand.stream_expand_seg(*seg_args)),
            plain_ms=cuda_ms(lambda: expand.stream_expand_seg_torch(
                *seg_args)),
            **bound(nbytes(*seg_args[:4], *got), 0))
        gid_pre, _ = binning.gather_slots(offs, p)
        gid_long = gid_pre.long()
        got = expand.expand_pairs(packed, gid_pre)
        ref = expand.expand_pairs_torch(packed, gid_pre)
        torch.cuda.synchronize()
        results["expand_pairs"] = result(
            "expand_pairs",
            max_abs_err=exact_err("expand_pairs", ("cols",), (got,), (ref,)),
            ms=cuda_ms(lambda: expand.expand_pairs(packed, gid_pre)),
            plain_ms=cuda_ms(lambda: expand.expand_pairs_torch(packed,
                                                               gid_pre)),
            library_ms=cuda_ms(lambda: packed.index_select(0, gid_long)),
            library_call="packed.index_select(0, gid) (no transpose)",
            **bound(nbytes(packed, gid_pre, got), 0))
        del splats_rs, seg_args, got, ref, gid_long

        cfg_app = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                               pair_capacity=1 << 19,
                               strict_termination=False)
        cam_app = Camera.orbit(app_scene.bb_min, app_scene.bb_max, fov,
                               aspect, device=dev)
        binned_app = binning.bin_splats(
            project_gaussians(app_scene.model, cam_app, cfg_app), cfg_app)
        binned_1m = binning.bin_splats(splats_1m, cfg_1m)
        # The work of kernels C and D on the two frames, from the strict
        # aux forward's contributor counts.
        work = {}
        for label, binned, cfg in (("1M g=3", binned_1m, cfg_1m),
                                   ("app g=1", binned_app, cfg_app)):
            work[label] = raster_work(
                binned, cfg, rasterize.rasterize_tiles_aux(binned, cfg)[1])
            say("compositing_work", frame=label,
                pairs=int(binned.num_pairs), **work[label])
        for name, binned, cfg, label in (
                ("rasterize_strict", binned_1m, cfg_1m, "1M g=3"),
                ("rasterize_relaxed", binned_app, cfg_app, "app g=1")):
            got = rasterize.rasterize_tiles(binned, cfg)
            ref = rasterize_tiles_torch(binned, cfg)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not (torch.isfinite(got).all() and err <= TOL_RASTER):
                fail(f"{name}: max abs error {err} against the plain "
                     f"version (tolerance {TOL_RASTER})")
            results[name] = result(
                name, max_abs_err=err,
                ms=cuda_ms(lambda: rasterize.rasterize_tiles(binned, cfg)),
                plain_ms=cuda_ms(lambda: rasterize_tiles_torch(binned, cfg),
                                 reps=3 if name.endswith("strict") else 5),
                **bound(raster_bytes(binned, cfg, 16),
                        OPS_FWD_LIVE * work[label]["live_evaluations"]))
        shapes = {
            "coverage_masks": f"N={geomf.shape[1]}",
            "stream_expand": f"N={packed.shape[0] - 1},P={p}",
            "rasterize_strict": f"T={binned_1m.tile_starts.shape[0]},"
                                f"pairs={int(binned_1m.num_pairs)},g=3",
            "rasterize_relaxed": f"T={binned_app.tile_starts.shape[0]},"
                                 f"pairs={int(binned_app.num_pairs)},g=1",
            "row_cumsum_exclusive": f"R={lay.counts.shape[0]},"
                                    f"N={lay.counts.shape[1]}",
            "stream_expand_seg": f"N={lay.offs.shape[1]},"
                                 f"R={lay.offs.shape[0]},cap={lay.cap}",
            "expand_pairs": f"N={packed.shape[0] - 1},P={p},g=3"}
        for name, shape in shapes.items():
            say("kernel", shape=shape, **results[name])

        # The strict aux forward and the backward at the two training
        # shapes: the 1M train step's frame and the train app's first
        # step (its distill initialisation at view 0, 640x360).
        binned_t1m = binning.bin_splats(
            project_gaussians(model_1m, cam_1m(0.0), cfg_train_1m),
            cfg_train_1m)
        extent = float(np.linalg.norm(app_scene.bb_max - app_scene.bb_min)
                       * 0.5)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        init_app = GaussianModel.random(APP_GAUSSIANS, generator=gen,
                                        device=dev, extent=extent)
        cfg_tapp = RasterConfig(image_width=TRAIN_W, image_height=TRAIN_H)
        cam_tapp = Camera.orbit(app_scene.bb_min, app_scene.bb_max, fov,
                                TRAIN_W / TRAIN_H, device=dev)
        binned_tapp = binning.bin_splats(
            project_gaussians(init_app, cam_tapp, cfg_tapp), cfg_tapp)
        checks = {}
        for shape_name, binned, cfg, reps in (
                ("1M 1280x720 g=3", binned_t1m, cfg_train_1m, 1),
                ("app 640x360 g=1", binned_tapp, cfg_tapp, 3)):
            chk = check_aux_and_bwd(binned, cfg, SEED + 5, reps)
            checks[shape_name] = chk
            say("train_kernels", shape=shape_name,
                tiles=binned.tile_starts.shape[0],
                pairs=int(binned.num_pairs), **chk)
        main_chk = checks["1M 1280x720 g=3"]
        # The train frame holds the same pairs as the 1M frame at angle 0
        # (only its capacity differs), so it has the same work.
        live_1m = work["1M g=3"]["live_evaluations"]
        results["rasterize_strict_aux"] = result(
            "rasterize_strict_aux",
            max_abs_err=max(c["aux_err"] for c in checks.values()),
            ms=main_chk["aux_ms"], plain_ms=main_chk["aux_plain_ms"],
            **bound(raster_bytes(binned_t1m, cfg_train_1m, 20),
                    OPS_FWD_LIVE * live_1m))
        results["rasterize_bwd"] = result(
            "rasterize_bwd",
            max_abs_err=max(c["bwd_err"] for c in checks.values()),
            ms=main_chk["bwd_ms"], plain_ms=main_chk["bwd_plain_ms"],
            **bound(raster_bytes(binned_t1m, cfg_train_1m, 24, 16),
                    OPS_BWD_LIVE * live_1m))

        # The CUDA binning and rasterizer on a small scene against the CPU
        # spec (which the CPU tests hold to the JAX package), from the same
        # projected splats, on every binning path: tables bit-identical,
        # images within 1e-5, the pair-table gradient within the
        # backward's bound.
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        small = GaussianModel.random(2000, generator=gen, device=dev)
        small_cfgs = []
        cfg_small = RasterConfig(image_width=160, image_height=96,
                                 tile_width=16, tile_height=16,
                                 chunk_size=32, pair_capacity=1 << 14)
        for change in (dict(), dict(tile_group=3, exact_tile_test=True),
                       dict(rowseg_buckets=2),
                       dict(exact_tile_test=True, rowseg_buckets=3),
                       dict(tile_group=3, exact_tile_test=True,
                            rowseg_buckets=2),
                       dict(presort_depth=True),
                       dict(fused_sort_key=False, exact_tile_test=True),
                       dict(expand_kernel=False, tile_group=3,
                            exact_tile_test=True)):
            cfg_s = dataclasses.replace(cfg_small, **change)
            label = ",".join(f"{k}={v}" for k, v in change.items()) or "flat"
            small_cfgs.append((label, cfg_s))
            cam_s = Camera.orbit(-np.ones(3), np.ones(3), fov, 160 / 96,
                                 rot_y_deg=30.0, device=dev)
            sp = project_gaussians(small, cam_s, cfg_s)
            sp_cpu = type(sp)(*(x.cpu() for x in sp))
            b_gpu = binning.bin_splats(sp, cfg_s)
            b_cpu = binning.bin_splats(sp_cpu, cfg_s)
            for f in b_gpu._fields:
                if not torch.equal(getattr(b_gpu, f).cpu(),
                                   getattr(b_cpu, f)):
                    fail(f"small scene {label}: BinnedSplats.{f} on CUDA "
                         "differs from the CPU spec")
            err = float((rasterize.rasterize_tiles(b_gpu, cfg_s).cpu()
                         - rasterize_tiles_torch(b_cpu, cfg_s)).abs().max())
            if err > TOL_RASTER:
                fail(f"small scene {label}: CUDA image differs from the CPU "
                     f"spec by {err}")
            tiles, nc = rasterize_tiles_torch(b_cpu, cfg_s, need_aux=True)
            cot = torch.randn(tiles.shape, generator=torch.Generator(
                ).manual_seed(len(small_cfgs)))
            args = (1.0 - tiles[..., 3], nc, cfg_s)
            dfeat = rasterize.rasterize_backward(
                b_gpu.features, b_gpu.tile_starts, b_gpu.tile_ends,
                cot.to(dev), *(a.to(dev) for a in args[:2]), cfg_s)
            dfeat_err = bwd_err(f"small scene {label} dfeat", dfeat.cpu(),
                                rasterize_backward_torch(
                                    b_cpu.features, b_cpu.tile_starts,
                                    b_cpu.tile_ends, cot, *args))
            say("small_scene_vs_cpu", config=label,
                pairs=int(b_cpu.num_pairs), table=b_cpu.features.shape[1],
                binned_identical=True, max_abs_err=err,
                dfeat_max_abs_err=dfeat_err)

    # Model gradients of the whole differentiable render, CUDA against the
    # CPU path, from the same weights and the same pixel weights.
    for label, cfg_s in small_cfgs:
        cam_s = Camera.orbit(-np.ones(3), np.ones(3), fov, 160 / 96,
                             rot_y_deg=30.0, device="cpu")
        w = torch.randn((96, 160, 4), generator=torch.Generator(
            ).manual_seed(SEED + 2))
        grads = {}
        for d in (dev, torch.device("cpu")):
            m = GaussianModel.from_numpy(small.to_numpy(), d).trainable()
            loss = torch.sum(pipeline.render_image(m, cam_s.to(d), cfg_s)
                             * w.to(d))
            loss.backward()
            grads[d.type] = {k: getattr(m, k).grad.cpu() for k in FIELDS}
        errs = {k: bwd_err(f"small scene {label} d{k}",
                           grads["cuda"][k].reshape(len(small.means), -1)
                           .T, grads["cpu"][k].reshape(len(small.means), -1)
                           .T) for k in FIELDS}
        say("small_scene_grads_vs_cpu", config=label, max_abs_err=errs)

    # -- 3. the app ---------------------------------------------------------
    launches = {}
    out_png = os.path.join(tmp, "app.png")
    t0 = time.perf_counter()
    stats, launches["app"] = counted(cuda_lib, lambda: app_main.run([
        "--input", ply_path, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--frames", "8", "--pair-capacity", "0", "--device", "cuda",
        "--output", out_png, "--log-level", "warn"]))
    app_s = time.perf_counter() - t0
    img = image_util.decode_png(open(out_png, "rb").read())
    if img.shape != (HEIGHT, WIDTH, 4) or img[..., :3].max() == 0:
        fail(f"app PNG is blank or misshapen: {img.shape}")
    need_launches("app run", launches["app"],
                  ("stream_expand", "rasterize_relaxed"), 8)
    if stats["overflow"] or stats["truncated"]:
        fail(f"app run dropped pairs: {stats}")
    say("app", gaussians=APP_GAUSSIANS, frames=stats["frames"],
        pair_capacity=stats["pair_capacity"], num_pairs=stats["num_pairs"],
        overflow=stats["overflow"], truncated=stats["truncated"],
        median_frame_ms=stats["median_ms"], frame_ms=stats["frame_ms"],
        wall_s=app_s, launches=launches["app"],
        lit_pixels=int((img[..., 3] > 0).sum()))

    # -- 4. the 1M config ---------------------------------------------------
    def frames_1m():
        frame_ms, out = [], None
        with torch.inference_mode():
            for a in angles_1m:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = pipeline.render(model_1m, cam_1m(a), cfg_1m)
                end.record()
                end.synchronize()
                frame_ms.append(start.elapsed_time(end))
                if int(out.overflow) or not bool(
                        torch.isfinite(out.image).all()):
                    fail(f"1M frame at {a} deg: overflow "
                         f"{int(out.overflow)} or non-finite pixels")
        return frame_ms, out

    (frame_ms, out), launches["1m"] = counted(cuda_lib, frames_1m)
    need_launches("1M run", launches["1m"],
                  ("coverage_masks", "stream_expand", "rasterize_strict"),
                  len(angles_1m))
    if tuple(out.image.shape) != (HEIGHT, WIDTH, 4) or float(
            out.image[..., 3].max()) <= 0.0:
        fail("1M frame is blank or misshapen")
    say("1m", gaussians=N_1M, frames=len(angles_1m), tile_group=3,
        exact_tile_test=True, strict=True,
        pair_capacity=cfg_1m.pair_capacity, num_pairs=int(out.num_pairs),
        overflow=int(out.overflow), truncated=int(out.truncated),
        frame_ms=frame_ms, median_frame_ms=float(np.median(frame_ms)),
        launches=launches["1m"])

    # -- 5. the 1M train step -----------------------------------------------
    cam0 = cam_1m(0.0)
    with torch.inference_mode():
        target_out = pipeline.render(model_1m, cam0, cfg_train_1m)
    target = target_out.image.clone()   # a normal tensor for autograd
    tc_1m = trainer.TrainConfig(ssim_weight=0.0)
    state = trainer.init_state(model_1m.trainable(), tc_1m)

    def steps_1m():
        step_ms, losses = [], []
        for _ in range(TRAIN_STEPS_1M):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, loss = trainer.train_step(state, cam0, target, cfg_train_1m,
                                         tc_1m)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
        return step_ms, losses

    (step_ms, losses_1m), launches["train_1m"] = counted(cuda_lib, steps_1m)
    need_launches("1M train", launches["train_1m"],
                  ("coverage_masks", "stream_expand", "rasterize_strict_aux",
                   "rasterize_bwd"), TRAIN_STEPS_1M)
    params = list(state.params.parameters())
    qnorm = torch.linalg.vector_norm(state.params.quats.detach(), dim=-1)
    with torch.inference_mode():
        after = pipeline.render(state.params, cam0, cfg_train_1m)
    if not (np.isfinite(losses_1m).all()
            and all(bool(torch.isfinite(t).all()) for t in params)):
        fail(f"1M train: non-finite loss or parameters: {losses_1m}")
    if float((qnorm - 1.0).abs().max()) > 1e-5:
        fail("1M train: quaternions not normalised")
    if int(target_out.overflow) or int(after.overflow):
        fail(f"1M train dropped pairs: overflow {int(target_out.overflow)} "
             f"before, {int(after.overflow)} after")
    say("train_1m", gaussians=N_1M, steps=TRAIN_STEPS_1M,
        pair_capacity=cfg_train_1m.pair_capacity,
        num_pairs=int(target_out.num_pairs),
        overflow=int(after.overflow), truncated=int(after.truncated),
        losses=losses_1m, step_ms=step_ms,
        median_step_ms=float(np.median(step_ms[1:])),
        quat_norm_max_dev=float((qnorm - 1.0).abs().max()),
        launches=launches["train_1m"])
    del state, params

    # -- 6. the train app ---------------------------------------------------
    ckpt = os.path.join(tmp, "train.npz")
    common = ["--input", ply_path, "--mode", "distill", "--width",
              str(TRAIN_W), "--height", str(TRAIN_H), "--views",
              str(TRAIN_VIEWS), "--device", "cuda", "--seed", str(SEED),
              "--log-level", "warn"]
    t0 = time.perf_counter()
    tstats, launches["train_app"] = counted(cuda_lib, lambda: app_train.run(
        common + ["--steps", str(TRAIN_STEPS_APP), "--checkpoint", ckpt]))
    train_s = time.perf_counter() - t0
    need_launches("train app", launches["train_app"],
                  ("stream_expand", "rasterize_strict_aux",
                   "rasterize_bwd"), TRAIN_STEPS_APP)
    first = float(np.mean(tstats["losses"][:TRAIN_VIEWS]))
    last = float(np.mean(tstats["losses"][-TRAIN_VIEWS:]))
    if not (np.isfinite(tstats["losses"]).all() and last < first):
        fail(f"train app: the loss did not fall: first epoch {first}, "
             f"last epoch {last}")
    if any(tstats["target_overflow"]) or tstats["final_overflow"]:
        fail(f"train app dropped pairs: targets {tstats['target_overflow']}"
             f", final render {tstats['final_overflow']}")
    if not os.path.isfile(ckpt):
        fail("train app wrote no checkpoint")
    resumed, launches["train_app_resume"] = counted(
        cuda_lib, lambda: app_train.run(common + ["--steps", "1",
                                                  "--resume", ckpt]))
    if resumed["step"] != TRAIN_STEPS_APP + 1 or not np.isfinite(
            resumed["losses"]).all():
        fail(f"train app resume: step {resumed['step']}, losses "
             f"{resumed['losses']}")
    say("train_app", gaussians=APP_GAUSSIANS, width=TRAIN_W,
        height=TRAIN_H, views=TRAIN_VIEWS, steps=TRAIN_STEPS_APP,
        pair_capacity=tstats["pair_capacity"],
        num_pairs=tstats["num_pairs"],
        target_overflow=tstats["target_overflow"],
        target_truncated=tstats["target_truncated"],
        final_overflow=tstats["final_overflow"],
        first_epoch_loss=first, last_epoch_loss=last, psnr=tstats["psnr"],
        median_step_ms=float(np.median(tstats["step_ms"][1:])),
        step_ms=tstats["step_ms"], wall_s=train_s,
        checkpoint_bytes=os.path.getsize(ckpt),
        resumed_step=resumed["step"], resumed_loss=resumed["losses"][0],
        launches=launches["train_app"])

    # -- 7. rowseg 1M ---------------------------------------------------------
    def rowseg_1m():
        frame_ms, images, out = [], [], None
        with torch.inference_mode():
            for a in angles_1m[:RS_FRAMES]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = pipeline.render(model_1m, cam_1m(a), cfg_rs)
                end.record()
                end.synchronize()
                frame_ms.append(start.elapsed_time(end))
                if int(out.overflow) or not bool(
                        torch.isfinite(out.image).all()):
                    fail(f"rowseg 1M frame at {a} deg: overflow "
                         f"{int(out.overflow)} or non-finite pixels")
                images.append(out.image)
            target_out = pipeline.render(model_1m, cam0, cfg_rs)
        target = target_out.image.clone()
        state = trainer.init_state(model_1m.trainable(), tc_1m)
        step_ms, losses = [], []
        for _ in range(RS_TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, loss = trainer.train_step(state, cam0, target, cfg_rs, tc_1m)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
        with torch.inference_mode():
            after = pipeline.render(state.params, cam0, cfg_rs)
        finite = all(bool(torch.isfinite(t).all())
                     for t in state.params.parameters())
        return dict(frame_ms=frame_ms, images=images, out=out,
                    target_overflow=int(target_out.overflow),
                    after_overflow=int(after.overflow), step_ms=step_ms,
                    losses=losses, params_finite=finite)

    rs, launches["rowseg_1m"] = counted(cuda_lib, rowseg_1m)
    need_launches("rowseg 1M", launches["rowseg_1m"],
                  ("coverage_masks", "row_cumsum_exclusive",
                   "stream_expand_seg", "rasterize_strict",
                   "rasterize_strict_aux", "rasterize_bwd"), RS_TRAIN_STEPS)
    if not (np.isfinite(rs["losses"]).all() and rs["params_finite"]):
        fail(f"rowseg 1M train: non-finite loss or parameters: "
             f"{rs['losses']}")
    if rs["target_overflow"] or rs["after_overflow"]:
        fail(f"rowseg 1M train dropped pairs: overflow "
             f"{rs['target_overflow']} before, {rs['after_overflow']} after")
    cfg_rs_flat = dataclasses.replace(cfg_rs, rowseg_buckets=1,
                                      rowseg_bounds=())
    with torch.inference_mode():
        flat_err = max(float((pipeline.render(model_1m, cam_1m(a),
                                              cfg_rs_flat).image
                              - img).abs().max())
                       for a, img in zip(angles_1m, rs["images"]))
    if flat_err > TOL_RASTER:
        fail(f"rowseg 1M frames differ from the flat path's by {flat_err}")
    say("rowseg_1m", gaussians=N_1M, R=rs_info["R"],
        bounds=rs_info["bounds"], bucket_demands=rs_info["bucket_demands"],
        cap_seg=rs_info["cap_seg"], table=cfg_rs.pair_capacity,
        num_pairs=int(rs["out"].num_pairs), overflow=int(rs["out"].overflow),
        truncated=int(rs["out"].truncated),
        max_abs_diff_vs_flat=flat_err, frame_ms=rs["frame_ms"],
        losses=rs["losses"], step_ms=rs["step_ms"],
        target_overflow=rs["target_overflow"],
        after_overflow=rs["after_overflow"], launches=launches["rowseg_1m"])
    del rs

    # -- 8. the app with --rowseg 4 -----------------------------------------
    out_rs_png = os.path.join(tmp, "app_rowseg.png")
    stats_rs, launches["app_rowseg"] = counted(cuda_lib, lambda: app_main.run([
        "--input", ply_path, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--frames", "8", "--rowseg", "4", "--device", "cuda",
        "--output", out_rs_png, "--log-level", "warn"]))
    need_launches("app --rowseg 4", launches["app_rowseg"],
                  ("row_cumsum_exclusive", "stream_expand_seg",
                   "rasterize_relaxed"), 8)
    if stats_rs["overflow"] or stats_rs["truncated"]:
        fail(f"app --rowseg 4 dropped pairs: {stats_rs}")
    img_rs = image_util.decode_png(open(out_rs_png, "rb").read())
    say("app_rowseg", rowseg=4, frames=stats_rs["frames"],
        pair_capacity=stats_rs["pair_capacity"],
        num_pairs=stats_rs["num_pairs"], overflow=stats_rs["overflow"],
        truncated=stats_rs["truncated"],
        median_frame_ms=stats_rs["median_ms"],
        frame_ms=stats_rs["frame_ms"],
        png_max_abs_diff_vs_flat_app=int(np.abs(
            img_rs.astype(np.int32) - img.astype(np.int32)).max()),
        launches=launches["app_rowseg"])

    # -- 9. the gather paths at 1M ------------------------------------------
    with torch.inference_mode():
        flat_img = pipeline.render(model_1m, cam0, cfg_1m).image
    for name, change in (("presort", dict(presort_depth=True)),
                         ("exact_sort", dict(fused_sort_key=False)),
                         ("gather_expansion", dict(expand_kernel=False))):
        cfg_g = dataclasses.replace(cfg_1m, **change)

        def frame(cfg_g=cfg_g):
            with torch.inference_mode():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                o = pipeline.render(model_1m, cam0, cfg_g)
                end.record()
                end.synchronize()
            return o, start.elapsed_time(end)

        (o, ms), launches[f"1m_{name}"] = counted(cuda_lib, frame)
        need_launches(f"1M {name}", launches[f"1m_{name}"],
                      ("coverage_masks", "expand_pairs", "rasterize_strict"),
                      1)
        if int(o.overflow) or not bool(torch.isfinite(o.image).all()):
            fail(f"1M {name} frame: overflow {int(o.overflow)} or "
                 "non-finite pixels")
        say("gather_1m", path=name, frame_ms=ms,
            num_pairs=int(o.num_pairs), overflow=int(o.overflow),
            truncated=int(o.truncated),
            max_abs_diff_vs_default=float((o.image - flat_img).abs().max()),
            launches=launches[f"1m_{name}"])

    for name, r in results.items():
        r["launches"] = sum(path.get(name, 0) for path in launches.values())
        if r["launches"] == 0:
            fail(f"{name} was not launched on the main path")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported: the port must run without it")
    if any(m == "gaussian_splat_ipu_tpu"
           or m.startswith("gaussian_splat_ipu_tpu.") for m in sys.modules):
        fail("the JAX package was imported: the port must run without it")
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
