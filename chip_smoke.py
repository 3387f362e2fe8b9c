#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gaussian_splat_ipu_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py [--old DIR]

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
     bound scaled to each gradient row (TOL_BWD_*); device-time medians
     of each kernel and each plain version (DeviceTimer: each run queued
     behind a spin, so the wrapper's host work is not counted; the spin
     must cover it for every kernel and library timing), each kernel's
     bound on the H100 (PEAK_*: bytes or operations, for C and D from the
     live evaluations that tile_raster.live_evaluations counts), and for
     E and F the time of one PyTorch call for the same function (never
     called by the port); torch.profiler's device time of A and E beside
     the event timer's; the row scan's design, and with --old DIR the
     parent commit's one-CTA-per-row scan.cu from DIR, timed in turns
     with it (old, new, new, old); the walked, kept and live evaluations
     of C and D on the 1M and app frames; the projection kernel G against
     the plain projection at 2^20 gaussians at SH 3 and on the app scene
     (render/kernels/project.compare: each value within its tolerances,
     the radii that differ counted, none off a threshold), both timed;
     the optimizer kernel H (train/adam.py) against its plain twin at
     2^20 gaussians at SH 3, in 2^21 slots at SH 3 and at 37,941 at SH
     0, every state leaf bit for bit, timed beside the twin and, as a
     yardstick, torch.optim.Adam(fused=True). Then, on a small scene, the CUDA binning (flat, rowseg R = 2 and 3,
     the three gather paths; tables bit-identical), rasterizer,
     pair-table gradient and model gradients against the CPU path;
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
     run resumes for one more step (each step a replay of the captured
     step, the programs registered after the resume);
  7. rowseg 1M: benchmarks/bench_1m.py's balanced row-bucket config
     (tile_group=2, exact_tile_test, strict; bounds from balance_bounds
     over the worst bucket demands of 4 orbit views, R and per-bucket
     capacity by its recipe): 3 orbit frames, held to the flat path's
     images, then 2 train steps;
  8. the app with --rowseg 4 at its default --pair-capacity, 8 frames;
  9. the gather paths at 1M: one frame each with presort_depth,
     fused_sort_key=False (the exact two-pass sort) and
     expand_kernel=False;
 10. the render engine (runtime/engine.py), the app's splat program
     captured as a CUDA graph: the app's 37,941-gaussian scene at
     1280x720 (relaxed) and the 1M config (tile_group=3, exact tiles,
     strict), ENGINE_EQ_FRAMES replays each, their outputs held until
     all have run (2 and more in flight), each equal bit for bit to the
     eager render of the same angle (image, tile_counts, overflow,
     truncated, pairs); pipelined ms per frame, eager and replayed in
     turns, the median of ENGINE_FRAMES frames with 2 in flight; the
     replay's device time (DeviceTimer), the device time of both by
     torch.profiler, and the capture seconds. Then the train step
     captured as a train program (trainer.register_step) in the two train
     cells, train 1M (phase 5's config, targets rendered at other angles
     so the step has a gradient) and train app 640x360 (phase 6's): the
     state after register equal to its snapshot bit for bit; STEP_EQ_STEPS
     replays, each held to the eager step from the same state (losses,
     Adam moments and parameters within the backward's row-scaled bound,
     a parameter past it only where the moment's bound leaves the sign of
     Adam's step open, and then within 4 learning rates; counts, the
     means schedule count and step equal), replays counting no launch;
     pipelined ms of eager and replayed steps in turns, the replay's
     device time, both profiler device times and the capture seconds;
 11. --device points on the card: the app's PNG, histogram and count,
     and the points program through the engine at three angles, equal
     to the plain CPU render_points / tile_histogram of the same model
     and camera;
 12. the app with --ui-port on the card (37,941 gaussians, 1280x720, the
     probe capacity read back from phase 3's --compile-cache): an
     in-process InterfaceClient gets `ready`, sends lambda2 and fov,
     decodes a (720, 1280) preview, gets a histogram with overflow and
     truncated 0, switches to points and back (`device`; the
     histogram's total tells the programs apart), detaches, reconnects
     to a key frame and stops the app, which returns 0. Every wait has
     a deadline of UI_DEADLINE_S;
 13. posed-image datasets at full width: a COLMAP capture of the app
     scene (DS_VIEWS orbit views at 1280x720 rendered on the card, PINHOLE
     intrinsics, OpenCV poses, every DS_POINTS_EVERY-th gaussian mean with
     its dc colour as the SfM cloud) trained by app/train.py --dataset
     (--holdout-every DS_HOLDOUT, exact tiles, DS_PAIR_SLACK x the probed
     demand of the SfM initialisation, DS_STEPS steps, checkpoint, PLY
     and .splat export): initialised from the SfM points, overflow 0 on
     every view, the loss falling, the holdout PSNR above the initial
     model's; app/eval.py on the exported PLY equal to the train CLI's
     holdout PSNR within EVAL_PSNR_TOL dB; the app rendering the .splat;
     and a transforms.json set of TJ_VIEWS straight-alpha RGBA views at
     TJ_SIZE x TJ_SIZE trained over a white background from a random
     initialisation for TJ_STEPS steps;
 14. the training extras at full width: (a) phase 13's capture, its SfM
     tracks written, trained by app/train.py over EX_EPOCHS epochs with
     --densify (a slot buffer of EX_CAPACITY_X x the SfM points, an event
     at each epoch boundary), --depth-loss, --sh-step-every (a bump at
     each epoch boundary: 3 bumps, each a new capture), --max-device-views
     EX_DEVICE_VIEWS and --exact-tiles: overflow 0 on every view, event
     probe and final render, the alive count growing, the loss falling,
     finite parameters, the exported .splat (alive slots only) rendered by
     the app, and C-aux and D launched (bumps + 1) x 4 x 2 + 2 times (each
     capture's warm-ups and capture of the image and depth passes, and
     loss_mix_scale's two eager passes: every step a replay); (b) a copy
     of the capture whose written poses carry a known perturbation and
     whose images a per-view exposure error, trained with --pose-opt,
     --exposure-opt and --depth-loss in one aux program, at the exposure
     rates EX_EXPOSURE_LRS over EX_POSE_EPOCHS epochs each: finite,
     nonzero deltas and maps, the per-epoch loss (falling at the last
     rate), the learned mean |delta| beside the injected one; (c) the
     train 1M cell's model in a slot buffer of EX_SLOTS_1M: replayed
     densify steps held to eager ones (step_err, grad_sum within D's
     bound, vis_count equal) and timed against the plain replayed step (on
     the buffer and on the unpadded model, in turns); one densify_and_prune
     and one reset_opacity timed behind a spin, which also shows that the
     host queues them without waiting on the device; births equal to
     min(candidates, free slots) and no kept slot overwritten; the capture
     seconds of every registration, and the reserved bytes before and
     after 3 re-registrations (old pools freed);
 15. the distributed path (parallel/), DIST_SHARDS shards all on cuda:0:
     (a) kernel C in its three modes and D against their plain versions on
     the 1M frame's last strip (rows 18-23 of 23, one phantom: a nonzero
     tile offset), C and nc equal, D within TOL_BWD_*, each one's time and
     bound beside its whole-grid row; (b) the 1M frame sharded, both
     exchanges, 3 angles, each held to the single-device frame (image
     within TOL_RASTER, pairs, tile counts and truncation equal, no
     overflow or exchange overflow), its replay bit-equal to the eager
     sharded frame, pipelined ms of the single-device replay and the
     sharded replay and eager frame in turns; (c) the 1M train step
     sharded, replayed as a train program, each held to the single-device
     eager step (step_err); (d) a DIST_VB_MESH (view groups, shards) mesh:
     render_views_sharded of DIST_VB_VIEWS views at 640x360, each within
     TOL_RASTER of its single-device render, and the view-batch step
     replayed, held to the single-device step on the mean loss; (e) the
     app with --distributed (PNG equal to phase 3's, frames replayed), its
     UI session (the histogram's exchange_overflow 0), the train CLI with
     --distributed --densify on phase 13's capture (DIST_EPOCHS epochs: no
     drop of either kind, alive growing, loss falling) and with
     --view-batch in distill mode (no drops, loss falling); (f)
     MH_PROCESSES processes sharing cuda:0 over gloo (parallel/
     multihost.py; this script with --mh-child) load their shards of the
     app's PLY and render a frame equal to the one-process render; then
     (this script with --mh-train) train with app/train.py --distributed,
     one shard per process, every program eager: the train app cell's
     distill run (MH_STEPS steps, a checkpoint and a PLY) and a
     --densify run (events at steps 4 and 8, births at both), each held
     to the one-process --distributed run (captured) made here: every
     step's loss within MH_LOSS_RTOL, the events' steps and alive counts
     equal, nothing dropped, only the primary's checkpoint written; the
     eager pipelined ms a step of each process;
 16. kernels C and D against the dense oracle (render/oracle.py) on
     ORACLE_GAUSSIANS seeded gaussians at ORACLE_W x ORACLE_H: C strict,
     C-aux and the DIST_SHARDS-shard frame (C at tile offsets) within
     ORACLE_TOL of the oracle's image; D's model gradients within
     ORACLE_GRAD_TOL of autograd through the oracle on a black
     background; the error at a white background reported only;
 17. utils/profiling.trace() around TRACE_FRAMES replayed app frames
     (exact tiles), each inside a Tracepoint: the Chrome trace names
     kernels A, B and C and the Tracepoint's range;
 18. the native host library (io/native.py), the scene tool and a
     clustered scene: (a) the library built by g++ on the card's host from
     the port's csrc/host/ and loaded; (b) stack_f32_columns on the
     2^20-row PLY of phase 4's scene (14 columns) and center_flip on its
     means, equal to numpy, and to_uint8 on a 1280x720 frame of phase 3's
     scene within 1 count, host ms with and without the library; (c) phase
     13's capture through load_colmap with the library at downscale 1 and
     2, every image bit-equal to decode_png_torch, load seconds with and
     without it, then app/train.py --dataset --downscale 2 on the
     prefetched targets (exact tiles, a probed capacity): no drop, finite
     losses, kernels A, B, C-aux and D launched; (d) app/scene_tool.py on
     phase 13's exported PLY (prune, SH cap, centre-and-flip, --stats, PLY
     and .splat), both outputs rendered by the app with overflow 0, and
     the app scene at full width (strict C) against its mirrored copy
     through the mirrored camera (MIRROR_*); (e)
     GaussianModel.clustered(2^20) at the 1M config: one frame, overflow
     0, then C strict on its table against the plain version, timed with
     its bound beside the uniform 1M row.
Each phase runs inside a Tracepoint named after it; their host seconds
(profiling.tracepoint_summary) are printed after phase 18.
The launch counters are zeroed just before each of phases 3-15, 17 and
18's paths and read just after: every kernel must have carried the path
that uses it (phase 16 compares kernels with the oracle, and its launches
are reported apart). The apps (phases 3, 6, 8, 12-15, 17, 18) run their
frames and steps as graph replays, which launch through no wrapper: a
kernel of a captured program counts engine.WARMUP_CALLS + 1 launches
(warm-up and capture) however many frames or steps are replayed, and the
engine phase checks that replays count 0. Processes this script starts
launch in their own counters, reported in their phase's line.
Neither jax nor the JAX package (gaussian_splat_ipu_tpu) may be imported.
Then one JSON line of per-kernel results, the card line, and last the
status line {"ok": true, "device": {...}}. Any failure exits non-zero
before it, and so does a run still going after DEADLINE_S (with every
thread's stack).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import faulthandler
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
# Engine phase: replays held to eager, and frames timed per pipelined run.
ENGINE_EQ_FRAMES = 8
ENGINE_FRAMES = 24
UI_DEADLINE_S = 60.0
# Engine phase, train cells: replays held to the eager step, and steps
# timed per pipelined run.
STEP_EQ_STEPS = 3
STEP_PIPE_STEPS = 16
# Dataset phase: the COLMAP capture's views, holdout, steps (2 epochs of
# the 21 training views), orbit (radius, height above the centre of the
# app scene's [-1, 1]^3 cloud), vertical fov, SfM cloud thinning and pair
# capacity over the probed demand; the transforms.json set's views, size
# and steps; the eval CLI's agreement with the train CLI.
DS_VIEWS = 24
DS_HOLDOUT = 8
DS_STEPS = 42
DS_RADIUS, DS_HEIGHT = 3.5, 0.8
DS_FOV_Y_DEG = 40.0
DS_POINTS_EVERY = 4
DS_PAIR_SLACK = 1.3
TJ_VIEWS, TJ_SIZE, TJ_STEPS = 8, 800, 8
EVAL_PSNR_TOL = 0.01
# Training-extras phase: (a) phase 13's capture over EX_EPOCHS epochs, an
# event and an SH bump at each epoch boundary, a slot buffer of
# EX_CAPACITY_X x the SfM points, pair capacity EX_PAIR_X x the SfM
# model's probed demand (densification stops at 0.8 of it), targets
# streamed EX_DEVICE_VIEWS at a time; (b) the perturbed capture: pose
# noise (rotation rad, translation, per axis), exposure gain and bias
# spreads, the three learning rates / weights and the epochs of each run;
# (c) the slot buffer of the train 1M cell's model. At the first exposure
# rate, 1e-2 (the reference's suggested start), the loss does not settle:
# Adam runs over the whole (V, 3, 4) tensor, as optax does, so each view's
# map moves on its momentum between its visits. The loss is reported
# there and must fall at the last rate. tests/test_torch_exposure_epochs.py
# holds the port's per-epoch losses to the JAX CLI's at both rates.
EX_EPOCHS = 4
EX_CAPACITY_X = 4
EX_PAIR_X = 6
EX_DEVICE_VIEWS = 8
EX_GRAD_THRESHOLD = 5e-5
EX_DEPTH_W = 0.1
EX_POSE_ROT, EX_POSE_TRANS = 0.004, 0.01
EX_GAIN, EX_BIAS = 0.1, 0.03
EX_POSE_LR = 5e-4
EX_EXPOSURE_LRS = (1e-2, 1e-3)
EX_POSE_EPOCHS = 8
EX_SLOTS_1M = 1 << 21
# Distributed phase: the shards of the 1M and app meshes (all on cuda:0),
# the view batch's (view groups, shards) mesh and its views, and the
# epochs of the train CLI runs.
DIST_SHARDS = 4
DIST_VB_MESH = (2, 2)
DIST_VB_VIEWS = 4
DIST_EPOCHS = 2
# Multi-process phase: processes sharing cuda:0 over gloo, and each one's
# time limit. Training: the train app cell's distill run for MH_STEPS steps;
# the densify run over MH_DENSIFY_VIEWS views (an event each epoch, at steps
# 4 and 8) with a threshold nearly every visible gaussian passes, in a slot
# buffer of MH_CAPACITY_X x the scene; every step's loss held to the
# one-process --distributed run's within MH_LOSS_RTOL (kernel D's atomics
# reorder the gradient sums, so not bit for bit).
MH_PROCESSES = 2
MH_TIMEOUT_S = 300
MH_STEPS = 6
MH_DENSIFY_VIEWS = 4
MH_DENSIFY_STEPS = 8
MH_DENSIFY_THRESHOLD = 1e-7
MH_CAPACITY_X = 4
MH_LOSS_RTOL = 1e-4
# Oracle phase: a scene at tests/test_backward_kernel.py:53-61's density
# (192 gaussians over 64x64) at 160x128, held to render/oracle.py at the
# tiled render's bar (tests/test_tile_raster.py:45) and the backward's
# (tests/test_backward_kernel.py:61). Footprints reach the full alpha_min
# radius (extent_sigma 0, tests/test_tile_raster.py:120-133): at 3 sigma
# the tiled render cuts a near-opaque splat's tail, which the oracle, with
# no footprint, composites: C strict then fails the bar on this scene.
ORACLE_W, ORACLE_H = 160, 128
ORACLE_GAUSSIANS = 960
ORACLE_TOL = dict(atol=2e-5, rtol=1e-4)
ORACLE_GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
# Trace phase: app frames replayed under profiling.trace().
TRACE_FRAMES = 3
# Host-library phase: host timings are medians of NATIVE_REPS calls; the
# decode's train run takes NATIVE_TRAIN_STEPS steps; the scene tool prunes
# below TOOL_PRUNE_OPACITY (3DGS's own). The mirrored frame is held to
# MIRROR_TOL (tests/test_scene_tool.py:130) but for MIRROR_SHARE of its
# values, each within MIRROR_CUTOFF_X alpha_min: at full width a few
# splats' alpha rounds across alpha_min, or a pixel's transmittance across
# strict termination, in one frame and not the other (f32: the mirrored
# means and camera round apart), and each such crossing moves a pixel by
# up to about one alpha_min.
NATIVE_REPS = 5
NATIVE_TRAIN_STEPS = 6
TOOL_PRUNE_OPACITY = 0.005
MIRROR_TOL = 2e-5
MIRROR_SHARE = 1e-3
MIRROR_CUTOFF_X = 2.0
# A run still going after this many seconds prints every thread's stack and
# exits non-zero (the run's limit is 1200 s).
DEADLINE_S = 1140
# DeviceTimer: the least spin queued before each timed run, how often a
# run a host stall outlasted is timed again, the cycles of the spin that
# measures the rate it runs at, and the device time and the most calls of
# one timed run.
SPIN_MS = 5.0
SPIN_RETRIES = 3
SPIN_CAL_CYCLES = 10_000_000
RUN_MS = 1.0
MAX_CALLS = 20
# The C entry of the one-CTA-per-row scan.cu that --old builds: x, r, n,
# out, stream (the look-back scan added a scratch pointer).
OLD_SCAN_SIGNATURE = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p)
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
    "project_gaussians": ("project.cu", "render/projection.py (no Pallas "
                          "kernel: XLA fuses the projection)"),
    "project_gaussians_bwd": ("project_bwd.cu", "render/projection.py (no "
                              "Pallas kernel: XLA differentiates the "
                              "projection)"),
    "project_gaussians_bwd_view": ("project_bwd.cu", "render/projection.py "
                                   "(no Pallas kernel: XLA differentiates "
                                   "the projection in the view too)"),
    "adam": ("adam.cu", "train/adam.py (no Pallas kernel: the update is "
             "optax's, fused by XLA)"),
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


def raster_work(binned, cfg, nc, tile_offset: int = 0) -> dict:
    """What kernels C and D walk on one frame or strip (nc from the strict
    aux forward): pairs of the walk (each range cut at start + the tile's
    largest nc), those the tile cull keeps, and the live evaluations;
    evaluations = pairs x pixels of a tile."""
    from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
        live_evaluations, surviving_pairs)
    walked, kept = surviving_pairs(binned, cfg, nc, tile_offset)
    npix = cfg.pixels_per_tile
    return dict(walked_pairs=walked, kept_pairs=kept,
                walked_evaluations=walked * npix,
                kept_evaluations=kept * npix,
                live_evaluations=live_evaluations(
                    binned, cfg, nc, tile_offset=tile_offset))


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


class DeviceTimer:
    """Device time of a function, without the host's share.

    `ms` queues each timed run behind a spin on the stream
    (torch.cuda._sleep) of at least SPIN_MS and twice the host's time to
    queue the run, then the start event, fn() `calls` times back to back,
    the end event. The device stamps the start event when the spin ends,
    by which time the host has queued the whole run: the wrapper's checks,
    allocations and ctypes call are not counted as kernel time. `calls`
    makes a run last about RUN_MS (at most MAX_CALLS calls), so that the
    events' own cost of a few us is shared by many calls of a short
    kernel. The spin covered the host when the host's time from the
    spin's enqueue to the end event's enqueue stays below the spin's
    length; `checks` keeps that check for every timing. A run the spin did
    not cover (the host stalled: the machine's cores are shared) is timed
    again behind a spin twice as long, at most SPIN_RETRIES times."""

    def __init__(self):
        self.checks: list = []
        self._rate = None

    def cycles_per_ms(self) -> float:
        """SM cycles per ms of the spin: the larger of the rate a spin of
        SPIN_CAL_CYCLES runs at (CUDA events) and the card's reported
        clock, so that a spin of c cycles lasts at least c / this ms."""
        import torch
        if self._rate is None:
            torch.cuda._sleep(1000)
            ms = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                torch.cuda._sleep(SPIN_CAL_CYCLES)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            khz = getattr(torch.cuda.get_device_properties(0), "clock_rate",
                          0)
            self._rate = max(SPIN_CAL_CYCLES / float(np.median(ms)),
                             float(khz))
        return self._rate

    def ms(self, fn, reps: int = 5, label: str = "", enforce: bool = True
           ) -> float:
        """Median device time of one fn() call in ms over `reps` runs
        after one warm-up call. A timing whose spin did not cover the host
        fails the run when `enforce`; the plain versions (PyTorch programs
        of many launches, some reading a loop length back from the device,
        which no spin can cover) are timed with enforce=False and their
        check is only recorded."""
        import torch
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        one_ms = max(start.elapsed_time(end), 1e-3)
        calls = int(min(MAX_CALLS, max(1, RUN_MS // one_ms)))
        spin_ms = (max(SPIN_MS, 2.0 * calls * host_ms) if enforce
                   else SPIN_MS)
        times, worst, retries = [], 0.0, 0
        while len(times) < reps:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda._sleep(int(spin_ms * self.cycles_per_ms()))
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            host = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            if enforce and host >= spin_ms and retries < SPIN_RETRIES:
                retries += 1
                spin_ms *= 2.0
                continue
            worst = max(worst, host)
            times.append(start.elapsed_time(end) / calls)
        covered = worst < spin_ms
        self.checks.append(dict(label=label, calls=calls, spin_ms=spin_ms,
                                host_ms=worst, covered=covered,
                                enforced=enforce, retries=retries))
        if enforce and not covered:
            fail(f"timer: {label or fn}: the host took {worst:.3f} ms to "
                 f"queue the run, longer than the {spin_ms:.3f} ms spin "
                 "before it")
        return float(np.median(times))

    def once(self, fn, label: str, spin_ms: float = 100.0):
        """One fn() call queued behind a spin of spin_ms: (its result, its
        device ms). Fails unless the host queued the whole call within the
        spin, so a call that waits on the device (a read back) fails."""
        import torch
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * self.cycles_per_ms()))
        start.record()
        out = fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        covered = host_ms < spin_ms
        self.checks.append(dict(label=label, calls=1, spin_ms=spin_ms,
                                host_ms=host_ms, covered=covered,
                                enforced=True))
        if not covered:
            fail(f"timer: {label}: the host took {host_ms:.3f} ms to queue "
                 f"one call, longer than the {spin_ms:.3f} ms spin before "
                 "it (does it read back from the device?)")
        return out, start.elapsed_time(end)

    def summary(self) -> dict:
        """The spin checks so far: every enforced one covered the host (or
        the run failed); each plain version's, by label."""
        enforced = [t for t in self.checks if t["enforced"]]
        return dict(
            cycles_per_ms=self.cycles_per_ms(), timings=len(self.checks),
            enforced=len(enforced),
            enforced_covered=sum(t["covered"] for t in enforced),
            retimed_runs=sum(t.get("retries", 0) for t in enforced),
            worst_enforced_host_over_spin=max(
                (t["host_ms"] / t["spin_ms"] for t in enforced), default=0.0),
            calls={t["label"]: t["calls"] for t in enforced},
            plain=[(t["label"], t["covered"], round(t["host_ms"], 3))
                   for t in self.checks if not t["enforced"]])


def profiled_ms(fn, reps: int = 5) -> float:
    """Device time of fn() in ms by torch.profiler: the sum of the CUDA
    activity (kernels, memsets) of `reps` calls, over reps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
             for ev in prof.key_averages() if ev.device_type.name == "CUDA")
    return us / 1e3 / reps


def build_lib(srcs, out_dir: str, signatures: dict, flags=()):
    """nvcc each source in parallel with the port's flags and `flags`,
    link them into one library in a new directory under out_dir, load it
    and bind each entry of `signatures` (name -> ctypes argtypes). Returns
    (library, build log)."""
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = cuda_lib._nvcc()
    work = tempfile.mkdtemp(dir=out_dir)
    objs = [os.path.join(work, os.path.basename(s) + ".o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, *flags, "-c",
                               "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    log = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        fail(f"nvcc failed on {srcs}:\n{log}")
    lib_path = os.path.join(work, "lib.so")
    subprocess.run([nvcc, "-shared", "-o", lib_path, *objs], check=True)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, log


def ptxas_lines(log: str, key: str) -> list:
    """ptxas's register, shared-memory and spill lines of the entries whose
    name holds `key`, each after the name of its entry."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = key in ln
        if keep and ("Compiling entry" in ln or "Used" in ln
                     or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return out


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


def need_exact(path: str, launches: dict, names, count: int):
    for k in names:
        if launches.get(k, 0) != count:
            fail(f"{path} launched {k} {launches.get(k, 0)} times, not "
                 f"{count}: {launches}")


def pipelined_ms(step, frames: int, in_flight: int = 2) -> list:
    """The app loop's pacing: step(k) for k = 0..frames, each followed by
    an event, the oldest event waited for once `in_flight` are
    outstanding. Returns the host ms between consecutive retirements
    (`frames` values)."""
    import collections

    import torch
    inflight, times, t_prev = collections.deque(), [], None

    def retire():
        nonlocal t_prev
        inflight.popleft().synchronize()
        now = time.perf_counter()
        if t_prev is not None:
            times.append((now - t_prev) * 1e3)
        t_prev = now

    for k in range(frames + 1):
        step(k)
        ev = torch.cuda.Event()
        ev.record()
        inflight.append(ev)
        if len(inflight) >= in_flight:
            retire()
    while inflight:
        retire()
    return times


def engine_check(label, model, cfg, host_cam, angles, timer):
    """Phase 10 for one scene: the app's splat program captured by a
    RenderEngine, ENGINE_EQ_FRAMES replays against the eager render of
    the same angle, then pipelined and device times. host_cam(angle) is
    the frame's camera on the CPU. Returns (facts, the register's
    launches)."""
    import torch
    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    dev = model.device
    splat = app_main.splat_program(cfg)

    def host_args(a):
        cam = host_cam(a)
        return model, cam.view, cam.proj, cam.env_rot

    def dev_args(a):
        m, *cam = host_args(a)
        return (m, *(t.to(dev) for t in cam))

    def eager(a):
        with torch.inference_mode():
            return splat(*dev_args(a))

    eng = engine_lib.RenderEngine(RuntimeConfig(device="cuda"))
    cuda_lib.launches.clear()
    eng.register("project", splat, dev_args(angles[0]))
    captured = dict(cuda_lib.launches)
    seq = [angles[k % len(angles)] for k in range(ENGINE_EQ_FRAMES)]
    outs = [eng.run("project", *host_args(a)) for a in seq]
    torch.cuda.synchronize()
    if dict(cuda_lib.launches) != captured:
        fail(f"engine {label}: replays launched through a wrapper: "
             f"{dict(cuda_lib.launches)} after capture {captured}")
    for k, (a, out) in enumerate(zip(seq, outs)):
        want = eager(a)
        for name, x, y in zip(out._fields, out, want):
            if not torch.equal(x, y):
                fail(f"engine {label}: replay {k} (angle {a}) {name} "
                     f"differs from the eager render")
        if int(out.overflow) or int(out.truncated):
            fail(f"engine {label}: replay {k} dropped pairs")
    n = len(angles)
    turns = [("eager", lambda k: eager(angles[k % n])),
             ("replay", lambda k: eng.run("project",
                                          *host_args(angles[k % n])))]
    times = {"eager": [], "replay": []}
    for name, step in turns + turns[::-1]:      # eager, replay, replay, eager
        times[name].append(float(np.median(pipelined_ms(step,
                                                        ENGINE_FRAMES))))
    return dict(
        frames_held_equal=len(seq), angles=list(angles),
        pairs=[int(o.count) for o in outs[:n]],
        capture_s=eng.programs["project"].compile_seconds,
        pipelined_eager_ms=times["eager"], pipelined_replay_ms=times["replay"],
        frames_per_median=ENGINE_FRAMES,
        replay_device_ms=timer.ms(
            lambda: eng.run("project", *host_args(angles[0])),
            label=f"engine {label} replay"),
        replay_profiler_ms=profiled_ms(
            lambda: eng.run("project", *host_args(angles[0])), reps=3),
        eager_profiler_ms=profiled_ms(lambda: eager(angles[0]), reps=3),
        reserved_mb=torch.cuda.memory_reserved(dev) / 2 ** 20), captured


def step_err(label, got, ref, loss, want, tc) -> dict:
    """A replayed step's state `got` against the eager step's `ref`, both
    from the same state: the losses, each group's Adam moments and its
    parameters within the backward's row-scaled bound (TOL_BWD_*, rows =
    one component over all gaussians). A parameter may pass its bound
    only where the eager first moment of its gaussian is itself within
    its bound of zero, so that the bound leaves the sign of Adam's step
    (about one learning rate) open; there it must stay within 4 learning
    rates, and such entries are counted. Counts, the means schedule count
    and step must be equal."""
    import torch
    from gaussian_splat_ipu_tpu_torch.train import adam
    lr = dict(means=tc.lr_means * tc.scene_extent,
              log_scales=tc.lr_log_scales, quats=tc.lr_quats,
              opacities=tc.lr_opacities, sh=tc.lr_sh)

    def rows(x):
        x = x.detach()
        return x.reshape(x.shape[0], -1).T

    out = dict(loss=float(loss), loss_eager=float(want))
    if not abs(out["loss"] - out["loss_eager"]) <= (
            TOL_BWD_ROW + TOL_BWD_REL) * abs(out["loss_eager"]):
        fail(f"{label}: loss {out['loss']} against the eager step's "
             f"{out['loss_eager']}")
    for name in adam.LABELS:
        a, b = got.opt_state.adam[name], ref.opt_state.adam[name]
        if not torch.equal(a.count, b.count):
            fail(f"{label}: {name} Adam count differs from the eager step")
        errs = dict(mu=bwd_err(f"{label} {name} mu", rows(a.mu), rows(b.mu)),
                    nu=bwd_err(f"{label} {name} nu", rows(a.nu), rows(b.nu)))
        mu = rows(b.mu).abs()
        free = (mu <= TOL_BWD_ROW * mu.amax(-1, keepdim=True)
                + TOL_BWD_REL * mu).any(0)
        p, q = rows(getattr(got.params, name)), rows(getattr(ref.params,
                                                             name))
        err = (p - q).abs()
        over = err > (TOL_BWD_ROW * q.abs().amax(-1, keepdim=True)
                      + TOL_BWD_REL * q.abs())
        sign_free = over & free & (err <= 4.0 * lr[name])
        if not bool(torch.isfinite(p).all()) or bool(
                (over & ~sign_free).any()):
            fail(f"{label}: {int((over & ~sign_free).sum())} {name} entries "
                 f"outside the bound; max abs error {float(err.max())}")
        out[name] = dict(errs, param=float(err.max()),
                         sign_free=int(sign_free.sum()))
    if not (torch.equal(got.opt_state.means_lr_count,
                        ref.opt_state.means_lr_count)
            and torch.equal(got.step, ref.step)):
        fail(f"{label}: schedule count or step differs from the eager step")
    return out


def step_check(label, model, cfg, tc, cams, targets, timer):
    """Phase 10 for one train cell: the train step registered from a fresh
    state, the state afterwards equal to its snapshot bit for bit;
    STEP_EQ_STEPS replays, each held to the eager step from the same state
    (step_err) and launching nothing; then pipelined ms per step, eager
    and replayed in turns (medians of STEP_PIPE_STEPS), the replay's
    device time, both profiler device times and the capture seconds. The
    steps cycle through cams / targets. Returns (facts, the register's
    launches)."""
    import torch
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    dev = model.device
    n = len(cams)
    state = trainer.init_state(model.trainable(), tc)
    snapshot = state.to_numpy()
    eng = engine_lib.RenderEngine(RuntimeConfig(device="cuda"))
    cuda_lib.launches.clear()
    prog = trainer.register_step(eng, state, cams[0], targets[0], cfg, tc)
    captured = dict(cuda_lib.launches)
    for i, (a, b) in enumerate(zip(state.to_numpy(), snapshot)):
        if not np.array_equal(a, b):
            fail(f"train {label}: register left leaf {i} of the state "
                 "other than its snapshot")
    del snapshot
    held = []
    for k in range(STEP_EQ_STEPS):
        eager = trainer.TrainState.from_numpy(state.to_numpy(), dev)
        before = dict(cuda_lib.launches)
        loss = eng.run(trainer.STEP_PROGRAM, state, cams[k % n],
                       targets[k % n])
        torch.cuda.synchronize()
        if dict(cuda_lib.launches) != before:
            fail(f"train {label}: a replay launched through a wrapper")
        _, want = trainer.train_step(eager, cams[k % n], targets[k % n],
                                     cfg, tc)
        held.append(step_err(f"train {label} step {k}", state, eager, loss,
                             want, tc))
        del eager
    timed = trainer.TrainState.from_numpy(state.to_numpy(), dev)

    def eager_step(k):
        trainer.train_step(timed, cams[k % n], targets[k % n], cfg, tc)

    def replay_step(k):
        eng.run(trainer.STEP_PROGRAM, state, cams[k % n], targets[k % n])

    turns = [("eager", eager_step), ("replay", replay_step)]
    times = {"eager": [], "replay": []}
    for name, step in turns + turns[::-1]:      # eager, replay, replay, eager
        times[name].append(float(np.median(pipelined_ms(step,
                                                        STEP_PIPE_STEPS))))
    return dict(
        gaussians=model.num_gaussians, capture_s=prog.compile_seconds,
        state_equal_after_register=True, steps_held=len(held), held=held,
        pipelined_eager_ms=times["eager"], pipelined_replay_ms=times["replay"],
        steps_per_median=STEP_PIPE_STEPS,
        replay_device_ms=timer.ms(lambda: replay_step(0),
                                  label=f"train {label} replay"),
        replay_profiler_ms=profiled_ms(lambda: replay_step(0), reps=3),
        eager_profiler_ms=profiled_ms(lambda: eager_step(0), reps=3),
        reserved_mb=torch.cuda.memory_reserved(dev) / 2 ** 20), captured


def orbit_poses(n: int, radius: float, height: float) -> list:
    """n OpenCV world-to-camera poses (4x4 f64) on a circle of `radius`
    around the origin, `height` above it, each looking at the origin (z
    forward, y down)."""
    out = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        eye = np.array([radius * np.sin(a), -height, radius * np.cos(a)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross(z, [0.0, 1.0, 0.0])
        x /= np.linalg.norm(x)
        w2c = np.eye(4)
        w2c[:3, :3] = np.stack([x, np.cross(z, x), z])
        w2c[:3, 3] = -w2c[:3, :3] @ eye
        out.append(w2c)
    return out


def render_views(model, cfg, poses, intr, size, dev) -> list:
    """The port's render of `model` at each OpenCV pose (pinhole `intr`,
    size (W, H)) as (H, W, 4) host arrays; fails on dropped pairs."""
    import torch
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.render import pipeline
    out = []
    with torch.inference_mode():
        for w2c in poses:
            cam = Camera.from_intrinsics(*intr, *size, w2c.astype(np.float32),
                                         device=dev)
            o = pipeline.render(model, cam, cfg)
            if int(o.overflow) or int(o.truncated):
                fail("dataset capture: a render dropped pairs")
            out.append(o.image.cpu().numpy())
    return out


def write_capture(root: str, model, poses, intr, images) -> int:
    """A COLMAP capture under root: images/view_XXX.png, and sparse/0 with
    one PINHOLE camera per view, the poses, every DS_POINTS_EVERY-th
    gaussian mean of `model` with its dc colour as the SfM cloud, and its
    tracks: each point observed by every view it projects into, in front
    of the camera and inside the frame. Returns the cloud's size."""
    from gaussian_splat_ipu_tpu_torch.io import colmap
    from gaussian_splat_ipu_tpu_torch.ops.sh import SH_C0
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    p = model.to_numpy()
    xyz = p["means"][::DS_POINTS_EVERY].astype(np.float64)
    rgb = image_util.to_uint8(SH_C0 * p["sh"][::DS_POINTS_EVERY, 0] + 0.5)
    fx, fy, cx, cy = intr
    cams, imgs, tracks = {}, {}, {k + 1: [] for k in range(len(xyz))}
    for i, (w2c, img) in enumerate(zip(poses, images)):
        name = f"view_{i:03d}.png"
        image_util.write_png(os.path.join(root, "images", name),
                             img[..., :3])
        h, w = img.shape[:2]
        cam = xyz @ w2c[:3, :3].T + w2c[:3, 3]
        z = np.maximum(cam[:, 2], 1e-9)
        u, v = fx * cam[:, 0] / z + cx, fy * cam[:, 1] / z + cy
        seen = np.nonzero((cam[:, 2] > 0.01) & (u >= 0) & (u < w)
                          & (v >= 0) & (v < h))[0]
        for j, k in enumerate(seen):
            tracks[k + 1].append((i + 1, j))
        cams[i + 1] = ("PINHOLE", w, h, list(intr))
        imgs[i + 1] = (name, colmap.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3],
                       i + 1, [(u[k], v[k], k + 1) for k in seen])
    points = {k + 1: (tuple(xyz[k]), tuple(int(c) for c in rgb[k]),
                      tracks[k + 1]) for k in range(len(xyz))}
    colmap.write_binary_model(os.path.join(root, "sparse", "0"), cams, imgs,
                              points)
    return len(xyz)


def write_transforms_rgba(root: str, poses, fov_x: float, images) -> None:
    """A blender transforms.json set: straight-alpha RGBA PNGs r_i.png
    (bare stems in the json) and OpenGL camera-to-world matrices."""
    import json as json_lib
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    os.makedirs(root, exist_ok=True)
    gl_to_cv = np.diag([1.0, -1.0, -1.0, 1.0])
    frames = []
    for i, (w2c, img) in enumerate(zip(poses, images)):
        a = img[..., 3:4]
        rgba = np.concatenate([img[..., :3] / np.maximum(a, 1e-6), a], -1)
        image_util.write_png(os.path.join(root, f"r_{i}.png"), rgba)
        frames.append({"file_path": f"r_{i}", "transform_matrix":
                       (np.linalg.inv(w2c) @ gl_to_cv).tolist()})
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json_lib.dump({"camera_angle_x": fov_x, "frames": frames}, f)


def dataset_phase(tmp: str, app_scene, dev, launches: dict) -> dict:
    """Phase 13: the COLMAP capture trained, scored by the eval CLI and
    exported as .splat, and the transforms.json set; launches of each run
    go into `launches`. Returns what the phase saw."""
    import torch
    import gaussian_splat_ipu_tpu_torch.app.eval as app_eval
    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    import gaussian_splat_ipu_tpu_torch.app.train as app_train
    from gaussian_splat_ipu_tpu_torch.io import colmap
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    captured = engine_lib.WARMUP_CALLS + 1
    t0 = time.perf_counter()
    f = 0.5 * HEIGHT / np.tan(np.radians(DS_FOV_Y_DEG) / 2.0)
    intr = (f, f, WIDTH / 2.0, HEIGHT / 2.0)
    poses = orbit_poses(DS_VIEWS, DS_RADIUS, DS_HEIGHT)
    cfg_big = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                           pair_capacity=1 << 21, exact_tile_test=True)
    root = os.path.join(tmp, "colmap_capture")
    n_points = write_capture(root, app_scene.model, poses, intr,
                             render_views(app_scene.model, cfg_big, poses,
                                          intr, (WIDTH, HEIGHT), dev))
    # The pair demand of the SfM initialisation over every view.
    fs, xyz, rgb = colmap.load_colmap(root, device=dev)
    init = GaussianModel.from_points(xyz, rgb, sh_degree=3, device=dev)
    with torch.inference_mode():
        demand = max(int(b.num_pairs + b.overflow) for b in (
            binning.bin_splats(project_gaussians(init, c, cfg_big), cfg_big)
            for c in fs.cameras))
    c = cfg_big.chunk_size
    cap = -(-int(DS_PAIR_SLACK * demand) // c) * c
    capture_s = time.perf_counter() - t0
    del fs, init

    ckpt = os.path.join(tmp, "ds.npz")
    ply = os.path.join(tmp, "ds.ply")
    splat = os.path.join(tmp, "ds.splat")
    common = ["--dataset", root, "--holdout-every", str(DS_HOLDOUT),
              "--exact-tiles", "--pair-capacity", str(cap), "--device",
              "cuda", "--log-level", "warn"]
    start = app_train.run(common + ["--steps", "0"])
    t0 = time.perf_counter()
    st, launches["dataset train"] = counted(cuda_lib, lambda: app_train.run(
        common + ["--steps", str(DS_STEPS), "--checkpoint", ckpt,
                  "--export-ply", ply, "--export-splat", splat]))
    train_s = time.perf_counter() - t0
    need_exact("dataset train", launches["dataset train"],
               ("rasterize_strict_aux", "rasterize_bwd", "rasterize_strict"),
               captured)
    need_exact("dataset train", launches["dataset train"],
               ("coverage_masks", "stream_expand"), 2 * captured)
    views = DS_VIEWS - len(range(0, DS_VIEWS, DS_HOLDOUT))
    if not (st["init"] == f"{n_points} SfM points"
            and st["num_gaussians"] == n_points and st["views"] == views):
        fail(f"dataset train: init {st['init']}, {st['views']} views")
    drops = (st["target_overflow"] + st["target_truncated"]
             + st["holdout_overflow"] + [st["final_overflow"],
                                         st["final_truncated"]])
    if any(drops):
        fail(f"dataset train dropped pairs: {st}")
    first = float(np.mean(st["losses"][:views]))
    last = float(np.mean(st["losses"][-views:]))
    if not (np.isfinite(st["losses"]).all() and last < first):
        fail(f"dataset train: the loss did not fall ({first} -> {last})")
    if not (np.isfinite(st["eval_psnr"])
            and st["eval_psnr"] > start["eval_psnr"]):
        fail(f"dataset train: holdout PSNR {st['eval_psnr']} not above the "
             f"initial model's {start['eval_psnr']}")

    ev, launches["dataset eval"] = counted(cuda_lib, lambda: app_eval.run([
        "--input", ply, "--dataset", root, "--split", "holdout",
        "--holdout-every", str(DS_HOLDOUT), "--exact-tiles",
        "--pair-capacity", str(cap), "--device", "cuda", "--log-level",
        "warn"]))
    need_exact("dataset eval", launches["dataset eval"],
               ("rasterize_strict", "coverage_masks"), captured)
    if abs(ev["mean_psnr"] - st["eval_psnr"]) > EVAL_PSNR_TOL:
        fail(f"eval CLI mean PSNR {ev['mean_psnr']} against the train "
             f"CLI's holdout PSNR {st['eval_psnr']}")

    splat_png = os.path.join(tmp, "splat.png")
    sp, launches["dataset splat app"] = counted(cuda_lib, lambda: app_main.run(
        ["--input", splat, "--width", str(WIDTH), "--height", str(HEIGHT),
         "--frames", "2", "--pair-capacity", "0", "--device", "cuda",
         "--output", splat_png, "--log-level", "warn"]))
    img = image_util.decode_png(open(splat_png, "rb").read())
    if sp["overflow"] or int((img[..., 3] > 0).sum()) == 0:
        fail(f"the app's render of the exported .splat is empty or dropped "
             f"pairs: {sp['overflow']}")

    fov = np.radians(DS_FOV_Y_DEG)          # square views: fov x = fov y
    ft = 0.5 * TJ_SIZE / np.tan(fov / 2.0)
    tj_poses = orbit_poses(TJ_VIEWS, DS_RADIUS, DS_HEIGHT)
    tj_root = os.path.join(tmp, "transforms_rgba")
    write_transforms_rgba(tj_root, tj_poses, float(fov), render_views(
        app_scene.model, dataclasses.replace(cfg_big, image_width=TJ_SIZE,
                                             image_height=TJ_SIZE),
        tj_poses, (ft, ft, TJ_SIZE / 2.0, TJ_SIZE / 2.0),
        (TJ_SIZE, TJ_SIZE), dev))
    tj, launches["dataset transforms"] = counted(cuda_lib, lambda:
                                                 app_train.run([
        "--dataset", tj_root, "--background", "white", "--steps",
        str(TJ_STEPS), "--device", "cuda", "--log-level", "warn"]))
    need_exact("dataset transforms", launches["dataset transforms"],
               ("rasterize_strict_aux", "rasterize_bwd"), captured)
    if (any(tj["target_overflow"]) or tj["final_overflow"]
            or not np.isfinite(tj["losses"]).all()
            or not tj["init"].endswith("random gaussians")):
        fail(f"transforms.json run: {tj}")
    return dict(
        views=DS_VIEWS, width=WIDTH, height=HEIGHT, holdout_every=DS_HOLDOUT,
        capture_root=root, train_views=views, sfm_points=n_points,
        init=st["init"],
        probed_demand=demand, pair_capacity=cap, steps=DS_STEPS,
        loss_first=st["losses"][0], loss_last=st["losses"][-1],
        first_epoch_loss=first, last_epoch_loss=last,
        step_ms=st["step_ms"], median_step_ms=float(np.median(
            st["step_ms"][1:])), pipelined_ms=st["pipelined_ms"],
        median_pipelined_ms=float(np.median(st["pipelined_ms"])),
        capture_s=st["capture_seconds"], psnr_view0=st["psnr"],
        holdout_psnr_init=start["eval_psnr"], holdout_psnr=st["eval_psnr"],
        eval_mean_psnr=ev["mean_psnr"], eval_mean_ssim=ev["mean_ssim"],
        eval_views=ev["views"], final_pairs=st["num_pairs"],
        checkpoint_bytes=os.path.getsize(ckpt),
        splat_records=os.path.getsize(splat) // 32,
        splat_app_lit_pixels=int((img[..., 3] > 0).sum()),
        splat_app_pairs=sp["num_pairs"], write_and_probe_s=capture_s,
        train_wall_s=train_s, transforms=dict(
            views=TJ_VIEWS, size=TJ_SIZE, steps=TJ_STEPS, init=tj["init"],
            loss_first=tj["losses"][0], loss_last=tj["losses"][-1],
            psnr_view0=tj["psnr"], step_ms=tj["step_ms"],
            pipelined_ms=tj["pipelined_ms"],
            capture_s=tj["capture_seconds"], pairs=tj["num_pairs"]))


def registrations_of(stats: dict) -> list:
    """A train CLI run's program registrations, for the phase's line."""
    return [dict(r, reserved_mb=(r.pop("reserved_bytes") or 0) / 2 ** 20)
            for r in stats["registrations"]]


def drops_of(stats: dict) -> list:
    return (stats["target_overflow"] + stats["target_truncated"]
            + stats["holdout_overflow"]
            + [stats["final_overflow"], stats["final_truncated"]]
            + [e["overflow"] for e in stats["events"]])


def epoch_means(label: str, losses: list, per_epoch: int) -> list:
    """Mean loss of each epoch; fails unless finite and the last epoch's
    below the first's."""
    means = [float(np.mean(losses[i:i + per_epoch]))
             for i in range(0, len(losses), per_epoch)]
    if not (np.isfinite(losses).all() and means[-1] < means[0]):
        fail(f"{label}: the loss did not fall: epoch means {means}")
    return means


def extras_colmap(tmp: str, ds: dict, dev, launches: dict) -> dict:
    """Phase 14 (a): phase 13's capture (with its SfM tracks) trained by
    app/train.py with --densify, --depth-loss, --sh-step-every (one bump
    per epoch, 3 in the run), --max-device-views and --exact-tiles, then
    the exported (compacted) .splat rendered by the app."""
    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    import gaussian_splat_ipu_tpu_torch.app.train as app_train
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    captured = engine_lib.WARMUP_CALLS + 1
    views, n_points = ds["train_views"], ds["sfm_points"]
    c = 128                                    # RasterConfig.chunk_size
    cap = -(-int(EX_PAIR_X * ds["probed_demand"]) // c) * c
    per_epoch = -(-views // EX_DEVICE_VIEWS) * EX_DEVICE_VIEWS
    ckpt = os.path.join(tmp, "extras.npz")
    splat = os.path.join(tmp, "extras.splat")
    t0 = time.perf_counter()
    st, launches["extras colmap"] = counted(cuda_lib, lambda: app_train.run([
        "--dataset", ds["capture_root"], "--holdout-every", str(DS_HOLDOUT),
        "--exact-tiles", "--pair-capacity", str(cap), "--device", dev.type,
        "--log-level", "warn", "--steps", str(EX_EPOCHS * views),
        "--densify", "--capacity", str(EX_CAPACITY_X * n_points),
        "--densify-from", str(views), "--densify-every", str(views),
        "--densify-grad-threshold", str(EX_GRAD_THRESHOLD),
        "--depth-loss", str(EX_DEPTH_W), "--sh-step-every", str(views),
        "--max-device-views", str(EX_DEVICE_VIEWS), "--checkpoint", ckpt,
        "--export-splat", splat]))
    wall_s = time.perf_counter() - t0
    regs = registrations_of(st)
    steps_regs = [r for r in regs if r["program"] == "densify_step"]
    if [r["active_sh_degree"] for r in steps_regs] != [0, 1, 2, 3]:
        fail(f"extras colmap: the step was not registered once per SH "
             f"degree: {regs}")
    # Each registration captures 4 steps (3 warm-ups and the capture) of
    # 2 passes (image and depth); loss_mix_scale adds 2 eager backward
    # passes; the render program is registered once.
    per_step = len(steps_regs) * captured * 2
    need_exact("extras colmap", launches["extras colmap"],
               ("rasterize_strict_aux", "rasterize_bwd"), per_step + 2)
    need_exact("extras colmap", launches["extras colmap"],
               ("rasterize_strict",), captured)
    need_exact("extras colmap", launches["extras colmap"],
               ("coverage_masks", "stream_expand"), captured + per_step + 2)
    events = st["events"]
    if len(events) < 3 or any(drops_of(st)):
        fail(f"extras colmap: {len(events)} events, drops {drops_of(st)}")
    if not (events[-1]["alive"] > n_points
            and st["final_alive"] == events[-1]["alive"]):
        fail(f"extras colmap: the alive count did not grow from {n_points}: "
             f"{events}")
    if st["step"] != EX_EPOCHS * per_epoch or st["device_views"] != \
            EX_DEVICE_VIEWS:
        fail(f"extras colmap: {st['step']} steps, {st['device_views']} "
             "views a piece")
    epochs = epoch_means("extras colmap", st["losses"], per_epoch)
    with np.load(ckpt) as data:
        if not all(np.isfinite(data[f"leaf_{i}"]).all() for i in range(5)):
            fail("extras colmap: non-finite parameters in the checkpoint")
        alive_ckpt = int(data["leaf_24"].sum())
    png = os.path.join(tmp, "extras_splat.png")
    sp, launches["extras splat app"] = counted(cuda_lib, lambda: app_main.run(
        ["--input", splat, "--width", str(WIDTH), "--height", str(HEIGHT),
         "--frames", "2", "--pair-capacity", "0", "--device", dev.type,
         "--output", png, "--log-level", "warn"]))
    img = image_util.decode_png(open(png, "rb").read())
    records = os.path.getsize(splat) // 32
    if (sp["overflow"] or int((img[..., 3] > 0).sum()) == 0
            or records != st["final_alive"] or alive_ckpt != records):
        fail(f"extras colmap: the exported .splat ({records} records, "
             f"{st['final_alive']} alive) rendered with overflow "
             f"{sp['overflow']}")
    return dict(
        sfm_points=n_points, slots=st["num_gaussians"], pair_capacity=cap,
        steps=st["step"], epochs=EX_EPOCHS, steps_per_epoch=per_epoch,
        events=events, final_alive=st["final_alive"], epoch_loss=epochs,
        registrations=regs, median_step_ms=float(np.median(st["step_ms"])),
        median_pipelined_ms=float(np.median(st["pipelined_ms"])),
        psnr_view0=st["psnr"], holdout_psnr=st["eval_psnr"],
        splat_records=records, splat_app_lit_pixels=int(
            (img[..., 3] > 0).sum()), wall_s=wall_s)


def extras_pose(tmp: str, app_scene, ds: dict, dev, launches: dict) -> dict:
    """Phase 14 (b): a copy of phase 13's capture whose written poses carry
    a known SE(3) perturbation per view and whose images a per-view affine
    exposure error, trained with --pose-opt, --exposure-opt and
    --depth-loss in one aux program: at each exposure rate of
    EX_EXPOSURE_LRS, over EX_POSE_EPOCHS epochs, finite, nonzero deltas and
    maps and the per-epoch loss, which must fall at the last rate."""
    import torch
    import gaussian_splat_ipu_tpu_torch.app.train as app_train
    from gaussian_splat_ipu_tpu_torch.render import projection
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.train import pose_opt
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    captured = engine_lib.WARMUP_CALLS + 1
    rng = np.random.default_rng(SEED)
    f = 0.5 * HEIGHT / np.tan(np.radians(DS_FOV_Y_DEG) / 2.0)
    intr = (f, f, WIDTH / 2.0, HEIGHT / 2.0)
    poses = orbit_poses(DS_VIEWS, DS_RADIUS, DS_HEIGHT)
    cfg_big = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                           pair_capacity=1 << 21, exact_tile_test=True)
    images = render_views(app_scene.model, cfg_big, poses, intr,
                          (WIDTH, HEIGHT), dev)
    inj = np.concatenate([rng.normal(0, EX_POSE_ROT, (DS_VIEWS, 3)),
                          rng.normal(0, EX_POSE_TRANS, (DS_VIEWS, 3))], 1)
    written = [pose_opt.se3_exp(torch.tensor(d, dtype=torch.float64)).numpy()
               @ w2c for d, w2c in zip(inj, poses)]
    gain = rng.uniform(1.0 - EX_GAIN, 1.0 + EX_GAIN, (DS_VIEWS, 3))
    bias = rng.uniform(-EX_BIAS, EX_BIAS, (DS_VIEWS, 3))
    exposed = [np.concatenate([np.clip(im[..., :3] * g + b, 0.0, 1.0),
                               im[..., 3:]], -1)
               for im, g, b in zip(images, gain, bias)]
    root = os.path.join(tmp, "colmap_perturbed")
    write_capture(root, app_scene.model, written, intr, exposed)
    del images, exposed
    steps = EX_POSE_EPOCHS * ds["train_views"]
    train = [i for i in range(DS_VIEWS) if i % DS_HOLDOUT]
    out = dict(injected_mean_abs_delta=float(np.linalg.norm(
        inj[train], axis=1).mean()),
        injected_mean_abs_gain_dev=float(np.abs(gain[train] - 1.0).mean()),
        injected_mean_abs_bias=float(np.abs(bias[train]).mean()), runs=[])
    for lr in EX_EXPOSURE_LRS:
        path = f"extras pose exposure {lr:g}"
        plain = dict(projection.plain_calls)
        st, launches[path] = counted(cuda_lib, lambda: app_train.run([
            "--dataset", root, "--holdout-every", str(DS_HOLDOUT),
            "--exact-tiles", "--pair-capacity", str(ds["pair_capacity"]),
            "--device", dev.type, "--log-level", "warn", "--steps",
            str(steps), "--pose-opt", str(EX_POSE_LR), "--exposure-opt",
            str(lr), "--depth-loss", str(EX_DEPTH_W)]))
        need_exact(path, launches[path],
                   ("rasterize_strict_aux", "rasterize_bwd"), 2 * captured)
        need_exact(path, launches[path], ("rasterize_strict",), captured)
        need_exact(path, launches[path], ("coverage_masks", "stream_expand"),
                   3 * captured)
        # The image's and the depth's projection: G-bwd with the view's
        # gradient, no plain projection for the camera.
        need_exact(path, launches[path], ("project_gaussians_bwd",
                                          "project_gaussians_bwd_view"),
                   2 * captured)
        if projection.plain_calls["camera_grad"] != plain.get("camera_grad",
                                                               0):
            fail(f"{path}: the plain projection ran for the camera")
        if any(drops_of(st)):
            fail(f"{path} dropped pairs: {drops_of(st)}")
        per = ds["train_views"]
        if lr == EX_EXPOSURE_LRS[-1]:
            epochs = epoch_means(path, st["losses"], per)
        else:
            epochs = [float(np.mean(st["losses"][i:i + per]))
                      for i in range(0, steps, per)]
        deltas, mats = st["pose_deltas"], st["exposure_mats"]
        if not (np.isfinite(deltas).all() and np.isfinite(mats).all()
                and np.abs(deltas).min(axis=1).max() > 0.0
                and np.abs(mats - np.eye(3, 4)).max(axis=(1, 2)).min()
                > 0.0):
            fail(f"{path}: deltas or exposure maps non-finite or zero")
        out["runs"].append(dict(
            exposure_lr=lr, pose_lr=EX_POSE_LR, depth_weight=EX_DEPTH_W,
            steps=st["step"], epoch_loss=epochs,
            learned_mean_abs_delta=float(np.linalg.norm(deltas,
                                                        axis=1).mean()),
            learned_mean_abs_gain_dev=float(np.abs(
                mats[:, :, :3] - np.eye(3)).mean()),
            learned_mean_abs_bias=float(np.abs(mats[:, :, 3]).mean()),
            psnr_view0_corrected=st["psnr"], holdout_psnr=st["eval_psnr"],
            registrations=registrations_of(st),
            median_step_ms=float(np.median(st["step_ms"])),
            median_pipelined_ms=float(np.median(st["pipelined_ms"]))))
    return out


def clone_state(state):
    """A device copy of a TrainState (the eager twin of a replayed step)."""
    from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                              GaussianModel)
    from gaussian_splat_ipu_tpu_torch.train import trainer
    params = GaussianModel(*(getattr(state.params, k).detach().clone()
                             for k in FIELDS), requires_grad=True)
    adam = {k: trainer.AdamState(*(t.clone() for t in st))
            for k, st in state.opt_state.adam.items()}
    return trainer.TrainState(params, trainer.OptState(
        adam, state.opt_state.means_lr_count.clone()), state.step.clone())


def extras_1m(model_1m, cfg, tc, cam, timer) -> dict:
    """Phase 14 (c): the train 1M cell's model in a slot buffer of
    EX_SLOTS_1M slots: the replayed densify step held to the eager one,
    timed against the plain replayed step; one densify_and_prune and one
    reset_opacity timed and checked on the device; 3 re-registrations
    freeing their old pools."""
    import torch
    from gaussian_splat_ipu_tpu_torch.models.gaussians import FIELDS
    from gaussian_splat_ipu_tpu_torch.render import pipeline
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.train import densify, trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    dev = model_1m.device
    n = model_1m.num_gaussians
    with torch.inference_mode():
        tgts = [pipeline.render(model_1m, c, cfg).image for c in
                (cam(10.0), cam(20.0), cam(30.0))]
    tgts = [t.clone() for t in tgts]
    cam0 = cam(0.0)
    state = trainer.init_state(
        densify.pad_model(model_1m, EX_SLOTS_1M).trainable(), tc)
    d = densify.init_state(n, EX_SLOTS_1M, device=dev)
    eng = engine_lib.RenderEngine(RuntimeConfig(device=dev.type))
    torch.cuda.empty_cache()
    r_empty = torch.cuda.memory_reserved(dev)
    prog = densify.register_step(eng, state, d, cam0, tgts[0], cfg, tc)
    pool_mb = (torch.cuda.memory_reserved(dev) - r_empty) / 2 ** 20
    captures = [("densify_step", prog.compile_seconds)]
    step = densify.make_train_step(cfg, tc)
    held = []
    for k in range(STEP_EQ_STEPS):
        eager = clone_state(state)
        gs, vc = d.grad_sum.clone(), d.vis_count.clone()
        before = dict(cuda_lib.launches)
        loss = eng.run(densify.STEP_PROGRAM, state, d.grad_sum, d.vis_count,
                       cam0, tgts[k % 3])
        torch.cuda.synchronize()
        if dict(cuda_lib.launches) != before:
            fail("densify 1M: a replay launched through a wrapper")
        visible = int((d.vis_count - vc).sum())
        want = step(eager, gs, vc, cam0, tgts[k % 3])
        facts = step_err(f"densify 1M step {k}", state, eager, loss, want, tc)
        facts["grad_sum"] = bwd_err(f"densify 1M step {k} grad_sum",
                                    d.grad_sum[None], gs[None])
        if not torch.equal(d.vis_count, vc):
            fail(f"densify 1M step {k}: vis_count differs from the eager "
                 "step's")
        facts["visible"] = visible
        held.append(facts)
        del eager, gs, vc

    # The replayed densify step against the plain replayed step, on the
    # same slot buffer and on the unpadded model, in turns.
    captures.append(("train_step slots", trainer.register_step(
        eng, state, cam0, tgts[0], cfg, tc).compile_seconds))
    base = trainer.init_state(model_1m.trainable(), tc)
    eng_1m = engine_lib.RenderEngine(RuntimeConfig(device=dev.type))
    captures.append(("train_step 1M", trainer.register_step(
        eng_1m, base, cam0, tgts[0], cfg, tc).compile_seconds))
    runs = {
        "densify_step": lambda: eng.run(densify.STEP_PROGRAM, state,
                                        d.grad_sum, d.vis_count, cam0,
                                        tgts[0]),
        "train_step_slots": lambda: eng.run(trainer.STEP_PROGRAM, state,
                                            cam0, tgts[0]),
        "train_step_1m": lambda: eng_1m.run(trainer.STEP_PROGRAM, base, cam0,
                                            tgts[0])}
    times = {k: [] for k in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(timer.ms(runs[name], label=f"extras 1M {name}"))
    eng.release(trainer.STEP_PROGRAM)
    del eng_1m, base

    # One event at the median screen gradient of the slots that have one
    # (most visible gaussians of this scene get none: they lie behind the
    # pixels' stop), checked against the counts and masks taken before it.
    with torch.no_grad():
        avg = d.grad_sum / torch.clamp_min(d.vis_count, 1).float()
        thr = float(torch.quantile(avg[d.alive & (avg > 0)], 0.5))
        dcfg = densify.DensifyConfig(grad_threshold=thr,
                                     scene_extent=tc.scene_extent)
        old = {k: getattr(state.params, k).detach().clone() for k in FIELDS}
        keep = d.alive & ~(torch.sigmoid(old["opacities"]) < dcfg.min_opacity)
        cand = keep & (avg > thr)
        split = cand & (torch.exp(old["log_scales"]).amax(-1)
                        > dcfg.percent_dense * dcfg.scene_extent)
        n_keep, n_birth = keep.sum(), cand.sum()
    (state, d), event_ms = timer.once(
        lambda: densify.densify_and_prune(state, d, dcfg),
        label="extras 1M densify_and_prune")
    with torch.no_grad():
        births = d.alive.sum() - n_keep
        want_births = torch.minimum(n_birth, EX_SLOTS_1M - n_keep)
        if not bool(births == want_births) or not bool(d.alive[keep].all()):
            fail(f"densify 1M event: {int(births)} births for "
                 f"{int(want_births)} = min(candidates, free), or a kept "
                 "slot died")
        same = keep & ~split
        for k in FIELDS:
            if not torch.equal(getattr(state.params, k)[same], old[k][same]):
                fail(f"densify 1M event: a kept slot's {k} was overwritten")
        facts_event = dict(threshold=thr, kept=int(n_keep),
                           candidates=int(n_birth), splits=int(split.sum()),
                           births=int(births),
                           alive_after=int(d.alive.sum()))
        del old, keep, cand, split, same, avg
    _, reset_ms = timer.once(lambda: densify.reset_opacity(state, d, dcfg),
                             label="extras 1M reset_opacity")
    ceiling = float(torch.log(torch.tensor(0.01 / 0.99)))
    if float(state.params.opacities.detach()[d.alive].max()) > ceiling:
        fail("densify 1M: reset_opacity left a live opacity above 0.01")

    # Three more registrations of the step (as 3 SH bumps do): each frees
    # the pool of the graph it replaces.
    torch.cuda.empty_cache()
    r_before = torch.cuda.memory_reserved(dev)
    for degree in (1, 2, 3):
        captures.append((f"densify_step again ({degree})",
                         densify.register_step(
                             eng, state, d, cam0, tgts[0],
                             dataclasses.replace(cfg,
                                                 active_sh_degree=degree),
                             tc).compile_seconds))
    torch.cuda.empty_cache()
    r_after = torch.cuda.memory_reserved(dev)
    if r_after - r_before > 0.5 * pool_mb * 2 ** 20:
        fail(f"densify 1M: 3 re-registrations grew the reserved memory by "
             f"{(r_after - r_before) / 2 ** 20:.0f} MB (a capture reserves "
             f"{pool_mb:.0f} MB): old pools were not freed")
    loss = eng.run(densify.STEP_PROGRAM, state, d.grad_sum, d.vis_count,
                   cam0, tgts[0])
    if not (bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(t).all()) for t in state.params.parameters())):
        fail("densify 1M: non-finite loss or parameters after the event")
    return dict(
        gaussians=n, slots=EX_SLOTS_1M, steps_held=len(held), held=held,
        replay_device_ms=times,
        densify_over_plain_1m=float(np.mean(times["densify_step"])
                                    / np.mean(times["train_step_1m"])),
        event=facts_event, densify_and_prune_ms=event_ms,
        reset_opacity_ms=reset_ms, captures_s=captures,
        capture_pool_mb=pool_mb,
        reserved_mb_before_3_registrations=r_before / 2 ** 20,
        reserved_mb_after_3_registrations=r_after / 2 ** 20)


def ui_session(ply_path: str, probe_cache: str, out_png: str,
               extra=()) -> dict:
    """Phase 12: the app with --ui-port on the card (and the flags
    `extra`), driven by an in-process InterfaceClient; fails on any step
    that does not happen within UI_DEADLINE_S. Returns what the session
    saw."""
    import json as json_lib
    import socket
    import threading

    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    from gaussian_splat_ipu_tpu_torch.ui.server import InterfaceClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    result = {}

    def run_app():
        try:
            result["rc"] = app_main.main([
                "--input", ply_path, "--width", str(WIDTH), "--height",
                str(HEIGHT), "--ui-port", str(port), "--device", "cuda",
                "--pair-capacity", "0", "--compile-cache", probe_cache,
                "--output", out_png, "--log-level", "warn", *extra])
        except BaseException as e:
            result["error"] = repr(e)

    def connect(what):
        deadline = time.monotonic() + UI_DEADLINE_S
        while True:
            try:
                cli = InterfaceClient("127.0.0.1", port, timeout=2.0)
                break
            except OSError:
                if "error" in result or time.monotonic() > deadline:
                    fail(f"ui: could not connect ({what}): {result}")
                time.sleep(0.1)
        next_packet(cli, lambda t, _: t == "ready", f"ready ({what})")
        return cli

    def next_packet(cli, accept, what):
        deadline = time.monotonic() + UI_DEADLINE_S
        while time.monotonic() < deadline:
            try:
                ptype, payload = cli.recv()
            except socket.timeout:
                continue
            except (ConnectionError, OSError) as e:
                fail(f"ui: connection lost waiting for {what}: {e!r}")
            if accept(ptype, payload):
                return ptype, payload
        fail(f"ui: no {what} within {UI_DEADLINE_S} s")

    def histogram(cli, accept, what):
        def take(ptype, payload):
            return ptype == "tile_histogram" and accept(
                json_lib.loads(payload.decode()))
        return json_lib.loads(next_packet(cli, take, what)[1].decode())

    t0 = time.perf_counter()
    thread = threading.Thread(target=run_app, daemon=True)
    thread.start()
    cli = connect("first")
    ready_s = time.perf_counter() - t0
    cli.send("lambda2", 30.0)
    cli.send("fov", 0.6)
    frames = []

    def decoded(ptype, payload):
        if ptype == "render_preview":
            f = cli.decode_preview(payload)
            if f is not None:
                frames.append(f.shape)
                return True
        return False

    next_packet(cli, decoded, "a decoded preview frame")
    if frames[0][:2] != (HEIGHT, WIDTH):
        fail(f"ui: preview frame of shape {frames[0]}")
    hist = histogram(cli, lambda h: True, "a histogram")
    if hist["overflow"] or hist["truncated"] or hist["exchange_overflow"]:
        fail(f"ui: the histogram reports drops: {hist}")
    splat_total = sum(hist["counts"])
    # The points histogram counts at most one entry per gaussian, the
    # splat one every (gaussian, tile) pair.
    n = APP_GAUSSIANS
    cli.send("device", "points")
    pts = histogram(cli, lambda h: sum(h["counts"]) <= n, "a points frame")
    cli.send("device", "cuda")
    back = histogram(cli, lambda h: sum(h["counts"]) > n,
                     "a splat frame after points")
    cli.send("detach")
    cli.sock.settimeout(0.2)
    deadline = time.monotonic() + UI_DEADLINE_S
    while True:
        try:
            cli.recv()
        except socket.timeout:
            pass
        except (ConnectionError, OSError):
            break
        if time.monotonic() > deadline:
            fail("ui: the detached client was not dropped")
    cli.close()
    if not thread.is_alive():
        fail(f"ui: the app stopped on detach: {result}")
    cli = connect("after detach")
    _, key = next_packet(cli, lambda t, _: t == "render_preview",
                         "a preview after reconnecting")
    if key[4] != 0:
        fail("ui: the stream did not restart on a key frame")
    key_shape = cli.decode_preview(key).shape
    cli.send("stop")
    thread.join(timeout=UI_DEADLINE_S)
    cli.close()
    if thread.is_alive() or result.get("rc") != 0:
        fail(f"ui: the app did not stop with rc 0: {result}")
    return dict(port=port, ready_s=ready_s, preview_shape=list(frames[0]),
                exchange_overflow=hist["exchange_overflow"],
                splat_histogram_total=splat_total,
                points_histogram_total=sum(pts["counts"]),
                splat_again_total=sum(back["counts"]),
                keyframe_shape=list(key_shape), rc=result["rc"],
                wall_s=time.perf_counter() - t0)


def project_row(label: str, model, cam, cfg, cuda_ms) -> dict:
    """Kernel G against the plain projection on one frame: compare's
    errors (fails on a value outside its tolerances or a radius that
    differs off a threshold), the device ms of both and G's byte bound
    (each input byte it needs read once, each output written once)."""
    from gaussian_splat_ipu_tpu_torch.render import projection
    from gaussian_splat_ipu_tpu_torch.render.kernels import project
    res = project.compare(projection.project_gaussians(model, cam, cfg),
                          projection.project_gaussians_torch(model, cam, cfg),
                          cfg)
    bad = {k: v for k, v in res.items() if v and (
        k.endswith("_outside") or k == "radius_differ_off_threshold")}
    if bad:
        fail(f"project_gaussians {label}: {bad}")
    degree = (model.sh_degree if cfg.active_sh_degree < 0
              else min(model.sh_degree, cfg.active_sh_degree))
    kc = (degree + 1) ** 2
    return dict(
        shape=label, **res,
        ms=cuda_ms(lambda: projection.project_gaussians(model, cam, cfg),
                   label=f"project_gaussians {label}"),
        plain_ms=cuda_ms(lambda: projection.project_gaussians_torch(
            model, cam, cfg), label=f"project_gaussians {label} plain",
            enforce=False),
        **bound(model.num_gaussians * (44 + 12 * kc + 48), 0))


def project_bwd_row(label: str, model, cam, cfg, cuda_ms) -> dict:
    """Kernel G-bwd on one frame, every gaussian given normal cotangents of
    its five outputs (no probe, as in a fit step), against the plain
    projection's f32 autograd, both against the float64 gradient
    (project.compare_bwd; fails outside its bounds); the device ms of
    G-bwd and of the plain version's autograd backward (its graph kept),
    and G-bwd's byte bound (each parameter and cotangent byte it needs
    read once, each gradient byte written once). Runs with autograd on
    whatever mode the caller is in, on copies of the model and camera."""
    import torch
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import projection
    from gaussian_splat_ipu_tpu_torch.render.kernels import project
    degree = (model.sh_degree if cfg.active_sh_degree < 0
              else min(model.sh_degree, cfg.active_sh_degree))
    with torch.inference_mode(False), torch.enable_grad():
        trainable = model.trainable()
        cam = Camera(cam.view.clone(), cam.proj.clone(), cam.env_rot.clone())
        params = list(trainable.parameters())
        outs = list(projection.project_gaussians_torch(trainable, cam,
                                                       cfg)[:5])
        gen = torch.Generator(device=model.device).manual_seed(SEED)
        cots = [torch.randn(o.shape, generator=gen, device=o.device)
                for o in outs]
        args = [p.detach() for p in params] + [cam.view, cam.proj,
                                               cam.env_rot]
        got = project.project_bwd(*args, cfg, degree, cots)
        plain = torch.autograd.grad(outs, params, cots, retain_graph=True)
        m64 = GaussianModel(*(p.detach().double() for p in params),
                            requires_grad=True, dtype=torch.float64)
        c64 = Camera(cam.view.double(), cam.proj.double())
        c64.env_rot = cam.env_rot.double()
        exact = torch.autograd.grad(
            list(projection.project_gaussians_torch(m64, c64, cfg)[:5]),
            list(m64.parameters()), [c.double() for c in cots])
        del m64
        live = torch.ones(model.num_gaussians, dtype=torch.bool,
                          device=model.device)
        res = project.compare_bwd(got[:5], plain, exact, live)
        del exact, got, plain
        bad = project.compare_bwd_failures(res)
        if bad:
            fail(f"project_gaussians_bwd {label}: {bad}")
        kc, k = (degree + 1) ** 2, model.sh.shape[1]
        return dict(
            shape=label, **res,
            ms=cuda_ms(lambda: project.project_bwd(*args, cfg, degree, cots),
                       label=f"project_gaussians_bwd {label}"),
            plain_ms=cuda_ms(lambda: torch.autograd.grad(
                outs, params, cots, retain_graph=True),
                label=f"project_gaussians_bwd {label} plain", enforce=False),
            **bound(model.num_gaussians * (44 + 12 * kc + 40 + 44 + 12 * k),
                    0))


def project_bwd_view_row(label: str, model, cam, cfg, cuda_ms) -> dict:
    """Kernel G-bwd with the view matrix's gradient (pose refinement) on
    one frame, every gaussian given normal cotangents of xy, conic, colour
    and opacity (depth's none, as in a render): the view's gradient against
    the plain twin's in float64 on the same f32 inputs, G-bwd's error at
    most ACC_FACTOR times the f32 twin's (floored at ACC_FLOOR of the
    norm; fails otherwise), its parameter gradients equal to the
    camera-free launch's bit for bit; the device ms of both launches, of
    the plain projection's autograd backward with the view a leaf (the
    path a view gradient took before this kernel; its graph kept, its view
    gradient's error beside G-bwd's), and the view launch's byte bound
    (project_bwd_row's, with the 112 B of partial sums of each block of
    128 gaussians)."""
    import torch
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import FIELDS
    from gaussian_splat_ipu_tpu_torch.render import projection
    from gaussian_splat_ipu_tpu_torch.render.kernels import project
    degree = (model.sh_degree if cfg.active_sh_degree < 0
              else min(model.sh_degree, cfg.active_sh_degree))
    n = model.num_gaussians
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    widths = (2, None, 3, 3, None)
    cots = [None if w is None else torch.randn(
        (n, w), generator=gen, device=model.device) for w in widths]
    cots[4] = torch.randn((n,), generator=gen, device=model.device)
    args = [getattr(model, k).detach() for k in FIELDS] + [
        cam.view, cam.proj, cam.env_rot, cfg, degree]
    got = project.project_bwd(*args, cots, view_grad=True)
    plain = project.project_bwd(*args, cots)
    if not all(torch.equal(a, b) for a, b in zip(got[:5], plain[:5])):
        fail(f"project_gaussians_bwd view {label}: the parameter gradients "
             "differ from the camera-free launch's")
    twin = project.project_gaussians_bwd_torch(*args, cots,
                                               view_grad=True)[-1]
    exact = project.project_gaussians_bwd_torch(
        *(a.double() if isinstance(a, torch.Tensor) else a for a in args),
        [None if c is None else c.double() for c in cots],
        view_grad=True)[-1]
    err = float((got[-1].double() - exact).norm())
    err_twin = float((twin.double() - exact).norm())
    limit = project.ACC_FACTOR * max(
        err_twin, project.ACC_FLOOR * float(exact.norm()))
    del twin, plain
    if not err <= limit:
        fail(f"project_gaussians_bwd view {label}: error {err:.3e} over "
             f"{limit:.3e}")
    with torch.inference_mode(False), torch.enable_grad():
        trainable = model.trainable()
        leaves = list(trainable.parameters())
        view = cam.view.clone().requires_grad_(True)
        outs = projection.project_gaussians_torch(
            trainable, Camera(view, cam.proj.clone(), cam.env_rot.clone()),
            cfg)[:5]
        pairs = [(o, c) for o, c in zip(outs, cots) if c is not None]
        outs_used = [o for o, _ in pairs]
        cots_used = [c for _, c in pairs]
        g_view = torch.autograd.grad(outs_used, leaves + [view], cots_used,
                                     retain_graph=True)[-1]
        err_plain = float((g_view.double() - exact).norm())
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            outs_used, leaves + [view], cots_used, retain_graph=True),
            label=f"project_gaussians_bwd view {label} plain", enforce=False)
    del exact, outs, outs_used, pairs, g_view
    kc, k = (degree + 1) ** 2, model.sh.shape[1]
    blocks = -(-n // project.THREADS)
    return dict(
        shape=label, view_err=err, view_err_twin=err_twin,
        view_err_plain=err_plain, view_ratio=err / limit,
        ms=cuda_ms(lambda: project.project_bwd(*args, cots, view_grad=True),
                   label=f"project_gaussians_bwd view {label}"),
        camera_free_ms=cuda_ms(lambda: project.project_bwd(*args, cots),
                               label=f"project_gaussians_bwd {label}"),
        plain_ms=plain_ms,
        **bound(n * (44 + 12 * kc + 36 + 44 + 12 * k)
                + blocks * 4 * project.VIEW_PARTS, 0))


def adam_row(label: str, n: int, sh_degree: int, cuda_ms) -> dict:
    """Kernel H against its plain twin on two updates of n gaussians at
    sh_degree (the second from nonzero moments), every leaf of the state
    bit for bit (fails otherwise); the device ms of H, of the twin and, as
    a library yardstick only, of torch.optim.Adam(fused=True) over the
    same five tensors (another function: no SH scale, no renormalisation,
    never called by the port); H's byte bound: p, g, mu and nu read and p,
    mu and nu written once, 28 B a parameter."""
    import torch
    from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                              GaussianModel)
    from gaussian_splat_ipu_tpu_torch.train import adam, trainer
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tc = trainer.TrainConfig()
    state = trainer.init_state(GaussianModel.random(
        n, generator=gen, device=dev, sh_degree=sh_degree).trainable(), tc)
    grads = {k: torch.randn(getattr(state.params, k).shape, generator=gen,
                            device=dev) for k in FIELDS}
    twin = clone_state(state)
    for _ in range(2):
        adam.adam_update(state.params, grads, state.opt_state, tc)
        adam.apply_param_updates_torch(twin.params, grads, twin.opt_state,
                                       tc)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(state.to_numpy(), twin.to_numpy())):
        if not np.array_equal(a, b, equal_nan=True):
            fail(f"adam {label}: state leaf {i} (TrainState.to_numpy's "
                 f"order): {int((a != b).sum())} of {a.size} differ from "
                 "the twin")
    n_params = sum(p.numel() for p in state.params.parameters())
    row = dict(shape=label, parameters=n_params, leaves_equal=True,
               ms=cuda_ms(lambda: adam.adam_update(
                   state.params, grads, state.opt_state, tc),
                   label=f"adam {label}"),
               plain_ms=cuda_ms(lambda: adam.apply_param_updates_torch(
                   twin.params, grads, twin.opt_state, tc),
                   label=f"adam {label} plain", enforce=False))
    del state
    params = list(twin.params.parameters())
    for p, k in zip(params, FIELDS):
        p.grad = grads[k]
    opt = torch.optim.Adam(params, lr=tc.lr_sh, eps=tc.adam_eps, fused=True)
    row["library_ms"] = cuda_ms(opt.step, label=f"adam {label} library")
    return dict(row, **bound(28 * n_params, 0))


def check_aux_and_bwd(binned, cfg, seed: int, plain_reps: int, cuda_ms):
    """The strict aux forward and the backward kernel against their plain
    versions on one binned frame: returns a dict of errors and times
    (cuda_ms: a DeviceTimer's ms)."""
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
        aux_ms=cuda_ms(lambda: rasterize.rasterize_tiles_aux(binned, cfg),
                       label="rasterize_strict_aux"),
        aux_plain_ms=cuda_ms(lambda: rasterize_tiles_torch(
            binned, cfg, need_aux=True), reps=plain_reps,
            label="rasterize_strict_aux plain", enforce=False),
        bwd_ms=cuda_ms(lambda: rasterize.rasterize_backward(*args),
                       label="rasterize_bwd"),
        bwd_plain_ms=cuda_ms(lambda: rasterize_backward_torch(*args),
                             reps=plain_reps, label="rasterize_bwd plain",
                             enforce=False))


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


def dist_strip_capacity(splats, cfg, d: int, capacity) -> tuple:
    """Each of the d strips' pair demand on one frame, and the per-shard
    pair capacity for the worst: capacity(demand, chunk)."""
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.render import binning
    rows = distributed._rows_per_device(cfg, d)
    demand = []
    for j in range(d):
        b = binning.bin_splats(splats, cfg, j * rows, rows,
                               cfg.pair_capacity)
        demand.append(int(b.num_pairs + b.overflow))
    return demand, capacity(max(demand), cfg.chunk_size)


def dist_strip_kernels(splats, cfg, d: int, cap: int, results: dict,
                       cuda_ms) -> dict:
    """15 (a): kernel C in its three modes and kernel D against their plain
    versions on the last strip of a d-shard mesh, at its tile offset: C
    equal, nc equal, D within the row-scaled bound; each one's device time
    and bound beside the whole-grid row of phase 2."""
    import torch
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.render import binning
    from gaussian_splat_ipu_tpu_torch.render.kernels import rasterize
    from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
        rasterize_backward_torch, rasterize_tiles_torch)
    rows = distributed._rows_per_device(cfg, d)
    row_lo = (d - 1) * rows
    off = row_lo * cfg.tiles_x
    binned = binning.bin_splats(splats, cfg, row_lo, rows, cap)
    tiles, nc = rasterize.rasterize_tiles_aux(binned, cfg, off)
    ref_tiles, ref_nc = rasterize_tiles_torch(binned, cfg, need_aux=True,
                                              tile_offset=off)
    torch.cuda.synchronize()
    work = raster_work(binned, cfg, nc, off)
    live = work["live_evaluations"]
    relaxed = dataclasses.replace(cfg, strict_termination=False)
    out = dict(shards=d, row_lo=row_lo, rows=rows,
               phantom_rows=row_lo + rows - cfg.tiles_y, tile_offset=off,
               tiles=binned.tile_starts.shape[0],
               pairs=int(binned.num_pairs), **work, modes={})
    err = exact_err("strip rasterize_strict_aux", ("tiles", "nc"),
                    (tiles, nc), (ref_tiles, ref_nc))
    out["modes"]["rasterize_strict_aux"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: rasterize.rasterize_tiles_aux(
            binned, cfg, off), label="strip rasterize_strict_aux"),
        **bound(raster_bytes(binned, cfg, 20), OPS_FWD_LIVE * live))
    for name, c in (("rasterize_strict", cfg), ("rasterize_relaxed",
                                                relaxed)):
        got = rasterize.rasterize_tiles(binned, c, off)
        ref = rasterize_tiles_torch(binned, c, tile_offset=off)
        torch.cuda.synchronize()
        out["modes"][name] = dict(
            max_abs_err=exact_err(f"strip {name}", ("tiles",), (got,),
                                  (ref,)),
            ms=cuda_ms(lambda c=c: rasterize.rasterize_tiles(binned, c, off),
                       label=f"strip {name}"),
            **bound(raster_bytes(binned, cfg, 16), OPS_FWD_LIVE * live))
    gen = torch.Generator(device=tiles.device).manual_seed(SEED + 15)
    args = (binned.features, binned.tile_starts, binned.tile_ends,
            torch.randn(tiles.shape, generator=gen, device=tiles.device),
            1.0 - ref_tiles[..., 3], ref_nc, cfg, off)
    got = rasterize.rasterize_backward(*args)
    ref = rasterize_backward_torch(*args)
    torch.cuda.synchronize()
    out["modes"]["rasterize_bwd"] = dict(
        max_abs_err=bwd_err("strip rasterize_bwd", got, ref),
        ms=cuda_ms(lambda: rasterize.rasterize_backward(*args),
                   label="strip rasterize_bwd"),
        **bound(raster_bytes(binned, cfg, 24, 16), OPS_BWD_LIVE * live))
    for name, m in out["modes"].items():
        m["whole_grid_ms"] = results[name]["ms"]
        m["whole_grid_bound_ms"] = results[name]["bound_ms"]
    return out


def dist_frames(model, cfg, d: int, cap: int, cam_host, angles,
                timer) -> dict:
    """15 (b): the 1M frame on a d-shard mesh on cuda:0, both exchanges,
    each a program captured by a RenderEngine: at every angle the eager
    sharded frame equals the single-device frame (image within TOL_RASTER,
    pairs, tile counts and truncation equal, no overflow of either kind)
    and its replay equals it bit for bit; then the pipelined ms of the
    single-device replay and the sharded replay and eager frame in turns,
    the replays' device ms and the profiler's device ms of all three."""
    import torch
    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    dev = model.device
    mesh = mesh_lib.make_mesh(d, device="cuda:0")

    def dev_args(a):
        c = cam_host(a)
        return (model, c.view.to(dev), c.proj.to(dev), c.env_rot.to(dev))

    def replay(name, a):
        c = cam_host(a)
        return eng.run(name, model, c.view, c.proj, c.env_rot)

    progs = {"single": app_main.splat_program(cfg)}
    progs.update({ex: app_main.sharded_program(cfg, mesh, pair_capacity=cap,
                                               exchange=ex)
                  for ex in distributed.EXCHANGES})
    eng = engine_lib.RenderEngine(RuntimeConfig(device="cuda"))
    for name, fn in progs.items():
        eng.register(name, fn, dev_args(angles[0]))
    facts = dict(shards=d, devices=sorted({str(x) for x in mesh.devices}),
                 device_count=torch.cuda.device_count(),
                 pair_capacity_per_shard=cap,
                 capture_s={k: p.compile_seconds
                            for k, p in eng.programs.items()})
    for ex in distributed.EXCHANGES:
        per_angle = []
        for a in angles:
            with torch.inference_mode():
                eager = progs[ex](*dev_args(a))
                want = progs["single"](*dev_args(a))
            got = replay(ex, a)
            for f, x, y in zip(got._fields, got, eager):
                if not torch.equal(x, y):
                    fail(f"sharded 1M {ex} at {a} deg: the replay's {f} "
                         "differs from the eager sharded frame")
            err = float((eager.image - want.image).abs().max())
            if not (err <= TOL_RASTER
                    and torch.equal(eager.tile_counts, want.tile_counts)
                    and int(eager.count) == int(want.count)
                    and int(eager.truncated) == int(want.truncated)):
                fail(f"sharded 1M {ex} at {a} deg: image {err} or counts "
                     "differ from the single-device frame")
            if int(eager.overflow) or int(eager.exchange_overflow):
                fail(f"sharded 1M {ex} at {a} deg: overflow "
                     f"{int(eager.overflow)}, exchange overflow "
                     f"{int(eager.exchange_overflow)}")
            per_angle.append(dict(angle=a, max_abs_diff=err,
                                  pairs=int(eager.count),
                                  truncated=int(eager.truncated)))
        facts[ex] = per_angle
    n = len(angles)

    def eager_sharded(k):
        with torch.inference_mode():
            return progs["all_to_all"](*dev_args(angles[k % n]))

    turns = [("single_replay", lambda k: replay("single", angles[k % n])),
             ("sharded_replay", lambda k: replay("all_to_all",
                                                 angles[k % n])),
             ("sharded_eager", eager_sharded)]
    times = {name: [] for name, _ in turns}
    for name, step in turns + turns[::-1]:
        times[name].append(float(np.median(pipelined_ms(step,
                                                        ENGINE_FRAMES))))
    facts.update(
        pipelined_ms=times, frames_per_median=ENGINE_FRAMES,
        replay_device_ms={k: timer.ms(lambda k=k: replay(k, angles[0]),
                                      label=f"sharded 1M {k} replay")
                          for k in ("single", "all_to_all")},
        profiler_ms=dict(
            single_replay=profiled_ms(lambda: replay("single", angles[0]),
                                      reps=3),
            sharded_replay=profiled_ms(lambda: replay("all_to_all",
                                                      angles[0]), reps=3),
            sharded_eager=profiled_ms(lambda: eager_sharded(0), reps=3)),
        reserved_mb=torch.cuda.memory_reserved(dev) / 2 ** 20)
    return facts


def dist_train_step(model, cfg, tc, d: int, cap: int, cams, targets,
                    timer) -> dict:
    """15 (c): the sharded train step on a d-shard mesh on cuda:0,
    registered as a train program; the state after register equal to its
    snapshot; STEP_EQ_STEPS replays, each held to the single-device eager
    step from the same state (step_err); the replay's device ms."""
    import torch
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    dev = model.device
    mesh = mesh_lib.make_mesh(d, device="cuda:0")
    state = trainer.init_state(mesh_lib.shard_model(model, mesh).trainable(),
                               tc)
    snapshot = state.to_numpy()
    eng = engine_lib.RenderEngine(RuntimeConfig(device="cuda"))
    prog = trainer.register_step(
        eng, state, cams[0], targets[0], cfg, tc,
        step_fn=distributed.make_sharded_train_step(mesh, cfg, tc,
                                                    pair_capacity=cap))
    for i, (a, b) in enumerate(zip(state.to_numpy(), snapshot)):
        if not np.array_equal(a, b):
            fail(f"sharded train: register left leaf {i} other than its "
                 "snapshot")
    del snapshot
    held, n = [], len(cams)
    for k in range(STEP_EQ_STEPS):
        eager = trainer.TrainState.from_numpy(state.to_numpy(), dev)
        loss = eng.run(trainer.STEP_PROGRAM, state, cams[k % n],
                       targets[k % n])
        _, want = trainer.train_step(eager, cams[k % n], targets[k % n], cfg,
                                     tc)
        held.append(step_err(f"sharded train step {k}", state, eager, loss,
                             want, tc))
        del eager
    return dict(
        shards=d, pair_capacity_per_shard=cap, capture_s=prog.compile_seconds,
        steps_held=len(held), held=held,
        replay_device_ms=timer.ms(lambda: eng.run(
            trainer.STEP_PROGRAM, state, cams[0], targets[0]),
            label="sharded train replay"),
        reserved_mb=torch.cuda.memory_reserved(dev) / 2 ** 20)


def dist_view_batch(model, cfg, tc, cams, targets, timer) -> dict:
    """15 (d): a (view groups, shards) mesh on cuda:0: render_views_sharded
    of DIST_VB_VIEWS views, each within TOL_RASTER of its single-device
    render, no drops; the view-batch step registered as a train program,
    one replay held to the single-device step on the mean of the views'
    losses (step_err); the replay's device ms."""
    import torch
    from gaussian_splat_ipu_tpu_torch.models.gaussians import FIELDS
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
    from gaussian_splat_ipu_tpu_torch.render import pipeline
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.train import losses, trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    dev = model.device
    mesh = mesh_lib.make_mesh_2d(*DIST_VB_MESH, device="cuda:0")
    sm = mesh_lib.shard_model(model, mesh)
    cams = tuple(cams[:DIST_VB_VIEWS])
    tgts = torch.stack(targets[:DIST_VB_VIEWS])
    with torch.inference_mode():
        images, stats = distributed.render_views_sharded(
            sm, cams, cfg, mesh, pair_capacity=cfg.pair_capacity,
            with_stats=True)
        errs = [float((im - pipeline.render(sm, c, cfg).image).abs().max())
                for im, c in zip(images, cams)]
    drops = {k: int(v) for k, v in stats.items()}
    if max(errs) > TOL_RASTER or any(drops.values()):
        fail(f"view batch render: errors {errs}, drops {drops}")
    state = trainer.init_state(sm.trainable(), tc)
    eng = engine_lib.RenderEngine(RuntimeConfig(device="cuda"))
    step = distributed.make_view_batch_train_step(
        mesh, cfg, tc, pair_capacity=cfg.pair_capacity)
    prog = eng.register("view_batch_step", step, (
        state, tuple(trainer.static_copies(c, tgts)[0] for c in cams),
        tgts.clone()), grad=True)
    eager = trainer.TrainState.from_numpy(state.to_numpy(), dev)
    loss, step_drops = eng.run("view_batch_step", state, cams, tgts)
    params = eager.params
    want = torch.mean(torch.stack([
        losses.render_loss(pipeline.render_image(params, c, cfg), t,
                           tc.ssim_weight) for c, t in zip(cams, tgts)]))
    grads = torch.autograd.grad(want, tuple(params.parameters()))
    trainer.apply_param_updates(params, dict(zip(FIELDS, grads)),
                                eager.opt_state, tc)
    eager.step.add_(1)
    held = step_err("view batch step", state, eager, loss, want.detach(), tc)
    if any(step_drops.tolist()):
        fail(f"view batch step dropped rows: {step_drops.tolist()}")
    return dict(
        mesh=list(DIST_VB_MESH), views=len(cams), gaussians=sm.num_gaussians,
        image_max_abs_diff=errs, drops=drops, step_held=held,
        capture_s=prog.compile_seconds,
        replay_device_ms=timer.ms(lambda: eng.run(
            "view_batch_step", state, cams, tgts),
            label="view batch step replay"))


def mh_cfg():
    """The multi-process phase's frame: the app's, strict (a frame that
    does not depend on which kernel mode the process runs)."""
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    return RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                        pair_capacity=1 << 19)


def mh_camera(scene):
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    return Camera.orbit(scene.bb_min, scene.bb_max, float(np.radians(40.0)),
                        WIDTH / HEIGHT, rot_y_deg=30.0, device="cpu")


def mh_child(rank: str, world: str, coord: str, ply: str, out: str) -> int:
    """One process of phase 15 (f): join the gloo group, load this
    process's shard of the PLY, render the frame over the process mesh on
    cuda:0 and save it."""
    import torch
    from gaussian_splat_ipu_tpu_torch.parallel import distributed, multihost
    assert multihost.initialize(coord, int(world), int(rank), device="cuda")
    mesh = multihost.make_process_mesh("cuda")
    scene = multihost.load_scene_sharded(ply, mesh)
    cfg = mh_cfg()
    with torch.inference_mode():
        res = distributed.render_sharded(
            scene.model, mh_camera(scene).to(mesh.device), cfg, mesh,
            pair_capacity=cfg.pair_capacity)
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 image=res.image.cpu().numpy(), num_pairs=int(res.num_pairs),
                 overflow=int(res.overflow),
                 exchange_overflow=int(res.exchange_overflow),
                 rows=scene.model.num_gaussians,
                 backend=torch.distributed.get_backend(),
                 device=str(mesh.device))
    torch.distributed.destroy_process_group()
    return 0


def run_processes(label: str, args_of_rank) -> float:
    """Start MH_PROCESSES copies of this script, process r with
    args_of_rank(r, coord), coord a free local port for the group; wait
    for all, each within MH_TIMEOUT_S (on a time-out every process is
    killed). Fails with a process's stderr if one exits non-zero. Returns
    the wall seconds."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args_of_rank(r, coord)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MH_PROCESSES)]
    try:
        logs = [p.communicate(timeout=MH_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1][-2000:] for p in procs]
        fail(f"{label}: a process outlived {MH_TIMEOUT_S} s: {errs}")
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"{label}: process {r} exited {p.returncode}: "
                 f"{err[-2000:]}")
    return time.perf_counter() - t0


def mh_phase(tmp: str, ply_path: str, dev) -> dict:
    """15 (f): MH_PROCESSES processes sharing cuda:0 over gloo
    (parallel/multihost.py) each load their shard of the app's PLY and
    render the frame; every process's image equals the one-process render
    over a mesh of as many shards on cuda:0, pairs equal, nothing
    dropped."""
    import torch
    from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
    out = tempfile.mkdtemp(dir=tmp, prefix="mh_")
    wall_s = run_processes("multi-process render", lambda r, coord: [
        "--mh-child", str(r), str(MH_PROCESSES), coord, ply_path, out])
    got = [np.load(os.path.join(out, f"rank{r}.npz"))
           for r in range(MH_PROCESSES)]
    cfg = mh_cfg()
    scene = scene_io.load_scene(ply_path, device=dev)
    mesh = mesh_lib.make_mesh(MH_PROCESSES, device="cuda:0")
    with torch.inference_mode():
        want = distributed.render_sharded(
            mesh_lib.shard_model(scene.model, mesh),
            mh_camera(scene).to(dev), cfg, mesh,
            pair_capacity=cfg.pair_capacity)
    image = want.image.cpu().numpy()
    for r, g in enumerate(got):
        if not (np.array_equal(g["image"], image)
                and int(g["num_pairs"]) == int(want.num_pairs)
                and int(g["overflow"]) == int(g["exchange_overflow"]) == 0):
            fail(f"multi-process: process {r}'s frame differs from the "
                 "one-process render (or dropped pairs)")
    return dict(processes=MH_PROCESSES, backend=str(got[0]["backend"]),
                devices=[str(g["device"]) for g in got],
                rows_per_process=[int(g["rows"]) for g in got],
                num_pairs=int(want.num_pairs), image_equal=True,
                lit_pixels=int((image[..., 3] > 0).sum()), wall_s=wall_s)


MH_TRAIN_KEYS = ("losses", "step_ms", "pipelined_ms", "events",
                 "final_loss", "psnr", "step", "num_gaussians",
                 "final_alive", "shards", "processes", "final_overflow",
                 "final_truncated", "target_overflow", "num_pairs")


def mh_train_child(rank: str, world: str, coord: str, out: str,
                   *argv) -> int:
    """One process of phase 15 (f)'s training: app/train.py's run() in a
    group of `world` processes ("{rank}" in an argument becomes the rank),
    its statistics, the group's backend and the kernel launches it made
    saved as JSON."""
    import torch
    from gaussian_splat_ipu_tpu_torch.parallel import multihost
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    import gaussian_splat_ipu_tpu_torch.app.train as app_train
    os.environ.update(GSPLAT_COORDINATOR=coord, GSPLAT_NUM_PROCESSES=world,
                      GSPLAT_PROCESS_ID=rank)
    assert multihost.initialize(device="cuda")
    backend = torch.distributed.get_backend()
    cuda_lib.launches.clear()
    stats = app_train.run([a.replace("{rank}", rank) for a in argv])
    with open(out, "w") as f:
        json.dump(dict({k: stats[k] for k in MH_TRAIN_KEYS},
                       backend=backend, launches=dict(cuda_lib.launches)), f)
    return 0


def mh_train(tmp: str, label: str, argv: list) -> list:
    """The train CLI in MH_PROCESSES processes on cuda:0: each one's
    statistics."""
    outs = [os.path.join(tmp, f"{label}_{r}.json")
            for r in range(MH_PROCESSES)]
    wall_s = run_processes(f"multi-process {label}", lambda r, coord: [
        "--mh-train", str(r), str(MH_PROCESSES), coord, outs[r], *argv])
    got = []
    for path in outs:
        with open(path) as f:
            got.append(dict(json.load(f), wall_s=wall_s))
    return got


def loss_rel_err(got: list, want: list) -> float:
    if len(got) != len(want):
        return float("inf")
    g, w = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(g - w) / np.abs(w)))


def mh_train_phase(tmp: str, ply_path: str, launches: dict,
                   cuda_lib) -> dict:
    """15 (f), training: MH_PROCESSES processes sharing cuda:0 over gloo
    run app/train.py --distributed (one shard each, every program eager)
    in the train app cell's distill mode, with a checkpoint and a PLY,
    then with --densify (events at steps 4 and 8); each held to the
    one-process --distributed MH_PROCESSES run (captured) made here:
    every step's loss within MH_LOSS_RTOL, the events' steps and alive
    counts equal, no pair or exchange row dropped, only the primary's
    checkpoint written, the PLY's row count equal."""
    import gaussian_splat_ipu_tpu_torch.app.train as app_train
    from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
    out = tempfile.mkdtemp(dir=tmp, prefix="mh_train_")
    common = ["--input", ply_path, "--mode", "distill", "--width",
              str(TRAIN_W), "--height", str(TRAIN_H), "--device", "cuda",
              "--seed", str(SEED), "--log-level", "warn"]
    n = str(MH_PROCESSES)
    runs = {
        "distill": common + ["--views", str(TRAIN_VIEWS), "--steps",
                             str(MH_STEPS)],
        "densify": common + [
            "--views", str(MH_DENSIFY_VIEWS), "--steps",
            str(MH_DENSIFY_STEPS), "--densify", "--densify-from",
            str(MH_DENSIFY_VIEWS), "--densify-every", str(MH_DENSIFY_VIEWS),
            "--densify-grad-threshold", str(MH_DENSIFY_THRESHOLD),
            "--capacity", str(MH_CAPACITY_X * APP_GAUSSIANS)]}
    facts = {}
    for name, argv in runs.items():
        files = ["--checkpoint", os.path.join(out, name + "_{rank}.npz"),
                 "--export-ply", os.path.join(out, name + "_mp.ply")]
        got = mh_train(out, name, argv + ["--distributed"] + files)
        one_ck = os.path.join(out, name + "_one.npz")
        one_ply = os.path.join(out, name + "_one.ply")
        want, launches[f"mh train {name} one process"] = counted(
            cuda_lib, lambda: app_train.run(argv + [
                "--distributed", n, "--checkpoint", one_ck, "--export-ply",
                one_ply]))
        errs = [loss_rel_err(g["losses"], want["losses"]) for g in got]
        events = [[(e["step"], e["alive"]) for e in g["events"]]
                  for g in got]
        want_events = [(e["step"], e["alive"]) for e in want["events"]]
        drops = [(e["overflow"], e["exchange_overflow"])
                 for g in got for e in g["events"]]
        shape = [(g["processes"], g["shards"], g["num_gaussians"],
                  g["final_overflow"], max(g["target_overflow"]))
                 for g in got]
        if (max(errs) > MH_LOSS_RTOL
                or any(e != want_events for e in events)
                or any(any(d) for d in drops)
                or any(s != (MH_PROCESSES, MH_PROCESSES,
                             want["num_gaussians"], 0, 0) for s in shape)):
            fail(f"multi-process train {name}: loss rel. err. {errs} (bar "
                 f"{MH_LOSS_RTOL}), events {events} vs {want_events}, drops "
                 f"{drops}, (processes, shards, slots, final and target "
                 f"overflow) {shape}")
        if name == "densify" and not (
                [s for s, _ in want_events] == [MH_DENSIFY_VIEWS,
                                                MH_DENSIFY_STEPS]
                and APP_GAUSSIANS < want_events[0][1] < want_events[1][1]):
            fail(f"multi-process train densify: events {want_events}, "
                 "expected births at steps 4 and 8")
        written = [os.path.exists(os.path.join(out, f"{name}_{r}.npz"))
                   for r in range(MH_PROCESSES)]
        with np.load(os.path.join(out, name + "_0.npz")) as a, \
                np.load(one_ck) as b:
            same_layout = (sorted(a.files) == sorted(b.files) and all(
                a[k].shape == b[k].shape for k in a.files))
            param_err = max(float(np.abs(a[f"leaf_{i}"]
                                         - b[f"leaf_{i}"]).max())
                            for i in range(5))
        rows = [ply_io.count_vertices(p) for p in
                (os.path.join(out, name + "_mp.ply"), one_ply)]
        if written != [True] + [False] * (MH_PROCESSES - 1) \
                or not same_layout or rows[0] != rows[1]:
            fail(f"multi-process train {name}: checkpoints written "
                 f"{written}, layout equal {same_layout}, PLY rows {rows}")
        facts[name] = dict(
            backend=got[0]["backend"], steps=len(want["losses"]),
            loss_max_rel_err=max(errs), loss_rtol=MH_LOSS_RTOL,
            losses=got[0]["losses"], one_process_losses=want["losses"],
            events=[g["events"] for g in got][0],
            one_process_events=want["events"],
            final_loss=[g["final_loss"] for g in got],
            psnr=[g["psnr"] for g in got], one_process_psnr=want["psnr"],
            slots=want["num_gaussians"], final_alive=want["final_alive"],
            checkpoint_param_max_abs_diff=param_err, ply_rows=rows[0],
            median_pipelined_ms_eager=[
                float(np.median(g["pipelined_ms"])) for g in got],
            median_step_ms_eager=[float(np.median(g["step_ms"]))
                                  for g in got],
            one_process_median_pipelined_ms_replayed=float(
                np.median(want["pipelined_ms"])),
            wall_s=got[0]["wall_s"],
            process_launches=[g["launches"] for g in got])
    return facts


def oracle_phase(dev, cuda_lib) -> dict:
    """16: kernels C and D against the dense oracle (render/oracle.py) on
    ORACLE_GAUSSIANS seeded gaussians at ORACLE_W x ORACLE_H on the card,
    footprints at the full alpha_min radius:
    the strict frame (C) and the strict frame with contributor counts
    (C-aux) within ORACLE_TOL of the oracle's image; D's model gradients
    of a seeded pixel-weighted sum, through the tiled render under
    autograd, within ORACLE_GRAD_TOL of autograd through the oracle on a
    black background; the frame rendered over DIST_SHARDS shards of
    cuda:0 (C at each strip's tile offset) within ORACLE_TOL of the
    oracle. At a white background the gradient error is reported only
    (the reference's backward kernel exceeds the bar against its spec on
    dense scenes with a nonzero background)."""
    import dataclasses as dc

    import torch
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import (
        FIELDS, GaussianModel)
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
    from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
    from gaussian_splat_ipu_tpu_torch.render.kernels import rasterize
    from gaussian_splat_ipu_tpu_torch.render.oracle import render_oracle
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

    def excess(got, ref, tol) -> tuple:
        """(max |got - ref|, max of |got - ref| / (atol + rtol |ref|))."""
        d = (got - ref).abs()
        return (float(d.max()),
                float((d / (tol["atol"] + tol["rtol"] * ref.abs())).max()))

    cfg = RasterConfig(image_width=ORACLE_W, image_height=ORACLE_H,
                       pair_capacity=1 << 16, extent_sigma=0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = GaussianModel.random(ORACLE_GAUSSIANS, generator=gen, device=dev)
    weights = torch.randn((ORACLE_H, ORACLE_W, 4), generator=gen,
                          device=dev)
    bb = np.ones(3, np.float32)
    cam = Camera.orbit(-bb, bb, float(np.radians(40.0)),
                       ORACLE_W / ORACLE_H, rot_y_deg=30.0, device=dev)
    facts = {}
    cuda_lib.launches.clear()
    with torch.inference_mode():
        ref = render_oracle(model, cam, cfg)
        out = pipeline.render(model, cam, cfg)
        binned = binning.bin_splats(project_gaussians(model, cam, cfg), cfg)
        aux = pipeline._untile_crop(
            rasterize.rasterize_tiles_aux(binned, cfg)[0], cfg)
        mesh = mesh_lib.make_mesh(DIST_SHARDS, device="cuda:0")
        shard = distributed.render_sharded(mesh_lib.shard_model(model, mesh),
                                           cam, cfg, mesh)
    for name, img in (("rasterize_strict", out.image),
                      ("rasterize_strict_aux", aux),
                      ("sharded_strict", shard.image)):
        err, ratio = excess(img, ref, ORACLE_TOL)
        facts[name] = dict(max_abs_err=err, max_err_over_bar=ratio)
        if ratio > 1.0:
            fail(f"oracle: {name} differs from the oracle by {err} "
                 f"({ratio}x the bar {ORACLE_TOL})")
    if int(out.overflow) or int(out.truncated) or int(shard.overflow) \
            or int(shard.exchange_overflow):
        fail("oracle: the tiled render dropped pairs")

    def grads(render_fn, c):
        m = model.trainable()
        loss = torch.sum(render_fn(m, cam, c) * weights)
        return dict(zip(FIELDS, torch.autograd.grad(
            loss, tuple(m.parameters()))))

    for bg in ("black", "white"):
        c = dc.replace(cfg, background=(1.0,) * 3 if bg == "white"
                       else (0.0,) * 3)
        got = grads(lambda m, cm, f: pipeline.render(m, cm, f).image, c)
        want = grads(render_oracle, c)
        per = {k: excess(got[k], want[k], ORACLE_GRAD_TOL) for k in FIELDS}
        facts[f"rasterize_bwd_{bg}"] = dict(
            max_abs_err={k: v[0] for k, v in per.items()},
            max_err_over_bar=max(v[1] for v in per.values()))
        if bg == "black" and max(v[1] for v in per.values()) > 1.0:
            fail(f"oracle: D's model gradients differ from autograd "
                 f"through the oracle beyond {ORACLE_GRAD_TOL}: {per}")
    return dict(gaussians=ORACLE_GAUSSIANS, width=ORACLE_W,
                height=ORACLE_H, num_pairs=int(out.num_pairs),
                shards=DIST_SHARDS, tol=ORACLE_TOL,
                grad_tol=ORACLE_GRAD_TOL, **facts,
                launches=dict(cuda_lib.launches))


def trace_phase(tmp: str, app_scene, cfg, cam_of, cuda_lib) -> dict:
    """17: TRACE_FRAMES app frames (exact tiles, so kernels A, B and C
    run), replayed from the splat program captured in a RenderEngine,
    under utils/profiling.trace(), each inside a Tracepoint: the Chrome
    trace must name kernels A, B and C and the Tracepoint's range."""
    import torch
    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.utils import profiling
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    eng = engine_lib.RenderEngine(RuntimeConfig(device="cuda"))
    dev = app_scene.model.device
    c0 = cam_of(0.0)       # on the host: the engine copies each one in
    eng.register("render", app_main.splat_program(cfg), (
        app_scene.model, c0.view.to(dev), c0.proj.to(dev),
        c0.env_rot.to(dev)))
    log_dir = os.path.join(tmp, "trace")
    with profiling.trace(log_dir) as prof:
        for k in range(TRACE_FRAMES):
            c = cam_of(360.0 * k / TRACE_FRAMES)
            with profiling.Tracepoint("app_frame"):
                eng.run("render", app_scene.model, c.view, c.proj,
                        c.env_rot)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    want = {"coverage_masks": "coverage_masks_kernel",
            "stream_expand": "stream_expand_kernel",
            "rasterize": "rasterize_fwd_kernel"}
    found = {k: sorted(n for n in kernels if v in n)
             for k, v in want.items()}
    ranges = sum(1 for e in events if e.get("name") == "app_frame")
    if not all(found.values()) or ranges < TRACE_FRAMES:
        fail(f"trace: kernels {found} or {ranges} app_frame ranges in "
             f"{path} (kernels seen: {sorted(kernels)[:20]})")
    device_us = {k.key: float(getattr(k, "self_device_time_total", 0.0)
                              or 0.0)
                 for k in prof.key_averages()
                 if any(v in k.key for v in want.values())}
    return dict(frames=TRACE_FRAMES, trace_bytes=os.path.getsize(path),
                kernels=found, app_frame_ranges=ranges,
                kernel_device_us=device_us, capture_s=eng.programs[
                    "render"].compile_seconds)


def host_ms(fn, reps: int = NATIVE_REPS) -> float:
    """Median host ms of fn() over `reps` calls: the host library runs on
    the card machine's CPU, not on the card."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


@contextlib.contextmanager
def without_native(native):
    """The host library's unbuilt state for the calls inside: each of its
    functions returns None and its callers take their numpy or PIL
    path."""
    lib = native._lib
    native._lib = None
    try:
        yield
    finally:
        native._lib = lib


def native_build(native) -> dict:
    """18 (a): build the host library with g++ on the card's host and load
    it."""
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60)
    t0 = time.perf_counter()
    try:
        path = native.build()
    except RuntimeError as e:
        fail(f"native build: {e}")
    build_s = time.perf_counter() - t0
    if not native.available():
        fail("native build: the library does not load")
    return dict(gxx=(gxx.stdout.splitlines() or [gxx.stderr])[0].strip(),
                build_s=build_s, library=os.path.relpath(path),
                flags=" ".join(native.CXX_FLAGS + native.LIBS))


def native_functions(tmp: str, model_1m, frame, native) -> dict:
    """18 (b): each function of the library against its plain version at
    the sizes the system gives it: stack_f32_columns on the 2^20-row PLY
    of phase 4's scene (14 columns) and center_flip on its means, both
    equal; to_uint8 on a 1280x720 RGB frame of phase 3's scene within 1
    count. Host ms with and without the library, each the median of
    NATIVE_REPS calls."""
    from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
    from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
    from gaussian_splat_ipu_tpu_torch.models.gaussians import (
        center_and_flip)
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    path = os.path.join(tmp, "scene_1m.ply")
    scene_io.write_ply(path, model_1m)
    rec = ply_io.read_ply(path)["vertex"].data
    names = list(rec.dtype.names)

    def plain_stack():           # io/ply.py's numpy path
        return np.stack([np.asarray(rec[n]).astype(np.float32)
                         for n in names], -1)

    cols = native.stack_f32_columns(rec, names)
    if len(names) != 14 or cols is None or not np.array_equal(
            cols, plain_stack()):
        fail(f"stack_f32_columns: {len(names)} columns, not equal to the "
             "numpy stack")
    facts = dict(stack_f32_columns=dict(
        rows=int(cols.shape[0]), columns=len(names), equal=True,
        host_ms=host_ms(lambda: native.stack_f32_columns(rec, names)),
        host_ms_without=host_ms(plain_stack)))

    means = np.ascontiguousarray(cols[:, :3])
    want = center_and_flip(means)
    bufs = [means.copy() for _ in range(NATIVE_REPS + 1)]
    bb = native.center_flip(bufs[0])
    if bb is None or not (np.array_equal(bufs[0], want) and np.array_equal(
            bb, np.stack([means.min(0), means.max(0)]))):
        fail("center_flip: not equal to the numpy centre and flip")
    left = iter(bufs[1:])
    facts["center_flip"] = dict(
        shape=list(means.shape), equal=True,
        host_ms=host_ms(lambda: native.center_flip(next(left))),
        host_ms_without=host_ms(lambda: center_and_flip(means)))

    for exposure, gamma in ((1.0, 1.0), (1.0, 2.2)):
        got = native.to_uint8(frame, exposure, gamma)
        with without_native(native):
            want = image_util.to_uint8(frame, exposure, gamma)
            plain = host_ms(lambda: image_util.to_uint8(frame, exposure,
                                                        gamma))
        diff = int(np.abs(got.astype(np.int32) - want).max())
        if got.shape != want.shape or diff > 1:
            fail(f"to_uint8 (gamma {gamma}): {diff} counts from the numpy "
                 "tone map")
        facts[f"to_uint8_gamma_{gamma}"] = dict(
            shape=list(frame.shape), max_count_diff=diff,
            counts_off=int((got != want).sum()),
            host_ms=host_ms(lambda: native.to_uint8(frame, exposure,
                                                    gamma)),
            host_ms_without=plain)
    return facts


def native_decode(ds: dict, dev, native, cuda_lib):
    """18 (c): phase 13's capture through load_colmap with the library at
    downscale 1 and 2, every image equal to decode_png_torch (at 1: PIL's
    bytes times f32(1/255)), against the load without it (PIL); then
    app/train.py --dataset --downscale 2 for NATIVE_TRAIN_STEPS steps on
    the prefetched targets (every image fetched through ImagePrefetcher),
    exact tiles, DS_PAIR_SLACK x the probed demand: no drop on any view and
    finite losses. Returns (facts, the train run's launches)."""
    import torch
    import gaussian_splat_ipu_tpu_torch.app.train as app_train
    from gaussian_splat_ipu_tpu_torch.io import colmap, dataset
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    root = ds["capture_root"]
    img_dir = os.path.join(root, "images")
    paths = [os.path.join(img_dir, n) for n in sorted(os.listdir(img_dir))]
    facts = {}
    for d in (1, 2):
        def load(with_lib: bool):
            t0 = time.perf_counter()
            with (contextlib.nullcontext() if with_lib
                  else without_native(native)):
                fs = colmap.load_colmap(root, downscale=d, device=dev)[0]
            return fs, time.perf_counter() - t0

        # In turns: without, with, with, without.
        pil_fs, s0 = load(False)
        lib_fs, s1 = load(True)
        _, s2 = load(True)
        _, s3 = load(False)
        if len(lib_fs) != DS_VIEWS or len(paths) != DS_VIEWS:
            fail(f"decode: {len(lib_fs)} views loaded of {len(paths)}")
        for p, img in zip(paths, lib_fs.images):
            want = dataset._expand_channels(native.decode_png_torch(p, d)[0])
            if img.shape != want.shape or not np.array_equal(img, want):
                fail(f"decode at downscale {d}: {p} is not decode_png_torch's "
                     "bit for bit")
        facts[f"downscale_{d}"] = dict(
            size=[lib_fs.width, lib_fs.height], views=len(lib_fs),
            equal_to_decode_png_torch=True,
            max_abs_diff_from_pil_state=max(
                float(np.abs(a - b).max())
                for a, b in zip(lib_fs.images, pil_fs.images)),
            load_s=[s1, s2], load_s_without=[s0, s3])

    fs2, xyz, rgb = colmap.load_colmap(root, downscale=2, device=dev)
    init = GaussianModel.from_points(xyz, rgb, sh_degree=3, device=dev)
    cfg2 = RasterConfig(image_width=fs2.width, image_height=fs2.height,
                        pair_capacity=1 << 21, exact_tile_test=True)
    with torch.inference_mode():
        demand = max(int(b.num_pairs + b.overflow) for b in (
            binning.bin_splats(project_gaussians(init, c, cfg2), cfg2)
            for c in fs2.cameras))
    c = cfg2.chunk_size
    cap = -(-int(DS_PAIR_SLACK * demand) // c) * c
    del fs2, init
    fetched = []
    fetch = native.ImagePrefetcher.fetch

    def counting_fetch(pf, job):
        got = fetch(pf, job)
        fetched.append(got is not None)
        return got

    native.ImagePrefetcher.fetch = counting_fetch
    try:
        st, launches = counted(cuda_lib, lambda: app_train.run([
            "--dataset", root, "--downscale", "2", "--holdout-every",
            str(DS_HOLDOUT), "--exact-tiles", "--pair-capacity", str(cap),
            "--steps", str(NATIVE_TRAIN_STEPS), "--device", "cuda",
            "--log-level", "warn"]))
    finally:
        native.ImagePrefetcher.fetch = fetch
    if len(fetched) < DS_VIEWS or not all(fetched):
        fail(f"train --downscale 2: {sum(fetched)} of {len(fetched)} "
             f"images came through the prefetcher, expected {DS_VIEWS}")
    drops = (st["target_overflow"] + st["target_truncated"]
             + st["holdout_overflow"] + [st["final_overflow"],
                                         st["final_truncated"]])
    if any(drops) or not np.isfinite(st["losses"]).all() or len(
            st["losses"]) != NATIVE_TRAIN_STEPS:
        fail(f"train --downscale 2: drops {drops}, losses {st['losses']}")
    facts["train"] = dict(
        downscale=2, steps=NATIVE_TRAIN_STEPS, prefetched=len(fetched),
        views=st["views"], probed_demand=demand, pair_capacity=cap,
        losses=st["losses"], holdout_psnr=st["eval_psnr"],
        median_step_ms=float(np.median(st["step_ms"])),
        target_overflow=max(st["target_overflow"]),
        final_overflow=st["final_overflow"])
    return facts, launches


def scene_tool_phase(tmp: str, ply_path: str, dev, fov: float,
                     capacity, cuda_lib):
    """18 (d): app/scene_tool.py on phase 13's exported PLY (prune,
    --max-sh 0, --center-flip, --stats, both outputs): the --stats line's
    count equal to the survivors, both outputs rendered by app/main.py
    with overflow 0. Then the app scene loaded raw at full width with
    strict C, and its center_flip'ped copy through the mirrored camera V @
    [[F, c], [0, 1]] (tests/test_scene_tool.py:98-130): within MIRROR_TOL
    but for at most MIRROR_SHARE of the values (splats whose alpha rounds
    across alpha_min, or a pixel across strict termination, in one of the
    two frames), each within MIRROR_CUTOFF_X alpha_min; the same copy with
    its quats left unmirrored shown far past that. Returns (facts, the
    launches of the tool's renders)."""
    import io

    import torch
    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    from gaussian_splat_ipu_tpu_torch.app import scene_tool
    from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
    from gaussian_splat_ipu_tpu_torch.io import splat as splat_io
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.train import checkpoint
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    src = os.path.join(tmp, "ds.ply")             # phase 13's export
    raw = checkpoint.import_ply(src, device="cpu")
    opac = 1.0 / (1.0 + np.exp(-raw.opacities.numpy()))
    survivors = int((opac >= TOOL_PRUNE_OPACITY).sum())
    out_ply = os.path.join(tmp, "tool.ply")
    out_splat = os.path.join(tmp, "tool.splat")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = scene_tool.main([
            "--input", src, "--prune-opacity", str(TOOL_PRUNE_OPACITY),
            "--max-sh", "0", "--center-flip", "--stats", "--output",
            out_ply, "--output-splat", out_splat, "--log-level", "warn"])
    tool_s = time.perf_counter() - t0
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    if (rc or stats["gaussians"] != survivors or stats["sh_degree"] != 0
            or splat_io.count_records(out_splat) != survivors):
        fail(f"scene tool: rc {rc}, stats {stats}, {survivors} survivors of "
             f"{raw.num_gaussians}")

    def render(label: str, path: str) -> dict:
        png = os.path.join(tmp, f"tool_{label}.png")
        r = app_main.run(["--input", path, "--width", str(WIDTH),
                          "--height", str(HEIGHT), "--frames", "2",
                          "--pair-capacity", "0", "--device", "cuda",
                          "--output", png, "--log-level", "warn"])
        img = image_util.decode_png(open(png, "rb").read())
        lit = int((img[..., 3] > 0).sum())
        if r["overflow"] or r["truncated"] or lit == 0:
            fail(f"the app's render of the scene tool's {label}: overflow "
                 f"{r['overflow']}, truncated {r['truncated']}, {lit} lit "
                 "pixels")
        return dict(num_pairs=r["num_pairs"],
                    pair_capacity=r["pair_capacity"],
                    overflow=r["overflow"], lit_pixels=lit)

    renders, launches = counted(cuda_lib, lambda: {
        "ply": render("ply", out_ply), "splat": render("splat", out_splat)})

    scene = scene_io.load_scene(ply_path, center=False, flip_z=False,
                                device=dev)
    cam = Camera.orbit(scene.bb_min, scene.bb_max, fov, WIDTH / HEIGHT,
                       rot_y_deg=30.0, device=dev)
    cfg = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                       pair_capacity=1 << 22)
    with torch.inference_mode():
        b = binning.bin_splats(project_gaussians(scene.model, cam, cfg), cfg)
        demand = int(b.num_pairs + b.overflow)
        cfg = dataclasses.replace(cfg, pair_capacity=capacity(
            demand, cfg.chunk_size))
        ref = pipeline.render(scene.model, cam, cfg)
        mirrored, _ = scene_tool.process(scene.model, center_flip=True)
        means = scene.model.means.cpu().numpy()
        minv = np.eye(4, dtype=np.float32)
        minv[:3, :3] = np.diag([1.0, 1.0, -1.0])
        minv[:3, 3] = (means.min(0) + means.max(0)) * 0.5
        cam2 = Camera(torch.tensor(cam.view.cpu().numpy() @ minv,
                                   device=dev), cam.proj, cam.env_rot)
        got = pipeline.render(mirrored, cam2, cfg)
        p = mirrored.to_numpy()
        p["quats"] = scene.model.quats.cpu().numpy()
        wrong = pipeline.render(GaussianModel.from_numpy(p, dev), cam2, cfg)

    def diff(out) -> dict:
        d = (out.image - ref.image).abs()
        over = d > MIRROR_TOL
        return dict(max_abs_err=float(d.max()), values_over_tol=int(
            over.sum()), share_over_tol=float(over.float().mean()),
            pixels_over_tol=int(over.any(-1).sum()),
            overflow=int(out.overflow))

    mirror, unmirrored = diff(got), diff(wrong)
    cutoff = MIRROR_CUTOFF_X * cfg.alpha_min
    if (mirror["overflow"] or int(ref.overflow)
            or mirror["share_over_tol"] > MIRROR_SHARE
            or mirror["max_abs_err"] > cutoff
            or unmirrored["share_over_tol"] <= MIRROR_SHARE):
        fail(f"mirrored render: {mirror} (tol {MIRROR_TOL} but for a share "
             f"of {MIRROR_SHARE}, each within {cutoff}); quats unmirrored: "
             f"{unmirrored}")
    return dict(
        input=os.path.basename(src), input_gaussians=raw.num_gaussians,
        prune_opacity=TOOL_PRUNE_OPACITY, stats=stats, tool_s=tool_s,
        renders=renders, mirror=dict(
            gaussians=scene.num_gaussians, width=WIDTH, height=HEIGHT,
            strict=True, demand=demand, pair_capacity=cfg.pair_capacity,
            pairs=int(ref.num_pairs), tol=MIRROR_TOL,
            share_allowed=MIRROR_SHARE, cutoff_bound=cutoff, **mirror,
            quats_unmirrored=unmirrored)), launches


def clustered_phase(cfg_1m, cam, capacity, cuda_ms, cuda_lib):
    """18 (e): GaussianModel.clustered(2^20, seed SEED) at the 1M config
    (tile_group=3, exact tiles, strict) with 1.15x the probed demand of the
    angle-0 frame (bench.py:261-275): one frame with overflow 0; then C
    strict on its table against the plain version (TOL_RASTER), its device
    time (DeviceTimer), the plain version's (its one call) and its bound
    from the live evaluations. Returns (facts, the frame's launches)."""
    import torch
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
    from gaussian_splat_ipu_tpu_torch.render.kernels import rasterize
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
        rasterize_tiles_torch)
    dev = cam.view.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = GaussianModel.clustered(N_1M, generator=gen, device=dev)
    cfg = dataclasses.replace(cfg_1m, pair_capacity=1 << 22)
    with torch.inference_mode():
        b = binning.bin_splats(project_gaussians(model, cam, cfg), cfg)
        demand = int(b.num_pairs + b.overflow)
        del b
        cfg = dataclasses.replace(cfg, pair_capacity=capacity(
            demand, cfg.chunk_size))
        out, launches = counted(cuda_lib, lambda: pipeline.render(
            model, cam, cfg))
        if int(out.overflow) or not bool(torch.isfinite(out.image).all()):
            fail(f"clustered 1M frame: overflow {int(out.overflow)} or "
                 "non-finite pixels")
        binned = binning.bin_splats(project_gaussians(model, cam, cfg), cfg)
        got = rasterize.rasterize_tiles(binned, cfg)
        # The plain version walks every tile to the longest range (over
        # 100k pairs in one tile here, seconds a call): its one comparison
        # call is its timing, host time included as in every plain timing.
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = rasterize_tiles_torch(binned, cfg)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err = float((got - ref).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= TOL_RASTER):
            fail(f"clustered 1M: C strict {err} from the plain version "
                 f"(tolerance {TOL_RASTER})")
        work = raster_work(binned, cfg,
                           rasterize.rasterize_tiles_aux(binned, cfg)[1])
        ms = cuda_ms(lambda: rasterize.rasterize_tiles(binned, cfg),
                     label="rasterize_strict clustered 1M")
        counts = binned.tile_ends - binned.tile_starts
    b = bound(raster_bytes(binned, cfg, 16),
              OPS_FWD_LIVE * work["live_evaluations"])
    return dict(
        gaussians=N_1M, clusters=64, tile_group=cfg.tile_group,
        exact_tile_test=True, strict=True, demand=demand,
        pair_capacity=cfg.pair_capacity, pairs=int(out.num_pairs),
        overflow=int(out.overflow), truncated=int(out.truncated),
        tiles=int(binned.tile_starts.shape[0]),
        range_pairs_max=int(counts.max()),
        range_pairs_median=float(counts.float().median()),
        max_abs_err=err, ms=ms, plain_ms=plain_ms, share=b["bound_ms"] / ms,
        **b, **work), launches


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--mh-train"]:
        faulthandler.dump_traceback_later(MH_TIMEOUT_S, exit=True)
        return mh_train_child(*sys.argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", metavar="DIR",
                    help="a directory holding the parent commit's scan.cu "
                    "(one CTA per row): phase 2 times it in turns with the "
                    "row scan")
    ap.add_argument("--mh-child", nargs=5, metavar=("RANK", "WORLD", "COORD",
                                                    "PLY", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mh_child:
        faulthandler.dump_traceback_later(MH_TIMEOUT_S, exit=True)
        return mh_child(*args.mh_child)
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "one CUDA GPU")

    from gaussian_splat_ipu_tpu_torch.io import native
    from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import (
        FIELDS, GaussianModel)
    from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
    from gaussian_splat_ipu_tpu_torch.render import points as points_render
    from gaussian_splat_ipu_tpu_torch.render.kernels import (
        coverage, cuda_lib, expand, rasterize, scan)
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
        rasterize_backward_torch, rasterize_tiles_torch)
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util
    from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
    from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                          RuntimeConfig)
    import gaussian_splat_ipu_tpu_torch.app.main as app_main
    import gaussian_splat_ipu_tpu_torch.app.train as app_train
    from gaussian_splat_ipu_tpu_torch.utils import profiling

    # Each phase is one Tracepoint: the next phase's start closes it.
    phases = contextlib.ExitStack()

    def phase(name: str):
        phases.close()
        phases.enter_context(profiling.Tracepoint(name))

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = DeviceTimer()
    cuda_ms = timer.ms

    # -- 1. environment -----------------------------------------------------
    phase("1. environment")
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
    old_scan = None
    if args.old:
        old_scan, log = build_lib(
            [os.path.join(args.old, "scan.cu")],
            tempfile.mkdtemp(prefix="gsplat_old_"),
            {"gsplat_row_cumsum_exclusive": OLD_SCAN_SIGNATURE})
        say("old_build", source=os.path.join(args.old, "scan.cu"),
            ptxas=ptxas_lines(log, "row_scan"))

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
        phase("2. kernels")
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
            ms=cuda_ms(lambda: coverage.coverage_masks(geomf, geomi, **kw),
                       label="coverage_masks"),
            plain_ms=cuda_ms(lambda: coverage.coverage_masks_torch(
                geomf, geomi, **kw), label="coverage_masks plain",
                enforce=False),
            **bound(nbytes(geomf, geomi, *got), OPS_COVERAGE_CELL * int(
                torch.where(geomi[4] != 0, geomi[2] * geomi[3], 0).sum())))
        # The event timer against torch.profiler's kernel duration.
        prof_ms = profiled_ms(lambda: coverage.coverage_masks(geomf, geomi,
                                                              **kw))
        say("coverage_profiler", event_ms=results["coverage_masks"]["ms"],
            profiler_ms=prof_ms,
            event_over_profiler=results["coverage_masks"]["ms"] / prof_ms)

        packed, offs = binning.pack_gaussians(splats_1m, cfg_1m)
        p = cfg_1m.pair_capacity
        got = expand.stream_expand(packed, offs, p)
        ref = expand.stream_expand_torch(packed, offs, p)
        torch.cuda.synchronize()
        results["stream_expand"] = result(
            "stream_expand",
            max_abs_err=exact_err("stream_expand", ("cols", "gid", "rank"),
                                  got, ref),
            ms=cuda_ms(lambda: expand.stream_expand(packed, offs, p),
                       label="stream_expand"),
            plain_ms=cuda_ms(lambda: expand.stream_expand_torch(
                packed, offs, p), label="stream_expand plain",
                enforce=False),
            **bound(nbytes(packed, offs, *got), 0))

        # The three kernels of the rowseg and gather paths: the row scan
        # and the segmented expansion at the rowseg 1M config's angle-0
        # frame, expand_pairs on the 1M g=3 table through the gather
        # expansion (expand_kernel=False).
        splats_rs = project_gaussians(model_1m, cam_1m(0.0), cfg_rs)
        lay = binning.rowseg_layout(binning.footprints(splats_rs, cfg_rs),
                                    cfg_rs)
        counts = lay.counts
        got = scan.row_cumsum_exclusive(counts)
        ref = scan.row_cumsum_exclusive_torch(counts)
        torch.cuda.synchronize()
        err = exact_err("row_cumsum_exclusive", ("excl",), (got,), (ref,))

        def e_new():
            return cuda_ms(lambda: scan.row_cumsum_exclusive(counts),
                           label="row_cumsum_exclusive")

        if old_scan is None:
            e_ms = [e_new()]
        else:
            # The parent's one-CTA-per-row kernel, in turns with the new
            # one: old, new, new, old.
            def e_old():
                out = torch.empty_like(counts)
                cuda_lib.check("old row_cumsum_exclusive",
                               old_scan.gsplat_row_cumsum_exclusive(
                                   counts.data_ptr(), *counts.shape,
                                   out.data_ptr(),
                                   cuda_lib.stream_handle(dev)))
                return out

            exact_err("old row_cumsum_exclusive", ("excl",), (e_old(),),
                      (ref,))
            old_ms = [cuda_ms(e_old, label="old row_cumsum_exclusive")]
            e_ms = [e_new(), e_new()]
            old_ms.append(cuda_ms(e_old, label="old row_cumsum_exclusive"))
        words = cuda_lib.library().gsplat_row_cumsum_scratch_words(
            *counts.shape)
        say("row_scan", design="single-pass scan, decoupled look-back "
            "(one warp, 32 predecessors a step), tile ticket by atomicAdd",
            shape=list(counts.shape), ctas=words - 1,
            tiles_per_row=(words - 1) // counts.shape[0], ms=e_ms,
            old_one_cta_per_row_ms=old_ms if old_scan is not None
            else "not measured (no --old)",
            profiler_ms=profiled_ms(
                lambda: scan.row_cumsum_exclusive(counts)))
        results["row_cumsum_exclusive"] = result(
            "row_cumsum_exclusive", max_abs_err=err,
            ms=float(np.median(e_ms)),
            plain_ms=cuda_ms(lambda: scan.row_cumsum_exclusive_torch(counts),
                             label="row_cumsum_exclusive plain",
                             enforce=False),
            library_ms=cuda_ms(lambda: torch.cumsum(counts, dim=1),
                               label="row_cumsum_exclusive library"),
            library_call="torch.cumsum(x, dim=1) (inclusive scan)",
            **bound(nbytes(counts, got), counts.numel()))
        seg_args = (binning.pack_gaussians(splats_rs, cfg_rs)[0], lay.offs,
                    lay.offs2, lay.live_end, lay.cap)
        got = expand.stream_expand_seg(*seg_args)
        ref = expand.stream_expand_seg_torch(*seg_args)
        torch.cuda.synchronize()
        results["stream_expand_seg"] = result(
            "stream_expand_seg",
            max_abs_err=exact_err("stream_expand_seg", ("cols", "gid",
                                                        "rank"), got, ref),
            ms=cuda_ms(lambda: expand.stream_expand_seg(*seg_args),
                       label="stream_expand_seg"),
            plain_ms=cuda_ms(lambda: expand.stream_expand_seg_torch(
                *seg_args), label="stream_expand_seg plain", enforce=False),
            **bound(nbytes(*seg_args[:4], *got), 0))
        gid_pre, _ = binning.gather_slots(offs, p)
        gid_long = gid_pre.long()
        got = expand.expand_pairs(packed, gid_pre)
        ref = expand.expand_pairs_torch(packed, gid_pre)
        torch.cuda.synchronize()
        results["expand_pairs"] = result(
            "expand_pairs",
            max_abs_err=exact_err("expand_pairs", ("cols",), (got,), (ref,)),
            ms=cuda_ms(lambda: expand.expand_pairs(packed, gid_pre),
                       label="expand_pairs"),
            plain_ms=cuda_ms(lambda: expand.expand_pairs_torch(
                packed, gid_pre), label="expand_pairs plain", enforce=False),
            library_ms=cuda_ms(lambda: packed.index_select(0, gid_long),
                               label="expand_pairs library"),
            library_call="packed.index_select(0, gid) (no transpose)",
            **bound(nbytes(packed, gid_pre, got), 0))
        del splats_rs, seg_args, got, ref, gid_long

        cfg_app = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                               pair_capacity=1 << 19,
                               strict_termination=False)
        cam_app = Camera.orbit(app_scene.bb_min, app_scene.bb_max, fov,
                               aspect, device=dev)
        # Kernel G at the capture's width (2^20 gaussians at SH 3) and on
        # the app scene (37,941 at SH 0).
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model_sh3 = GaussianModel.random(N_1M, generator=gen, device=dev,
                                         sh_degree=3)
        g_rows = [project_row("2^20 SH 3", model_sh3, cam_1m(0.0), cfg_1m,
                              cuda_ms),
                  project_row("37.9k SH 0", app_scene.model, cam_app,
                              cfg_app, cuda_ms)]
        bwd_rows = [project_bwd_row("2^20 SH 3", model_sh3, cam_1m(0.0),
                                    cfg_1m, cuda_ms),
                    project_bwd_row("37.9k SH 0", app_scene.model, cam_app,
                                    cfg_app, cuda_ms)]
        # G-bwd with the view's gradient (pose refinement).
        view_row = project_bwd_view_row("2^20 SH 3", model_sh3, cam_1m(0.0),
                                        cfg_1m, cuda_ms)
        del model_sh3
        for row in g_rows:
            say("project_gaussians", **row,
                share=row["bound_ms"] / row["ms"])
        results["project_gaussians"] = result(
            "project_gaussians", max_abs_err=max(
                v for row in g_rows for k, v in row.items()
                if k.endswith("_max_abs_err")),
            **{k: g_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "bytes", "operations",
                                         "radius_differ")})
        for row in bwd_rows:
            say("project_gaussians_bwd", **row,
                share=row["bound_ms"] / row["ms"])
        results["project_gaussians_bwd"] = result(
            "project_gaussians_bwd", max_ratio=max(
                v for row in bwd_rows for k, v in row.items()
                if k.endswith("_ratio")),
            **{k: bwd_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "bytes",
                                           "operations")})
        say("project_gaussians_bwd_view", **view_row,
            share=view_row["bound_ms"] / view_row["ms"])
        results["project_gaussians_bwd_view"] = result(
            "project_gaussians_bwd_view", **{k: view_row[k] for k in (
                "view_ratio", "ms", "camera_free_ms", "plain_ms", "bound_ms",
                "bound_by", "bytes", "operations")})
        # Kernel H at the capture's width, in the densify cell's 2^21
        # slots, and on the app scene.
        h_rows = [adam_row(label, n, degree, cuda_ms) for label, n, degree
                  in (("2^20 SH 3", N_1M, 3), ("2^21 slots SH 3", 2 * N_1M,
                                                3),
                      ("37.9k SH 0", APP_GAUSSIANS, 0))]
        for row in h_rows:
            say("adam", **row, share=row["bound_ms"] / row["ms"])
        results["adam"] = result("adam", max_abs_err=0.0, **{
            k: h_rows[0][k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "bytes",
                                      "operations")})
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
                ms=cuda_ms(lambda: rasterize.rasterize_tiles(binned, cfg),
                           label=name),
                plain_ms=cuda_ms(lambda: rasterize_tiles_torch(binned, cfg),
                                 reps=3 if name.endswith("strict") else 5,
                                 label=f"{name} plain", enforce=False),
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
            chk = check_aux_and_bwd(binned, cfg, SEED + 5, reps, cuda_ms)
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
        # The timer's spin check over every timing of this phase.
        say("timer", **timer.summary())

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
    phase("3. the app")
    launches = {}
    out_png = os.path.join(tmp, "app.png")
    probe_cache = os.path.join(tmp, "probe_cache")
    captured = engine_lib.WARMUP_CALLS + 1   # launches of a captured kernel
    t0 = time.perf_counter()
    stats, launches["app"] = counted(cuda_lib, lambda: app_main.run([
        "--input", ply_path, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--frames", "8", "--pair-capacity", "0", "--device", "cuda",
        "--compile-cache", probe_cache, "--output", out_png,
        "--log-level", "warn"]))
    app_s = time.perf_counter() - t0
    img = image_util.decode_png(open(out_png, "rb").read())
    if img.shape != (HEIGHT, WIDTH, 4) or img[..., :3].max() == 0:
        fail(f"app PNG is blank or misshapen: {img.shape}")
    # The demand probe runs B eagerly; the frames replay the graph.
    need_launches("app run", launches["app"], ("stream_expand",), captured)
    need_exact("app run", launches["app"], ("rasterize_relaxed",), captured)
    if stats["overflow"] or stats["truncated"]:
        fail(f"app run dropped pairs: {stats}")
    say("app", gaussians=APP_GAUSSIANS, frames=stats["frames"],
        pair_capacity=stats["pair_capacity"], num_pairs=stats["num_pairs"],
        overflow=stats["overflow"], truncated=stats["truncated"],
        median_frame_ms=stats["median_ms"], frame_ms=stats["frame_ms"],
        wall_s=app_s, capture_s=stats["capture_seconds"],
        launches=launches["app"], lit_pixels=int((img[..., 3] > 0).sum()))

    # -- 4. the 1M config ---------------------------------------------------
    phase("4. the 1M config")
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
    phase("5. the 1M train step")
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
                   "rasterize_bwd", "project_gaussians",
                   "project_gaussians_bwd", "adam"), TRAIN_STEPS_1M)
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
    phase("6. the train app")
    ckpt = os.path.join(tmp, "train.npz")
    common = ["--input", ply_path, "--mode", "distill", "--width",
              str(TRAIN_W), "--height", str(TRAIN_H), "--views",
              str(TRAIN_VIEWS), "--device", "cuda", "--seed", str(SEED),
              "--log-level", "warn"]
    t0 = time.perf_counter()
    tstats, launches["train_app"] = counted(cuda_lib, lambda: app_train.run(
        common + ["--steps", str(TRAIN_STEPS_APP), "--checkpoint", ckpt]))
    train_s = time.perf_counter() - t0
    # The steps are replays: D and C's aux mode launch only in the step
    # program's warm-ups and capture.
    need_launches("train app", launches["train_app"], ("stream_expand",),
                  captured)
    need_exact("train app", launches["train_app"],
               ("rasterize_strict_aux", "rasterize_bwd"), captured)
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
    need_exact("train app resume", launches["train_app_resume"],
               ("rasterize_strict_aux", "rasterize_bwd"), captured)
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
        step_ms=tstats["step_ms"],
        median_pipelined_ms=float(np.median(tstats["pipelined_ms"])),
        pipelined_ms=tstats["pipelined_ms"],
        capture_s=tstats["capture_seconds"], wall_s=train_s,
        checkpoint_bytes=os.path.getsize(ckpt),
        resumed_step=resumed["step"], resumed_loss=resumed["losses"][0],
        launches=launches["train_app"])

    # -- 7. rowseg 1M ---------------------------------------------------------
    phase("7. rowseg 1M")
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
    phase("8. the app with --rowseg 4")
    out_rs_png = os.path.join(tmp, "app_rowseg.png")
    stats_rs, launches["app_rowseg"] = counted(cuda_lib, lambda: app_main.run([
        "--input", ply_path, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--frames", "8", "--rowseg", "4", "--device", "cuda",
        "--output", out_rs_png, "--log-level", "warn"]))
    need_exact("app --rowseg 4", launches["app_rowseg"],
               ("row_cumsum_exclusive", "stream_expand_seg",
                "rasterize_relaxed"), captured)
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
    phase("9. the gather paths at 1M")
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

    # -- 10. the render engine ------------------------------------------
    phase("10. the render engine")
    app_angles = tuple(360.0 * i / 8 for i in range(8))
    cfg_eng_app = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                               pair_capacity=stats["pair_capacity"],
                               strict_termination=False)

    def app_cam(a):
        state = dict(fov=fov, rx=0.0, ry=a, x=0.0, y=0.0, z=0.0, erx=0.0,
                     ery=0.0)
        return app_main.orbit_camera(app_scene, state, aspect)

    def cam_1m_host(a):
        return Camera.orbit(-bb1, bb1, fov, aspect, rot_y_deg=a,
                            device="cpu")

    for label, model, cfg, cam_of, angles, kernels in (
            ("app 37.9k", app_scene.model, cfg_eng_app, app_cam, app_angles,
             ("stream_expand", "rasterize_relaxed")),
            ("1M", model_1m, cfg_1m, cam_1m_host, angles_1m,
             ("coverage_masks", "stream_expand", "rasterize_strict"))):
        facts, launches[f"engine {label}"] = engine_check(
            label, model, cfg, cam_of, angles, timer)
        need_exact(f"engine {label} capture", launches[f"engine {label}"],
                   kernels, captured)
        say("engine", cell=label, **facts,
            launches=launches[f"engine {label}"])

    step_facts = {}
    # The train step as a captured program: train 1M (phase 5's model,
    # capacity and L1 loss, its camera at angle 0, targets rendered at
    # other angles so that every step has a gradient) and train app
    # 640x360 (phase 6's initialisation, views and targets). Cameras and
    # targets are made outside inference mode: autograd may save them.
    cams_t = [Camera.orbit(app_scene.bb_min, app_scene.bb_max, fov,
                           TRAIN_W / TRAIN_H,
                           rot_y_deg=360.0 * i / TRAIN_VIEWS, device=dev)
              for i in range(TRAIN_VIEWS)]
    with torch.inference_mode():
        tgt_1m = [pipeline.render(model_1m, cam_1m(a), cfg_1m).image
                  for a in (10.0, 20.0, 30.0)]
        tgt_t = [pipeline.render(app_scene.model, c, cfg_tapp).image
                 for c in cams_t]
    for label, model, cfg, tc, cams, tgts, kernels in (
            ("1M", model_1m, cfg_train_1m, tc_1m, [cam0] * 3,
             [t.clone() for t in tgt_1m],
             ("coverage_masks", "stream_expand", "rasterize_strict_aux",
              "rasterize_bwd", "project_gaussians", "project_gaussians_bwd",
              "adam")),
            ("app 640x360", init_app, cfg_tapp, trainer.TrainConfig(
                scene_extent=extent), cams_t, [t.clone() for t in tgt_t],
             ("stream_expand", "rasterize_strict_aux", "rasterize_bwd",
              "project_gaussians", "project_gaussians_bwd", "adam"))):
        facts, launches[f"train step {label}"] = step_check(
            label, model, cfg, tc, cams, tgts, timer)
        step_facts[label] = facts
        need_exact(f"train step {label} capture",
                   launches[f"train step {label}"], kernels, captured)
        say("train_step_engine", cell=label, **facts,
            launches=launches[f"train step {label}"])
    del tgt_1m, tgt_t

    # -- 11. --device points on the card --------------------------------
    phase("11. --device points on the card")
    pts_png = os.path.join(tmp, "points.png")
    pts_frames = 3
    pts_stats, launches["points"] = counted(cuda_lib, lambda: app_main.run([
        "--input", ply_path, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--frames", str(pts_frames), "--device", "points",
        "--output", pts_png, "--log-level", "warn"]))
    scene_cpu = scene_io.load_scene(ply_path, device="cpu")
    cfg_pts = RasterConfig(image_width=WIDTH, image_height=HEIGHT)

    def points_ref(a):
        state = dict(fov=fov, rx=0.0, ry=a, x=0.0, y=0.0, z=0.0, erx=0.0,
                     ery=0.0)
        cam = app_main.orbit_camera(scene_cpu, state, aspect)
        with torch.inference_mode():
            return (cam, points_render.render_points(scene_cpu.model, cam,
                                                     cfg_pts),
                    points_render.tile_histogram(scene_cpu.model, cam,
                                                 cfg_pts))

    _, ref_img, ref_hist = points_ref(360.0 * (pts_frames - 1) / pts_frames)
    got_png = image_util.decode_png(open(pts_png, "rb").read())
    if not np.array_equal(got_png, image_util.to_uint8(
            ref_img.image.numpy())):
        fail("--device points: the PNG differs from the CPU render_points")
    if not (np.array_equal(pts_stats["tile_counts"], ref_hist.numpy())
            and pts_stats["num_pairs"] == int(ref_img.count)
            == int(ref_hist.sum())):
        fail(f"--device points: histogram or count differs from the CPU "
             f"(count {pts_stats['num_pairs']} vs {int(ref_img.count)})")
    eng_pts = engine_lib.RenderEngine(RuntimeConfig(device="cuda"))
    points_fn = app_main.points_program(cfg_pts)
    cam0_pts = points_ref(0.0)[0]
    eng_pts.register("points", points_fn, (
        app_scene.model, cam0_pts.view.to(dev), cam0_pts.proj.to(dev),
        cam0_pts.env_rot.to(dev)))
    for a in (0.0, 100.0, 250.0):
        cam, ref_img, ref_hist = points_ref(a)
        out = eng_pts.run("points", app_scene.model, cam.view, cam.proj,
                          cam.env_rot)
        if not (torch.equal(out.image.cpu(), ref_img.image)
                and torch.equal(out.tile_counts.cpu(), ref_hist)
                and int(out.count) == int(ref_img.count)):
            fail(f"points program at {a} deg: the card's image, histogram "
                 "or count differs from the CPU")
    say("points", frames=pts_stats["frames"], count=pts_stats["num_pairs"],
        histogram_total=int(pts_stats["tile_counts"].sum()),
        lit_pixels=int((got_png[..., 3] > 0).sum()),
        median_frame_ms=pts_stats["median_ms"],
        capture_s=eng_pts.programs["points"].compile_seconds,
        engine_angles_equal=3, launches=launches["points"])
    del eng_pts

    # -- 12. the remote UI ------------------------------------------------
    phase("12. the remote UI")
    ui_facts, launches["ui"] = counted(cuda_lib, lambda: ui_session(
        ply_path, probe_cache, os.path.join(tmp, "ui.png")))
    # The probe is read back from phase 3's cache, so B runs no eager
    # frame: only the splat program's warm-up and capture launch.
    need_exact("ui app", launches["ui"],
               ("stream_expand", "rasterize_relaxed"), captured)
    say("ui", **ui_facts, launches=launches["ui"])

    # -- 13. posed-image datasets ---------------------------------------
    phase("13. posed-image datasets")
    ds = dataset_phase(tmp, app_scene, dev, launches)
    say("dataset", **ds)

    # -- 14. training extras ----------------------------------------------
    phase("14. training extras")
    say("extras_colmap", **extras_colmap(tmp, ds, dev, launches))
    facts, launches["extras 1M"] = counted(cuda_lib, lambda: extras_1m(
        model_1m, cfg_train_1m, tc_1m, cam_1m, timer))
    need_launches("extras 1M", launches["extras 1M"],
                  ("coverage_masks", "stream_expand", "rasterize_strict_aux",
                   "rasterize_bwd"), 1)
    say("extras_1m", **facts, launches=launches["extras 1M"])
    say("extras_pose", **extras_pose(tmp, app_scene, ds, dev, launches))

    # -- 15. the distributed path ---------------------------------------
    phase("15. the distributed path")
    def dist_kernels_and_programs():
        with torch.inference_mode():
            splats = project_gaussians(model_1m, cam0, cfg_1m)
            demand, cap = dist_strip_capacity(splats, cfg_1m, DIST_SHARDS,
                                              capacity)
            strip = dist_strip_kernels(splats, cfg_1m, DIST_SHARDS, cap,
                                       results, cuda_ms)
        del splats
        say("dist_strip_kernels", card=card, strip_demand=demand,
            pair_capacity_per_shard=cap, **strip)
        say("dist_1m_frames", card=card, **dist_frames(
            model_1m, cfg_1m, DIST_SHARDS, cap, cam_1m_host, angles_1m,
            timer))
        with torch.inference_mode():
            tgt = [pipeline.render(model_1m, cam_1m(a), cfg_1m).image
                   for a in (10.0, 20.0, 30.0)]
        facts = dist_train_step(model_1m, cfg_train_1m, tc_1m, DIST_SHARDS,
                                cap, [cam0] * 3, [t.clone() for t in tgt],
                                timer)
        say("dist_train_1m", card=card, single_replay_device_ms=step_facts[
            "1M"]["replay_device_ms"], **facts)
        del tgt
        with torch.inference_mode():
            tgt = [pipeline.render(app_scene.model, c, cfg_tapp).image
                   for c in cams_t[:DIST_VB_VIEWS]]
        say("dist_view_batch", card=card, **dist_view_batch(
            init_app, cfg_tapp, trainer.TrainConfig(scene_extent=extent),
            cams_t, [t.clone() for t in tgt], timer))

    _, launches["dist"] = counted(cuda_lib, dist_kernels_and_programs)
    need_launches("distributed 1M and view batch", launches["dist"],
                  ("coverage_masks", "stream_expand", "rasterize_strict",
                   "rasterize_relaxed", "rasterize_strict_aux",
                   "rasterize_bwd"), 1)
    say("timer", **timer.summary())

    # The apps with --distributed: the app at phase 3's flags (its PNG
    # equal, every frame a replay), with the UI (the histogram's exchange
    # overflow 0), and the train CLI sharded with --densify on phase 13's
    # capture and with --view-batch in distill mode.
    shards = str(DIST_SHARDS)
    dist_png = os.path.join(tmp, "app_dist.png")
    dstats, launches["dist app"] = counted(cuda_lib, lambda: app_main.run([
        "--input", ply_path, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--frames", "8", "--pair-capacity", "0", "--device", "cuda",
        "--compile-cache", probe_cache, "--output", dist_png,
        "--distributed", shards, "--log-level", "warn"]))
    need_exact("app --distributed", launches["dist app"],
               ("stream_expand", "rasterize_relaxed"),
               DIST_SHARDS * captured)
    dist_img = image_util.decode_png(open(dist_png, "rb").read())
    png_diff = int(np.abs(dist_img.astype(np.int32)
                          - img.astype(np.int32)).max())
    if (png_diff or dstats["overflow"] or dstats["exchange_overflow"]
            or dstats["shards"] != DIST_SHARDS):
        fail(f"app --distributed {shards}: PNG differs by {png_diff} from "
             f"the single-device app's, or drops: {dstats}")
    ui_dist, launches["dist ui"] = counted(cuda_lib, lambda: ui_session(
        ply_path, probe_cache, os.path.join(tmp, "ui_dist.png"),
        ("--distributed", shards)))
    say("dist_app", card=card, shards=DIST_SHARDS, frames=dstats["frames"],
        pair_capacity=dstats["pair_capacity"], num_pairs=dstats["num_pairs"],
        png_max_abs_diff=png_diff, overflow=dstats["overflow"],
        exchange_overflow=dstats["exchange_overflow"],
        median_frame_ms=dstats["median_ms"], frame_ms=dstats["frame_ms"],
        single_device_median_frame_ms=stats["median_ms"],
        capture_s=dstats["capture_seconds"], ui=ui_dist,
        launches=launches["dist app"])
    views, n_points = ds["train_views"], ds["sfm_points"]
    cap_ds = -(-int(EX_PAIR_X * ds["probed_demand"]) // 128) * 128
    dd, launches["dist densify"] = counted(cuda_lib, lambda: app_train.run([
        "--dataset", ds["capture_root"], "--holdout-every", str(DS_HOLDOUT),
        "--exact-tiles", "--pair-capacity", str(cap_ds), "--device", "cuda",
        "--steps", str(DIST_EPOCHS * views), "--densify", "--densify-from",
        str(views), "--densify-every", str(views),
        "--densify-grad-threshold", str(EX_GRAD_THRESHOLD),
        "--distributed", shards, "--log-level", "warn"]))
    need_launches("train --distributed --densify", launches["dist densify"],
                  ("coverage_masks", "stream_expand", "rasterize_strict_aux",
                   "rasterize_bwd"), captured)
    xovf = [e["exchange_overflow"] for e in dd["events"]]
    if (any(drops_of(dd)) or any(xovf) or len(dd["events"]) != DIST_EPOCHS
            or not dd["events"][-1]["alive"] > n_points
            or dd["shards"] != DIST_SHARDS):
        fail(f"train --distributed --densify: drops {drops_of(dd)}, "
             f"exchange {xovf}, events {dd['events']}")
    say("dist_train_densify", card=card, shards=DIST_SHARDS,
        sfm_points=n_points, slots=dd["num_gaussians"], events=dd["events"],
        epoch_loss=epoch_means("train --distributed --densify",
                               dd["losses"], views),
        median_step_ms=float(np.median(dd["step_ms"])),
        median_pipelined_ms=float(np.median(dd["pipelined_ms"])),
        holdout_psnr=dd["eval_psnr"], registrations=registrations_of(dd),
        launches=launches["dist densify"])
    vb = DIST_VB_MESH[0]
    dv, launches["dist view batch"] = counted(cuda_lib, lambda: app_train.run(
        common + ["--steps", str(DIST_EPOCHS * TRAIN_VIEWS), "--distributed",
                  shards, "--view-batch", str(vb)]))
    need_launches("train --view-batch", launches["dist view batch"],
                  ("stream_expand", "rasterize_strict_aux", "rasterize_bwd"),
                  captured)
    if any(dv["vb_drops"].values()) or dv["view_batch"] != vb:
        fail(f"train --view-batch: drops {dv['vb_drops']}")
    say("dist_train_view_batch", card=card, shards=DIST_SHARDS,
        view_batch=vb, steps=len(dv["losses"]), drops=dv["vb_drops"],
        epoch_loss=epoch_means("train --view-batch", dv["losses"],
                               TRAIN_VIEWS // vb),
        median_step_ms=float(np.median(dv["step_ms"])),
        median_pipelined_ms=float(np.median(dv["pipelined_ms"])),
        psnr=dv["psnr"], launches=launches["dist view batch"])
    facts, launches["dist processes"] = counted(
        cuda_lib, lambda: mh_phase(tmp, ply_path, dev))
    say("dist_processes", card=card, **facts)
    for name, facts in mh_train_phase(tmp, ply_path, launches,
                                      cuda_lib).items():
        say("dist_train_processes", card=card, run=name,
            processes=MH_PROCESSES, **facts)
    say("timer", **timer.summary())

    # -- 16. kernels C and D against the dense oracle -------------------
    phase("16. oracle")
    say("oracle", card=card, **oracle_phase(dev, cuda_lib))

    # -- 17. a profiler trace of replayed app frames ----------------------
    phase("17. trace")
    cfg_trace = dataclasses.replace(cfg_eng_app, exact_tile_test=True)
    facts, launches["trace"] = counted(cuda_lib, lambda: trace_phase(
        tmp, app_scene, cfg_trace, app_cam, cuda_lib))
    need_exact("trace", launches["trace"],
               ("coverage_masks", "stream_expand", "rasterize_relaxed"),
               captured)
    say("trace", card=card, **facts, launches=launches["trace"])

    # -- 18. the host library, the scene tool, a clustered 1M scene -------
    phase("18. host library, scene tool, clustered 1M")
    say("native_build", card=card, **native_build(native))
    with torch.inference_mode():
        frame = pipeline.render(app_scene.model, app_cam(0.0).to(dev),
                                cfg_eng_app).image[..., :3].cpu().numpy()
    say("native_functions", card=card, times="host ms on the card machine",
        **native_functions(tmp, model_1m, frame, native))
    facts, launches["native decode train"] = native_decode(ds, dev, native,
                                                           cuda_lib)
    need_launches("train --downscale 2", launches["native decode train"],
                  ("coverage_masks", "stream_expand", "rasterize_strict_aux",
                   "rasterize_bwd"), 1)
    say("native_decode", card=card, times="host s on the card machine",
        **facts, launches=launches["native decode train"])
    facts, launches["scene tool"] = scene_tool_phase(tmp, ply_path, dev, fov,
                                                     capacity, cuda_lib)
    need_launches("scene tool renders", launches["scene tool"],
                  ("stream_expand", "rasterize_relaxed"), 1)
    say("scene_tool", card=card, **facts, launches=launches["scene tool"])
    facts, launches["clustered 1M"] = clustered_phase(
        cfg_1m, cam_1m(0.0), capacity, cuda_ms, cuda_lib)
    need_launches("clustered 1M frame", launches["clustered 1M"],
                  ("coverage_masks", "stream_expand", "rasterize_strict"), 1)
    say("clustered_1m", card=card, uniform_1m_ms=results[
        "rasterize_strict"]["ms"], **facts, launches=launches["clustered 1M"])
    say("timer", **timer.summary())
    phases.close()
    say("tracepoints", **profiling.tracepoint_summary())

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
