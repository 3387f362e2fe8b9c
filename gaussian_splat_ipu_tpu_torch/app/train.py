"""Training application: fit gaussian parameters to target views (torch
port of gaussian_splat_ipu_tpu/app/train.py).

    python -m gaussian_splat_ipu_tpu_torch.app.train --input scene.ply \\
        --steps 200 --views 8 [--mode distill|self] [--device cuda]
    python -m gaussian_splat_ipu_tpu_torch.app.train --dataset DIR \\
        --holdout-every 8 --steps 30000 --densify --depth-loss 0.1 \\
        --sh-step-every 1000 --export-ply out.ply

Targets:
  --input    render the target views from a loaded scene over an orbit;
             --mode distill trains a fresh random initialisation toward
             them (known ground truth), --mode self keeps optimising the
             loaded parameters against their own renders;
  --dataset  posed images: a COLMAP capture (io/colmap.py) when the
             directory holds a sparse model, else a transforms.json set
             (io/dataset.py). RGBA images are flattened over --background.
             The model starts from the COLMAP SfM points (at SH degree 3
             unless --sh-degree says otherwise), else from a random cloud
             of --init-gaussians (20,000 by default) inside half the
             cameras' extent. --holdout-every K keeps every K-th view out
             of training and reports its mean PSNR (eval_psnr=).

Training extras, with the reference's defaults and composition rules:
  --densify          density control in a fixed slot buffer
                     (train/densify.py): --capacity (0 = twice the initial
                     count), --densify-every (rounded to whole epochs),
                     --densify-from / --densify-until, the gradient
                     threshold scaled by the measured L1 / SSIM mix when
                     --ssim-weight > 0, --auto-grow (double the buffer
                     above 90% alive). Steps run in whole epochs; after each
                     event every training view's pair demand is probed, and
                     densification stops above 0.8x --pair-capacity.
  --pose-opt LR, --exposure-opt LR
                     per-view pose deltas and exposure maps optimised with
                     the scene (train/aux_opt.py); ignored, with a warning,
                     under --densify.
  --depth-loss W     sparse SfM depth supervision (train/depth.py); COLMAP
                     captures only, else ignored with a warning; composes
                     with --densify and with the aux modules.
  --sh-step-every N  progressive SH: one more band every N steps; each bump
                     registers the step program again. The final, holdout
                     and probe renders use every band.
  --max-device-views N
                     the targets stay in (pinned) host memory; each epoch
                     uploads them N views at a time as one (N, H, W, C)
                     device tensor, the last short piece wrapping in the
                     epoch's first views, as the reference's.
  --distributed [N]  sharded training over a mesh (parallel/distributed.py):
                     alone, one shard per visible device of --device's kind
                     (so one card, or the CPU, trains on the single-device
                     path, as the reference does on one chip); with N, N
                     shards, placed round-robin on those devices (N shards
                     on one card share it). Steps one view at a time, as
                     the reference's sharded program; with --densify, the
                     sharded densify step in whole epochs, the event on the
                     whole slot buffer, --auto-grow padding each shard's
                     slice, and the pair-demand guard against the summed
                     per-shard budgets. Pose, exposure and depth are
                     single-device only (ignored with a warning).
  --view-batch V     with --distributed and without --densify: V views a
                     step on a (V, N / V) view x shard mesh, the loss their
                     mean; V must divide N. The drop counters of every step
                     are summed and logged (warned about as they occur).

Multi-process runs (parallel/multihost.py), one process per shard, with
the reference's environment contract: GSPLAT_COORDINATOR (host:port of
process 0), GSPLAT_NUM_PROCESSES and GSPLAT_PROCESS_ID, the same
arguments on every process. NCCL when each process has a card of its own,
gloo otherwise (processes sharing one card, or the CPU):
  --distributed      the mesh is one shard per process (--distributed N
                     must name the process count). --input loads only this
                     process's rows (--sh-degree is then ignored); --mode
                     distill and --dataset build the whole initial model
                     from the seed on every process and keep this
                     process's rows. Every program runs eagerly (a
                     collective across processes is not captured). The
                     density event all-gathers the slot buffer, runs on it
                     on every process with the same key and keeps this
                     process's rows. --checkpoint gathers the state on
                     every process; --export-ply without --densify writes
                     each process's rows in place; the primary (process 0)
                     writes every other file.
  no --distributed   the replicated run: every process trains the whole
                     model on the single-device path; only the primary
                     writes files.
  --view-batch, --pose-opt, --exposure-opt and --depth-loss are ignored
  with a warning, and --resume exits.

Each step is one replay of a train program captured as a CUDA graph
(runtime/engine.RenderEngine; trainer, densify or aux_opt register_step)
with the view's camera, target and view index copied in; on --device cpu
the same program runs eagerly. The density event and the opacity reset
run eagerly between replays, in place on the captured tensors. Whole
epochs step as the reference's epoch programs do (the view order a fresh
permutation each epoch under --shuffle), then the last
partial epoch one step at a time. The final, holdout and probe renders
replay one render program (app/main.py::splat_program). The run logs the
loss and ends with the reference's `final_loss=... psnr=...` line.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import logging
import os
import time

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.app.eval import (flatten_rgba,
                                                   load_frames, select_split)
from gaussian_splat_ipu_tpu_torch.app.main import (sharded_program,
                                                   splat_program)
from gaussian_splat_ipu_tpu_torch.io import colmap as colmap_lib
from gaussian_splat_ipu_tpu_torch.io import splat as splat_io
from gaussian_splat_ipu_tpu_torch.io.scene import load_scene
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.parallel import distributed, multihost
from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.train import (appearance, aux_opt,
                                                checkpoint, densify, depth,
                                                losses, pose_opt, trainer)
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig,
                                                      check_supported)

log = logging.getLogger("gsplat")

_STEPS_IN_FLIGHT = 2     # steps queued on the device before one retires
_RENDER = "render"       # the engine's render program
_PROBE = "probe"         # the sharded pair-demand probe (--densify)
_VB_STEP = "view_batch_step"  # the --view-batch step program
_ORDER_SEED = 0xC0FFEE   # the reference's visit-order generator
_PROBE_SHARE = 0.8       # stop densifying above this share of the capacity
_GROW_SHARE = 0.9        # --auto-grow above this share of the slots alive
_VB_KEEP = 4             # view-batch steps whose counters stay unread


def parse_args(argv=None):
    """The reference CLI's flags, same defaults, plus --device and --seed;
    --distributed also takes a shard count."""
    p = argparse.ArgumentParser(
        description="CUDA gaussian splat trainer (PyTorch port)")
    p.add_argument("--input", default="", help="PLY/XYZ/.splat scene")
    p.add_argument("--dataset", default="",
                   help="posed images to train on instead of a scene: a "
                        "COLMAP capture or a transforms.json set")
    p.add_argument("--downscale", type=int, default=1,
                   help="--dataset: image downscale factor")
    p.add_argument("--holdout-every", type=int, default=0,
                   help="--dataset: hold every K-th view out of training "
                        "and report its mean PSNR at the end (0 = train "
                        "on every view)")
    p.add_argument("--log-level", default="info",
                   choices=list(engine_lib.LOG_LEVELS))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda = the CUDA kernels, each step a CUDA-graph "
                        "replay; cpu = their plain torch versions, eagerly")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random initialisation (--mode "
                        "distill, or a --dataset without SfM points)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--views", type=int, default=8,
                   help="orbit camera count for the target set")
    p.add_argument("--init-gaussians", type=int, default=0,
                   help="random-init size (0 = the scene's size, or "
                        "20,000 for a --dataset)")
    p.add_argument("--mode", choices=["distill", "self"], default="distill")
    p.add_argument("--ssim-weight", type=float, default=0.2)
    p.add_argument("--sh-degree", type=int, default=-1,
                   help="SH capacity of the trained model (-1 = keep the "
                        "source degree, 3 for SfM points; new bands start "
                        "at zero)")
    p.add_argument("--sh-step-every", type=int, default=0,
                   help="progressive SH schedule: one more band every N "
                        "steps (0 = all bands from the start); each bump "
                        "registers the step program again")
    p.add_argument("--pose-opt", type=float, default=0.0, metavar="LR",
                   help="refine per-view camera poses (SE(3) tangent deltas "
                        "at this Adam LR; 5e-4 is a sensible start); not "
                        "with --densify; composes with --exposure-opt and "
                        "--depth-loss")
    p.add_argument("--exposure-opt", type=float, default=0.0, metavar="LR",
                   help="per-view affine exposure compensation of the "
                        "render before the loss (Adam LR; 1e-2 is a "
                        "sensible start); not with --densify; composes "
                        "with --pose-opt and --depth-loss")
    p.add_argument("--depth-loss", type=float, default=0.0, metavar="W",
                   help="supervise the rendered depth at the COLMAP SfM "
                        "track observations with this weight (masked "
                        "relative L1; needs a COLMAP --dataset); composes "
                        "with --densify and --pose-opt / --exposure-opt")
    p.add_argument("--shuffle", action="store_true",
                   help="visit the views in a fresh random order each "
                        "epoch")
    p.add_argument("--background", choices=["black", "white"],
                   default="black",
                   help="render / composite background")
    p.add_argument("--max-device-views", type=int, default=0,
                   help="stream the targets from host memory this many "
                        "views at a time (0 = every target on the device); "
                        "view counts it does not divide wrap a few "
                        "duplicates into an epoch's last piece")
    p.add_argument("--pair-capacity", type=int, default=1 << 18)
    p.add_argument("--exact-tiles", action="store_true",
                   help="exact tile-ellipse coverage test (fewer pairs, "
                        "identical image)")
    p.add_argument("--tile-group", type=int, default=1,
                   help="bin pairs over KxK super-tiles (1 = off)")
    p.add_argument("--rowseg", type=int, default=1,
                   help="row-bucket segmented binning into N buckets of "
                        "--pair-capacity / N pairs each (1 = off)")
    p.add_argument("--antialias", action="store_true",
                   help="energy-conserving lowpass (Mip-Splatting)")
    p.add_argument("--checkpoint", default="",
                   help="write the final params + optimizer state here "
                        "(.npz, the JAX package's layout; with --densify "
                        "the density-control state, with --pose-opt / "
                        "--exposure-opt their states)")
    p.add_argument("--resume", default="",
                   help="restore a --checkpoint .npz (same CLI shape flags) "
                        "and continue training from it")
    p.add_argument("--export-ply", default="",
                   help="write the trained scene as a standard 3DGS PLY")
    p.add_argument("--export-splat", default="",
                   help="write the trained scene as a web-viewer .splat "
                        "(u8-quantised)")
    p.add_argument("--spans", default="", metavar="PATH",
                   help="record the engine's and the step program's spans "
                        "(utils/profiling.py) and write them to PATH as a "
                        "Chrome trace at exit (process k of a multi-process "
                        "run: PATH.k)")
    p.add_argument("--distributed", type=int, nargs="?", const=-1,
                   default=0, metavar="N",
                   help="sharded training: one shard per visible device of "
                        "--device's kind, or N shards round-robin on them")
    p.add_argument("--view-batch", type=int, default=0,
                   help="--distributed: also split each step's views over "
                        "a (view, shard) mesh, this many views a step (it "
                        "must divide the shard count)")
    p.add_argument("--densify", action="store_true",
                   help="adaptive density control (split / clone / prune)")
    p.add_argument("--capacity", type=int, default=0,
                   help="--densify: slot-buffer capacity (0 = twice the "
                        "initial count)")
    p.add_argument("--densify-every", type=int, default=100)
    p.add_argument("--densify-grad-threshold", type=float, default=2e-4)
    p.add_argument("--densify-from", type=int, default=500)
    p.add_argument("--densify-until", type=int, default=15_000)
    p.add_argument("--auto-grow", action="store_true",
                   help="--densify: double the slot buffer when 90%% full "
                        "(the programs are registered again) instead of "
                        "dropping the lowest-priority births")
    args = p.parse_args(argv)
    if not args.input and not args.dataset:
        p.error("one of --input / --dataset is required")
    return args


def render_views(engine, model, cameras, program: str = _RENDER) -> list:
    """One replay of a render program per camera (eager on the CPU): the
    FrameOutputs."""
    return [engine.run(program, model, c.view, c.proj, c.env_rot)
            for c in cameras]


def run(argv=None) -> dict:
    """The body of main. Returns the run's statistics: per-step losses,
    step times (CUDA-event ms on the card, host ms on the CPU) and
    pipelined ms (host ms between consecutive step retirements, up to
    _STEPS_IN_FLIGHT queued); every program registration (program, step,
    the SH degree it renders, -1 for every band, slots, capture seconds,
    the allocator's reserved bytes after it); with --densify each event
    (step, alive count, pair demand, overflow and exchange overflow of the
    probe, event ms) and the final alive count; the shard count, the view
    batch and its summed drop counters, the process count;
    the learned pose deltas and exposure maps; the overflow and truncation
    of the target renders (--input) or of the initial model's render of
    each training view (--dataset) and of the final render, the holdout
    PSNR and overflow, the final loss, PSNR and step."""
    args = parse_args(argv)
    engine_lib.setup_logging(args.log_level)
    # Multi-process bootstrap (GSPLAT_COORDINATOR; a no-op without it).
    multiproc = (multihost.initialize(device=args.device)
                 and multihost.process_count() > 1)
    if multiproc and args.resume:
        raise SystemExit("--resume is single-process only (restore then "
                         "re-shard the file across hosts manually via "
                         "load_scene_sharded)")
    engine = engine_lib.RenderEngine(RuntimeConfig(
        device=str(multihost.process_device(args.device)) if multiproc
        else args.device))
    device = engine.device
    rank = multihost.process_index() if multiproc else None
    rec = profiling.start(device) if args.spans else None
    try:
        return _run(args, engine, multiproc)
    finally:
        if rec is not None:
            path = args.spans if rank is None else f"{args.spans}.{rank}"
            profiling.export_spans(path, rec)
            profiling.stop()
            log.info("spans -> %s", path)


def _run(args, engine, multiproc: bool) -> dict:
    device = engine.device
    # A multi-process --distributed run shards over the processes: one
    # shard each, this process's on its own device.
    pmesh = None
    if multiproc and args.distributed:
        nproc = multihost.process_count()
        if args.distributed > 0 and args.distributed != nproc:
            raise SystemExit(f"--distributed {args.distributed} in a run of "
                             f"{nproc} processes: a multi-process run has "
                             "one shard per process")
        pmesh = multihost.make_process_mesh(str(device))
        log.info("multi-process run: %d processes, shard %d on %s", nproc,
                 multihost.process_index(), device)
    on_cuda = device.type == "cuda"
    if on_cuda:
        # Full f32 matmuls and convolutions (SSIM), as the reference.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    bg = 1.0 if args.background == "white" else 0.0
    holdout_cams, holdout_targets = [], []
    init = "loaded scene"
    target_renders = None
    depth_obs = None

    if args.dataset:
        colmap_dir = (os.path.isdir(args.dataset)
                      and colmap_lib.is_colmap_dir(args.dataset))
        if args.depth_loss > 0 and not colmap_dir:
            log.warning("--depth-loss needs a COLMAP dataset (SfM track "
                        "observations); ignoring")
            args.depth_loss = 0.0
        if args.depth_loss > 0:
            fs, sfm_xyz, sfm_rgb, depth_obs = colmap_lib.load_colmap(
                args.dataset, downscale=args.downscale, with_depth=True,
                device=device)
        else:
            fs, sfm_xyz, sfm_rgb = load_frames(args.dataset, args.downscale,
                                               device=device)
        if args.holdout_every > 0:
            hold = select_split(len(fs), "holdout", args.holdout_every)
            train_idx = select_split(len(fs), "train", args.holdout_every)
            holdout_cams = [fs.cameras[i] for i in hold]
            holdout_targets = [torch.tensor(flatten_rgba(fs.images[i], bg),
                                            device=device) for i in hold]
            log.info("holdout: %d eval views (every %d), %d train views",
                     len(hold), args.holdout_every, len(train_idx))
        else:
            train_idx = list(range(len(fs)))
        cameras = [fs.cameras[i] for i in train_idx]
        host_targets = [flatten_rgba(fs.images[i], bg) for i in train_idx]
        args.views = len(cameras)
        args.width, args.height = fs.width, fs.height
        origins = np.stack([c.cam_origin.cpu().numpy() for c in cameras])
        extent = max(float(np.linalg.norm(origins - origins.mean(0),
                                          axis=1).max()), 1e-3)
        if sfm_xyz is not None and sfm_xyz.shape[0] > 0:
            # Standard 3DGS seeds at full SH capacity (degree 3).
            deg = args.sh_degree if args.sh_degree >= 0 else 3
            model = GaussianModel.from_points(sfm_xyz, sfm_rgb,
                                              sh_degree=deg, device=device)
            init = f"{sfm_xyz.shape[0]} SfM points"
            log.info("init from %d COLMAP SfM points (SH degree %d)",
                     sfm_xyz.shape[0], deg)
        else:
            gen = torch.Generator(device=device).manual_seed(args.seed)
            model = GaussianModel.random(args.init_gaussians or 20_000,
                                         generator=gen, device=device,
                                         extent=0.5 * extent)
            init = f"{model.num_gaussians} random gaussians"
        log.info("dataset %s: %d views at %dx%d, camera extent %.2f",
                 args.dataset, len(cameras), fs.width, fs.height, extent)
        del fs
    else:
        if args.depth_loss > 0:
            log.warning("--depth-loss needs a COLMAP --dataset; ignoring")
            args.depth_loss = 0.0
        if pmesh is not None:
            # Each process parses only its rows of the scene file.
            scene = multihost.load_scene_sharded(args.input, pmesh)
        else:
            scene = load_scene(args.input, device=device)
        scene_rows = scene.num_rows or scene.num_gaussians
        extent = float(np.linalg.norm(scene.bb_max - scene.bb_min) * 0.5)
        fov = float(np.radians(40.0))
        cameras = [Camera.orbit(scene.bb_min, scene.bb_max, fov,
                                args.width / args.height,
                                rot_y_deg=360.0 * i / args.views,
                                device=device)
                   for i in range(args.views)]
        if args.mode == "distill":
            # The whole scene's count on every process (the reference
            # draws the padded count of its sharded array: one culled row
            # more at an odd count over 2 processes).
            gen = torch.Generator(device=device).manual_seed(args.seed)
            model = GaussianModel.random(
                args.init_gaussians or scene_rows, generator=gen,
                device=device, extent=extent)
            init = f"{model.num_gaussians} random gaussians"
        else:
            model = scene.model
    cfg = RasterConfig(image_width=args.width, image_height=args.height,
                       pair_capacity=args.pair_capacity,
                       exact_tile_test=args.exact_tiles,
                       antialias=args.antialias, tile_group=args.tile_group,
                       rowseg_buckets=args.rowseg, background=(bg, bg, bg))
    check_supported(cfg)
    # The mesh: --distributed alone takes one shard per visible device
    # (the reference's jax.devices()), or one per process; one shard is
    # the single-device path.
    shards = (multihost.process_count() if pmesh is not None
              else args.distributed if args.distributed > 0
              else mesh_lib.visible_device_count(device.type)
              if args.distributed < 0 else 1)
    use_dist = shards > 1
    # On a process mesh this process holds a slice of each slot-indexed
    # tensor: the model as loaded by --mode self, the state from here on.
    model_local = pmesh is not None and not args.dataset \
        and args.mode == "self"
    if args.view_batch > 1 and (not use_dist or args.densify or multiproc):
        log.warning("--view-batch needs --distributed without --densify "
                    "in a single process; ignoring")
        args.view_batch = 0
    if args.view_batch > 1 and shards % args.view_batch:
        raise SystemExit("--view-batch must divide the shard count "
                         f"({shards})")
    if args.depth_loss > 0 and (use_dist or multiproc):
        log.warning("--depth-loss needs the single-device path; ignoring")
        args.depth_loss = 0.0
    mesh, eager = None, ""
    probe_capacity = cfg.pair_capacity
    if pmesh is not None:
        probe_capacity = distributed.default_pair_budget(cfg, shards) * shards
        mesh = pmesh
        eager = ("its shards are processes: a collective across processes "
                 "is not captured in a CUDA graph")
    elif use_dist:
        probe_capacity = distributed.default_pair_budget(cfg, shards) * shards
        mesh = (mesh_lib.make_mesh_2d(args.view_batch,
                                      shards // args.view_batch,
                                      device=device.type)
                if args.view_batch > 1
                else mesh_lib.make_mesh(shards, device=device.type))
        if mesh.spans_devices:
            eager = (f"its {mesh.size} shards span "
                     f"{len(set(mesh.devices))} devices")
        log.info("distributed over %d shards on %s%s", shards,
                 sorted({str(d) for d in mesh.devices}),
                 f" (view batch {args.view_batch})"
                 if args.view_batch > 1 else "")
    if not args.dataset:
        log.info("rendering %d target views at %dx%d from %d gaussians",
                 args.views, args.width, args.height, scene_rows)
        with torch.no_grad():
            target_renders = [
                distributed.render_sharded(scene.model, cam, cfg, pmesh)
                if pmesh is not None else render(scene.model, cam, cfg)
                for cam in cameras]
        host_targets = None

    # The targets: every view on the device, or with --max-device-views a
    # host store (pinned on the card) uploaded one piece at a time.
    chunk_views = (args.max_device_views
                   if 0 < args.max_device_views < args.views else 0)
    if chunk_views:
        store = (torch.from_numpy(np.stack(host_targets)) if host_targets
                 else torch.stack([o.image for o in target_renders]).cpu())
        if on_cuda:
            store = store.pin_memory()
        targets = None
        log.info("target streaming: %d views on the device per piece (%d "
                 "in all, %.1f MB host store)", chunk_views, args.views,
                 store.numel() * store.element_size() / 1e6)
    elif host_targets is not None:
        targets = [torch.tensor(t, device=device) for t in host_targets]
    else:
        targets = [o.image for o in target_renders]
    del host_targets

    def target_of(k):
        if targets is not None:
            return targets[k]
        return store[k].to(device, non_blocking=True)

    target0 = target_of(0)
    depth_pack = None
    if args.depth_loss > 0 and depth_obs is not None:
        depth_pack = depth.pack_observations(
            [depth_obs[i] for i in train_idx], device=device)
        log.info("depth supervision: %d SfM observations over %d views "
                 "(packed K=%d)", sum(depth_obs[i].shape[0]
                                      for i in train_idx),
                 len(train_idx), depth_pack[0].shape[1])
    depth_weight = args.depth_loss if depth_pack is not None else 0.0

    if args.sh_degree >= 0 and args.sh_degree != model.sh_degree:
        if pmesh is not None and args.input:
            log.warning("--sh-degree ignored: scene was loaded sharded")
        else:
            model = model.with_sh_degree(args.sh_degree)
            log.info("SH degree -> %d (%d bands)", args.sh_degree,
                     model.sh.shape[1])
    # Progressive SH: band 0 first, one more every --sh-step-every steps.
    full_sh_degree = model.sh_degree
    active_sh = 0 if args.sh_step_every > 0 else -1
    tc = trainer.TrainConfig(ssim_weight=args.ssim_weight,
                             scene_extent=extent)

    # --pose-opt / --exposure-opt compose with --depth-loss in one aux
    # step; density control and the sharded steps take neither.
    for flag in ("pose_opt", "exposure_opt"):
        if getattr(args, flag) > 0 and (args.densify or use_dist
                                        or multiproc):
            log.warning("--%s needs the single-device non-densify path; "
                        "ignoring", flag.replace("_", "-"))
            setattr(args, flag, 0.0)
    aux = None
    if args.pose_opt > 0 or args.exposure_opt > 0:
        aux = aux_opt.init_aux_state(args.views, args.pose_opt,
                                     args.exposure_opt, device=device)
        if args.pose_opt > 0:
            log.info("pose refinement on: %d views, lr %g", args.views,
                     args.pose_opt)
        if args.exposure_opt > 0:
            log.info("exposure compensation on: %d views, lr %g",
                     args.views, args.exposure_opt)

    dstate = dcfg = None
    if args.densify:
        if model_local:
            # The event works on the whole buffer: gather the loaded slices.
            with torch.no_grad():
                model = GaussianModel(*(multihost.gather_rows(
                    getattr(model, k).detach()) for k in FIELDS))
        n0 = model.num_gaussians
        capacity = args.capacity or 2 * n0
        if args.distributed:
            # The slot buffer splits evenly over the shards.
            capacity = -(-capacity // shards) * shards
        gscale = 1.0
        if args.ssim_weight > 0.0:
            # The threshold is calibrated on L1: normalise it by the
            # measured gradient scale of the mix, or densification
            # over-grows.
            gscale = densify.loss_mix_scale(model, cameras[0], target0, cfg,
                                            args.ssim_weight)
            log.info("densify threshold scaled x%.2f for ssim_weight %.2f",
                     gscale, args.ssim_weight)
        dcfg = densify.DensifyConfig(
            grad_threshold=args.densify_grad_threshold * gscale,
            # Events land on epoch boundaries.
            densify_every=max(args.densify_every // args.views, 1)
            * args.views,
            densify_from_step=args.densify_from,
            densify_until_step=args.densify_until, scene_extent=extent)
        dstate = densify.init_state(n0, capacity, device=device)
        state = trainer.init_state(
            densify.pad_model(model, capacity).trainable(), tc)
        if pmesh is not None:
            state, dstate = multihost.keep_state(state, dstate)
        log.info("density control on: %d init gaussians, capacity %d", n0,
                 capacity)
    elif pmesh is not None:
        state = trainer.init_state((model if model_local else
                                    multihost.local_model(model)).trainable(),
                                   tc)
    elif use_dist:
        state = trainer.init_state(
            mesh_lib.shard_model(model, mesh).trainable(), tc)
    else:
        state = trainer.init_state(model.trainable(), tc)
    if args.resume:
        if args.densify:
            state, dstate = checkpoint.restore_checkpoint(args.resume,
                                                          (state, dstate))
        elif aux is not None:
            state, aux = checkpoint.restore_checkpoint(args.resume,
                                                       (state, aux))
        else:
            state = checkpoint.restore_checkpoint(args.resume, state)
        if use_dist and state.params.num_gaussians % shards:
            raise SystemExit("--resume --distributed needs a checkpoint whose "
                             f"gaussian count divides the {shards} shards")
        log.info("resumed from %s at step %d", args.resume, int(state.step))

    # The programs, registered after any resume (a graph updates the
    # tensors it captured) and again whenever the state's tensors or the
    # active SH degree change. The render program reads state.params as
    # the steps leave them.
    cam0 = cameras[0]
    obs_all, mask_all = (depth_pack if depth_pack is not None
                         else aux_opt.dummy_depth_obs(args.views,
                                                      device=device))
    # Depth alone is the aux step with both modules off; it checkpoints
    # the bare state, as the reference does.
    step_aux = aux
    if step_aux is None and depth_weight > 0 and not args.densify:
        step_aux = aux_opt.AuxState(pose=None, exposure=None)
    registrations = []
    i = 0

    def registered(prog, sh_degree):
        registrations.append(dict(
            program=prog.name, step=i, active_sh_degree=sh_degree,
            slots=state.params.num_gaussians,
            capture_s=prog.compile_seconds,
            reserved_bytes=(torch.cuda.memory_reserved(device) if on_cuda
                            else None)))
        return prog

    def register_render():
        example = (state.params, cam0.view.clone(), cam0.proj.clone(),
                   cam0.env_rot.clone())
        # On a process mesh each process holds a slice: every render is
        # sharded, at the shards' own budgets.
        registered(engine.register(
            _RENDER, sharded_program(cfg, mesh) if pmesh is not None
            else splat_program(cfg), example, eager=eager), -1)
        if use_dist and args.densify:
            # The pair-demand probe renders sharded, at the shards' own
            # budgets (distributed.default_pair_budget), as the
            # reference's densify guard does.
            registered(engine.register(_PROBE, sharded_program(cfg, mesh),
                                       example, eager=eager), -1)

    # The view-batch steps' views: the training views cycled to a whole
    # number of batches, as the reference's.
    vb_groups = []
    if args.view_batch > 1:
        idxs = list(range(args.views))
        idxs += idxs[:(-len(idxs)) % args.view_batch]
        vb_groups = [idxs[g:g + args.view_batch]
                     for g in range(0, len(idxs), args.view_batch)]

    def vb_args(sel):
        return (state, tuple(cameras[k] for k in sel),
                torch.stack([target_of(k) for k in sel]))

    def register_step():
        acfg = (cfg if active_sh < 0 else
                dataclasses.replace(cfg, active_sh_degree=active_sh))
        vi = torch.zeros((), dtype=torch.int64, device=device)
        if args.densify:
            prog = densify.register_step(
                engine, state, dstate, cam0, target0, acfg, tc, depth_weight,
                vi, obs_all, mask_all,
                step_fn=(distributed.make_sharded_densify_train_step(
                    mesh, acfg, tc) if use_dist else None), eager=eager)
        elif args.view_batch > 1:
            _, cams, tgts = vb_args(vb_groups[0])
            step = distributed.make_view_batch_train_step(
                mesh, acfg, tc, pair_capacity=args.pair_capacity)
            prog = engine.register(_VB_STEP, step, (
                state, tuple(trainer.static_copies(c, tgts)[0]
                             for c in cams), tgts.clone()),
                grad=True, eager=eager)
        elif use_dist:
            prog = trainer.register_step(
                engine, state, cam0, target0, acfg, tc,
                step_fn=distributed.make_sharded_train_step(
                    mesh, acfg, tc, pair_capacity=args.pair_capacity),
                eager=eager)
        elif step_aux is not None:
            prog = aux_opt.register_step(
                engine, state, step_aux, vi, cam0, target0, obs_all,
                mask_all, acfg, tc, args.pose_opt, args.exposure_opt,
                depth_weight)
        else:
            prog = trainer.register_step(engine, state, cam0, target0, acfg,
                                         tc)
        return registered(prog, active_sh)

    def step_args(k, target):
        """The step program's arguments for view k."""
        cam, vi = cameras[k], torch.tensor(k, dtype=torch.int64)
        if args.densify:
            stats = (state, dstate.grad_sum, dstate.vis_count)
            if depth_weight > 0:
                return (*stats, vi, cam, target, obs_all, mask_all)
            return (*stats, cam, target)
        if step_aux is not None:
            return (state, step_aux, vi, cam, target, obs_all, mask_all)
        return (state, cam, target)

    register_render()
    if target_renders is None:
        # The pairs each training view bins at the start.
        target_renders = render_views(engine, state.params, cameras)
    target_overflow = [int(o.overflow) for o in target_renders]
    target_truncated = [int(o.truncated) for o in target_renders]
    del target_renders
    if any(target_overflow) or any(target_truncated):
        log.warning("target renders dropped pairs: overflow %s, truncated "
                    "%s: raise --pair-capacity", target_overflow,
                    target_truncated)
    step_prog = register_step()
    log.info("step program: %s", engine.manifest())

    inflight = collections.deque()
    loss_t, marks, pipelined = [], [], []
    t_last = None

    def retire():
        nonlocal t_last
        ev = inflight.popleft()
        if on_cuda:
            ev[1].synchronize()
        now = time.perf_counter()
        if t_last is not None:
            pipelined.append((now - t_last) * 1e3)
        t_last = now

    def launch(*step_in):
        """Run the step program once; the loss (and with --view-batch its
        drop counters) stays on the device."""
        if on_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        else:
            ev = time.perf_counter()
        loss = engine.run(step_prog.name, *step_in)
        if args.view_batch > 1:
            loss, drops = loss
            vb_pending.append(drops)
        if on_cuda:
            ev[1].record()
        else:
            ev = (time.perf_counter() - ev) * 1e3
        loss_t.append(loss)
        marks.append(ev)
        inflight.append(ev)
        if len(inflight) >= _STEPS_IN_FLIGHT:
            retire()

    def run_step(k, target):
        launch(*step_args(k, target))

    # View-batch drop counters: each step's (exchange_overflow, overflow,
    # truncated) stays on the device until it is _VB_KEEP steps old (or a
    # log line is due), then joins the run's sums; drops warn as they
    # surface, since they corrupt that step's gradients.
    vb_names = ("exchange_overflow", "overflow", "truncated")
    vb_drops = dict.fromkeys(vb_names, 0)
    vb_pending = []

    def drain_vb(step_i, keep=0):
        since = dict.fromkeys(vb_names, 0)
        while len(vb_pending) > keep:
            for name, v in zip(vb_names, vb_pending.pop(0).tolist()):
                since[name] += v
        for name, v in since.items():
            vb_drops[name] += v
        if any(since.values()):
            log.warning("view-batch drops by step %d: %s since last check "
                        "(run totals %s): dropped pairs corrupt gradients; "
                        "raise --pair-capacity", step_i, since, vb_drops)

    order_rng = np.random.default_rng(_ORDER_SEED)

    def view_order():
        """An epoch's visit order: a fresh permutation under --shuffle."""
        return (order_rng.permutation(args.views) if args.shuffle
                else np.arange(args.views))

    step_order = list(range(args.views))

    def next_step_index(i):
        """The sharded step's view: the reference steps it one view at a
        time, the order shuffled in place at each epoch boundary."""
        k = i % args.views
        if k == 0 and args.shuffle:
            order_rng.shuffle(step_order)
        return step_order[k]

    def run_epoch():
        """One epoch in pieces of chunk_views (the last wraps the epoch's
        first views in), each piece's targets uploaded as one device
        tensor; without streaming, one piece of every view."""
        order = view_order()
        n = chunk_views or args.views
        chunk = None
        for c0 in range(0, args.views, n):
            sel = order[c0:c0 + n]
            if len(sel) < n:
                sel = np.concatenate([sel, order[:n - len(sel)]])
            if chunk_views:
                chunk = None        # the previous piece leaves first
                chunk = torch.empty((n,) + tuple(store.shape[1:]),
                                    dtype=store.dtype, device=device)
                for j, k in enumerate(sel):
                    chunk[j].copy_(store[int(k)], non_blocking=True)
            for j, k in enumerate(sel):
                run_step(int(k), chunk[j] if chunk_views else targets[k])

    def alive_count() -> int:
        """Alive slots of the whole buffer (summed over the processes)."""
        alive = torch.sum(dstate.alive)
        return int(pmesh.group().psum([alive]) if pmesh is not None
                   else alive)

    def slot_count() -> int:
        """The whole slot buffer's size (every process's slice)."""
        return state.params.num_gaussians * (shards if pmesh is not None
                                              else 1)

    densify_open = True
    events = []
    tail_order = None
    t0 = time.perf_counter()
    while i < args.steps:
        if (args.sh_step_every > 0 and active_sh < full_sh_degree
                and i // args.sh_step_every > active_sh):
            active_sh = min(full_sh_degree, i // args.sh_step_every)
            step_prog = register_step()
            log.info("SH schedule: active degree -> %d at step %d",
                     active_sh, i)
        if args.densify or (not use_dist and args.steps - i >= args.views):
            run_epoch()
            i += args.views
        elif args.view_batch > 1:
            launch(*vb_args(vb_groups[(i // args.view_batch)
                                      % len(vb_groups)]))
            drain_vb(i, keep=_VB_KEEP)
            i += args.view_batch
        elif use_dist:
            k = next_step_index(i)
            run_step(k, target_of(k))
            i += 1
        else:
            # The last partial epoch, one step at a time.
            if i % args.views == 0:
                tail_order = view_order()
            k = int(tail_order[i % args.views])
            run_step(k, target_of(k))
            i += 1
        if args.densify:
            c = dcfg
            if (densify_open
                    and c.densify_from_step <= i <= c.densify_until_step
                    and i % c.densify_every == 0):
                ev_t = time.perf_counter()
                if on_cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                state, dstate = (multihost if pmesh is not None
                                 else densify).densify_and_prune(state,
                                                                 dstate, c)
                if on_cuda:
                    ev[1].record()
                    ev[1].synchronize()
                    event_ms = ev[0].elapsed_time(ev[1])
                else:
                    event_ms = (time.perf_counter() - ev_t) * 1e3
                # Guard the pair budget over every training view: dropped
                # pairs corrupt gradients, so stop growing first. Sharded,
                # the global demand against the summed per-shard budgets
                # (counted overflow catches a single hot shard).
                probe = render_views(engine, state.params, cameras,
                                     _PROBE if use_dist else _RENDER)
                demand = max(int(o.count + o.overflow) for o in probe)
                ovf = max(int(o.overflow) for o in probe)
                xovf = max(int(o.exchange_overflow) for o in probe)
                del probe
                if ovf > 0:
                    log.warning("pair overflow (%d dropped): raise "
                                "--pair-capacity", ovf)
                if demand > int(_PROBE_SHARE * probe_capacity):
                    densify_open = False
                    log.info("pair demand %d near capacity %d: no further "
                             "densification", demand, probe_capacity)
                alive_now = alive_count()
                slots = slot_count()
                events.append(dict(step=i, alive=alive_now, demand=demand,
                                   overflow=ovf, exchange_overflow=xovf,
                                   event_ms=event_ms, slots=slots))
                if (args.auto_grow and densify_open
                        and alive_now > int(_GROW_SHARE * slots)):
                    if use_dist:
                        state, dstate = distributed.grow_capacity_sharded(
                            mesh, state, dstate, 2 * slots)
                    else:
                        state, dstate = densify.grow_capacity(state, dstate,
                                                              2 * slots)
                    register_render()
                    step_prog = register_step()
                    log.info("slot buffer grown to %d (programs registered "
                             "again)", 2 * slots)
                log.info("densify at step %d: %d gaussians alive (%d "
                         "pairs)", i, alive_now, demand)
            # Reset only while densification runs (pruning must harvest
            # it) and never near the end: the model needs a few hundred
            # steps to recover.
            if (densify_open and c.reset_opacity_every
                    and i % c.reset_opacity_every < args.views
                    and i >= c.reset_opacity_every
                    and i <= min(args.steps - 500, c.densify_until_step)):
                densify.reset_opacity(state, dstate, c)
        if (i // args.views) % 10 == 0 or i >= args.steps:
            log.info("step %d: loss %.5f", i, float(loss_t[-1]))
            drain_vb(i)
    while inflight:
        retire()
    drain_vb(i)
    if any(vb_drops.values()):
        log.warning("view-batch drop totals over the run: %s: raise "
                    "--pair-capacity", vb_drops)
    if on_cuda:
        torch.cuda.synchronize(device)
        step_ms = [a.elapsed_time(b) for a, b in marks]
    else:
        step_ms = marks
    dt = time.perf_counter() - t0
    losses_h = [float(x) for x in loss_t]
    if losses_h:
        log.info("trained %d steps in %.1fs (%.2f it/s)", len(losses_h), dt,
                 len(losses_h) / dt)

    pose = aux.pose if aux is not None else None
    expo = aux.exposure if aux is not None else None
    if expo is not None:
        dev_ = (expo.mats - appearance.identity_mats(
            args.views, device=device)).abs()
        log.info("exposure compensation: mean |dev| %.4g, max %.4g",
                 float(dev_.mean()), float(dev_.max()))
    cam_final = cam0
    if pose is not None:
        # PSNR of view 0 through its corrected pose.
        cam_final = pose_opt.apply_delta(cam0, pose.deltas[0])
        mags = torch.linalg.vector_norm(pose.deltas, dim=1)
        log.info("pose refinement: mean |delta| %.4g, max %.4g",
                 float(mags.mean()), float(mags.max()))
    final = render_views(engine, state.params, [cam_final])[0]
    psnr = float(losses.psnr(final.image[..., :3], target0[..., :3]))
    log.info("PSNR vs target view 0: %.2f dB", psnr)
    eval_psnr, holdout_overflow = None, []
    if holdout_cams:
        outs = render_views(engine, state.params, holdout_cams)
        holdout_overflow = [int(o.overflow) for o in outs]
        eval_psnr = float(np.mean([
            float(losses.psnr(o.image[..., :3], t[..., :3]))
            for o, t in zip(outs, holdout_targets)]))
        log.info("holdout eval: %.2f dB mean PSNR over %d unseen views",
                 eval_psnr, len(outs))
    final_alive = None
    if args.densify:
        final_alive = alive_count()
        log.info("final gaussian count: %d (capacity %d)", final_alive,
                 slot_count())
    # The files: on a process mesh the state is gathered on every process
    # (a collective all of them call) and the primary writes, except a
    # PLY without --densify, which each process writes its rows of.
    sharded_ply = pmesh is not None and not args.densify
    whole, whole_d = state, dstate
    if pmesh is not None and (args.checkpoint or args.export_splat
                              or (args.export_ply and not sharded_ply)):
        whole, whole_d = multihost.gather_state(state, dstate)
    scene_out = whole.params
    if args.densify and (args.export_ply or args.export_splat):
        scene_out = densify.compact(whole.params, whole_d)
    primary = multihost.is_primary()
    if args.checkpoint and primary:
        payload = ((whole, whole_d) if args.densify
                   else (whole, aux) if aux is not None else whole)
        checkpoint.save_checkpoint(args.checkpoint, payload)
        log.info("checkpoint -> %s", args.checkpoint)
    if args.export_ply and sharded_ply:
        multihost.export_ply_sharded(args.export_ply, state.params)
        log.info("scene -> %s (each process its rows)", args.export_ply)
    elif args.export_ply and primary:
        checkpoint.export_ply(args.export_ply, scene_out)
        log.info("scene -> %s", args.export_ply)
    if args.export_splat and primary:
        splat_io.write_splat(args.export_splat, scene_out)
        log.info("scene -> %s (.splat)", args.export_splat)
    final_loss = losses_h[-1] if losses_h else float("nan")
    tail = f" eval_psnr={eval_psnr:.2f}" if eval_psnr is not None else ""
    print(f"final_loss={final_loss:.6f} psnr={psnr:.2f}{tail}")
    processes = multihost.process_count()
    if multiproc:
        torch.distributed.destroy_process_group()
    return dict(losses=losses_h, step_ms=step_ms, pipelined_ms=pipelined,
                shards=shards if use_dist else 1, processes=processes,
                view_batch=args.view_batch, vb_drops=vb_drops,
                capture_seconds=step_prog.compile_seconds,
                registrations=registrations, events=events,
                final_loss=final_loss, psnr=psnr, eval_psnr=eval_psnr,
                step=int(state.step), init=init,
                num_gaussians=slot_count(),
                final_alive=final_alive, active_sh_degree=active_sh,
                views=args.views, holdout_views=len(holdout_cams),
                device_views=chunk_views or args.views,
                pose_deltas=(pose.deltas.cpu().numpy() if pose is not None
                             else None),
                exposure_mats=(expo.mats.cpu().numpy() if expo is not None
                               else None),
                target_overflow=target_overflow,
                target_truncated=target_truncated,
                holdout_overflow=holdout_overflow,
                final_overflow=int(final.overflow),
                final_truncated=int(final.truncated),
                num_pairs=int(final.count),
                pair_capacity=cfg.pair_capacity)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
