"""Training application: fit gaussian parameters to target views (torch
port of the single-device path of gaussian_splat_ipu_tpu/app/train.py).

    python -m gaussian_splat_ipu_tpu_torch.app.train --input scene.ply \\
        --steps 200 --views 8 [--mode distill|self] [--device cuda]
    python -m gaussian_splat_ipu_tpu_torch.app.train --dataset DIR \\
        --holdout-every 8 --steps 30000 --export-ply out.ply

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

The targets stay on the device. Each step is one replay of the train step
captured as a CUDA graph (train/trainer.py::register_step, a
runtime/engine.RenderEngine program) with the view's camera and target
copied in; on --device cpu the same program runs eagerly. There is no
whole-epoch program as the reference's lax.scan: a replay costs one host
call, so an epoch is one replay per view. The final, holdout and probe
renders replay one render program (app/main.py::splat_program) with the
camera copied in. The run logs the loss and ends with the reference's
`final_loss=... psnr=...` line.
"""

from __future__ import annotations

import argparse
import collections
import logging
import time

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.app.eval import (flatten_rgba,
                                                   load_frames, select_split)
from gaussian_splat_ipu_tpu_torch.app.main import splat_program
from gaussian_splat_ipu_tpu_torch.io import splat as splat_io
from gaussian_splat_ipu_tpu_torch.io.scene import load_scene
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.train import checkpoint, losses, trainer
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig,
                                                      check_supported)

log = logging.getLogger("gsplat")

_LOG_EVERY_EPOCHS = 10
_STEPS_IN_FLIGHT = 2     # steps queued on the device before one retires
_RENDER = "render"       # the engine's render program

# Flags of the reference CLI that this port does not carry yet: (dest,
# the value that means "off", what it is, the ROADMAP.md queue-1 item).
_UNPORTED = (
    ("densify", False, "--densify (adaptive density control)",
     "Training extras: train/densify.py"),
    ("capacity", 0, "--capacity (a --densify option)",
     "Training extras: train/densify.py"),
    ("densify_every", 100, "--densify-every (a --densify option)",
     "Training extras: train/densify.py"),
    ("densify_grad_threshold", 2e-4,
     "--densify-grad-threshold (a --densify option)",
     "Training extras: train/densify.py"),
    ("densify_from", 500, "--densify-from (a --densify option)",
     "Training extras: train/densify.py"),
    ("densify_until", 15_000, "--densify-until (a --densify option)",
     "Training extras: train/densify.py"),
    ("auto_grow", False, "--auto-grow (a --densify option)",
     "Training extras: train/densify.py"),
    ("distributed", False, "--distributed (sharded training)",
     "Distributed path"),
    ("view_batch", 0, "--view-batch (view-parallel training)",
     "Distributed path"),
    ("pose_opt", 0.0, "--pose-opt (camera pose refinement)",
     "Training extras: train/pose_opt.py, train/aux_opt.py"),
    ("exposure_opt", 0.0, "--exposure-opt (exposure compensation)",
     "Training extras: train/appearance.py, train/aux_opt.py"),
    ("depth_loss", 0.0, "--depth-loss (SfM depth supervision)",
     "Training extras: train/depth.py"),
    ("sh_step_every", 0, "--sh-step-every (progressive SH schedule)",
     "Training extras: the progressive SH schedule"),
    ("max_device_views", 0, "--max-device-views (host-streamed targets)",
     "Training extras: target streaming"),
)


def parse_args(argv=None):
    """The reference CLI's flags, same defaults, plus --device and --seed;
    the ones this port does not carry are refused."""
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
                   help="not ported yet")
    p.add_argument("--pose-opt", type=float, default=0.0, metavar="LR",
                   help="not ported yet")
    p.add_argument("--exposure-opt", type=float, default=0.0, metavar="LR",
                   help="not ported yet")
    p.add_argument("--depth-loss", type=float, default=0.0, metavar="W",
                   help="not ported yet")
    p.add_argument("--shuffle", action="store_true",
                   help="visit the views in a fresh random order each "
                        "epoch")
    p.add_argument("--background", choices=["black", "white"],
                   default="black",
                   help="render / composite background")
    p.add_argument("--max-device-views", type=int, default=0,
                   help="not ported yet")
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
                        "(.npz, the JAX package's layout)")
    p.add_argument("--resume", default="",
                   help="restore a --checkpoint .npz (same CLI shape flags) "
                        "and continue training from it")
    p.add_argument("--export-ply", default="",
                   help="write the trained scene as a standard 3DGS PLY")
    p.add_argument("--export-splat", default="",
                   help="write the trained scene as a web-viewer .splat "
                        "(u8-quantised)")
    p.add_argument("--distributed", action="store_true",
                   help="not ported yet")
    p.add_argument("--view-batch", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--densify", action="store_true", help="not ported yet")
    p.add_argument("--capacity", type=int, default=0, help="not ported yet")
    p.add_argument("--densify-every", type=int, default=100,
                   help="not ported yet")
    p.add_argument("--densify-grad-threshold", type=float, default=2e-4,
                   help="not ported yet")
    p.add_argument("--densify-from", type=int, default=500,
                   help="not ported yet")
    p.add_argument("--densify-until", type=int, default=15_000,
                   help="not ported yet")
    p.add_argument("--auto-grow", action="store_true", help="not ported yet")
    args = p.parse_args(argv)
    unported = [f"{what} (ROADMAP.md queue 1, {item})"
                for dest, off, what, item in _UNPORTED
                if getattr(args, dest) != off]
    if unported:
        p.error("not ported to the torch package yet: "
                + "; ".join(unported))
    if not args.input and not args.dataset:
        p.error("one of --input / --dataset is required")
    return args


def render_views(engine, model, cameras) -> list:
    """One replay of the render program per camera (eager on the CPU):
    the FrameOutputs."""
    return [engine.run(_RENDER, model, c.view, c.proj, c.env_rot)
            for c in cameras]


def run(argv=None) -> dict:
    """The body of main. Returns the run's statistics: per-step losses,
    step times (CUDA-event ms on the card, host ms on the CPU) and
    pipelined ms (host ms between consecutive step retirements, up to
    _STEPS_IN_FLIGHT queued), the capture seconds of the step program,
    the overflow and truncation of the target renders (--input) or of the
    initial model's render of each training view (--dataset) and of the
    final render, the holdout PSNR and overflow, the final loss, PSNR
    and step."""
    args = parse_args(argv)
    engine_lib.setup_logging(args.log_level)
    engine = engine_lib.RenderEngine(RuntimeConfig(device=args.device))
    device = engine.device
    on_cuda = device.type == "cuda"
    if on_cuda:
        # Full f32 matmuls and convolutions (SSIM), as the reference.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    bg = 1.0 if args.background == "white" else 0.0
    holdout_cams, holdout_targets = [], []
    init = "loaded scene"
    target_renders = None

    if args.dataset:
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
        targets = [torch.tensor(flatten_rgba(fs.images[i], bg),
                                device=device) for i in train_idx]
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
    else:
        scene = load_scene(args.input, device=device)
        extent = float(np.linalg.norm(scene.bb_max - scene.bb_min) * 0.5)
        fov = float(np.radians(40.0))
        cameras = [Camera.orbit(scene.bb_min, scene.bb_max, fov,
                                args.width / args.height,
                                rot_y_deg=360.0 * i / args.views,
                                device=device)
                   for i in range(args.views)]
        if args.mode == "distill":
            gen = torch.Generator(device=device).manual_seed(args.seed)
            model = GaussianModel.random(
                args.init_gaussians or scene.num_gaussians, generator=gen,
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
    if not args.dataset:
        log.info("rendering %d target views at %dx%d from %d gaussians",
                 args.views, args.width, args.height, scene.num_gaussians)
        with torch.no_grad():
            target_renders = [render(scene.model, cam, cfg)
                              for cam in cameras]
        targets = [out.image for out in target_renders]

    if args.sh_degree >= 0 and args.sh_degree != model.sh_degree:
        model = model.with_sh_degree(args.sh_degree)
        log.info("SH degree -> %d (%d bands)", args.sh_degree,
                 model.sh.shape[1])
    tc = trainer.TrainConfig(ssim_weight=args.ssim_weight,
                             scene_extent=extent)
    state = trainer.init_state(model.trainable(), tc)
    if args.resume:
        state = checkpoint.restore_checkpoint(args.resume, state)
        log.info("resumed from %s at step %d", args.resume, int(state.step))

    # The programs, registered after any resume: a graph updates the
    # tensors it captured. The render program reads state.params as the
    # steps leave them.
    cam0 = cameras[0]
    engine.register(_RENDER, splat_program(cfg), (
        state.params, cam0.view.clone(), cam0.proj.clone(),
        cam0.env_rot.clone()))
    if target_renders is None:
        # The pairs each training view bins at the start.
        target_renders = render_views(engine, state.params, cameras)
    target_overflow = [int(o.overflow) for o in target_renders]
    target_truncated = [int(o.truncated) for o in target_renders]
    if any(target_overflow) or any(target_truncated):
        log.warning("target renders dropped pairs: overflow %s, truncated "
                    "%s: raise --pair-capacity", target_overflow,
                    target_truncated)
    step_prog = trainer.register_step(engine, state, cam0, targets[0], cfg,
                                      tc)
    log.info("step program: %s", engine.manifest())

    order_rng = np.random.default_rng(0xC0FFEE)
    order = list(range(args.views))
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

    t0 = time.perf_counter()
    for i in range(args.steps):
        k = i % args.views
        if k == 0 and args.shuffle:
            order_rng.shuffle(order)
        if on_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        else:
            ev = time.perf_counter()
        loss = engine.run(trainer.STEP_PROGRAM, state, cameras[order[k]],
                          targets[order[k]])
        if on_cuda:
            ev[1].record()
        else:
            ev = (time.perf_counter() - ev) * 1e3
        loss_t.append(loss)
        marks.append(ev)
        inflight.append(ev)
        if len(inflight) >= _STEPS_IN_FLIGHT:
            retire()
        done = i + 1
        if (done % args.views == 0
                and (done // args.views) % _LOG_EVERY_EPOCHS == 0) \
                or done == args.steps:
            log.info("step %d: loss %.5f", done, float(loss))
    while inflight:
        retire()
    if on_cuda:
        torch.cuda.synchronize(device)
        step_ms = [a.elapsed_time(b) for a, b in marks]
    else:
        step_ms = marks
    dt = time.perf_counter() - t0
    losses_h = [float(x) for x in loss_t]
    if args.steps:
        log.info("trained %d steps in %.1fs (%.2f it/s)", args.steps, dt,
                 args.steps / dt)

    final = render_views(engine, state.params, [cam0])[0]
    psnr = float(losses.psnr(final.image[..., :3], targets[0][..., :3]))
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
    if args.checkpoint:
        checkpoint.save_checkpoint(args.checkpoint, state)
        log.info("checkpoint -> %s", args.checkpoint)
    if args.export_ply:
        checkpoint.export_ply(args.export_ply, state.params)
        log.info("scene -> %s", args.export_ply)
    if args.export_splat:
        splat_io.write_splat(args.export_splat, state.params)
        log.info("scene -> %s (.splat)", args.export_splat)
    final_loss = losses_h[-1] if losses_h else float("nan")
    tail = f" eval_psnr={eval_psnr:.2f}" if eval_psnr is not None else ""
    print(f"final_loss={final_loss:.6f} psnr={psnr:.2f}{tail}")
    return dict(losses=losses_h, step_ms=step_ms, pipelined_ms=pipelined,
                capture_seconds=step_prog.compile_seconds,
                final_loss=final_loss, psnr=psnr, eval_psnr=eval_psnr,
                step=int(state.step), init=init,
                num_gaussians=state.params.num_gaussians, views=args.views,
                holdout_views=len(holdout_cams),
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
