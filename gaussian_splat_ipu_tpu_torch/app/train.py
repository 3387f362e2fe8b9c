"""Training application: fit gaussian parameters to target views (torch
port of the single-device --input path of
gaussian_splat_ipu_tpu/app/train.py:147-918).

    python -m gaussian_splat_ipu_tpu_torch.app.train --input scene.ply \\
        --steps 200 --views 8 [--mode distill|self] [--device cuda]

Two target modes:
  distill  render the target views from the loaded scene, then train a
           fresh random initialisation toward them (known ground truth;
           reports PSNR);
  self     start from the loaded parameters and keep optimising against
           their own renders.

The targets are rendered once and stay on the device. Training is a plain
Python loop of trainer.train_step over the orbit views (the reference's
lax.scan epochs only batch TPU dispatches). The run logs the loss and
ends with the reference's `final_loss=... psnr=...` line.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.io.scene import load_scene
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.train import checkpoint, losses, trainer
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      check_supported)

log = logging.getLogger("gsplat")

_LOG_EVERY_EPOCHS = 10

# Flags of the reference CLI that this port does not carry yet: (dest,
# the value that means "off", what it is, the ROADMAP.md queue-1 item).
_UNPORTED = (
    ("dataset", "", "--dataset (posed-image datasets)",
     "Oracle, other IO and apps: io/dataset.py, io/colmap.py"),
    ("downscale", 1, "--downscale (a --dataset option)",
     "Oracle, other IO and apps: io/dataset.py"),
    ("holdout_every", 0, "--holdout-every (a --dataset option)",
     "Oracle, other IO and apps: app/eval.py"),
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
    ("export_splat", "", "--export-splat (.splat output)",
     "Oracle, other IO and apps: io/splat.py"),
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
    p.add_argument("--input", default="", help="PLY/XYZ scene")
    p.add_argument("--dataset", default="", help="not ported yet")
    p.add_argument("--downscale", type=int, default=1, help="not ported yet")
    p.add_argument("--holdout-every", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--log-level", default="info",
                   choices=list(engine_lib.LOG_LEVELS))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda = the CUDA kernels; cpu = their plain torch "
                        "versions")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the --mode distill random initialisation")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--views", type=int, default=8,
                   help="orbit camera count for the target set")
    p.add_argument("--init-gaussians", type=int, default=0,
                   help="--mode distill: random-init size (0 = same as "
                        "the scene)")
    p.add_argument("--mode", choices=["distill", "self"], default="distill")
    p.add_argument("--ssim-weight", type=float, default=0.2)
    p.add_argument("--sh-degree", type=int, default=-1,
                   help="SH capacity of the trained model (-1 = keep the "
                        "source degree; new bands start at zero)")
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
                   default="black")
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
    p.add_argument("--export-splat", default="", help="not ported yet")
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
    if not args.input:
        p.error("--input is required")
    return args


def run(argv=None) -> dict:
    """The body of main. Returns the run's statistics: per-step losses and
    step times (CUDA-event ms on the card, host ms on the CPU), the
    overflow and truncation of the target renders and the final render,
    the final loss, PSNR and step."""
    args = parse_args(argv)
    engine_lib.setup_logging(args.log_level)
    device = torch.device(args.device)
    on_cuda = device.type == "cuda"
    if on_cuda:
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        # Full f32 matmuls and convolutions (SSIM), as the reference.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    scene = load_scene(args.input, device=device)
    bg = 1.0 if args.background == "white" else 0.0
    cfg = RasterConfig(image_width=args.width, image_height=args.height,
                       pair_capacity=args.pair_capacity,
                       exact_tile_test=args.exact_tiles,
                       antialias=args.antialias, tile_group=args.tile_group,
                       rowseg_buckets=args.rowseg, background=(bg, bg, bg))
    check_supported(cfg)
    fov = float(np.radians(40.0))
    aspect = args.width / args.height
    extent = float(np.linalg.norm(scene.bb_max - scene.bb_min) * 0.5)
    cameras = [Camera.orbit(scene.bb_min, scene.bb_max, fov, aspect,
                            rot_y_deg=360.0 * i / args.views, device=device)
               for i in range(args.views)]

    log.info("rendering %d target views at %dx%d from %d gaussians",
             args.views, args.width, args.height, scene.num_gaussians)
    targets, target_overflow, target_truncated = [], [], []
    with torch.no_grad():
        for cam in cameras:
            out = render(scene.model, cam, cfg)
            targets.append(out.image)
            target_overflow.append(out.overflow)
            target_truncated.append(out.truncated)
    target_overflow = [int(x) for x in target_overflow]
    target_truncated = [int(x) for x in target_truncated]
    if any(target_overflow) or any(target_truncated):
        log.warning("target renders dropped pairs: overflow %s, truncated "
                    "%s: raise --pair-capacity", target_overflow,
                    target_truncated)

    if args.mode == "distill":
        n = args.init_gaussians or scene.num_gaussians
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = GaussianModel.random(n, generator=gen, device=device,
                                     extent=extent)
    else:
        model = scene.model
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

    order_rng = np.random.default_rng(0xC0FFEE)
    order = list(range(args.views))
    loss_t, marks = [], []
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
        state, loss = trainer.train_step(state, cameras[order[k]],
                                         targets[order[k]], cfg, tc)
        if on_cuda:
            ev[1].record()
        else:
            ev = (time.perf_counter() - ev) * 1e3
        loss_t.append(loss)
        marks.append(ev)
        done = i + 1
        if (done % args.views == 0
                and (done // args.views) % _LOG_EVERY_EPOCHS == 0) \
                or done == args.steps:
            log.info("step %d: loss %.5f", done, float(loss))
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

    with torch.no_grad():
        final = render(state.params, cameras[0], cfg)
        psnr = float(losses.psnr(final.image[..., :3], targets[0][..., :3]))
    log.info("PSNR vs target view 0: %.2f dB", psnr)
    if args.checkpoint:
        checkpoint.save_checkpoint(args.checkpoint, state)
        log.info("checkpoint -> %s", args.checkpoint)
    if args.export_ply:
        checkpoint.export_ply(args.export_ply, state.params)
        log.info("scene -> %s", args.export_ply)
    final_loss = losses_h[-1] if losses_h else float("nan")
    print(f"final_loss={final_loss:.6f} psnr={psnr:.2f}")
    return dict(losses=losses_h, step_ms=step_ms, final_loss=final_loss,
                psnr=psnr, step=int(state.step),
                target_overflow=target_overflow,
                target_truncated=target_truncated,
                final_overflow=int(final.overflow),
                final_truncated=int(final.truncated),
                num_pairs=int(final.num_pairs),
                pair_capacity=cfg.pair_capacity)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
