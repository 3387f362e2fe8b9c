"""Application entry point: the headless render loop (torch port of
gaussian_splat_ipu_tpu/app/main.py:186-447).

Loads a scene, fits an orbit camera to its bounds, renders --frames orbit
frames on the chosen device with up to two frames in flight, logs the
per-frame time and the overflow / truncation telemetry, and writes the
last frame as a PNG.

Run:  python -m gaussian_splat_ipu_tpu_torch.app.main --input scene.ply
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import time

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.io.scene import load_scene
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.render.binning import bin_splats
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.render.projection import project_gaussians
from gaussian_splat_ipu_tpu_torch.utils import image as image_util
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      check_supported)

log = logging.getLogger("gsplat")

_LEVELS = {"trace": logging.DEBUG, "debug": logging.DEBUG,
           "info": logging.INFO, "warn": logging.WARNING,
           "err": logging.ERROR, "off": logging.CRITICAL}
_TELEMETRY_EVERY = 30   # frames between overflow reads and timing logs
_FRAMES_IN_FLIGHT = 2


def parse_args(argv=None):
    """Flags of the reference CLI that the port carries, same defaults."""
    p = argparse.ArgumentParser(
        description="CUDA gaussian splat renderer (PyTorch port)")
    p.add_argument("--input", "-o", required=True,
                   help="PLY or XYZ scene file")
    p.add_argument("--log-level", default="info", choices=list(_LEVELS))
    p.add_argument("--device", default="cuda",
                   choices=["cuda", "cpu", "points"],
                   help="cuda = the CUDA kernels; cpu = their plain torch "
                        "versions; points is not ported yet")
    p.add_argument("--ui-port", type=int, default=0,
                   help="remote UI port; not ported yet (0 = headless)")
    p.add_argument("--distributed", type=int, default=0, metavar="N",
                   help="multi-device rendering; not ported yet")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--fov", type=float, default=40.0, help="degrees")
    p.add_argument("--frames", type=int, default=0,
                   help="render N orbit frames then exit (0 = one frame)")
    p.add_argument("--output", default="test.png",
                   help="final frame dump")
    p.add_argument("--dump-frames", default="",
                   help="directory to write every frame as "
                        "frame_%%05d.png")
    p.add_argument("--pair-capacity", type=int, default=1 << 19,
                   help="(gaussian, tile) pair-table size. 0 = probe the "
                        "worst demand over an orbit and right-size")
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
    p.add_argument("--strict-termination", action="store_true",
                   help="exact reference break semantics. Default off: "
                        "the relaxed kernel is colour-identical and only "
                        "the alpha channel may exceed the strict value by "
                        "<= eps/(1-alpha_clamp)")
    args = p.parse_args(argv)
    unported = [msg for bad, msg in (
        (args.device == "points", "--device points (the 1-px point "
                                  "renderer)"),
        (args.ui_port != 0, "--ui-port (the remote UI server)"),
        (args.distributed > 1, "--distributed (multi-device rendering)"),
    ) if bad]
    if unported:
        p.error("not ported to the torch package yet: "
                + ", ".join(unported))
    return args


def _auto_pair_capacity(scene, width: int, height: int, fov: float,
                        device, views: int = 8,
                        probe_cap: int = 1 << 21) -> int:
    """Probe the worst (gaussian, tile) pair demand over an orbit with the
    default binning, growing the probe table until nothing overflows, and
    return 1.3x that, chunk-aligned (every binning pass is O(capacity))."""
    aspect = width / height
    while True:
        cfg = RasterConfig(image_width=width, image_height=height,
                           pair_capacity=probe_cap)
        worst = 0
        for i in range(views):
            cam = Camera.orbit(scene.bb_min, scene.bb_max, fov, aspect,
                               rot_y_deg=360.0 * i / views,
                               device="cpu").to(device)
            b = bin_splats(project_gaussians(scene.model, cam, cfg), cfg)
            worst = max(worst, int(b.num_pairs + b.overflow))
        if worst <= probe_cap or probe_cap >= 1 << 24:
            break
        probe_cap *= 4
    cap = max(int(worst * 1.3), 4 * cfg.chunk_size)
    return -(-cap // cfg.chunk_size) * cfg.chunk_size


def run(argv=None) -> dict:
    """The body of main: render the frames and return their statistics —
    frame_ms (device time per frame on CUDA, host time on CPU), and the
    last frame's overflow, truncated and num_pairs."""
    args = parse_args(argv)
    logging.basicConfig(level=_LEVELS[args.log_level],
                        format="[%(asctime)s] [%(levelname)s] %(message)s",
                        datefmt="%H:%M:%S")
    device = torch.device(args.device)
    on_cuda = device.type == "cuda"
    if on_cuda:
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        # Full f32 matmuls, as the reference's HIGHEST precision.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with torch.inference_mode():
        scene = load_scene(args.input, device=device)
        model = scene.model
        n = model.num_gaussians
        log.info("loaded %d gaussians from %s", n, args.input)
        fov = float(np.radians(args.fov))
        aspect = args.width / args.height
        if args.pair_capacity == 0:
            args.pair_capacity = _auto_pair_capacity(
                scene, args.width, args.height, fov, device)
            log.info("auto pair capacity: %d", args.pair_capacity)
        cfg = RasterConfig(image_width=args.width, image_height=args.height,
                           pair_capacity=args.pair_capacity,
                           exact_tile_test=args.exact_tiles,
                           antialias=args.antialias,
                           tile_group=args.tile_group,
                           rowseg_buckets=args.rowseg,
                           strict_termination=args.strict_termination)
        check_supported(cfg)
        if args.dump_frames:
            os.makedirs(args.dump_frames, exist_ok=True)

        nframes = max(args.frames, 1)
        inflight = collections.deque()
        frame_ms = []
        last = None

        def retire_one():
            nonlocal last
            out, ev0, ev1, host_ms = inflight.popleft()
            k = len(frame_ms)
            if on_cuda:
                ev1.synchronize()
                frame_ms.append(ev0.elapsed_time(ev1))
            else:
                frame_ms.append(host_ms)
            if k % _TELEMETRY_EVERY == 0:
                ovf, trc = int(out.overflow), int(out.truncated)
                if ovf or trc:
                    log.warning("frame %d: dropped splat pairs (overflow=%d "
                                "over --pair-capacity, truncated=%d past the "
                                "per-tile work bound)", k, ovf, trc)
                log.info("frame %d: %.3f ms (%d pairs)", k, frame_ms[-1],
                         int(out.num_pairs))
            if args.dump_frames:
                image_util.write_png(
                    os.path.join(args.dump_frames, f"frame_{k:05d}.png"),
                    out.image.cpu().numpy())
            last = out

        for i in range(nframes):
            cam = Camera.orbit(scene.bb_min, scene.bb_max, fov, aspect,
                               rot_y_deg=360.0 * i / nframes,
                               device="cpu").to(device, non_blocking=True)
            ev0 = ev1 = None
            t0 = time.perf_counter()
            if on_cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            out = render(model, cam, cfg)
            if on_cuda:
                ev1.record()
            inflight.append((out, ev0, ev1,
                             (time.perf_counter() - t0) * 1e3))
            if len(inflight) >= _FRAMES_IN_FLIGHT:
                retire_one()
        while inflight:
            retire_one()

        image_util.write_png(args.output, last.image.cpu().numpy())
        stats = dict(frames=nframes, frame_ms=frame_ms,
                     median_ms=float(np.median(frame_ms)),
                     overflow=int(last.overflow),
                     truncated=int(last.truncated),
                     num_pairs=int(last.num_pairs),
                     pair_capacity=cfg.pair_capacity)
    log.info("wrote %s; median frame %.3f ms over %d frames, overflow=%d, "
             "truncated=%d, num_pairs=%d", args.output, stats["median_ms"],
             nframes, stats["overflow"], stats["truncated"],
             stats["num_pairs"])
    return stats


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
