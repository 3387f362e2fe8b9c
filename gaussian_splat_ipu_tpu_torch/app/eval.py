"""Evaluation CLI: render a trained scene against posed images and report
PSNR / SSIM per view (torch port of gaussian_splat_ipu_tpu/app/eval.py).

    python -m gaussian_splat_ipu_tpu_torch.app.eval --input trained.ply \\
        --dataset data/lego --split holdout --holdout-every 8 \\
        [--dump renders/ [--dump-depth]] [--device cuda|cpu|points]

`app/train.py --export-ply` writes the scene; this scores it as 3DGS
papers report quality: mean PSNR / SSIM over a holdout of every K-th
frame (the Mip-NeRF360 convention), or over a transforms_test.json beside
the training json when there is one. Renders and RGBA targets are both
composited over --background. On the card each view is one replay of the
app's render program (app/main.py) with the camera copied in; --device cpu
runs the plain versions eagerly, --device points the 1-px point program on
the card. Prints one line per view and a JSON summary line last.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.app import main as app_main
from gaussian_splat_ipu_tpu_torch.io import colmap as colmap_lib
from gaussian_splat_ipu_tpu_torch.io import dataset as dataset_lib
from gaussian_splat_ipu_tpu_torch.render.pipeline import render_depth
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.train import checkpoint, losses
from gaussian_splat_ipu_tpu_torch.utils import image as image_util
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig)

log = logging.getLogger("gsplat")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gsplat-eval", description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True,
                   help="trained 3DGS PLY (app/train.py --export-ply)")
    p.add_argument("--dataset", required=True,
                   help="COLMAP capture, or transforms.json file or its "
                        "directory; a sibling transforms_test.json is "
                        "preferred when present")
    p.add_argument("--split", default="holdout",
                   choices=["holdout", "train", "all"],
                   help="holdout = every K-th view (test), train = the "
                        "complement, all = every view")
    p.add_argument("--holdout-every", type=int, default=8,
                   help="K for the holdout split (Mip-NeRF360 convention)")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--pair-capacity", type=int, default=1 << 19)
    p.add_argument("--exact-tiles", action="store_true",
                   help="exact tile-ellipse coverage test (fewer pairs)")
    p.add_argument("--tile-group", type=int, default=1,
                   help="bin pairs over KxK super-tiles")
    p.add_argument("--antialias", action="store_true",
                   help="energy-conserving lowpass: match a scene trained "
                        "with --antialias")
    p.add_argument("--background", default="black",
                   choices=["black", "white"],
                   help="composite both render and RGBA targets over this")
    p.add_argument("--dump", default="",
                   help="directory for per-view rendered PNGs")
    p.add_argument("--dump-depth", action="store_true",
                   help="with --dump: also write normalised depth maps "
                        "(render_depth: alpha-composited mean depth)")
    p.add_argument("--device", default="cuda",
                   choices=["cuda", "cpu", "points"],
                   help="cuda = the CUDA kernels, each view a CUDA-graph "
                        "replay; cpu = their plain torch versions; points "
                        "= 1-px point splats on the card")
    p.add_argument("--log-level", default="info",
                   choices=list(engine_lib.LOG_LEVELS))
    return p


def select_split(n: int, split: str, k: int):
    """Frame indices of a split: holdout = {0, k, 2k, ...}, train = the
    rest, all = every frame."""
    if split == "all":
        return list(range(n))
    hold = set(range(0, n, max(k, 1)))
    if split == "holdout":
        return sorted(hold)
    return [i for i in range(n) if i not in hold]


def load_frames(path: str, downscale: int = 1, max_frames=None, *, device):
    """A posed-image set -> (FrameSet, sfm_xyz, sfm_rgb): a COLMAP capture
    when `path` is a directory with a sparse model (with its SfM cloud),
    else a transforms.json set (no cloud: None, None)."""
    if os.path.isdir(path) and colmap_lib.is_colmap_dir(path):
        return colmap_lib.load_colmap(path, downscale=downscale,
                                      max_frames=max_frames, device=device)
    return (dataset_lib.load_transforms(path, downscale=downscale,
                                        max_frames=max_frames,
                                        device=device), None, None)


def flatten_rgba(image: np.ndarray, bg: float) -> np.ndarray:
    """The RGB of a dataset image: straight-alpha RGBA is composited over
    the background `bg`."""
    im = np.asarray(image, np.float32)
    if im.shape[-1] == 4:
        a = im[..., 3:4]
        im = im[..., :3] * a + bg * (1.0 - a)
    return im


def run(argv=None) -> dict:
    """The body of main; returns the JSON summary plus the per-view rows
    (index, PSNR, SSIM)."""
    args = build_parser().parse_args(argv)
    engine_lib.setup_logging(args.log_level)
    engine = engine_lib.RenderEngine(RuntimeConfig(
        device="cpu" if args.device == "cpu" else "cuda"))
    device = engine.device
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # A transforms_test.json beside the training json is the test split.
    ds_path = args.dataset
    if os.path.isdir(ds_path):
        test_json = os.path.join(ds_path, "transforms_test.json")
        if os.path.exists(test_json) and args.split != "train":
            ds_path = test_json
            args.split = "all"
    fs, _, _ = load_frames(ds_path, args.downscale, args.max_frames,
                           device=device)
    idxs = select_split(len(fs), args.split, args.holdout_every)
    if not idxs:
        raise SystemExit("split selected zero views")

    model = checkpoint.import_ply(args.input, device=device)
    cfg = RasterConfig(image_width=fs.width, image_height=fs.height,
                       pair_capacity=args.pair_capacity,
                       exact_tile_test=args.exact_tiles,
                       tile_group=args.tile_group, antialias=args.antialias)
    log.info("eval: %d gaussians, %d/%d views (%s), %dx%d",
             model.num_gaussians, len(idxs), len(fs), args.split, fs.width,
             fs.height)
    bg = 1.0 if args.background == "white" else 0.0
    points = args.device == "points"
    program = (app_main.points_program(cfg) if points
               else app_main.splat_program(cfg))
    cam0 = fs.cameras[idxs[0]]
    engine.register("render", program, (model, cam0.view.clone(),
                                        cam0.proj.clone(),
                                        cam0.env_rot.clone()))
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)

    rows = []
    for i in idxs:
        cam = fs.cameras[i]
        img = engine.run("render", model, cam.view, cam.proj,
                         cam.env_rot).image
        # Splat renders are composited over transparent: put them on the
        # targets' background. The point program draws on black.
        pred = img[..., :3] if points else (img[..., :3]
                                            + bg * (1.0 - img[..., 3:4]))
        target = torch.tensor(flatten_rgba(fs.images[i], bg), device=device)
        p = float(losses.psnr(pred, target))
        s = float(losses.ssim(pred, target))
        rows.append((i, p, s))
        log.info("view %4d: psnr %6.2f dB  ssim %.4f", i, p, s)
        if args.dump:
            image_util.write_png(
                os.path.join(args.dump, f"eval_{i:05d}.png"),
                pred.cpu().numpy())
            if args.dump_depth and not points:
                with torch.inference_mode():
                    mean_d, _, a = render_depth(model, cam, cfg)
                d, a = mean_d.cpu().numpy(), a.cpu().numpy()
                hi_d = (np.percentile(d[a > 0.5], 99.0)
                        if float(a.max()) > 0.5 else 1.0)
                image_util.write_png(
                    os.path.join(args.dump, f"depth_{i:05d}.png"),
                    np.clip(d / max(hi_d, 1e-6), 0.0, 1.0))

    summary = {
        "views": len(rows), "split": args.split,
        "mean_psnr": round(float(np.mean([r[1] for r in rows])), 4),
        "mean_ssim": round(float(np.mean([r[2] for r in rows])), 6),
        "min_psnr": round(min(r[1] for r in rows), 4),
        "gaussians": model.num_gaussians,
    }
    print(json.dumps(summary))
    return dict(summary, rows=rows)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
