"""Scene post-processing utility: inspect, prune and convert trained
scenes (torch port of gaussian_splat_ipu_tpu/app/scene_tool.py, the same
flags, defaults, log lines and --stats line):

    python -m gaussian_splat_ipu_tpu_torch.app.scene_tool --input in.ply \\
        --prune-opacity 0.005 --prune-scale 5.0 --max-sh 1 \\
        --center-flip --output out.ply [--output-splat out.splat] [--stats]

The surgery is numpy on the host: this is a file tool, not a render path.
The scene is loaded onto the card (`main(..., device="cpu")` keeps it on
the CPU), and `process` returns a model on its input model's device.
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

from gaussian_splat_ipu_tpu_torch.models.gaussians import (
    GaussianModel, center_and_flip)

log = logging.getLogger("gsplat")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="3DGS scene utility")
    p.add_argument("--input", required=True,
                   help="scene file (.ply / .xyz / .splat)")
    p.add_argument("--output", default="", help="write result as PLY")
    p.add_argument("--output-splat", default="",
                   help="write result as web-viewer .splat")
    p.add_argument("--prune-opacity", type=float, default=0.0,
                   help="drop gaussians with post-sigmoid opacity below "
                        "this (3DGS ships ~0.005)")
    p.add_argument("--prune-scale", type=float, default=0.0,
                   help="drop gaussians whose max axis scale exceeds "
                        "this many scene-extent units (floaters)")
    p.add_argument("--max-sh", type=int, default=-1,
                   help="cap the SH degree (-1 = keep)")
    p.add_argument("--center-flip", action="store_true",
                   help="centre on the centroid and flip y/z (the "
                        "reference's preprocessing, splat.cpp:92-100)")
    p.add_argument("--stats", action="store_true",
                   help="print a JSON stats line for the (processed) "
                        "scene")
    p.add_argument("--log-level", default="info")
    return p.parse_args(argv)


def scene_stats(model: GaussianModel) -> dict:
    """Host-side summary statistics of a GaussianModel."""
    if model.num_gaussians == 0:
        return {"gaussians": 0, "sh_degree": int(model.sh_degree)}
    p = model.to_numpy()
    means = p["means"]
    scales = np.exp(p["log_scales"])
    opac = 1.0 / (1.0 + np.exp(-p["opacities"]))
    return {
        "gaussians": int(model.num_gaussians),
        "sh_degree": int(model.sh_degree),
        "bb_min": [round(float(v), 4) for v in means.min(0)],
        "bb_max": [round(float(v), 4) for v in means.max(0)],
        "mean_opacity": round(float(opac.mean()), 4),
        "frac_opacity_below_0.005": round(float((opac < 0.005).mean()), 4),
        "median_scale": round(float(np.median(scales)), 6),
        "p99_scale": round(float(np.quantile(scales, 0.99)), 6),
    }


def process(model: GaussianModel, prune_opacity: float = 0.0,
            prune_scale: float = 0.0, max_sh: int = -1,
            center_flip: bool = False):
    """Apply the requested surgeries; returns (model on the input's device,
    report dict)."""
    report = {"input_gaussians": int(model.num_gaussians)}
    p = model.to_numpy()
    keep = np.ones(model.num_gaussians, bool)
    if prune_opacity > 0.0:
        opac = 1.0 / (1.0 + np.exp(-p["opacities"]))
        keep &= opac >= prune_opacity
    if prune_scale > 0.0:
        means = p["means"]
        extent = float(np.linalg.norm(means.max(0) - means.min(0)) * 0.5)
        smax = np.exp(p["log_scales"]).max(axis=1)
        keep &= smax <= prune_scale * max(extent, 1e-12)
    if not keep.all():
        idx = np.flatnonzero(keep)
        model = GaussianModel.from_numpy({k: v[idx] for k, v in p.items()},
                                         model.device)
    report["pruned"] = report["input_gaussians"] - int(keep.sum())

    if max_sh >= 0 and max_sh != model.sh_degree:
        model = model.with_sh_degree(max_sh)
    if center_flip and model.num_gaussians > 0:
        # Full rigid mirror through z (not the reference's means-only
        # display flip): Sigma' = F Sigma F^T with F = diag(1,1,-1)
        # conjugates the rotation — quat (w,x,y,z) -> (w,-x,-y,z) — and
        # real SH bands transform as Y_l^m(x,y,-z) = (-1)^(l+m) Y_l^m.
        p = model.to_numpy()
        k = p["sh"].shape[1]
        signs = np.ones(k, np.float32)
        idx = 0
        for l in range(int(np.sqrt(k))):
            for m in range(-l, l + 1):
                signs[idx] = (-1.0) ** (l + m)
                idx += 1
        model = GaussianModel.from_numpy(dict(
            means=center_and_flip(p["means"]), log_scales=p["log_scales"],
            quats=p["quats"] * np.array([1, -1, -1, 1], np.float32),
            opacities=p["opacities"], sh=p["sh"] * signs[None, :, None]),
            model.device)
    report["output_gaussians"] = int(model.num_gaussians)
    report["sh_degree"] = int(model.sh_degree)
    return model, report


def main(argv=None, *, device: str = "cuda") -> int:
    args = parse_args(argv)
    from gaussian_splat_ipu_tpu_torch.io import splat as splat_io
    from gaussian_splat_ipu_tpu_torch.io.scene import load_scene
    from gaussian_splat_ipu_tpu_torch.runtime.engine import (
        select_device, setup_logging)
    from gaussian_splat_ipu_tpu_torch.train import checkpoint
    setup_logging(args.log_level)

    # Load RAW: a file tool must not re-centre / mirror its input (the
    # render CLI's display preprocessing would silently change the
    # coordinate frame of every output artifact).
    scene = load_scene(args.input, center=False, flip_z=False,
                       device=select_device(device))
    model, report = process(scene.model,
                            prune_opacity=args.prune_opacity,
                            prune_scale=args.prune_scale,
                            max_sh=args.max_sh,
                            center_flip=args.center_flip)
    if model.num_gaussians == 0:
        log.warning("0 gaussians survive the requested pruning — "
                    "nothing useful to write")
    log.info("%s: %d -> %d gaussians (pruned %d), SH degree %d",
             args.input, report["input_gaussians"],
             report["output_gaussians"], report["pruned"],
             report["sh_degree"])
    if args.output:
        checkpoint.export_ply(args.output, model)
        log.info("scene -> %s", args.output)
    if args.output_splat:
        splat_io.write_splat(args.output_splat, model)
        log.info("scene -> %s (.splat)", args.output_splat)
    if args.stats:
        print(json.dumps(scene_stats(model)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
