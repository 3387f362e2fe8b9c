"""Arithmetic the per-layer metric readers share. Each reader
(metrics/<metric>.py) takes the run's reading `r`: kind ("view" or
"train"), enqueue_s (host seconds of each engine call in the window),
profile (harness.read_profile of the profiled stretch; empty without
--trace 1), work (the reference's counts of each profiled frame or step),
items (how many were profiled), item_s (the window's wall seconds per
frame or step, on the host's clock), rc and scene (the config's raster
and scene settings) and ssim_weight. A reader returns None where it finds
nothing to read; a share is never made up as 0.

Tracing slows the host's side of a stretch (each CUDA-graph launch under
the profiler costs about a millisecond more), so the stretch's own wall
time overstates the window's. Shares of wall time therefore take the
device's work per frame or step from the stretch and the wall time per
frame or step from the window of the same run."""

from __future__ import annotations

import statistics

from splatbench.reference import work as W


def enqueue_ms(r, kind):
    if r["kind"] != kind or not r["enqueue_s"]:
        return None
    return statistics.median(r["enqueue_s"]) * 1e3


def _profiled(r, kind):
    return r["kind"] == kind and r["profile"] and r["work"] \
        and len(r["work"]) == r["items"] and r.get("item_s")


def mfu(r, kind):
    if not _profiled(r, kind):
        return None
    if kind == "view":
        ops = sum(W.frame_ops(w, r["scene"]) for w in r["work"])
    else:
        ops = sum(W.step_ops(w, r["scene"], r["rc"], r["ssim_weight"])
                  for w in r["work"])
    return 100.0 * ops / r["items"] / r["item_s"] / W.PEAK_OPS_S


def kernel_s(r, key):
    return sum(s for name, s in r["profile"]["kernel_s"].items()
               if key in name)


def roofline(r, kind, key):
    if not _profiled(r, kind):
        return None
    t = kernel_s(r, key)
    if t <= 0.0:
        return None
    if key == "rasterize_bwd_kernel":
        bound = sum(W.raster_bwd_bound_s(w, r["rc"]) for w in r["work"])
    else:
        bound = sum(W.raster_fwd_bound_s(w, r["rc"], kind == "train")
                    for w in r["work"])
    return 100.0 * bound / t


def idle(r, kind):
    """The share of the window's wall time per frame or step in which the
    device ran nothing: 1 - (the stretch's busy seconds per item) over
    (the window's seconds per item)."""
    if not _profiled(r, kind):
        return None
    return 100.0 * (1.0 - r["profile"]["busy_s"] / r["items"] / r["item_s"])
