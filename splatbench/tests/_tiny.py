"""Tiny cells for the harness's CPU tests: the real cells of BENCHMARK.json
with their scene, image and view count cut to what the CPU's plain
versions render in seconds. The drivers, the reference, the limits and
the comparison are the real ones."""

from __future__ import annotations

import copy
import importlib.util
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from splatbench import harness  # noqa: E402

# The CPU tests run under several workers: one thread each.
torch.set_num_threads(1)

SIZES = {"capture1m-fit": (128, 96, 500), "capture1m-orbit": (128, 96, 500),
         "demo38k-fit": (96, 64, 200), "demo38k-orbit": (96, 64, 200)}


def run_module():
    spec = importlib.util.spec_from_file_location(
        "splatbench_run", os.path.join(ROOT, "splatbench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_cell(name: str):
    cell = harness.find_cell(name)
    w, h, n = SIZES[name]
    cell.config = copy.deepcopy(cell.config)
    cell.config["raster"].update(image_width=w, image_height=h)
    cell.config["scene"]["gaussians"] = n
    cell.traffic = copy.deepcopy(cell.traffic)
    if "views_per_ring" in cell.traffic:
        cell.traffic["views_per_ring"] = 3
    return cell


def run_tiny(name: str, seed: int = 2_200_000_017, seconds: float = 0.3,
             trace: bool = False, control: str = "", fault=None) -> dict:
    """One run of the tiny cell on the CPU, past the harness's look for a
    card."""
    return run_module().run_one(tiny_cell(name), seed, seconds, trace,
                                torch.device("cpu"), time.perf_counter(),
                                control=control, fault=fault)
