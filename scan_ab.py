#!/usr/bin/env python3
"""Kernel E of the PyTorch + CUDA port (the row scan, csrc/scan.cu) at
several tile shapes, in turns, on one NVIDIA GPU.

    python3 scan_ab.py [--reps 20]

Builds csrc/scan.cu once for each (threads, elements a thread) of
VARIANTS (-DGSPLAT_SCAN_THREADS / -DGSPLAT_SCAN_ITEMS, all nvcc processes
at once). Each build is held to the plain version
(scan.row_cumsum_exclusive_torch), exactly, at every shape of SHAPES: one
element, rows shorter than a tile, N not a multiple of 4, a row start
that is not 16-B aligned, more tiles than the card holds at once, the
rowseg 1M shape (9, 2^20) and sums that wrap i32. Then each is timed at
(9, 2^20) by chip_smoke.DeviceTimer (device time only), in turns: v1 ...
vk, vk ... v1. One JSON line per build and per timing, then the card's
name and power limit. (chip_smoke.py --old DIR times the default tile
against an earlier scan.cu.)
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke as smoke

# (threads a CTA, elements a thread); the source's default is the first.
VARIANTS = ((128, 64), (128, 32), (256, 32), (512, 16), (1024, 8), (256, 16))
RS_SHAPE = (9, 1 << 20)
# (R, N, low, high, offset): counts drawn from [low, high), the row start
# `offset` elements past a 16-B aligned address.
SHAPES = ((1, 1, 0, 9, 0), (1, 5, 0, 9, 0), (3, 2047, 0, 9, 0),
          (3, 2049, 0, 9, 0), (2, 3 * 8192 + 5, 0, 9, 0),
          (2, 3 * 8192 + 8, 0, 9, 1), (4, 37_941, 0, 9, 0),
          (3, 1 << 22, 0, 9, 0), (*RS_SHAPE, 0, 9, 0),
          (2, 5000, 1 << 28, 1 << 30, 0))


def inputs(dev):
    """Each shape of SHAPES as a contiguous (R, N) i32 tensor on dev."""
    import torch
    rng = np.random.default_rng(0)
    out = []
    for r, n, lo, hi, off in SHAPES:
        flat = torch.empty(r * n + off, dtype=torch.int32, device=dev)
        x = flat[off:].view(r, n)
        x.copy_(torch.from_numpy(rng.integers(lo, hi, (r, n),
                                              dtype=np.int32)))
        out.append(x)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("no CUDA GPU")
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib, scan

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    src = os.path.join(cuda_lib.CSRC_DIR, "scan.cu")
    names = ("gsplat_row_cumsum_scratch_words", "gsplat_row_cumsum_exclusive")
    sig = {k: cuda_lib._SIGNATURES[k] for k in names}
    out_dir = tempfile.mkdtemp(prefix="gsplat_scan_ab_")
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = {f"{t}x{k}": pool.submit(
            smoke.build_lib, [src], out_dir, sig,
            (f"-DGSPLAT_SCAN_THREADS={t}", f"-DGSPLAT_SCAN_ITEMS={k}"))
            for t, k in VARIANTS}
        libs = {}
        for k, fut in built.items():
            libs[k], log = fut.result()
            smoke.say("build", variant=k,
                      ptxas=smoke.ptxas_lines(log, "row_scan"))

    def call(key, x):
        """scan.row_cumsum_exclusive's launch, on the build `key`."""
        lib = libs[key]
        out = torch.empty_like(x)
        scratch = torch.empty(lib.gsplat_row_cumsum_scratch_words(*x.shape),
                              dtype=torch.int64, device=dev)
        cuda_lib.check(f"{key} row_cumsum_exclusive",
                       lib.gsplat_row_cumsum_exclusive(
                           x.data_ptr(), *x.shape, out.data_ptr(),
                           scratch.data_ptr(), cuda_lib.stream_handle(dev)))
        return out

    xs = inputs(dev)
    for x, shape in zip(xs, SHAPES):
        ref = scan.row_cumsum_exclusive_torch(x)
        for key in libs:
            smoke.exact_err(f"{key} at {shape}", ("excl",),
                            (call(key, x),), (ref,))
        torch.cuda.synchronize()
    smoke.say("equal", shapes=[list(s) for s in SHAPES], builds=list(libs))

    x = xs[SHAPES.index((*RS_SHAPE, 0, 9, 0))]
    timer = smoke.DeviceTimer()
    times = {k: [] for k in libs}
    for key in list(libs) + list(libs)[::-1]:
        times[key].append(timer.ms(lambda key=key: call(key, x),
                                   reps=args.reps, label=key))
    bound_ms = 2 * x.numel() * 4 / smoke.PEAK_BYTES_S * 1e3
    for key, ms in times.items():
        smoke.say("time", variant=key, shape=list(x.shape), ms=ms,
                  bound_ms=bound_ms, share=bound_ms / float(np.median(ms)))
    smoke.say("timer", **timer.summary())
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
