"""Kernel C's (with contributor counts) bound over its device time in the
profiled steps, from the work model and the reference's counts."""

from splatbench.metrics_common import roofline

LAYER = "render/kernels/rasterize.py"
MOVES = "step_ms"
UNIT = "%"


def read(r):
    return roofline(r, "train", "rasterize_fwd_kernel")
