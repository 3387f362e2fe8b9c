"""Kernel D's bound over its device time in the profiled steps, from the work
model and the reference's pairs and live evaluations."""

from splatbench.metrics_common import roofline

LAYER = "render/kernels/rasterize.py"
MOVES = "step_ms"
UNIT = "%"


def read(r):
    return roofline(r, "train", "rasterize_bwd_kernel")
