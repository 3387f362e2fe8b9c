"""Kernel C's bound over its device time in the profiled frames, the bound
from the work model and the reference's pairs and live evaluations."""

from splatbench.metrics_common import roofline

LAYER = "render/kernels/rasterize.py"
MOVES = "frame_ms"
UNIT = "%"


def read(r):
    return roofline(r, "view", "rasterize_fwd_kernel")
