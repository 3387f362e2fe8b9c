"""The profiled frames' operations per frame (the work model's, from the
reference's counts of those frames) over the window's seconds per frame,
against 67 TFLOP/s FP32."""

from splatbench.metrics_common import mfu

LAYER = "frame program: render/pipeline.py via app/main.splat_program"
MOVES = "frame_ms"
UNIT = "%"


def read(r):
    return mfu(r, "view")
