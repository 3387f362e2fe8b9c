"""The profiled steps' operations per step (forward, loss, backward and Adam,
from the reference's counts of those steps) over the window's seconds per
step, against 67 TFLOP/s FP32."""

from splatbench.metrics_common import mfu

LAYER = "step program: train/trainer.py::register_step"
MOVES = "step_ms"
UNIT = "%"


def read(r):
    return mfu(r, "train")
