"""The share of a step's wall time in the window in which no kernel, copy or
fill ran on the device: the profiled steps' device busy seconds per step
against the window's seconds per step."""

from splatbench.metrics_common import idle

LAYER = "device"
MOVES = "step_ms"
UNIT = "%"


def read(r):
    return idle(r, "train")
