"""The share of a frame's wall time in the window in which no kernel, copy or
fill ran on the device: the profiled frames' device busy seconds per frame
against the window's seconds per frame."""

from splatbench.metrics_common import idle

LAYER = "device"
MOVES = "frame_ms"
UNIT = "%"


def read(r):
    return idle(r, "view")
