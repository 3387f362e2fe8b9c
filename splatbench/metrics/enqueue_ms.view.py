"""Median host time of one RenderEngine.run call of the frames program in the
window: the harness's own span around each call (copy-in and replay)."""

from splatbench.metrics_common import enqueue_ms

LAYER = "runtime/engine.py"
MOVES = "frame_ms"
UNIT = "ms"


def read(r):
    return enqueue_ms(r, "view")
