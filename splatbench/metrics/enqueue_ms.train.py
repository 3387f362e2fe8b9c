"""Median host time of one RenderEngine.run call of the step program in the
window: the harness's own span around each call (copy-in and replay)."""

from splatbench.metrics_common import enqueue_ms

LAYER = "runtime/engine.py"
MOVES = "step_ms"
UNIT = "ms"


def read(r):
    return enqueue_ms(r, "train")
