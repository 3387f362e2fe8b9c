"""The comparison that decides `correct`, on tiny cells on the CPU: sound
runs pass it; the control (the reference in bfloat16 in the program's
place) and each fault a cell can have, planted under the timed path, fail
it. Every other part of a run is the real one."""

from __future__ import annotations

import pytest

from _tiny import run_tiny

CELLS = ("capture1m-fit", "capture1m-orbit", "demo38k-orbit", "demo38k-fit")
# A step that returns its state unchanged; half of the batch (the image's
# rows) left out, the mean taken over the rest; an answer (a frame's value,
# a step's loss) altered where it is produced. One card: no exchange.
FAULTS = [(c, f) for c in CELLS for f in
          (("step_unchanged", "half_batch", "answer") if c.endswith("fit")
           else ("half_batch", "answer"))]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = run_tiny(cell, control="bfloat16")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_is_not_correct(cell, fault):
    out = run_tiny(cell, fault=fault)
    assert not out["correct"], out["checks"]
