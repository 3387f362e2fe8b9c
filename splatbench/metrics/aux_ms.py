"""Median device milliseconds a step of the aux step's own work: the
program's spans "pose" (the delta's se3_exp and the corrected camera),
"exposure" (the affine map on the image) and "aux.adam" (the deltas' and
the maps' Adam steps) of train/aux_opt.py, summed per engine run over a
traced run's window and stretch. None where the program recorded none of
them."""

import statistics

LAYER = "train/aux_opt.py"
MOVES = "step_ms"
UNIT = "ms"
NAMES = ("pose", "exposure", "aux.adam")


def read(r):
    steps = [sum(s.get(n, 0.0) for n in NAMES)
             for s in r.get("step_spans") or () if any(n in s for n in NAMES)]
    return statistics.median(steps) if steps else None
