"""Median device milliseconds of the program's span "densify.event"
(train/densify.py: densify_and_prune, from the stamp before the event's
first kernel to the one after its last) over the events of a traced run's
window and stretch. None where the program recorded no such span."""

import statistics

LAYER = "train/densify.py"
MOVES = "step_ms"
UNIT = "ms"


def read(r):
    ms = [t for name, track, t in r.get("program_spans", ())
          if name == "densify.event" and track == "device"]
    return statistics.median(ms) if ms else None
