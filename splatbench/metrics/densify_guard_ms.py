"""Median host milliseconds of the program's span "densify.guard"
(train/densify.py: pair_demand_guard, every training view rendered and the
demand read back once) over the guards of a traced run's window and
stretch. None where the program recorded no such span."""

import statistics

LAYER = "train/densify.py"
MOVES = "step_ms"
UNIT = "ms"


def read(r):
    ms = [t for name, track, t in r.get("program_spans", ())
          if name == "densify.guard" and track == "host"]
    return statistics.median(ms) if ms else None
