"""Median device milliseconds per step of the splat exchange, forward and
backward, on the slowest rank: the program's spans "exchange" (packing,
routing and the all_to_all) and "exchange.bwd" (the inverse all_to_all
and the routing gather's transpose) of parallel/distributed.py, summed per
step of each rank's traced stretch; the largest of the ranks' medians.
None where no rank recorded either span."""

import statistics

LAYER = "parallel/distributed.py"
MOVES = "step_ms"
UNIT = "ms"
NAMES = ("exchange", "exchange.bwd")


def read(r):
    medians = []
    for layer in r.get("by_rank") or [r]:
        steps = [sum(s.get(n, 0.0) for n in NAMES)
                 for s in (layer or {}).get("step_spans") or ()
                 if any(n in s for n in NAMES)]
        if steps:
            medians.append(statistics.median(steps))
    return max(medians) if medians else None
