"""How far the slowest rank's strip work stands above the ranks' mean: per
rank the median device milliseconds per step of the program's spans
"strip.bin", "strip.raster" (kernel C) and "strip.raster.bwd" (kernel D)
of parallel/distributed.py over its traced stretch; the largest of these
over their mean (1 when the strips take equal time). None where fewer
than two ranks recorded them."""

import statistics

LAYER = "parallel/distributed.py strips"
MOVES = "step_ms"
UNIT = "ratio"
NAMES = ("strip.bin", "strip.raster", "strip.raster.bwd")


def read(r):
    medians = []
    for layer in r.get("by_rank") or [r]:
        steps = [sum(s.get(n, 0.0) for n in NAMES)
                 for s in (layer or {}).get("step_spans") or ()
                 if any(n in s for n in NAMES)]
        if steps:
            medians.append(statistics.median(steps))
    if len(medians) < 2 or statistics.mean(medians) <= 0.0:
        return None
    return max(medians) / statistics.mean(medians)
