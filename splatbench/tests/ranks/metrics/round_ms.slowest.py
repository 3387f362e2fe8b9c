"""The slowest rank's median round (one all_reduce and one all_to_all,
the flag read back on the host), in host milliseconds: the collectives
wait for the slowest rank, so it sets the round."""

LAYER = "parallel/multihost.py"
MOVES = "round_ms"
UNIT = "ms"


def read(r):
    ranks = [x["round_ms"] for x in r.get("by_rank") or []
             if x and x.get("round_ms")]
    return max(ranks) if ranks else None
