"""The share of its traced stretch a card spends in NCCL's kernels
(names holding "nccl"), waits for a slower peer included, on the card
where it is largest: each rank's seconds in those kernels over its
stretch's window (the device.collective_s_by_card of the line over
device.window_s_by_card). None without a traced reading of several
ranks."""

LAYER = "parallel/multihost.py / NCCL"
MOVES = "step_ms"
UNIT = "%"


def read(r):
    shares = []
    for layer in r.get("by_rank") or ():
        prof = (layer or {}).get("profile") or {}
        if prof.get("window_s"):
            nccl = sum(s for name, s in prof["kernel_s"].items()
                       if "nccl" in name.lower())
            shares.append(100.0 * nccl / prof["window_s"])
    return max(shares) if len(shares) > 1 else None
