"""Host seconds of the run's RenderEngine.register calls (the warm-ups, the
capture and, for a train program, the copy-aside of its inputs): the
program's own Tracepoint channel "engine.register" (utils/profiling.py),
totalled over the process the run took place in, one run a process. None
outside a run's reading (no items) and where the program has no such
channel."""

LAYER = "runtime/engine.py"
MOVES = "setup_s"
UNIT = "s"


def read(r):
    if not r.get("items"):
        return None
    from gaussian_splat_ipu_tpu_torch.utils import profiling
    channel = profiling.tracepoint_summary().get("engine.register")
    return channel["total_s"] if channel else None
