"""Kernel G-bwd's bound over its device time in the profiled steps, one
launch a step: the bytes of reference/work_project.py at the memory rate,
each step's own live gaussians where the reading's work counts them
(`live_gaussians` of every profiled step), else every gaussian live, over
the seconds of the kernel by name, "project_bwd_view_kernel" where the
step asks for the view's gradient (pose refinement), else
"project_bwd_kernel". None without a traced train reading, where neither
kernel ran (the plain projection) or where both did."""

from splatbench.reference import work_project as WP

LAYER = "render/kernels/project.py"
MOVES = "step_ms"
UNIT = "%"


def read(r):
    if r.get("kind") != "train" or not r.get("profile") or not r.get("items"):
        return None
    kernels = r["profile"]["kernel_s"]
    plain = sum(s for name, s in kernels.items()
                if "project_bwd_kernel" in name)
    view = sum(s for name, s in kernels.items()
               if "project_bwd_view_kernel" in name)
    if (plain > 0.0) == (view > 0.0):
        return None
    live = [w.get("live_gaussians") for w in r.get("work") or []]
    if len(live) != r["items"] or None in live:
        live = [None] * r["items"]
    bound = sum(WP.project_bwd_bound_s(r["scene"], view > 0.0, n)
                for n in live)
    return 100.0 * bound / (plain + view)
