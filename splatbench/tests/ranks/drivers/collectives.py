"""The `collectives` traffic of the harness's multi-rank fixture (a fixture
of run.py's launch and merge, not a cell of BENCHMARK.json).

Every rank joins the program's process group through
parallel/multihost.initialize, from the GSPLAT_* variables run.py sets, as
app/train.py does, and then runs rounds of one all_reduce and one
all_to_all_single of float32 tensors of the config's sizes, on its own
device. Rank 0 ends the window: it raises a flag, carried as the last
element of the all_reduce, once `--seconds` have passed, so every rank runs
the same rounds. Each round reads the flag back on the host.

Correct: the group's backend is NCCL on cards (gloo on the CPU),
multihost.process_device() is the rank's own device and the group's rank
and size are run.py's, and every round's sum and exchanged chunk is exact:
the values are whole numbers under 2**24, so float32 sums carry no
rounding. --fault answer alters one value of the last rank's sum.

The traffic's `end_rank`, `end_after_rounds` and `end_by` ("exit": exit
code 1; "kill": SIGKILL) end that rank in the middle of the window, while
the others wait in a collective: the run must then end non-zero, with no
rank left.
"""

from __future__ import annotations

import os
import signal
import statistics
import sys
import time

import torch

from splatbench import harness


def _end(how: str):
    print(f"ending this rank ({how}) at unix time {time.time():.3f}",
          file=sys.stderr, flush=True)
    if how == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    os._exit(1)


def run(ctx) -> dict:
    import torch.distributed as dist

    from gaussian_splat_ipu_tpu_torch.parallel import multihost

    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    if ctx.fault not in (None, "answer"):
        raise ValueError(f"the collectives fixture has no fault {ctx.fault}")
    if not multihost.initialize(device=dev.type):
        raise RuntimeError("GSPLAT_COORDINATOR is not set: the fixture runs "
                           "on several ranks")
    world, rank = multihost.process_count(), multihost.process_index()
    backend = dist.get_backend()
    readings = {
        "backend_mismatch": float(
            backend != ("nccl" if dev.type == "cuda" else "gloo")),
        "device_mismatch": float(multihost.process_device(dev.type) != dev),
        "rank_mismatch": float((rank, world) != (ctx.rank, ctx.world)),
    }

    def whole(n):
        return torch.arange(n, device=dev, dtype=torch.float32) % 997

    n_ar = int(cfg["all_reduce_bytes"]) // 4
    ar_base = whole(n_ar) + 1000.0 * rank
    ar_want = world * whole(n_ar - 1) + 1000.0 * world * (world - 1) / 2
    chunk = int(cfg["all_to_all_bytes"]) // 4 // world
    ks = whole(chunk)
    a2a_base = torch.cat([ks + 1000.0 * rank + 10.0 * j
                          for j in range(world)])
    a2a_want = torch.cat([ks + 1000.0 * s + 10.0 * rank
                          for s in range(world)])
    a2a_out = torch.empty_like(a2a_base)
    err_ar = torch.zeros((), device=dev)
    err_a2a = torch.zeros((), device=dev)
    bad = torch.zeros((), device=dev, dtype=torch.int64)
    end_rank = traffic.get("end_rank")

    def one_round(t, flag):
        nonlocal err_ar, err_a2a, bad
        x = ar_base + float(t)
        x[-1] = flag
        dist.all_reduce(x)
        if ctx.fault == "answer" and rank == world - 1:
            x[0] += 0.5
        d_ar = (x[:-1] - (ar_want + world * float(t))).abs().max()
        dist.all_to_all_single(a2a_out, a2a_base + float(t))
        d_a2a = (a2a_out - (a2a_want + float(t))).abs().max()
        err_ar = torch.maximum(err_ar, d_ar)
        err_a2a = torch.maximum(err_a2a, d_a2a)
        bad += ((d_ar > 0) | (d_a2a > 0)).long()
        return x[-1]

    t = 0
    for _ in range(int(traffic["warmup_rounds"])):
        one_round(t, 0.0).item()
        t += 1
    spans, round_s = ctx.spans, []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    rounds = 0
    while True:
        if rank == end_rank and rounds == traffic["end_after_rounds"]:
            _end(traffic["end_by"])
        ts = time.perf_counter()
        flag = 1.0 if rank == 0 and ts >= deadline else 0.0
        with spans("round"):
            stop = one_round(t, flag).item() > 0
        round_s.append(time.perf_counter() - ts)
        t += 1
        rounds += 1
        if stop:
            break
    t_end = time.perf_counter()
    failed = min(int(bad), rounds)
    prof = {}
    n_prof = int(traffic["profiled_rounds"]) if ctx.trace else 0
    if n_prof:
        with harness.profiled(prof, spans):
            for _ in range(n_prof):
                with spans("round"):
                    one_round(t, 0.0).item()
                t += 1
    readings["allreduce_err"] = float(err_ar)
    readings["alltoall_err"] = float(err_a2a)
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = sum(v.numel() * v.element_size() for v in (
            ar_base, ar_want, a2a_base, a2a_want, a2a_out))
    dist.destroy_process_group()
    round_ms = (t_end - t0) * 1e3 / rounds
    return dict(
        attempted=rounds, failed=failed, readings=readings, checked=t,
        e2e={"setup_s": t0 - ctx.t_start, "round_ms": round_ms},
        layer=dict(kind="collectives", profile=prof, items=n_prof,
                   round_ms=statistics.median(round_s) * 1e3),
        memory_peak_bytes=int(peak),
        info=dict(backend=backend, device=str(dev),
                  gsplat_process_id=os.environ.get("GSPLAT_PROCESS_ID"),
                  rounds=rounds, all_reduce_elements=n_ar,
                  all_to_all_elements=chunk * world, round_ms=round_ms))
