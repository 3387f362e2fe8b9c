"""The `sharded_fit` traffic: the train CLI's multi-process --distributed
step in a closed loop, one process (rank) per card (app/train.py's process
mesh path).

Every rank joins the process group through the program's own contract
(parallel/multihost.initialize, from the GSPLAT_* environment the harness
sets), makes its shard of the config's city scene (splatbench/city.py,
rows [r N / W, (r + 1) N / W) from (seed, r)), the fit's start from it
perturbed as traffic `perturb` says, and the drone cameras. The capacity
is the config's factor times the worst whole-frame pair demand of the
ground truth and the start over every view: each rank counts its rows'
pairs with the program's footprints and the counts are summed over the
ranks. The targets are the program's sharded renders of the ground truth,
gathered on every rank. The step is
parallel/distributed.make_sharded_train_step on
multihost.make_process_mesh, registered with trainer.register_step and run
eagerly, as app/train.py registers it; it returns the frame's drop
counters beside the loss. Up to `in_flight` steps are outstanding; the
oldest is retired by reading its loss on the host. Views are visited in a
fresh order drawn from the seed each epoch, the same on every rank. Rank 0
decides when the window closes: after each step it writes go or stop
under the step's number in the process group's store, and every rank
reads it there before its next step, so all ranks run the same steps.

Correct: set-up drives the step through its first `checked_steps` steps
on the first views of the first epoch. Each rank takes the squared norms
of its rows' first gradient (Adam's first moment after step 1 over 1 -
b1) and of its rows' change after the last step, by field; the sums over
the ranks go to rank 0. Once the window has closed and rank 0's program
is released, rank 0 runs the plain reference (reference/sharded_fit.py)
on the whole model: the checked views' targets and the same steps from
the same start. Compared as the fit cells compare: the targets
(`target_rel_l2`), each step's loss (`loss_gap`), each field's gradient
norm (`grad_gap`) and change norm (`change_gap`), each over all rows.
Every rank checks its own steps: a finite loss and no dropped pairs,
rows or truncation; a window step that fails counts in `failed`.

A traced run records the program's spans and counters (utils/profiling.py)
over one more epoch after the window, through the window's own loop,
under the profiler: each rank's reading holds, per step, the device ms of
the spans of parallel/distributed.py and the counters.

Set-up faults for setting the limits (never in a benchmark run): the
environment variable CITY_FAULT plants one of `row_lo` (strip 1 bins the
tile rows one below its own), `cotangent_sum` (the image gather's
backward sums the ranks' cotangents instead of keeping this rank's) or
`half_buckets` (the exchange buckets hold half the worst demand).
"""

from __future__ import annotations

import collections
import inspect
import math
import os
import statistics
import time

import torch

from splatbench import city, harness, inputs
from splatbench.drivers import fit
from splatbench.reference import sharded_fit as refs

FIELDS = city.FIELDS
SPANS = ("shard.project", "exchange", "exchange.bwd", "strip.bin",
         "strip.raster", "strip.raster.bwd", "gather", "gather.bwd")
COUNTERS = ("exchange.rows_sent", "exchange.bucket_rows", "strip.pairs")
FAULTS = ("row_lo", "cotangent_sum", "half_buckets")
EAGER = ("its shards are processes: a collective across processes is not "
         "captured in a CUDA graph")


def _all_sum(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist
    dist.all_reduce(x)
    return x


def _all_max(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


def shard_demand(shard: dict, cams, cfg) -> torch.Tensor:
    """(views,) int64 pair demand of this shard's rows at each camera,
    counted by the program's footprints (harness.probe_capacity's count)."""
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import binning
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    model = GaussianModel(*(shard[k] for k in FIELDS))
    with torch.no_grad():
        return torch.stack([binning.footprints(project_gaussians(
            model, Camera(*cam), cfg), cfg).ncov.sum(dtype=torch.int64)
            for cam in cams])


def capacity(config: dict, param_sets, cams) -> int:
    """The config's capacity rule over the whole model
    (harness.probe_capacity's): the worst whole-frame demand (every rank's
    rows summed) of any of this rank's parameter sets at any camera,
    times the factor, chunk-aligned."""
    cfg = harness.raster_config(config, 1 << 24)
    demand = _all_sum(torch.stack([shard_demand(s, cams, cfg)
                                   for s in param_sets]))
    worst = int(demand.max())
    chunk = config["raster"]["chunk_size"]
    cap = max(int(worst * config["capacity"]["factor"]), 4 * chunk)
    return -(-cap // chunk) * chunk


def build_step(pmesh, cfg, tcfg):
    """The step the cell runs: the sharded train step of the process mesh
    at each shard's default pair budget, with its drop counters."""
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    return distributed.make_sharded_train_step(pmesh, cfg, tcfg,
                                               with_stats=True)


def _bucket_demand(shard: dict, cams, cfg, world: int) -> int:
    """The most rows any camera sends from this shard to one strip."""
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    model = GaussianModel(*(shard[k] for k in FIELDS))
    rows = distributed._rows_per_device(cfg, world)
    worst = 0
    with torch.no_grad():
        for cam in cams:
            sp = project_gaussians(model, Camera(*cam), cfg)
            lo, span = distributed._dest_strip_span(sp, cfg, rows)
            for j in range(world):
                hit = (lo <= j) & (j < lo + span)
                worst = max(worst, int(hit.sum()))
    return worst


def plant_fault(fault: str, cfg, gt: dict, cams, world: int) -> None:
    """Plant a set-up fault (module docstring) in this process."""
    import torch.distributed as dist

    from gaussian_splat_ipu_tpu_torch.parallel import distributed, multihost
    from gaussian_splat_ipu_tpu_torch.render import binning
    if fault == "row_lo":
        bin_splats = binning.bin_splats
        strip_lo = distributed._rows_per_device(cfg, world)

        def shifted(splats, rcfg, row_lo=None, num_rows=None,
                    pair_capacity=None):
            if row_lo == strip_lo:
                row_lo += 1
            return bin_splats(splats, rcfg, row_lo, num_rows, pair_capacity)

        binning.bin_splats = shifted
    elif fault == "cotangent_sum":
        def summed(ctx, g):
            g = g.contiguous().clone()
            dist.all_reduce(g)
            lo = ctx.rank * ctx.rows
            return g[lo:lo + ctx.rows]

        multihost._GatherReplicated.backward = staticmethod(summed)
    elif fault == "half_buckets":
        worst = torch.tensor([_bucket_demand(gt, cams, cfg, world)],
                             dtype=torch.int64, device=gt["means"].device)
        half = max(int(_all_max(worst)) // 2, 1)
        distributed._exchange_capacity = (
            lambda nloc, d, requested=None: -(-half // 128) * 128)
    else:
        raise ValueError(f"CITY_FAULT {fault!r}: expected one of {FAULTS}")


def _layer_reading(rec, prof, n_items, item_s) -> dict:
    """This rank's traced reading: per step of the stretch, the device ms
    of each span of SPANS (summed per engine run), and the counters."""
    per = {}
    for s in rec.collect():
        if s.name in SPANS and s.track == "device" and s.item >= 0:
            d = per.setdefault(s.item, {})
            d[s.name] = d.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    summary = rec.summary()
    steps = [per[k] for k in sorted(per)]
    return dict(kind="sharded_train", profile=prof, items=n_items,
                item_s=item_s, step_spans=steps,
                span_ms={n: statistics.median(s.get(n, 0.0) for s in steps)
                         for n in SPANS if any(n in s for s in steps)},
                counters={k: summary[k] for k in COUNTERS if k in summary})


def run(ctx) -> dict:
    import torch.distributed as dist

    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.parallel import distributed, multihost
    from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils import profiling
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig

    cell, dev, spans = ctx.cell, ctx.device, ctx.spans
    config, traffic = cell.config, cell.traffic
    scene, rc = config["scene"], config["raster"]
    tc = fit.train_settings(config, traffic)
    n_check = int(traffic["checked_steps"])
    if ctx.control:
        return _control(ctx, tc, n_check)
    if "with_stats" not in inspect.signature(
            distributed.make_sharded_train_step).parameters:
        raise SystemExit("the program's sharded train step gives no drop "
                         "counters: this cell cannot check its steps")
    if not multihost.initialize(device=dev.type):
        raise SystemExit("the sharded_fit traffic runs one process per "
                         "shard: no GSPLAT_COORDINATOR is set")
    rank, world = multihost.process_index(), multihost.process_count()
    if world != int(scene["shards"]):
        raise SystemExit(f"{world} processes for {scene['shards']} shards")
    pmesh = multihost.make_process_mesh(dev.type)
    store = dist.distributed_c10d._get_default_store()

    cams = city.drone_cameras(config, traffic, dev)
    n_views = len(cams)
    gt = city.make_shard(scene, ctx.seed, rank, dev)
    init = city.perturb_shard(gt, traffic["perturb"], ctx.seed, rank)
    order = inputs.epoch_order(n_views, ctx.seed, 0)
    checked_views = order[:n_check]

    cap = capacity(config, [gt, init], cams)
    cfg = harness.raster_config(config, cap)
    fault = os.environ.get("CITY_FAULT", "")
    if fault:
        plant_fault(fault, cfg, gt, cams, world)
    cam_objs = [Camera(*c) for c in cams]

    with torch.no_grad():
        truth = GaussianModel(*(gt[k] for k in FIELDS))
        targets, target_drops = [], []
        for cam in cam_objs:
            out = distributed.render_sharded(truth, cam, cfg, pmesh)
            targets.append(out.image)
            target_drops.append(torch.stack([out.exchange_overflow,
                                             out.overflow, out.truncated]))
        del truth, out
    target_failed = int((torch.stack(target_drops) != 0).any(1).sum())
    del gt

    tcfg = trainer.TrainConfig(**tc)
    state = trainer.init_state(GaussianModel(
        *(init[k].clone() for k in FIELDS), requires_grad=True), tcfg)
    engine = RenderEngine(RuntimeConfig(device=dev.type))
    trainer.register_step(engine, state, cam_objs[order[0]],
                          targets[order[0]], cfg, tcfg,
                          step_fn=build_step(pmesh, cfg, tcfg), eager=EAGER)

    inflight = collections.deque()
    losses, done, drops, nonfinite = [], [], [], [0]

    def submit(view):
        with spans("enqueue"):
            out = engine.run(trainer.STEP_PROGRAM, state, cam_objs[view],
                             targets[view])
        inflight.append(out)

    def retire():
        loss, d = inflight.popleft()
        with spans("retire"):
            value = float(loss)
        losses.append(value)
        done.append(time.perf_counter())
        drops.append(d)
        if not math.isfinite(value):
            nonfinite[0] += 1

    # The checked steps: this rank's squared norms of the first gradient
    # and of the change, by field (float64 on the host).
    norms = []
    for i, view in enumerate(checked_views):
        submit(view)
        if i == 0:
            norms += [refs.sumsq(state.opt_state.adam[k].mu / (1.0 - fit.B1))
                      for k in FIELDS]
        if len(inflight) >= traffic["in_flight"]:
            retire()
    norms += [refs.sumsq(getattr(state.params, k).detach() - init[k])
              for k in FIELDS]
    while inflight:
        retire()
    checked_losses = list(losses)
    del init

    pos, epoch, cur = [n_check], [0], [order]

    def next_view():
        if pos[0] == n_views:
            epoch[0] += 1
            cur[0] = inputs.epoch_order(n_views, ctx.seed, epoch[0])
            pos[0] = 0
        v = cur[0][pos[0]]
        pos[0] += 1
        return v

    spans.times.clear()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    steps, go = 0, True
    while go:
        submit(next_view())
        steps += 1
        if len(inflight) >= traffic["in_flight"]:
            retire()
        key = f"sharded_fit.go.{steps}"
        if rank == 0:
            go = time.perf_counter() < deadline
            store.set(key, "1" if go else "0")
        else:
            go = store.get(key) == b"1"
    while inflight:
        retire()
    t_end = time.perf_counter()
    setup_s = t0 - ctx.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    per = torch.stack(drops).cpu() != 0
    bad = per.any(dim=1)
    xovf, overflowed, truncated = (int(x) for x in per[n_check:].sum(dim=0))
    failed = int(bad[n_check:].sum()) + nonfinite[0]
    epochs = epoch[0] + 1
    step_ms = (t_end - t0) * 1e3 / max(steps, 1)

    # The traced stretch: one more epoch through the window's loop.
    layer, stretch_s = None, None
    if ctx.trace:
        stretch_views = inputs.epoch_order(n_views, ctx.seed, epochs)
        prof = {}
        rec = profiling.start(dev)
        try:
            with harness.profiled(prof, spans):
                t_p = time.perf_counter()
                for view in stretch_views:
                    submit(view)
                    if len(inflight) >= traffic["in_flight"]:
                        retire()
                while inflight:
                    retire()
                stretch_s = time.perf_counter() - t_p
            layer = _layer_reading(rec, prof, len(stretch_views),
                                   step_ms * 1e-3)
        finally:
            profiling.stop()

    prog_targets = [targets[v].clone() for v in checked_views] \
        if rank == 0 else []
    whole = _all_sum(torch.tensor(norms, dtype=torch.float64,
                                  device=dev)).tolist()
    del engine, state, targets, inflight
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    info = dict(rank=rank, pair_capacity=cap,
                shard_pair_budget=distributed.default_pair_budget(cfg, world),
                steps=steps, epochs=epochs, window_s=t_end - t0,
                per_second=harness.per_second(done, t0),
                window_step_ms=step_ms,
                stretch_step_ms=(stretch_s * 1e3 / layer["items"]
                                 if layer else None),
                target_failed=target_failed, exchange_overflowed=xovf,
                overflowed=overflowed, truncated=truncated,
                checked_steps_failed=int(bad[:n_check].sum()),
                losses_program=checked_losses,
                last_loss=losses[-1] if losses else None,
                counters=layer["counters"] if layer else None,
                span_ms=layer["span_ms"] if layer else None,
                kernel_build_s=cuda_lib.BuildInfo.seconds,
                kernel_build_wait_s=getattr(cuda_lib.BuildInfo, "wait_s",
                                            None),
                fault=fault or None)
    readings, checked = {}, 0
    if rank == 0:
        t_ref = time.perf_counter()
        readings, ref_info = _reference_readings(
            ctx, tc, cams, checked_views, prog_targets, checked_losses,
            whole)
        info.update(ref_info, reference_s=time.perf_counter() - t_ref)
        checked = n_check
    return dict(
        attempted=steps, failed=failed, readings=readings, checked=checked,
        e2e={"setup_s": setup_s, "step_ms": step_ms}, layer=layer,
        memory_peak_bytes=int(peak), info=info)


def _norm_readings(losses_p, grad_p, change_p, losses_r, grad_r, change_r):
    """fit.compare's loss, gradient and change readings from the norms:
    the worst field's gap over the larger of the reference field's norm
    and the median field's; fields the reference barely moves are left
    out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    scale = statistics.median(grad_r.values())
    grad_gap = max(fit._gap(grad_p[k], grad_r[k], scale) for k in FIELDS)
    moved = [k for k in FIELDS if grad_r[k] >= fit.STILL_SHARE * scale]
    cscale = statistics.median(change_r[k] for k in moved)
    change_gap = max(fit._gap(change_p[k], change_r[k], cscale)
                     for k in moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)


def _reference_run(ctx, tc, cams, views, dtype):
    """The reference's targets at `views` and its first steps on them, on
    the whole model in `dtype`: (targets, losses, first-gradient norms,
    change norms, frame stats)."""
    config, traffic = ctx.cell.config, ctx.cell.traffic
    scene, rc = config["scene"], config["raster"]
    dev = ctx.device
    gt = {k: v.to(dtype) for k, v in
          city.make_scene(scene, ctx.seed, dev).items()}
    targets = [refs.render(gt, *(t.to(dtype) for t in cams[v]),
                           rc)["image"] for v in views]
    del gt
    params = {k: v.to(dtype) for k, v in city.make_scene(
        scene, ctx.seed, dev, start=traffic["perturb"]).items()}
    losses, first, counts = refs.first_steps(params, cams, views, targets,
                                             rc, tc)
    init = city.make_scene(scene, ctx.seed, dev, start=traffic["perturb"])
    change = {k: math.sqrt(refs.sumsq(params[k].float() - init[k]))
              for k in FIELDS}
    del params, init
    grads = {k: math.sqrt(v) for k, v in first.items()}
    return targets, losses, grads, change, counts


def _reference_readings(ctx, tc, cams, views, prog_targets, losses_p,
                        whole):
    """Rank 0's readings against the plain reference on the whole model."""
    targets_r, losses_r, grad_r, change_r, counts = _reference_run(
        ctx, tc, cams, views, torch.float32)
    n = len(FIELDS)
    grad_p = {k: math.sqrt(whole[i]) for i, k in enumerate(FIELDS)}
    change_p = {k: math.sqrt(whole[n + i]) for i, k in enumerate(FIELDS)}
    readings = _norm_readings(losses_p, grad_p, change_p, losses_r, grad_r,
                              change_r)
    readings["target_rel_l2"] = max(harness.rel_l2(a, b) for a, b in
                                    zip(prog_targets, targets_r))
    readings = {k: (v if math.isfinite(v) else float("inf"))
                for k, v in readings.items()}
    return readings, dict(losses_reference=losses_r,
                          reference_pairs=[c["pairs"] for c in counts],
                          grad_norms_program=grad_p,
                          grad_norms_reference=grad_r,
                          change_norms_program=change_p,
                          change_norms_reference=change_r)


def _control(ctx, tc, n_check):
    """The control: the reference in bfloat16 in the program's place,
    judged as a run is, on rank 0 (the other ranks check nothing)."""
    if ctx.rank != 0:
        return dict(attempted=0, failed=0, checked=0, readings={}, e2e={},
                    layer=None, memory_peak_bytes=0,
                    info=dict(control="bfloat16"))
    config, traffic = ctx.cell.config, ctx.cell.traffic
    cams = city.drone_cameras(config, traffic, ctx.device)
    views = inputs.epoch_order(len(cams), ctx.seed, 0)[:n_check]
    tgt_c, l_c, g_c, c_c, _ = _reference_run(ctx, tc, cams, views,
                                             torch.bfloat16)
    tgt_r, l_r, g_r, c_r, _ = _reference_run(ctx, tc, cams, views,
                                             torch.float32)
    readings = _norm_readings(l_c, g_c, c_c, l_r, g_r, c_r)
    readings["target_rel_l2"] = max(harness.rel_l2(a.float(), b)
                                    for a, b in zip(tgt_c, tgt_r))
    readings = {k: (v if math.isfinite(v) else float("inf"))
                for k, v in readings.items()}
    return dict(attempted=n_check, failed=0, checked=n_check,
                readings=readings, e2e={}, layer=None, memory_peak_bytes=0,
                info=dict(control="bfloat16"))
