"""The `densify` traffic: the train CLI's density-controlled fit in a closed
loop (app/train.py --densify on one device).

Set-up makes what the `fit` traffic makes (the config's scene from the
seed as the ground truth, the views on the elevation rings, the targets
rendered by the program, the start perturbed from the seed) and puts the
start in a slot buffer of the config's `slots` (train/densify.pad_model),
the first `gaussians` alive. The gradient threshold is the config's
scaled by the program's measured L1 / D-SSIM mix (densify.loss_mix_scale
on view 0), as the app scales it. The step is densify.register_step's
program (forward with the screen-space probe, loss, backward, the
gradient statistics and Adam as one CUDA-graph replay); its render
function returns the frame's overflow and truncation beside the loss.
The render program (app/main.splat_program) serves the pair-demand guard.

The loop is the app's: whole epochs of every view in a fresh order drawn
from the seed, up to `in_flight` steps outstanding, the oldest retired by
reading its loss on the host; the step counter starts at the config's
`start_step`; after an epoch, when the schedule says so (every
densify_every steps rounded down to whole epochs, from densify_from_step
to densify_until_step, while the guard is open), one event
(densify.densify_and_prune, its counts written on the device) and the
guard (densify.pair_demand_guard: every view rendered, the demand and the
event's counts read back once); the opacity reset on its cadence. The
window closes at the end of the first epoch (its event and guard
included) that ends at or after --seconds, so that it holds whole
epochs: step_ms is the window's wall time over the steps retired in it.

Correct. Set-up drives the step object through its first `checked_steps`
steps, on the first views of the first epoch, keeping Adam's first moment
after step 1, and the parameters and the statistics (grad_sum, vis_count)
after the last; then one event on that state with the key's own draws
(densify.split_noise) and the guard after it; then it puts the state back
as it was before the event. After the window the plain reference
(reference/render.py and reference/densify.py) renders those views'
targets, follows the same steps from the same start and measures the mix
scale: compared are what the `fit` traffic compares (target_rel_l2,
loss_gap, grad_gap, change_gap), the mix scale's gap, grad_sum's relative
L2 error and the share of live slots whose vis_count differs. The
reference's event from the program's pre-event state and the same draws:
the slots whose alive bit differs, the worst parameter's gap (largest
absolute difference over the reference's largest magnitude, per field)
and the moment rows the program zeroed where the reference did not, or
changed where it kept them. The window is held to finite losses, no
dropped pairs and no guard that saw dropped pairs.

A traced run records the program's spans (utils/profiling.py) from the
window's start, and profiles one more epoch after the window through the
window's own loop, its event and guard included. The guard's renders are
profiled apart: the device's busy seconds count them, the seconds by
kernel name (which the rasterizer's rooflines read against the steps'
work) do not. The reference counts the steps' work at the parameters the
stretch starts from.
"""

from __future__ import annotations

import collections
import math
import os
import time

import torch

from splatbench import harness, inputs
from splatbench.reference import densify as refd
from splatbench.reference import render as ref

fit = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "fit.py"),
    "splatbench_driver_fit")

# What the cell drives in the program's train/densify.py.
NEEDS = ("pair_demand_guard", "new_counts")
RENDER = "render"
SPANS = ("densify.event", "densify.guard", "densify.reset")


def _program_densify():
    """The program's density control; a program without what this traffic
    drives is refused at once."""
    from gaussian_splat_ipu_tpu_torch.train import densify
    missing = [n for n in NEEDS if not hasattr(densify, n)]
    if missing:
        raise SystemExit(f"splatbench: the program's train/densify.py has "
                         f"no {', '.join(missing)}: it cannot run the "
                         f"densify traffic")
    return densify


def padded(params: dict, slots: int) -> dict:
    """`params` in a buffer of `slots` rows: the rest dead (means and SH
    zero, log-scales and opacities at the reference's dead value, identity
    quaternions)."""
    n = params["means"].shape[0]
    out = {}
    for k, v in params.items():
        fill = refd.DEAD if k in ("log_scales", "opacities") else 0.0
        pad = torch.full((slots - n,) + tuple(v.shape[1:]), fill,
                         dtype=v.dtype, device=v.device)
        if k == "quats":
            pad[:, 0] = 1.0
        out[k] = torch.cat([v, pad])
    return out


def event_config(config: dict, mix_scale: float, extent: float) -> dict:
    """The event's settings (reference/densify.DEFAULTS' keys): the
    config's, the threshold scaled by the mix."""
    d = config["densify"]
    return dict(grad_threshold=d["grad_threshold"] * mix_scale,
                percent_dense=d["percent_dense"],
                min_opacity=d["min_opacity"],
                max_world_scale=d["max_world_scale"],
                split_scale_factor=d["split_scale_factor"],
                scene_extent=extent)


def mix_scale(params, cam, target, rc, w, dtype) -> float:
    """The reference's screen-gradient scale of the (1-w) L1 + w D-SSIM
    mix against pure L1: the mean norm over visible gaussians of each
    term's gradient alone."""
    if w <= 0.0:
        return 1.0
    v, p, e = (t.to(dtype) for t in cam)
    p_ = {k: x.to(dtype) for k, x in params.items()}
    means = []
    for weight in (0.0, 1.0):
        _, _, gn, vis = refd.loss_and_stats(p_, v, p, e, target.to(dtype),
                                            rc, weight)
        means.append(float(torch.where(vis, gn, 0.0).double().sum()
                           / max(int(vis.sum()), 1)))
    return (1.0 - w) + w * means[1] / max(means[0], 1e-12)


def stat_readings(prog, refr, alive) -> dict:
    """grad_sum's relative L2 error and the share of live slots whose
    vis_count differs."""
    gs_p, vc_p = prog
    gs_r, vc_r = refr
    n = max(int(alive.sum()), 1)
    return dict(grad_sum_gap=harness.rel_l2(gs_p, gs_r),
                vis_count_mismatch=float((vc_p != vc_r).sum()) / n)


def event_readings(prog: dict, want: dict) -> dict:
    """The program's (or the control's) event against the reference's:
    alive bits, the worst field's gap, and the moment rows (prog["moment_
    rows"]: per row, whether the program zeroed it and whether it kept
    it; or prog["touched"])."""
    gap = 0.0
    for k in refd.FIELDS:
        scale = float(want["params"][k].double().abs().max())
        gap = max(gap, harness.max_abs(prog["params"][k], want["params"][k])
                  / max(scale, 1e-30))
    if "touched" in prog:
        rows = int((prog["touched"] != want["touched"]).sum())
    else:
        zeroed, kept = prog["moment_rows"]
        t = want["touched"]
        rows = int(((t & ~zeroed) | (~t & ~kept)).sum())
    return dict(event_alive_mismatch=float(
                    (prog["alive"] != want["alive"]).sum()),
                event_param_gap=gap if math.isfinite(gap) else float("inf"),
                event_moment_rows=float(rows))


def run(ctx) -> dict:
    densify = _program_densify()
    from gaussian_splat_ipu_tpu_torch.app.main import splat_program
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import pipeline
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.train import losses, trainer
    from gaussian_splat_ipu_tpu_torch.utils import profiling
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig

    cell, dev, spans = ctx.cell, ctx.device, ctx.spans
    config, traffic = cell.config, cell.traffic
    rc = config["raster"]
    tc = fit.train_settings(config, traffic)
    ds = config["densify"]
    n_check = int(traffic["checked_steps"])
    cams = fit._cameras(config, traffic, dev)
    n_views = len(cams)
    slots = int(config["slots"])
    n0 = int(config["scene"]["gaussians"])

    gt = inputs.make_scene(config["scene"], ctx.seed, dev)
    init = inputs.perturb(gt, traffic["perturb"], ctx.seed)
    order = inputs.epoch_order(n_views, ctx.seed, 0)
    checked_views = order[:n_check]
    # The split noise's key, from the seed.
    key = [ctx.seed & 0xFFFFFFFF, (ctx.seed >> 32) & 0xFFFFFFFF]

    if ctx.control:
        return _control(ctx, gt, padded(init, slots), cams, checked_views,
                        rc, tc, config)

    cap = harness.probe_capacity(config, [gt, init], cams)
    cfg = harness.raster_config(config, cap)

    with torch.no_grad():
        truth = GaussianModel(*(gt[k].clone() for k in inputs.FIELDS))
        targets, target_drops = [], []
        for v, p, e in cams:
            out = pipeline.render(truth, Camera(v, p, e), cfg)
            targets.append(out.image)
            target_drops.append(torch.stack([out.overflow, out.truncated]))
        del truth
    target_failed = int((torch.stack(target_drops) != 0).any(1).sum())

    tcfg = trainer.TrainConfig(**tc)
    cam_objs = [Camera(v, p, e) for v, p, e in cams]
    model = GaussianModel(*(init[k].clone() for k in inputs.FIELDS))
    gscale = densify.loss_mix_scale(model, cam_objs[0], targets[0], cfg,
                                    tc["ssim_weight"])
    ecfg = event_config(config, gscale, tc["scene_extent"])
    every = max(ds["densify_every"] // n_views, 1) * n_views
    dcfg = densify.DensifyConfig(
        densify_every=every, densify_from_step=ds["densify_from_step"],
        densify_until_step=ds["densify_until_step"],
        reset_opacity_every=ds["reset_opacity_every"],
        reset_opacity_to=ds["reset_opacity_to"], **ecfg)
    dst = [densify.init_state(n0, slots, key, device=dev)]
    state = trainer.init_state(densify.pad_model(model, slots).trainable(),
                               tcfg)
    del model
    counts = densify.new_counts(dev)
    h = rc["image_height"]

    def step_fn(state, grad_sum, vis_count, camera, target):
        drops = []

        def render_fn(params, cam, rcfg, xy_probe=None):
            out = pipeline.render(params, cam, rcfg, xy_probe=xy_probe)
            drops.append(torch.stack([out.overflow, out.truncated]))
            if ctx.fault == "half_batch":
                return out._replace(image=out.image[:h // 2])
            return out

        if ctx.fault == "half_batch":
            target = target[:h // 2]
        if ctx.fault == "step_unchanged":
            out = render_fn(state.params, camera, cfg)
            loss = losses.render_loss(out.image, target, tcfg.ssim_weight)
            return loss.detach(), drops[0]
        loss = densify.make_train_step(cfg, tcfg, render_fn=render_fn)(
            state, grad_sum, vis_count, camera, target)
        if ctx.fault == "answer":
            loss = loss * 1.01
        return loss, drops[0]

    engine = RenderEngine(RuntimeConfig(device=dev.type))
    v0 = cam_objs[order[0]]
    engine.register(RENDER, splat_program(cfg), (
        state.params, v0.view.clone(), v0.proj.clone(), v0.env_rot.clone()))
    densify.register_step(engine, state, dst[0], v0, targets[order[0]], cfg,
                          tcfg, step_fn=step_fn)

    def moments():
        return [m for st in state.opt_state.adam.values()
                for m in (st.mu, st.nu)]

    def held():
        """Every tensor a step or an event writes; the moments follow the
        parameters."""
        d = dst[0]
        return (*state.params.parameters(), *moments(),
                *(st.count for st in state.opt_state.adam.values()),
                state.opt_state.means_lr_count, state.step, d.grad_sum,
                d.vis_count, d.alive)

    def snapshot():
        return [t.detach().clone() for t in held()]

    def restore(saved):
        with torch.no_grad():
            for t, v in zip(held(), saved):
                t.copy_(v)

    def run_step(view):
        d = dst[0]
        return engine.run(densify.STEP_PROGRAM, state, d.grad_sum,
                          d.vis_count, cam_objs[view], targets[view])

    # One more replay, its effect undone: a graph's first launch uploads it.
    with torch.no_grad():
        saved = snapshot()
        float(run_step(order[0])[0])
        restore(saved)
        del saved

    inflight = collections.deque()
    losses_h, done, drops, nonfinite = [], [], [], [0]

    def submit(view):
        with spans("enqueue"):
            out = run_step(view)
        inflight.append(out)

    def retire():
        loss, d = inflight.popleft()
        with spans("retire"):
            value = float(loss)
        losses_h.append(value)
        done.append(time.perf_counter())
        drops.append(d)
        if not math.isfinite(value):
            nonfinite[0] += 1

    snap = {}
    for i, view in enumerate(checked_views):
        submit(view)
        if i == 0:
            with spans("snapshot"):
                snap["mu"] = {k: state.opt_state.adam[k].mu.detach().clone()
                              for k in inputs.FIELDS}
        if len(inflight) >= traffic["in_flight"]:
            retire()
    while inflight:
        retire()
    checked_losses = list(losses_h)
    with torch.no_grad():
        snap["after"] = {k: getattr(state.params, k).detach().clone()
                         for k in inputs.FIELDS}
        snap["grad_sum"] = dst[0].grad_sum.clone()
        snap["vis_count"] = dst[0].vis_count.clone()
        snap["alive"] = dst[0].alive.clone()

    # The checked event and its guard, then the state as before it.
    saved = snapshot()
    eps_a, eps_b, _ = densify.split_noise(dst[0], slots, dev)
    counts.copy_(densify.densify_and_prune_core(state, dst[0], dcfg, eps_a,
                                                eps_b))
    checked_guard = densify.pair_demand_guard(engine, state.params, cam_objs,
                                              cap, RENDER, counts)
    with torch.no_grad():
        n_fields = len(inputs.FIELDS)
        zeroed = kept = None
        for m, before in zip(moments(), saved[n_fields:]):
            flat, old = m.reshape(m.shape[0], -1), before.reshape(
                m.shape[0], -1)
            z, k = (flat == 0).all(1), (flat == old).all(1)
            zeroed = z if zeroed is None else zeroed & z
            kept = k if kept is None else kept & k
        snap["event"] = dict(
            params={k: getattr(state.params, k).detach().clone()
                    for k in inputs.FIELDS},
            alive=dst[0].alive.clone(), moment_rows=(zeroed, kept),
            counts=checked_guard.counts)
    restore(saved)
    del saved

    events, guard_failed, is_open = [], [0], [True]

    def density_event(i) -> bool:
        """The app's event after an epoch ending at step i, where the
        schedule and the guard allow one."""
        c = dcfg
        if not (is_open[0] and c.densify_from_step <= i
                <= c.densify_until_step and i % c.densify_every == 0):
            return False
        with spans("event"):
            _, dst[0] = densify.densify_and_prune(state, dst[0], c, counts)
        return True

    def guard(i):
        with spans("guard"):
            g = densify.pair_demand_guard(engine, state.params, cam_objs,
                                          cap, RENDER, counts)
        if g.overflow or g.exchange_overflow:
            guard_failed[0] += 1
        if g.closes:
            is_open[0] = False
        events.append(dict(step=i, demand=g.demand, overflow=g.overflow,
                           closes=g.closes, **g.counts))

    def reset(i):
        c = dcfg
        if (is_open[0] and c.reset_opacity_every
                and i % c.reset_opacity_every < n_views
                and c.reset_opacity_every <= i <= c.densify_until_step):
            densify.reset_opacity(state, dst[0], c)

    def after_epoch(i):
        if density_event(i):
            guard(i)
        reset(i)

    def epoch_views(epoch):
        return inputs.epoch_order(n_views, ctx.seed, epoch)

    rec = profiling.start(dev) if ctx.trace else None
    try:
        spans.times.clear()
        step_i = int(config["start_step"]) + n_check
        epoch, views = 0, order[n_check:]
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        steps = 0
        while True:
            for view in views:
                submit(view)
                steps += 1
                step_i += 1
                if len(inflight) >= traffic["in_flight"]:
                    retire()
            after_epoch(step_i)
            if time.perf_counter() >= deadline:
                break
            epoch += 1
            views = epoch_views(epoch)
        while inflight:
            retire()
        t_end = time.perf_counter()
        setup_s = t0 - ctx.t_start
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        window_events = list(events)
        enqueue = list(spans.times.get("enqueue", []))

        # The traced stretch: one more epoch through the window's loop.
        prof, stretch_views, stretch_start, stretch_s = {}, [], None, None
        if ctx.trace:
            stretch_views = epoch_views(epoch + 1)
            with torch.no_grad():
                stretch_start = {k: getattr(state.params, k).detach().clone()
                                 for k in inputs.FIELDS}
            steps_part, guard_part = {}, {}
            t_p = time.perf_counter()
            with harness.profiled(steps_part, spans):
                for view in stretch_views:
                    submit(view)
                    step_i += 1
                    if len(inflight) >= traffic["in_flight"]:
                        retire()
                while inflight:
                    retire()
                evented = density_event(step_i)
            # The guard's renders, profiled apart.
            with harness.profiled(guard_part, spans):
                if evented:
                    guard(step_i)
            reset(step_i)
            stretch_s = time.perf_counter() - t_p
            prof = merge_profiles(steps_part, guard_part)
        program_spans = []
        if rec is not None:
            program_spans = [(s.name, s.track, (s.end_ns - s.start_ns) / 1e6)
                             for s in rec.collect() if s.name in SPANS]
            recorder_counters = {k: v for k, v in rec.summary().items()
                                 if k.startswith("densify.")}
    finally:
        if rec is not None:
            profiling.stop()

    per = torch.stack(drops) != 0
    bad = per.any(dim=1)
    overflowed, truncated = (int(x) for x in per[n_check:].sum(dim=0))
    failed = int(bad[n_check:].sum()) + nonfinite[0] + guard_failed[0]
    prog_targets = [targets[v].clone() for v in checked_views]
    g_prog = {k: v / (1.0 - fit.B1) for k, v in snap.pop("mu").items()}
    alive_final = int(dst[0].alive.sum())
    del engine, state, targets, inflight
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    init_slots = padded(init, slots)
    ref_targets = [ref.render(gt, *cams[v], rc)["image"]
                   for v in checked_views]
    losses_r, g_r, after_r, gs_r, vc_r = refd.steps(
        init_slots, cams, checked_views, ref_targets, rc, tc, torch.float32)
    readings = fit.compare(
        (checked_losses, g_prog, snap["after"], prog_targets),
        (losses_r, g_r, after_r, ref_targets), init_slots)
    del g_r, g_prog, after_r
    readings.update(stat_readings((snap["grad_sum"], snap["vis_count"]),
                                  (gs_r, vc_r), snap["alive"]))
    target0 = ref.render(gt, *cams[0], rc)["image"]
    gscale_r = mix_scale(init, cams[0], target0, rc, tc["ssim_weight"],
                         torch.float32)
    readings["mix_scale_gap"] = abs(gscale - gscale_r) / gscale_r
    want = refd.event(snap["after"], snap["grad_sum"], snap["vis_count"],
                      snap["alive"], eps_a, eps_b, ecfg)
    readings.update(event_readings(snap["event"], want))
    readings = {k: (v if math.isfinite(v) else float("inf"))
                for k, v in readings.items()}
    reference_s = time.perf_counter() - t_ref
    work = []
    for view in stretch_views:
        r = ref.render(stretch_start, *cams[view], rc)
        work.append(dict(pairs=r["pairs"], live=r["live"]))
    step_ms = (t_end - t0) * 1e3 / max(steps, 1)
    return dict(
        attempted=steps, failed=failed, readings=readings, checked=n_check,
        e2e={"setup_s": setup_s, "step_ms": step_ms},
        layer=dict(kind="train", enqueue_s=enqueue, profile=prof,
                   work=work, items=len(stretch_views),
                   item_s=step_ms * 1e-3, ssim_weight=tc["ssim_weight"],
                   program_spans=program_spans),
        memory_peak_bytes=int(peak),
        info=dict(pair_capacity=cap, slots=slots, steps=steps,
                  epochs=epoch + 1, window_s=t_end - t0,
                  mix_scale=gscale, mix_scale_reference=gscale_r,
                  grad_threshold=dcfg.grad_threshold,
                  events=window_events, events_in_window=len(window_events),
                  guard_closed=not is_open[0], alive_final=alive_final,
                  checked_event=dict(snap["event"]["counts"],
                                     demand=checked_guard.demand),
                  reference_event=want["counts"],
                  recorder_counters=(recorder_counters if rec is not None
                                     else None),
                  guard_kernel_s=prof.get("guard_kernel_s"),
                  reference_s=reference_s,
                  per_second=harness.per_second(done, t0),
                  window_step_ms=step_ms,
                  stretch_step_ms=(stretch_s * 1e3 / len(stretch_views)
                                   if stretch_views else None),
                  target_failed=target_failed, overflowed=overflowed,
                  truncated=truncated, guard_failed=guard_failed[0],
                  checked_steps_failed=int(bad[:n_check].sum()),
                  checked_views=checked_views,
                  losses_program=checked_losses, losses_reference=losses_r,
                  last_loss=losses_h[-1] if losses_h else None))


def merge_profiles(steps_part: dict, guard_part: dict) -> dict:
    """One reading of the stretch from its two profiled parts: busy and
    traced seconds of both; seconds by kernel name of the steps and the
    event only (the guard's by name kept apart in guard_kernel_s)."""
    if not steps_part or not guard_part:
        return {}
    gaps = dict(steps_part["idle_gaps"])
    for label, s in guard_part["idle_gaps"]:
        gaps[label] = gaps.get(label, 0.0) + s
    return dict(kernel_s=steps_part["kernel_s"],
                busy_s=steps_part["busy_s"] + guard_part["busy_s"],
                window_s=steps_part["window_s"] + guard_part["window_s"],
                top_ops=steps_part["top_ops"],
                idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
                guard_kernel_s=guard_part["top_ops"])


def _control(ctx, gt, init_slots, cams, views, rc, tc, config):
    """The control: the reference in bfloat16 in the program's place (its
    targets, its steps and statistics, its mix scale and its event, from
    its own state with noise drawn from the seed), judged as a run is."""
    bf, f32 = torch.bfloat16, torch.float32
    dev = init_slots["means"].device
    gen = torch.Generator(device=dev).manual_seed(int(ctx.seed) ^ 0xE7E7)
    n = init_slots["means"].shape[0]
    eps = [torch.randn((n, 3), generator=gen, device=dev) for _ in range(2)]
    alive = init_slots["opacities"] > refd.DEAD
    out = {}
    for name, dt in (("control", bf), ("reference", f32)):
        gtd = {k: v.to(dt) for k, v in gt.items()}
        tgt = [ref.render(gtd, *(t.to(dt) for t in cams[v]), rc)["image"]
               for v in views]
        losses_, g, after, gs, vc = refd.steps(init_slots, cams, views, tgt,
                                               rc, tc, dt)
        t0 = ref.render(gtd, *(t.to(dt) for t in cams[0]), rc)["image"]
        scale = mix_scale(init_slots, cams[0], t0, rc, tc["ssim_weight"], dt)
        ecfg = event_config(config, scale, tc["scene_extent"])
        ev = refd.event(after, gs, vc, alive, *(e.to(dt) for e in eps),
                        ecfg)
        out[name] = dict(steps=(losses_, g, after, [t.float() for t in tgt]),
                         stats=(gs.float(), vc), scale=scale, event=ev)
    c, r = out["control"], out["reference"]
    readings = fit.compare(c["steps"], r["steps"], init_slots)
    readings.update(stat_readings(c["stats"], r["stats"], alive))
    readings["mix_scale_gap"] = abs(c["scale"] - r["scale"]) / r["scale"]
    readings.update(event_readings(c["event"], r["event"]))
    return dict(attempted=len(views), failed=0, checked=len(views),
                readings=readings, e2e={}, layer=None,
                memory_peak_bytes=0, info=dict(control="bfloat16"))
