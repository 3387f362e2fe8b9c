"""The `fit` traffic: the train CLI's replayed step in a closed loop
(app/train.py's single-device path).

Set-up makes the config's scene from the seed (the ground truth), the
views on the traffic's elevation rings, and the targets: the ground
truth's images of every view, rendered by the program. The fit starts from
the ground truth with every parameter perturbed from the seed. The step
is train/trainer.register_step's program (forward, loss, backward, Adam as
one CUDA-graph replay, the view's camera and target copied in); its image
function is the port's render with the frame's overflow and truncation
counts returned beside the loss. Up to `in_flight` steps are outstanding;
the oldest is retired by reading its loss on the host. Views are visited in
a fresh order drawn from the seed each epoch.

Correct: set-up drives that same step object through its first
`checked_steps` steps, on the first views of the first epoch, and keeps the
first moment of Adam after step 1 (the first gradient is it over 1 - b1)
and the parameters after the last. After the window the plain reference
renders those views' targets itself and follows the same steps from the
same start. Compared: each step's loss, each parameter's gradient norm
(step 1) and change norm (after the steps), each as the gap to the
reference's norm over the larger of that and the median parameter's; and
the program's targets against the reference's. The window's later steps
are held to finite losses and no dropped pairs only.

A traced run profiles one more epoch after the window, through the
window's own loop (every view once, in a fresh order drawn from the seed;
the same retire), so that its views weigh as the window's do; the
reference counts their work at the parameters the stretch starts from.
"""

from __future__ import annotations

import collections
import math
import statistics
import time

import torch

from splatbench import harness, inputs
from splatbench.reference import render as ref

B1 = 0.9
# Parameters whose reference gradient norm is under this share of the
# median parameter's are left out of the change (Adam moves them by
# round-off alone).
STILL_SHARE = 1e-3


def train_settings(config, traffic) -> dict:
    """TrainConfig's defaults (3DGS's rates, L1 + 0.2 D-SSIM), the scene
    extent from the config's box as the train CLI takes it from the
    scene's bounds, and the traffic's overrides."""
    box = config["scene"]
    extent = math.dist(box["box_min"], box["box_max"]) * 0.5
    tc = dict(lr_means=1.6e-4, lr_means_final=1.6e-6,
              lr_means_decay_steps=30_000, lr_log_scales=5e-3,
              lr_quats=1e-3, lr_opacities=5e-2, lr_sh=2.5e-3,
              sh_rest_lr_scale=1.0 / 20.0, ssim_weight=0.2,
              scene_extent=extent, adam_eps=1e-15)
    tc.update(traffic.get("train", {}))
    return tc


def _cameras(config, traffic, device):
    fov = math.radians(config["fov_deg"])
    rc = config["raster"]
    aspect = rc["image_width"] / rc["image_height"]
    box = config["scene"]
    poses = inputs.ring_poses(traffic["ring_pitch_deg"],
                              traffic["views_per_ring"])
    return [tuple(t.to(device) for t in inputs.orbit_camera(
        box["box_min"], box["box_max"], fov, aspect, p, y))
        for p, y in poses]


def _gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / max(want, scale)


def norm_gaps(got: dict, want: dict, keys) -> float:
    """The worst leaf's gap of norms, over the larger of the reference
    leaf's norm and the median leaf's."""
    ng = {k: float(got[k].double().norm()) for k in keys}
    nw = {k: float(want[k].double().norm()) for k in keys}
    scale = statistics.median(nw.values())
    return max(_gap(ng[k], nw[k], scale) for k in keys)


def reference_steps(init, cams, views, targets, rc, tc, dtype):
    """The reference's first steps from `init` on `views`: (losses, first
    gradient, parameters after, per-step counts)."""
    params = {k: v.to(dtype) for k, v in init.items()}
    adam = ref.Adam(params, tc)
    losses, first, counts = [], None, []
    for view, target in zip(views, targets):
        v, p, e = (t.to(dtype) for t in cams[view])
        loss, grads, stats = ref.loss_and_grads(params, v, p, e,
                                                target.to(dtype), rc,
                                                tc["ssim_weight"])
        losses.append(float(loss))
        counts.append(stats)
        if first is None:
            first = grads
        params = adam.step(params, grads)
    return losses, first, params, counts


def compare(prog, refr, init):
    """The readings of the program's (or the control's) first steps
    against the reference's."""
    keys = inputs.FIELDS
    losses_p, g_p, after_p, tgt_p = prog
    losses_r, g_r, after_r, tgt_r = refr
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    grad_gap = norm_gaps(g_p, g_r, keys)
    gnorm = {k: float(g_r[k].double().norm()) for k in keys}
    med = statistics.median(gnorm.values())
    moved = [k for k in keys if gnorm[k] >= STILL_SHARE * med]
    d_p = {k: after_p[k].double() - init[k].double() for k in moved}
    d_r = {k: after_r[k].double() - init[k].double() for k in moved}
    change_gap = norm_gaps(d_p, d_r, moved)
    target = max(harness.rel_l2(a, b) for a, b in zip(tgt_p, tgt_r))
    out = dict(target_rel_l2=target, loss_gap=loss_gap, grad_gap=grad_gap,
               change_gap=change_gap)
    return {k: (v if math.isfinite(v) else float("inf"))
            for k, v in out.items()}


def run(ctx) -> dict:
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import pipeline
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig

    cell, dev, spans = ctx.cell, ctx.device, ctx.spans
    config, traffic = cell.config, cell.traffic
    rc = config["raster"]
    tc = train_settings(config, traffic)
    n_check = int(traffic["checked_steps"])
    cams = _cameras(config, traffic, dev)
    n_views = len(cams)

    gt = inputs.make_scene(config["scene"], ctx.seed, dev)
    init = inputs.perturb(gt, traffic["perturb"], ctx.seed)
    order = inputs.epoch_order(n_views, ctx.seed, 0)
    checked_views = order[:n_check]

    if ctx.control:
        return _control(ctx, gt, init, cams, checked_views, rc, tc)

    # The capacity covers the ground truth and the start at every view.
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
    model = GaussianModel(*(init[k].clone() for k in inputs.FIELDS),
                          requires_grad=True)
    state = trainer.init_state(model, tcfg)
    h = rc["image_height"]

    def step_fn(state, camera, target):
        drops = []

        def image_fn(params, cam, rcfg):
            out = pipeline.render(params, cam, rcfg)
            drops.append(torch.stack([out.overflow, out.truncated]))
            if ctx.fault == "half_batch":
                return out.image[:h // 2]
            return out.image

        if ctx.fault == "step_unchanged":
            loss = trainer.loss_fn(state.params, camera, target, cfg, tcfg,
                                   image_fn)
            return state, (loss.detach(), drops[0])
        if ctx.fault == "half_batch":
            target = target[:h // 2]
        state, loss = trainer.train_step(state, camera, target, cfg, tcfg,
                                         image_fn=image_fn)
        if ctx.fault == "answer":
            loss = loss * 1.01
        return state, (loss, drops[0])

    engine = RenderEngine(RuntimeConfig(device=dev.type))
    cam_objs = [Camera(v, p, e) for v, p, e in cams]
    trainer.register_step(engine, state, cam_objs[order[0]],
                          targets[order[0]], cfg, tcfg, step_fn=step_fn)

    # One more replay, its effect undone: a graph's first launch uploads
    # it, which would stall the first checked step.
    held = [t for t in state.params.parameters()] + [
        t for st in state.opt_state.adam.values() for t in st] + [
        state.opt_state.means_lr_count, state.step]
    with torch.no_grad():
        saved = [t.detach().clone() for t in held]
        float(engine.run(trainer.STEP_PROGRAM, state, cam_objs[order[0]],
                         targets[order[0]])[0])
        for t, v in zip(held, saved):
            t.copy_(v)
        del saved

    inflight = collections.deque()
    losses, done, drops, nonfinite = [], [], [], [0]

    def submit(view):
        t = time.perf_counter()
        with spans("enqueue"):
            out = engine.run(trainer.STEP_PROGRAM, state, cam_objs[view],
                             targets[view])
        inflight.append((t, out))

    def retire():
        _, (loss, d) = inflight.popleft()
        with spans("retire"):
            value = float(loss)
        losses.append(value)
        done.append(time.perf_counter())
        drops.append(d)
        if not math.isfinite(value):
            nonfinite[0] += 1

    snap = {}

    def checked_steps():
        for i, view in enumerate(checked_views):
            submit(view)
            if i == 0:
                with spans("snapshot"):
                    snap["mu"] = {k: state.opt_state.adam[k].mu.detach()
                                  .clone() for k in inputs.FIELDS}
            if len(inflight) >= traffic["in_flight"]:
                retire()
        with spans("snapshot"):
            snap["after"] = {k: getattr(state.params, k).detach().clone()
                             for k in inputs.FIELDS}
        while inflight:
            retire()

    checked_steps()
    checked_losses = list(losses)

    pos, epoch = [n_check], [0]
    cur = [order]

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
    steps = 0
    while time.perf_counter() < deadline:
        submit(next_view())
        steps += 1
        if len(inflight) >= traffic["in_flight"]:
            retire()
    while inflight:
        retire()
    t_end = time.perf_counter()
    setup_s = t0 - ctx.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    per = torch.stack(drops) != 0
    bad = per.any(dim=1)
    overflowed, truncated = (int(x) for x in per[n_check:].sum(dim=0))
    failed = int(bad[n_check:].sum()) + nonfinite[0]
    enqueue = list(spans.times.get("enqueue", []))
    last_loss = losses[-1] if losses else None
    epochs = epoch[0] + 1

    # The traced stretch: one more epoch through the window's loop.
    prof, stretch_views, stretch_start, stretch_s = {}, [], None, None
    if ctx.trace:
        stretch_views = inputs.epoch_order(n_views, ctx.seed, epochs)
        with torch.no_grad():
            stretch_start = {k: getattr(state.params, k).detach().clone()
                             for k in inputs.FIELDS}
        with harness.profiled(prof, spans):
            t_p = time.perf_counter()
            for view in stretch_views:
                submit(view)
                if len(inflight) >= traffic["in_flight"]:
                    retire()
            while inflight:
                retire()
            stretch_s = time.perf_counter() - t_p

    prog_targets = [targets[v].clone() for v in checked_views]
    g_prog = {k: v / (1.0 - B1) for k, v in snap["mu"].items()}
    del engine, state, model, targets, inflight
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref_targets = [ref.render(gt, *cams[v], rc)["image"]
                   for v in checked_views]
    losses_r, g_r, after_r, _ = reference_steps(
        init, cams, checked_views, ref_targets, rc, tc, torch.float32)
    readings = compare(
        (checked_losses, g_prog, snap["after"], prog_targets),
        (losses_r, g_r, after_r, ref_targets), init)
    reference_s = time.perf_counter() - t_ref
    work = []
    for view in stretch_views:
        r = ref.render(stretch_start, *cams[view], rc)
        work.append(dict(pairs=r["pairs"], live=r["live"]))
    step_ms = (t_end - t0) * 1e3 / max(steps, 1)
    checked_bad = int(bad[:n_check].sum())
    return dict(
        attempted=steps, failed=failed, readings=readings, checked=n_check,
        e2e={"setup_s": setup_s, "step_ms": step_ms},
        layer=dict(kind="train", enqueue_s=enqueue, profile=prof,
                   work=work, items=len(stretch_views),
                   item_s=step_ms * 1e-3,
                   ssim_weight=tc["ssim_weight"]),
        memory_peak_bytes=int(peak),
        info=dict(pair_capacity=cap, steps=steps, epochs=epochs,
                  reference_s=reference_s,
                  per_second=harness.per_second(done, t0),
                  window_step_ms=step_ms,
                  stretch_step_ms=(stretch_s * 1e3 / len(stretch_views)
                                   if stretch_views else None),
                  target_failed=target_failed, overflowed=overflowed,
                  truncated=truncated,
                  checked_steps_failed=checked_bad,
                  checked_views=checked_views,
                  losses_program=checked_losses, losses_reference=losses_r,
                  last_loss=last_loss))


def _control(ctx, gt, init, cams, views, rc, tc):
    """The control: the reference in bfloat16 in the program's place
    (its targets and its steps), judged as a run is."""
    bf = torch.bfloat16
    gtb = {k: v.to(bf) for k, v in gt.items()}
    tgt_c = [ref.render(gtb, *(t.to(bf) for t in cams[v]), rc)["image"]
             for v in views]
    l_c, g_c, a_c, _ = reference_steps(init, cams, views, tgt_c, rc, tc, bf)
    tgt_r = [ref.render(gt, *cams[v], rc)["image"] for v in views]
    l_r, g_r, a_r, _ = reference_steps(init, cams, views, tgt_r, rc, tc,
                                       torch.float32)
    readings = compare((l_c, g_c, a_c, [t.float() for t in tgt_c]),
                       (l_r, g_r, a_r, tgt_r), init)
    return dict(attempted=len(views), failed=0, checked=len(views),
                readings=readings, e2e={}, layer=None,
                memory_peak_bytes=0, info=dict(control="bfloat16"))
