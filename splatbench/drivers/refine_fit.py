"""The `refine-fit` traffic: the train CLI's aux step with pose refinement
and exposure compensation (app/train.py --pose-opt --exposure-opt) in a
closed loop.

Set-up makes the config's scene from the seed (the ground truth), the
true views on the traffic's elevation rings (fit's), one exposure map a
view (gains on the diagonal and a bias, drawn from the seed) and one SE(3)
pose error a view (a rotation vector and a translation, each component
normal, drawn from the seed). The targets are the ground truth's images
at the TRUE views, rendered by the program, each put through its view's
exposure map; the training cameras are the true views left-multiplied by
their errors. The fit starts from fit's perturbed ground truth, zero
deltas and identity maps. The step is train/aux_opt.step_program at the
config's `aux` rates, registered by trainer.register_view_step as the
train CLI registers it (forward with the corrected camera and the mapped
image, loss, backward with the view's gradient from kernel G-bwd, the
scene's Adam and the deltas' and the maps' as one CUDA-graph replay, the
view's index, camera and target copied in). Up to `in_flight` steps are
outstanding; the oldest is retired by reading its loss on the host; views
in a fresh order drawn from the seed each epoch.

Correct: set-up drives that same step object through its first
`checked_steps` steps, on the first views of the first epoch, and keeps
Adam's first moments after step 1 (of the scene, the deltas and the maps)
and the state after the last. After the window the plain reference
(reference/refine.py) renders those views' targets itself and follows the
same steps from the same start. Compared: fit's four readings of the
scene, and the deltas' and the maps' first moments after step 1 and their
change after the last, each as the relative L2 distance from the
reference's. The window's steps are held to finite losses; pairs are
checked at set-up (targets, the start at every training camera) and once
after the window (every training view at the final state and deltas), a
view that drops any counting as a failed step.

A traced run records the program's spans and counters (utils/profiling.py)
from before the registration, so the captured step holds its stamps, and
profiles one more epoch after the window through the window's own loop;
its reading holds each step's spans, the counters "project.view_grad"
(G-bwd launches with the view's gradient) and the engine's replays, and
projection.plain_calls by reason; the reference counts each profiled
step's work (reference/work_project.frame_work: pairs, live evaluations
and live gaussians) at the parameters the stretch starts from.

The environment variable REFINE_FAULT plants one of `no_sh_term` (the
view's gradient without the SH view direction's term), `no_w_term`
(without the EWA W term) or `maps_frozen` (the maps' Adam step left out),
for setting the limits; run.py's --fault is refused.
"""

from __future__ import annotations

import collections
import math
import os
import time

import torch

from splatbench import harness, inputs
from splatbench.reference import refine as refr
from splatbench.reference import render as ref
from splatbench.reference import work_project

fit = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "fit.py"),
    "splatbench_driver_fit")

FAULTS = ("no_sh_term", "no_w_term", "maps_frozen")
SPANS = ("pose", "exposure", "aux.adam")


def exposure_maps(views: int, drift: dict, seed: int, device):
    """(V, 3, 4) maps [diag(gains) | bias], drawn from the seed."""
    g = torch.Generator().manual_seed(int(seed) ^ 0xE4905)
    lo, hi = drift["gain"]
    gains = torch.rand((views, 3), generator=g) * (hi - lo) + lo
    lo, hi = drift["bias"]
    bias = torch.rand((views, 3), generator=g) * (hi - lo) + lo
    return torch.cat([torch.diag_embed(gains), bias[:, :, None]],
                     -1).to(device)


def pose_errors(views: int, noise: dict, seed: int) -> torch.Tensor:
    """(V, 4, 4) f32 SE(3) errors: exp of a rotation vector with each
    component N(0, rotation_deg) and a translation with each N(0,
    translation), drawn from the seed (Rodrigues' formula in float64)."""
    g = torch.Generator().manual_seed(int(seed) ^ 0x9D5E)
    w = torch.randn((views, 3), generator=g, dtype=torch.float64) \
        * math.radians(noise["rotation_deg"])
    t = torch.randn((views, 3), generator=g, dtype=torch.float64) \
        * noise["translation"]
    out = torch.eye(4, dtype=torch.float64).repeat(views, 1, 1)
    for i in range(views):
        out[i, :3, :3] = torch.matrix_exp(torch.tensor(
            [[0.0, -w[i, 2], w[i, 1]], [w[i, 2], 0.0, -w[i, 0]],
             [-w[i, 1], w[i, 0], 0.0]], dtype=torch.float64))
        out[i, :3, 3] = t[i]
    return out.float()


def plant_fault(fault: str, mats) -> None:
    """Plant a set-up fault (module docstring) in this process."""
    from gaussian_splat_ipu_tpu_torch.render.kernels import project
    from gaussian_splat_ipu_tpu_torch.train import trainer
    if fault in ("no_sh_term", "no_w_term"):
        cols = project.VIEW_ORIGIN if fault == "no_sh_term" else project.VIEW_W
        assemble = project.assemble_view_grad

        def dropped(parts, view):
            parts = parts.clone()
            parts[:, cols] = 0.0
            return assemble(parts, view)

        project.assemble_view_grad = dropped
    elif fault == "maps_frozen":
        adam_apply = trainer.adam_apply

        def frozen(param, grad, st, lr, eps=1e-15):
            if param is not mats:
                adam_apply(param, grad, st, lr, eps)

        trainer.adam_apply = frozen
    else:
        raise ValueError(f"REFINE_FAULT {fault!r}: expected one of {FAULTS}")


def compare(prog: dict, want: dict, init: dict) -> dict:
    """fit.compare's readings of the scene, and the deltas' and the maps'
    first moments and changes, each as the relative L2 distance from the
    reference's (prog and want: reference/refine.steps' dict, with the
    targets under "targets")."""
    out = fit.compare(
        (prog["losses"], prog["grads"], prog["params"], prog["targets"]),
        (want["losses"], want["grads"], want["params"], want["targets"]),
        init)
    rel = harness.rel_l2
    out.update(
        pose_grad_gap=rel(prog["mu_pose"], want["mu_pose"]),
        exposure_grad_gap=rel(prog["mu_exposure"], want["mu_exposure"]),
        pose_change_gap=rel(prog["deltas"], want["deltas"]),
        exposure_change_gap=rel(prog["mats"] - prog["mats0"],
                                want["mats"] - want["mats0"]))
    return {k: (v if math.isfinite(v) else float("inf"))
            for k, v in out.items()}


def _layer_spans(rec) -> list:
    """Per engine run (in order), the device ms of each span of SPANS (the
    aux step's own)."""
    per = {}
    for s in rec.collect():
        if s.name in SPANS and s.track == "device" and s.item >= 0:
            d = per.setdefault(s.item, {})
            d[s.name] = d.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return [per[k] for k in sorted(per)]


def run(ctx) -> dict:
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render import pipeline, projection
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.train import aux_opt, pose_opt, trainer
    from gaussian_splat_ipu_tpu_torch.utils import profiling
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig

    cell, dev, spans = ctx.cell, ctx.device, ctx.spans
    if ctx.fault:
        raise ValueError(f"--fault {ctx.fault}: this traffic plants its "
                         f"faults through REFINE_FAULT ({FAULTS})")
    config, traffic = cell.config, cell.traffic
    rc = config["raster"]
    tc = fit.train_settings(config, traffic)
    aux_rates = config["aux"]
    pose_lr, expo_lr = aux_rates["pose_lr"], aux_rates["exposure_lr"]
    n_check = int(traffic["checked_steps"])
    true_cams = fit._cameras(config, traffic, dev)
    n_views = len(true_cams)
    errors = pose_errors(n_views, traffic["pose_noise"], ctx.seed).to(dev)
    cams = [(e @ v, p, r) for e, (v, p, r) in zip(errors, true_cams)]
    truth_maps = exposure_maps(n_views, traffic["exposure_drift"], ctx.seed,
                               dev)

    gt = inputs.make_scene(config["scene"], ctx.seed, dev)
    init = inputs.perturb(gt, traffic["perturb"], ctx.seed)
    order = inputs.epoch_order(n_views, ctx.seed, 0)
    checked_views = order[:n_check]
    deltas0 = torch.zeros((n_views, 6), device=dev)
    mats0 = torch.eye(3, 4, device=dev).repeat(n_views, 1, 1)

    if ctx.control:
        return _control(ctx, gt, init, true_cams, cams, truth_maps, deltas0,
                        mats0, checked_views, rc, tc, aux_rates)

    cap = harness.probe_capacity(config, [gt, init], true_cams + cams)
    cfg = harness.raster_config(config, cap)

    def drops_of(model, views):
        with torch.no_grad():
            return [int((torch.stack([o.overflow, o.truncated]) != 0).any())
                    for o in (pipeline.render(model, Camera(*c), cfg)
                              for c in views)]

    with torch.no_grad():
        truth = GaussianModel(*(gt[k].clone() for k in inputs.FIELDS))
        targets, target_drops = [], []
        for (v, p, e), mat in zip(true_cams, truth_maps):
            out = pipeline.render(truth, Camera(v, p, e), cfg)
            targets.append(refr.exposure(out.image, mat))
            target_drops.append(torch.stack([out.overflow, out.truncated]))
        del truth
    target_failed = int((torch.stack(target_drops) != 0).any(1).sum())
    start_model = GaussianModel(*(init[k] for k in inputs.FIELDS))
    start_failed = sum(drops_of(start_model, cams))
    del start_model

    tcfg = trainer.TrainConfig(**tc)
    model = GaussianModel(*(init[k].clone() for k in inputs.FIELDS),
                          requires_grad=True)
    state = trainer.init_state(model, tcfg)
    aux = aux_opt.init_aux_state(n_views, pose_lr, expo_lr, device=dev)
    obs_all, mask_all = aux_opt.dummy_depth_obs(n_views, device=dev)
    fault = os.environ.get("REFINE_FAULT", "")
    if fault:
        plant_fault(fault, aux.exposure.mats)

    rec = profiling.start(dev) if ctx.trace else None
    plain0 = dict(projection.plain_calls)
    cam_objs = [Camera(v, p, e) for v, p, e in cams]
    view_idx = [torch.tensor(i, dtype=torch.int64, device=dev)
                for i in range(n_views)]
    engine = RenderEngine(RuntimeConfig(device=dev.type))
    aux_opt.register_step(engine, state, aux, view_idx[order[0]],
                          cam_objs[order[0]], targets[order[0]], obs_all,
                          mask_all, cfg, tcfg, pose_lr, expo_lr)

    def run_step(view):
        return engine.run(aux_opt.STEP_PROGRAM, state, aux, view_idx[view],
                          cam_objs[view], targets[view], obs_all, mask_all)

    # One more replay, its effect undone: a graph's first launch uploads
    # it, which would stall the first checked step.
    held = [t for t in state.params.parameters()] + [
        t for st in state.opt_state.adam.values() for t in st] + [
        state.opt_state.means_lr_count, state.step] + [
        t for m in aux for t in (m[0], *m[1])]
    with torch.no_grad():
        saved = [t.detach().clone() for t in held]
        float(run_step(order[0]))
        for t, v in zip(held, saved):
            t.copy_(v)
        del saved

    inflight = collections.deque()
    losses, done, nonfinite = [], [], [0]

    def submit(view):
        t = time.perf_counter()
        with spans("enqueue"):
            out = run_step(view)
        inflight.append((t, out))

    def retire():
        _, loss = inflight.popleft()
        with spans("retire"):
            value = float(loss)
        losses.append(value)
        done.append(time.perf_counter())
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
                    snap["mu_pose"] = aux.pose.opt_state.mu.detach().clone()
                    snap["mu_exposure"] = (aux.exposure.opt_state.mu
                                           .detach().clone())
            if len(inflight) >= traffic["in_flight"]:
                retire()
        with spans("snapshot"):
            snap["after"] = {k: getattr(state.params, k).detach().clone()
                             for k in inputs.FIELDS}
            snap["deltas"] = aux.pose.deltas.detach().clone()
            snap["mats"] = aux.exposure.mats.detach().clone()
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

    def counters():
        if rec is None:
            return {}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        s = rec.summary()
        return {k: s.get(k, 0) for k in ("project.view_grad",
                                         "replays." + aux_opt.STEP_PROGRAM)}

    before = counters()
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
    enqueue = list(spans.times.get("enqueue", []))
    last_loss = losses[-1] if losses else None
    epochs = epoch[0] + 1

    # The traced stretch: one more epoch through the window's loop.
    prof, stretch_views, stretch_start, stretch_s = {}, [], None, None
    step_spans = []
    try:
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
        after = counters()
        if rec is not None:
            step_spans = _layer_spans(rec)
    finally:
        if rec is not None:
            profiling.stop()
    plain = {k: v - plain0.get(k, 0)
             for k, v in projection.plain_calls.items()
             if v - plain0.get(k, 0)}
    counted = {k: after[k] - before[k] for k in after}

    # Pairs once more: every training view at the final state and deltas.
    with torch.no_grad():
        final_model = GaussianModel(*(getattr(state.params, k).detach()
                                      for k in inputs.FIELDS))
        final_cams = [(c.view, c.proj, c.env_rot) for c in
                      pose_opt.corrected_cameras(cam_objs, aux.pose.deltas)]
        final_failed = sum(drops_of(final_model, final_cams))
        del final_model
    failed = nonfinite[0] + final_failed

    prog = dict(losses=checked_losses,
                grads={k: v / (1.0 - fit.B1) for k, v in snap["mu"].items()},
                mu_pose=snap["mu_pose"], mu_exposure=snap["mu_exposure"],
                params=snap["after"], deltas=snap["deltas"],
                mats=snap["mats"], mats0=mats0,
                targets=[targets[v].clone() for v in checked_views])
    del engine, state, model, targets, inflight, aux
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref_targets = [refr.exposure(ref.render(gt, *true_cams[v], rc)["image"],
                             truth_maps[v]) for v in checked_views]
    want = refr.steps(init, deltas0, mats0, cams, checked_views, ref_targets,
                      rc, tc, aux_rates, torch.float32)
    want.update(targets=ref_targets, mats0=mats0)
    readings = compare(prog, want, init)
    reference_s = time.perf_counter() - t_ref
    t_work = time.perf_counter()
    work = [work_project.frame_work(stretch_start, *cams[view], rc)
            for view in stretch_views]
    work_s = time.perf_counter() - t_work
    step_ms = (t_end - t0) * 1e3 / max(steps, 1)
    return dict(
        attempted=steps, failed=failed, readings=readings, checked=n_check,
        e2e={"setup_s": setup_s, "step_ms": step_ms},
        layer=dict(kind="train", enqueue_s=enqueue, profile=prof,
                   work=work, items=len(stretch_views),
                   item_s=step_ms * 1e-3, ssim_weight=tc["ssim_weight"],
                   step_spans=step_spans),
        memory_peak_bytes=int(peak),
        info=dict(pair_capacity=cap, steps=steps, epochs=epochs,
                  reference_s=reference_s, work_s=work_s,
                  per_second=harness.per_second(done, t0),
                  window_step_ms=step_ms,
                  stretch_step_ms=(stretch_s * 1e3 / len(stretch_views)
                                   if stretch_views else None),
                  target_failed=target_failed, start_failed=start_failed,
                  final_failed=final_failed,
                  projection_plain_calls=plain,
                  counters=counted,
                  fault=fault or None,
                  checked_views=checked_views,
                  losses_program=checked_losses,
                  losses_reference=want["losses"], last_loss=last_loss))


def _control(ctx, gt, init, true_cams, cams, truth_maps, deltas0, mats0,
             views, rc, tc, aux_rates):
    """The control: the reference in bfloat16 in the program's place
    (its targets and its steps), judged as a run is."""
    bf = torch.bfloat16
    gtb = {k: v.to(bf) for k, v in gt.items()}
    tgt_c = [refr.exposure(ref.render(gtb, *(t.to(bf) for t in true_cams[v]),
                                  rc)["image"], truth_maps[v].to(bf))
             for v in views]
    got = refr.steps(init, deltas0, mats0, cams, views, tgt_c, rc, tc,
                     aux_rates, bf)
    got = {k: ({f: t.float() for f, t in v.items()} if isinstance(v, dict)
               else v if k == "losses" else v.float())
           for k, v in got.items()}
    got.update(targets=[t.float() for t in tgt_c], mats0=mats0)
    tgt_r = [refr.exposure(ref.render(gt, *true_cams[v], rc)["image"],
                       truth_maps[v]) for v in views]
    want = refr.steps(init, deltas0, mats0, cams, views, tgt_r, rc, tc,
                      aux_rates, torch.float32)
    want.update(targets=tgt_r, mats0=mats0)
    readings = compare(got, want, init)
    return dict(attempted=len(views), failed=0, checked=len(views),
                readings=readings, e2e={}, layer=None,
                memory_peak_bytes=0, info=dict(control="bfloat16"))
