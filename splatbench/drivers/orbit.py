"""The `orbit` traffic: one viewer in a closed loop, the app's headless
orbit path (app/main.py::run).

The frames program is app/main.splat_program, registered in a RenderEngine
(warm-ups and one CUDA-graph capture) and replayed once a frame with the
frame's camera copied in. Up to `in_flight` frames are outstanding; the
oldest is retired by copying its image to host memory, and a frame is
delivered when that copy returns. The copy goes to page-locked memory
(torch's caching host allocator), as the port's own host transfers do: the
app's retire copies to pageable memory, whose staging memcpy on the host
took half of a 37.9k-gaussian frame and is the harness's, not the
program's.
The yaw steps `yaw_step_deg` a frame on from a whole-degree start drawn
from the seed; the cameras of every pose are made at set-up.

Correct: once the window has closed, `checked_frames` frames drawn from
the seed over the window (a reservoir sample) are rendered again by the
plain reference and compared: the worst relative L2 error of the RGBA
image and the worst absolute error of one value.

A traced run profiles `profiled_frames` more frames after the window,
through the window's own loop: the next poses of the orbit, the same
retire, which drops each image once it is in host memory. The reference
counts the work of those poses for the work model.
"""

from __future__ import annotations

import collections
import math
import random
import time

import torch

from splatbench import harness, inputs
from splatbench.reference import render as ref


def _cameras(config, pitch, yaws, device):
    fov = math.radians(config["fov_deg"])
    rc = config["raster"]
    aspect = rc["image_width"] / rc["image_height"]
    box = config["scene"]
    out = {}
    for y in yaws:
        v, p, e = inputs.orbit_camera(box["box_min"], box["box_max"], fov,
                                      aspect, pitch, y)
        out[y] = tuple(t.to(device) for t in (v, p, e))
    return out


def _yaw(start, k, step):
    return float((start + k * step) % 360.0)


def reference_frames(params, cams, poses, rc, dtype=torch.float32):
    """The reference's image and counts of each pose."""
    p = {k: v.to(dtype) for k, v in params.items()}
    out = []
    for y in poses:
        v, pr, e = (t.to(dtype) for t in cams[y])
        out.append(ref.render(p, v, pr, e, rc))
    return out


def run(ctx) -> dict:
    from gaussian_splat_ipu_tpu_torch.app.main import splat_program
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig

    cell, dev, spans = ctx.cell, ctx.device, ctx.spans
    config, traffic = cell.config, cell.traffic
    rc = config["raster"]
    step = float(traffic["yaw_step_deg"])
    if not (360.0 / step).is_integer():
        raise ValueError(f"yaw_step_deg {step}: the orbit's poses repeat "
                         "only for a step that divides 360")
    start = inputs.orbit_start_yaw(ctx.seed)
    rng = random.Random(ctx.seed)
    n_check = int(traffic["checked_frames"])
    n_prof = int(traffic["profiled_frames"]) if ctx.trace else 0

    params = inputs.make_scene(config["scene"], ctx.seed, dev)
    all_yaws = sorted({_yaw(start, k, step)
                       for k in range(int(360.0 / step))})
    cams = _cameras(config, float(traffic["pitch_deg"]), all_yaws, dev)

    if ctx.control:
        return _control(ctx, params, cams, start, step, n_check, rng)

    model = GaussianModel(*(params[k].clone() for k in inputs.FIELDS))
    cap = harness.probe_capacity(config, [params],
                                 [cams[y] for y in all_yaws])
    cfg = harness.raster_config(config, cap)
    engine = RenderEngine(RuntimeConfig(device=dev.type))
    v0, p0, e0 = cams[_yaw(start, 0, step)]
    engine.register("project", splat_program(cfg),
                    (model, v0.clone(), p0.clone(), e0.clone()))

    pinned = dev.type == "cuda"
    inflight = collections.deque()
    lat, done, drops, sample, seen = [], [], [], [], [0]
    delivered = [None]

    def submit(k, yaw):
        v, p, e = cams[yaw]
        t = time.perf_counter()
        with spans("enqueue"):
            out = engine.run("project", model, v, p, e)
        inflight.append((k, yaw, t, out))

    def retire(keep):
        k, yaw, t, out = inflight.popleft()
        with spans("to_host"):
            img = torch.empty(out.image.shape, dtype=out.image.dtype,
                              pin_memory=pinned)
            img.copy_(out.image)
        now = time.perf_counter()
        delivered[0] = now
        if keep is None:
            return
        lat.append(now - t)
        done.append(now)
        drops.append((out.overflow, out.truncated))
        if ctx.fault == "answer":
            img = img.clone()
            img[0, 0, 0] += 0.5
        if ctx.fault == "half_batch":
            img = img.clone()
            img[img.shape[0] // 2:] = 0.0
        # Reservoir sample of the window's frames, drawn from the seed.
        i = seen[0]
        seen[0] += 1
        if i < n_check:
            sample.append((k, yaw, img))
        else:
            j = rng.randrange(i + 1)
            if j < n_check:
                sample[j] = (k, yaw, img)

    def loop(k0, yaws, keep, deadline=None):
        k = k0
        for yaw in yaws:
            if deadline is not None and time.perf_counter() >= deadline:
                break
            submit(k, yaw)
            k += 1
            if len(inflight) >= traffic["in_flight"]:
                retire(keep)
        while inflight:
            retire(keep)
        return k

    # Warm-up: a few frames through the loop's own path (replay, copy).
    with torch.inference_mode():
        loop(0, [_yaw(start, k, step) for k in range(4)], None)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    def window_yaws():
        k = 0
        while True:
            yield _yaw(start, k, step)
            k += 1

    spans.times.clear()
    with torch.inference_mode():
        t0 = time.perf_counter()
        frames = loop(0, window_yaws(), True, t0 + ctx.seconds)
        t_end = delivered[0]
    setup_s = t0 - ctx.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bad = torch.stack([torch.stack([o, t]) for o, t in drops]) \
        if drops else torch.zeros((0, 2), dtype=torch.int32)
    failed = int(((bad != 0).any(dim=1)).sum())
    overflowed, truncated = (int(x) for x in (bad != 0).sum(dim=0))
    enqueue = list(spans.times.get("enqueue", []))

    # The traced stretch: the window's loop on over the orbit's next poses.
    prof, prof_yaws = {}, [_yaw(start, frames + i, step)
                           for i in range(n_prof)]
    stretch_s = None
    if n_prof:
        with torch.inference_mode(), harness.profiled(prof, spans):
            t_p = time.perf_counter()
            loop(frames, prof_yaws, None)
            stretch_s = time.perf_counter() - t_p

    del engine, model, inflight
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The comparison, after the window and after the program's state is
    # freed.
    checked = sample
    t_ref = time.perf_counter()
    refs = reference_frames(params, cams, [y for _, y, _ in checked], rc)
    rel, mx, wrong = 0.0, 0.0, 0
    for (_, _, img), r in zip(checked, refs):
        a = r["image"].to(img.device)
        e_rel, e_max = harness.rel_l2(img, a), harness.max_abs(img, a)
        if not math.isfinite(e_rel):
            e_rel = e_max = float("inf")
        rel, mx = max(rel, e_rel), max(mx, e_max)
        if not (e_rel <= cell.limits["img_rel_l2"]
                and e_max <= cell.limits["img_max_abs"]):
            wrong += 1
    readings = {"img_rel_l2": rel, "img_max_abs": mx}
    reference_s = time.perf_counter() - t_ref
    del refs
    work = []
    for y in prof_yaws:
        r = ref.render(params, *cams[y], rc)
        work.append(dict(pairs=r["pairs"], live=r["live"]))
    frame_ms = (t_end - t0) * 1e3 / max(frames, 1)
    return dict(
        attempted=frames, failed=failed + wrong, readings=readings,
        checked=len(checked),
        e2e={"setup_s": setup_s,
             "frame_ms": frame_ms,
             "frame_p95_ms": harness.percentile(lat, 95) * 1e3},
        layer=dict(kind="view", enqueue_s=enqueue, profile=prof,
                   work=work, items=n_prof, item_s=frame_ms * 1e-3),
        memory_peak_bytes=int(peak),
        info=dict(pair_capacity=cap, frames=frames, start_yaw=start,
                  reference_s=reference_s,
                  per_second=harness.per_second(done, t0),
                  window_frame_ms=frame_ms,
                  stretch_frame_ms=(stretch_s * 1e3 / n_prof
                                    if n_prof else None),
                  overflowed=overflowed, truncated=truncated,
                  checked_frames=[k for k, _, _ in checked]))


def _control(ctx, params, cams, start, step, n_check, rng):
    """The control: the reference in bfloat16 in the program's place, on
    as many seeded poses as a run checks, judged as a run is."""
    rc = ctx.cell.config["raster"]
    poses = [_yaw(start, rng.randrange(360), step) for _ in range(n_check)]
    got = reference_frames(params, cams, poses, rc, torch.bfloat16)
    refs = reference_frames(params, cams, poses, rc)
    rel = max(harness.rel_l2(g["image"].float(), r["image"])
              for g, r in zip(got, refs))
    mx = max(harness.max_abs(g["image"].float(), r["image"])
             for g, r in zip(got, refs))
    return dict(attempted=len(poses), failed=0, checked=len(poses),
                readings={"img_rel_l2": rel, "img_max_abs": mx},
                e2e={}, layer=None, memory_peak_bytes=0,
                info=dict(control="bfloat16"))
