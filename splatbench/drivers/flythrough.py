"""The `flythrough` traffic: one viewer in a closed loop flying through the
scene, the app's frame program as the orbit traffic drives it
(drivers/orbit.py: its loop, retire and check).

The camera moves on a horizontal circle of radius `loop_radius` about the
box's centre (y up), so that it passes through and beside the clusters,
and looks along the circle's tangent at `pitch_deg`: the app's free
camera (Camera.look_at: a look-at view and a symmetric perspective of
the configuration's vertical field `fov_deg`, as every driver takes it,
near and far planes as the traffic gives). `poses` poses close the loop,
one a frame, so a frame moves 2 pi `loop_radius` / `poses` world units,
from a pose drawn from the seed; the cameras of every pose are made at
set-up (f32 on the host, this module's own copy of the arithmetic), and
the capacity covers the worst demand over all of them.

The frames program is app/main.splat_program, registered in a
RenderEngine and replayed once a frame with the frame's camera copied in;
up to `in_flight` frames are outstanding, the oldest retired by copying
its image to page-locked host memory. Correct: once the window has
closed, `checked_frames` frames drawn from the seed over the window (a
reservoir sample) are rendered again by the plain reference and compared
as the orbit's are. A traced run profiles `profiled_frames` more frames
after the window, the loop's next poses, through the window's own loop.
"""

from __future__ import annotations

import collections
import math
import os
import random
import time

import torch

from splatbench import harness, inputs
from splatbench.reference import render as ref

orbit = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "orbit.py"),
    "splatbench_driver_orbit")


def start_pose(seed: int, poses: int) -> int:
    """The loop's first pose, drawn from the seed."""
    return int(torch.randint(0, poses, (1,), generator=torch.Generator()
                             .manual_seed(int(seed) ^ 0xF1E7)))


def loop_camera(config: dict, traffic: dict, k: int):
    """(view, proj, env_rot) f32 host tensors of pose k of the loop."""
    box = config["scene"]
    rc = config["raster"]
    center = (inputs._t(box["box_min"]) + inputs._t(box["box_max"])) * 0.5
    theta = 2.0 * math.pi * k / traffic["poses"]
    r = traffic["loop_radius"]
    eye = center + inputs._t((r * math.cos(theta), 0.0, r * math.sin(theta)))
    pitch = math.radians(traffic["pitch_deg"])
    ahead = inputs._t((-math.sin(theta) * math.cos(pitch), math.sin(pitch),
                       math.cos(theta) * math.cos(pitch)))
    view = inputs._look_at(eye, eye + ahead, inputs._t((0.0, 1.0, 0.0)))
    near, far = inputs._t(traffic["near"]), inputs._t(traffic["far"])
    aspect = rc["image_width"] / rc["image_height"]
    top = torch.tan(inputs._t(math.radians(config["fov_deg"])) * 0.5) * near
    proj = inputs._frustum(-top * aspect, top * aspect, -top, top, near, far)
    return view, proj, torch.zeros((2,), dtype=inputs.F32)


def run(ctx) -> dict:
    from gaussian_splat_ipu_tpu_torch.app.main import splat_program
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig

    cell, dev, spans = ctx.cell, ctx.device, ctx.spans
    config, traffic = cell.config, cell.traffic
    rc = config["raster"]
    n_poses = int(traffic["poses"])
    start = start_pose(ctx.seed, n_poses)
    rng = random.Random(ctx.seed)
    n_check = int(traffic["checked_frames"])
    n_prof = int(traffic["profiled_frames"]) if ctx.trace else 0

    def pose(k):
        return (start + k) % n_poses

    params = inputs.make_scene(config["scene"], ctx.seed, dev)
    cams = {k: tuple(t.to(dev) for t in loop_camera(config, traffic, k))
            for k in range(n_poses)}

    if ctx.control:
        poses = [pose(rng.randrange(n_poses)) for _ in range(n_check)]
        got = orbit.reference_frames(params, cams, poses, rc, torch.bfloat16)
        refs = orbit.reference_frames(params, cams, poses, rc)
        return dict(
            attempted=len(poses), failed=0, checked=len(poses),
            readings={"img_rel_l2": max(
                harness.rel_l2(g["image"].float(), r["image"])
                for g, r in zip(got, refs)),
                "img_max_abs": max(
                harness.max_abs(g["image"].float(), r["image"])
                for g, r in zip(got, refs))},
            e2e={}, layer=None, memory_peak_bytes=0,
            info=dict(control="bfloat16"))

    model = GaussianModel(*(params[k].clone() for k in inputs.FIELDS))
    cap = harness.probe_capacity(config, [params],
                                 [cams[k] for k in range(n_poses)])
    cfg = harness.raster_config(config, cap)
    engine = RenderEngine(RuntimeConfig(device=dev.type))
    v0, p0, e0 = cams[pose(0)]
    engine.register("project", splat_program(cfg),
                    (model, v0.clone(), p0.clone(), e0.clone()))

    pinned = dev.type == "cuda"
    inflight = collections.deque()
    lat, done, drops, sample, seen, pairs = [], [], [], [], [0], []
    delivered = [None]

    def submit(k):
        v, p, e = cams[pose(k)]
        t = time.perf_counter()
        with spans("enqueue"):
            out = engine.run("project", model, v, p, e)
        inflight.append((k, t, out))

    def retire(keep):
        k, t, out = inflight.popleft()
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
        pairs.append(out.count)
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
            sample.append((k, img))
        else:
            j = rng.randrange(i + 1)
            if j < n_check:
                sample[j] = (k, img)

    def loop(ks, keep, deadline=None):
        n = 0
        for k in ks:
            if deadline is not None and time.perf_counter() >= deadline:
                break
            submit(k)
            n += 1
            if len(inflight) >= traffic["in_flight"]:
                retire(keep)
        while inflight:
            retire(keep)
        return n

    def endless():
        k = 0
        while True:
            yield k
            k += 1

    # Warm-up: a few frames through the loop's own path (replay, copy).
    with torch.inference_mode():
        loop(range(4), None)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    spans.times.clear()
    with torch.inference_mode():
        t0 = time.perf_counter()
        frames = loop(endless(), True, t0 + ctx.seconds)
        t_end = delivered[0]
    setup_s = t0 - ctx.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bad = torch.stack([torch.stack([o, t]) for o, t in drops]) \
        if drops else torch.zeros((0, 2), dtype=torch.int32)
    failed = int(((bad != 0).any(dim=1)).sum())
    overflowed, truncated = (int(x) for x in (bad != 0).sum(dim=0))
    window_pairs = [int(x) for x in torch.stack(pairs)] if pairs else []
    enqueue = list(spans.times.get("enqueue", []))

    # The traced stretch: the window's loop on over the next poses.
    prof, prof_ks = {}, [frames + i for i in range(n_prof)]
    stretch_s = None
    if n_prof:
        with torch.inference_mode(), harness.profiled(prof, spans):
            t_p = time.perf_counter()
            loop(prof_ks, None)
            stretch_s = time.perf_counter() - t_p

    del engine, model, inflight
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    refs = orbit.reference_frames(params, cams, [pose(k) for k, _ in sample],
                                  rc)
    rel, mx, wrong = 0.0, 0.0, 0
    for (_, img), r in zip(sample, refs):
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
    for k in prof_ks:
        r = ref.render(params, *cams[pose(k)], rc)
        work.append(dict(pairs=r["pairs"], live=r["live"]))
    frame_ms = (t_end - t0) * 1e3 / max(frames, 1)
    return dict(
        attempted=frames, failed=failed + wrong, readings=readings,
        checked=len(sample),
        e2e={"setup_s": setup_s, "frame_ms": frame_ms,
             "frame_p95_ms": harness.percentile(lat, 95) * 1e3},
        layer=dict(kind="view", enqueue_s=enqueue, profile=prof,
                   work=work, items=n_prof, item_s=frame_ms * 1e-3),
        memory_peak_bytes=int(peak),
        info=dict(pair_capacity=cap, frames=frames, start_pose=start,
                  reference_s=reference_s,
                  per_second=harness.per_second(done, t0),
                  window_frame_ms=frame_ms,
                  stretch_frame_ms=(stretch_s * 1e3 / n_prof
                                    if n_prof else None),
                  window_pairs_median=(sorted(window_pairs)[
                      len(window_pairs) // 2] if window_pairs else None),
                  window_pairs_max=max(window_pairs, default=None),
                  overflowed=overflowed, truncated=truncated,
                  checked_frames=[k for k, _ in sample]))
