"""Inputs of a cell, made from --seed: the scene, the poses and their
cameras. Both the program and the reference are handed what this module
makes; neither makes its own.

The camera is the app's orbit camera (app/main.orbit_camera, the port's
Camera.orbit): a look-at of the box from one bounding radius down +z,
rotated about x and y, with a frustum fitted to the box. This module keeps
its own copy of that arithmetic, f32 on the host, op for op as the port's,
so the traffic is the app's (tests/test_splatbench_inputs.py holds the two
equal) while the yardstick does not depend on the program's code.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


# -- scenes -----------------------------------------------------------------

def _uniform(gen, device, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def make_scene(scene: dict, seed: int, device) -> dict:
    """The five parameter tensors of the config's scene, f32 on `device`,
    drawn from `seed` by a generator on that device in a few large calls.

    kind "random": the port's GaussianModel.random distributions (means
    uniform in +-extent, log-scales U(-5.5, -3.5) + ln extent, normal
    quats, opacities U(-2, 4), SH U(-1, 1)).
    kind "clustered": GaussianModel.clustered's (each gaussian at a
    uniformly drawn cluster centre plus a normal offset times its spread,
    log-scales N(-4.5 + ln extent, 0.6), normal quats, opacities U(-4, 6),
    SH U(-1, 1)); the cluster centres (U(+-0.8 extent)) and spreads
    (log-uniform in [0.02, 0.3] extent) come from the config's
    layout_seed, so every seed renders the same layout and the work per
    frame does not swing with the seed."""
    n = int(scene["gaussians"])
    ext = float(scene["extent"])
    kk = (int(scene["sh_degree"]) + 1) ** 2
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if scene["kind"] == "random":
        means = _uniform(gen, device, (n, 3), -ext, ext)
        log_scales = _uniform(gen, device, (n, 3), -5.5, -3.5) + math.log(ext)
        quats = torch.randn((n, 4), generator=gen, device=device)
        opacities = _uniform(gen, device, (n,), -2.0, 4.0)
    elif scene["kind"] == "clustered":
        k = int(scene["clusters"])
        lay = torch.Generator().manual_seed(int(scene["layout_seed"]))
        centers = _uniform(lay, "cpu", (k, 3), -0.8 * ext, 0.8 * ext)
        spread = torch.exp(_uniform(lay, "cpu", (k,), math.log(0.02 * ext),
                                    math.log(0.3 * ext)))
        centers, spread = centers.to(device), spread.to(device)
        assign = torch.randint(0, k, (n,), generator=gen, device=device)
        means = centers[assign] + torch.randn(
            (n, 3), generator=gen, device=device) * spread[assign][:, None]
        log_scales = torch.randn((n, 3), generator=gen, device=device) \
            * 0.6 - 4.5 + math.log(ext)
        quats = torch.randn((n, 4), generator=gen, device=device)
        opacities = _uniform(gen, device, (n,), -4.0, 6.0)
    else:
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    sh = _uniform(gen, device, (n, kk, 3), -1.0, 1.0)
    return dict(means=means, log_scales=log_scales, quats=quats,
                opacities=opacities, sh=sh)


def perturb(params: dict, sigma: dict, seed: int) -> dict:
    """A copy of `params` with N(0, sigma[field]) noise added to each
    field, drawn from `seed` on the parameters' device (the fit's start)."""
    device = params["means"].device
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    return {k: params[k] + float(sigma[k]) * torch.randn(
        params[k].shape, generator=gen, device=device) for k in FIELDS}


# -- poses and cameras ------------------------------------------------------

def orbit_start_yaw(seed: int) -> int:
    """The orbit's first yaw, a whole degree drawn from the seed, so that
    every seed visits the same 360 poses in another order."""
    return int(torch.randint(0, 360, (1,), generator=torch.Generator()
                             .manual_seed(int(seed) ^ 0x0B17)))


def ring_poses(pitches, per_ring: int) -> list:
    """(pitch, yaw) in degrees of `per_ring` views evenly around each
    elevation ring."""
    return [(float(p), 360.0 * i / per_ring) for p in pitches
            for i in range(per_ring)]


def epoch_order(num_views: int, seed: int, epoch: int) -> list:
    """The visit order of one epoch: a fresh permutation drawn from the
    seed and the epoch (app/train.py --shuffle)."""
    g = torch.Generator().manual_seed(int(seed) * 1_000_003 + epoch)
    return torch.randperm(num_views, generator=g).tolist()


def _t(x):
    return torch.as_tensor(x, dtype=F32)


def _look_at(eye, center, up):
    f = center - eye
    f = f / torch.linalg.vector_norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = torch.linalg.cross(s, f)
    zero, one = torch.zeros((), dtype=F32), torch.ones((), dtype=F32)
    return torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        torch.stack([zero, zero, zero, one]),
    ])


def _rotation(deg, axis: str):
    a = _t(deg) * (math.pi / 180.0)
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    if axis == "x":
        rows = [[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]]
    else:
        rows = [[c, z, s, z], [z, o, z, z], [-s, z, c, z], [z, z, z, o]]
    return torch.stack([torch.stack(r) for r in rows])


def _frustum(l, r, b, t, n, f):
    zero = torch.zeros((), dtype=F32)
    return torch.stack([
        torch.stack([2 * n / (r - l), zero, (r + l) / (r - l), zero]),
        torch.stack([zero, 2 * n / (t - b), (t + b) / (t - b), zero]),
        torch.stack([zero, zero, -(f + n) / (f - n), -2 * f * n / (f - n)]),
        torch.stack([zero, zero, -torch.ones_like(zero), zero]),
    ])


def orbit_camera(box_min, box_max, fov_rad: float, aspect: float,
                 pitch_deg: float, yaw_deg: float):
    """(view, proj, env_rot) f32 host tensors of the app's orbit camera
    at (pitch, yaw), no translation, no environment rotation."""
    bb_min, bb_max = _t(box_min), _t(box_max)
    up = _t((0.0, 1.0, 1.0))
    center = (bb_min + bb_max) * 0.5
    radius = torch.linalg.vector_norm(bb_max - bb_min) * 0.5
    offset = torch.stack([torch.zeros_like(radius), torch.zeros_like(radius),
                          1.0 * radius])
    base = _look_at(center - offset, center, up)
    view = base @ _rotation(pitch_deg, "x")
    view = view @ _rotation(yaw_deg, "y")
    view = view @ torch.eye(4, dtype=F32)
    corners = torch.stack([bb_min, bb_max])
    pts = torch.cat([corners, torch.ones((2, 1), dtype=F32)], dim=-1)
    eye = (pts @ base.T)[:, :3]
    r = torch.linalg.vector_norm(eye[1] - eye[0]) * 0.5
    near = r / torch.tan(_t(fov_rad))
    far = near + 20.0 * r
    proj = _frustum(-r * aspect, r * aspect, -r, r, near, far)
    return view, proj, torch.zeros((2,), dtype=F32)
