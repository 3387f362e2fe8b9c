"""The aerial city of the rubble-40m configuration, made from --seed: the
scene shard by shard, the fit's start shard by shard, and the drone
cameras. The program's ranks and the plain reference are handed what this
module makes; neither makes its own.

Shard s of S holds the rows [s * N / S, (s + 1) * N / S) of the whole
model and is drawn from a generator seeded by (seed, s) alone, so a rank
makes its own shard without the others, and the reference makes the
whole model as the shards side by side (`make_scene`).

The scene is GaussianModel.clustered's distributions in a flat box: many
clusters (the buildings), each at a centre uniform over the ground, with
a footprint spread log-uniform in `spread` and a height log-uniform in
`height`; a gaussian sits at a uniformly drawn cluster's centre (lifted
by its height) plus a normal offset times (spread, height, spread);
log-scales N(-4.5 + ln extent + scale_shift, 0.6), normal quats,
opacities U(-4, 6), SH U(-1, 1). The layout (centres, spreads, heights)
comes from the config's layout_seed, so every seed flies over the same
city and the work per step does not swing with the seed. World y is up.

A drone view looks down at a point of the ground at a ring's pitch from a
ring's distance, facing the scene's centre: `rings` of the traffic give
each ring's pitch (degrees below the horizon), the radius of its target
points and the distance from target to camera. The projection is a
symmetric frustum of the config's vertical fov_deg (full angle).
"""

from __future__ import annotations

import math

import torch

from splatbench import inputs

FIELDS = inputs.FIELDS
PERTURB_SALT = 0x5EED


def _shard_seed(seed: int, shard: int, salt: int = 0) -> int:
    return ((int(seed) * 1_000_003 + int(shard) * 7_919 + salt)
            % (1 << 62))


def shard_rows(scene: dict) -> int:
    n, s = int(scene["gaussians"]), int(scene["shards"])
    if n % s:
        raise ValueError(f"{n} gaussians do not split over {s} shards")
    return n // s


def layout(scene: dict):
    """(centres (K, 3), spreads (K, 3)) f32 on the CPU, from layout_seed."""
    k = int(scene["clusters"])
    gen = torch.Generator().manual_seed(int(scene["layout_seed"]))
    hx, hz = (float(v) for v in scene["ground_half"])

    def log_uniform(lo, hi):
        return torch.exp(inputs._uniform(gen, "cpu", (k,), math.log(lo),
                                         math.log(hi)))

    cx = inputs._uniform(gen, "cpu", (k,), -hx, hx)
    cz = inputs._uniform(gen, "cpu", (k,), -hz, hz)
    spread = log_uniform(*scene["spread"])
    height = log_uniform(*scene["height"])
    centres = torch.stack([cx, height, cz], -1)
    spreads = torch.stack([spread, height, spread], -1)
    return centres, spreads


def make_shard(scene: dict, seed: int, shard: int, device) -> dict:
    """The five parameter tensors of shard `shard`, f32 on `device`."""
    n = shard_rows(scene)
    kk = (int(scene["sh_degree"]) + 1) ** 2
    ext = float(scene["extent"])
    gen = torch.Generator(device=device).manual_seed(_shard_seed(seed,
                                                                 shard))
    centres, spreads = (t.to(device) for t in layout(scene))
    assign = torch.randint(0, centres.shape[0], (n,), generator=gen,
                           device=device)
    means = centres[assign] + torch.randn(
        (n, 3), generator=gen, device=device) * spreads[assign]
    log_scales = torch.randn((n, 3), generator=gen, device=device) * 0.6 \
        - 4.5 + math.log(ext) + float(scene["scale_shift"])
    quats = torch.randn((n, 4), generator=gen, device=device)
    opacities = inputs._uniform(gen, device, (n,), -4.0, 6.0)
    sh = inputs._uniform(gen, device, (n, kk, 3), -1.0, 1.0)
    return dict(means=means, log_scales=log_scales, quats=quats,
                opacities=opacities, sh=sh)


def perturb_shard(params: dict, sigma: dict, seed: int, shard: int) -> dict:
    """A copy of shard `shard`'s `params` with N(0, sigma[field]) noise on
    each field, drawn from (seed, shard) (the fit's start)."""
    device = params["means"].device
    gen = torch.Generator(device=device).manual_seed(
        _shard_seed(seed, shard, PERTURB_SALT))
    return {k: params[k] + float(sigma[k]) * torch.randn(
        params[k].shape, generator=gen, device=device) for k in FIELDS}


def make_scene(scene: dict, seed: int, device, start: dict | None = None
               ) -> dict:
    """The whole model: every shard's rows in shard order (with `start`,
    the perturbation sigmas, the fit's start instead of the scene)."""
    parts = []
    for s in range(int(scene["shards"])):
        p = make_shard(scene, seed, s, device)
        if start is not None:
            p = perturb_shard(p, start, seed, s)
        parts.append(p)
    return {k: torch.cat([p[k] for p in parts]) for k in FIELDS}


def drone_camera(config: dict, pitch_deg: float, yaw_deg: float,
                 target_radius: float, distance: float):
    """(view, proj, env_rot) f32 host tensors of one drone view: the
    ground point at `target_radius` from the centre in direction yaw,
    seen from `distance` at `pitch_deg` below the horizon, facing the
    centre."""
    rc = config["raster"]
    aspect = rc["image_width"] / rc["image_height"]
    yaw, pitch = math.radians(yaw_deg), math.radians(pitch_deg)
    t = inputs._t
    target = t((target_radius * math.cos(yaw), 0.0,
                target_radius * math.sin(yaw)))
    back = t((math.cos(yaw) * math.cos(pitch), math.sin(pitch),
              math.sin(yaw) * math.cos(pitch)))
    eye = target + back * distance
    view = inputs._look_at(eye, target, t((0.0, 1.0, 0.0)))
    near = float(config["near"])
    top = near * math.tan(math.radians(float(config["fov_deg"])) * 0.5)
    proj = inputs._frustum(t(-top * aspect), t(top * aspect), t(-top),
                           t(top), t(near), t(float(config["far"])))
    return view, proj, torch.zeros((2,), dtype=inputs.F32)


def drone_cameras(config: dict, traffic: dict, device) -> list:
    """Every view of the traffic's rings, `views_per_ring` evenly around
    each, on `device`."""
    per = int(traffic["views_per_ring"])
    out = []
    for ring in traffic["rings"]:
        for i in range(per):
            cam = drone_camera(config, ring["pitch_deg"], 360.0 * i / per,
                               ring["target_radius"], ring["distance"])
            out.append(tuple(x.to(device) for x in cam))
    return out
