"""The plain reference of adaptive density control: the statistics a
densifying train step gathers and one density-control event, as Kerbl et
al. 2023 (3D Gaussian Splatting for Real-Time Radiance Field Rendering,
arXiv:2308.04079) section 5.2 defines them, with the defaults of the
authors' code (arguments/__init__.py OptimizationParams: densify_grad_
threshold 2e-4, percent_dense 0.01, a split child's scales divided by 1.6,
min opacity 0.005).

Plain PyTorch, written for the benchmark: it imports nothing of the
program, only the plain reference of the renderer (render.py), whose
functions it composes. It computes in the dtype it is given (float32; the
control's bfloat16) and never in TF32.

(a) The step's statistics (`loss_and_stats`): for each gaussian, the norm
of d loss / d (screen x, screen y), each component scaled by half the
image's size in its axis (NDC-equivalent units, so that the threshold
holds at any resolution), taken from the x and y columns of the
compositing rows' cotangent (render.composite_vjp), and whether it was
visible (a nonzero projected radius). A fit adds the first to a running
sum over the steps where the second holds, and counts the second.

(b) One event (`event`), from a given state and given split noise:
- average gradient = sum / max(count, 1); a live gaussian above the
  threshold is a candidate;
- a gaussian is pruned where its opacity (after the sigmoid) is below
  min_opacity (and, where max_world_scale > 0, its largest world scale
  above that share of the scene extent);
- a kept candidate whose largest scale exceeds percent_dense x the scene
  extent splits: both children are sampled from the parent's Gaussian
  (mean + R diag(scale) eps, one eps each) with their scales divided by
  1.6; the first takes the parent's place. Any other kept candidate is
  cloned: an exact copy;
- the slot rule: births (the second split child, every clone) are ranked
  by average gradient, highest first, ties by slot index; free slots (not
  alive, or pruned) are taken in index order, birth b into free slot b;
- the moments of Adam of every row that changes meaning (split parents,
  slots born into, slots dead after the event) are zeroed; the
  statistics start again from zero.

Departures from the paper, each the program's documented design:
- The model lives in a static buffer of slots with an alive mask, so
  that one captured step serves a whole run; the paper's code grows and
  shrinks its tensors. Dead slots hold opacity and log-scale -30, which
  the projection culls.
- When the births outnumber the free slots, the lowest-ranked births are
  dropped; the paper's buffer always has room.
- The paper's code also prunes by screen-space size after an opacity
  reset (max_screen_size); this reference, like the program, has only the
  world-space rule, off by default.
"""

from __future__ import annotations

import math

import torch

from splatbench.reference import render as R

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIELDS = R.FIELDS
DEAD = -30.0
COUNT_NAMES = ("candidates", "splits", "clones", "placed", "dropped",
               "pruned", "alive")
DEFAULTS = dict(grad_threshold=2e-4, percent_dense=0.01, min_opacity=0.005,
                max_world_scale=0.0, split_scale_factor=1.6,
                scene_extent=1.0)


# -- (a) the step's statistics --------------------------------------------------

def screen_grad_norm(d_xy, rc: dict):
    """|d loss / d xy| of (N, 2) pixel-space gradients in NDC-equivalent
    units (x_px = (ndc + 1) W / 2)."""
    gx = d_xy[:, 0] * (0.5 * rc["image_width"])
    gy = d_xy[:, 1] * (0.5 * rc["image_height"])
    return torch.sqrt(gx * gx + gy * gy)


def loss_and_stats(params: dict, view, proj, env_rot, target, rc: dict,
                   ssim_weight: float):
    """render.loss_and_grads of one view, and its statistics: (loss,
    {field: gradient}, screen-gradient norm (N,), visible (N,) bool)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        sp = R.project(leaves, view, proj, env_rot, rc)
        rows = R.splat_rows(sp)
    with torch.no_grad():
        tile, gid, _ = R.tile_lists({k: v.detach() for k, v in sp.items()},
                                    rc)
        image, _, carries = R.composite(rows.detach(), tile, gid, rc,
                                        keep_carries=True)
    img = image.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = R.loss_of(img, target.to(img.dtype), ssim_weight)
        g_img, = torch.autograd.grad(loss, img)
    with torch.no_grad():
        d_rows = R.composite_vjp(rows.detach(), gid, rc, carries, g_img)
    with torch.enable_grad():
        grads = torch.autograd.grad(rows, [leaves[k] for k in FIELDS],
                                    d_rows, allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(FIELDS, grads)}
    visible = sp["radius"][:, 0].detach() > 0
    return (loss.detach(), grads, screen_grad_norm(d_rows[:, :2], rc),
            visible)


def steps(init: dict, cams, views, targets, rc: dict, tc: dict, dtype):
    """The reference's densifying steps from `init` on `views` (render.Adam
    after each): (losses, first gradient, parameters after, grad_sum,
    vis_count)."""
    params = {k: v.to(dtype) for k, v in init.items()}
    adam = R.Adam(params, tc)
    n = params["means"].shape[0]
    dev = params["means"].device
    grad_sum = torch.zeros((n,), dtype=dtype, device=dev)
    vis_count = torch.zeros((n,), dtype=torch.int32, device=dev)
    losses, first = [], None
    for view, target in zip(views, targets):
        v, p, e = (t.to(dtype) for t in cams[view])
        loss, grads, gn, vis = loss_and_stats(params, v, p, e,
                                              target.to(dtype), rc,
                                              tc["ssim_weight"])
        grad_sum = grad_sum + torch.where(vis, gn.to(dtype), 0.0)
        vis_count = vis_count + vis.to(torch.int32)
        losses.append(float(loss))
        if first is None:
            first = grads
        params = adam.step(params, grads)
    return losses, first, params, grad_sum, vis_count


# -- (b) one event ---------------------------------------------------------------

def _sample(means, rot, scales, eps):
    """mean + R diag(scale) eps, row by row, summed term by term."""
    v = scales * eps
    return means + (rot[:, :, 0] * v[:, 0:1] + rot[:, :, 1] * v[:, 1:2]
                    + rot[:, :, 2] * v[:, 2:3])


@torch.no_grad()
def event(params: dict, grad_sum, vis_count, alive, eps_a, eps_b,
          cfg: dict, moments=None) -> dict:
    """One density-control event (module docstring) on a buffer of C
    slots. params: {field: (C, ...)}; grad_sum (C,), vis_count (C,), alive
    (C,) bool; eps_a, eps_b (C, 3) the split noise (the first and the
    second child's); cfg: DEFAULTS' keys; moments: {name: (C, ...)} or
    None. Returns params, alive, moments (touched rows zeroed), touched
    (C,) bool and counts {COUNT_NAMES: int}."""
    c = {**DEFAULTS, **cfg}
    avg = grad_sum / torch.clamp_min(vis_count, 1).to(grad_sum.dtype)
    scales = torch.exp(params["log_scales"])
    smax = torch.amax(scales, dim=-1)
    ext = c["scene_extent"]

    candidate = alive & (avg > c["grad_threshold"])
    prune = torch.sigmoid(params["opacities"]) < c["min_opacity"]
    if c["max_world_scale"] > 0.0:
        prune = prune | (smax > c["max_world_scale"] * ext)
    keep = alive & ~prune
    big = smax > c["percent_dense"] * ext
    split = candidate & big & keep
    clone = candidate & ~big & keep

    rot = R._quat_to_rotmat(params["quats"])
    shrink = math.log(c["split_scale_factor"])
    out = {k: v.clone() for k, v in params.items()}
    out["means"][split] = _sample(params["means"], rot, scales,
                                  eps_a)[split]
    out["log_scales"][split] = params["log_scales"][split] - shrink
    child_means = torch.where(split[:, None],
                              _sample(params["means"], rot, scales, eps_b),
                              params["means"])

    births = torch.nonzero(split | clone)[:, 0]
    births = births[torch.argsort(-avg[births], stable=True)]
    free = torch.nonzero(~keep)[:, 0]
    n = min(int(births.shape[0]), int(free.shape[0]))
    src, dst = births[:n], free[:n]
    out["means"][dst] = child_means[src]
    out["log_scales"][dst] = out["log_scales"][src]
    for k in ("quats", "opacities", "sh"):
        out[k][dst] = params[k][src]

    alive_new = keep.clone()
    alive_new[dst] = True
    dead = ~alive_new
    out["opacities"][dead] = DEAD
    out["log_scales"][dead] = DEAD
    touched = split | dead
    touched[dst] = True
    moments_out = None
    if moments is not None:
        moments_out = {}
        for name, m in moments.items():
            m = m.clone()
            m[touched] = 0.0
            moments_out[name] = m
    counts = dict(zip(COUNT_NAMES, (
        int(candidate.sum()), int(split.sum()), int(clone.sum()), n,
        int(births.shape[0]) - n, int((alive & ~keep).sum()),
        int(alive_new.sum()))))
    return dict(params=out, alive=alive_new, moments=moments_out,
                touched=touched, counts=counts)
