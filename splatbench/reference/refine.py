"""The plain reference of a fit that refines its cameras: per-view pose
deltas and exposure maps trained with the scene.

Plain PyTorch, written for the benchmark: it imports nothing of the
program and nothing of JAX. It computes in the dtype it is given (the
configuration's float32; the control's bfloat16), with TF32 off as the
harness sets it, on the device of its inputs.

What it computes, from the published equations:

- pose: a tangent delta (w, v) in R^6 corrects the view matrix as
  exp(delta) @ view, exp the SE(3) exponential (Rodrigues' rotation
  I + a [w]x + b [w]x^2, a = sin t / t, b = (1 - cos t) / t^2, and the
  translation (I + b [w]x + c [w]x^2) v, c = (t - sin t) / t^3, t = |w|);
- exposure: a per-view 3x4 affine map [M | b] on the rendered image's
  RGB, rgb' = M rgb + b, the coverage channel passed through;
- the render, the loss and the scene's Adam: render.py's, the projection
  under autograd with the view built from the delta (so the view's
  gradient is autograd's through render.py's `project`), compositing and
  its gradient by render.py's `composite` / `composite_vjp`;
- the deltas' and the maps' steps: optax.adam(lr, b1 0.9, b2 0.999,
  eps 1e-15), each tensor updated whole (every view's row moves on its
  moments, the visited view's with its gradient).

Departures, each chosen to state the configuration's semantics rather
than another trainer's: the SE(3) tangent is left-multiplied on the view
(gsplat learns a 9-D embedding on camera-to-world); the map acts as
M @ rgb (graphdeco's rgb @ M: the transpose); the rates are constant (no
exposure decay, no pose_opt_reg). Below t^2 = 1e-8 the exponential takes
its series (a = 1 - t^2 / 6, b = 1/2 - t^2 / 24, c = 1/6 - t^2 / 120),
where the closed forms lose their digits; the branch not taken is made
finite first so that its gradient is too, at the zero start.
"""

from __future__ import annotations

import torch

from splatbench.reference import render as ref

B1, B2, EPS = 0.9, 0.999, 1e-15
FIELDS = ref.FIELDS


def _hat(w):
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def se3_exp(delta):
    """(4, 4) exp of the tangent delta = (w, v)."""
    w, v = delta[:3], delta[3:]
    t2 = (w * w).sum()
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / (t2s * t))
    k = _hat(w)
    k2 = k @ k
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    rot = eye + a * k + b * k2
    trans = (eye + b * k + c * k2) @ v
    out = torch.eye(4, dtype=delta.dtype, device=delta.device)
    out = torch.cat([torch.cat([rot, trans[:, None]], 1), out[3:]], 0)
    return out


def exposure(image, mat):
    """The map [M | b] (3, 4) on an (H, W, 4) image's RGB."""
    rgb = torch.einsum("ij,hwj->hwi", mat[:, :3], image[..., :3]) + mat[:, 3]
    return torch.cat([rgb, image[..., 3:]], -1)


def loss_and_grads(params: dict, delta, mat, view, proj, env_rot, target,
                   rc: dict, ssim_weight: float):
    """(loss, {field: gradient}, the delta's gradient (6,), the map's
    (3, 4), frame stats) of one view whose camera is `view` corrected by
    `delta` and whose image goes through `mat`."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    d = delta.detach().requires_grad_(True)
    m = mat.detach().requires_grad_(True)
    with torch.enable_grad():
        posed = se3_exp(d) @ view
        sp = ref.project(leaves, posed, proj, env_rot, rc)
        rows = ref.splat_rows(sp)
    with torch.no_grad():
        tile, gid, pairs = ref.tile_lists(
            {k: v.detach() for k, v in sp.items()}, rc)
        image, live, carries = ref.composite(rows.detach(), tile, gid, rc,
                                             keep_carries=True)
    img = image.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = ref.loss_of(exposure(img, m), target.to(img.dtype),
                           ssim_weight)
        g_img, g_mat = torch.autograd.grad(loss, (img, m))
    with torch.no_grad():
        d_rows = ref.composite_vjp(rows.detach(), gid, rc, carries, g_img)
    with torch.enable_grad():
        *grads, g_delta = torch.autograd.grad(
            rows, [leaves[k] for k in FIELDS] + [d], d_rows,
            allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(FIELDS, grads)}
    if g_delta is None:
        g_delta = torch.zeros_like(d)
    return loss.detach(), grads, g_delta, g_mat, dict(pairs=pairs, live=live)


class AuxAdam:
    """optax.adam(lr, b1, b2, eps) on one tensor, updated whole."""

    def __init__(self, value, lr: float):
        self.lr, self.count = lr, 0
        self.mu = torch.zeros_like(value)
        self.nu = torch.zeros_like(value)

    def step(self, value, grad):
        self.count += 1
        self.mu = (1.0 - B1) * grad + B1 * self.mu
        self.nu = (1.0 - B2) * (grad * grad) + B2 * self.nu
        d = (self.mu / (1.0 - B1 ** self.count)) / (
            torch.sqrt(self.nu / (1.0 - B2 ** self.count)) + EPS)
        return value + d * -self.lr


def steps(init: dict, deltas, mats, cams, views, targets, rc: dict,
          tc: dict, aux: dict, dtype):
    """The reference's first steps from `init` (and the (V, 6) deltas and
    (V, 3, 4) maps) on `views` (indices into `cams`, each (view, proj,
    env_rot)) against `targets`: a dict of the losses, the scene's first
    gradients, the deltas' and the maps' first moments after the first
    step, and the parameters, deltas and maps after the last."""
    params = {k: v.to(dtype) for k, v in init.items()}
    deltas, mats = deltas.to(dtype), mats.to(dtype)
    adam = ref.Adam(params, tc)
    pose = AuxAdam(deltas, aux["pose_lr"])
    expo = AuxAdam(mats, aux["exposure_lr"])
    losses, first = [], None
    mu_pose = mu_expo = None
    for view, target in zip(views, targets):
        v, p, e = (t.to(dtype) for t in cams[view])
        loss, grads, g_d, g_m, _ = loss_and_grads(
            params, deltas[view], mats[view], v, p, e, target.to(dtype), rc,
            tc["ssim_weight"])
        losses.append(float(loss))
        params = adam.step(params, grads)
        g_deltas = torch.zeros_like(deltas)
        g_deltas[view] = g_d
        g_mats = torch.zeros_like(mats)
        g_mats[view] = g_m
        deltas = pose.step(deltas, g_deltas)
        mats = expo.step(mats, g_mats)
        if first is None:
            first = grads
            mu_pose, mu_expo = pose.mu.clone(), expo.mu.clone()
    return dict(losses=losses, grads=first, mu_pose=mu_pose,
                mu_exposure=mu_expo, params=params, deltas=deltas, mats=mats)
