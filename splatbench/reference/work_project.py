"""The work model of kernel G-bwd (the projection's backward): the bytes
one launch must move, from the cell's scene, against the H100's memory
rate (reference/work.py's peaks).

Per gaussian it reads the cotangents of xy, conic, colour and opacity (9
floats; depth has no gradient in a render: binning only sorts by it) and
writes a gradient of each parameter (means 3, log-scales 3, quaternion 4,
opacity 1 and 3 (d + 1)^2 SH floats at the scene's degree d); a live
gaussian, one whose cotangents are not all zero, also reads its
parameters: 2 x 236 + 36 = 508 bytes at SH 3 live, 272 not. The view's
gradient (pose refinement: the kernel "project_bwd_view_kernel") adds one
row of 28 partial sums for each block of 128 gaussians.

The live gaussians of a frame are those with a live evaluation in the
reference's walk (`frame_work`); a cell whose driver does not count them
has every gaussian counted live, which overstates the bytes where many
are culled or hidden.
"""

from __future__ import annotations

import torch

from splatbench.reference import render as ref
from splatbench.reference import work as W

THREADS = 128
VIEW_PARTS = 28
COTANGENT_FLOATS = 2 + 3 + 3 + 1


def project_bwd_bytes(scene: dict, view: bool, live: int | None = None
                      ) -> int:
    """Bytes of one G-bwd launch over the scene's gaussians, `live` of them
    (default every one) with a cotangent that is not zero."""
    n = int(scene["gaussians"])
    live = n if live is None else int(live)
    params = 3 + 3 + 4 + 1 + 3 * (int(scene["sh_degree"]) + 1) ** 2
    out = 4 * (n * (params + COTANGENT_FLOATS) + live * params)
    if view:
        out += -(-n // THREADS) * VIEW_PARTS * 4
    return out


def project_bwd_bound_s(scene: dict, view: bool, live: int | None = None
                        ) -> float:
    """The least time of one launch: its bytes at the memory rate."""
    return W.bound_s(project_bwd_bytes(scene, view, live), 0.0)


def _blend(f, px, py, t_in, stop_in, rc):
    """render._chunk's walk of one block, line for line, keeping its blend
    mask (B, L, P) of the evaluations that blend; with the carry (t_out,
    stop_out)."""
    dx = f[..., 0, None] - px
    dy = f[..., 1, None] - py
    power = -0.5 * (f[..., 2, None] * dx * dx + f[..., 4, None] * dy * dy) \
        - f[..., 3, None] * dx * dy
    alpha = torch.clamp_max(f[..., 8, None] * torch.exp(power),
                            rc["alpha_clamp"])
    used = ~((power > 0.0) | (alpha < rc["alpha_min"]))
    fac = torch.where(used, 1.0 - alpha, 1.0)
    t_after = t_in[:, None, :] * torch.cumprod(fac, dim=1)
    eps = rc["transmittance_eps"]
    blend = used & (t_after >= eps) & ~stop_in[:, None, :]
    t_out = t_in * torch.prod(torch.where(blend, fac, 1.0), dim=1)
    stop_out = stop_in | (used & (t_after < eps)).any(dim=1)
    return blend, t_out, stop_out


def frame_work(params: dict, view, proj, env_rot, rc: dict) -> dict:
    """One frame's counts by the reference's walk (render.py's composite,
    block for block): its pairs and live evaluations, as `render` gives
    them, and `live_gaussians`, the gaussians with a live evaluation, the
    ones a loss gives cotangents that are not zero: the rows G-bwd reads."""
    with torch.no_grad():
        sp = ref.project(params, view, proj, env_rot, rc)
        feat = ref.splat_rows(sp)
        tile, gid, pairs = ref.tile_lists(sp, rc)
        n, dt, dev = feat.shape[0], feat.dtype, feat.device
        npix = ref.grid(rc)["npix"]
        hit = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
        live = torch.zeros((), dtype=torch.int64, device=dev)
        for t, pos, block in ref._block_plan(tile, gid, rc):
            px, py = ref._pixel_xy(rc, t, dt)
            t_in = torch.ones((t.shape[0], npix), dtype=dt, device=dev)
            stop = torch.zeros((t.shape[0], npix), dtype=torch.bool,
                               device=dev)
            for c0 in range(0, pos.shape[1], block):
                p = pos[:, c0:c0 + block]
                blend, t_in, stop = _blend(ref._gather(feat, gid, p), px, py,
                                           t_in, stop, rc)
                rows = torch.where(p >= 0, gid[p.clamp_min(0)], n)
                hit[rows[blend.any(dim=-1)]] = True
                live += blend.sum()
                if c0 + block < pos.shape[1] and bool(stop.all()):
                    break
    return dict(pairs=pairs, live=int(live),
                live_gaussians=int(hit[:n].sum()))
