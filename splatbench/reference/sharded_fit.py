"""The plain reference of a fit step for a model too large to differentiate
in one piece: reference/render.py's frame, loss, gradient and Adam over
the whole model, with the projection and the update taken in blocks of
gaussians.

Plain PyTorch, written for the benchmark: it imports nothing of the
program. What it computes is the single-device semantics of
reference/render.py, to the op: the projection is a per-gaussian map, so
a block of rows projects as the whole would; the compositing walk and the
loss take every block's splats at once; the gradient of each block's
parameters is the autograd of its projection against that block's rows of
the splat cotangent (render.composite_vjp's), zero for rows whose
cotangent is zero; and the update is
render.Adam on each block of rows, one optimizer state per block (Adam
and the quaternions' renormalisation act row by row). No block holds the
autograd graph of more than BLOCK_ROWS gaussians.

One part is this module's own: `tile_lists`. render.tile_lists orders a
group's pairs by one int64 key that packs the gaussian's index into its
low 21 bits, so past 2^21 gaussians the index spills into the depth bits
and the order is wrong. Here the pairs, which render.group_pairs makes in
gaussian order, take a stable sort by (group, depth bits) instead: the
same order, ties by gaussian index, at any count.
"""

from __future__ import annotations

import torch

from splatbench.reference import render as ref

FIELDS = ref.FIELDS
# Gaussians of one block of the projection and of the update.
BLOCK_ROWS = 1 << 22


def plain_precision() -> None:
    """Matmuls and convolutions in full f32, as the configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _blocks(n: int):
    return [(a, min(a + BLOCK_ROWS, n)) for a in range(0, n, BLOCK_ROWS)]


def _rows_of(params: dict, a: int, b: int) -> dict:
    return {k: params[k][a:b] for k in FIELDS}


def sumsq(x: torch.Tensor) -> float:
    """The squared norm of x in float64, block by block of rows."""
    return float(sum(x[a:b].double().square().sum()
                     for a, b in _blocks(x.shape[0])))


def tile_lists(sp: dict, rc: dict):
    """render.tile_lists for any number of gaussians: (tile, gid) int64 of
    every tile and gaussian of its group that can reach one of the tile's
    pixels, sorted by tile and then by the group's key order, and the
    group pair count."""
    gr = ref.grid(rc)
    g = rc["tile_group"]
    tw, th = rc["tile_width"], rc["tile_height"]
    gid, grp = ref.group_pairs(sp, rc)
    num_group_pairs = int(gid.shape[0])
    depth_q = sp["depth"].float().contiguous().view(torch.int32).to(
        torch.int64) >> gr["depth_shift"]
    # Group, then the depth's kept bits; equal keys keep gaussian order.
    _, order = torch.sort((grp << 32) | depth_q[gid], stable=True)
    gid, grp = gid[order], grp[order]
    gxs = grp % gr["groups_x"]
    gys = grp // gr["groups_x"]
    op = sp["opacity"].float()
    q = 2.0 * torch.log(torch.clamp_min(op, 1e-12) / rc["alpha_min"])
    q = q * (1.0 + 1e-3) + 1e-3
    con = sp["conic"].float()
    x, y = sp["xy"][:, 0].float(), sp["xy"][:, 1].float()
    tiles, gids, keys = [], [], []
    for m in range(g * g):
        tx = gxs * g + (m % g)
        ty = gys * g + (m // g)
        ok = (tx < gr["tiles_x"]) & (ty < gr["tiles_y"])
        u0 = (tx * tw).float() - x[gid]
        v0 = (ty * th).float() - y[gid]
        fmin = ref._quad_min(con[gid, 0], con[gid, 1], con[gid, 2], u0,
                             u0 + (tw - 1.0), v0, v0 + (th - 1.0))
        ok &= fmin <= q[gid]
        tiles.append((ty * gr["tiles_x"] + tx)[ok])
        gids.append(gid[ok])
        keys.append(torch.nonzero(ok)[:, 0])
    tile, gid, pos = (torch.cat(v) for v in (tiles, gids, keys))
    _, order = torch.sort(tile * (num_group_pairs + 1) + pos)
    return tile[order], gid[order], num_group_pairs


@torch.no_grad()
def project(params: dict, view, proj, env_rot, rc: dict) -> dict:
    """render.project of every gaussian, block by block."""
    parts = [ref.project(_rows_of(params, a, b), view, proj, env_rot, rc)
             for a, b in _blocks(params["means"].shape[0])]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def render(params: dict, view, proj, env_rot, rc: dict) -> dict:
    """A frame, as render.render: image (H, W, 4), pairs, live."""
    plain_precision()
    with torch.no_grad():
        sp = project(params, view, proj, env_rot, rc)
        tile, gid, pairs = tile_lists(sp, rc)
        image, live, _ = ref.composite(ref.splat_rows(sp), tile, gid, rc)
    return dict(image=image, pairs=pairs, live=live,
                tile_gaussians=int(tile.shape[0]))


def loss_and_grads(params: dict, view, proj, env_rot, target, rc: dict,
                   ssim_weight: float):
    """(loss, {field: gradient}, frame stats) of one view, as
    render.loss_and_grads."""
    plain_precision()
    with torch.no_grad():
        sp = project(params, view, proj, env_rot, rc)
        rows = ref.splat_rows(sp)
        tile, gid, pairs = tile_lists(sp, rc)
        del sp
        image, live, carries = ref.composite(rows, tile, gid, rc,
                                             keep_carries=True)
    img = image.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = ref.loss_of(img, target.to(img.dtype), ssim_weight)
        g_img, = torch.autograd.grad(loss, img)
    with torch.no_grad():
        d_rows = ref.composite_vjp(rows, gid, rc, carries, g_img)
    stats = dict(pairs=pairs, live=live, tile_gaussians=int(tile.shape[0]))
    del carries, rows, tile, gid
    grads = {k: torch.zeros_like(params[k]) for k in FIELDS}
    for a, b in _blocks(params["means"].shape[0]):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in _rows_of(params, a, b).items()}
        with torch.enable_grad():
            rows_b = ref.splat_rows(ref.project(leaves, view, proj, env_rot,
                                                rc))
            got = torch.autograd.grad(rows_b, [leaves[k] for k in FIELDS],
                                      d_rows[a:b], allow_unused=True)
        # A row whose splats' cotangent is zero (a gaussian in no tile's
        # list) has a zero gradient; autograd gives 0 * inf = NaN there
        # where the projection is singular (a mean on the camera's plane).
        live = (d_rows[a:b] != 0).any(1)
        for k, g in zip(FIELDS, got):
            if g is not None:
                grads[k][a:b] = torch.where(
                    live.view(-1, *([1] * (g.ndim - 1))), g, 0.0)
    return loss.detach(), grads, stats


class BlockAdam:
    """render.Adam over blocks of rows: the update of `params` in place."""

    def __init__(self, params: dict, tc: dict):
        n = params["means"].shape[0]
        self.blocks = _blocks(n)
        self.adams = [ref.Adam(_rows_of(params, a, b), tc)
                      for a, b in self.blocks]

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        for (a, b), adam in zip(self.blocks, self.adams):
            out = adam.step(_rows_of(params, a, b), _rows_of(grads, a, b))
            for k in FIELDS:
                params[k][a:b] = out[k]


def first_steps(params: dict, cams, views, targets, rc: dict, tc: dict):
    """The reference's first steps from `params` (updated in place, in its
    dtype) on `views` against `targets`: (losses, the first gradient's
    squared norm by field (float64), per-step frame stats)."""
    adam = BlockAdam(params, tc)
    losses, first, counts = [], None, []
    for view, target in zip(views, targets):
        v, p, e = (t.to(params["means"].dtype) for t in cams[view])
        loss, grads, stats = loss_and_grads(params, v, p, e, target, rc,
                                            tc["ssim_weight"])
        losses.append(float(loss))
        counts.append(stats)
        if first is None:
            first = {k: sumsq(grads[k]) for k in FIELDS}
        adam.step(params, grads)
        del grads
    return losses, first, counts
