"""The plain reference of the splat renderer, its loss and its train step.

Plain PyTorch, written for the benchmark: it imports nothing of the
program, and the program's packages nowhere. It computes in the dtype it
is given (the configuration's float32; the control's bfloat16), on the
device of its inputs, in blocks so that a 1M-gaussian frame fits.

What it computes is the semantics the configuration states, the 3D
Gaussian Splatting image formation of the upstream project as its tiled
renderer defines it:

- projection: view and clip transforms, the EWA 2D covariance with the
  1.3 tan(fov) clamp and a 0.3 px low-pass, the conic, SH colour at the
  scene's degree (+0.5, clamped at 0), sigmoid opacity, the alpha-aware
  footprint extent capped at extent_sigma, and the frustum cull (the same
  f32 operations in the same order as the port's projection, so the two
  agree to the bit on one device);
- binning: each visible gaussian covers the tile rectangle of its extent,
  clamped to the grid and to max_tiles_per_axis tiles an axis, then taken
  to tile_group x tile_group groups; with exact_tile_test a group is kept
  only where the conic quadratic's minimum over the group's pixel
  rectangle is within 2 ln(opacity / alpha_min) (footprints of more than
  8 groups an axis keep the rectangle). Every tile composites its group's
  gaussians in the order of the 32-bit key (group, the top bits of the
  f32 depth, as many as the grid leaves), ties by gaussian index;
- compositing: front to back per pixel, alpha = min(op exp(power), clamp),
  a gaussian skipped where power > 0 or alpha < alpha_min, strict
  termination (a pixel stops before the first gaussian that would take
  its transmittance below eps), background added under the remaining
  transmittance, alpha = 1 - T.

A tile is composited only with the gaussians that can reach one of its
pixels (the quadratic's minimum over the tile's pixel rectangle within
2 ln(op / alpha_min), with a margin): the others are skipped by the
rule above anyway, so the image is the same. Per block of tiles the
walk is a cumulative product over the gaussians (not the program's
one-by-one loop), so transmittance rounds differently, and a pixel whose
T lies within rounding of eps may stop one gaussian apart.

The gradient (`loss_and_grads`) recomputes the compositing block by
block under autograd, back to front, carrying the transmittance's
cotangent (`composite_vjp`), and ends with autograd through the
projection.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
FIELDS = ("means", "log_scales", "quats", "opacities", "sh")
MASK_SPAN = 8
# Elements of one (tiles, gaussians, pixels) block of the compositing walk.
BLOCK_ELEMS = 1 << 25
# Gaussian slots of one batch of tiles (the batch's longest list times its
# tiles).
BATCH_SLOTS = 1 << 18


# -- projection --------------------------------------------------------------

def _quat_to_rotmat(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _rot(a, axis):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    if axis == "x":
        rows = [[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]]
    else:
        rows = [[c, z, s, z], [z, o, z, z], [-s, z, c, z], [z, z, z, o]]
    return torch.stack([torch.stack(r) for r in rows])


def _eval_sh(sh, dirs, degree):
    result = SH_C0 * sh[:, 0]
    if degree >= 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        result = result + SH_C1 * (-y * sh[:, 1] + z * sh[:, 2]
                                   - x * sh[:, 3])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = result + (
            SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
            + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
            + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        result = result + (
            SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
            + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
            + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp_min(result + 0.5, 0.0)


def project(params: dict, view, proj, env_rot, rc: dict) -> dict:
    """Screen-space splats of every gaussian, in the parameters' dtype:
    xy (N, 2), depth (N,), conic (N, 3), color (N, 3), opacity (N,),
    radius (N, 2), (0, 0) where culled. Differentiable in `params`."""
    dt = params["means"].dtype
    w_img, h_img = rc["image_width"], rc["image_height"]
    means = params["means"]
    ones = torch.ones((means.shape[0], 1), dtype=dt, device=means.device)
    view_h = torch.cat([means, ones], dim=-1) @ view.T
    clip = view_h @ proj.T
    t_view = view_h[:, :3]
    depth = -t_view[:, 2]
    w = clip[..., 3:4]
    xy0 = clip[..., 0:2] * (0.5 / w) + 0.5
    xy = torch.stack([xy0[..., 0] * float(w_img), xy0[..., 1] * float(h_img)],
                     dim=-1)
    fx = proj[0, 0] * (w_img * 0.5)
    fy = proj[1, 1] * (h_img * 0.5)
    tan_fovx = 1.0 / proj[0, 0]
    tan_fovy = 1.0 / proj[1, 1]

    s = torch.exp(params["log_scales"])
    r = _quat_to_rotmat(params["quats"])
    m = r * s[..., None, :]
    cxx = torch.sum(m[..., 0, :] * m[..., 0, :], -1)
    cxy = torch.sum(m[..., 0, :] * m[..., 1, :], -1)
    cxz = torch.sum(m[..., 0, :] * m[..., 2, :], -1)
    cyy = torch.sum(m[..., 1, :] * m[..., 1, :], -1)
    cyz = torch.sum(m[..., 1, :] * m[..., 2, :], -1)
    czz = torch.sum(m[..., 2, :] * m[..., 2, :], -1)

    tx, ty, tz = t_view[..., 0], t_view[..., 1], t_view[..., 2]
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = fx * inv_tz
    j02 = -fx * tx * inv_tz2
    j11 = fy * inv_tz
    j12 = -fy * ty * inv_tz2
    wm = view[:3, :3]
    u00 = j00 * wm[0, 0] + j02 * wm[2, 0]
    u01 = j00 * wm[0, 1] + j02 * wm[2, 1]
    u02 = j00 * wm[0, 2] + j02 * wm[2, 2]
    u10 = j11 * wm[1, 0] + j12 * wm[2, 0]
    u11 = j11 * wm[1, 1] + j12 * wm[2, 1]
    u12 = j11 * wm[1, 2] + j12 * wm[2, 2]
    v00 = u00 * cxx + u01 * cxy + u02 * cxz
    v01 = u00 * cxy + u01 * cyy + u02 * cyz
    v02 = u00 * cxz + u01 * cyz + u02 * czz
    v10 = u10 * cxx + u11 * cxy + u12 * cxz
    v11 = u10 * cxy + u11 * cyy + u12 * cyz
    v12 = u10 * cxz + u11 * cyz + u12 * czz
    lp = rc["lowpass"]
    a = v00 * u00 + v01 * u01 + v02 * u02 + lp
    b = v00 * u10 + v01 * u11 + v02 * u12
    c = v10 * u10 + v11 * u11 + v12 * u12 + lp

    det = a * c - b * b
    valid = det > 1e-12
    det_inv = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)

    opacity = torch.sigmoid(params["opacities"])
    am = rc["alpha_min"]
    q = 2.0 * torch.log(torch.clamp_min(opacity.detach(), 1e-12) / am)
    sig = rc["extent_sigma"]
    if sig > 0.0:
        q = torch.clamp_max(q, sig * sig)
    q = torch.clamp_min(q, 0.0)
    rx = torch.ceil(torch.sqrt(q * torch.clamp_min(a, 0.0)))
    ry = torch.ceil(torch.sqrt(q * torch.clamp_min(c, 0.0)))

    sh = params["sh"]
    degree = int(math.isqrt(sh.shape[1])) - 1
    if degree == 0:
        color = torch.clamp_min(SH_C0 * sh[:, 0] + 0.5, 0.0)
    else:
        origin = -(view[:3, :3].T @ view[:3, 3])
        dirs = means - origin[None, :]
        dirs = dirs / torch.clamp_min(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-8)
        rot = _rot(env_rot[1], "y")[:3, :3] @ _rot(env_rot[0], "x")[:3, :3]
        dirs = dirs @ rot.T
        color = _eval_sh(sh, dirs, degree)

    near_ok = clip[:, 3] > 1e-6
    on_screen = ((xy[:, 0] + rx >= 0.0) & (xy[:, 0] - rx <= w_img)
                 & (xy[:, 1] + ry >= 0.0) & (xy[:, 1] - ry <= h_img))
    visible = near_ok & on_screen & valid & (rx > 0.0) & (ry > 0.0) \
        & (opacity >= am)
    radius = torch.where(visible[:, None], torch.stack([rx, ry], -1), 0.0)
    return dict(xy=xy, depth=depth, conic=conic, color=color,
                opacity=opacity, radius=radius)


# -- binning ---------------------------------------------------------------

def grid(rc: dict) -> dict:
    tw, th, g = rc["tile_width"], rc["tile_height"], rc["tile_group"]
    tx = -(-rc["image_width"] // tw)
    ty = -(-rc["image_height"] // th)
    gx, gy = -(-tx // g), -(-ty // g)
    # The 32-bit key: the group id, then as many top bits of the f32
    # depth as the grid leaves (its query bound doubled, as the program's
    # strip layout bounds it).
    max_query = 2 * gy * gx if g > 1 else 2 * ty * tx
    key_bits = 31 - (max_query + 1).bit_length()
    return dict(tiles_x=tx, tiles_y=ty, groups_x=gx, num_tiles=tx * ty,
                npix=tw * th, depth_shift=31 - key_bits)


def _floor_i64(v):
    return torch.floor(torch.clamp(v, -2.0 ** 30, 2.0 ** 30)).to(torch.int64)


def _quad_min(ca, cb, cc, u0, u1, v0, v1):
    """Minimum of ca u^2 + 2 cb u v + cc v^2 over [u0, u1] x [v0, v1]
    (edge minima with clamps; 0 where the rectangle holds the origin)."""
    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)

    def edge_u(e, lo, hi):
        v = torch.clamp(-cb * e / cc_s, lo, hi)
        return ca * e * e + 2.0 * cb * e * v + cc * v * v

    def edge_v(f, lo, hi):
        u = torch.clamp(-cb * f / ca_s, lo, hi)
        return ca * u * u + 2.0 * cb * u * f + cc * f * f

    inside = (u0 <= 0.0) & (0.0 <= u1) & (v0 <= 0.0) & (0.0 <= v1)
    fmin = torch.minimum(
        torch.minimum(edge_u(u0, v0, v1), edge_u(u1, v0, v1)),
        torch.minimum(edge_v(v0, u0, u1), edge_v(v1, u0, u1)))
    return torch.where(inside, 0.0, fmin)


def group_pairs(sp: dict, rc: dict):
    """(gid, group id) of every (gaussian, tile group) pair, int64, in no
    particular order."""
    gr = grid(rc)
    g = rc["tile_group"]
    tw, th = rc["tile_width"], rc["tile_height"]
    rx, ry = sp["radius"][:, 0].float(), sp["radius"][:, 1].float()
    x, y = sp["xy"][:, 0].float(), sp["xy"][:, 1].float()
    vis = rx > 0.0
    cap = rc["max_tiles_per_axis"]

    def span(c, r, size, n):
        lo = torch.clamp_min(_floor_i64((c - r) / size), 0)
        hi = torch.clamp_max(_floor_i64((c + r) / size), n - 1)
        return lo, torch.clamp(hi - lo + 1, 0, cap)

    x0, nx = span(x, rx, tw, gr["tiles_x"])
    y0, ny = span(y, ry, th, gr["tiles_y"])
    nx = torch.where(vis, nx, 0)
    ny = torch.where(vis, ny, 0)
    if g > 1:
        x1 = x0 + torch.clamp_min(nx - 1, 0)
        y1 = y0 + torch.clamp_min(ny - 1, 0)
        x0, y0 = x0 // g, y0 // g
        nx = torch.where(nx > 0, x1 // g - x0 + 1, 0)
        ny = torch.where(ny > 0, y1 // g - y0 + 1, 0)
    cnt = nx * ny
    gid = torch.repeat_interleave(torch.arange(cnt.shape[0],
                                               device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(gid.shape[0], device=cnt.device) - first[gid]
    dx = rank % nx[gid]
    dy = rank // nx[gid]
    cx, cy = x0[gid] + dx, y0[gid] + dy
    if rc["exact_tile_test"]:
        testable = (nx <= MASK_SPAN) & (ny <= MASK_SPAN) & (cnt > 0)
        op = sp["opacity"].float()
        q = 2.0 * torch.log(torch.clamp_min(op, 1e-12) / rc["alpha_min"])
        q = q * (1.0 + 1e-4) + 1e-4
        cw, ch = float(g * tw), float(g * th)
        con = sp["conic"].float()
        u0 = (x0[gid] + dx).float() * cw - x[gid]
        v0 = (y0[gid] + dy).float() * ch - y[gid]
        fmin = _quad_min(con[gid, 0], con[gid, 1], con[gid, 2], u0,
                         u0 + (cw - 1.0), v0, v0 + (ch - 1.0))
        keep = ~testable[gid] | (fmin <= q[gid])
        gid, cx, cy = gid[keep], cx[keep], cy[keep]
    return gid, cy * gr["groups_x"] + cx


def tile_lists(sp: dict, rc: dict):
    """The compositing lists: (tile, gid) int64 of every tile and gaussian
    of its group that can reach one of the tile's pixels, sorted by tile
    and then by the group's key order. Returns (tile, gid, group_pairs)."""
    gr = grid(rc)
    g = rc["tile_group"]
    tw, th = rc["tile_width"], rc["tile_height"]
    gid, grp = group_pairs(sp, rc)
    num_group_pairs = int(gid.shape[0])
    depth_q = sp["depth"].float().contiguous().view(torch.int32).to(
        torch.int64) >> gr["depth_shift"]
    # Group-level order, then each pair's member tiles (order kept).
    key = (grp << 52) | (depth_q[gid] << 21) | gid
    key, order = torch.sort(key)
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
        fmin = _quad_min(con[gid, 0], con[gid, 1], con[gid, 2], u0,
                         u0 + (tw - 1.0), v0, v0 + (th - 1.0))
        ok &= fmin <= q[gid]
        tiles.append((ty * gr["tiles_x"] + tx)[ok])
        gids.append(gid[ok])
        keys.append(torch.nonzero(ok)[:, 0])
    tile, gid, pos = (torch.cat(v) for v in (tiles, gids, keys))
    _, order = torch.sort(tile * (num_group_pairs + 1) + pos)
    return tile[order], gid[order], num_group_pairs


# -- compositing -------------------------------------------------------------

def _batches(counts: torch.Tensor):
    """Batches of tiles of similar list lengths: (tile ids, length) with
    len(tiles) * length <= BATCH_SLOTS where it can be."""
    lens, order = torch.sort(counts, descending=True)
    lens, order = lens.tolist(), order.tolist()
    out, i = [], 0
    while i < len(order) and lens[i] > 0:
        length = lens[i]
        k = max(1, BATCH_SLOTS // length)
        out.append((order[i:i + k], length))
        i += k
    return out


def _chunk(f, px, py, t_in, stop_in, rc):
    """One block of the walk. f (B, L, 9) rows [x, y, A, B, C, r, g, b,
    op]; px, py (B, 1, P); t_in (B, P) transmittance, stop_in (B, P) bool.
    Returns (rgb (B, P, 3), t_out, stop_out, live count)."""
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
    w = torch.where(blend, alpha * (t_after / fac), 0.0)
    rgb = torch.einsum("blp,blc->bpc", w, f[..., 5:8])
    t_out = t_in * torch.prod(torch.where(blend, fac, 1.0), dim=1)
    stop_out = stop_in | (used & (t_after < eps)).any(dim=1)
    return rgb, t_out, stop_out, blend.sum()


def _pixel_xy(rc, tiles, dtype):
    gr = grid(rc)
    tw, th = rc["tile_width"], rc["tile_height"]
    idx = torch.arange(gr["npix"], device=tiles.device)
    px = ((tiles % gr["tiles_x"]) * tw)[:, None] + (idx % tw)[None, :]
    py = ((tiles // gr["tiles_x"]) * th)[:, None] + (idx // tw)[None, :]
    return px.to(dtype)[:, None, :], py.to(dtype)[:, None, :]


def _lists(tile, gid, num_tiles):
    counts = torch.bincount(tile, minlength=num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    return counts, starts


def _block_plan(tile, gid, rc):
    """The walk's blocks: for each batch of tiles, its tile ids, its list
    matrix (B, L) of positions into the sorted lists (-1 pads) and the
    block length along L."""
    gr = grid(rc)
    counts, starts = _lists(tile, gid, gr["num_tiles"])
    plan = []
    for tids, length in _batches(counts):
        t = torch.tensor(tids, device=tile.device)
        j = torch.arange(length, device=tile.device)
        pos = starts[t][:, None] + j[None, :]
        pos = torch.where(j[None, :] < counts[t][:, None], pos, -1)
        block = max(1, BLOCK_ELEMS // (len(tids) * gr["npix"]))
        plan.append((t, pos, block))
    return plan


def _gather(feat, gid, pos):
    """(B, L, 9) rows of the list positions `pos`; pads (-1) get a zero
    row (opacity 0: never used)."""
    pad = torch.zeros((1, feat.shape[1]), dtype=feat.dtype,
                      device=feat.device)
    rows = torch.cat([feat, pad])
    g = torch.where(pos >= 0, gid[pos.clamp_min(0)], feat.shape[0])
    return rows[g]


def splat_rows(sp: dict) -> torch.Tensor:
    """(N, 9) compositing rows [x, y, A, B, C, r, g, b, op]."""
    return torch.cat([sp["xy"], sp["conic"], sp["color"],
                      sp["opacity"][:, None]], dim=-1)


def composite(feat, tile, gid, rc, keep_carries: bool = False):
    """Forward walk. Returns (image (H, W, 4), live evaluations, carries):
    carries, with keep_carries, every block's (tiles, list positions,
    t_in, stop_in) in walk order, for `composite_vjp`."""
    gr = grid(rc)
    dt = feat.dtype
    npix = gr["npix"]
    dev = feat.device
    t_all = torch.ones((gr["num_tiles"], npix), dtype=dt, device=dev)
    rgb_all = torch.zeros((gr["num_tiles"], npix, 3), dtype=dt, device=dev)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    carries = []
    for t, pos, block in _block_plan(tile, gid, rc):
        px, py = _pixel_xy(rc, t, dt)
        t_in = torch.ones((t.shape[0], npix), dtype=dt, device=dev)
        stop = torch.zeros((t.shape[0], npix), dtype=torch.bool, device=dev)
        rgb = torch.zeros((t.shape[0], npix, 3), dtype=dt, device=dev)
        for c0 in range(0, pos.shape[1], block):
            p = pos[:, c0:c0 + block]
            if keep_carries:
                carries.append((t, p, t_in, stop))
            d_rgb, t_in, stop, n_live = _chunk(_gather(feat, gid, p), px, py,
                                               t_in, stop, rc)
            rgb = rgb + d_rgb
            live += n_live
            # Every pixel of the batch has stopped: nothing after blends.
            if c0 + block < pos.shape[1] and bool(stop.all()):
                break
        t_all[t] = t_in
        rgb_all[t] = rgb
    return _to_image(rgb_all, t_all, rc), int(live), carries


def _to_image(rgb, t, rc):
    gr = grid(rc)
    bg = torch.tensor(rc["background"], dtype=rgb.dtype, device=rgb.device)
    tiles = torch.cat([rgb + t[..., None] * bg, (1.0 - t)[..., None]], -1)
    tw, th = rc["tile_width"], rc["tile_height"]
    x = tiles.reshape(gr["tiles_y"], gr["tiles_x"], th, tw, 4)
    x = x.permute(0, 2, 1, 3, 4).reshape(gr["tiles_y"] * th,
                                         gr["tiles_x"] * tw, 4)
    return x[:rc["image_height"], :rc["image_width"]]


def _to_tiles(img, rc):
    gr = grid(rc)
    tw, th = rc["tile_width"], rc["tile_height"]
    full = img.new_zeros((gr["tiles_y"] * th, gr["tiles_x"] * tw, 4))
    full[:img.shape[0], :img.shape[1]] = img
    x = full.reshape(gr["tiles_y"], th, gr["tiles_x"], tw, 4)
    return x.permute(0, 2, 1, 3, 4).reshape(gr["num_tiles"], gr["npix"], 4)


def composite_vjp(feat, gid, rc, carries, g_img):
    """d feat (N, 9) of <g_img, image>: each block of the forward walk
    (`carries`) recomputed under autograd from its carry, back to front,
    the transmittance's cotangent carried from block to block."""
    dt = feat.dtype
    g_tiles = _to_tiles(g_img.to(dt), rc)
    bg = torch.tensor(rc["background"], dtype=dt, device=feat.device)
    d_feat = torch.zeros_like(feat)
    g_t, last_t = None, None
    for t, p, t_in, stop in reversed(carries):
        u = g_tiles[t]
        if t is not last_t:
            # The batch's last block: its T is the pixels' final one, which
            # weighs the background and gives alpha = 1 - T.
            g_t = (u[..., :3] * bg).sum(-1) - u[..., 3]
            last_t = t
        px, py = _pixel_xy(rc, t, dt)
        f = _gather(feat, gid, p).detach().requires_grad_(True)
        t_leaf = t_in.detach().requires_grad_(True)
        with torch.enable_grad():
            rgb, t_out, _, _ = _chunk(f, px, py, t_leaf, stop, rc)
            df, g_t = torch.autograd.grad((rgb, t_out), (f, t_leaf),
                                          (u[..., :3], g_t))
        valid = p >= 0
        d_feat.index_add_(0, gid[p[valid]], df[valid])
    return d_feat


def render(params: dict, view, proj, env_rot, rc: dict) -> dict:
    """A frame: image (H, W, 4), pairs (group level), live evaluations."""
    with torch.no_grad():
        sp = project(params, view, proj, env_rot, rc)
        tile, gid, pairs = tile_lists(sp, rc)
        image, live, _ = composite(splat_rows(sp), tile, gid, rc)
    return dict(image=image, pairs=pairs, live=live,
                tile_gaussians=int(tile.shape[0]))


# -- loss and the train step -------------------------------------------------

def _gauss_window(size, sigma, dtype, device):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / torch.sum(g)).to(dtype)


def _blur(img, w):
    c = img.shape[-1]
    x = img.permute(2, 0, 1)[None]
    k = w.numel()
    x = F.conv2d(x, w.view(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, w.view(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(pred, target, window=11, sigma=1.5):
    """Mean SSIM of (H, W, C) images over an 11x11 Gaussian window
    (sigma 1.5), VALID (Wang et al. 2004, as 3DGS trains with)."""
    w = _gauss_window(window, sigma, pred.dtype, pred.device)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_p, mu_t = _blur(pred, w), _blur(target, w)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sig_p = _blur(pred * pred, w) - mu_pp
    sig_t = _blur(target * target, w) - mu_tt
    sig_pt = _blur(pred * target, w) - mu_pt
    num = (2.0 * mu_pt + c1) * (2.0 * sig_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sig_p + sig_t + c2)
    return torch.mean(num / den)


def loss_of(image, target, ssim_weight):
    """(1 - w) L1 + w (1 - SSIM) on the RGB channels."""
    p, t = image[..., :3], target[..., :3]
    loss = (1.0 - ssim_weight) * torch.mean(torch.abs(p - t))
    if ssim_weight > 0.0:
        loss = loss + ssim_weight * (1.0 - ssim(p, t))
    return loss


def loss_and_grads(params: dict, view, proj, env_rot, target, rc,
                   ssim_weight):
    """(loss, {field: gradient}, frame stats) of one view."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        sp = project(leaves, view, proj, env_rot, rc)
        rows = splat_rows(sp)
    with torch.no_grad():
        tile, gid, pairs = tile_lists({k: v.detach() for k, v in sp.items()},
                                      rc)
        image, live, carries = composite(rows.detach(), tile, gid, rc,
                                         keep_carries=True)
    img = image.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_of(img, target.to(img.dtype), ssim_weight)
        g_img, = torch.autograd.grad(loss, img)
    with torch.no_grad():
        d_rows = composite_vjp(rows.detach(), gid, rc, carries, g_img)
    with torch.enable_grad():
        grads = torch.autograd.grad(rows, [leaves[k] for k in FIELDS],
                                    d_rows, allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(FIELDS, grads)}
    return loss.detach(), grads, dict(pairs=pairs, live=live,
                                      tile_gaussians=int(tile.shape[0]))


def means_lr(count: int, tc: dict) -> float:
    """optax.exponential_decay of the means rate at schedule count."""
    init = tc["lr_means"] * tc["scene_extent"]
    end = tc["lr_means_final"] * tc["scene_extent"]
    rate = tc["lr_means_final"] / tc["lr_means"]
    if count <= 0:
        return init
    v = init * rate ** (count / tc["lr_means_decay_steps"])
    return max(v, end) if rate < 1.0 else min(v, end)


class Adam:
    """Per-field Adam (b1 0.9, b2 0.999, eps outside the root, bias
    correction with the count taken first), the SH bands >= 1 stepped at
    sh_rest_lr_scale of the SH rate, the means rate on its decay, and the
    quaternions renormalised after each step: the 3DGS optimizer as the
    configuration's TrainConfig defines it."""

    def __init__(self, params: dict, tc: dict):
        self.tc = tc
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        tc = self.tc
        lrs = dict(log_scales=tc["lr_log_scales"], quats=tc["lr_quats"],
                   opacities=tc["lr_opacities"], sh=tc["lr_sh"])
        self.count += 1
        bc1 = 1.0 - 0.9 ** self.count
        bc2 = 1.0 - 0.999 ** self.count
        out = {}
        for k in FIELDS:
            g = grads[k]
            self.mu[k] = 0.1 * g + 0.9 * self.mu[k]
            self.nu[k] = 0.001 * (g * g) + 0.999 * self.nu[k]
            d = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                     + tc["adam_eps"])
            lr = means_lr(self.count - 1, tc) if k == "means" else lrs[k]
            upd = d * -lr
            if k == "sh" and upd.shape[1] > 1:
                upd = torch.cat([upd[:, :1],
                                 upd[:, 1:] * tc["sh_rest_lr_scale"]], 1)
            out[k] = params[k] + upd
        q = out["quats"]
        out["quats"] = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-8)
        return out
