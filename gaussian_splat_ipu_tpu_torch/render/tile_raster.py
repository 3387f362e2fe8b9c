"""Tiled rasterization in plain torch: the CPU spec of the forward and
backward compositing kernels (render/kernels/rasterize.py) and their plain
versions on the card.

Port of gaussian_splat_ipu_tpu/render/tile_raster.py (forward) and of the
replay recurrence of the reference's backward kernel
(kernels/rasterize.py::_bwd_kernel). Every tile composites its
depth-sorted pair range front to back, all tiles and pixels at once, in
chunks of C pairs. A pair is skipped when power > 0 or alpha < alpha_min;
work per range is capped at max_chunks_per_range * C pairs; pixel centres
sit at integer coordinates.

Strict termination (cfg.strict_termination, the reference break,
codelets.cpp:405-408): a pixel stops before blending the first pair with
T * (1 - a) < eps, and its T freezes there. With need_aux the strict
forward also returns each pixel's contributor count nc = min(first
trigger position, end) - start, the reference's definition
(kernels/rasterize.py:278-284), which the backward replays up to.

Relaxed termination (the reference's inference kernel with
strict_termination=False, kernels/rasterize.py:94-177): a pair is blended
only when T * (1 - a) >= eps, but T takes the factor (1 - a) of every pair
until the whole tile stops, which it does at a chunk boundary once every
pixel's T is below eps. The colour equals the strict colour; the alpha
channel may decay past it by at most eps / (1 - alpha_clamp).

Within a chunk the pairs are composited one after another, with the same
f32 operations in the same order as the CUDA kernel's per-pixel loop (the
reference's spec takes a cumprod instead). Transmittance rounded in the
same order makes the near-threshold break and gate decisions of the two
agree, so the kernel can be held to this version pixel for pixel.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.render import binning as B
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig


def _pixel_coords(cfg: RasterConfig, device):
    """(NPIX,) local x and y of the pixel centres of a tile, row-major."""
    idx = torch.arange(cfg.pixels_per_tile, device=device)
    return ((idx % cfg.tile_width).to(torch.float32),
            (idx // cfg.tile_width).to(torch.float32))


def _tile_pixels(cfg: RasterConfig, num_tiles: int, device):
    """(T, NPIX) global x and y of every pixel centre of tiles 0..T-1."""
    lx, ly = _pixel_coords(cfg, device)
    tids = torch.arange(num_tiles, device=device)
    px = ((tids % cfg.tiles_x) * cfg.tile_width).to(torch.float32)[:, None] \
        + lx[None, :]
    py = ((tids // cfg.tiles_x) * cfg.tile_height).to(torch.float32)[
        :, None] + ly[None, :]
    return px, py


def _clipped_ranges(starts, ends, cfg: RasterConfig):
    """i64 (starts, ends) with every range cut at the per-range work bound
    max_chunks_per_range * chunk_size."""
    starts = starts.to(torch.int64)
    return starts, torch.minimum(
        ends.to(torch.int64),
        starts + cfg.max_chunks_per_range * cfg.chunk_size)


def rasterize_tiles_torch(binned: B.BinnedSplats, cfg: RasterConfig,
                          need_aux: bool = False):
    """Rasterize binned splats of the whole tile grid -> (T, NPIX, 4) RGBA
    tile buffers. need_aux=True composites with strict termination
    whatever cfg says (the differentiated forward) and returns
    (tiles, nc), nc the (T, NPIX) f32 contributor count of each pixel."""
    feats = binned.features
    device = feats.device
    c = cfg.chunk_size
    eps = cfg.transmittance_eps
    relaxed = not (cfg.strict_termination or need_aux)
    starts, ends = _clipped_ranges(binned.tile_starts, binned.tile_ends, cfg)
    num_tiles = starts.shape[0]
    # One zero chunk past the end; the windows of tiles whose own range
    # ended earlier (masked by `valid`) are clamped into it.
    table = torch.cat([feats[:B.FEAT_OPACITY + 1],
                       feats.new_zeros((B.FEAT_OPACITY + 1, c))], dim=1)
    px, py = _tile_pixels(cfg, num_tiles, device)           # (T, NPIX)

    t = torch.ones_like(px)
    # Position of each pixel's break pair; the range end if it never broke.
    stop_pos = ends[:, None].expand(px.shape).clone() if need_aux else None
    color = torch.zeros(px.shape + (3,), dtype=torch.float32, device=device)
    stopped = torch.zeros(px.shape, dtype=torch.bool, device=device)
    lens = (ends - starts).clamp_min(0)
    nchunks = int((lens.max() + c - 1) // c) if num_tiles else 0
    lane = torch.arange(c, device=device)
    for k in range(nchunks):
        idx = starts[:, None] + k * c + lane[None, :]       # (T, C)
        valid = idx < ends[:, None]
        # A tile stops once no pixel is live (relaxed: every T < eps).
        if relaxed:
            valid &= (t.amax(dim=1) >= eps)[:, None]
        else:
            valid &= ~stopped.all(dim=1)[:, None]
        m = int(valid.sum(dim=1).max())
        if m == 0:
            break
        chunk = table[:, idx[:, :m].clamp_max(table.shape[1] - 1)]
        for j in range(m):
            gx, gy, ca, cb, cc, r, g, b, op = (
                v[:, None] for v in chunk[:, :, j])         # (T, 1) each
            dx = gx - px                                    # (T, NPIX)
            dy = gy - py
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = torch.clamp_max(op * torch.exp(power), cfg.alpha_clamp)
            use = ~((power > 0.0) | (alpha < cfg.alpha_min)) \
                & valid[:, j, None]
            t_next = t * (1.0 - alpha)
            if relaxed:
                blend = use & (t_next >= eps)
                advance = use
            else:
                use = use & ~stopped
                stop = use & (t_next < eps)
                blend = advance = use & ~stop
                stopped = stopped | stop
                if need_aux:
                    stop_pos = torch.where(stop, idx[:, j, None], stop_pos)
            w = (alpha * t)[..., None]
            rgb = torch.stack([r, g, b], dim=-1)            # (T, 1, 3)
            color = torch.where(blend[..., None], color + w * rgb, color)
            t = torch.where(advance, t_next, t)
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=device)
    color = color + t[..., None] * bg
    tiles = torch.cat([color, (1.0 - t)[..., None]], dim=-1)
    if need_aux:
        return tiles, (stop_pos - starts[:, None]).to(torch.float32)
    return tiles


def rasterize_backward_torch(features: torch.Tensor, starts: torch.Tensor,
                             ends: torch.Tensor, gout: torch.Tensor,
                             t_n: torch.Tensor, nc: torch.Tensor,
                             cfg: RasterConfig) -> torch.Tensor:
    """Gradient of the strict forward with respect to the (16, P) pair
    table: dfeat (16, P) f32, rows 9-15 zero.

    gout (T, NPIX, 4) is the cotangent of the tile buffers; t_n = 1 - alpha
    and nc (both (T, NPIX) f32) are what the aux forward saved. Each range
    is walked back to front, one pair per step for all tiles and pixels at
    once, with the reference's recurrence (_bwd_kernel, :401-556): a pair
    is live while pos < start + nc; T before it is recovered by division,
    T_i = T_{i+1} / (1 - a_i); sigma suffix-accumulates a_j T_j (c_j . u);
    dL/da_i = T_i (c_i . u) - (sigma + g_T T_n) / (1 - a_i) with
    g_T = bg . u - dL/dalpha_out; the power derivative is taken only where
    alpha is unclamped. The six pixel sums are direct products (a
    pixel-basis matmul cancels in f32, :482-485). Every tile's per-pair
    sums are index-added into the pair's column, so the member tiles of a
    tile group all add into their shared range. Memory is O(T * NPIX): the
    forward is replayed, not stored."""
    device = features.device
    p = features.shape[1]
    starts, ends = _clipped_ranges(starts, ends, cfg)
    num_tiles = starts.shape[0]
    nc_i = nc.to(torch.int64)
    # Pairs past every pixel's last contributor have zero gradient.
    if num_tiles:
        ends = torch.minimum(ends, starts + nc_i.amax(dim=1))
    lens = (ends - starts).clamp_min(0)
    steps = int(lens.max()) if num_tiles else 0
    px, py = _tile_pixels(cfg, num_tiles, device)
    u0, u1, u2, g_a = gout.unbind(-1)                       # (T, NPIX) each
    bg = cfg.background
    g_tn = ((bg[0] * u0 + bg[1] * u1 + bg[2] * u2) - g_a) * t_n
    live_limit = starts[:, None] + nc_i
    t = t_n.clone()
    sigma = torch.zeros_like(t)
    table = features[:B.FEAT_OPACITY + 1]
    # Column p is a sink for the steps of ranges that are already done.
    dfeat = features.new_zeros((B.TABLE_ROWS, p + 1))
    for k in range(steps):
        valid = k < lens                                    # (T,)
        pos = ends - 1 - k
        col = table[:, torch.where(valid, pos, 0)]          # (9, T)
        gx, gy, ca, cb, cc, r, g, b, op = (v[:, None] for v in col)
        dx = gx - px                                        # (T, NPIX)
        dy = gy - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        a_raw = op * torch.exp(power)
        alpha = torch.clamp_max(a_raw, cfg.alpha_clamp)
        use = ~((power > 0.0) | (alpha < cfg.alpha_min)) \
            & (pos[:, None] < live_limit) & valid[:, None]
        a_eff = torch.where(use, alpha, 0.0)
        one_minus = 1.0 - a_eff
        t = t / one_minus                                   # T before pair
        cu = r * u0 + g * u1 + b * u2
        w = a_eff * t
        d_alpha = torch.where(use, t * cu - (sigma + g_tn) / one_minus, 0.0)
        sigma = sigma + w * cu
        dpow = torch.where(a_raw < cfg.alpha_clamp, d_alpha * a_eff, 0.0)
        m1 = dpow.sum(1)
        sdx = (dpow * dx).sum(1)
        sdy = (dpow * dy).sum(1)
        sdxx = (dpow * dx * dx).sum(1)
        sdyy = (dpow * dy * dy).sum(1)
        sdxy = (dpow * dx * dy).sum(1)
        ca, cb, cc, op = ca[:, 0], cb[:, 0], cc[:, 0], op[:, 0]
        grow = torch.stack([
            -(ca * sdx + cb * sdy),                         # d mean x
            -(cc * sdy + cb * sdx),                         # d mean y
            -0.5 * sdxx,                                    # d conic a
            -sdxy,                                          # d conic b
            -0.5 * sdyy,                                    # d conic c
            (w * u0).sum(1), (w * u1).sum(1), (w * u2).sum(1),  # d colour
            m1 / torch.clamp_min(op, cfg.alpha_min),        # d opacity
        ])                                                  # (9, T)
        dfeat[:B.FEAT_OPACITY + 1].index_add_(
            1, torch.where(valid, pos, p), grow)
    return dfeat[:, :p].contiguous()


# The cull of kernels C and D (csrc/raster_stage.cuh): boxes are used only
# for conics with AC / det at most this.
KAPPA_MAX = 1.0e4


def tile_cull_torch(rows: torch.Tensor, x0, x1, y0, y1,
                    alpha_min: float) -> torch.Tensor:
    """Plain twin of the kernels' pair cull (raster_stage.cuh::pair_box and
    misses), with the same f32 operations: rows (9, K) f32 are pairs
    [x, y, conic a, b, c, r, g, b, op]; x0, x1, y0, y1 (K,) f32 the
    pixel-centre rectangles they are tested against. True where the pair
    is culled: no pixel of its rectangle can have power <= 0 and
    alpha >= alpha_min. Pairs with op < alpha_min are always culled; a
    pair with a non-finite value, A <= 0, det <= 0 or AC / det > KAPPA_MAX
    never is (nor any pair when alpha_min <= 0)."""
    x, y, a, b, c = rows[:5]
    op = rows[8]
    am = torch.tensor(alpha_min, dtype=torch.float32, device=rows.device)
    ac = a * c
    det = ac - b * b
    finite = torch.isfinite(torch.stack([x, y, a, b, c, op, ac])).all(0)
    ok = (am > 0) & finite & (a > 0) & (det > 0) & (ac <= KAPPA_MAX * det)
    tau = 1.05 * torch.log(op / am) + 0.05
    rx = torch.sqrt(2.0 * tau * c / det) * 1.01 + 0.5
    ry = torch.sqrt(2.0 * tau * a / det) * 1.01 + 0.5
    miss = (x + rx < x0) | (x - rx > x1) | (y + ry < y0) | (y - ry > y1)
    return ((am > 0) & (op < am)) | (ok & miss)


def _walked_pairs(binned: B.BinnedSplats, cfg: RasterConfig,
                  nc: torch.Tensor):
    """(tile, position) of every pair the compositing walks: each range cut
    at the work bound and at start + the tile's largest contributor count
    (no pixel composites a pair past it)."""
    starts, ends = _clipped_ranges(binned.tile_starts, binned.tile_ends, cfg)
    if starts.shape[0]:
        ends = torch.minimum(ends, starts + nc.to(torch.int64).amax(dim=1))
    lens = (ends - starts).clamp_min(0)
    tiles = torch.repeat_interleave(
        torch.arange(starts.shape[0], device=starts.device), lens)
    first = torch.cumsum(lens, 0) - lens
    pos = starts[tiles] + torch.arange(tiles.shape[0],
                                       device=starts.device) - first[tiles]
    return tiles, pos


def surviving_pairs(binned: B.BinnedSplats, cfg: RasterConfig,
                    nc: torch.Tensor) -> tuple[int, int]:
    """(walked, surviving): the (tile, pair) steps of the walk that
    _walked_pairs describes, and those the kernels' tile cull keeps."""
    tiles, pos = _walked_pairs(binned, cfg, nc)
    x0 = ((tiles % cfg.tiles_x) * cfg.tile_width).to(torch.float32)
    y0 = ((tiles // cfg.tiles_x) * cfg.tile_height).to(torch.float32)
    culled = tile_cull_torch(binned.features[:B.FEAT_OPACITY + 1, pos], x0,
                             x0 + (cfg.tile_width - 1), y0,
                             y0 + (cfg.tile_height - 1), cfg.alpha_min)
    return int(tiles.shape[0]), int((~culled).sum())


def live_evaluations(binned: B.BinnedSplats, cfg: RasterConfig,
                     nc: torch.Tensor, batch: int = 2048) -> int:
    """The (pair, pixel) evaluations that do work in the compositing
    kernels: power <= 0, alpha >= alpha_min and position < start + nc of
    the pixel, with the rasterizer's own f32 arithmetic. nc is the
    (T, NPIX) contributor count of the strict aux forward."""
    tiles, pos = _walked_pairs(binned, cfg, nc)
    table = binned.features
    starts = binned.tile_starts.to(torch.int64)
    limit = starts[:, None] + nc.to(torch.int64)            # (T, NPIX)
    px, py = _tile_pixels(cfg, nc.shape[0], nc.device)
    total = 0
    for i in range(0, tiles.shape[0], batch):
        t, q = tiles[i:i + batch], pos[i:i + batch]
        gx, gy, ca, cb, cc = (table[f, q][:, None] for f in range(5))
        op = table[B.FEAT_OPACITY, q][:, None]
        dx = gx - px[t]
        dy = gy - py[t]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), cfg.alpha_clamp)
        live = ~((power > 0.0) | (alpha < cfg.alpha_min)) \
            & (q[:, None] < limit[t])
        total += int(live.sum())
    return total
