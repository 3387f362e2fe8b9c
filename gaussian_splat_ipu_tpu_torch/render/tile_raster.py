"""Tiled rasterization in plain torch: the CPU spec of kernel C
(render/kernels/rasterize.py) and its plain version on the card.

Port of gaussian_splat_ipu_tpu/render/tile_raster.py, forward only. Every
tile composites its depth-sorted pair range front to back, all tiles and
pixels at once, in chunks of C pairs. A pair is skipped when power > 0 or
alpha < alpha_min; work per range is capped at max_chunks_per_range * C
pairs; pixel centres sit at integer coordinates.

Strict termination (cfg.strict_termination, the reference break,
codelets.cpp:405-408): a pixel stops before blending the first pair with
T * (1 - a) < eps, and its T freezes there.

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


def rasterize_tiles_torch(binned: B.BinnedSplats, cfg: RasterConfig
                          ) -> torch.Tensor:
    """Rasterize binned splats of the whole tile grid -> (T, NPIX, 4) RGBA
    tile buffers."""
    feats = binned.features
    device = feats.device
    c = cfg.chunk_size
    eps = cfg.transmittance_eps
    relaxed = not cfg.strict_termination
    starts = binned.tile_starts.to(torch.int64)
    ends = torch.minimum(binned.tile_ends.to(torch.int64),
                         starts + cfg.max_chunks_per_range * c)
    num_tiles = starts.shape[0]
    # One zero chunk past the end keeps every chunk window in bounds.
    table = torch.cat([feats[:B.FEAT_OPACITY + 1],
                       feats.new_zeros((B.FEAT_OPACITY + 1, c))], dim=1)

    lx, ly = _pixel_coords(cfg, device)
    tids = torch.arange(num_tiles, device=device)
    px = ((tids % cfg.tiles_x) * cfg.tile_width).to(torch.float32)[:, None] \
        + lx[None, :]                                       # (T, NPIX)
    py = ((tids // cfg.tiles_x) * cfg.tile_height).to(torch.float32)[
        :, None] + ly[None, :]

    t = torch.ones_like(px)
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
        chunk = table[:, idx[:, :m]]                        # (9, T, m)
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
            w = (alpha * t)[..., None]
            rgb = torch.stack([r, g, b], dim=-1)            # (T, 1, 3)
            color = torch.where(blend[..., None], color + w * rgb, color)
            t = torch.where(advance, t_next, t)
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=device)
    color = color + t[..., None] * bg
    return torch.cat([color, (1.0 - t)[..., None]], dim=-1)
