"""The tile cull of the compositing kernels C and D, through its plain twin
tile_cull_torch: a culled pair is skipped at every pixel of its tile by
the plain rasterizer's own arithmetic; the work counters agree with a
brute-force count; the kernels' thread layout."""

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render import binning
from gaussian_splat_ipu_tpu_torch.render.kernels import rasterize
from gaussian_splat_ipu_tpu_torch.render.projection import project_gaussians
from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
    KAPPA_MAX, live_evaluations, rasterize_tiles_torch, surviving_pairs,
    tile_cull_torch)
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

torch.set_num_threads(1)

ALPHA_MIN = 1.0 / 255.0
CLAMP = 0.99


def random_pairs(rng, k, tile):
    """(9, k) f32 pairs around a tile [0, tile - 1]^2 of pixel centres:
    conics of every condition up to past KAPPA_MAX, opacities around
    alpha_min, centres spread across the tile's edges and corners; some
    degenerate (det <= 0, A <= 0), some non-finite."""
    scale = np.exp(rng.uniform(np.log(0.02), np.log(30.0), k))
    kappa = np.exp(rng.uniform(0.0, np.log(3 * KAPPA_MAX), k))
    theta = rng.uniform(0, np.pi, k)
    # Eigenvalues 1 / s^2 and 1 / (s^2 kappa): AC / det spans the range.
    l1, l2 = 1.0 / scale ** 2, 1.0 / (scale ** 2 * kappa)
    cs, sn = np.cos(theta), np.sin(theta)
    a = l1 * cs ** 2 + l2 * sn ** 2
    c = l1 * sn ** 2 + l2 * cs ** 2
    b = (l1 - l2) * cs * sn
    op = np.exp(rng.uniform(np.log(ALPHA_MIN / 2), np.log(1.5), k))
    reach = 1.5 * np.sqrt(2 * np.log(np.maximum(op / ALPHA_MIN, 1.0))
                          * np.maximum(c, a) / (a * c - b * b))
    x = rng.uniform(-1, tile, k) + rng.choice([-1, 0, 1], k) * (
        rng.uniform(0.5, 1.5, k) * np.minimum(reach, 1e4))
    y = rng.uniform(-1, tile, k) + rng.choice([-1, 0, 1], k) * (
        rng.uniform(0.5, 1.5, k) * np.minimum(reach, 1e4))
    rows = np.stack([x, y, a, b, c, *rng.uniform(0, 1, (3, k)), op])
    rows = rows.astype(np.float32)
    m = k // 40
    rows[4, :m] = rows[3, :m] ** 2 / np.maximum(rows[2, :m], 1e-6)  # det 0
    rows[3, m:2 * m] = np.sqrt(rows[2, m:2 * m] * rows[4, m:2 * m]) * 1.5
    rows[2, 2 * m:3 * m] *= -1.0                           # A < 0
    rows[0, 3 * m] = np.nan
    rows[3, 3 * m + 1] = np.inf
    rows[8, 3 * m + 2] = np.inf
    rows[2, 3 * m + 3] = 1e30                              # AC overflows
    return torch.tensor(rows)


def plain_skip(rows, px, py):
    """(K, NPIX) the plain rasterizer's skip test (tile_raster.py) for
    pairs rows (9, K) at pixel centres px, py (NPIX,)."""
    gx, gy, ca, cb, cc = (r[:, None] for r in rows[:5])
    op = rows[8][:, None]
    dx = gx - px[None]
    dy = gy - py[None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp_max(op * torch.exp(power), CLAMP)
    return (power > 0.0) | (alpha < ALPHA_MIN), power


@pytest.mark.parametrize("tile", [16, 32])
def test_culled_pairs_are_skipped_at_every_pixel(tile):
    rng = np.random.default_rng(tile)
    rows = random_pairs(rng, 6000, tile)
    zero = torch.zeros(rows.shape[1])
    culled = tile_cull_torch(rows, zero, zero + (tile - 1), zero,
                             zero + (tile - 1), ALPHA_MIN)
    idx = torch.arange(tile * tile)
    px, py = (idx % tile).float(), (idx // tile).float()
    skip, power = plain_skip(rows, px, py)
    assert bool(skip[culled].all())
    # The cull is not vacuous: it removes most pairs that no pixel uses,
    # and every pair below alpha_min.
    dead = skip.all(1)
    assert int(culled.sum()) > 0.6 * int(dead.sum()) > 300
    assert bool(culled[rows[8] < ALPHA_MIN].all())
    # Never culled: a non-finite value, A <= 0, det <= 0, AC / det past
    # KAPPA_MAX (unless op < alpha_min).
    a, b, c, op = rows[2], rows[3], rows[4], rows[8]
    det = a * c - b * b
    keep = (~torch.isfinite(rows[[0, 1, 2, 3, 4, 8]]).all(0) | (a <= 0)
            | (det <= 0) | (a * c > KAPPA_MAX * det)) & ~(op < ALPHA_MIN)
    assert int(keep.sum()) > 200 and not bool(culled[keep].any())
    # The kernels' per-pixel expf skip: power < -tau_m implies a skip.
    ok = ~keep & (op >= ALPHA_MIN) & torch.isfinite(op)
    tau_m = 1.05 * torch.log(op / ALPHA_MIN) + 0.05
    below = (power < -tau_m[:, None]) & ok[:, None]
    assert int(below.sum()) > 1000 and bool(skip[below].all())


def test_pairs_on_the_tile_edge():
    """Isotropic splats whose alpha_min circle just reaches the tile's
    first column from the left: those that reach it are kept."""
    k = 2000
    rng = np.random.default_rng(9)
    s = rng.uniform(0.3, 5.0, k)
    op = rng.uniform(0.05, 1.0, k)
    r = s * np.sqrt(2 * np.log(op / ALPHA_MIN))
    x = -r + rng.uniform(-0.3, 0.3, k)
    rows = np.zeros((9, k), np.float32)
    rows[0], rows[1] = x, 8.0
    rows[2] = rows[4] = 1.0 / s ** 2
    rows[8] = op
    rows = torch.tensor(rows)
    zero = torch.zeros(k)
    culled = tile_cull_torch(rows, zero, zero + 15, zero, zero + 15,
                             ALPHA_MIN)
    idx = torch.arange(256)
    skip, _ = plain_skip(rows, (idx % 16).float(), (idx // 16).float())
    assert not bool(culled[~skip.all(1)].any())
    assert bool(skip[culled].all())


def small_frame(cfg, n=1200, seed=0):
    g = torch.Generator().manual_seed(seed)
    model = GaussianModel.random(n, generator=g, device="cpu")
    cam = Camera.orbit(-np.ones(3), np.ones(3), 0.7,
                       cfg.image_width / cfg.image_height, rot_y_deg=25.0,
                       device="cpu")
    binned = binning.bin_splats(project_gaussians(model, cam, cfg), cfg)
    _, nc = rasterize_tiles_torch(binned, cfg, need_aux=True)
    return binned, nc


@pytest.mark.parametrize("tile_group", [1, 3])
def test_work_counters_match_brute_force(tile_group):
    cfg = RasterConfig(image_width=96, image_height=64, tile_width=16,
                       tile_height=16, chunk_size=32, pair_capacity=1 << 13,
                       tile_group=tile_group, exact_tile_test=True)
    binned, nc = small_frame(cfg)
    feats = binned.features
    live = walked = kept = 0
    idx = torch.arange(cfg.pixels_per_tile)
    for t in range(cfg.num_tiles):
        s, e = int(binned.tile_starts[t]), int(binned.tile_ends[t])
        if e <= s:
            continue
        x0 = float((t % cfg.tiles_x) * 16)
        y0 = float((t // cfg.tiles_x) * 16)
        rows = feats[:9, s:e]
        skip, _ = plain_skip(rows, x0 + (idx % 16).float(),
                             y0 + (idx // 16).float())
        pos = torch.arange(s, e)[:, None]
        live += int((~skip & (pos < s + nc[t].long()[None])).sum())
        n_walk = min(e - s, int(nc[t].max()))
        walked += n_walk
        culled = tile_cull_torch(rows[:, :n_walk], torch.tensor(x0),
                                 torch.tensor(x0 + 15), torch.tensor(y0),
                                 torch.tensor(y0 + 15), cfg.alpha_min)
        assert bool(skip[:n_walk][culled].all())
        kept += int((~culled).sum())
    assert live_evaluations(binned, cfg, nc, batch=97) == live > 0
    assert surviving_pairs(binned, cfg, nc) == (walked, kept)
    # Exact binning already drops the tiles a splat misses; a group range
    # holds its member tiles' pairs, most of which miss any one tile.
    assert 0 < kept <= walked
    if tile_group > 1:
        assert kept < 0.7 * walked


@pytest.mark.parametrize("tile, chunk, max_ppt, want", [
    ((32, 32), 128, 4, (4, 16, 256)), ((32, 32), 128, 2, (2, 16, 512)),
    ((16, 16), 32, 4, (4, 16, 64)), ((16, 16), 128, 2, (2, 16, 128)),
    ((16, 16), 256, 4, (2, 16, 128)), ((32, 32), 1024, 4, (2, 16, 512)),
    ((8, 8), 16, 4, (2, 8, 32)), ((24, 16), 64, 4, (4, 8, 96)),
    ((32, 3), 32, 4, None), ((32, 32), 2048, 4, None),
    ((32, 32), 128, 1, None)])
def test_kernel_layout(tile, chunk, max_ppt, want):
    """(pixels per thread, warp rectangle width, threads) as the kernels'
    choose_layout picks them, C capped at 2 pixels a thread, D at 4."""
    cfg = RasterConfig(tile_width=tile[0], tile_height=tile[1],
                       chunk_size=chunk)
    assert rasterize._layout(cfg, max_ppt) == want
