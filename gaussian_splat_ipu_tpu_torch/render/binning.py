"""Gaussian -> tile binning on the fused-key path (torch port of
gaussian_splat_ipu_tpu/render/binning.py::bin_splats).

Per frame: each gaussian's clamped tile (or tile-group) rectangle, optional
exact coverage masks (kernel A, render/kernels/coverage.py), slot offsets
by an exclusive cumsum, expansion to (gaussian, tile) pairs (kernel B,
render/kernels/expand.py), per-pair tile decode, ONE stable sort of the i32
key (tile << depth_keep_bits) | quantized depth, and CSR per-tile ranges.
The output is bit-identical to the reference's BinnedSplats.

Not ported yet (utils/config.check_supported rejects them): row-bucket
segmented binning, depth presort, the exact two-pass sort and the
distributed row-strip arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_splat_ipu_tpu_torch.render.kernels import coverage, expand
from gaussian_splat_ipu_tpu_torch.render.projection import ProjectedSplats
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      check_supported,
                                                      tile_bits)

# Rows of the feature-major (TABLE_ROWS, P) pair table, as in the reference.
FEAT_X = 0
FEAT_Y = 1
FEAT_CONIC_A = 2
FEAT_CONIC_B = 3
FEAT_CONIC_C = 4
FEAT_R = 5
FEAT_G = 6
FEAT_B = 7
FEAT_OPACITY = 8
FEAT_DEPTH = 9
NUM_FEATURES = 10
TABLE_ROWS = 16

MASK_SPAN = 8  # cell window of the 64-bit exact-coverage mask (8x8)

I32 = torch.int32
_PAD_KEY = 0x7FFFFFFF


class BinnedSplats(NamedTuple):
    """Sorted (gaussian, tile) pair table + per-tile ranges: tile t's pairs
    occupy [tile_starts[t], tile_ends[t]) of the table, depth-ascending."""

    features: torch.Tensor    # (TABLE_ROWS, P) f32, sorted (tile, depth)
    pair_gid: torch.Tensor    # (P,) i32 gaussian index per pair (N for pad)
    tile_starts: torch.Tensor  # (T,) i32
    tile_ends: torch.Tensor   # (T,) i32
    num_pairs: torch.Tensor   # () i32 valid pairs kept (<= capacity)
    overflow: torch.Tensor    # () i32 pairs dropped due to capacity


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> i32 conversion: saturating, NaN -> 0 (a plain torch
    cast of an out-of-range float is undefined)."""
    big = x >= 2147483648.0
    v = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0)
    return torch.where(big, torch.iinfo(I32).max, v.to(I32))


def tile_ranges_of(splats: ProjectedSplats, cfg: RasterConfig):
    """Clamped tile rectangle [x0, y0] + [nx, ny] per gaussian; culled or
    off-grid gaussians get nx = ny = 0."""
    rx, ry = splats.radius[:, 0], splats.radius[:, 1]
    visible = rx > 0.0
    x, y = splats.xy[:, 0], splats.xy[:, 1]

    def span(c, r, tile_sz, hi_bound):
        lo = torch.clamp_min(_to_i32(torch.floor((c - r) / tile_sz)), 0)
        hi = torch.clamp_max(_to_i32(torch.floor((c + r) / tile_sz)),
                             hi_bound - 1)
        n = torch.clamp(hi - lo + 1, 0, cfg.max_tiles_per_axis)
        return lo, n

    x0, nx = span(x, rx, cfg.tile_width, cfg.tiles_x)
    y0, ny = span(y, ry, cfg.tile_height, cfg.tiles_y)
    zero = torch.zeros_like(nx)
    return x0, y0, torch.where(visible, nx, zero), torch.where(visible, ny,
                                                               zero)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR bit count of uint32 values held in int64 (torch has no
    popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _decode_tiles(gx0, gy0, gnx, masked, mlo_g, mhi_g, rank):
    """Per-pair rank -> (tx, ty). Unmasked: row-major walk of the coverage
    rectangle (integer division equals the reference's f32 floor below
    2^24). Masked: the rank-th set bit of the 64-bit mask (mhi:mlo), found
    by the reference's 5-step popcount binary search. mlo_g/mhi_g are
    uint32 values in int64; the others int64."""
    ty_u = rank // gnx
    tx_u = rank - ty_u * gnx
    c0 = _popcount32(mlo_g)
    in_hi = rank >= c0
    w = torch.where(in_hi, mhi_g, mlo_g)
    r = rank - torch.where(in_hi, c0, 0)
    pos = torch.zeros_like(rank)
    for width in (16, 8, 4, 2, 1):
        c = _popcount32(w & (((1 << width) - 1) << pos))
        go = r >= c
        r = r - torch.where(go, c, 0)
        pos = pos + torch.where(go, width, 0)
    k = torch.where(in_hi, 32, 0) + pos
    tx = gx0 + torch.where(masked == 1, k & 7, tx_u)
    ty = gy0 + torch.where(masked == 1, k >> 3, ty_u)
    return tx, ty


def _decode_key_sort(cols, rank, gid_pre, n, depth_keep_bits, ntx_key):
    """Decode each pair's tile from its expanded integer payload columns +
    rank, build the fused key, stable-sort it, and carry the 10 feature
    rows and the gid through the permutation. Pad pairs take the max key
    and sink to the tail; their columns are zeroed.

    Returns (feats (TABLE_ROWS, P), tile_s (P,) i32, gid_s (P,) i32)."""
    is_pad = gid_pre >= n
    ints = cols[NUM_FEATURES:].to(torch.int64)     # exact-in-f32 payload
    xy0, nxm = ints[0], ints[1]
    mlo_g = (ints[3] << 16) | ints[2]
    mhi_g = (ints[5] << 16) | ints[4]
    tx, ty = _decode_tiles(xy0 & 0xFFF, xy0 >> 12,
                           torch.clamp_min(nxm & 0x3F, 1), (nxm >> 6) & 1,
                           mlo_g, mhi_g, rank.to(torch.int64))
    tile = (ty * ntx_key + tx).to(I32)
    depth_bits = cols[FEAT_DEPTH].contiguous().view(I32)
    key = torch.where(is_pad, _PAD_KEY,
                      (tile << depth_keep_bits)
                      | (depth_bits >> (31 - depth_keep_bits)))
    key_s, perm = torch.sort(key, stable=True)
    gid_s = gid_pre[perm]
    stacked = cols[:NUM_FEATURES][:, perm]
    stacked = torch.where(gid_s[None, :] >= n, 0.0, stacked)
    feats = torch.cat([stacked, stacked.new_zeros(
        (TABLE_ROWS - NUM_FEATURES, stacked.shape[1]))])
    return feats, key_s >> depth_keep_bits, gid_s


def cell_footprints(splats: ProjectedSplats, cfg: RasterConfig):
    """(x0, y0, nx, ny) per gaussian in CELL units: tiles, or g x g tile
    groups when cfg.tile_group = g > 1 (a span inside one group is one
    pair)."""
    x0, y0, nx, ny = tile_ranges_of(splats, cfg)
    g = cfg.tile_group
    if g > 1:
        x1 = x0 + torch.clamp_min(nx - 1, 0)
        y1 = y0 + torch.clamp_min(ny - 1, 0)
        x0, y0 = x0 // g, y0 // g   # non-negative: floor division
        nx = torch.where(nx > 0, x1 // g - x0 + 1, 0)
        ny = torch.where(ny > 0, y1 // g - y0 + 1, 0)
    return x0, y0, nx, ny


def coverage_inputs(splats: ProjectedSplats, x0, y0, nx, ny):
    """Kernel A's inputs: (testable (N,) bool, geomf (6, N) f32, geomi
    (5, N) i32). Footprints wider than the 8x8 mask window keep their
    whole rectangle."""
    testable = (nx <= MASK_SPAN) & (ny <= MASK_SPAN) & (nx * ny > 0)
    geomf = torch.stack([splats.xy[:, 0], splats.xy[:, 1],
                         splats.conic[:, 0], splats.conic[:, 1],
                         splats.conic[:, 2], splats.opacity]).detach()
    geomi = torch.stack([x0, y0, nx, ny, testable.to(I32)]).to(I32)
    return testable, geomf.contiguous(), geomi.contiguous()


def pack_gaussians(splats: ProjectedSplats, cfg: RasterConfig):
    """Kernel B's inputs: the per-gaussian packed rows (N+1, 16) and the
    first pair slot of each gaussian, offsets_ext (N+1,) i32, whose last
    entry is the live pair total."""
    x0, y0, nx, ny = cell_footprints(splats, cfg)
    g = cfg.tile_group
    ncov = (nx * ny).to(I32)
    if cfg.exact_tile_test:
        testable, geomf, geomi = coverage_inputs(splats, x0, y0, nx, ny)
        mlo, mhi, ncov_x = coverage.coverage_masks(
            geomf, geomi, tw=float(g * cfg.tile_width),
            th=float(g * cfg.tile_height), alpha_min=float(cfg.alpha_min))
        ncov = torch.where(testable, ncov_x, ncov)
        flag01 = testable.to(I32)
    else:
        mlo = mhi = flag01 = torch.zeros_like(ncov)

    # The 10 feature columns, then the integer payload as exact-in-f32
    # pieces (x0 | y0<<12, nx | masked<<6, and the 16-bit halves of the two
    # mask words). Row N stays zero: it owns the pad slots.
    live = ncov > 0
    m32 = mlo.to(torch.int64) & 0xFFFFFFFF
    h32 = mhi.to(torch.int64) & 0xFFFFFFFF
    intcols = torch.stack([
        x0.to(torch.int64) | (y0.to(torch.int64) << 12),
        nx.to(torch.int64) | (flag01.to(torch.int64) << 6),
        m32 & 0xFFFF, m32 >> 16, h32 & 0xFFFF, h32 >> 16], dim=-1)
    intcols = torch.where(live[:, None], intcols, 0).to(torch.float32)
    body = torch.cat([splats.xy, splats.conic, splats.color,
                      splats.opacity[:, None], splats.depth[:, None]],
                     dim=-1)
    packed = torch.cat([torch.cat([body, intcols], dim=-1),
                        body.new_zeros((1, NUM_FEATURES + 6))]).contiguous()
    ends_cum = torch.cumsum(ncov.to(torch.int64), 0)
    offsets_ext = torch.cat([ends_cum.new_zeros(1), ends_cum]).to(I32)
    return packed, offsets_ext


def bin_splats(splats: ProjectedSplats, cfg: RasterConfig) -> BinnedSplats:
    """Bin splats into per-tile depth-sorted ranges (single device, whole
    grid). Runs on the device of `splats` without host synchronisation."""
    check_supported(cfg)
    n = splats.xy.shape[0]
    p = cfg.pair_capacity
    if p % cfg.chunk_size:
        raise ValueError(f"pair_capacity {p} is not a multiple of "
                         f"chunk_size {cfg.chunk_size}")
    ntx = cfg.tiles_x
    g = cfg.tile_group
    ntx_key = -(-ntx // g)
    num_keys_total = ntx_key * (-(-cfg.tiles_y // g))

    packed, offsets_ext = pack_gaussians(splats, cfg)
    total = offsets_ext[n]
    cols, gid_pre, rank = expand.stream_expand(packed, offsets_ext, p)
    feats, tile_s, gid_s = _decode_key_sort(cols, rank, gid_pre, n,
                                            31 - tile_bits(cfg), ntx_key)

    # Per-tile ranges; with tile groups every member tile points at its
    # group's range.
    tids = torch.arange(cfg.num_tiles, dtype=I32, device=splats.xy.device)
    if g > 1:
        tids = (tids // ntx // g) * ntx_key + (tids % ntx) // g
    starts = torch.searchsorted(tile_s, tids, out_int32=True)
    ends = torch.searchsorted(tile_s, tids, right=True, out_int32=True)
    pad_s = tile_s >= num_keys_total
    return BinnedSplats(
        features=feats,
        pair_gid=torch.where(pad_s, n, gid_s).to(I32),
        tile_starts=starts,
        tile_ends=ends,
        num_pairs=torch.clamp_max(total, p),
        overflow=torch.clamp_min(total - p, 0),
    )
