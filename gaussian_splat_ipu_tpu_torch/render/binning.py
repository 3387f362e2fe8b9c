"""Gaussian -> tile binning (torch port of
gaussian_splat_ipu_tpu/render/binning.py::bin_splats, every path of it).

Per frame: each gaussian's clamped tile (or tile-group) rectangle, optional
exact coverage masks (kernel A, render/kernels/coverage.py), slot offsets
by an exclusive cumsum, expansion to (gaussian, tile) pairs, per-pair tile
decode, a stable sort, and CSR per-tile ranges. The path is chosen as the
reference chooses it (binning.py:901-944, :1019-1133):

- fused stream (the default): kernel B (render/kernels/expand.py) expands
  the pairs from the offsets, and ONE stable sort orders the i32 key
  (tile << depth_keep_bits) | quantized depth;
- row-bucket segmented (`rowseg_buckets` R > 1, on the fused stream path
  when the grid has at least R group rows): per-bucket pair counts, their
  row scan (kernel E, render/kernels/scan.py), the segmented kernel B
  placing every pair in its bucket's chunk-aligned segment, a batched
  (R, cap) stable sort and CSR ranges per bucket;
- gather paths (`expand_kernel=False`; `presort_depth`, which presorts the
  N gaussians by depth and sorts the pairs by tile alone; the exact
  two-pass sort, for `fused_sort_key=False` or a grid that leaves fewer
  than 16 depth bits): a scatter-max of first slots and two cummax scans
  give each slot's gaussian and rank, and kernel F (`expand_pairs`)
  gathers the rows.
The output is bit-identical to the reference's BinnedSplats.

Row strips (binning.py:804-865, :967-976): with row_lo / num_rows, bin_splats
enumerates only the pairs of tile rows [row_lo, min(row_lo + num_rows,
tiles_y)) and reports the ranges of those num_rows * tiles_x tiles, keyed by
global tile id; this is one shard's strip on the distributed path
(parallel/distributed.py). The sort key's tile bits are the global grid's
(utils/config.tile_bits), so a strip's pairs sort as the single-device
table's. Two guards of the port's own, where the reference goes wrong on
inputs its own callers do not make:
- phantom tiles (rows past the grid, on the last strip of an uneven
  sharding) query the first key past the grid, so their ranges are empty
  even where the reference's phantom id would equal the pad sentinel
  (tiles_y = 8, tile_group = 3, 8 strips);
- the row buckets of a strip that does not start on a group row cover every
  group row the strip touches (the reference's ceil(num_rows / g) misses the
  last one and drops its pairs).

Gradients: every path's pair table is a row selection of the packed
per-gaussian table, so its backward (`_PairTable`) is one index_add_ of
the table's cotangent rows by sorted gid, as the reference's VJPs
(binning.py:307-315, :465-473, :660-668, :727-738, :790-797). Everything
else here is integer work or detached, as in the reference (binning.py:136,
:204).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from gaussian_splat_ipu_tpu_torch.render.kernels import coverage, expand, scan
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

# Each row bucket's capacity is a multiple of this: the reference aligns
# its buckets to the compiled TPU expand chunk (binning.py:497-498), so the
# port's segment layout equals the JAX package's on the TPU. (Under the
# Pallas interpreter the reference aligns to 256, binning.py:495-496; the
# parity tests set this to 256.)
SEG_ALIGN = 2048

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


class Footprints(NamedTuple):
    """Per-gaussian cell coverage, (N,) i32 each: the clamped cell
    rectangle, its pair count, and the exact-coverage flag and mask words
    (zero without exact_tile_test)."""

    x0: torch.Tensor
    y0: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    ncov: torch.Tensor
    flag01: torch.Tensor
    mlo: torch.Tensor
    mhi: torch.Tensor


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> i32 conversion: saturating, NaN -> 0 (a plain torch
    cast of an out-of-range float is undefined)."""
    big = x >= 2147483648.0
    v = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0)
    return torch.where(big, torch.iinfo(I32).max, v.to(I32))


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """The i32 bits of x as f32 (the reference's bitcast_convert_type)."""
    return x.to(I32).contiguous().view(torch.float32)


def tile_ranges_of(splats: ProjectedSplats, cfg: RasterConfig,
                   row_lo: int = 0, row_hi: int | None = None):
    """Clamped tile rectangle [x0, y0] + [nx, ny] per gaussian; culled or
    off-grid gaussians get nx = ny = 0. row_lo / row_hi restrict the rows
    to [row_lo, row_hi) (a strip; default the whole grid): a gaussian
    disjoint from them gets nx = ny = 0."""
    if row_hi is None:
        row_hi = cfg.tiles_y
    rx, ry = splats.radius[:, 0], splats.radius[:, 1]
    visible = rx > 0.0
    x, y = splats.xy[:, 0], splats.xy[:, 1]

    def span(c, r, tile_sz, lo_bound, hi_bound):
        lo = torch.clamp_min(_to_i32(torch.floor((c - r) / tile_sz)),
                             lo_bound)
        hi = torch.clamp_max(_to_i32(torch.floor((c + r) / tile_sz)),
                             hi_bound - 1)
        n = torch.clamp(hi - lo + 1, 0, cfg.max_tiles_per_axis)
        return lo, n

    x0, nx = span(x, rx, cfg.tile_width, 0, cfg.tiles_x)
    y0, ny = span(y, ry, cfg.tile_height, row_lo, row_hi)
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


def _pair_tile_decode(geom_g, mlo_g, mhi_g, rank):
    """Per-pair rank -> (tx, ty) i64 from the 31-bit packed geometry
    (x0 | y0<<12 | nx<<24 | masked<<30, i32) and the i32 mask words of the
    presort and exact paths (binning.py:218-226)."""
    geom = geom_g.to(torch.int64)
    return _decode_tiles(geom & 0xFFF, (geom >> 12) & 0xFFF,
                         torch.clamp_min((geom >> 24) & 0x3F, 1),
                         (geom >> 30) & 1,
                         mlo_g.to(torch.int64) & 0xFFFFFFFF,
                         mhi_g.to(torch.int64) & 0xFFFFFFFF,
                         rank.to(torch.int64))


def _with_zero_rows(stacked: torch.Tensor) -> torch.Tensor:
    """(NUM_FEATURES, P) -> (TABLE_ROWS, P) with a zero block below."""
    return torch.cat([stacked, stacked.new_zeros(
        (TABLE_ROWS - NUM_FEATURES, stacked.shape[1]))])


def _decode_key_sort(cols, rank, gid_pre, n, depth_keep_bits, ntx_key,
                     seg=None):
    """Decode each pair's tile from its expanded integer payload columns +
    rank, build the fused key, stable-sort it, and carry the 10 feature
    rows and the gid through the permutation. Pad pairs take the max key
    and sink to the tail; their columns are zeroed.

    seg=(R, cap): the pairs already sit in R row-bucket segments of cap
    slots; the sort is then a batched (R, cap) sort along the last axis
    (binning.py:366-370). Buckets are whole group rows in ascending order,
    so their sorted runs, concatenated, are in global key order.

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
    if seg is None:
        key_s, perm = torch.sort(key, stable=True)
    else:
        r_b, cap = seg
        key_s, perm = torch.sort(key.view(r_b, cap), dim=1, stable=True)
        perm = (perm + torch.arange(r_b, device=perm.device)[:, None]
                * cap).reshape(-1)
        key_s = key_s.reshape(-1)
    gid_s = gid_pre[perm]
    stacked = cols[:NUM_FEATURES][:, perm]
    stacked = torch.where(gid_s[None, :] >= n, 0.0, stacked)
    return _with_zero_rows(stacked), key_s >> depth_keep_bits, gid_s


def _expand_sort(packed, offsets_ext, p, depth_keep_bits, ntx_key):
    """Fused stream table: kernel B + `_decode_key_sort`. packed (N+1, 16)
    -> (feats (TABLE_ROWS, P), tile_s (P,) i32, gid_s (P,) i32)."""
    cols, gid_pre, rank = expand.stream_expand(packed, offsets_ext, p)
    return _decode_key_sort(cols, rank, gid_pre, packed.shape[0] - 1,
                            depth_keep_bits, ntx_key)


def _rowseg_sort(packed, offs, offs2, live_end, cap, depth_keep_bits,
                 ntx_key):
    """Segmented table (binning.py:637-652): the segmented kernel B places
    every pair in its bucket, then the batched (R, cap) sort."""
    cols, gid_pre, rank = expand.stream_expand_seg(packed, offs, offs2,
                                                   live_end, cap)
    return _decode_key_sort(cols, rank, gid_pre, packed.shape[0] - 1,
                            depth_keep_bits, ntx_key,
                            seg=(offs.shape[0], cap))


def _gather_sort(packed, gid_pre, rank, depth_keep_bits, ntx_key):
    """Fused table by the gather expansion (expand_kernel=False,
    binning.py:711-721): kernel F + `_decode_key_sort`."""
    return _decode_key_sort(expand.expand_pairs(packed, gid_pre), rank,
                            gid_pre, packed.shape[0] - 1, depth_keep_bits,
                            ntx_key)


def _presorted_sort(packed, gid_pre, rank, ntx_key):
    """Tile-only stable sort over the pairs of depth-presorted gaussians
    (binning.py:744-782). packed: (N+1, 16) rows in depth order: the 10
    features, then the i32 bits of the packed geometry, the two mask words
    and the original gaussian id, then two zero columns. Returns (feats,
    key_s (P,) i32, gid_s (P,) i32 in depth order, orig_gid_s (P,) i32)."""
    table = expand.expand_pairs(packed, gid_pre)
    ints = table[NUM_FEATURES:NUM_FEATURES + 4].contiguous().view(I32)
    tx, ty = _pair_tile_decode(ints[0], ints[1], ints[2], rank)
    key = torch.where(gid_pre >= packed.shape[0] - 1, _PAD_KEY,
                      (ty * ntx_key + tx).to(I32))
    key_s, perm = torch.sort(key, stable=True)
    return (_with_zero_rows(table[:NUM_FEATURES][:, perm]), key_s,
            gid_pre[perm], ints[3][perm])


def _exact_sort(packed, tile, gid_pre):
    """The exact path's table (binning.py:264-298): two stable sorts,
    by the full depth bits and then by tile. packed: (N+1, 16), the 10
    features and zero columns."""
    table = expand.expand_pairs(packed, gid_pre)
    depth_bits = torch.where(gid_pre >= packed.shape[0] - 1, _PAD_KEY,
                             table[FEAT_DEPTH].contiguous().view(I32))
    _, by_depth = torch.sort(depth_bits, stable=True)
    tile_s, by_tile = torch.sort(tile[by_depth], stable=True)
    perm = by_depth[by_tile]
    return (_with_zero_rows(table[:NUM_FEATURES][:, perm]), tile_s,
            gid_pre[perm])


class _PairTable(torch.autograd.Function):
    """A pair table `build(packed)` -> (feats, tile_s, gid_s, *rest),
    differentiable in `packed`: every path's table is a row selection of
    packed, so the backward adds each pair's cotangent rows 0-9 into row
    gid_s of packed (pads carry gid N, the zero row) and gives the other
    columns zero."""

    @staticmethod
    def forward(ctx, packed, build):
        out = build(packed)
        ctx.save_for_backward(out[2])
        ctx.packed_shape = packed.shape
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dfeat, *_):
        gid_s, = ctx.saved_tensors
        rows, width = ctx.packed_shape
        dbody = dfeat.new_zeros((rows, NUM_FEATURES)).index_add_(
            0, gid_s, dfeat[:NUM_FEATURES].T)
        dpacked = torch.cat([dbody, dbody.new_zeros(
            (rows, width - NUM_FEATURES))], dim=1)
        return dpacked, None


def _pair_table(build, packed):
    if torch.is_grad_enabled() and packed.requires_grad:
        return _PairTable.apply(packed, build)
    return build(packed)


def cell_footprints(splats: ProjectedSplats, cfg: RasterConfig,
                    row_lo: int = 0, row_hi: int | None = None):
    """(x0, y0, nx, ny) per gaussian in CELL units: tiles, or g x g tile
    groups when cfg.tile_group = g > 1 (a span inside one group is one
    pair), over tile rows [row_lo, row_hi)."""
    x0, y0, nx, ny = tile_ranges_of(splats, cfg, row_lo, row_hi)
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


def footprints(splats: ProjectedSplats, cfg: RasterConfig,
               row_lo: int = 0, row_hi: int | None = None) -> Footprints:
    """Cell rectangles and pair counts over tile rows [row_lo, row_hi),
    exact ones (kernel A) with exact_tile_test."""
    x0, y0, nx, ny = cell_footprints(splats, cfg, row_lo, row_hi)
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
    return Footprints(x0, y0, nx, ny, ncov, flag01, mlo, mhi)


def _body(splats: ProjectedSplats) -> torch.Tensor:
    """The (N, 10) feature rows, in FEAT_* order."""
    return torch.cat([splats.xy, splats.conic, splats.color,
                      splats.opacity[:, None], splats.depth[:, None]],
                     dim=-1)


def _offsets(ncov: torch.Tensor) -> torch.Tensor:
    """(N+1,) i32 first pair slot of each gaussian; the last entry is the
    live pair total."""
    ends_cum = torch.cumsum(ncov.to(torch.int64), 0)
    return torch.cat([ends_cum.new_zeros(1), ends_cum]).to(I32)


def _pack_fused(body: torch.Tensor, fp: Footprints) -> torch.Tensor:
    """The fused paths' (N+1, 16) packed rows: the 10 feature columns, then
    the integer payload as exact-in-f32 pieces (x0 | y0<<12,
    nx | masked<<6, and the 16-bit halves of the two mask words). Row N
    stays zero: it owns the pad slots."""
    live = fp.ncov > 0
    m32 = fp.mlo.to(torch.int64) & 0xFFFFFFFF
    h32 = fp.mhi.to(torch.int64) & 0xFFFFFFFF
    intcols = torch.stack([
        fp.x0.to(torch.int64) | (fp.y0.to(torch.int64) << 12),
        fp.nx.to(torch.int64) | (fp.flag01.to(torch.int64) << 6),
        m32 & 0xFFFF, m32 >> 16, h32 & 0xFFFF, h32 >> 16], dim=-1)
    intcols = torch.where(live[:, None], intcols, 0).to(torch.float32)
    return torch.cat([torch.cat([body, intcols], dim=-1),
                      body.new_zeros((1, NUM_FEATURES + 6))]).contiguous()


def pack_gaussians(splats: ProjectedSplats, cfg: RasterConfig):
    """Kernel B's inputs on the fused stream path: the per-gaussian packed
    rows (N+1, 16) and the first pair slot of each gaussian, offsets_ext
    (N+1,) i32, whose last entry is the live pair total."""
    fp = footprints(splats, cfg)
    return _pack_fused(_body(splats), fp), _offsets(fp.ncov)


def gather_slots(offsets_ext: torch.Tensor, p: int):
    """Each of P slots' gaussian and rank from the first-slot offsets, as
    the reference's gather paths find them (binning.py:978-994): every
    covering gaussian's id is scatter-maxed at its first slot (a sentinel
    N at the live total owns the pad tail; slots past P drop), a cummax
    forward-fills it, and the rank counts from where the gid changes.
    Returns (gid (P,) i32, N for pads, ascending; rank (P,) i32)."""
    n = offsets_ext.shape[0] - 1
    dev = offsets_ext.device
    covering = torch.cat([offsets_ext[1:] > offsets_ext[:-1],
                          torch.ones(1, dtype=torch.bool, device=dev)])
    first = torch.where(covering, offsets_ext, p).clamp_max(p)
    gid_at = torch.zeros(p + 1, dtype=I32, device=dev).scatter_reduce_(
        0, first.long(), torch.arange(n + 1, dtype=I32, device=dev),
        "amax")[:p]
    gid = torch.cummax(gid_at, 0).values
    slot = torch.arange(p, dtype=I32, device=dev)
    prev = torch.cat([gid.new_full((1,), -1), gid[:-1]])
    rank = slot - torch.cummax(torch.where(gid != prev, slot, 0), 0).values
    return gid, rank


@functools.lru_cache(maxsize=64)
def _bounds_on(bounds: tuple, device: torch.device) -> torch.Tensor:
    """The bucket bounds as an i32 tensor on `device`, made once: a copy
    from host memory each frame would synchronise the stream."""
    with torch.inference_mode(False):
        return torch.tensor(bounds, dtype=I32, device=device)


def _bucket_counts(y0, nx, ny, flag01, mlo, mhi, gy_lo, bounds):
    """(R, N) i32 exact per-bucket pair counts (binning.py:503-530).

    Bucket r covers group rows [bounds[r], bounds[r+1]) counted from
    gy_lo. Masked footprints (flag01 = 1) count the popcount of each of
    their mask rows into the bucket holding that row; rectangles count nx
    per overlapped row. The column sums are the gaussians' ncov."""
    r_b = len(bounds) - 1
    b = _bounds_on(tuple(bounds), y0.device)
    rel = y0 - gy_lo
    ov = torch.clamp_min(torch.minimum(rel + ny, b[1:, None])
                         - torch.maximum(rel, b[:-1, None]), 0)
    rect = nx * ov                                             # (R, N)
    dy = torch.arange(MASK_SPAN, dtype=I32, device=y0.device)[:, None]
    byte = (torch.where(dy < 4, mlo, mhi) >> ((dy % 4) * 8)) & 0xFF
    byte = byte - ((byte >> 1) & 0x55)                         # popcount
    byte = (byte & 0x33) + ((byte >> 2) & 0x33)
    rowpop = torch.where(dy < ny, (byte + (byte >> 4)) & 0x0F, 0)  # (8, N)
    row = rel + dy
    bucket = torch.where((row >= bounds[0]) & (row < bounds[-1]),
                         torch.searchsorted(b, row, right=True) - 1, r_b)
    masked = torch.zeros((r_b + 1, y0.shape[0]), dtype=I32,
                         device=y0.device).scatter_add_(
        0, bucket.long(), rowpop)[:r_b]
    return torch.where(flag01 == 1, masked, rect).to(I32)


def balance_bounds(row_demands, r_buckets: int, min_sum: int = 0):
    """Optimal demand-balanced contiguous partition of group rows (a copy
    of the reference's plain-Python balance_bounds, binning.py:533-588).

    row_demands: per-group-row pair demand (pass the WORST over the
    camera set for orbit workloads). Returns an (R+1,) tuple of bucket
    start rows for RasterConfig.rowseg_bounds, minimizing the MAXIMUM
    bucket demand (DP linear partition) subject to every bucket's demand
    >= min_sum where feasible."""
    d = [int(x) for x in row_demands]
    nrows = len(d)
    if r_buckets >= nrows:
        return tuple(range(nrows + 1))
    pre = [0]
    for x in d:
        pre.append(pre[-1] + x)

    def seg(j, i):
        return pre[i] - pre[j]

    big = float("inf")

    def solve(floor):
        # f[r][i]: min possible max-bucket-demand partitioning rows
        # [0, i) into r buckets, each with sum >= floor.
        f = [[big] * (nrows + 1) for _ in range(r_buckets + 1)]
        arg = [[0] * (nrows + 1) for _ in range(r_buckets + 1)]
        f[0][0] = 0
        for r in range(1, r_buckets + 1):
            for i in range(1, nrows + 1):
                for j in range(i):
                    if f[r - 1][j] == big:
                        continue
                    s = seg(j, i)
                    if s < floor:
                        continue
                    v = max(f[r - 1][j], s)
                    if v < f[r][i]:
                        f[r][i] = v
                        arg[r][i] = j
        if f[r_buckets][nrows] == big:
            return None
        bounds = [nrows]
        for r in range(r_buckets, 0, -1):
            bounds.append(arg[r][bounds[-1]])
        return tuple(reversed(bounds))

    return solve(min_sum) or solve(0) or tuple(
        [0] + list(range(nrows - r_buckets + 1, nrows + 1)))


def bucket_demands(splats: ProjectedSplats, cfg: RasterConfig):
    """Per-group-row pair demand of this frame, (nrows_g,) i32: the probe
    input for balance_bounds (binning.py:591-613)."""
    fp = footprints(splats, cfg)
    nrows_g = -(-cfg.tiles_y // cfg.tile_group)
    counts = _bucket_counts(fp.y0, fp.nx, fp.ny, fp.flag01, fp.mlo, fp.mhi,
                            0, tuple(range(nrows_g + 1)))
    return counts.sum(dim=1, dtype=I32)


def rowseg_bounds(cfg: RasterConfig, nrows_g: int) -> tuple:
    """The (R+1,) bucket bounds in group rows: cfg.rowseg_bounds, checked,
    or an equal split whose trailing buckets may lie past the grid (they
    bin nothing and sort pure pads)."""
    r_seg = cfg.rowseg_buckets
    if cfg.rowseg_bounds:
        bounds = tuple(int(b) for b in cfg.rowseg_bounds)
        if not (len(bounds) == r_seg + 1 and bounds[0] == 0
                and bounds[-1] >= nrows_g
                and all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))):
            raise ValueError("rowseg_bounds must be (R+1,) ascending local "
                             f"group rows: {bounds} for R = {r_seg}, "
                             f"{nrows_g} group rows")
        return bounds
    rows_pb = -(-nrows_g // r_seg)
    return tuple(r * rows_pb for r in range(r_seg + 1))


class RowSegLayout(NamedTuple):
    """Where the segmented binning places each gaussian's pairs: R buckets
    of `cap` slots, bucket r owning slots [r * cap, (r + 1) * cap)."""

    counts: torch.Tensor    # (R, N) i32 pairs of gaussian g in bucket r
    offs: torch.Tensor      # (R, N) i32 first slot of g's pairs in bucket r
    offs2: torch.Tensor     # (R, N) i32 offs less g's pairs in earlier ones
    live_end: torch.Tensor  # (R,) i32 first pad slot of each bucket
    kept: torch.Tensor      # (R,) i32 pairs each bucket keeps (<= cap)
    cap: int
    bounds: tuple           # (R+1,) first group row of each bucket


def strip_group_rows(cfg: RasterConfig, row_lo: int, num_rows: int):
    """(first group row, group rows) of the strip of tile rows [row_lo,
    row_lo + num_rows): every group row the strip touches."""
    g = cfg.tile_group
    gy_lo = row_lo // g
    return gy_lo, (row_lo + num_rows - 1) // g - gy_lo + 1


def rowseg_layout(fp: Footprints, cfg: RasterConfig, row_lo: int = 0,
                  num_rows: int | None = None,
                  pair_capacity: int | None = None) -> RowSegLayout:
    """The segment geometry (binning.py:942-966, :1053-1077): per-bucket
    pair counts, their row scan (kernel E) into absolute slot offsets, and
    each bucket's live end. The buckets split the group rows of the strip
    [row_lo, row_lo + num_rows) (default the whole grid), counted from its
    first. The capacity per bucket is pair_capacity / R rounded up to
    SEG_ALIGN (binning.py:965). A bucket whose demand exceeds it keeps its
    first `cap` pairs."""
    r_seg = cfg.rowseg_buckets
    gy_lo, nrows_g = strip_group_rows(
        cfg, row_lo, cfg.tiles_y if num_rows is None else num_rows)
    bounds = rowseg_bounds(cfg, nrows_g)
    p = pair_capacity or cfg.pair_capacity
    cap = -(-(-(-p // r_seg)) // SEG_ALIGN) * SEG_ALIGN
    if cap % cfg.chunk_size:
        raise ValueError(f"row-bucket capacity {cap} is not a multiple of "
                         f"chunk_size {cfg.chunk_size}")
    counts = _bucket_counts(fp.y0, fp.nx, fp.ny, fp.flag01, fp.mlo, fp.mhi,
                            gy_lo, bounds)
    excl = scan.row_cumsum_exclusive(counts)
    kept = torch.clamp_max(excl[:, -1] + counts[:, -1], cap)
    bases = torch.arange(r_seg, dtype=I32, device=counts.device) * cap
    offs = bases[:, None] + excl
    # A pair's decode rank addresses the gaussian's WHOLE footprint, so
    # the rank offsets subtract its pairs in earlier buckets.
    offs2 = offs - (torch.cumsum(counts, dim=0) - counts).to(I32)
    return RowSegLayout(counts, offs, offs2, bases + kept, kept, cap, bounds)


def _bin_rowseg(fp: Footprints, body, cfg: RasterConfig, tids, queries,
                ntx_key, depth_keep_bits, row_lo, num_rows, p):
    """Row-bucket segmented binning (binning.py:1049-1100): (feats,
    tile_s, gid_s, starts, ends, num_pairs, overflow). tids: each reported
    tile's key, which picks its bucket; queries: the key its range is
    searched for (phantom tiles clamped past the grid)."""
    lay = rowseg_layout(fp, cfg, row_lo, num_rows, p)
    r_seg, cap = lay.offs.shape[0], lay.cap
    feats, tile_s, gid_s = _pair_table(
        lambda pk: _rowseg_sort(pk, lay.offs, lay.offs2, lay.live_end, cap,
                                depth_keep_bits, ntx_key),
        _pack_fused(body, fp))
    # CSR per bucket: each tile searches the sorted run of the bucket
    # holding its group row.
    runs = tile_s.view(r_seg, cap)
    queries = queries.expand(r_seg, -1).contiguous()
    rel = tids // ntx_key - row_lo // cfg.tile_group
    b_t = torch.zeros_like(tids)
    for b in lay.bounds[1:-1]:
        b_t = b_t + (rel >= b).to(I32)
    b_t = torch.clamp(b_t, 0, r_seg - 1)
    row = b_t[None].long()
    starts = b_t * cap + torch.searchsorted(
        runs, queries, out_int32=True).gather(0, row)[0]
    ends = b_t * cap + torch.searchsorted(
        runs, queries, right=True, out_int32=True).gather(0, row)[0]
    live_total = lay.kept.sum(dtype=I32)
    return (feats, tile_s, gid_s, starts, ends, live_total,
            fp.ncov.sum(dtype=I32) - live_total)


def _bin_gather(fp: Footprints, body, splats: ProjectedSplats, p: int,
                use_presort: bool, fused: bool, depth_keep_bits, ntx_key):
    """The gather paths (binning.py:901-920, :978-1005, :1019-1031,
    :1119-1133): (feats, tile_s, gid_s, total)."""
    n = body.shape[0]
    geom = torch.where(fp.ncov > 0, fp.x0 | (fp.y0 << 12) | (fp.nx << 24)
                       | (fp.flag01 << 30), 0)
    mlo, mhi, ncov = fp.mlo, fp.mhi, fp.ncov
    if use_presort:
        # Depth-presort the N gaussians: their pairs then come out in
        # depth order and a stable tile-only sort suffices. Gaussians
        # without pairs go last whatever their depth bits.
        depth_key = torch.where(
            ncov > 0, splats.depth.detach().contiguous().view(I32),
            _PAD_KEY)
        _, perm = torch.sort(depth_key, stable=True)
        body, geom, mlo, mhi, ncov = (
            x[perm] for x in (body, geom, mlo, mhi, ncov))
    offsets_ext = _offsets(ncov)
    gid_pre, rank = gather_slots(offsets_ext, p)
    # Row N of every packed table is zero except the presort's id column.
    zero_row = body.new_zeros((1, NUM_FEATURES))
    if use_presort:
        # 10 features, the i32 bits of the geometry, the mask words and
        # the original id, and two zero columns (kernel F moves 16).
        ints = torch.stack([_f32_bits(torch.cat([x, x.new_full((1,), v)]))
                            for x, v in ((geom, 0), (mlo, 0), (mhi, 0),
                                         (perm, n))], dim=-1)
        packed = torch.cat([torch.cat([body, zero_row]), ints,
                            body.new_zeros((n + 1, 2))], dim=-1)
        feats, tile_s, _, gid_s = _pair_table(
            lambda pk: _presorted_sort(pk, gid_pre, rank, ntx_key), packed)
    elif fused:
        feats, tile_s, gid_s = _pair_table(
            lambda pk: _gather_sort(pk, gid_pre, rank, depth_keep_bits,
                                    ntx_key),
            _pack_fused(body, fp))
    else:
        # The exact path decodes each pair's tile before the gather; pads
        # sort after every real and phantom tile id.
        tx, ty = _pair_tile_decode(*(torch.cat([x, x.new_zeros(1)])[gid_pre]
                                     for x in (geom, mlo, mhi)), rank)
        tile = torch.where(gid_pre >= n, 1 << 30,
                           (ty * ntx_key + tx).to(I32))
        packed = torch.cat([torch.cat([body, zero_row]), body.new_zeros(
            (n + 1, TABLE_ROWS - NUM_FEATURES))], dim=-1)
        feats, tile_s, gid_s = _pair_table(
            lambda pk: _exact_sort(pk, tile, gid_pre), packed)
    return feats, tile_s, gid_s, offsets_ext[n]


def bin_splats(splats: ProjectedSplats, cfg: RasterConfig,
               row_lo: int | None = None, num_rows: int | None = None,
               pair_capacity: int | None = None) -> BinnedSplats:
    """Bin splats into per-tile depth-sorted ranges. Runs on the device of
    `splats` without host synchronisation.

    With row_lo / num_rows (Python ints), bins only tile rows [row_lo,
    row_lo + num_rows), rows past the grid binning nothing, and reports the
    ranges of those num_rows * tiles_x tiles (a distributed strip; module
    docstring). pair_capacity overrides cfg.pair_capacity."""
    check_supported(cfg)
    n = splats.xy.shape[0]
    p = pair_capacity or cfg.pair_capacity
    if p % cfg.chunk_size:
        raise ValueError(f"pair_capacity {p} is not a multiple of "
                         f"chunk_size {cfg.chunk_size}")
    if row_lo is None:
        row_lo, num_rows = 0, cfg.tiles_y
    if num_rows is None or row_lo < 0 or num_rows <= 0:
        raise ValueError(f"row strip row_lo={row_lo}, num_rows={num_rows}")
    g = cfg.tile_group
    ntx = cfg.tiles_x
    ntx_key = -(-ntx // g)
    num_keys_total = ntx_key * -(-cfg.tiles_y // g)
    tb = tile_bits(cfg)
    dkb = 31 - tb

    # The global key of each reported tile; with tile groups every member
    # tile points at its group's range.
    local = torch.arange(num_rows * ntx, dtype=I32, device=splats.xy.device)
    rows = row_lo + local // ntx
    tids = (rows // g) * ntx_key + (local % ntx) // g
    # Phantom tiles search the first key past the grid: an empty range.
    queries = torch.clamp_max(tids, num_keys_total)

    fp = footprints(splats, cfg, row_lo,
                    min(row_lo + num_rows, cfg.tiles_y))
    body = _body(splats)
    # Path selection as the reference's (binning.py:901-902, :937-944).
    use_presort = cfg.presort_depth and cfg.fused_sort_key and tb <= 31 \
        and n > 0
    fused = cfg.fused_sort_key and dkb >= 16
    use_stream = fused and not use_presort and cfg.expand_kernel and n > 0
    nrows_g = strip_group_rows(cfg, row_lo, num_rows)[1]
    if use_stream and 1 < cfg.rowseg_buckets <= nrows_g:
        feats, tile_s, gid_s, starts, ends, num_pairs, overflow = \
            _bin_rowseg(fp, body, cfg, tids, queries, ntx_key, dkb, row_lo,
                        num_rows, p)
    else:
        if use_stream:
            offsets_ext = _offsets(fp.ncov)
            total = offsets_ext[n]
            feats, tile_s, gid_s = _pair_table(
                lambda pk: _expand_sort(pk, offsets_ext, p, dkb, ntx_key),
                _pack_fused(body, fp))
        else:
            feats, tile_s, gid_s, total = _bin_gather(
                fp, body, splats, p, use_presort, fused, dkb, ntx_key)
        starts = torch.searchsorted(tile_s, queries, out_int32=True)
        ends = torch.searchsorted(tile_s, queries, right=True,
                                  out_int32=True)
        num_pairs = torch.clamp_max(total, p)
        overflow = torch.clamp_min(total - p, 0)
    pad_s = tile_s >= num_keys_total
    return BinnedSplats(
        features=feats,
        pair_gid=torch.where(pad_s, n, gid_s).to(I32),
        tile_starts=starts,
        tile_ends=ends,
        num_pairs=num_pairs,
        overflow=overflow,
    )
