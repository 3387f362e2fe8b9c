"""Distributed rendering and training over a shard mesh (torch port of
gaussian_splat_ipu_tpu/parallel/distributed.py).

The design is the reference's, one mesh axis in two roles:

  1. Projection is data-parallel over gaussians: shard j projects its
     contiguous N / D slice of the sharded model (parallel/mesh.py).
  2. The exchange is a per-destination all_to_all of compact projected
     splats (12 f32 each: position, depth, conic, colour, opacity, radius):
     each shard routes every splat it projected only to the shards whose
     framebuffer row strips the splat's footprint touches, at most `cap`
     rows per destination bucket, and counts the rows a bucket could not
     take (`exchange_overflow`). The received rows are in global gaussian
     order, so the stable pair sort gives every tile the single-device
     pair order and the frame equals the single-device one. The autograd
     transpose of the routing gather and the all_to_all is the inverse
     all_to_all and an index-add, so splat gradients land on the owning
     shard. `exchange="all_gather"` replicates every splat instead.
  3. Rasterization is spatially parallel over tile rows: shard j bins only
     its own strip (render/binning.py row_lo / num_rows) and composites it
     with kernel C at the strip's tile offset (kernel D under grad).

The shard body is written once over the mesh's shard group and calls only
its collectives (mesh.ShardGroup: all_to_all, all_gather, psum, gather).
The group's type decides how the buckets are sized:

  - On a mesh held by one process (mesh.ShardGroup) the collectives are
    index, reshape and cat operations on one stream, and every bucket is
    `cap` rows long, pads included: nothing here reads a value back to the
    host (the bucket bounds come from a device searchsorted), so the whole
    sharded frame, or train step, can be captured as one CUDA graph
    (runtime/engine.py), as the single-device ones are.
  - On a process mesh (multihost.ProcessShardGroup) each bucket holds
    exactly its rows. The ranks exchange their per-destination demands (D
    counts each) and read the (D, D) matrix back to the host once a
    forward, inside the "exchange" span; the all_to_all then sends parts of
    those sizes and its backward returns the same sizes without a second
    read. A process mesh's programs run eagerly (collectives across
    processes are not captured), so the read costs a drain of the stream,
    not a capture; the strips then bin only rows that carry a splat.

Training (make_sharded_train_step, make_view_batch_train_step,
make_sharded_densify_train_step) differentiates these renders. On a mesh
held by one process the sharded parameters are one tensor per field (their
D slices side by side), so the optimizer, the density event and the
opacity reset run on the whole slot buffer as the reference's global
surgery does (its :565-567), and `grow_capacity_sharded` pads each
shard's slice with dead slots (:485-549).

Spans and counters (utils/profiling.py; recorded only while spans are
recorded), on the model's device: "shard.project" (projection of each
local shard), "exchange" (packing, routing, the demand read on a
process mesh, and the all_to_all or all_gather), "strip.bin",
"strip.raster" (kernel C at the strip's tile offset), "gather" (the strip
images gathered into the frame); under grad
the backward's "gather.bwd", "strip.raster.bwd" (kernel D) and
"exchange.bwd" (the inverse all_to_all and the routing gather's
transpose); on a mesh held by one process the shards' "exchange.bwd"
spans nest, each in the one begun before it. Counters: "exchange.rows_sent" (send
rows that carry a splat), "exchange.bucket_rows" (send rows in all, pads
too: equal to rows_sent on a process mesh), "exchange.recv_rows" (rows
each strip receives and bins), "strip.pairs" (pairs each strip keeps).

One deliberate difference: `truncated` counts the pairs past the per-range
work bound max_chunks_per_range * chunk_size once per tile group, as the
single-device render counts them (render/pipeline.py); the reference's
sharded programs count every member tile against the per-tile bound
(:302-304), which overcounts grouped strips.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.parallel.mesh import (SHARD_AXIS,
                                                       VIEW_AXIS, Mesh,
                                                       ShardGroup)
from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
from gaussian_splat_ipu_tpu_torch.render.kernels import rasterize
from gaussian_splat_ipu_tpu_torch.render.projection import (ProjectedSplats,
                                                            project_gaussians)
from gaussian_splat_ipu_tpu_torch.train import densify as densify_lib
from gaussian_splat_ipu_tpu_torch.train import trainer
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

I32 = torch.int32
EXCHANGES = ("all_to_all", "all_gather")


class ShardedRenderOutput(NamedTuple):
    image: torch.Tensor        # (H, W, 4) f32
    tile_counts: torch.Tensor  # (rows * D * tiles_x,) i32, phantom rows too
    overflow: torch.Tensor     # () i32 pairs dropped, summed over shards
    num_pairs: torch.Tensor    # () i32 pairs kept, summed over shards
    visible: torch.Tensor      # (N,) bool frustum mask of the model's
    #                            rows, shard order (this process's slice
    #                            on a process mesh)
    truncated: torch.Tensor    # () i32 pairs past the per-range work bound
    exchange_overflow: torch.Tensor  # () i32 splat rows dropped at the
    #                                  all_to_all buckets (0 for all_gather)


# -- packed projected-splat wire format ------------------------------------

def _splat_columns(sp: ProjectedSplats) -> List[torch.Tensor]:
    """The wire rows' columns, (n, k) each, 12 in all. The radius rides
    detached: binning reads it only as integer footprints, so it has no
    gradient on the single-device path either, and a zero cotangent sent
    back through its torch.where would turn the infinite extents of culled
    slots into NaN gradients (the reference's sharded step writes NaN into
    dead slots so)."""
    return [sp.xy, sp.depth[:, None], sp.conic, sp.color,
            sp.opacity[:, None], sp.radius.detach()]


def _pack_splats(sp: ProjectedSplats) -> torch.Tensor:
    """(n, 12) wire rows."""
    return torch.cat(_splat_columns(sp), dim=-1)


def _unpack_splats(f: torch.Tensor) -> ProjectedSplats:
    return ProjectedSplats(xy=f[:, 0:2], depth=f[:, 2], conic=f[:, 3:6],
                           color=f[:, 6:9], opacity=f[:, 9],
                           radius=f[:, 10:12])


def _rows_per_device(cfg: RasterConfig, num_devices: int) -> int:
    """Tile rows per shard, rounded up to a multiple of tile_group so every
    strip covers whole group rows; the last shard's rows past the grid are
    phantom (bin_splats bins nothing there)."""
    rows = -(-cfg.tiles_y // num_devices)
    g = cfg.tile_group
    return -(-rows // g) * g


def _dest_strip_span(sp: ProjectedSplats, cfg: RasterConfig, rows: int):
    """The destination shards [dest_lo, dest_lo + span) of each splat: the
    strips its tile footprint's rows fall in; span 0 for culled splats."""
    _, y0, nx, ny = binning.tile_ranges_of(sp, cfg)
    dest_lo = y0 // rows
    dest_hi = (y0 + torch.clamp_min(ny, 1) - 1) // rows
    span = torch.where((nx > 0) & (ny > 0), dest_hi - dest_lo + 1, 0)
    return dest_lo.to(I32), span.to(I32)


class _RouteGather(torch.autograd.Function):
    """send = packed_ext[idx], packed_ext the splat rows with a zero row
    appended; differentiable in `packed`. The transpose sums, for each
    splat, the cotangents of its (at most d) send rows: pos maps each
    (splat, destination) pair, in splat order, to its send row (or to a
    zero row when it was dropped), so the backward is d gathers and adds,
    with no atomics and no scatter onto the pad row that most send rows
    point at."""

    @staticmethod
    def forward(ctx, packed, idx, pos, offsets, span, d):
        ctx.save_for_backward(pos, offsets, span)
        ctx.d = d
        return torch.cat([packed, packed.new_zeros((1, packed.shape[1]))]
                         )[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, dsend):
        pos, offsets, span = ctx.saved_tensors
        p = pos.shape[0]
        zero = dsend.new_zeros((1, dsend.shape[1]))
        dpair = torch.cat([torch.cat([dsend, zero])[pos], zero])
        dpacked = dsend.new_zeros((offsets.shape[0], dsend.shape[1]))
        for k in range(ctx.d):
            slot = offsets + k
            ok = (k < span) & (slot < p)
            dpacked = dpacked + torch.where(ok[:, None],
                                            dpair[slot.clamp_max(p)], 0.0)
        return dpacked, None, None, None, None, None


class _DemandGather(torch.autograd.Function):
    """send = cat(cols, 1)[idx], the rows of the live (splat, destination)
    pairs only (buckets sized by the demand); differentiable in the
    columns. The transpose is _RouteGather's sum, in the same order, over
    pairs instead of splats: src[r] is send row r's pair slot, so the
    cotangents are copied into pair order (a dropped pair's stays zero);
    a splat's pairs are consecutive there, count[s] of them from slot s on,
    so its sum is d shifted adds at its first pair, whose row target[s]
    names (the other pairs' target is a row dropped after). No row
    gathers: on the H100 a gather of 48-byte rows is 20x one of 8- or
    12-byte columns."""

    @staticmethod
    def forward(ctx, idx, src, count, target, d, *cols):
        ctx.save_for_backward(src, count, target)
        ctx.d, ctx.rows = d, cols[0].shape[0]
        ctx.widths = [c.shape[1] for c in cols]
        return torch.cat([c[idx] for c in cols], dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dsend):
        src, count, target = ctx.saved_tensors
        total, nfeat = count.shape[0], dsend.shape[1]
        dpair = dsend.new_zeros((total + ctx.d, nfeat)).index_copy_(
            0, src, dsend)
        acc = dsend.new_zeros((total, nfeat))
        for k in range(ctx.d):
            acc = acc + torch.where((k < count)[:, None],
                                    dpair[k:k + total], 0.0)
        dcols = acc.new_zeros((ctx.rows + 1, nfeat)).index_put_(
            (target,), acc)[:ctx.rows]
        return (None,) * 5 + tuple(dcols.split(ctx.widths, dim=1))


def _pair_slots(span: torch.Tensor, total):
    """The (splat, destination) pairs of one shard in gaussian order,
    destinations ascending within a splat: (offsets (nloc,) i64 each
    splat's first pair, slot (total,) i64, gid (total,) i64 each pair's
    splat, its offset into the splat's span). Slot s belongs to the
    rightmost splat whose first slot is at or before it (splats of span 0
    share their successor's offset), found by a binary search, as kernel B
    finds a pair's gaussian. The reference forward-fills a scatter with
    cummax instead; torch.cummax takes 2.5 ms a 2^20-slot pass on the
    H100. `span` may end in a sentinel whose offset every slot past the
    live pairs finds."""
    ends_cum = torch.cumsum(span.to(torch.int64), 0)
    offsets = ends_cum - span
    slot = torch.arange(total, device=span.device)
    gid = torch.searchsorted(offsets, slot, right=True) - 1
    return offsets, slot, gid, slot - offsets[gid]


def _route_all_to_all(packed: torch.Tensor, dest_lo: torch.Tensor,
                      span: torch.Tensor, d: int, cap: int):
    """Bucket one shard's splat rows by destination into fixed buckets:
    (send (d * cap, F), send_overflow () i32). Bucket j holds, in gaussian
    order, the rows bound for shard j, up to cap of them, then zero pad
    rows; rows past a bucket's cap (or past the d * cap expansion table)
    are dropped and counted. The row gather is differentiable in `packed`
    (_RouteGather); the routing is integer-only and reads nothing back to
    the host. The scatter writes distinct slots (dropped entries go to
    slots past the table, one each): on the card, entries that all hit one
    slot serialise."""
    nloc, nfeat = packed.shape
    dev = packed.device
    p = d * cap
    span_ext = torch.cat([span, span.new_full((1,), p)])
    offsets_ext, slot, gid, within = _pair_slots(span_ext, p)
    total = offsets_ext[-1]
    is_pad = gid >= nloc
    dest_ext = torch.cat([dest_lo, dest_lo.new_full((1,), d)])
    dest = torch.where(is_pad, d, dest_ext[gid] + within)

    # A stable sort by destination keeps gaussian order within a bucket;
    # a pair's rank in its bucket counts from the bucket's first pair.
    dest_s, perm = torch.sort(dest.to(I32), stable=True)
    gid_s = gid[perm].to(I32)
    bounds = torch.searchsorted(
        dest_s, torch.arange(d + 1, dtype=I32, device=dev), out_int32=True)
    lrank = slot - bounds.to(torch.int64)[dest_s.to(torch.int64)]
    keep = (dest_s < d) & (lrank < cap)
    kept_slot = dest_s.to(torch.int64) * cap + lrank
    idx = torch.full((2 * p,), nloc, dtype=I32, device=dev).scatter_(
        0, torch.where(keep, kept_slot, p + slot), gid_s)[:p].to(torch.int64)
    if torch.is_grad_enabled() and packed.requires_grad:
        pos = torch.empty(p, dtype=torch.int64, device=dev).scatter_(
            0, perm, torch.where(keep, kept_slot, p))
        send = _RouteGather.apply(packed, idx, pos, offsets_ext[:nloc],
                                  span, d)
    else:
        send = torch.cat([packed, packed.new_zeros((1, nfeat))])[idx]

    if profiling.active is not None:
        profiling.count("exchange.rows_sent", keep.sum())
        profiling.count("exchange.bucket_rows", p)
    demand = bounds[1:] - bounds[:-1]
    send_overflow = (torch.clamp_min(total - p, 0).to(I32)
                     + torch.clamp_min(demand - cap, 0).sum(dtype=I32))
    return send, send_overflow


def _bucket_demand(dest_lo: torch.Tensor, span: torch.Tensor,
                   d: int) -> torch.Tensor:
    """(d,) i64: the rows one shard would send each destination shard, on
    the device (a splat counts once in each strip its footprint touches)."""
    j = torch.arange(d, dtype=dest_lo.dtype, device=dest_lo.device)
    hit = (dest_lo[:, None] <= j) & (j < (dest_lo + span)[:, None])
    return hit.sum(0, dtype=torch.int64)


def _route_by_demand(cols: Sequence[torch.Tensor], dest_lo: torch.Tensor,
                     span: torch.Tensor, demand: torch.Tensor,
                     demand_host: Sequence[int], cap: int) -> torch.Tensor:
    """Bucket one shard's splat rows (the columns `cols`, _splat_columns)
    by destination, each bucket exactly as long as the rows it keeps: send
    (sum(min(demand_j, cap)), F). Bucket j holds, in gaussian order, the
    first min(demand_j, cap) rows bound for shard j; the rest are dropped
    (the caller counts them). demand: the shard's _bucket_demand on the
    device; demand_host: the same counts on the host, which size the
    table: it holds the live pairs only, and only their rows are packed.
    The row gather is differentiable in the columns (_DemandGather)."""
    d = len(demand_host)
    total = sum(demand_host)
    p = sum(min(m, cap) for m in demand_host)
    _, slot, gid, within = _pair_slots(span, total)
    dest_s, perm = torch.sort((dest_lo[gid] + within).to(I32), stable=True)
    dest_s = dest_s.to(torch.int64)
    # A pair's rank in its bucket counts from the bucket's first pair; the
    # kept ones go to the bucket's start in the send buffer.
    first = torch.cumsum(demand, 0) - demand
    sizes = torch.clamp_max(demand, cap)
    start = torch.cumsum(sizes, 0) - sizes
    lrank = slot - first[dest_s]
    row = torch.where(lrank < cap, start[dest_s] + lrank, p + slot)
    # Send row r holds pair src[r]; the dropped pairs' rows lie past p.
    src = torch.empty(p + total, dtype=torch.int64, device=span.device
                      ).scatter_(0, row, perm)[:p]
    idx = gid[src]
    if not (torch.is_grad_enabled()
            and any(c.requires_grad for c in cols)):
        return torch.cat([c[idx] for c in cols], dim=1)
    # The transpose runs over the pairs, not the shard's splats: a splat's
    # first pair gathers its cotangents.
    target = torch.where(within == 0, gid, span.shape[0])
    return _DemandGather.apply(idx, src, span[gid] - within, target, d,
                               *cols)


def _exchange_by_demand(group, sp: ProjectedSplats, cfg: RasterConfig,
                        rows: int, cap: int):
    """The all_to_all exchange of a process mesh (one shard a process,
    multihost.ProcessShardGroup), each bucket exactly as long as the rows
    it keeps: (the rows this process's strip receives, in source-shard
    order and gaussian order within a source; its send overflow () i32).
    The ranks' demands are read back to the host here, once a forward."""
    d, me = group.size, group.rank
    dest_lo, span = _dest_strip_span(sp, cfg, rows)
    demand = _bucket_demand(dest_lo, span, d)
    matrix = group.demand_matrix(demand)
    cols = _splat_columns(sp)
    # The columns' gradients all arrive in one backward call.
    cols[0] = profiling.backward_ends(cols[0], "exchange.bwd")
    send = _route_by_demand(cols, dest_lo, span, demand, matrix[me], cap)
    if profiling.active is not None:
        profiling.count("exchange.rows_sent", send.shape[0])
        profiling.count("exchange.bucket_rows", send.shape[0])
    (recv,) = group.all_to_all([send], [min(m, cap) for m in matrix[me]],
                               [min(row[me], cap) for row in matrix])
    return recv, torch.clamp_min(demand - cap, 0).sum(dtype=I32)


def _exchange_capacity(nloc: int, d: int,
                       requested: int | None = None) -> int:
    """Rows per destination bucket: an even nloc / d share with 4x slack,
    never more than nloc (then no routing can overflow a bucket), 128-row
    aligned."""
    if requested is not None:
        cap = requested
    else:
        cap = max(min(4 * nloc // max(d, 1), nloc), 128)
    return -(-cap // 128) * 128


def default_pair_budget(cfg: RasterConfig, d: int) -> int:
    """Each shard's pair-table size when the caller passes none: an even
    share of cfg.pair_capacity with 2x slack, chunk-aligned. The train
    CLI's densify pair-demand guard compares against the same budget."""
    per = max(2 * cfg.pair_capacity // d, 4 * cfg.chunk_size)
    return -(-per // cfg.chunk_size) * cfg.chunk_size


def _untile_rows(tiles: torch.Tensor, cfg: RasterConfig,
                 rows_total: int) -> torch.Tensor:
    """(rows_total * tiles_x, NPIX, 4) -> (H, W, 4), phantom rows cropped."""
    c = tiles.shape[-1]
    x = tiles.reshape(rows_total, cfg.tiles_x, cfg.tile_height,
                      cfg.tile_width, c)
    x = x.permute(0, 2, 1, 3, 4).reshape(rows_total * cfg.tile_height,
                                         cfg.padded_width, c)
    return x[:cfg.image_height, :cfg.image_width]


class _ShardModel(NamedTuple):
    """One shard's slice of the model's fields, as projection reads them."""

    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1


def _render_group(group: ShardGroup, model: GaussianModel, camera: Camera,
                  cfg: RasterConfig, pair_capacity: int, exchange: str,
                  cap: int, xy_probe: torch.Tensor | None):
    """The shard body over one shard group: per shard (projected splats,
    strip tiles, strip binned); then the group's psums. Returns (tiles
    (rows * D * tiles_x, NPIX, 4), counts, overflow, num_pairs, visible,
    truncated, exchange_overflow), gathered on the model's device."""
    d = group.size
    rows = _rows_per_device(cfg, d)
    fields = [group.shard_slices(getattr(model, k)) for k in FIELDS]
    probes = (group.shard_slices(xy_probe) if xy_probe is not None
              else [None] * len(group.local))
    cams = {}
    out = model.device
    splats, xovf = [], []
    for i, j in enumerate(group.local):
        dev = group.devices[j]
        if dev not in cams:
            cams[dev] = camera.to(dev)
        with profiling.span("shard.project", out):
            splats.append(project_gaussians(
                _ShardModel(*(f[i] for f in fields)), cams[dev], cfg,
                xy_probe=probes[i]))
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange {exchange!r}: expected one of "
                         f"{EXCHANGES}")
    with profiling.span("exchange", out):
        if exchange == "all_gather":
            packed = [profiling.backward_ends(_pack_splats(sp),
                                              "exchange.bwd")
                      for sp in splats]
            routed = group.all_gather(packed)
            xovf = [torch.zeros((), dtype=I32, device=pk.device)
                    for pk in packed]
        elif isinstance(group, ShardGroup):
            sends = []
            for sp in splats:
                pk = profiling.backward_ends(_pack_splats(sp), "exchange.bwd")
                dest_lo, span = _dest_strip_span(sp, cfg, rows)
                send, ovf = _route_all_to_all(pk, dest_lo, span, d, cap)
                sends.append(send)
                xovf.append(ovf)
            routed = group.all_to_all(sends)
        else:
            (sp,) = splats
            recv, ovf = _exchange_by_demand(group, sp, cfg, rows, cap)
            routed, xovf = [recv], [ovf]
        routed = [profiling.backward_begins(r, "exchange.bwd")
                  for r in routed]
    tiles, counts, ovf, npairs, trunc = [], [], [], [], []
    for j, recv in zip(group.local, routed):
        row_lo = j * rows
        profiling.count("exchange.recv_rows", recv.shape[0])
        with profiling.span("strip.bin", out):
            binned = binning.bin_splats(_unpack_splats(recv), cfg, row_lo,
                                        rows, pair_capacity)
        binned = binned._replace(features=profiling.backward_ends(
            binned.features, "strip.raster.bwd"))
        with profiling.span("strip.raster", out):
            strip = rasterize.rasterize_tiles(binned, cfg,
                                              row_lo * cfg.tiles_x)
        strip = profiling.backward_begins(strip, "strip.raster.bwd")
        tiles.append(profiling.backward_ends(strip, "gather.bwd"))
        profiling.count("strip.pairs", binned.num_pairs)
        cnt = binned.tile_ends - binned.tile_starts
        counts.append(cnt)
        ovf.append(binned.overflow)
        npairs.append(binned.num_pairs)
        trunc.append(pipeline.truncated_pairs(cnt, cfg, row_lo))
    # The frustum mask of the rows this process holds (all of them on a
    # one-process mesh): the rows its densify statistics accumulate over.
    visible = torch.cat([(sp.radius[:, 0] > 0.0).to(out) for sp in splats])
    with profiling.span("gather", out):
        frame = profiling.backward_begins(group.gather(tiles, out),
                                          "gather.bwd")
    return (frame, group.gather(counts, out),
            group.psum(ovf).to(out), group.psum(npairs).to(out), visible,
            group.psum(trunc).to(out), group.psum(xovf).to(out))


def _capacities(model, group, cfg: RasterConfig, pair_capacity,
                exchange_capacity):
    """(each shard's pair capacity, its exchange bucket rows)."""
    d = group.size
    if pair_capacity is None:
        pair_capacity = default_pair_budget(cfg, d)
    pair_capacity = -(-pair_capacity // cfg.chunk_size) * cfg.chunk_size
    cap = _exchange_capacity(group.local_rows(model.num_gaussians), d,
                             exchange_capacity)
    return pair_capacity, cap


def render_sharded(model: GaussianModel, camera: Camera, cfg: RasterConfig,
                   mesh: Mesh, axis: str = SHARD_AXIS,
                   pair_capacity: int | None = None,
                   xy_probe: torch.Tensor | None = None,
                   exchange: str = "all_to_all",
                   exchange_capacity: int | None = None
                   ) -> ShardedRenderOutput:
    """Render one frame across the mesh's shard axis. Differentiable in the
    model's parameters (and in xy_probe).

    model: sharded (parallel.mesh.shard_model: N a multiple of the axis
    size; on a process mesh, parallel/multihost.py, this process's
    slice). pair_capacity: each shard's pair table (default
    default_pair_budget). xy_probe: optional (N, 2) zeros sharded like the
    model, the screen-space gradient probe of density control; its
    gradient stays with the owning shard. exchange: "all_to_all" (the
    default; exchange_capacity rows per destination bucket, default
    _exchange_capacity) or "all_gather"."""
    group = mesh.group(0, axis)
    pair_capacity, cap = _capacities(model, group, cfg, pair_capacity,
                                     exchange_capacity)
    rows = _rows_per_device(cfg, group.size)
    (tiles, counts, overflow, num_pairs, visible, truncated,
     xovf) = _render_group(group, model, camera, cfg, pair_capacity,
                           exchange, cap, xy_probe)
    return ShardedRenderOutput(
        image=_untile_rows(tiles, cfg, rows * group.size),
        tile_counts=counts,
        overflow=overflow, num_pairs=num_pairs, visible=visible,
        truncated=truncated, exchange_overflow=xovf)


def render_image_sharded(model: GaussianModel, camera: Camera,
                         cfg: RasterConfig, mesh: Mesh,
                         axis: str = SHARD_AXIS,
                         pair_capacity: int | None = None,
                         exchange: str = "all_to_all",
                         exchange_capacity: int | None = None
                         ) -> torch.Tensor:
    return render_sharded(model, camera, cfg, mesh, axis, pair_capacity,
                          exchange=exchange,
                          exchange_capacity=exchange_capacity).image


def render_views_sharded(model: GaussianModel, cameras: Sequence[Camera],
                         cfg: RasterConfig, mesh: Mesh,
                         view_axis: str = VIEW_AXIS,
                         shard_axis: str = SHARD_AXIS,
                         pair_capacity: int | None = None,
                         exchange: str = "all_to_all",
                         exchange_capacity: int | None = None,
                         with_stats: bool = False):
    """Render a batch of V views over a 2-D (view, shard) mesh: view group
    v renders views [v * V / G, (v + 1) * V / G) one after another, each
    with render_sharded's shard body over its own shards. Returns (V, H,
    W, 4), or (images, stats) with with_stats, stats the drop counters
    summed over views and shards: {"exchange_overflow", "overflow",
    "truncated"}. Differentiable: the groups share the parameters, so their
    gradients sum."""
    groups = mesh.shape[view_axis]
    v = len(cameras)
    if v % groups:
        raise ValueError(f"{v} views do not split over {groups} view groups")
    d = mesh.shape[shard_axis]
    pair_capacity, cap = _capacities(model, mesh.group(0, shard_axis), cfg,
                                     pair_capacity, exchange_capacity)
    rows = _rows_per_device(cfg, d)
    images: List[torch.Tensor] = []
    stats = torch.zeros(3, dtype=I32, device=model.device)
    for k, cam in enumerate(cameras):
        group = mesh.group(k // (v // groups), shard_axis)
        tiles, _, overflow, _, _, truncated, xovf = _render_group(
            group, model, cam, cfg, pair_capacity, exchange, cap, None)
        images.append(_untile_rows(tiles, cfg, rows * d))
        stats = stats + torch.stack([xovf, overflow, truncated])
    images = torch.stack(images)
    if not with_stats:
        return images
    return images, {"exchange_overflow": stats[0], "overflow": stats[1],
                    "truncated": stats[2]}


# -- training --------------------------------------------------------------

def make_sharded_train_step(mesh: Mesh, raster_cfg: RasterConfig,
                            train_cfg: trainer.TrainConfig,
                            axis: str = SHARD_AXIS,
                            pair_capacity: int | None = None,
                            with_stats: bool = False):
    """step(state, camera, target) -> (state, loss): trainer.train_step
    with the sharded render, updating the state in place. The gradients of
    the exchange land on the owning shards' parameter slices. with_stats:
    (state, (loss, stats)), stats the frame's (3,) i32 drop counters
    summed over the shards (exchange_overflow, overflow, truncated), as
    make_view_batch_train_step's: dropped rows corrupt gradients, so the
    caller checks them."""
    if not with_stats:
        return functools.partial(
            trainer.train_step, raster_cfg=raster_cfg, train_cfg=train_cfg,
            image_fn=functools.partial(render_image_sharded, mesh=mesh,
                                       axis=axis,
                                       pair_capacity=pair_capacity))

    def step(state: trainer.TrainState, camera: Camera,
             target: torch.Tensor):
        stats = []

        def image_fn(params, cam, cfg):
            out = render_sharded(params, cam, cfg, mesh, axis,
                                 pair_capacity)
            stats.append(torch.stack([out.exchange_overflow, out.overflow,
                                      out.truncated]))
            return out.image

        state, loss = trainer.train_step(state, camera, target, raster_cfg,
                                         train_cfg, image_fn=image_fn)
        return state, (loss, stats[0])

    return step


def make_view_batch_train_step(mesh: Mesh, raster_cfg: RasterConfig,
                               train_cfg: trainer.TrainConfig,
                               view_axis: str = VIEW_AXIS,
                               shard_axis: str = SHARD_AXIS,
                               pair_capacity: int | None = None):
    """step(state, cameras, targets) -> (loss, stats (3,) i32): one update
    from a batch of V views on a (view, shard) mesh, the loss the mean of
    the per-view losses, the parameter gradients summed over the view
    groups by autograd (each group's render reads the same parameters);
    stats the summed drop counters (exchange_overflow, overflow,
    truncated): dropped rows corrupt gradients, so the caller checks
    them. Updates the state in place."""
    def step(state: trainer.TrainState, cameras: Sequence[Camera],
             targets: torch.Tensor):
        with profiling.span("render", state.params.device):
            images, stats = render_views_sharded(
                state.params, cameras, raster_cfg, mesh, view_axis,
                shard_axis, pair_capacity, with_stats=True)
        loss = trainer.image_loss(images, targets, train_cfg)
        trainer.gradient_step(state, loss, train_cfg)
        return loss.detach(), torch.stack([stats["exchange_overflow"],
                                           stats["overflow"],
                                           stats["truncated"]])

    return step


def make_sharded_densify_train_step(mesh: Mesh, raster_cfg: RasterConfig,
                                    train_cfg: trainer.TrainConfig,
                                    axis: str = SHARD_AXIS,
                                    pair_capacity: int | None = None):
    """densify.make_train_step on the sharded render: step(state,
    grad_sum, vis_count, camera, target) -> loss. The probe is sharded
    like the model, so its gradient, the NDC norm scaled by half the image
    size, accumulates on the owning shard's slots."""
    return densify_lib.make_train_step(raster_cfg, train_cfg, render_fn=(
        functools.partial(render_sharded, mesh=mesh, axis=axis,
                          pair_capacity=pair_capacity)))


def grow_capacity_sharded(mesh: Mesh, state: trainer.TrainState,
                          dstate: densify_lib.DensifyState,
                          new_capacity: int, axis: str = SHARD_AXIS):
    """Slot-buffer growth of sharded training state: each shard's slice of
    every slot-indexed tensor (parameters, Adam moments, statistics) gains
    (new - old) / D dead slots at its end, so the buffer keeps its even
    per-shard layout (growth at the global end would land every new slot
    on the last shard). New slots are culled and unallocated (opacity and
    log-scales -30, identity quaternions, alive False); the density event
    allocates by the alive mask, so interleaved dead runs serve as a
    contiguous tail would. new_capacity counts the whole buffer; on a
    process mesh (parallel/multihost.py) this process grows its own
    shard's slice, the one it holds. The result holds new tensors:
    register the programs again."""
    group = mesh.group(0, axis)
    d, held = group.size, len(group.local)
    rows = dstate.alive.shape[0]          # the rows this process holds
    old = rows // held * d
    if new_capacity == old:
        return state, dstate
    if new_capacity < old or new_capacity % d or rows % held:
        raise ValueError(f"capacity {old} -> {new_capacity} must grow in "
                         f"multiples of the mesh size {d}")
    pad_per = (new_capacity - old) // d
    new_rows = rows + held * pad_per

    def grow(x, fill=0.0):
        shards = x.detach().reshape(held, rows // held, *x.shape[1:])
        if fill is None:       # identity quaternions
            pad = shards.new_zeros((held, pad_per, 4))
            pad[..., 0] = 1.0
        else:
            pad = shards.new_full((held, pad_per) + tuple(x.shape[1:]),
                                  fill)
        return torch.cat([shards, pad], 1).reshape(new_rows, *x.shape[1:])

    p = state.params
    params = GaussianModel(grow(p.means), grow(p.log_scales, -30.0),
                           grow(p.quats, None), grow(p.opacities, -30.0),
                           grow(p.sh), requires_grad=True)
    opt = trainer.OptState(
        {label: trainer.AdamState(st.count, grow(st.mu), grow(st.nu))
         for label, st in state.opt_state.adam.items()},
        state.opt_state.means_lr_count)
    return (trainer.TrainState(params, opt, state.step),
            densify_lib.DensifyState(grow(dstate.grad_sum),
                                     grow(dstate.vis_count),
                                     grow(dstate.alive, False), dstate.key))
