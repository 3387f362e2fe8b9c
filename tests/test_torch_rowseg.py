"""Row-bucket segmented binning of the port against the JAX package: the
scan and segmented-expansion plain versions against the reference's
interpret-mode kernels, the bucket geometry helpers, bin_splats bit for
bit, the span-fallback scene per tile, and the rowseg image and gradients
against the port's flat path.

The reference takes its segmented path on the CPU only with
FORCE_EXPAND_KERNEL set, and then aligns its buckets to the interpreter's
256-slot chunk (binning.py:495-496); the fixture sets both, the port's
SEG_ALIGN included."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.render import binning as jbin
from gaussian_splat_ipu_tpu.render.kernels import expand as jexp
from gaussian_splat_ipu_tpu.render.kernels import scan as jscan
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render import binning, pipeline
from gaussian_splat_ipu_tpu_torch.render.kernels import expand, scan
from tests.test_torch_config import jax_config
from tests.test_torch_binning import (CFG, assert_binned_equal, jax_splats,
                                      to_torch)
from tests.test_torch_train import cameras, params_np

torch.set_num_threads(1)

INTERP_CHUNK, INTERP_WIN = 256, 1024   # binning._stream_sizes(True, True)


@pytest.fixture(autouse=True)
def _segmented_reference(monkeypatch):
    monkeypatch.setattr(jbin, "FORCE_EXPAND_KERNEL", True)
    monkeypatch.setattr(binning, "SEG_ALIGN", INTERP_CHUNK)


def segmented(b) -> bool:
    """True when a table has the segmented layout: some tile range starts
    past the live pair count (a later bucket's segment)."""
    return int(np.asarray(b.tile_starts).max()) > int(b.num_pairs)


def tile_slices(b):
    feats, gid = np.asarray(b.features), np.asarray(b.pair_gid)
    return [(feats[:, s:e], gid[s:e])
            for s, e in zip(np.asarray(b.tile_starts),
                            np.asarray(b.tile_ends))]


def test_scan_plain_matches_pallas_interpret():
    """Exact: integer sums. N = 5000 crosses the reference's 2048-lane
    block carry twice and ends in a partial block."""
    x = np.random.default_rng(0).integers(0, 60, (3, 5000)).astype(np.int32)
    want = np.asarray(jscan.row_cumsum_exclusive(jnp.asarray(x),
                                                 interpret=True))
    got = scan.row_cumsum_exclusive(torch.tensor(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        scan.row_cumsum_exclusive_torch(torch.tensor(x)).numpy(), want)


def test_bucket_helpers_match_jax(monkeypatch):
    """_bucket_counts (equal and uneven bounds), bucket_demands and
    balance_bounds equal the reference's; exact, integer. (The reference's
    coverage masks on its CPU spec path: the Pallas kernel in interpret
    mode gives the same bits, tests/test_exact_tile.py:163, slower.)"""
    monkeypatch.setattr(jbin, "FORCE_EXPAND_KERNEL", False)
    cfg = dataclasses.replace(CFG, tile_group=1, exact_tile_test=True)
    js = jax_splats(0, 1500, cfg)
    ts = to_torch(js)
    fp = binning.footprints(ts, cfg)
    args = [fp.y0, fp.nx, fp.ny, fp.flag01, fp.mlo, fp.mhi]
    for bounds in ((0, 2, 4, 6), (0, 1, 4, 6), (0, 1, 2, 3, 4, 5, 6),
                   (0, 4, 8)):
        want = jbin._bucket_counts(*(jnp.asarray(a.numpy()) for a in args),
                                   jnp.int32(0), bounds)
        got = binning._bucket_counts(*args, 0, bounds)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.sum(0).numpy(), fp.ncov.numpy())
    for g in (1, 2):
        c = dataclasses.replace(cfg, tile_group=g)
        rd = binning.bucket_demands(to_torch(jax_splats(0, 1500, c)), c)
        np.testing.assert_array_equal(
            rd.numpy(), np.asarray(jbin.bucket_demands(
                jax_splats(0, 1500, c), jax_config(c))))
    # The demand list of tests/test_rowseg.py:93-101, and min_sum floors.
    d = [10, 200, 250, 240, 30, 5, 5, 260, 0, 0, 0, 0]
    for r in (2, 3, 4, 6, 12, 13):
        for min_sum in (0, 100, 300, 10_000):
            assert binning.balance_bounds(d, r, min_sum) == \
                jbin.balance_bounds(d, r, min_sum), (r, min_sum)
    assert binning.balance_bounds(rd.numpy(), 2) == \
        jbin.balance_bounds(np.asarray(rd), 2)


def test_segmented_expansion_plain_matches_pallas_interpret():
    """The plain segmented expansion against the reference's stream_expand
    with offs2 (interpret mode), driven as binning.py:1049-1076 drives it,
    on a capacity that truncates the first bucket. gid and rank are
    compared on every slot, the columns on live slots (the TPU kernel's
    pad columns are unspecified; bin_splats zeroes them after the sort)."""
    cfg = dataclasses.replace(CFG, tile_group=1, exact_tile_test=True,
                              rowseg_buckets=2, rowseg_bounds=(0, 4, 6),
                              pair_capacity=1024)
    ts = to_torch(jax_splats(3, 700, cfg))
    fp = binning.footprints(ts, cfg)
    packed = binning._pack_fused(binning._body(ts), fp)
    n = packed.shape[0] - 1
    lay = binning.rowseg_layout(fp, cfg)
    cap, totals = lay.cap, lay.counts.sum(1)
    assert int(totals[0]) > cap > int(totals[1])   # bucket 0 truncates
    cols, gid, rank = expand.stream_expand_seg_torch(
        packed, lay.offs, lay.offs2, lay.live_end, cap)

    tail = np.full((2, INTERP_WIN + 256), 0x7FFFFFFF, np.int32)
    end = lay.live_end.numpy()[:, None]
    offs_rows = jnp.asarray(np.concatenate([lay.offs.numpy(), end, tail],
                                           1))
    offs2_rows = jnp.asarray(np.concatenate([lay.offs2.numpy(), end, tail],
                                            1))
    los, rows, pads, span = jexp.window_starts_from_offsets_seg(
        offs_rows, cap, n, chunk=INTERP_CHUNK)
    assert int(span) <= INTERP_WIN
    jcols, jgid, jrank = jexp.stream_expand(
        jexp.pad_packed_cols(jnp.asarray(packed.numpy()), win=INTERP_WIN),
        offs_rows, los, rows, pads, jnp.full((1,), n, jnp.int32), 2 * cap,
        chunk=INTERP_CHUNK, win=INTERP_WIN, interpret=True,
        offs2_pad=offs2_rows)
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    live = gid.numpy() < n
    assert live.sum() == int(lay.kept.sum())
    np.testing.assert_array_equal(cols.numpy()[:, live],
                                  np.asarray(jcols)[:, live])
    np.testing.assert_array_equal(cols.numpy()[:, ~live], 0.0)


@pytest.mark.parametrize("tile_group,exact,r", [(1, False, 3), (1, True, 2),
                                                (3, True, 2)])
def test_rowseg_bin_splats_bit_identical(tile_group, exact, r):
    cfg = dataclasses.replace(CFG, tile_group=tile_group,
                              exact_tile_test=exact, rowseg_buckets=r)
    js = jax_splats(0, 1500, cfg)
    want = jbin.bin_splats(js, jax_config(cfg))
    got = binning.bin_splats(to_torch(js), cfg)
    assert segmented(want)                     # the reference's own branch
    assert_binned_equal(want, got)
    assert int(got.overflow) == 0


def test_rowseg_balanced_bounds_bit_identical():
    """Demand-balanced bounds from the port's own probe: the table equals
    the reference's with the same bounds, and each tile's slice equals the
    flat path's."""
    cfg = dataclasses.replace(CFG, exact_tile_test=True)
    js = jax_splats(1, 1500, cfg)
    ts = to_torch(js)
    rd = binning.bucket_demands(ts, cfg)
    bounds = binning.balance_bounds(rd.numpy(), 4)
    assert bounds != binning.rowseg_bounds(
        dataclasses.replace(cfg, rowseg_buckets=4), cfg.tiles_y)
    cfg_b = dataclasses.replace(cfg, rowseg_buckets=4, rowseg_bounds=bounds)
    want = jbin.bin_splats(js, jax_config(cfg_b))
    got = binning.bin_splats(ts, cfg_b)
    assert segmented(want)
    assert_binned_equal(want, got)
    flat = binning.bin_splats(ts, cfg)
    assert int(rd.sum()) == int(flat.num_pairs) == int(got.num_pairs)
    for (f1, g1), (f2, g2) in zip(tile_slices(flat), tile_slices(got)):
        np.testing.assert_array_equal(g2, g1)
        np.testing.assert_array_equal(f2, f1)


def test_rowseg_truncating_capacity_bit_identical():
    """A capacity far below demand truncates every bucket on its own:
    bit-identical to the reference, pairs + overflow account for the
    whole demand, and every reported range holds live pairs only."""
    cfg = dataclasses.replace(CFG, rowseg_buckets=2, pair_capacity=1024)
    js = jax_splats(0, 1500, cfg)
    want = jbin.bin_splats(js, jax_config(cfg))
    got = binning.bin_splats(to_torch(js), cfg)
    assert_binned_equal(want, got)
    demand = int(binning.bin_splats(
        to_torch(js), dataclasses.replace(CFG, pair_capacity=1 << 14))
        .num_pairs)
    assert int(got.num_pairs) == 1024 and int(got.overflow) > 0
    assert int(got.num_pairs) + int(got.overflow) == demand
    gid = got.pair_gid.numpy()
    for s, e in zip(got.tile_starts.numpy(), got.tile_ends.numpy()):
        assert (gid[s:e] < 1500).all()


def test_span_fallback_scene_per_tile_slices_match():
    """Only every 20th gaussian is visible, so a 256-slot step spans more
    source rows than the reference's 1024-row window and the reference
    falls back to the flat layout (binning.py:1111-1113). The port has no
    window and keeps the segmented layout; every tile's slice equals the
    reference's."""
    cfg = dataclasses.replace(CFG, rowseg_buckets=2)
    js = jax_splats(4, 6000, cfg)
    hidden = np.arange(6000) % 20 != 0
    js = js._replace(radius=jnp.where(hidden[:, None], 0.0, js.radius))
    want = jbin.bin_splats(js, jax_config(cfg))
    got = binning.bin_splats(to_torch(js), cfg)
    assert not segmented(want) and segmented(got)
    assert int(got.num_pairs) == int(want.num_pairs) > 500
    assert int(got.overflow) == int(want.overflow) == 0
    for (f1, g1), (f2, g2) in zip(tile_slices(want), tile_slices(got)):
        np.testing.assert_array_equal(g2, g1)
        np.testing.assert_array_equal(f2, f1)


def test_rowseg_image_and_grads_match_flat():
    """The port's rowseg render against its flat render: each tile's pairs
    are the same in the same order and the plain rasterizer composites
    each pixel serially, so the image is held to equality (bound 0.0).
    The gradients of all five fields are held to the JAX suite's
    rtol 2e-4 / atol 2e-6 (tests/test_rowseg.py:120-122)."""
    cfg = dataclasses.replace(CFG, image_width=64, image_height=48,
                              pair_capacity=4096, tile_group=2,
                              exact_tile_test=True)
    p = params_np(5, 300, sh_degree=1)
    _, cam = cameras(cfg)
    w = torch.tensor(np.random.default_rng(2).normal(
        size=(48, 64, 4)).astype(np.float32))
    out = {}
    for r in (1, 2):
        c = dataclasses.replace(cfg, rowseg_buckets=r)
        model = GaussianModel.from_numpy(p, device="cpu").trainable()
        image = pipeline.render_image(model, cam, c)
        torch.sum(image * w).backward()
        out[r] = image.detach(), {k: getattr(model, k).grad for k in FIELDS}
    assert float(out[1][0][..., 3].max()) > 0.1
    np.testing.assert_array_equal(out[2][0].numpy(), out[1][0].numpy())
    for k in FIELDS:
        np.testing.assert_allclose(out[2][1][k].numpy(), out[1][1][k].numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=k)
        assert float(out[1][1][k].abs().max()) > 1e-4, k
