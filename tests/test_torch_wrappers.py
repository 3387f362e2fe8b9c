"""The kernel wrappers: a CPU tensor takes the plain version and launches
nothing; a tensor on another device is refused; on a CUDA card each kernel
equals its plain version (marked `cuda`, skipped without a card)."""

import dataclasses

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render import binning
from gaussian_splat_ipu_tpu_torch.render.kernels import (coverage, cuda_lib,
                                                         expand, rasterize,
                                                         scan)
from gaussian_splat_ipu_tpu_torch.render.projection import project_gaussians
from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
    rasterize_backward_torch, rasterize_tiles_torch)
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

torch.set_num_threads(1)

CFG = RasterConfig(image_width=160, image_height=96, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 14,
                   tile_group=2, exact_tile_test=True)


def splats_on(device, n=1500):
    g = torch.Generator(device=device).manual_seed(3)
    model = GaussianModel.random(n, generator=g, device=device)
    cam = Camera.orbit(-np.ones(3), np.ones(3), 0.7, 160 / 96,
                       rot_y_deg=20.0, device=device)
    return project_gaussians(model, cam, CFG)


def kernel_inputs(splats):
    x0, y0, nx, ny = binning.cell_footprints(splats, CFG)
    _, geomf, geomi = binning.coverage_inputs(splats, x0, y0, nx, ny)
    packed, offs = binning.pack_gaussians(splats, CFG)
    return geomf, geomi, packed, offs, binning.bin_splats(splats, CFG)


def seg_inputs(splats, packed, offs):
    """The three new kernels' inputs as bin_splats makes them: (R, N)
    bucket counts for the scan, the segmented expansion's offsets (3
    buckets of 512 slots, the middle one truncated) and gid_pre for
    expand_pairs."""
    cfg = dataclasses.replace(CFG, rowseg_buckets=3, pair_capacity=1536)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(binning, "SEG_ALIGN", 256)
        lay = binning.rowseg_layout(binning.footprints(splats, cfg), cfg)
    gid_pre, _ = binning.gather_slots(offs, 4096)
    return lay.counts, (packed, lay.offs, lay.offs2, lay.live_end,
                        lay.cap), gid_pre


def new_kernels_match(splats, packed, offs):
    counts, seg, gid_pre = seg_inputs(splats, packed, offs)
    assert int(counts[0].sum()) < 512 < int(counts[1].sum())
    assert torch.equal(scan.row_cumsum_exclusive(counts),
                       scan.row_cumsum_exclusive_torch(counts))
    for a, b in zip(expand.stream_expand_seg(*seg),
                    expand.stream_expand_seg_torch(*seg)):
        assert torch.equal(a, b)
    assert torch.equal(expand.expand_pairs(packed, gid_pre),
                       expand.expand_pairs_torch(packed, gid_pre))


# Kernel E's awkward shapes, (R, N, low, high, offset): counts drawn from
# [low, high), the rows starting `offset` elements past an aligned
# address. N not a multiple of 4 (scalar loads), N below one tile, a row
# start off 16 B, more tiles than the card holds at once, i32 wrap.
SCAN_CASES = ((1, 1, 0, 9, 0), (3, 4099, 0, 9, 0), (2, 2049, 0, 9, 0),
              (2, 3 * 8192 + 8, 0, 9, 1), (3, 1 << 22, 0, 9, 0),
              (2, 5000, 1 << 28, 1 << 30, 0))


def scan_matches_at_awkward_shapes(device):
    rng = np.random.default_rng(7)
    for r, n, low, high, off in SCAN_CASES:
        flat = torch.empty(r * n + off, dtype=torch.int32, device=device)
        x = flat[off:].view(r, n)
        x.copy_(torch.from_numpy(rng.integers(low, high, (r, n),
                                              dtype=np.int32)))
        assert torch.equal(scan.row_cumsum_exclusive(x),
                           scan.row_cumsum_exclusive_torch(x)), (r, n, off)


KW = dict(tw=32.0, th=32.0, alpha_min=1.0 / 255.0)


def raster_kernels_match(binned, cfg, tile_offset=0):
    """Kernel C in its three modes and kernel D against their plain
    versions on one binned frame (or strip, at its tile offset)."""
    for strict in (True, False):
        c = dataclasses.replace(cfg, strict_termination=strict)
        got = rasterize.rasterize_tiles(binned, c, tile_offset)
        want = rasterize_tiles_torch(binned, c, tile_offset=tile_offset)
        assert float((got - want).abs().max()) <= 1e-5
    tiles, nc = rasterize.rasterize_tiles_aux(binned, cfg, tile_offset)
    want, want_nc = rasterize_tiles_torch(binned, cfg, need_aux=True,
                                          tile_offset=tile_offset)
    assert float((tiles - want).abs().max()) <= 1e-5
    assert torch.equal(nc, want_nc)
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = (binned.features, binned.tile_starts, binned.tile_ends,
            torch.randn(want.shape, generator=gen, device="cuda"),
            1.0 - want[..., 3], want_nc, cfg, tile_offset)
    got = rasterize.rasterize_backward(*args)
    ref = rasterize_backward_torch(*args)
    # Atomics reorder the sums: bound each row by its own scale.
    bound = (1e-4 * ref.abs().amax(dim=1, keepdim=True) + 1e-3 * ref.abs())
    assert bool(((got - ref).abs() <= bound).all())


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    cuda_lib.launches.clear()
    geomf, geomi, packed, offs, binned = kernel_inputs(splats_on("cpu"))
    for a, b in zip(coverage.coverage_masks(geomf, geomi, **KW),
                    coverage.coverage_masks_torch(geomf, geomi, **KW)):
        assert torch.equal(a, b)
    for a, b in zip(expand.stream_expand(packed, offs, 4096),
                    expand.stream_expand_torch(packed, offs, 4096)):
        assert torch.equal(a, b)
    assert torch.equal(rasterize.rasterize_tiles(binned, CFG),
                       rasterize_tiles_torch(binned, CFG))
    new_kernels_match(splats_on("cpu"), packed, offs)
    scan_matches_at_awkward_shapes("cpu")
    assert sum(cuda_lib.launches.values()) == 0


def test_other_devices_are_refused():
    meta = torch.empty((6, 10), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        coverage.coverage_masks(meta, meta.to(torch.int32), **KW)
    with pytest.raises(ValueError, match="CUDA tensors"):
        expand.stream_expand(torch.empty((5, 16), device="meta"),
                             torch.empty((5,), device="meta"), 128)
    rows = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan.row_cumsum_exclusive(rows)
    with pytest.raises(ValueError, match="CUDA tensors"):
        expand.stream_expand_seg(torch.empty((5, 16), device="meta"), rows,
                                 rows, rows[:, 0], 256)
    with pytest.raises(ValueError, match="CUDA tensors"):
        expand.expand_pairs(torch.empty((5, 16), device="meta"), rows[0])
    assert sum(cuda_lib.launches.values()) == 0


def test_importing_builds_nothing():
    assert cuda_lib._lib is None or torch.cuda.is_available()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs this comparison at full size)")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        geomf, geomi, packed, offs, binned = kernel_inputs(splats_on("cuda"))
        # A 3x3 tile group: every member tile walks its group's range.
        cfg3 = dataclasses.replace(CFG, tile_group=3)
        binned3 = binning.bin_splats(splats_on("cuda"), cfg3)
        cuda_lib.launches.clear()
        for a, b in zip(coverage.coverage_masks(geomf, geomi, **KW),
                        coverage.coverage_masks_torch(geomf, geomi, **KW)):
            assert torch.equal(a, b)
        for a, b in zip(expand.stream_expand(packed, offs, 4096),
                        expand.stream_expand_torch(packed, offs, 4096)):
            assert torch.equal(a, b)
        new_kernels_match(splats_on("cuda"), packed, offs)
        scan_matches_at_awkward_shapes("cuda")
        raster_kernels_match(binned, CFG)
        raster_kernels_match(binned3, cfg3)
        torch.cuda.synchronize()
    # splats_on projects once more, through kernel G.
    assert cuda_lib.launches == {"coverage_masks": 2, "stream_expand": 1,
                                 "project_gaussians": 1,
                                 "row_cumsum_exclusive":
                                 2 + len(SCAN_CASES),
                                 "stream_expand_seg": 1, "expand_pairs": 1,
                                 "rasterize_strict": 2,
                                 "rasterize_relaxed": 2,
                                 "rasterize_strict_aux": 2,
                                 "rasterize_bwd": 2}


@pytest.mark.cuda
def test_raster_kernels_match_at_a_tile_offset_on_the_card():
    """Kernels C and D on the last of 3 strips (tile rows 4-5 of 6, offset
    40) and on a grouped strip (tile_group 3, rows 3-5, offset 30), against
    their plain versions at the same offset: C to the whole-grid bar, D
    within the row-scaled bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py phase 15 runs this at full size)")
    with torch.inference_mode():
        splats = splats_on("cuda")
        cases = [(CFG, 4, 2), (dataclasses.replace(CFG, tile_group=3), 3, 3)]
        cuda_lib.launches.clear()
        for cfg, row_lo, rows in cases:
            binned = binning.bin_splats(splats, cfg, row_lo, rows, 4096)
            assert int((binned.tile_ends - binned.tile_starts).sum()) > 0
            raster_kernels_match(binned, cfg, row_lo * cfg.tiles_x)
        with pytest.raises(ValueError, match="whole number"):
            rasterize.rasterize_tiles(binned, CFG, 3)
        torch.cuda.synchronize()
    assert cuda_lib.launches["rasterize_bwd"] == 2


@pytest.mark.cuda
def test_raster_kernels_match_the_oracle_on_the_card():
    """Kernel C strict and C-aux against the dense oracle
    (render/oracle.py) at the tiled render's bar (atol 2e-5 / rtol 1e-4),
    and kernel D's model gradients, through the render under autograd,
    against autograd through the oracle (atol 2e-4 / rtol 1e-3), on 192
    gaussians at 64x64 over a black background (the density of
    tests/test_backward_kernel.py:53-61)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py's oracle phase runs this at 160x128)")
    from gaussian_splat_ipu_tpu_torch.models.gaussians import FIELDS
    from gaussian_splat_ipu_tpu_torch.render import pipeline
    from gaussian_splat_ipu_tpu_torch.render.oracle import render_oracle
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = RasterConfig(image_width=64, image_height=64,
                       pair_capacity=1 << 12, max_chunks_per_tile=4)
    g = torch.Generator(device="cuda").manual_seed(0)
    model = GaussianModel.random(192, generator=g, device="cuda")
    cam = Camera.orbit(-np.ones(3), np.ones(3), float(np.radians(40.0)), 1.0,
                       device="cuda")
    weights = torch.randn((64, 64, 4), generator=g, device="cuda")
    cuda_lib.launches.clear()
    with torch.inference_mode():
        ref = render_oracle(model, cam, cfg)
        strict = pipeline.render(model, cam, cfg).image
        binned = binning.bin_splats(project_gaussians(model, cam, cfg), cfg)
        aux = pipeline._untile_crop(rasterize.rasterize_tiles_aux(binned,
                                                                  cfg)[0],
                                    cfg)
    for img in (strict, aux):
        torch.testing.assert_close(img, ref, atol=2e-5, rtol=1e-4)

    def grads(render_fn):
        m = model.trainable()
        loss = torch.sum(render_fn(m, cam, cfg) * weights)
        return torch.autograd.grad(loss, tuple(m.parameters()))

    got = grads(lambda m, c, f: pipeline.render(m, c, f).image)
    want = grads(render_oracle)
    for k, a, b in zip(FIELDS, got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3, msg=k)
    assert cuda_lib.launches["rasterize_strict"] == 1
    assert cuda_lib.launches["rasterize_strict_aux"] == 2
    assert cuda_lib.launches["rasterize_bwd"] == 1
