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


KW = dict(tw=32.0, th=32.0, alpha_min=1.0 / 255.0)


def raster_kernels_match(binned, cfg):
    """Kernel C in its three modes and kernel D against their plain
    versions on one binned frame."""
    for strict in (True, False):
        c = dataclasses.replace(cfg, strict_termination=strict)
        got = rasterize.rasterize_tiles(binned, c)
        want = rasterize_tiles_torch(binned, c)
        assert float((got - want).abs().max()) <= 1e-5
    tiles, nc = rasterize.rasterize_tiles_aux(binned, cfg)
    want, want_nc = rasterize_tiles_torch(binned, cfg, need_aux=True)
    assert float((tiles - want).abs().max()) <= 1e-5
    assert torch.equal(nc, want_nc)
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = (binned.features, binned.tile_starts, binned.tile_ends,
            torch.randn(want.shape, generator=gen, device="cuda"),
            1.0 - want[..., 3], want_nc, cfg)
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
        raster_kernels_match(binned, CFG)
        raster_kernels_match(binned3, cfg3)
        torch.cuda.synchronize()
    assert cuda_lib.launches == {"coverage_masks": 2, "stream_expand": 1,
                                 "row_cumsum_exclusive": 2,
                                 "stream_expand_seg": 1, "expand_pairs": 1,
                                 "rasterize_strict": 2,
                                 "rasterize_relaxed": 2,
                                 "rasterize_strict_aux": 2,
                                 "rasterize_bwd": 2}
