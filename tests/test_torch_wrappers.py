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
                                                         expand, rasterize)
from gaussian_splat_ipu_tpu_torch.render.projection import project_gaussians
from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
    rasterize_tiles_torch)
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


KW = dict(tw=32.0, th=32.0, alpha_min=1.0 / 255.0)


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
    assert sum(cuda_lib.launches.values()) == 0


def test_other_devices_are_refused():
    meta = torch.empty((6, 10), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        coverage.coverage_masks(meta, meta.to(torch.int32), **KW)
    with pytest.raises(ValueError, match="CUDA tensors"):
        expand.stream_expand(torch.empty((5, 16), device="meta"),
                             torch.empty((5,), device="meta"), 128)
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
        cuda_lib.launches.clear()
        for a, b in zip(coverage.coverage_masks(geomf, geomi, **KW),
                        coverage.coverage_masks_torch(geomf, geomi, **KW)):
            assert torch.equal(a, b)
        for a, b in zip(expand.stream_expand(packed, offs, 4096),
                        expand.stream_expand_torch(packed, offs, 4096)):
            assert torch.equal(a, b)
        for strict in (True, False):
            cfg = dataclasses.replace(CFG, strict_termination=strict)
            got = rasterize.rasterize_tiles(binned, cfg)
            want = rasterize_tiles_torch(binned, cfg)
            assert float((got - want).abs().max()) <= 1e-5
        torch.cuda.synchronize()
    assert cuda_lib.launches == {"coverage_masks": 1, "stream_expand": 1,
                                 "rasterize_strict": 1,
                                 "rasterize_relaxed": 1}
