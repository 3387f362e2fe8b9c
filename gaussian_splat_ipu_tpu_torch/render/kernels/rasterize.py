"""Kernel C: forward tile compositing (port of the inference primal of
gaussian_splat_ipu_tpu/render/kernels/rasterize.py::rasterize_tiles, i.e.
_pallas_forward -> _kernel with need_aux=False, both its strict and its
relaxed branch).

`rasterize_tiles` launches csrc/rasterize.cu on CUDA tensors and runs
render/tile_raster.rasterize_tiles_torch, the plain version, on CPU
tensors. Forward only: the backward kernel comes with the training port.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.render import binning as B
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
    rasterize_tiles_torch)
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

_STAGED_ROWS = B.FEAT_OPACITY + 1   # x, y, conic a/b/c, r, g, b, opacity
_MAX_STATIC_SMEM = 48 * 1024


def rasterize_tiles(binned: B.BinnedSplats, cfg: RasterConfig
                    ) -> torch.Tensor:
    """Rasterize binned splats -> (T, NPIX, 4) RGBA tile buffers, strict or
    relaxed termination per cfg.strict_termination. CUDA tensors launch
    the kernel, CPU tensors take the plain version."""
    feats = binned.features
    if feats.device.type == "cpu":
        return rasterize_tiles_torch(binned, cfg)
    cuda_lib.require_cuda(feats, "features")
    dev = feats.device
    p = feats.shape[1]
    num_tiles = binned.tile_starts.shape[0]
    npix = cfg.pixels_per_tile
    c = cfg.chunk_size
    cuda_lib.require(feats, "features", torch.float32, (B.TABLE_ROWS, p), dev)
    cuda_lib.require(binned.tile_starts, "tile_starts", torch.int32,
                     (num_tiles,), dev)
    cuda_lib.require(binned.tile_ends, "tile_ends", torch.int32,
                     (num_tiles,), dev)
    if not 0 < npix <= 1024:
        raise ValueError(f"tile of {npix} pixels: the kernel runs one "
                         "thread per pixel, at most 1024")
    if _STAGED_ROWS * c * 4 > _MAX_STATIC_SMEM:
        raise ValueError(f"chunk_size {c} needs more than 48 KiB of shared "
                         "memory")
    max_pairs = cfg.max_chunks_per_range * c
    if max_pairs >= 1 << 31:
        raise ValueError("max_chunks_per_range * chunk_size exceeds int32")
    out = torch.empty((num_tiles, npix, 4), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return out
    relaxed = not cfg.strict_termination
    bg = cfg.background
    lib = cuda_lib.library()
    cuda_lib.check("rasterize_fwd", lib.gsplat_rasterize_fwd(
        feats.data_ptr(), p, binned.tile_starts.data_ptr(),
        binned.tile_ends.data_ptr(), num_tiles, cfg.tiles_x,
        cfg.tile_width, cfg.tile_height, c, max_pairs,
        cfg.transmittance_eps, cfg.alpha_clamp, cfg.alpha_min,
        bg[0], bg[1], bg[2], int(relaxed), out.data_ptr(),
        cuda_lib.stream_handle(dev)))
    cuda_lib.launches["rasterize_relaxed" if relaxed
                      else "rasterize_strict"] += 1
    return out
