"""Kernels C and D: forward and backward tile compositing (port of
gaussian_splat_ipu_tpu/render/kernels/rasterize.py::rasterize_tiles, i.e.
_pallas_forward -> _kernel in its strict, relaxed and strict-aux forms,
and _pallas_backward -> _bwd_kernel).

`rasterize_tiles` is differentiable, as the reference's custom_vjp
(:636-663): with grad enabled and a pair table that requires grad, the
forward runs the strict aux kernel whatever cfg.strict_termination says
(raster_fwd), saves t_n = 1 - alpha and the contributor count nc, and the
backward is kernel D. Otherwise it runs the inference primal, strict or
relaxed. CUDA tensors launch csrc/rasterize.cu and csrc/rasterize_bwd.cu;
CPU tensors take the plain versions in render/tile_raster.py. There is no
other fallback: a CUDA tensor whose kernel fails to build or launch
raises.

Every entry takes `tile_offset`, the global flat id of the first tile of
the ranges: a row strip of the distributed renderer (parallel/
distributed.py) passes row_lo * tiles_x, as the reference passes its
`off_ref` scalar (:614-634). A strip is whole tile rows, so the offset is
a multiple of tiles_x.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from gaussian_splat_ipu_tpu_torch.render import binning as B
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.render.tile_raster import (
    rasterize_backward_torch, rasterize_tiles_torch)
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

_MAX_THREADS = 512                  # csrc/raster_stage.cuh kMaxThreads
_ROUNDS = 2                         # staging rounds: chunk <= 2 x threads
_FWD_MAX_PPT, _BWD_MAX_PPT = 2, 4   # pixels per thread, kernels C and D
_STRICT, _RELAXED, _STRICT_AUX = 0, 1, 2
_MODE_NAMES = {_STRICT: "rasterize_strict", _RELAXED: "rasterize_relaxed",
               _STRICT_AUX: "rasterize_strict_aux"}


def _layout(cfg: RasterConfig, max_ppt: int):
    """The kernels' thread layout, csrc/raster_stage.cuh::choose_layout:
    (pixels per thread, warp rectangle width, threads), or None when the
    tile and chunk admit none. Each warp owns a ww x (32 / ww) * ppt pixel
    rectangle, ww = min(16, lowest set bit of tile_width), ppt the largest
    of 4, 2, 1 up to max_ppt that fits."""
    tw, th, chunk = cfg.tile_width, cfg.tile_height, cfg.chunk_size
    if tw <= 0 or th <= 0 or chunk <= 0:
        return None
    ww = min(16, tw & -tw)
    for ppt in (p for p in (4, 2, 1) if p <= max_ppt):
        threads = tw * th // ppt
        if (th % ((32 // ww) * ppt) == 0 and threads <= _MAX_THREADS
                and chunk <= _ROUNDS * threads):
            return ppt, ww, threads
    return None


def _check_launch(feats, starts, ends, cfg: RasterConfig, backward: bool,
                  tile_offset: int):
    """Validate what the kernels take; returns (device, P, T, max_pairs)."""
    cuda_lib.require_cuda(feats, "features")
    if tile_offset < 0 or tile_offset % cfg.tiles_x:
        raise ValueError(f"tile_offset {tile_offset}: not a whole number of "
                         f"{cfg.tiles_x}-tile rows")
    dev = feats.device
    p = feats.shape[1]
    num_tiles = starts.shape[0]
    cuda_lib.require(feats, "features", torch.float32, (B.TABLE_ROWS, p), dev)
    cuda_lib.require(starts, "tile_starts", torch.int32, (num_tiles,), dev)
    cuda_lib.require(ends, "tile_ends", torch.int32, (num_tiles,), dev)
    if _layout(cfg, _BWD_MAX_PPT if backward else _FWD_MAX_PPT) is None:
        raise ValueError(
            f"{cfg.tile_width}x{cfg.tile_height} tiles with chunk_size "
            f"{cfg.chunk_size}: the kernels need warp rectangles that tile "
            f"the tile, at most {_MAX_THREADS} threads and a chunk of at "
            f"most {_ROUNDS} x threads pairs")
    max_pairs = cfg.max_chunks_per_range * cfg.chunk_size
    if max_pairs >= 1 << 31:
        raise ValueError("max_chunks_per_range * chunk_size exceeds int32")
    return dev, p, num_tiles, max_pairs


def _forward(binned: B.BinnedSplats, cfg: RasterConfig, mode: int,
             tile_offset: int = 0):
    """Launch kernel C in `mode`: (T, NPIX, 4) tiles, and with _STRICT_AUX
    also the (T, NPIX) f32 contributor counts."""
    feats, starts, ends = binned.features, binned.tile_starts, \
        binned.tile_ends
    dev, p, num_tiles, max_pairs = _check_launch(feats, starts, ends, cfg,
                                                 False, tile_offset)
    npix = cfg.pixels_per_tile
    out = torch.empty((num_tiles, npix, 4), dtype=torch.float32, device=dev)
    nc = (torch.empty((num_tiles, npix), dtype=torch.float32, device=dev)
          if mode == _STRICT_AUX else None)
    if num_tiles:
        bg = cfg.background
        lib = cuda_lib.library()
        cuda_lib.check("rasterize_fwd", lib.gsplat_rasterize_fwd(
            feats.data_ptr(), p, starts.data_ptr(), ends.data_ptr(),
            num_tiles, tile_offset, cfg.tiles_x, cfg.tile_width,
            cfg.tile_height,
            cfg.chunk_size, max_pairs, cfg.transmittance_eps,
            cfg.alpha_clamp, cfg.alpha_min, bg[0], bg[1], bg[2], mode,
            out.data_ptr(), 0 if nc is None else nc.data_ptr(),
            cuda_lib.stream_handle(dev)))
        cuda_lib.launches[_MODE_NAMES[mode]] += 1
    return out if nc is None else (out, nc)


def rasterize_tiles_aux(binned: B.BinnedSplats, cfg: RasterConfig,
                        tile_offset: int = 0):
    """Strict forward with contributor counts: ((T, NPIX, 4) tiles,
    (T, NPIX) f32 nc). CUDA tensors launch the strict aux kernel, CPU
    tensors take the plain version."""
    if binned.features.device.type == "cpu":
        return rasterize_tiles_torch(binned, cfg, need_aux=True,
                                     tile_offset=tile_offset)
    return _forward(binned, cfg, _STRICT_AUX, tile_offset)


def rasterize_backward(features: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor, gout: torch.Tensor,
                       t_n: torch.Tensor, nc: torch.Tensor,
                       cfg: RasterConfig,
                       tile_offset: int = 0) -> torch.Tensor:
    """dfeat (16, P) from the cotangent gout (T, NPIX, 4) and the saved
    t_n, nc (T, NPIX); see tile_raster.rasterize_backward_torch. CUDA
    tensors launch kernel D, CPU tensors take the plain version."""
    if features.device.type == "cpu":
        return rasterize_backward_torch(features, starts, ends, gout, t_n,
                                        nc, cfg, tile_offset)
    dev, p, num_tiles, max_pairs = _check_launch(
        features, starts, ends, cfg, True, tile_offset)
    npix = cfg.pixels_per_tile
    cuda_lib.require(gout, "gout", torch.float32, (num_tiles, npix, 4), dev)
    cuda_lib.require(t_n, "t_n", torch.float32, (num_tiles, npix), dev)
    cuda_lib.require(nc, "nc", torch.float32, (num_tiles, npix), dev)
    dfeat = torch.zeros_like(features)
    if num_tiles:
        bg = cfg.background
        lib = cuda_lib.library()
        cuda_lib.check("rasterize_bwd", lib.gsplat_rasterize_bwd(
            features.data_ptr(), p, starts.data_ptr(), ends.data_ptr(),
            gout.data_ptr(), t_n.data_ptr(), nc.data_ptr(), num_tiles,
            tile_offset, cfg.tiles_x, cfg.tile_width, cfg.tile_height,
            cfg.chunk_size, max_pairs, cfg.alpha_clamp, cfg.alpha_min,
            bg[0], bg[1], bg[2], dfeat.data_ptr(),
            cuda_lib.stream_handle(dev)))
        cuda_lib.launches["rasterize_bwd"] += 1
    return dfeat


class _Rasterize(torch.autograd.Function):
    """Pair table (16, P) -> (T, NPIX, 4) tiles, differentiable in the
    table (the tile ranges are integers)."""

    @staticmethod
    def forward(ctx, features, binned, cfg, tile_offset):
        tiles, nc = rasterize_tiles_aux(binned._replace(features=features),
                                        cfg, tile_offset)
        ctx.save_for_backward(features, binned.tile_starts, binned.tile_ends,
                              1.0 - tiles[..., 3], nc)
        ctx.cfg = cfg
        ctx.tile_offset = tile_offset
        return tiles

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        features, starts, ends, t_n, nc = ctx.saved_tensors
        return rasterize_backward(features, starts, ends, gout.contiguous(),
                                  t_n, nc, ctx.cfg,
                                  ctx.tile_offset), None, None, None


def rasterize_tiles(binned: B.BinnedSplats, cfg: RasterConfig,
                    tile_offset: int = 0) -> torch.Tensor:
    """Rasterize binned splats -> (T, NPIX, 4) RGBA tile buffers, local
    tile t at global flat id tile_offset + t. Differentiated: the strict
    aux forward and kernel D. Otherwise the inference primal, strict or
    relaxed per cfg.strict_termination. CUDA tensors launch the kernels,
    CPU tensors take the plain versions."""
    feats = binned.features
    if torch.is_grad_enabled() and feats.requires_grad:
        return _Rasterize.apply(feats, binned, cfg, tile_offset)
    if feats.device.type == "cpu":
        return rasterize_tiles_torch(binned, cfg, tile_offset=tile_offset)
    return _forward(binned, cfg,
                    _STRICT if cfg.strict_termination else _RELAXED,
                    tile_offset)
