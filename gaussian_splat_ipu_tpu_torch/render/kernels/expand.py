"""Pair expansion kernels (port of
gaussian_splat_ipu_tpu/render/kernels/expand.py).

Kernel B, `stream_expand` (flat) and `stream_expand_seg` (row-bucket
segmented), the counterpart of the reference's `stream_expand`: for each
output slot s in [0, P): gid = the rightmost g with offsets[g] <= s,
rank = s - offsets[gid], and the slot's 16 columns are packed[gid]. Empty
gaussians repeat their successor's offset and are never selected. Slots
past the live total get gid = N, their rank counted from it, and the zero
row N, as the reference's pad rule has it.

Kernel F, `expand_pairs`, the counterpart of the reference's
`expand_pairs`: the ascending row gather packed[gid_pre] into the
feature-major (16, P) table, for the binning's gather paths.

Each wrapper launches its CUDA kernel (csrc/expand.cu,
csrc/expand_pairs.cu) on CUDA tensors and runs its plain version
(`*_torch`) on CPU tensors.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib

ROW = 16  # columns of the packed per-gaussian table


def stream_expand_torch(packed: torch.Tensor, offsets_ext: torch.Tensor,
                        p: int):
    """Plain version. packed: (N+1, 16) f32, row N zero; offsets_ext:
    (N+1,) i32 non-decreasing first-slot offsets, offsets_ext[N] = total.
    Returns (cols (16, P) f32, gid (P,) i32, rank (P,) i32)."""
    s = torch.arange(p, dtype=torch.int32, device=packed.device)
    gid = torch.searchsorted(offsets_ext, s, right=True, out_int32=True) - 1
    rank = s - offsets_ext[gid]
    return packed[gid].T.contiguous(), gid, rank


def stream_expand(packed: torch.Tensor, offsets_ext: torch.Tensor, p: int):
    """(cols (16, P), gid (P,), rank (P,)); see stream_expand_torch. CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    if packed.device.type == "cpu":
        return stream_expand_torch(packed, offsets_ext, p)
    cuda_lib.require_cuda(packed, "packed")
    n1 = packed.shape[0]
    dev = packed.device
    cuda_lib.require(packed, "packed", torch.float32, (n1, ROW), dev)
    cuda_lib.require(offsets_ext, "offsets_ext", torch.int32, (n1,), dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed: rows must be 16-byte aligned")
    cols = torch.empty((ROW, p), dtype=torch.float32, device=dev)
    gid = torch.empty((p,), dtype=torch.int32, device=dev)
    rank = torch.empty((p,), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check("stream_expand", lib.gsplat_stream_expand(
        packed.data_ptr(), offsets_ext.data_ptr(), n1 - 1, p,
        cols.data_ptr(), gid.data_ptr(), rank.data_ptr(),
        cuda_lib.stream_handle(dev)))
    cuda_lib.launches["stream_expand"] += 1
    return cols, gid, rank


def stream_expand_seg_torch(packed: torch.Tensor, offs_rows: torch.Tensor,
                            offs2_rows: torch.Tensor,
                            live_end: torch.Tensor, cap: int):
    """Plain version of the segmented expansion into R buckets of `cap`
    slots. packed: (N+1, 16) f32, row N zero, N >= 1; offs_rows,
    offs2_rows: (R, N) i32, offs_rows[r] ascending with
    offs_rows[r, 0] = r * cap (gaussian g's first slot in bucket r), and
    offs2_rows = offs_rows less g's pairs in earlier buckets; live_end:
    (R,) i32, the first pad slot of each bucket.

    Slot s of bucket r = s // cap: a pad when s >= live_end[r] (gid N,
    rank s - live_end[r]); otherwise gid = the rightmost g < N with
    offs_rows[r, g] <= s and rank = s - offs2_rows[r, gid] (the rank in
    the gaussian's whole footprint). Returns (cols (16, R*cap) f32,
    gid (R*cap,) i32, rank (R*cap,) i32)."""
    n = packed.shape[0] - 1
    r_b = offs_rows.shape[0]
    s = torch.arange(r_b * cap, dtype=torch.int32,
                     device=packed.device).view(r_b, cap)
    found = torch.searchsorted(offs_rows, s, right=True, out_int32=True) - 1
    end = live_end[:, None]
    is_pad = s >= end
    gid = torch.where(is_pad, n, found).reshape(-1)
    rank = torch.where(is_pad, s - end,
                       s - torch.gather(offs2_rows, 1, found.long()))
    return packed[gid].T.contiguous(), gid, rank.reshape(-1)


def stream_expand_seg(packed: torch.Tensor, offs_rows: torch.Tensor,
                      offs2_rows: torch.Tensor, live_end: torch.Tensor,
                      cap: int):
    """(cols (16, R*cap), gid (R*cap,), rank (R*cap,)); see
    stream_expand_seg_torch. CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    if packed.device.type == "cpu":
        return stream_expand_seg_torch(packed, offs_rows, offs2_rows,
                                       live_end, cap)
    cuda_lib.require_cuda(packed, "packed")
    n1 = packed.shape[0]
    r_b = offs_rows.shape[0]
    dev = packed.device
    if n1 < 2:
        raise ValueError("packed: the segmented expansion needs N >= 1")
    cuda_lib.require(packed, "packed", torch.float32, (n1, ROW), dev)
    cuda_lib.require(offs_rows, "offs_rows", torch.int32, (r_b, n1 - 1), dev)
    cuda_lib.require(offs2_rows, "offs2_rows", torch.int32, (r_b, n1 - 1),
                     dev)
    cuda_lib.require(live_end, "live_end", torch.int32, (r_b,), dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed: rows must be 16-byte aligned")
    p = r_b * cap
    cols = torch.empty((ROW, p), dtype=torch.float32, device=dev)
    gid = torch.empty((p,), dtype=torch.int32, device=dev)
    rank = torch.empty((p,), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check("stream_expand_seg", lib.gsplat_stream_expand_seg(
        packed.data_ptr(), offs_rows.data_ptr(), offs2_rows.data_ptr(),
        live_end.data_ptr(), n1 - 1, r_b, cap, cols.data_ptr(),
        gid.data_ptr(), rank.data_ptr(), cuda_lib.stream_handle(dev)))
    cuda_lib.launches["stream_expand_seg"] += 1
    return cols, gid, rank


def expand_pairs_torch(packed: torch.Tensor,
                       gid_pre: torch.Tensor) -> torch.Tensor:
    """Plain version. packed: (N+1, 16) f32, row N zero; gid_pre: (P,) i32
    rows in [0, N] (ascending in the binning, N for pads). Returns the
    (16, P) f32 feature-major table packed[gid_pre].T."""
    return packed[gid_pre].T.contiguous()


def expand_pairs(packed: torch.Tensor, gid_pre: torch.Tensor) -> torch.Tensor:
    """(16, P) f32; see expand_pairs_torch. CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    if packed.device.type == "cpu":
        return expand_pairs_torch(packed, gid_pre)
    cuda_lib.require_cuda(packed, "packed")
    n1 = packed.shape[0]
    p = gid_pre.shape[0]
    dev = packed.device
    cuda_lib.require(packed, "packed", torch.float32, (n1, ROW), dev)
    cuda_lib.require(gid_pre, "gid_pre", torch.int32, (p,), dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed: rows must be 16-byte aligned")
    cols = torch.empty((ROW, p), dtype=torch.float32, device=dev)
    cuda_lib.check("expand_pairs", cuda_lib.library().gsplat_expand_pairs(
        packed.data_ptr(), gid_pre.data_ptr(), p, cols.data_ptr(),
        cuda_lib.stream_handle(dev)))
    cuda_lib.launches["expand_pairs"] += 1
    return cols
