"""Kernel B: stream expansion of gaussians into (gaussian, tile) pair slots
(port of gaussian_splat_ipu_tpu/render/kernels/expand.py::stream_expand).

For each output slot s in [0, P): gid = the rightmost g with
offsets_ext[g] <= s, rank = s - offsets_ext[gid], and the slot's 16
columns are packed[gid]. Empty gaussians repeat their successor's offset
and are never selected. Slots past the live total resolve to the sentinel
g = N (offsets_ext[N] = total), so they get gid = N, rank = s - total and
the zero row N, as the reference's pad rule has it.

`stream_expand` launches csrc/expand.cu on CUDA tensors and runs
`stream_expand_torch`, the plain version, on CPU tensors.
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
