"""Kernel E: exclusive cumsum along the rows of an (R, N) i32 matrix (port
of gaussian_splat_ipu_tpu/render/kernels/scan.py::row_cumsum_exclusive).

The row-bucket segmented binning scans its per-bucket pair counts with it
into per-bucket slot offsets (render/binning.py). `row_cumsum_exclusive`
launches csrc/scan.cu on CUDA tensors and runs
`row_cumsum_exclusive_torch`, the plain version, on CPU tensors. The
kernel is a single-pass scan with decoupled look-back over R x ceil(N /
tile) CTAs; see the note at the top of csrc/scan.cu.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib


def row_cumsum_exclusive_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (R, N) i32 -> (R, N) i32 exclusive cumsum along
    rows (torch.cumsum of i32 gives i64, cast back: wraps as i32 sums
    do)."""
    return (torch.cumsum(x, dim=1) - x).to(torch.int32)


def row_cumsum_exclusive(x: torch.Tensor) -> torch.Tensor:
    """(R, N) i32 exclusive cumsum along rows; see
    row_cumsum_exclusive_torch. CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    if x.device.type == "cpu":
        return row_cumsum_exclusive_torch(x)
    cuda_lib.require_cuda(x, "x")
    if x.dim() != 2:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (R, N)")
    r, n = x.shape
    cuda_lib.require(x, "x", torch.int32, (r, n), x.device)
    out = torch.empty_like(x)
    lib = cuda_lib.library()
    # The look-back's ticket and tile status words; the entry zeroes them.
    scratch = torch.empty(lib.gsplat_row_cumsum_scratch_words(r, n),
                          dtype=torch.int64, device=x.device)
    cuda_lib.check("row_cumsum_exclusive", lib.gsplat_row_cumsum_exclusive(
        x.data_ptr(), r, n, out.data_ptr(), scratch.data_ptr(),
        cuda_lib.stream_handle(x.device)))
    cuda_lib.launches["row_cumsum_exclusive"] += 1
    return out
