"""Kernel A: exact cell-coverage masks (port of
gaussian_splat_ipu_tpu/render/kernels/coverage.py::coverage_masks_tpu).

Per gaussian, over an 8x8 window of cells, the minimum of the conic
quadratic F(u, v) = A u^2 + 2B u v + C v^2 over each cell's pixel rectangle
(closed-form edge minima with clamps); a cell is kept when the minimum is
<= q = 2 ln(opacity / alpha_min) * (1 + 1e-4) + 1e-4.

`coverage_masks` launches csrc/coverage.cu on CUDA tensors and runs
`coverage_masks_torch`, the plain version, on CPU tensors. Both produce
the same bits.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib

MASK_SPAN = 8


def coverage_masks_torch(geomf: torch.Tensor, geomi: torch.Tensor, *,
                         tw: float, th: float, alpha_min: float):
    """Plain version, the torch twin of binning._coverage_masks of the
    reference, on the kernel's inputs.

    geomf: (6, N) f32 rows [gx, gy, conic_a, conic_b, conic_c, opacity];
    geomi: (5, N) i32 rows [x0, y0, nx, ny, testable] in cell units.
    Returns (mlo, mhi, count), each (N,) i32."""
    gx, gy, ca, cb, cc, op = geomf
    x0f, y0f, nxf, nyf = (geomi[i].to(torch.float32) for i in range(4))
    testable = geomi[4] != 0
    q = 2.0 * torch.log(torch.clamp_min(op, 1e-12) / alpha_min)
    q = q * (1.0 + 1e-4) + 1e-4
    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)

    def edge_u(e, v0, v1):
        v = torch.clamp(-cb * e / cc_s, v0, v1)
        return ca * e * e + 2.0 * cb * e * v + cc * v * v

    def edge_v(f, u0, u1):
        u = torch.clamp(-cb * f / ca_s, u0, u1)
        return ca * u * u + 2.0 * cb * u * f + cc * f * f

    words = [torch.zeros_like(gx, dtype=torch.int64) for _ in range(2)]
    count = torch.zeros_like(gx, dtype=torch.int32)
    for k in range(MASK_SPAN * MASK_SPAN):
        dx, dy = float(k & 7), float(k >> 3)
        u0 = (x0f + dx) * tw - gx
        u1 = u0 + (tw - 1.0)
        v0 = (y0f + dy) * th - gy
        v1 = v0 + (th - 1.0)
        inside = (u0 <= 0.0) & (0.0 <= u1) & (v0 <= 0.0) & (0.0 <= v1)
        fmin = torch.minimum(
            torch.minimum(edge_u(u0, v0, v1), edge_u(u1, v0, v1)),
            torch.minimum(edge_v(v0, u0, u1), edge_v(v1, u0, u1)))
        fmin = torch.where(inside, 0.0, fmin)
        keep = testable & (dx < nxf) & (dy < nyf) & (fmin <= q)
        words[k // 32] |= keep.to(torch.int64) << (k % 32)
        count += keep.to(torch.int32)
    # uint32 bit patterns -> i32 (bit 31 is the sign bit).
    mlo, mhi = (torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
                for w in words)
    return mlo, mhi, count


def coverage_masks(geomf: torch.Tensor, geomi: torch.Tensor, *, tw: float,
                   th: float, alpha_min: float):
    """(mlo, mhi, count) each (N,) i32; see coverage_masks_torch. CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    if geomf.device.type == "cpu":
        return coverage_masks_torch(geomf, geomi, tw=tw, th=th,
                                    alpha_min=alpha_min)
    cuda_lib.require_cuda(geomf, "geomf")
    n = geomf.shape[1]
    dev = geomf.device
    cuda_lib.require(geomf, "geomf", torch.float32, (6, n), dev)
    cuda_lib.require(geomi, "geomi", torch.int32, (5, n), dev)
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    if n:
        lib = cuda_lib.library()
        cuda_lib.check("coverage_masks", lib.gsplat_coverage_masks(
            geomf.data_ptr(), geomi.data_ptr(), n, tw, th, alpha_min,
            out.data_ptr(), cuda_lib.stream_handle(dev)))
        cuda_lib.launches["coverage_masks"] += 1
    return out[0], out[1], out[2]
