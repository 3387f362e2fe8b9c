"""Spherical-harmonics colour evaluation, degrees 0..3 (torch port of
gaussian_splat_ipu_tpu/ops/sh.py, same constants and term order)."""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.ops.transforms import at_least_f32

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def dc_to_rgb(f_dc: torch.Tensor) -> torch.Tensor:
    """(N, 3) DC coefficients -> RGB = SH_C0 * f_dc + 0.5, clamped at 0
    (reference src/main/splat.cpp:136-148)."""
    return torch.clamp_min(SH_C0 * at_least_f32(f_dc) + 0.5, 0.0)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int
            ) -> torch.Tensor:
    """(N, K, 3) coefficients at (N, 3) unit view directions -> (N, 3)
    RGB = SH(dir) + 0.5, clamped >= 0."""
    result = SH_C0 * sh[:, 0]
    if degree >= 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        result = result + SH_C1 * (-y * sh[:, 1] + z * sh[:, 2]
                                   - x * sh[:, 3])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = result + (
            SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
            + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
            + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        result = result + (
            SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
            + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
            + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp_min(result + 0.5, 0.0)
