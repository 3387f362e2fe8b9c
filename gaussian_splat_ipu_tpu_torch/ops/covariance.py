"""Gaussian covariance math: 3D covariance, EWA 2D projection, conics.

Torch port of gaussian_splat_ipu_tpu/ops/covariance.py: component-wise
expressions over (N,) tensors in f32 (f64 for f64 inputs), with the
reference's 1.3*tan_fov clamp, +0.3 low-pass, alpha-aware extents and
conic validity kept exactly.
"""

from __future__ import annotations

import torch

from gaussian_splat_ipu_tpu_torch.ops.transforms import (at_least_f32,
                                                         quat_to_rotmat)


def covariance_3d(log_scales: torch.Tensor, quats: torch.Tensor):
    """(N,3) log-scales + (N,4) quats -> the six upper-triangle components
    (xx, xy, xz, yy, yz, zz) of Sigma = R S S^T R^T."""
    s = torch.exp(at_least_f32(log_scales))
    r = quat_to_rotmat(at_least_f32(quats))
    m = r * s[..., None, :]
    xx = torch.sum(m[..., 0, :] * m[..., 0, :], -1)
    xy = torch.sum(m[..., 0, :] * m[..., 1, :], -1)
    xz = torch.sum(m[..., 0, :] * m[..., 2, :], -1)
    yy = torch.sum(m[..., 1, :] * m[..., 1, :], -1)
    yz = torch.sum(m[..., 1, :] * m[..., 2, :], -1)
    zz = torch.sum(m[..., 2, :] * m[..., 2, :], -1)
    return xx, xy, xz, yy, yz, zz


def ewa_project(t_view: torch.Tensor, cov3d, view: torch.Tensor,
                focal_x, focal_y, tan_fovx, tan_fovy, lowpass: float = 0.3):
    """EWA projection of 3D covariances to the (a, b, c) components of the
    symmetric 2x2 screen-space covariance [[a, b], [b, c]], low-pass added
    to the diagonal (reference ipu_geometry.hpp:333-383)."""
    xx, xy, xz, yy, yz, zz = cov3d
    tx, ty, tz = t_view[..., 0], t_view[..., 1], t_view[..., 2]

    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    w = view[:3, :3]
    u00 = j00 * w[0, 0] + j02 * w[2, 0]
    u01 = j00 * w[0, 1] + j02 * w[2, 1]
    u02 = j00 * w[0, 2] + j02 * w[2, 2]
    u10 = j11 * w[1, 0] + j12 * w[2, 0]
    u11 = j11 * w[1, 1] + j12 * w[2, 1]
    u12 = j11 * w[1, 2] + j12 * w[2, 2]

    v00 = u00 * xx + u01 * xy + u02 * xz
    v01 = u00 * xy + u01 * yy + u02 * yz
    v02 = u00 * xz + u01 * yz + u02 * zz
    v10 = u10 * xx + u11 * xy + u12 * xz
    v11 = u10 * xy + u11 * yy + u12 * yz
    v12 = u10 * xz + u11 * yz + u12 * zz

    a0 = v00 * u00 + v01 * u01 + v02 * u02
    b = v00 * u10 + v01 * u11 + v02 * u12
    c0 = v10 * u10 + v11 * u11 + v12 * u12
    return a0 + lowpass, b, c0 + lowpass


def aa_opacity_compensation(a, b, c, lowpass: float):
    """Mip-Splatting opacity factor sqrt(det(cov) / det(cov + lowpass)) in
    (0, 1], from the post-dilation (a, b, c)."""
    det_after = a * c - b * b
    det_before = (a - lowpass) * (c - lowpass) - b * b
    ratio = torch.clamp_min(det_before, 0.0) / torch.clamp_min(det_after,
                                                               1e-12)
    return torch.sqrt(torch.clamp(ratio, 0.0, 1.0))


def conic(a, b, c, eps: float = 1e-12):
    """Invert 2x2 covariances -> conic (A, B, C) and validity (det > eps);
    a degenerate covariance gets a zero conic."""
    det = a * c - b * b
    valid = det > eps
    det_inv = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    return c * det_inv, -b * det_inv, a * det_inv, valid


def eigenvalues_2d(a, b, c, floor: float = 0.1):
    """Eigenvalues (larger, smaller) of the 2x2 covariance [[a, b], [b, c]],
    the discriminant floored at `floor` (reference
    Gaussian2D::ComputeEigenvalues, ipu_geometry.hpp:247-261)."""
    det = a * c - b * b
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, floor))
    return mid + disc, mid - disc


def splat_radius(a, b, c):
    """3-sigma pixel radius of a splat, ceil'd: ceil(3 sqrt(largest
    eigenvalue)) (reference Gaussian2D::GetBoundingBox,
    ipu_geometry.hpp:263-276)."""
    l1, _ = eigenvalues_2d(a, b, c)
    return torch.ceil(3.0 * torch.sqrt(torch.clamp_min(l1, 0.0)))


def splat_extent(a, c, opacity=None, alpha_min: float = 1.0 / 255.0,
                 max_sigma: float = 3.0):
    """Per-axis half-extents (rx, ry), ceil'd, of the footprint
    {d : d^T Sigma^-1 d <= q}: sqrt(q*Sigma_xx), sqrt(q*Sigma_yy). With
    `opacity`, q = 2 ln(opacity/alpha_min) (alpha-aware), capped at
    max_sigma^2 when max_sigma > 0."""
    if opacity is None:
        q = max_sigma * max_sigma
    else:
        q = 2.0 * torch.log(torch.clamp_min(opacity, 1e-12) / alpha_min)
        if max_sigma > 0.0:
            q = torch.clamp_max(q, max_sigma * max_sigma)
        q = torch.clamp_min(q, 0.0)
    rx = torch.ceil(torch.sqrt(q * torch.clamp_min(a, 0.0)))
    ry = torch.ceil(torch.sqrt(q * torch.clamp_min(c, 0.0)))
    return rx, ry
