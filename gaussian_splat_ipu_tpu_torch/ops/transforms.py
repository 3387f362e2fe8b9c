"""Camera and point transforms (torch, f32).

Port of gaussian_splat_ipu_tpu/ops/transforms.py with the same OpenGL
conventions: a right-handed lookAt with the camera looking down -z, a
glm::frustum perspective, and clip -> screen as (x/w * 0.5 + 0.5) * width
with no y flip. Matrices act on column vectors: p' = M @ p.

Functions that build a matrix from Python numbers take an explicit
`device`; angle arguments may also be 0-d tensors (the camera's env_rot).
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in f64 where it is f64 (the gradient tests run the
    plain projection in f64)."""
    return t.to(torch.promote_types(t.dtype, F32))


def look_at(eye, center, up, device=None) -> torch.Tensor:
    """Right-handed lookAt view matrix (glm::lookAt semantics)."""
    eye, center, up = (_t(v, device) for v in (eye, center, up))
    f = center - eye
    f = f / torch.linalg.vector_norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = torch.linalg.cross(s, f)
    zero = torch.zeros((), dtype=F32, device=eye.device)
    one = torch.ones((), dtype=F32, device=eye.device)
    return torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        torch.stack([zero, zero, zero, one]),
    ])


def look_at_bounding_box(bb_min, bb_max, up=(0.0, 1.0, 1.0), scale=1.0,
                         device=None) -> torch.Tensor:
    """Camera `scale` bounding-radii down +z looking at the box centroid
    (reference lookAtBoundingBox, src/splat/camera.cpp:10-15)."""
    bb_min, bb_max = _t(bb_min, device), _t(bb_max, device)
    center = (bb_min + bb_max) * 0.5
    radius = torch.linalg.vector_norm(bb_max - bb_min) * 0.5
    offset = torch.stack([torch.zeros_like(radius), torch.zeros_like(radius),
                          scale * radius])
    return look_at(center - offset, center, up, device=bb_min.device)


def frustum(left, right, bottom, top, near, far, device=None
            ) -> torch.Tensor:
    """glm::frustum-equivalent OpenGL perspective projection matrix."""
    l, r, b, t, n, f = (_t(v, device) for v in (left, right, bottom, top,
                                                near, far))
    zero = torch.zeros((), dtype=F32, device=l.device)
    return torch.stack([
        torch.stack([2 * n / (r - l), zero, (r + l) / (r - l), zero]),
        torch.stack([zero, 2 * n / (t - b), (t + b) / (t - b), zero]),
        torch.stack([zero, zero, -(f + n) / (f - n), -2 * f * n / (f - n)]),
        torch.stack([zero, zero, -torch.ones_like(zero), zero]),
    ])


def fit_frustum_to_bounding_box(bb_min, bb_max, fov_radians, aspect,
                                device=None) -> torch.Tensor:
    """Frustum fitted to a camera-space bounding box (reference
    fitFrustumToBoundingBox, src/splat/geometry.cpp:9-24): near =
    radius/tan(fov), far = near + 20*radius, half extents radius*(aspect,
    1)."""
    bb_min, bb_max = _t(bb_min, device), _t(bb_max, device)
    radius = torch.linalg.vector_norm(bb_max - bb_min) * 0.5
    near = radius / torch.tan(_t(fov_radians, bb_min.device))
    far = near + 20.0 * radius
    return frustum(-radius * aspect, radius * aspect, -radius, radius, near,
                   far, device=bb_min.device)


def perspective(fov_y_radians, aspect, near, far, device=None
                ) -> torch.Tensor:
    """Symmetric perspective projection (gluPerspective semantics)."""
    t = torch.tan(_t(fov_y_radians, device) * 0.5) * _t(near, device)
    return frustum(-t * aspect, t * aspect, -t, t, near, far, device=device)


def radians(degrees, device=None) -> torch.Tensor:
    """f32 degrees -> radians, the product jnp.radians computes."""
    return _t(degrees, device) * (math.pi / 180.0)


def _rotation(radians_, device, axis: str) -> torch.Tensor:
    a = (at_least_f32(radians_) if torch.is_tensor(radians_)
         else _t(radians_, device))
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    if axis == "x":
        rows = [[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]]
    else:
        rows = [[c, z, s, z], [z, o, z, z], [-s, z, c, z], [z, z, z, o]]
    return torch.stack([torch.stack(r) for r in rows])


def rotate_x(radians_, device=None) -> torch.Tensor:
    return _rotation(radians_, device, "x")


def rotate_y(radians_, device=None) -> torch.Tensor:
    return _rotation(radians_, device, "y")


def translate(v, device=None) -> torch.Tensor:
    v = _t(v, device)
    m = torch.eye(4, dtype=F32, device=v.device)
    m[:3, 3] = v
    return m


def transform_points(matrix: torch.Tensor, points: torch.Tensor
                     ) -> torch.Tensor:
    """Batched 4x4 transform of (N, 3|4) points, in full f32 (the
    reference asks XLA for HIGHEST precision; the port turns TF32 off), or
    f64 for f64 points."""
    points = at_least_f32(points)
    if points.shape[-1] == 3:
        points = torch.cat(
            [points, torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                                device=points.device)], dim=-1)
    return points @ matrix.T


def clip_to_screen(clip: torch.Tensor, width, height) -> torch.Tensor:
    """Perspective divide + viewport transform -> (N, 2) pixel coords
    (reference Viewport::clipSpaceToViewport: no y flip). The viewport
    scale is a product with Python floats, exact in f32 like the
    reference's f32 [width, height], and needs no host-to-device copy (a
    CUDA graph cannot capture one)."""
    w = clip[..., 3:4]
    xy = clip[..., 0:2] * (0.5 / w) + 0.5
    return torch.stack([xy[..., 0] * float(width),
                        xy[..., 1] * float(height)], dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) quaternions (w, x, y, z) -> (N, 3, 3) rotation matrices,
    normalised first."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)
