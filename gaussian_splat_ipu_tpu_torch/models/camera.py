"""Camera state passed to the renderer each frame (torch port of
gaussian_splat_ipu_tpu/models/camera.py): a (4, 4) view matrix, a (4, 4)
projection and a (2,) environment rotation, all f32 on one device."""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.ops import transforms


class Camera:
    """View + projection for one frame."""

    def __init__(self, view: torch.Tensor, proj: torch.Tensor,
                 env_rot: torch.Tensor | None = None):
        self.view = view
        self.proj = proj
        # Environment rotation (x, y) radians of the SH view directions;
        # zero = unrotated.
        self.env_rot = (torch.zeros((2,), dtype=torch.float32,
                                    device=view.device)
                        if env_rot is None
                        else torch.as_tensor(env_rot, dtype=torch.float32,
                                             device=view.device))

    def unbind(self) -> tuple:
        """The per-frame cameras of a camera whose tensors carry a leading
        frame axis (FrameSet.stacked), as the view-batch step takes them
        (parallel/distributed.make_view_batch_train_step)."""
        return tuple(Camera(v, p, e) for v, p, e in zip(
            self.view, self.proj, self.env_rot))

    def to(self, device, non_blocking: bool = False) -> "Camera":
        return Camera(self.view.to(device, non_blocking=non_blocking),
                      self.proj.to(device, non_blocking=non_blocking),
                      self.env_rot.to(device, non_blocking=non_blocking))

    @property
    def view_proj(self) -> torch.Tensor:
        """proj @ view, as four f32 products summed in order, one op at a
        time: the same bits on the CPU and on CUDA (a matmul sums in
        another order on each)."""
        out = self.proj[:, 0:1] * self.view[0:1, :]
        for k in range(1, 4):
            out = out + self.proj[:, k:k + 1] * self.view[k:k + 1, :]
        return out

    def focals(self, width: int, height: int):
        """Pixel focal lengths and fov tangents from the projection:
        focal = proj[0,0]*W/2, tan(half fov) = 1/proj[0,0]."""
        fx = self.proj[0, 0] * (width * 0.5)
        fy = self.proj[1, 1] * (height * 0.5)
        tan_fovx = 1.0 / self.proj[0, 0]
        tan_fovy = 1.0 / self.proj[1, 1]
        return fx, fy, tan_fovx, tan_fovy

    @property
    def cam_origin(self) -> torch.Tensor:
        """Camera position in world space (for SH view directions)."""
        r = self.view[:3, :3]
        t = self.view[:3, 3]
        return -(r.T @ t)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_numpy(cls, view, proj, env_rot=None, *, device) -> "Camera":
        """Camera from (4, 4) numpy view/proj matrices (and an optional (2,)
        env rotation), so that both packages render the same camera."""
        def t(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)
        return cls(t(view), t(proj), None if env_rot is None else t(env_rot))

    @classmethod
    def look_at(cls, eye, center, up, fov_y_radians: float, aspect: float,
                near: float = 0.01, far: float = 1000.0, *,
                device) -> "Camera":
        """Free camera: look-at view + symmetric perspective frustum."""
        view = transforms.look_at(eye, center, up, device=device)
        proj = transforms.perspective(fov_y_radians, aspect, near, far,
                                      device=device)
        return cls(view, proj)

    @classmethod
    def from_intrinsics(cls, fx, fy, cx, cy, width: int, height: int, w2c,
                        near: float = 0.01, far: float = 1000.0, *,
                        device) -> "Camera":
        """Pinhole camera from OpenCV/COLMAP intrinsics (pixels, origin at
        the top-left, v down) and a (4, 4) OpenCV world->camera transform:
        u = fx*X/Z + cx lands at rendered pixel (u, v), row 0 on top."""
        w2c = torch.tensor(np.asarray(w2c, np.float32), device=device)
        flip = torch.tensor([[1.0], [1.0], [-1.0], [1.0]],
                            dtype=torch.float32, device=device)
        view = w2c * flip
        w, h = float(width), float(height)
        proj = torch.tensor([
            [2.0 * fx / w, 0.0, 1.0 - 2.0 * cx / w, 0.0],
            [0.0, 2.0 * fy / h, 1.0 - 2.0 * cy / h, 0.0],
            [0.0, 0.0, -(far + near) / (far - near),
             -2.0 * far * near / (far - near)],
            [0.0, 0.0, -1.0, 0.0],
        ], dtype=torch.float32, device=device)
        return cls(view, proj)

    @classmethod
    def orbit(cls, bb_min, bb_max, fov_radians: float, aspect: float,
              rot_x_deg=0.0, rot_y_deg=0.0, translation=(0.0, 0.0, 0.0),
              up=(0.0, 1.0, 1.0), env_rot=None, *, device) -> "Camera":
        """Orbit camera around a scene bounding box: lookAtBoundingBox,
        then rotate about x and y, then translate (reference
        src/main/splat.cpp:186-195, 312-314)."""
        base = transforms.look_at_bounding_box(bb_min, bb_max, up,
                                               device=device)
        view = base @ transforms.rotate_x(
            transforms.radians(rot_x_deg, device), device)
        view = view @ transforms.rotate_y(
            transforms.radians(rot_y_deg, device), device)
        view = view @ transforms.translate(translation, device)
        corners = torch.stack([
            torch.as_tensor(bb_min, dtype=torch.float32, device=device),
            torch.as_tensor(bb_max, dtype=torch.float32, device=device)])
        eye = transforms.transform_points(base, corners)[:, :3]
        proj = transforms.fit_frustum_to_bounding_box(eye[0], eye[1],
                                                      fov_radians, aspect)
        return cls(view, proj, env_rot)
