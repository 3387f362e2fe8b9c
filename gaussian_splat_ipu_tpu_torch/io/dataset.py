"""Posed-image datasets in the transforms.json layouts (torch port of
gaussian_splat_ipu_tpu/io/dataset.py:36-169).

  * Blender / NeRF-synthetic: `camera_angle_x` and a per-frame
    `transform_matrix`, a camera-to-world in the OpenGL convention (the
    camera looks down -z, y up), images beside the json.
  * nerfstudio: `fl_x/fl_y/cx/cy/w/h` intrinsics in OpenCV pixels, per
    file or per frame, and the same OpenGL camera-to-world.

Each camera is converted once to the renderer's convention by
Camera.from_intrinsics: flip the y and z axes of the camera-to-world
(OpenGL -> OpenCV camera axes), invert, pass the pixel intrinsics. Images
decode top row first (the rendered array's orientation), as f32 in [0, 1]
on the host: through the native prefetcher when the port's host library is
built (io/native.py), else with PIL. Cameras are made on an explicit
device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.io import native
from gaussian_splat_ipu_tpu_torch.models.camera import Camera

# OpenGL camera axes (x right, y up, z backward) -> OpenCV camera axes
# (x right, y down, z forward): negate the y and z basis vectors.
_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


@dataclasses.dataclass
class FrameSet:
    """Posed images: lists indexed by frame."""

    cameras: List[Camera]
    images: List[np.ndarray]          # (H, W, C) f32 in [0, 1], C in {3, 4}
    width: int
    height: int

    def __len__(self) -> int:
        return len(self.cameras)

    def stacked(self, device):
        """(cameras, images) for view-batch training: one Camera whose view,
        proj and env_rot carry a leading frame axis (Camera.unbind gives
        the per-view cameras parallel/distributed.py's view-batch step
        takes), and the images as one (F, H, W, C) f32 tensor, both on
        `device`."""
        cams = Camera(*(torch.stack([getattr(c, k) for c in self.cameras])
                        .to(device) for k in ("view", "proj", "env_rot")))
        return cams, torch.from_numpy(np.stack(self.images)).to(device)


def _expand_channels(arr: np.ndarray) -> np.ndarray:
    """Decoded channel counts -> C in {3, 4}: gray -> RGB, gray + alpha
    (PNG colour type 4) -> RGBA."""
    c = arr.shape[-1]
    if c == 1:
        return np.repeat(arr, 3, axis=-1)
    if c == 2:
        return np.concatenate(
            [np.repeat(arr[..., :1], 3, axis=-1), arr[..., 1:]], axis=-1)
    return arr


def load_image(path: str, downscale: int):
    """(image f32 in [0, 1] with 3 or 4 channels, (W0, H0) before any
    resize). downscale > 1 shrinks by PIL's bilinear resize to the floor of
    each side over `downscale`."""
    from PIL import Image

    img = Image.open(path)
    orig = (img.width, img.height)
    if downscale > 1:
        img = img.resize((img.width // downscale, img.height // downscale),
                         Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return _expand_channels(arr), orig


def load_images(paths, downscale: int) -> list:
    """load_image's (image, (W0, H0)) for each path, in order. With the
    native library built, every path goes to an ImagePrefetcher up front
    (its workers decode while the earlier images are taken) and a file it
    rejects goes to load_image; at downscale > 1 its images are d x d block
    averages, not PIL's bilinear resize (the reference's two states)."""
    if not native.available():
        return [load_image(p, downscale) for p in paths]
    pf = native.ImagePrefetcher()
    try:
        jobs = [pf.submit(p, downscale) for p in paths]
        out = []
        for p, job in zip(paths, jobs):
            got = pf.fetch(job)
            out.append(load_image(p, downscale) if got is None
                       else (_expand_channels(got[0]), got[1]))
        return out
    finally:
        pf.close()


def load_transforms(path: str, downscale: int = 1,
                    max_frames: Optional[int] = None, near: float = 0.01,
                    far: float = 1000.0, *, device) -> FrameSet:
    """Load a transforms.json dataset (the file or its directory, where
    transforms.json is preferred to transforms_train.json)."""
    if os.path.isdir(path):
        for name in ("transforms.json", "transforms_train.json"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no transforms*.json under {path}")
    root = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if max_frames is not None:
        frames = frames[:max_frames]
    if not frames:
        raise ValueError(f"{path}: no frames")

    paths = []
    for fr in frames:
        img_path = os.path.join(root, fr["file_path"])
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"              # blender's bare stems
        paths.append(img_path)

    cameras, images = [], []
    width = height = None
    for fr, (img, (w0, h0)) in zip(frames, load_images(paths, downscale)):
        h, w = img.shape[:2]
        if width is None:
            width, height = w, h

        def field(name, default=None):
            return fr.get(name, meta.get(name, default))

        if field("fl_x") is not None:
            # The actual resize ratio, not 1 / downscale: the resize floors
            # each side, which moves the calibration by up to half a pixel.
            sx, sy = w / w0, h / h0
            fx = field("fl_x") * sx
            fy = field("fl_y", field("fl_x")) * sy
            cx = field("cx", w0 * 0.5) * sx
            cy = field("cy", h0 * 0.5) * sy
        else:
            cax = float(meta["camera_angle_x"])
            fx = fy = 0.5 * w / np.tan(0.5 * cax)
            cx, cy = w * 0.5, h * 0.5
        c2w = np.asarray(fr["transform_matrix"], np.float32)
        w2c_cv = np.linalg.inv(c2w @ _GL_TO_CV)
        cameras.append(Camera.from_intrinsics(fx, fy, cx, cy, w, h, w2c_cv,
                                              near, far, device=device))
        images.append(img)
    return FrameSet(cameras=cameras, images=images, width=width,
                    height=height)
