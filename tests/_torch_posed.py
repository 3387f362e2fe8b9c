"""Posed-image sets written from a seed for the port's dataset tests:
OpenCV orbit poses, COLMAP sparse models (binary through the port's
io/colmap.write_binary_model, text written here) and transforms.json sets
(blender and nerfstudio), with PNGs written by PIL."""

import json
import os

import numpy as np
from PIL import Image

from gaussian_splat_ipu_tpu_torch.io.colmap import (rotmat_to_qvec,
                                                   write_binary_model)

_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


def orbit_w2c(n, radius=3.0, height=0.6, center=(0.0, 0.0, 0.0)):
    """n OpenCV world-to-camera (4, 4) poses on a circle around `center`,
    each looking at it (z forward, y down)."""
    center = np.asarray(center, np.float64)
    out = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        eye = center + np.array([radius * np.sin(a), -height,
                                 radius * np.cos(a)])
        z = center - eye
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 1.0, 0.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        w2c = np.eye(4)
        w2c[:3, :3] = np.stack([x, y, z])
        w2c[:3, 3] = -w2c[:3, :3] @ eye
        out.append(w2c)
    return out


def save_png(path, image):
    """f32 [0, 1] (H, W, C) or u8 -> PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    Image.fromarray(img).save(path)


def write_text_model(sparse_dir, cameras, images, points):
    """The text layout of the same dicts write_binary_model takes."""
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for cam_id, (model, w, h, params) in cameras.items():
            f.write(f"{cam_id} {model} {w} {h} "
                    + " ".join(repr(float(p)) for p in params) + "\n")
    with open(os.path.join(sparse_dir, "images.txt"), "w") as f:
        f.write("# Image list: two lines per image\n\n")
        for img_id, (name, q, t, cam_id, pts2d) in images.items():
            f.write(f"{img_id} " + " ".join(repr(float(v)) for v in q) + " "
                    + " ".join(repr(float(v)) for v in t)
                    + f" {cam_id} {name}\n")
            f.write(" ".join(f"{float(x)!r} {float(y)!r} {pid}"
                             for (x, y, pid) in pts2d) + "\n")
    with open(os.path.join(sparse_dir, "points3D.txt"), "w") as f:
        f.write("# 3D points\n")
        for pid, (xyz, rgb, track) in points.items():
            f.write(f"{pid} " + " ".join(repr(float(v)) for v in xyz) + " "
                    + " ".join(str(int(v)) for v in rgb) + " 0.0 "
                    + " ".join(f"{im} {p2}" for (im, p2) in track) + "\n")


def write_colmap(root, images, w2cs, intrinsics, xyz, rgb_u8, *,
                 binary=True, layout="sparse0", models=None, pts2d=None):
    """A COLMAP capture under root: images (list of arrays) as
    images/view_XXX.png, one camera per view (model name, params) from
    `intrinsics` [(fx, fy, cx, cy)] unless `models` gives [(name, params)],
    the poses, and the points (ids 1..N, with a track on view 1)."""
    sub = {"sparse0": os.path.join("sparse", "0"), "sparse": "sparse",
           "flat": "."}[layout]
    sparse = os.path.join(root, sub)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    h, w = np.asarray(images[0]).shape[:2]
    cams, imgs = {}, {}
    for i, (img, w2c) in enumerate(zip(images, w2cs)):
        name = f"view_{i:03d}.png"
        save_png(os.path.join(root, "images", name), img)
        model = (models[i] if models is not None
                 else ("PINHOLE", list(intrinsics[i])))
        cams[i + 1] = (model[0], w, h, list(model[1]))
        imgs[i + 1] = (name, rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3],
                       i + 1, [] if pts2d is None else pts2d[i])
    points = {k + 1: (tuple(float(v) for v in xyz[k]),
                      tuple(int(v) for v in rgb_u8[k]), [(1, 0)])
              for k in range(len(xyz))}
    (write_binary_model if binary else write_text_model)(
        sparse, cams, imgs, points)
    return root


def project_tracks(xyz, w2cs, intrinsics, width, height):
    """Per view, the SfM points it observes as COLMAP 2D points (x, y,
    point id): each point projected by the pinhole camera, kept where it
    lies in front of the camera and inside the frame."""
    out = []
    for w2c, (fx, fy, cx, cy) in zip(w2cs, intrinsics):
        cam = np.asarray(xyz, np.float64) @ w2c[:3, :3].T + w2c[:3, 3]
        z = cam[:, 2]
        u = fx * cam[:, 0] / np.maximum(z, 1e-9) + cx
        v = fy * cam[:, 1] / np.maximum(z, 1e-9) + cy
        seen = (z > 0.01) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        out.append([(u[k], v[k], k + 1) for k in np.nonzero(seen)[0]])
    return out


def write_transforms(root, images, w2cs, *, kind="blender", fov_x=0.9,
                     intrinsics=None, name="transforms.json", stem="r"):
    """A transforms.json set: blender (camera_angle_x, bare stems) or
    nerfstudio (top-level fl_x/fl_y/cx/cy, or per-frame `intrinsics`)."""
    os.makedirs(root, exist_ok=True)
    frames = []
    for i, (img, w2c) in enumerate(zip(images, w2cs)):
        file = f"{stem}_{i}"
        save_png(os.path.join(root, file + ".png"), img)
        c2w_gl = np.linalg.inv(w2c) @ _GL_TO_CV
        fr = {"file_path": file if kind == "blender" else file + ".png",
              "transform_matrix": c2w_gl.tolist()}
        if kind == "nerfstudio" and intrinsics is not None:
            fx, fy, cx, cy = intrinsics[i]
            fr.update(fl_x=fx, fl_y=fy, cx=cx, cy=cy)
        frames.append(fr)
    h, w = np.asarray(images[0]).shape[:2]
    meta = {"frames": frames}
    if kind == "blender":
        meta["camera_angle_x"] = fov_x
    elif intrinsics is None:
        meta.update(fl_x=0.6 * w, fl_y=0.62 * w, cx=0.5 * w + 1.5,
                    cy=0.5 * h - 0.5, w=w, h=h)
    with open(os.path.join(root, name), "w") as f:
        json.dump(meta, f)
    return root
