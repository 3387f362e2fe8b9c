"""COLMAP sparse reconstructions, the standard real-world 3DGS input (torch
port of gaussian_splat_ipu_tpu/io/colmap.py; numpy only, cameras on an
explicit device).

A sparse model is `cameras.bin/.txt` (intrinsics), `images.bin/.txt`
(per-view poses) and `points3D.bin/.txt` (the SfM cloud that seeds the
gaussians), in COLMAP's documented binary or text layout; both are read,
and `write_binary_model` writes the binary one. COLMAP's conventions are
the renderer's through Camera.from_intrinsics: pixel intrinsics with (0,
0) the top-left corner, the camera looking down +z with y down, and a
world-to-camera pose x_cam = R(q) @ x_world + t, q = (w, x, y, z).

Layout under the dataset root:

    root/sparse/0/{cameras,images,points3D}.{bin|txt}   (or root/sparse/)
    root/images/<image names from images.bin>
    root/images_{K}/...      # pre-downscaled copies, used as they are when
                             # downscale=K and the directory exists
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from gaussian_splat_ipu_tpu_torch.io.dataset import FrameSet, load_images
from gaussian_splat_ipu_tpu_torch.models.camera import Camera

log = logging.getLogger(__name__)

# COLMAP camera model ids -> (name, number of params). The params start
# with the pinhole block; the rest are distortion coefficients, which the
# pinhole renderer cannot apply (a warning, once per load).
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k
    3: ("RADIAL", 5),           # f, cx, cy, k1, k2
    4: ("OPENCV", 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: mid for mid, (name, _) in _CAMERA_MODELS.items()}
_SINGLE_FOCAL = ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE")


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    has_distortion: bool


class ColmapImage(NamedTuple):
    name: str
    qvec: np.ndarray     # (4,) w, x, y, z
    tvec: np.ndarray     # (3,)
    camera_id: int
    # The SfM track observations of this view, read only with
    # with_points2d=True: pixel xy (K, 2) and the point3D id of each (K,),
    # untriangulated (-1) entries dropped.
    xys: np.ndarray = np.zeros((0, 2), np.float64)
    point3d_ids: np.ndarray = np.zeros((0,), np.int64)


def _pinhole(model: str, params: np.ndarray) -> ColmapCamera:
    """The pinhole block of any COLMAP model's parameters."""
    if model in _SINGLE_FOCAL:
        f, cx, cy = params[0], params[1], params[2]
        fx = fy = f
        dist = params[3:]
    else:      # PINHOLE, the OPENCV family, FOV: fx fy cx cy [dist...]
        fx, fy, cx, cy = params[0], params[1], params[2], params[3]
        dist = params[4:]
    return ColmapCamera(model, 0, 0, float(fx), float(fy), float(cx),
                        float(cy), bool(np.any(np.abs(dist) > 1e-12)))


# -- binary: little-endian, u64 counts, NUL-terminated names ----------------

def _read(f, fmt: str):
    size = struct.calcsize("<" + fmt)     # "<": no native padding either
    data = f.read(size)
    if len(data) != size:
        raise EOFError("truncated COLMAP binary file")
    return struct.unpack("<" + fmt, data)


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * n_params))
            cams[cam_id] = _pinhole(name, params)._replace(
                width=int(width), height=int(height))
    return cams


def read_images_binary(path: str, with_points2d: bool = False
                       ) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "idddddddi")
            chars = bytearray()
            while True:
                (c,) = _read(f, "c")
                if c == b"\x00":
                    break
                chars += c
            (num_pts,) = _read(f, "Q")
            if with_points2d and num_pts:
                rec = np.frombuffer(f.read(24 * num_pts),
                                    dtype=[("xy", "<f8", 2), ("pid", "<i8")])
                keep = rec["pid"] >= 0
                xys, pids = rec["xy"][keep], rec["pid"][keep]
            else:
                f.seek(24 * num_pts, os.SEEK_CUR)   # (x, y, point3D_id)
                xys = np.zeros((0, 2), np.float64)
                pids = np.zeros((0,), np.int64)
            images[vals[0]] = ColmapImage(
                chars.decode("utf-8"), np.array(vals[1:5], np.float64),
                np.array(vals[5:8], np.float64), vals[8], xys, pids)
    return images


def read_points3d_binary(path: str
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xyz (N, 3) f32, rgb (N, 3) f32 in [0, 1], ids (N,) i64)."""
    xyzs, rgbs, ids = [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "qdddBBBd")
            ids.append(vals[0])
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            (track_len,) = _read(f, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)   # (image_id, point2D_idx)
    xyz = np.asarray(xyzs, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgbs, np.float32).reshape(-1, 3) / 255.0
    return xyz, rgb, np.asarray(ids, np.int64)


def write_binary_model(sparse_dir: str, cameras: dict, images: dict,
                       points: dict) -> None:
    """Write {cameras,images,points3D}.bin. cameras: id -> (model name,
    width, height, params); images: id -> (name, qvec, tvec, camera id,
    [(x, y, point3D id), ...]); points: id -> (xyz, rgb u8, [(image id,
    point2D index), ...]); track errors are written as 0."""
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam_id, (model, w, h, params) in cameras.items():
            f.write(struct.pack("<iiQQ", cam_id, _MODEL_IDS[model], w, h))
            f.write(struct.pack("<" + "d" * len(params), *params))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img_id, (name, q, t, cam_id, pts2d) in images.items():
            f.write(struct.pack("<idddddddi", img_id, *q, *t, cam_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(pts2d)))
            for x, y, pid in pts2d:
                f.write(struct.pack("<ddq", x, y, pid))
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, (xyz, rgb, track) in points.items():
            f.write(struct.pack("<qdddBBBd", pid, *xyz, *rgb, 0.0))
            f.write(struct.pack("<Q", len(track)))
            for im, p2 in track:
                f.write(struct.pack("<ii", im, p2))


# -- text -----------------------------------------------------------------

def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    for line in _data_lines(path):
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        if model not in _MODEL_IDS:
            raise ValueError(f"{path}: unknown camera model {model!r}")
        params = np.array([float(p) for p in parts[4:]])
        cams[cam_id] = _pinhole(model, params)._replace(
            width=int(parts[2]), height=int(parts[3]))
    return cams


def read_images_text(path: str, with_points2d: bool = False
                     ) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    pose_line = True
    image_id = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                continue            # comments take no slot...
            if pose_line:
                if not line:
                    continue        # ...nor do blanks between records
                parts = line.split()
                image_id = int(parts[0])
                images[image_id] = ColmapImage(
                    parts[9], np.array([float(v) for v in parts[1:5]]),
                    np.array([float(v) for v in parts[5:8]]), int(parts[8]))
            elif with_points2d and line:
                # Triplets "x y point3D_id"; -1 = untriangulated.
                vals = np.array(line.split(), np.float64).reshape(-1, 3)
                keep = vals[:, 2] >= 0
                images[image_id] = images[image_id]._replace(
                    xys=vals[keep, :2],
                    point3d_ids=vals[keep, 2].astype(np.int64))
            # The 2D-point line (maybe empty) always follows a pose line.
            pose_line = not pose_line
    return images


def read_points3d_text(path: str
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, ids = [], [], []
    for line in _data_lines(path):
        parts = line.split()
        ids.append(int(parts[0]))
        xyzs.append([float(v) for v in parts[1:4]])
        rgbs.append([float(v) for v in parts[4:7]])
    xyz = np.asarray(xyzs, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgbs, np.float32).reshape(-1, 3) / 255.0
    return xyz, rgb, np.asarray(ids, np.int64)


# -- the model and the capture -----------------------------------------------

def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> COLMAP (w, x, y, z) unit quaternion, w >= 0:
    the eigenvector of the largest eigenvalue of Bar-Itzhack's symmetric
    matrix (COLMAP's own rotmat2qvec), well defined at every angle."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = np.asarray(
        r, np.float64).flat
    k = np.array([
        [rxx - ryy - rzz, 0.0, 0.0, 0.0],
        [ryx + rxy, ryy - rxx - rzz, 0.0, 0.0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0.0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q if q[0] >= 0 else -q


def find_sparse_dir(root: str) -> str:
    """The sparse model's directory: root itself, root/sparse/0 or
    root/sparse."""
    for cand in (root, os.path.join(root, "sparse", "0"),
                 os.path.join(root, "sparse")):
        for ext in (".bin", ".txt"):
            if os.path.exists(os.path.join(cand, "cameras" + ext)):
                return cand
    raise FileNotFoundError(f"no COLMAP cameras.bin/.txt under {root}")


def is_colmap_dir(root: str) -> bool:
    try:
        find_sparse_dir(root)
        return True
    except FileNotFoundError:
        return False


def read_model(sparse_dir: str, with_points2d: bool = False):
    """(cameras, images, points xyz, points rgb, point ids); binary files
    are preferred to text ones."""
    def pick(stem):
        for ext in (".bin", ".txt"):
            p = os.path.join(sparse_dir, stem + ext)
            if os.path.exists(p):
                return p, ext == ".bin"
        raise FileNotFoundError(f"{sparse_dir}/{stem}.bin|.txt")

    cam_path, binary = pick("cameras")
    cams = (read_cameras_binary if binary else read_cameras_text)(cam_path)
    img_path, binary = pick("images")
    imgs = (read_images_binary if binary else read_images_text)(
        img_path, with_points2d=with_points2d)
    try:
        pts_path, binary = pick("points3D")
        xyz, rgb, pids = (read_points3d_binary if binary
                          else read_points3d_text)(pts_path)
    except FileNotFoundError:
        xyz = np.zeros((0, 3), np.float32)
        rgb = np.zeros((0, 3), np.float32)
        pids = np.zeros((0,), np.int64)
    return cams, imgs, xyz, rgb, pids


def load_colmap(root: str, downscale: int = 1,
                max_frames: Optional[int] = None, near: float = 0.01,
                far: float = 1000.0, images_dir: Optional[str] = None,
                with_depth: bool = False, *, device):
    """A COLMAP capture -> (FrameSet, sfm_xyz, sfm_rgb), frames sorted by
    image name.

    `root` is the capture directory (sparse/ and images/) or the sparse
    model's own directory. With downscale > 1 an `images_{downscale}/`
    directory is used as it is when it exists; otherwise the images are
    resized on load. The intrinsics are scaled to the decoded resolution.

    with_depth=True also returns, 4th, one (K_i, 3) f32 array per frame of
    sparse depth observations [u_px, v_px, z_cam]: each triangulated track
    the view observes, at the decoded resolution, in front of `near`."""
    root = os.path.abspath(root)
    sparse = find_sparse_dir(root)
    if sparse == root and not os.path.isdir(os.path.join(root, "images")):
        # root is the sparse model with no images/ of its own: the capture
        # is its parent, or its grandparent for sparse/0.
        parent = os.path.dirname(root)
        capture_root = (os.path.dirname(parent)
                        if os.path.basename(parent) == "sparse" else parent)
    else:
        capture_root = root

    cams, imgs, xyz, rgb, pids = read_model(sparse,
                                            with_points2d=with_depth)
    if with_depth and len(pids) == 0:
        log.warning("with_depth: %s has no points3D; the depth "
                    "observations are empty", sparse)
        imgs = {k: im._replace(xys=np.zeros((0, 2)),
                               point3d_ids=np.zeros((0,), np.int64))
                for k, im in imgs.items()}
    if with_depth:
        # point3D id -> row (ids are sparse and unordered).
        sort_idx = np.argsort(pids)
        pids_sorted = pids[sort_idx]

    resize = downscale
    if images_dir is None:
        images_dir = os.path.join(capture_root, "images")
        if downscale > 1:
            pre = os.path.join(capture_root, f"images_{downscale}")
            if os.path.isdir(pre):
                images_dir, resize = pre, 1
    if not os.path.isdir(images_dir):
        raise FileNotFoundError(f"image directory {images_dir} not found")

    order = sorted(imgs.values(), key=lambda im: im.name)
    if max_frames is not None:
        order = order[:max_frames]

    warned_distortion = False
    cameras: List[Camera] = []
    images: List[np.ndarray] = []
    depth_obs: List[np.ndarray] = []
    width = height = None
    decoded = load_images([os.path.join(images_dir, im.name)
                           for im in order], resize)
    for im, (arr, _) in zip(order, decoded):
        h, w = arr.shape[:2]
        if width is None:
            width, height = w, h
        elif (w, h) != (width, height):
            # Training stacks the targets at one size: say so here rather
            # than fail on a shape deep in the step.
            raise ValueError(
                f"mixed image resolutions in COLMAP capture: {im.name} "
                f"is {w}x{h}, first image was {width}x{height}")
        cam = cams[im.camera_id]
        if cam.has_distortion and not warned_distortion:
            log.warning("COLMAP model %s has distortion coefficients; the "
                        "pinhole renderer ignores them (undistort the "
                        "capture for exact reprojection)", cam.model)
            warned_distortion = True
        sx, sy = w / cam.width, h / cam.height
        w2c = np.eye(4, dtype=np.float64)
        w2c[:3, :3] = qvec_to_rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        cameras.append(Camera.from_intrinsics(
            cam.fx * sx, cam.fy * sy, cam.cx * sx, cam.cy * sy, w, h,
            w2c.astype(np.float32), near, far, device=device))
        images.append(arr)
        if with_depth:
            # z of R @ X + t (OpenCV camera, +z forward) of each observed
            # track; pixel xy scales with the decoded resolution.
            rows = np.searchsorted(pids_sorted, im.point3d_ids)
            valid = ((rows < len(pids_sorted))
                     & (pids_sorted[np.minimum(rows, len(pids_sorted) - 1)]
                        == im.point3d_ids))
            pts = xyz[sort_idx[rows[valid]]].astype(np.float64)
            z = (pts @ w2c[2, :3]) + w2c[2, 3]
            uv = im.xys[valid] * np.array([sx, sy])
            infront = z > near
            depth_obs.append(np.concatenate(
                [uv[infront], z[infront, None]], axis=1).astype(np.float32))
    if not cameras:
        raise ValueError(f"{root}: COLMAP model contains no images")
    fs = FrameSet(cameras=cameras, images=images, width=width,
                  height=height)
    if with_depth:
        return fs, xyz, rgb, depth_obs
    return fs, xyz, rgb
