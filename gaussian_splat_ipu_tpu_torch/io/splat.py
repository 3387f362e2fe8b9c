"""The web-viewer `.splat` format, antimatter15/splat's convention (torch
port of gaussian_splat_ipu_tpu/io/splat.py; numpy only).

A flat array of 32-byte records:

    position  3 x f32   world-space mean
    scale     3 x f32   linear per-axis scale (exp of log_scales)
    color     4 x u8    RGB = SH_C0 * f_dc + 0.5 in [0, 1] -> u8,
                        A = sigmoid(opacity) -> u8
    rotation  4 x u8    normalised quaternion (w, x, y, z), each
                        component mapped to q * 128 + 128

Colour and rotation are u8, so a PLY -> .splat -> PLY round trip is lossy
by design (about 1/255 in colour, 1/128 per quaternion component), and
higher-order SH bands are dropped on write.
"""

from __future__ import annotations

import os

import numpy as np

from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.ops.sh import SH_C0

RECORD_BYTES = 32
_DTYPE = np.dtype([
    ("position", "<f4", (3,)),
    ("scale", "<f4", (3,)),
    ("color", "u1", (4,)),
    ("rot", "u1", (4,)),
])
assert _DTYPE.itemsize == RECORD_BYTES


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def write_splat(path: str, model: GaussianModel,
                sort_by_importance: bool = True) -> None:
    """Write the model as .splat records. sort_by_importance orders them by
    opacity x volume, largest first, as web viewers expect (big splats
    show first while the file streams in)."""
    p = model.to_numpy()
    n = model.num_gaussians
    rec = np.empty(n, _DTYPE)
    rec["position"] = p["means"]
    scales = np.exp(p["log_scales"])
    rec["scale"] = scales
    rgb = np.clip(SH_C0 * p["sh"][:, 0] + 0.5, 0.0, 1.0)
    alpha = _sigmoid(p["opacities"])
    rec["color"] = (np.concatenate([rgb, alpha[:, None]], -1)
                    * 255.0 + 0.5).astype(np.uint8)
    q = p["quats"]
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    rec["rot"] = np.clip(q * 128.0 + 128.0, 0.0, 255.0).astype(np.uint8)
    if sort_by_importance and n:
        importance = alpha * scales.prod(-1)
        rec = rec[np.argsort(-importance, kind="stable")]
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def count_records(path: str) -> int:
    return os.path.getsize(path) // RECORD_BYTES


def read_splat(path: str, row_range=None) -> dict:
    """The records of a .splat file as the loader's field dict (means,
    log_scales, quats, opacity, f_dc: io/ply.load_points' contract).
    row_range=(lo, hi) reads only those records, with one seek."""
    size = os.path.getsize(path)
    if size % RECORD_BYTES:
        raise ValueError(f"{path}: size {size} is not a multiple of "
                         f"{RECORD_BYTES}: not a .splat file?")
    count = size // RECORD_BYTES
    lo, hi = (0, count) if row_range is None else row_range
    if lo < 0 or hi < lo:
        raise ValueError(f"bad row_range {row_range}")
    hi = min(hi, count)
    lo = min(lo, hi)
    with open(path, "rb") as f:
        f.seek(lo * RECORD_BYTES)
        rec = np.frombuffer(f.read((hi - lo) * RECORD_BYTES), _DTYPE)
    color = rec["color"].astype(np.float32) / 255.0
    eps = 1.0 / 510.0     # half a quantisation step keeps the logit finite
    alpha = np.clip(color[:, 3], eps, 1.0 - eps)
    return {
        "means": rec["position"].astype(np.float32),
        "log_scales": np.log(np.maximum(rec["scale"], 1e-12)),
        "quats": (rec["rot"].astype(np.float32) - 128.0) / 128.0,
        "opacity": np.log(alpha / (1.0 - alpha)),
        "f_dc": (color[:, :3] - 0.5) / SH_C0,
    }
