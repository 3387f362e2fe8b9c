"""Scene assembly: file -> GaussianModel + world bounds (torch port of
gaussian_splat_ipu_tpu/io/scene.py). Parsing is the port's io/ply.py;
this module builds the port's model on an explicit device."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel


@dataclasses.dataclass
class Scene:
    model: GaussianModel
    bb_min: np.ndarray
    bb_max: np.ndarray
    # The whole scene's row count when `model` holds one process's slice
    # (parallel/multihost.load_scene_sharded); None: the model's own.
    num_rows: Optional[int] = None

    @property
    def num_gaussians(self) -> int:
        return self.model.num_gaussians


def assemble_scene(fields, center: bool = True, flip_z: bool = True,
                   sh_degree: int = 0, default_log_scale: float = -4.0,
                   center_point=None, *, device) -> Scene:
    """Build a Scene from a parsed field dict (io/ply.load_points): centre
    on the bounding-box midpoint (or `center_point`), flip z, and give
    plain xyz clouds dim grey isotropic gaussians (reference
    src/main/splat.cpp:86-163)."""
    means = fields["means"].astype(np.float32)
    if center:
        if center_point is None:
            center_point = (means.min(0) + means.max(0)) * 0.5
        means = means - np.asarray(center_point, np.float32)
    if flip_z:
        means = means.copy()
        means[:, 2] = -means[:, 2]
    n = means.shape[0]

    if "f_dc" in fields:
        f_dc = fields["f_dc"]
        opacity = fields["opacity"]
        log_scales = fields["log_scales"]
        quats = fields["quats"]
    else:
        f_dc = np.full((n, 3), (0.05 - 0.5) / 0.28209479177387814,
                       np.float32)
        opacity = np.full((n,), 6.0, np.float32)
        log_scales = np.full((n, 3), default_log_scale, np.float32)
        quats = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))

    f_rest = fields.get("f_rest")
    if f_rest is not None and sh_degree == 0:
        sh_degree = int(np.sqrt(f_rest.shape[1] + 1)) - 1

    model = GaussianModel.create(means, log_scales, quats, opacity, f_dc,
                                 f_rest, sh_degree, device=device)
    if n == 0:
        return Scene(model, np.full(3, np.inf, np.float32),
                     np.full(3, -np.inf, np.float32))
    return Scene(model, means.min(0), means.max(0))


def load_scene(path: str, center: bool = True, flip_z: bool = True,
               sh_degree: int = 0, default_log_scale: float = -4.0, *,
               device) -> Scene:
    """Load a .ply, .xyz or .splat scene and assemble it on `device`."""
    return assemble_scene(ply_io.load_points(path), center, flip_z,
                          sh_degree, default_log_scale, device=device)


def write_ply(path: str, model: GaussianModel) -> None:
    """Write the model as a standard 3DGS binary PLY."""
    ply_io.write_ply(path, gaussian_columns(model))


def gaussian_columns(model: GaussianModel) -> dict:
    """The model's standard 3DGS PLY columns, in file order (f_dc + f_rest
    channel-major, opacity and scales raw, quats w-first)."""
    p = model.to_numpy()
    cols = {"x": p["means"][:, 0], "y": p["means"][:, 1],
            "z": p["means"][:, 2]}
    for i in range(3):
        cols[f"f_dc_{i}"] = p["sh"][:, 0, i]
    rest = p["sh"][:, 1:].transpose(0, 2, 1).reshape(len(p["sh"]), -1)
    for i in range(rest.shape[1]):
        cols[f"f_rest_{i}"] = rest[:, i]
    cols["opacity"] = p["opacities"]
    for i in range(3):
        cols[f"scale_{i}"] = p["log_scales"][:, i]
    for i in range(4):
        cols[f"rot_{i}"] = p["quats"][:, i]
    return cols
