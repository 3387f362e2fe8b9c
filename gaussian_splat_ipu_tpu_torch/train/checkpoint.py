"""Checkpoints and PLY export for training (torch port of
gaussian_splat_ipu_tpu/train/checkpoint.py).

A checkpoint is the reference's .npz layout: `leaf_{i}` for the leaves of
the TrainState pytree in JAX's flatten order (TrainState.to_numpy), so a
checkpoint written by either package restores in the other. PLY export
writes the standard 3DGS field set through io/scene.write_ply.
"""

from __future__ import annotations

import os

import numpy as np

from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.train.trainer import TrainState


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the state's leaves to an .npz, atomically (a crash never
    leaves a truncated checkpoint)."""
    arrays = {f"leaf_{i}": x for i, x in enumerate(state.to_numpy())}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Read a checkpoint into a TrainState on the template's device. The
    template (e.g. a fresh init_state) fixes the leaf count, shapes and
    dtypes the file must have."""
    want = template.to_numpy()
    with np.load(path) as data:
        if len(data.files) != len(want):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, the "
                             f"template {len(want)}: structure mismatch")
        leaves = [data[f"leaf_{i}"] for i in range(len(want))]
    for i, (got, ref) in enumerate(zip(leaves, want)):
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise ValueError(f"leaf {i}: {got.dtype}{got.shape} in the "
                             f"file, template {ref.dtype}{ref.shape}")
    return TrainState.from_numpy(leaves, template.params.device)


def export_ply(path: str, model: GaussianModel) -> None:
    """Write the parameters as a standard 3DGS PLY."""
    scene_io.write_ply(path, model)


def import_ply(path: str, *, device) -> GaussianModel:
    """Load a 3DGS PLY back into a GaussianModel, without the centring and
    flip of io/scene.load_scene."""
    fields = ply_io.gaussian_fields_from_ply(ply_io.read_ply(path))
    f_rest = fields.get("f_rest")
    degree = 0
    if f_rest is not None:
        degree = int(np.sqrt(f_rest.shape[1] + 1)) - 1
    return GaussianModel.create(
        fields["means"], fields["log_scales"], fields["quats"],
        fields["opacity"], fields["f_dc"], f_rest, degree, device=device)
