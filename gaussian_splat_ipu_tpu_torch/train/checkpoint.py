"""Checkpoints and PLY export for training (torch port of
gaussian_splat_ipu_tpu/train/checkpoint.py).

A checkpoint is the reference's .npz layout: `leaf_{i}` for the leaves of
the saved pytree in JAX's flatten order, so a checkpoint written by either
package restores in the other. The payload is a TrainState (its 22
leaves, TrainState.to_numpy), or a (TrainState, DensifyState) pair (26
leaves: grad_sum, vis_count, alive, key after the state's), or a
(TrainState, AuxState) pair (each active module's deltas or mats, Adam
count, mu and nu). PLY export writes the standard 3DGS field set through
io/scene.write_ply.
"""

from __future__ import annotations

import os

import numpy as np

from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
from gaussian_splat_ipu_tpu_torch.io import scene as scene_io
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.train.trainer import TrainState


def payload_leaves(payload) -> list:
    """A payload's leaves as numpy, in the reference's flatten order."""
    if isinstance(payload, TrainState):
        return payload.to_numpy()
    state, extra = payload
    return state.to_numpy() + extra.to_numpy()


def save_checkpoint(path: str, payload) -> None:
    """Write the payload's leaves to an .npz, atomically (a crash never
    leaves a truncated checkpoint)."""
    arrays = {f"leaf_{i}": x for i, x in enumerate(payload_leaves(payload))}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore_checkpoint(path: str, template):
    """Read a checkpoint into a payload shaped as `template` (a TrainState
    or a (TrainState, DensifyState | AuxState) pair, whose second state
    rebuilds itself with from_numpy_like) on the template's
    device. The template (e.g. fresh states) fixes the leaf count, shapes
    and dtypes the file must have."""
    want = payload_leaves(template)
    with np.load(path) as data:
        if len(data.files) != len(want):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, the "
                             f"template {len(want)}: structure mismatch")
        leaves = [data[f"leaf_{i}"] for i in range(len(want))]
    for i, (got, ref) in enumerate(zip(leaves, want)):
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise ValueError(f"leaf {i}: {got.dtype}{got.shape} in the "
                             f"file, template {ref.dtype}{ref.shape}")
    if isinstance(template, TrainState):
        return TrainState.from_numpy(leaves, template.params.device)
    state, extra = template
    dev = state.params.device
    n = len(state.to_numpy())
    return (TrainState.from_numpy(leaves[:n], dev),
            extra.from_numpy_like(leaves[n:], dev))


def gaussian_columns(model: GaussianModel) -> dict:
    """The standard 3DGS PLY column set in file order: io/scene's
    gaussian_columns, under the reference's name for it here."""
    return scene_io.gaussian_columns(model)


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
