"""Per-view appearance (exposure) compensation, optimised with the scene
(torch port of gaussian_splat_ipu_tpu/train/appearance.py).

A per-view affine colour map is applied to the RENDERED image before the
loss:

    rgb' = M @ rgb + b        M: (3, 3) init I,  b: (3,) init 0

It sits on the loss side only: exports and eval render the raw scene, so
it soaks up per-shot exposure drift without leaking into the geometry.
The (HW, 3) x (3, 3) product is a small einsum (the reference computes it
outside any Pallas kernel); the (V, 3, 4) [M | b] tensor is updated whole
by optax.adam's rule (trainer.adam_apply).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.train import trainer
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig


class ExposureState(NamedTuple):
    mats: torch.Tensor             # (V, 3, 4) [M | b] per view
    opt_state: trainer.AdamState   # optax.adam's count, mu, nu

    def to_numpy(self) -> list:
        """The reference ExposureState's leaves: mats, Adam count, mu,
        nu."""
        return [x.detach().cpu().numpy() for x in (self.mats,
                                                   *self.opt_state)]


def identity_mats(num_views: int, *, device) -> torch.Tensor:
    """(V, 3, 4) identity maps [I | 0]."""
    eye = torch.eye(3, 4, dtype=torch.float32, device=device)
    return eye[None].repeat(num_views, 1, 1)


def init_exposure_state(num_views: int, *, device) -> ExposureState:
    """Identity maps and a fresh Adam state."""
    mats = identity_mats(num_views, device=device)
    return ExposureState(mats, trainer.init_adam(mats))


def apply_exposure(image: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """The affine colour map of a (3, 4) [M | b] on the RGB channels of an
    (H, W, C >= 3) image; extra channels (alpha) pass through."""
    out = torch.einsum("ij,hwj->hwi", mat[:, :3], image[..., :3]) + mat[:, 3]
    if image.shape[-1] > 3:
        out = torch.cat([out, image[..., 3:]], dim=-1)
    return out


def joint_step(state: trainer.TrainState, estate: ExposureState,
               view_idx: torch.Tensor, camera: Camera, target: torch.Tensor,
               raster_cfg: RasterConfig, train_cfg: trainer.TrainConfig,
               exposure_lr: float):
    """One step optimising the scene and this view's exposure map, in
    place: (state, estate, loss)."""
    from gaussian_splat_ipu_tpu_torch.train import aux_opt
    aux = aux_opt.AuxState(pose=None, exposure=estate)
    loss = aux_opt.make_aux_step(raster_cfg, train_cfg,
                                 exposure_lr=exposure_lr)(
        state, aux, view_idx, camera, target, None, None)
    return state, estate, loss
