"""Joint camera-pose refinement: per-view SE(3) corrections optimised with
the scene (torch port of gaussian_splat_ipu_tpu/train/pose_opt.py).

A tangent delta d = (w, v) in R^6 per view corrects the view matrix as
view' = exp([w]x | v) @ view: a small rigid motion left-multiplied in
camera space. exp is the exact SO(3) Rodrigues map with Taylor guards at
theta -> 0 and the exact SE(3) V-matrix for the translation. The render is
differentiable in the view matrix, so the deltas need nothing else; each
view's delta is one row of a (V, 6) tensor that optax.adam's rule
(trainer.adam_apply) updates whole, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.train import trainer
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig


def _hat(w: torch.Tensor) -> torch.Tensor:
    """(3,) -> the 3x3 skew-symmetric [w]x."""
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([zero, -w[2], w[1],
                        w[2], zero, -w[0],
                        -w[1], w[0], zero]).view(3, 3)


def se3_exp(delta: torch.Tensor) -> torch.Tensor:
    """Exact SE(3) exponential of a (6,) tangent (w, v) -> (4, 4), with
    series below theta^2 = 1e-8, so the map and its gradient are exact and
    finite at the zero initialisation."""
    w, v = delta[:3], delta[3:]
    th2 = torch.dot(w, w)
    small = th2 < 1e-8
    # Double where: the branch not selected must also stay finite (and
    # have finite gradients) at theta -> 0, or its NaN poisons the
    # gradient of the whole where. A safe denominator is substituted
    # first.
    th2s = torch.where(small, 1.0, th2)
    th = torch.sqrt(th2s)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th2s * th))
    k = _hat(w)
    k2 = k @ k
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    r = eye + a * k + b * k2
    t = (eye + b * k + c * k2) @ v
    bottom = torch.eye(4, dtype=delta.dtype, device=delta.device)[3:]
    return torch.cat([torch.cat([r, t[:, None]], 1), bottom], 0)


def apply_delta(camera: Camera, delta: torch.Tensor) -> Camera:
    """Left-multiply the view by the exp of a (6,) tangent delta."""
    return Camera(se3_exp(delta) @ camera.view, camera.proj, camera.env_rot)


class PoseState(NamedTuple):
    deltas: torch.Tensor           # (V, 6) f32 tangent corrections
    opt_state: trainer.AdamState   # optax.adam's count, mu, nu

    def to_numpy(self) -> list:
        """The reference PoseState's leaves: deltas, Adam count, mu, nu."""
        return [x.detach().cpu().numpy()
                for x in (self.deltas, *self.opt_state)]


def init_pose_state(num_views: int, *, device) -> PoseState:
    """Zero deltas and a fresh Adam state."""
    deltas = torch.zeros((num_views, 6), dtype=torch.float32, device=device)
    return PoseState(deltas, trainer.init_adam(deltas))


def joint_step(state: trainer.TrainState, pstate: PoseState,
               view_idx: torch.Tensor, camera: Camera, target: torch.Tensor,
               raster_cfg: RasterConfig, train_cfg: trainer.TrainConfig,
               pose_lr: float):
    """One step optimising the scene and this view's pose delta, in place:
    (state, pstate, loss)."""
    from gaussian_splat_ipu_tpu_torch.train import aux_opt
    aux = aux_opt.AuxState(pose=pstate, exposure=None)
    loss = aux_opt.make_aux_step(raster_cfg, train_cfg, pose_lr=pose_lr)(
        state, aux, view_idx, camera, target, None, None)
    return state, pstate, loss


def corrected_cameras(cameras, deltas: torch.Tensor):
    """The learned deltas applied to a list of cameras (eval, export)."""
    return [apply_delta(cam, deltas[i]) for i, cam in enumerate(cameras)]
