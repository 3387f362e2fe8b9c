"""Composable auxiliary training objectives: pose + exposure + depth (torch
port of gaussian_splat_ipu_tpu/train/aux_opt.py).

One step over any subset of the three modules: the pose delta corrects the
camera first, the corrected camera drives both the photometric render and
the depth residuals, and the exposure map sits on the loss side only. A
module that is off (None in AuxState) costs nothing and holds no leaves,
so a (TrainState, AuxState) checkpoint has the reference's leaves.

Spans (utils/profiling.py), besides every step kind's: "pose" (the
delta's se3_exp and the corrected camera) and "exposure" (the affine map
on the image), both inside "render", and "aux.adam" (the deltas' and the
maps' Adam steps) after "adam". The view's gradient comes from kernel
G-bwd (render/projection.py), as the model's does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.render.pipeline import render_image
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
from gaussian_splat_ipu_tpu_torch.train import (appearance, depth, pose_opt,
                                                trainer)
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

STEP_PROGRAM = "aux_step"


class AuxState(NamedTuple):
    """The per-module states; None = the module is off."""

    pose: Optional[pose_opt.PoseState]
    exposure: Optional[appearance.ExposureState]

    def to_numpy(self) -> list:
        """The reference AuxState's leaves: each active module's in field
        order (deltas or mats, then Adam count, mu, nu)."""
        return [x for m in self if m is not None for x in m.to_numpy()]

    @classmethod
    def from_numpy(cls, leaves, device, pose: bool,
                   exposure: bool) -> "AuxState":
        """Inverse of to_numpy for the given active modules."""
        it = iter(leaves)

        def take():
            value, count, mu, nu = (next(it) for _ in range(4))
            f32 = [torch.tensor(np.asarray(x, np.float32), device=device)
                   for x in (value, mu, nu)]
            return f32[0], trainer.AdamState(
                torch.tensor(np.asarray(count, np.int32), device=device),
                f32[1], f32[2])

        out = cls(pose_opt.PoseState(*take()) if pose else None,
                  appearance.ExposureState(*take()) if exposure else None)
        if next(it, None) is not None:
            raise ValueError("more leaves than the AuxState holds")
        return out

    def from_numpy_like(self, leaves, device) -> "AuxState":
        """from_numpy with this state's active modules."""
        return AuxState.from_numpy(leaves, device,
                                   pose=self.pose is not None,
                                   exposure=self.exposure is not None)


def init_aux_state(num_views: int, pose_lr: float = 0.0,
                   exposure_lr: float = 0.0, *, device) -> AuxState:
    return AuxState(
        pose=(pose_opt.init_pose_state(num_views, device=device)
              if pose_lr > 0 else None),
        exposure=(appearance.init_exposure_state(num_views, device=device)
                  if exposure_lr > 0 else None))


def make_aux_step(raster_cfg: RasterConfig, train_cfg: trainer.TrainConfig,
                  pose_lr: float = 0.0, exposure_lr: float = 0.0,
                  depth_weight: float = 0.0):
    """step(state, aux, view_idx, camera, target, obs, mask) -> loss,
    optimising the scene and every active module in place. view_idx is a
    () integer tensor; obs / mask are the view's depth observations (unused
    when depth_weight == 0). The deltas and maps are gradient_step's
    leaves, their gradients each module's own Adam step."""
    def step(state: trainer.TrainState, aux: AuxState,
             view_idx: torch.Tensor, camera: Camera, target: torch.Tensor,
             obs: Optional[torch.Tensor],
             mask: Optional[torch.Tensor]) -> torch.Tensor:
        params = state.params
        dev = params.device
        leaves, cam = [], camera
        with profiling.span("render", dev):
            if pose_lr > 0:
                with profiling.span("pose", dev):
                    deltas = aux.pose.deltas.detach().requires_grad_()
                    leaves.append(deltas)
                    cam = pose_opt.apply_delta(
                        camera, trainer.select_row(deltas, view_idx))
            image = render_image(params, cam, raster_cfg)
            if exposure_lr > 0:
                with profiling.span("exposure", dev):
                    mats = aux.exposure.mats.detach().requires_grad_()
                    leaves.append(mats)
                    image = appearance.apply_exposure(
                        image, trainer.select_row(mats, view_idx))
        # The depth residuals use the pose-corrected camera.
        loss = trainer.image_loss(image, target, train_cfg, (
            lambda: depth_weight * depth.sparse_depth_loss(
                params, cam, obs, mask, raster_cfg))
            if depth_weight > 0.0 else None)
        rest = iter(trainer.gradient_step(state, loss, train_cfg, leaves))
        with profiling.span("aux.adam", dev):
            if pose_lr > 0:
                trainer.adam_apply(aux.pose.deltas, next(rest),
                                   aux.pose.opt_state, pose_lr)
            if exposure_lr > 0:
                trainer.adam_apply(aux.exposure.mats, next(rest),
                                   aux.exposure.opt_state, exposure_lr)
        return loss.detach()

    return step


def dummy_depth_obs(num_views: int = 1, *, device):
    """One-row placeholders per view for the observations when depth is
    off: ((V, 1, 3) zeros, (V, 1) False)."""
    return (torch.zeros((num_views, 1, 3), dtype=torch.float32,
                        device=device),
            torch.zeros((num_views, 1), dtype=torch.bool, device=device))


def step_program(state: trainer.TrainState, aux: AuxState,
                 obs_all: torch.Tensor, mask_all: torch.Tensor,
                 raster_cfg: RasterConfig, train_cfg: trainer.TrainConfig,
                 pose_lr: float = 0.0, exposure_lr: float = 0.0,
                 depth_weight: float = 0.0):
    """The aux step as trainer.register_view_step's (program, inputs),
    fn(state, aux, view_idx, camera, target, obs_all, mask_all) -> loss:
    the () view index picks the view's delta, exposure map and packed
    observations inside the program."""
    step = make_aux_step(raster_cfg, train_cfg, pose_lr, exposure_lr,
                         depth_weight)
    return trainer.per_view_program(step, pass_view=True), (
        lambda vi, cam, tgt: (state, aux, vi, cam, tgt, obs_all, mask_all))


def register_step(engine: RenderEngine, state: trainer.TrainState,
                  aux: AuxState, view_idx: torch.Tensor, camera: Camera,
                  target: torch.Tensor, obs_all: torch.Tensor,
                  mask_all: torch.Tensor, raster_cfg: RasterConfig,
                  train_cfg: trainer.TrainConfig, pose_lr: float = 0.0,
                  exposure_lr: float = 0.0, depth_weight: float = 0.0,
                  name: str = STEP_PROGRAM):
    """Register step_program on `engine` (trainer.register_view_step)."""
    return trainer.register_view_step(
        engine, name, *step_program(state, aux, obs_all, mask_all,
                                    raster_cfg, train_cfg, pose_lr,
                                    exposure_lr, depth_weight),
        camera, target, view_idx)
