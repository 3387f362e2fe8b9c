"""Sparse-depth supervision from SfM track observations (torch port of
gaussian_splat_ipu_tpu/train/depth.py).

COLMAP triangulates a sparse depth wherever a track is observed; the loss
holds the rendered mean depth (render/pipeline.py::render_depth, kernels C
and D on the (depth, depth^2, 0) colour rows) to it at those pixels:

    mean over valid observations of  |D(u, v) - z| / z

gated on rendered alpha > 0.5 at the pixel. The observations of every view
stay on the device as one (V, K, 3) [u, v, z] tensor and a (V, K) mask; a
captured step picks its view's rows with a () view-index tensor copied in
per step (trainer.select_row), the reference's `obs_all[k]`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.pipeline import render_depth
from gaussian_splat_ipu_tpu_torch.train import trainer
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig


def pack_observations(depth_obs: List[np.ndarray], max_per_view: int = 4096,
                      *, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-view (K_i, 3) arrays -> ((V, K, 3) f32, (V, K) bool mask) on
    `device`. K = min(the most any view observes, max_per_view), at least
    1; a view with more keeps an evenly spaced subsample of exactly K."""
    if not depth_obs:
        raise ValueError("no depth observations")
    k = max(min(max(o.shape[0] for o in depth_obs), max_per_view), 1)
    obs = np.zeros((len(depth_obs), k, 3), np.float32)
    mask = np.zeros((len(depth_obs), k), bool)
    for i, o in enumerate(depth_obs):
        if o.shape[0] > k:
            o = o[np.linspace(0, o.shape[0] - 1, k).round().astype(int)]
        obs[i, :o.shape[0]] = o
        mask[i, :o.shape[0]] = True
    return (torch.tensor(obs, device=device),
            torch.tensor(mask, device=device))


def sparse_depth_loss(params: GaussianModel, camera: Camera,
                      obs: torch.Tensor, mask: torch.Tensor,
                      cfg: RasterConfig) -> torch.Tensor:
    """Masked relative-L1 between the rendered mean depth and the SfM
    depth. obs: (K, 3) [u_px, v_px, z_cam]; mask: (K,) valid flags."""
    mean_d, _, alpha = render_depth(params, camera, cfg)
    u = torch.clamp(obs[:, 0].to(torch.int32), 0,
                    cfg.image_width - 1).to(torch.int64)
    v = torch.clamp(obs[:, 1].to(torch.int32), 0,
                    cfg.image_height - 1).to(torch.int64)
    pred = mean_d[v, u]
    z = torch.clamp_min(obs[:, 2], 1e-6)
    valid = mask & (alpha[v, u] > 0.5)
    err = torch.abs(pred - z) / z
    return (torch.sum(torch.where(valid, err, 0.0))
            / torch.clamp_min(torch.sum(valid.to(torch.float32)), 1.0))


def make_depth_train_step(raster_cfg: RasterConfig,
                          train_cfg: trainer.TrainConfig,
                          depth_weight: float):
    """step(state, camera, target, obs, mask) -> (state, loss): the
    photometric loss plus depth_weight x the sparse depth loss, one more
    render pass per step; the state is updated in place. It is
    aux_opt.make_aux_step with pose and exposure off."""
    # aux_opt imports this module for sparse_depth_loss.
    from gaussian_splat_ipu_tpu_torch.train import aux_opt
    aux_step = aux_opt.make_aux_step(raster_cfg, train_cfg,
                                     depth_weight=depth_weight)
    off = aux_opt.AuxState(pose=None, exposure=None)

    def step(state: trainer.TrainState, camera: Camera, target: torch.Tensor,
             obs: torch.Tensor, mask: torch.Tensor):
        return state, aux_step(state, off, None, camera, target, obs, mask)

    return step
