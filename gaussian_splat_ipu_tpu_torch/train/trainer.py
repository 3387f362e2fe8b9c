"""Single-device training step over gaussian parameters (torch port of
gaussian_splat_ipu_tpu/train/trainer.py).

Pixel loss -> gradients through the differentiable render (rasterizer
kernels C and D, the pair-table index_add_, projection by autograd) ->
one per-group Adam update. The optimizer reproduces the reference's
`make_optimizer` (trainer.py:53-96), optax's `multi_transform` of one Adam
per parameter family, written as functions on tensors: torch.optim.Adam
cannot scale half of one tensor (the SH bands >= 1) after the Adam step.

  * Adam as optax's: b1 0.9, b2 0.999, eps = adam_eps outside the square
    root, bias correction 1 - b**count with count incremented first;
  * means: learning rate optax.exponential_decay(lr_means * scene_extent,
    lr_means_decay_steps, lr_means_final / lr_means, end_value =
    lr_means_final * scene_extent), non-staircase, evaluated at the
    schedule's own count (0 at the first update);
  * sh: the update of bands >= 1 is scaled by sh_rest_lr_scale after Adam;
  * quaternions are renormalised after each step, by max(norm, 1e-8).

Every scalar of the update (counts, bias corrections, the scheduled rate)
stays on the device, so a step never waits for the device.
`train_step` updates the state's tensors in place and returns it.

The compiled step (the reference jits it, trainer.py:138/160): on CUDA
`register_step` captures one train_step as a CUDA graph in a
runtime/engine.RenderEngine program (fn(state, camera, target) ->
loss), and a step is one replay with the camera and target
copied in; `fit` runs its steps so. Register after a resume:
checkpoint.restore_checkpoint makes new tensors, and a graph updates the
ones it captured. With a card a replayed step is held to the eager step
within kernel D's row-scaled bound, not bit for bit: D's shared group
ranges and the pair-table VJP's `index_add_` add with atomics.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render.pipeline import render_image
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
from gaussian_splat_ipu_tpu_torch.train import losses
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig)

B1, B2 = 0.9, 0.999
# The optimizer's parameter groups in sorted label order: the order of
# optax's multi_transform state, and so of the checkpoint's leaves.
LABELS = tuple(sorted(FIELDS))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation hyper-parameters; the reference's fields and
    defaults."""

    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_means_decay_steps: int = 30_000
    lr_log_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_sh: float = 2.5e-3
    # Higher-order SH bands step at lr_sh * this (standard 3DGS trains
    # f_rest at 1/20 of the f_dc rate).
    sh_rest_lr_scale: float = 1.0 / 20.0
    ssim_weight: float = 0.2
    # Scene extent multiplies the means learning rate (3DGS convention).
    scene_extent: float = 1.0
    adam_eps: float = 1e-15


class AdamState(NamedTuple):
    count: torch.Tensor   # () i32 updates taken
    mu: torch.Tensor      # first moment, shaped as the parameter
    nu: torch.Tensor      # second moment


class OptState(NamedTuple):
    adam: dict            # label -> AdamState
    means_lr_count: torch.Tensor  # () i32 count of the means lr schedule


class TrainState(NamedTuple):
    params: GaussianModel  # parameters that require grad
    opt_state: OptState
    step: torch.Tensor     # () i32

    def to_numpy(self) -> list:
        """The state as the reference's 22 pytree leaves, in its flatten
        order: the 5 params (field order); per label in sorted order Adam
        count, mu, nu, with the means schedule count after means' Adam
        state; then step."""
        leaves = list(self.params.to_numpy().values())
        for label in LABELS:
            st = self.opt_state.adam[label]
            leaves += [st.count, st.mu, st.nu]
            if label == "means":
                leaves.append(self.opt_state.means_lr_count)
        leaves.append(self.step)
        return [x if isinstance(x, np.ndarray)
                else x.detach().cpu().numpy() for x in leaves]

    @classmethod
    def from_numpy(cls, leaves, device) -> "TrainState":
        """Inverse of to_numpy: carries a reference TrainState (its
        flattened leaves) across, parameters made trainable."""
        it = iter(leaves)

        def take(dtype):
            return torch.tensor(np.asarray(next(it), dtype), device=device)

        params = GaussianModel(*(take(np.float32) for _ in FIELDS),
                               requires_grad=True)
        adam, sched = {}, None
        for label in LABELS:
            adam[label] = AdamState(take(np.int32), take(np.float32),
                                    take(np.float32))
            if label == "means":
                sched = take(np.int32)
        step = take(np.int32)
        if next(it, None) is not None:
            raise ValueError("more leaves than a TrainState holds")
        return cls(params, OptState(adam, sched), step)


def init_state(model: GaussianModel,
               cfg: TrainConfig = TrainConfig()) -> TrainState:
    """Fresh optimizer state for `model`, whose parameters must require
    grad (GaussianModel.trainable()). `cfg` shapes nothing: every group's
    state is a count and two moments, as optax's."""
    del cfg
    if not all(t.requires_grad for t in model.parameters()):
        raise ValueError("init_state: the model's parameters do not "
                         "require grad; pass model.trainable()")
    zero = torch.zeros((), dtype=torch.int32, device=model.device)
    adam = {label: init_adam(getattr(model, label)) for label in LABELS}
    return TrainState(model, OptState(adam, zero.clone()), zero.clone())


def loss_fn(params: GaussianModel, camera: Camera, target: torch.Tensor,
            raster_cfg: RasterConfig, train_cfg: TrainConfig,
            image_fn=render_image) -> torch.Tensor:
    """The render loss of `image_fn(params, camera, raster_cfg)`, the
    single-device render by default (parallel/distributed.py passes the
    sharded one). Spans "render" and "loss" while spans are recorded, and
    the image marked "loss" (utils/profiling.mark: its gradient's arrival
    ends "loss.bwd")."""
    dev = params.device
    with profiling.span("render", dev):
        image = image_fn(params, camera, raster_cfg)
    image = profiling.mark(image, "loss")
    with profiling.span("loss", dev):
        return losses.render_loss(image, target, train_cfg.ssim_weight)


def means_lr(count: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """optax.exponential_decay of the means rate at schedule count
    `count` (a () i32 device tensor), as a () f32 device tensor."""
    init = cfg.lr_means * cfg.scene_extent
    end = cfg.lr_means_final * cfg.scene_extent
    # Guarded ratio: lr_means == 0 (a frozen scene) must not divide by 0.
    rate = cfg.lr_means_final / cfg.lr_means if cfg.lr_means > 0 else 1.0
    count_f = count.to(torch.float32)
    if cfg.lr_means_decay_steps <= 0 or rate == 0.0:
        return torch.full_like(count_f, init)   # optax's constant schedule
    decayed = torch.where(
        count <= 0, torch.full_like(count_f, init),
        init * torch.pow(torch.full_like(count_f, rate),
                         count_f / cfg.lr_means_decay_steps))
    return (torch.clamp_min if rate < 1.0 else torch.clamp_max)(decayed, end)


def _adam_direction(grad: torch.Tensor, st: AdamState, eps: float):
    """One optax scale_by_adam step: updates `st` in place, returns the
    bias-corrected direction mu_hat / (sqrt(nu_hat) + eps)."""
    st.count.add_(1)
    st.mu.copy_((1.0 - B1) * grad + B1 * st.mu)
    st.nu.copy_((1.0 - B2) * (grad * grad) + B2 * st.nu)
    count_f = st.count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(count_f, B1), count_f)
    bc2 = 1.0 - torch.pow(torch.full_like(count_f, B2), count_f)
    return (st.mu / bc1) / (torch.sqrt(st.nu / bc2) + eps)


@torch.no_grad()
def adam_apply(param: torch.Tensor, grad: torch.Tensor, st: AdamState,
               lr: float, eps: float = 1e-15) -> None:
    """optax.adam(lr, b1=0.9, b2=0.999, eps) + apply_updates on one tensor,
    in place (the pose and exposure optimizers)."""
    param.copy_(param + _adam_direction(grad, st, eps) * -lr)


def select_row(x: torch.Tensor, view_idx: torch.Tensor) -> torch.Tensor:
    """x[view_idx] for a () integer tensor on x's device, without reading
    the index back to the host (a captured program's per-view row)."""
    return x.index_select(0, view_idx.reshape(1).to(torch.int64))[0]


def init_adam(param: torch.Tensor) -> AdamState:
    """optax.adam's fresh state for `param`: count 0, zero moments."""
    return AdamState(torch.zeros((), dtype=torch.int32, device=param.device),
                     torch.zeros_like(param), torch.zeros_like(param))


@torch.no_grad()
def apply_param_updates(params: GaussianModel, grads: dict,
                        opt_state: OptState, cfg: TrainConfig) -> None:
    """Per-group Adam update + quaternion renormalisation, in place."""
    lrs = {"log_scales": cfg.lr_log_scales, "quats": cfg.lr_quats,
           "opacities": cfg.lr_opacities, "sh": cfg.lr_sh}
    for label in LABELS:
        p = getattr(params, label)
        d = _adam_direction(grads[label], opt_state.adam[label],
                            cfg.adam_eps)
        if label == "means":
            lr = means_lr(opt_state.means_lr_count, cfg)
            opt_state.means_lr_count.add_(1)
            update = -lr * d
        else:
            update = d * -lrs[label]
        if label == "sh" and p.shape[1] > 1:
            update[:, 1:] *= cfg.sh_rest_lr_scale
        p.copy_(p + update)
    q = params.quats
    q.copy_(q / torch.clamp_min(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-8))


def train_step(state: TrainState, camera: Camera, target: torch.Tensor,
               raster_cfg: RasterConfig, train_cfg: TrainConfig,
               image_fn=render_image):
    """One forward + backward + update step. Updates `state` in place and
    returns (state, loss), loss a () device tensor. Spans (while
    recorded): loss_fn's, then "backward" around the gradients (with
    "loss.bwd" inside) and "adam" around the update."""
    params = state.params
    loss = loss_fn(params, camera, target, raster_cfg, train_cfg, image_fn)
    with profiling.span("backward", params.device):
        grads = torch.autograd.grad(loss, tuple(params.parameters()))
    with profiling.span("adam", params.device):
        apply_param_updates(params, dict(zip(FIELDS, grads)),
                            state.opt_state, train_cfg)
    state.step.add_(1)
    return state, loss.detach()


STEP_PROGRAM = "train_step"


def register_step(engine: RenderEngine, state: TrainState, camera: Camera,
                  target: torch.Tensor, raster_cfg: RasterConfig,
                  train_cfg: TrainConfig, name: str = STEP_PROGRAM,
                  step_fn=None, eager: str = ""):
    """Register train_step on `engine` as a train program (grad=True),
    fn(state, camera, target) -> the () loss: on CUDA captured, with
    `state` as it was afterwards. The state is the registered object, so
    `engine.run(name, state, camera, target)` updates it in place and
    hands back only the loss, no copy of the parameters; the camera and
    target are copies, the static inputs each run copies into. step_fn
    replaces train_step (the sharded step of parallel/distributed.py);
    eager: see RenderEngine.register."""
    def step(state: TrainState, camera: Camera, target: torch.Tensor):
        if step_fn is not None:
            return step_fn(state, camera, target)[1]
        return train_step(state, camera, target, raster_cfg, train_cfg)[1]

    return engine.register(name, step, (state, *static_copies(camera,
                                                              target)),
                           grad=True, eager=eager)


def static_copies(camera: Camera, target: torch.Tensor):
    """The engine's own copies of an example camera and target: the static
    inputs each run copies into, so a copy-in never writes the caller's
    view."""
    return (Camera(camera.view.clone(), camera.proj.clone(),
                   camera.env_rot.clone()), target.detach().clone())


def fit(model: GaussianModel, cameras, targets, raster_cfg: RasterConfig,
        train_cfg: TrainConfig = TrainConfig(), num_steps: int = 100,
        log_every: Optional[int] = None):
    """Simple single-device fit loop over (camera, target) views, cycled
    in order, each step a replay of the captured step on CUDA. Returns
    (trained model, list of losses: every step, or steps 0, log_every,
    ... with log_every)."""
    state = init_state(model.trainable(), train_cfg)
    engine = RenderEngine(RuntimeConfig(device=str(state.params.device)))
    register_step(engine, state, cameras[0], targets[0], raster_cfg,
                  train_cfg)
    history = []
    for i in range(num_steps):
        loss = engine.run(STEP_PROGRAM, state, cameras[i % len(cameras)],
                          targets[i % len(targets)])
        if not log_every or i % log_every == 0:
            history.append(loss)
    return state.params, [float(x) for x in history]
