"""Single-device training step over gaussian parameters (torch port of
gaussian_splat_ipu_tpu/train/trainer.py).

Pixel loss -> gradients through the differentiable render (rasterizer
kernels C and D, the pair-table index_add_, projection kernels G and
G-bwd, render/projection.py) -> one per-group Adam update, the
reference's `make_optimizer` (trainer.py:53-96), in train/adam.py: on
CUDA kernel H (csrc/adam.cu), one launch over every group, elsewhere its
plain twin. Every scalar of the update (counts, bias corrections, the
scheduled rate) stays on the device, so a step never waits for the
device. `train_step` updates the state's tensors in place and returns it.

Every step kind (train_step, densify's, aux_opt's, the view batch's)
renders in the span "render", takes `image_loss` and ends in
`gradient_step`, so each records the same spans.

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
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render.pipeline import render_image
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
from gaussian_splat_ipu_tpu_torch.train import losses
from gaussian_splat_ipu_tpu_torch.train.adam import (LABELS, adam_direction,
                                                     apply_param_updates)
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig)


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


def image_loss(image: torch.Tensor, target: torch.Tensor,
               train_cfg: TrainConfig, extra=None) -> torch.Tensor:
    """The render loss of `image`, or the mean over a stack of V images,
    in the span "loss", the image marked "loss" (its gradient's arrival
    ends "loss.bwd"); extra(), built after it, is added (the depth term)."""
    w = train_cfg.ssim_weight
    image = profiling.mark(image, "loss")
    with profiling.span("loss", image.device):
        loss = (losses.render_loss(image, target, w) if image.ndim == 3
                else torch.mean(torch.stack([
                    losses.render_loss(im, tg, w)
                    for im, tg in zip(image.unbind(0), target.unbind(0))])))
        return loss if extra is None else loss + extra()


def loss_fn(params: GaussianModel, camera: Camera, target: torch.Tensor,
            raster_cfg: RasterConfig, train_cfg: TrainConfig,
            image_fn=render_image) -> torch.Tensor:
    """The render loss of `image_fn(params, camera, raster_cfg)`, the
    single-device render by default (parallel/distributed.py passes the
    sharded one), rendered in the span "render" (then image_loss's)."""
    with profiling.span("render", params.device):
        image = image_fn(params, camera, raster_cfg)
    return image_loss(image, target, train_cfg)


@torch.no_grad()
def adam_apply(param: torch.Tensor, grad: torch.Tensor, st: AdamState,
               lr: float, eps: float = 1e-15) -> None:
    """optax.adam(lr, b1=0.9, b2=0.999, eps) + apply_updates on one tensor,
    in place (the pose and exposure optimizers)."""
    param.copy_(param + adam_direction(grad, st, eps) * -lr)


def select_row(x: torch.Tensor, view_idx: torch.Tensor) -> torch.Tensor:
    """x[view_idx] for a () integer tensor on x's device, without reading
    the index back to the host (a captured program's per-view row)."""
    return x.index_select(0, view_idx.reshape(1).to(torch.int64))[0]


def init_adam(param: torch.Tensor) -> AdamState:
    """optax.adam's fresh state for `param`: count 0, zero moments."""
    return AdamState(torch.zeros((), dtype=torch.int32, device=param.device),
                     torch.zeros_like(param), torch.zeros_like(param))


def gradient_step(state: TrainState, loss: torch.Tensor,
                  train_cfg: TrainConfig, leaves=()) -> tuple:
    """Every step once it has its loss: the gradients of the model and of
    the step's own `leaves` in one autograd call (span "backward"), the
    Adam update (span "adam"), the step count. The leaves' gradients."""
    params = state.params
    with profiling.span("backward", params.device):
        grads = torch.autograd.grad(loss, (*params.parameters(), *leaves))
    with profiling.span("adam", params.device):
        apply_param_updates(params, dict(zip(FIELDS, grads)),
                            state.opt_state, train_cfg)
    state.step.add_(1)
    return grads[len(FIELDS):]


def train_step(state: TrainState, camera: Camera, target: torch.Tensor,
               raster_cfg: RasterConfig, train_cfg: TrainConfig,
               image_fn=render_image):
    """loss_fn, then gradient_step: updates `state` in place and returns
    (state, loss), loss a () device tensor."""
    loss = loss_fn(state.params, camera, target, raster_cfg, train_cfg,
                   image_fn)
    gradient_step(state, loss, train_cfg)
    return state, loss.detach()


STEP_PROGRAM = "train_step"


def step_program(state: TrainState, raster_cfg: RasterConfig,
                 train_cfg: TrainConfig, step_fn=None):
    """(program, inputs) of train_step, or of step_fn(state, camera,
    target) -> (state, loss) (the sharded step): see register_view_step."""
    step_fn = step_fn or functools.partial(
        train_step, raster_cfg=raster_cfg, train_cfg=train_cfg)
    return (lambda st, cam, tgt: step_fn(st, cam, tgt)[1],
            lambda vi, cam, tgt: (state, cam, tgt))


def per_view_program(step, pass_view: bool = False):
    """program(*lead, view_idx, camera, target, obs_all, mask_all) ->
    step(*lead, [view_idx,] camera, target, obs, mask), the view's depth
    rows picked inside the program, so one capture serves every view."""
    def program(*args):
        *lead, view_idx, camera, target, obs_all, mask_all = args
        if pass_view:
            lead.append(view_idx)
        return step(*lead, camera, target, select_row(obs_all, view_idx),
                    select_row(mask_all, view_idx))

    return program


def register_view_step(engine: RenderEngine, name: str, program, inputs,
                       camera, target: torch.Tensor, view_idx=None,
                       eager: str = ""):
    """Register `program` as a train program (grad=True) on the example
    inputs(view_idx, camera, target) -> its arguments, the view's index
    (if any), camera(s) and target the engine's own copies; the state and
    the rest `inputs` names are the registered objects, which a run
    updates in place. eager: see RenderEngine.register."""
    cam, tgt = static_copies(camera, target)
    vi = None if view_idx is None else view_idx.to(engine.device).clone()
    return engine.register(name, program, inputs(vi, cam, tgt), grad=True,
                           eager=eager)


def register_step(engine: RenderEngine, state: TrainState, camera: Camera,
                  target: torch.Tensor, raster_cfg: RasterConfig,
                  train_cfg: TrainConfig, name: str = STEP_PROGRAM,
                  step_fn=None, eager: str = ""):
    """Register step_program on `engine`: `engine.run(name, state, camera,
    target)` updates the state in place and hands back only the loss."""
    return register_view_step(
        engine, name, *step_program(state, raster_cfg, train_cfg, step_fn),
        camera, target, eager=eager)


def static_copies(camera, target: torch.Tensor):
    """The engine's own copies of an example camera (or tuple of cameras)
    and target, so a copy-in never writes the caller's view."""
    def copy(c: Camera) -> Camera:
        return Camera(c.view.clone(), c.proj.clone(), c.env_rot.clone())

    cams = (tuple(map(copy, camera)) if isinstance(camera, tuple)
            else copy(camera))
    return cams, target.detach().clone()


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
