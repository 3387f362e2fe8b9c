"""Adaptive density control: split, clone and prune gaussians during
training (torch port of gaussian_splat_ipu_tpu/train/densify.py; 3DGS,
Kerbl et al. 2023 section 5.2).

The reference's static-shape design is kept, because it is what lets one
CUDA graph serve a whole run, as one XLA executable does there:

- The model lives in a fixed-capacity buffer of `capacity` slots plus an
  `alive` mask. Children go to free (dead) slots and pruning clears the
  mask, so the step's shapes never change and its program is captured
  once. Only `grow_capacity` changes shapes; the caller then registers its
  programs again.
- The densification signal is the screen-space positional gradient: a
  zero (N, 2) probe added to the projected xy (render(..., xy_probe=)),
  whose gradient is d(loss)/d(pixel position), accumulated in
  NDC-equivalent units so the standard 2e-4 threshold holds at any
  resolution.
- Slots are allocated by rank and scatter: births ranked by accumulated
  gradient (a stable argsort), free slots enumerated by a stable argsort
  of the keep mask, birth b placed in free slot b while b < min(births,
  free); the lowest-priority births are dropped when the buffer is full.
- Adam moments of rows that changed meaning are zeroed in place.
- The event writes its counts (COUNT_NAMES) into a small int64 tensor on
  the device; nothing is read back until the pair-demand guard
  (pair_demand_guard), which renders every training view after an event
  and reads its demand and the counts in one read-back.

A registered step and the eager events share tensors: the event and the
opacity reset run between replays and write into the very tensors the
graph captured (the five parameters, every label's moments, grad_sum,
vis_count, alive) with copy_ / masked_fill_, never rebinding them. The
event reads nothing back to the host.

Spans and counters (utils/profiling.py, while spans are recorded):
"densify.event" (host and device) around densify_and_prune,
"densify.guard" (host) around the guard's renders and read-back,
"densify.reset" (host and device) around reset_opacity; the counters
densify.events (events), densify.births, densify.dropped and
densify.pruned (summed over the events the guard read), densify.alive and
densify.pair_demand (the latest guard's). Off, each costs one attribute
check.

Split noise: the reference draws two normal (C, 3) arrays from
jax.random.split(key, 3). The port keeps the key as the same (2,) uint32
leaf (so a (state, dstate) checkpoint has the reference's 26 leaves),
seeds a torch.Generator from it for each event's two draws and advances
it, so a resumed run does not replay an event's noise. The draws are not
the reference's bits; `densify_and_prune_core` takes them as arguments,
so a test can feed it the reference's own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.ops.transforms import quat_to_rotmat
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
from gaussian_splat_ipu_tpu_torch.train import depth, losses, trainer
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig)

# Raw opacity and log-scale of dead slots: sigmoid(-30) ~ 9e-14, far below
# any alpha_min, so projection culls them.
_DEAD_OPACITY = -30.0
_DEAD_LOG_SCALE = -30.0
STEP_PROGRAM = "densify_step"
# The event's counts, in the order of its counts tensor: alive slots above
# the gradient threshold, splits and clones among the kept ones, births
# placed in free slots and dropped for want of one, alive slots pruned,
# and slots alive after the event.
COUNT_NAMES = ("candidates", "splits", "clones", "placed", "dropped",
               "pruned", "alive")
# Densification stops once a training view's pair demand passes this share
# of the pair capacity (dropped pairs corrupt gradients).
GUARD_SHARE = 0.8


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """Density-control hyper-parameters; the reference's fields and
    defaults."""

    # Average NDC-units screen gradient above which a gaussian densifies.
    grad_threshold: float = 2e-4
    # Split when max world scale > percent_dense * scene_extent, else clone.
    percent_dense: float = 0.01
    # Prune when the post-sigmoid opacity falls below this.
    min_opacity: float = 0.005
    # Prune when max world scale exceeds this fraction of the scene extent
    # (0 disables).
    max_world_scale: float = 0.0
    # Each split child's scales shrink by this factor.
    split_scale_factor: float = 1.6
    scene_extent: float = 1.0
    # Cadence (read by fit_densify and app/train.py, not by the event).
    densify_every: int = 100
    densify_from_step: int = 500
    densify_until_step: int = 15_000
    reset_opacity_every: int = 3_000
    # Opacity ceiling of the reset (post-sigmoid).
    reset_opacity_to: float = 0.01


class DensifyState(NamedTuple):
    """Per-slot densification statistics."""

    grad_sum: torch.Tensor   # (C,) f32 accumulated NDC screen-grad norms
    vis_count: torch.Tensor  # (C,) i32 steps the gaussian was visible
    alive: torch.Tensor      # (C,) bool slot occupancy
    key: np.ndarray          # (2,) uint32 on the host: seeds split noise

    def to_numpy(self) -> list:
        """The reference DensifyState's 4 leaves, in its order."""
        return [self.grad_sum.cpu().numpy(), self.vis_count.cpu().numpy(),
                self.alive.cpu().numpy(), np.asarray(self.key, np.uint32)]

    @classmethod
    def from_numpy(cls, leaves, device) -> "DensifyState":
        g, v, a, k = leaves
        return cls(torch.tensor(np.asarray(g, np.float32), device=device),
                   torch.tensor(np.asarray(v, np.int32), device=device),
                   torch.tensor(np.asarray(a, bool), device=device),
                   np.array(k, np.uint32))

    def from_numpy_like(self, leaves, device) -> "DensifyState":
        """from_numpy, for a checkpoint template of this layout."""
        return DensifyState.from_numpy(leaves, device)


def init_state(num_alive: int, capacity: int,
               key: Optional[np.ndarray] = None, *,
               device) -> DensifyState:
    """Fresh statistics: the first num_alive slots alive. The default key
    is the reference's jax.random.PRNGKey(0), [0, 0]."""
    if num_alive > capacity:
        raise ValueError(f"{num_alive} gaussians > capacity {capacity}")
    return DensifyState(
        grad_sum=torch.zeros((capacity,), dtype=torch.float32,
                             device=device),
        vis_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
        alive=torch.arange(capacity, device=device) < num_alive,
        key=np.zeros(2, np.uint32) if key is None
        else np.array(key, np.uint32))


def pad_model(model: GaussianModel, capacity: int) -> GaussianModel:
    """The model in its fixed-capacity buffer: dead slots at opacity -30
    and log-scale -30 (GaussianModel.pad_to). Parameters require grad as
    the input's do; the result never shares the input's storage."""
    with torch.no_grad():
        src = GaussianModel(*(getattr(model, k).detach().clone()
                              for k in FIELDS))
        padded = src.pad_to(capacity)
        live = torch.arange(capacity, device=model.device) \
            < model.num_gaussians
        opacities = torch.where(live, padded.opacities, _DEAD_OPACITY)
    return GaussianModel(padded.means, padded.log_scales, padded.quats,
                         opacities, padded.sh,
                         requires_grad=model.means.requires_grad)


def grow_capacity(state: trainer.TrainState, dstate: DensifyState,
                  new_capacity: int):
    """Pad the slot buffer (parameters, Adam moments, statistics) with dead
    slots at the end. The one operation that changes shapes: the result
    holds new tensors, so the caller registers its programs again."""
    old = dstate.alive.shape[0]
    if new_capacity < old:
        raise ValueError(f"new capacity {new_capacity} < current {old}")
    if new_capacity == old:
        return state, dstate
    pad = new_capacity - old

    def pad_rows(x):
        return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                         device=x.device)])

    opt = trainer.OptState(
        {label: trainer.AdamState(st.count, pad_rows(st.mu),
                                  pad_rows(st.nu))
         for label, st in state.opt_state.adam.items()},
        state.opt_state.means_lr_count)
    return (trainer.TrainState(pad_model(state.params, new_capacity), opt,
                               state.step),
            DensifyState(pad_rows(dstate.grad_sum),
                         pad_rows(dstate.vis_count), pad_rows(dstate.alive),
                         dstate.key))


def compact(model: GaussianModel, dstate: DensifyState) -> GaussianModel:
    """The alive slots only (before export); reads the mask back."""
    idx = torch.nonzero(dstate.alive)[:, 0]
    return GaussianModel(*(getattr(model, k).detach()[idx] for k in FIELDS))


# ---------------------------------------------------------------------------
# The step with gradient statistics
# ---------------------------------------------------------------------------

def _ndc_grad_norm(gxy: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """|d loss / d pixel xy| in NDC-equivalent units: xy_px = (ndc + 1) *
    wh / 2, so each component scales by half the image size."""
    return torch.linalg.vector_norm(torch.stack(
        [gxy[:, 0] * (0.5 * cfg.image_width),
         gxy[:, 1] * (0.5 * cfg.image_height)], -1), dim=-1)


def loss_mix_scale(model: GaussianModel, camera: Camera,
                   target: torch.Tensor, raster_cfg: RasterConfig,
                   ssim_weight: float) -> float:
    """Screen-gradient scale of the (1-w) L1 + w DSSIM mix relative to pure
    L1, measured on the scene with two eager backward passes: callers
    multiply the L1-calibrated grad_threshold by it (1 at w = 0)."""
    if ssim_weight <= 0.0:
        return 1.0
    frozen = GaussianModel(*(getattr(model, k).detach() for k in FIELDS))

    def mean_gnorm(loss_img_fn) -> float:
        with torch.enable_grad():
            probe = torch.zeros((frozen.num_gaussians, 2),
                                dtype=torch.float32, device=frozen.device,
                                requires_grad=True)
            out = render(frozen, camera, raster_cfg, xy_probe=probe)
            (g,) = torch.autograd.grad(loss_img_fn(out.image), (probe,))
        gn = _ndc_grad_norm(g, raster_cfg)
        denom = torch.clamp_min(torch.sum(out.visible.to(torch.float32)),
                                1.0)
        return float(torch.sum(torch.where(out.visible, gn, 0.0)) / denom)

    g_l1 = mean_gnorm(lambda im: losses.l1(im[..., :3], target[..., :3]))
    g_ssim = mean_gnorm(lambda im: losses.dssim(im[..., :3],
                                                target[..., :3]))
    alpha = g_ssim / max(g_l1, 1e-12)
    return (1.0 - ssim_weight) + ssim_weight * alpha


def make_train_step(raster_cfg: RasterConfig, train_cfg: trainer.TrainConfig,
                    depth_weight: float = 0.0, render_fn=render):
    """The train step that also accumulates the densification statistics:
    step(state, grad_sum, vis_count, camera, target[, obs, mask]) -> loss,
    updating the state and both statistics in place: the render with the
    xy probe, trainer's image_loss (with depth_weight > 0 plus the sparse
    depth term, train/depth.py, on the view's (K, 3) observations and (K,)
    mask) and gradient_step with the probe as a leaf. render_fn(params,
    camera, cfg, xy_probe=) -> an output with .image and .visible: the
    single-device render by default (parallel/distributed.py passes the
    sharded one)."""
    def step(state: trainer.TrainState, grad_sum: torch.Tensor,
             vis_count: torch.Tensor, camera: Camera, target: torch.Tensor,
             obs: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        params = state.params
        probe = torch.zeros((params.num_gaussians, 2), dtype=torch.float32,
                            device=params.device, requires_grad=True)
        with profiling.span("render", params.device):
            out = render_fn(params, camera, raster_cfg, xy_probe=probe)
        loss = trainer.image_loss(out.image, target, train_cfg, (
            lambda: depth_weight * depth.sparse_depth_loss(
                params, camera, obs, mask, raster_cfg))
            if depth_weight > 0.0 else None)
        (gxy,) = trainer.gradient_step(state, loss, train_cfg, (probe,))
        with torch.no_grad():
            visible = out.visible
            grad_sum.add_(torch.where(visible,
                                      _ndc_grad_norm(gxy, raster_cfg), 0.0))
            vis_count.add_(visible.to(torch.int32))
        return loss.detach()

    return step


def step_program(state: trainer.TrainState, dstate: DensifyState,
                 raster_cfg: RasterConfig, train_cfg: trainer.TrainConfig,
                 depth_weight: float = 0.0, obs_all=None, mask_all=None,
                 step_fn=None):
    """The densify step as trainer.register_view_step's (program, inputs):
    fn(state, grad_sum, vis_count, camera, target) -> loss, or with
    depth_weight > 0 fn(state, grad_sum, vis_count, view_idx, camera,
    target, obs_all, mask_all) -> loss. Only the tensors the step touches
    are inputs: never the alive mask or the key. step_fn replaces the step
    (without depth: the sharded one of parallel/distributed.py)."""
    step = step_fn or make_train_step(raster_cfg, train_cfg, depth_weight)
    stats = (state, dstate.grad_sum, dstate.vis_count)
    if depth_weight <= 0.0:
        return step, lambda vi, cam, tgt: (*stats, cam, tgt)
    return trainer.per_view_program(step), lambda vi, cam, tgt: (
        *stats, vi, cam, tgt, obs_all, mask_all)


def register_step(engine: RenderEngine, state: trainer.TrainState,
                  dstate: DensifyState, camera: Camera, target: torch.Tensor,
                  raster_cfg: RasterConfig, train_cfg: trainer.TrainConfig,
                  depth_weight: float = 0.0, view_idx=None, obs_all=None,
                  mask_all=None, name: str = STEP_PROGRAM, step_fn=None,
                  eager: str = ""):
    """Register step_program on `engine` (trainer.register_view_step)."""
    return trainer.register_view_step(
        engine, name, *step_program(state, dstate, raster_cfg, train_cfg,
                                    depth_weight, obs_all, mask_all,
                                    step_fn), camera, target, view_idx, eager)


# ---------------------------------------------------------------------------
# The densify / prune event and the opacity reset
# ---------------------------------------------------------------------------

def _zero_rows(opt_state: trainer.OptState, rows: torch.Tensor) -> None:
    """Zero, in place, every Adam moment row of a masked slot (the
    reference's _reset_rows: each leaf whose leading dimension is the
    capacity; the counts and the schedule count are scalars and stay)."""
    c = rows.shape[0]
    for st in opt_state.adam.values():
        for m in (st.mu, st.nu):
            if m.ndim >= 1 and m.shape[0] == c:
                m.masked_fill_(rows.view((c,) + (1,) * (m.ndim - 1)), 0.0)


def split_noise(dstate: DensifyState, capacity: int, device):
    """The event's two (C, 3) standard-normal draws from a generator seeded
    by the key, and the advanced key (host work only)."""
    seed = (int(dstate.key[0]) << 32) | int(dstate.key[1])
    gen = torch.Generator(device=device).manual_seed(seed)
    eps = [torch.randn((capacity, 3), generator=gen, dtype=torch.float32,
                       device=device) for _ in range(2)]
    key = np.random.default_rng(seed).integers(0, 1 << 32, 2,
                                               dtype=np.uint32)
    return eps[0], eps[1], key


def new_counts(device) -> torch.Tensor:
    """A zeroed counts tensor for densify_and_prune (COUNT_NAMES)."""
    return torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=device)


@torch.no_grad()
def densify_and_prune_core(state: trainer.TrainState, dstate: DensifyState,
                           cfg: DensifyConfig, eps_a: torch.Tensor,
                           eps_b: torch.Tensor) -> torch.Tensor:
    """One density-control event with the given split noise, in place:
    capacity never changes, children land in free slots, the
    lowest-priority births drop when the buffer is full. Every new value
    is computed from the old ones before any is written. Returns the
    event's (7,) int64 counts (COUNT_NAMES) on the device."""
    params = state.params
    capacity = params.num_gaussians
    dev = params.device
    alive = dstate.alive

    avg = dstate.grad_sum / torch.clamp_min(dstate.vis_count, 1).to(
        torch.float32)
    scales = torch.exp(params.log_scales)
    smax = torch.amax(scales, dim=-1)
    ext = cfg.scene_extent

    candidate = alive & (avg > cfg.grad_threshold)
    is_split = candidate & (smax > cfg.percent_dense * ext)
    is_clone = candidate & ~is_split
    prune = torch.sigmoid(params.opacities) < cfg.min_opacity
    if cfg.max_world_scale > 0.0:
        prune = prune | (smax > cfg.max_world_scale * ext)
    keep = alive & ~prune
    is_split = is_split & keep
    is_clone = is_clone & keep

    # Split: the parent slot becomes child A (sampled inside the parent's
    # footprint, scales shrunk); child B is born into a free slot. A clone
    # is born as an exact copy. The footprint product is summed
    # explicitly (no matmul, so no TF32).
    rot = quat_to_rotmat(params.quats)                      # (C, 3, 3)

    def sample(eps):
        return params.means + torch.sum(rot * (scales * eps)[:, None, :],
                                        dim=-1)

    split3 = is_split[:, None]
    means = torch.where(split3, sample(eps_a), params.means)
    log_scales = torch.where(
        split3, params.log_scales - math.log(cfg.split_scale_factor),
        params.log_scales)
    birth = is_split | is_clone
    birth_means = torch.where(split3, sample(eps_b), params.means)

    # Births ranked by accumulated gradient; free slots enumerated stably.
    order = torch.argsort(torch.where(birth, -avg, math.inf), stable=True)
    free_slots = torch.argsort(keep.to(torch.uint8), stable=True)
    n_birth = torch.sum(birth)
    n_free = capacity - torch.sum(keep)
    n_placed = torch.minimum(n_birth, n_free)
    placed = torch.arange(capacity, device=dev) < n_placed

    def place(x, values):
        m = placed.view((-1,) + (1,) * (x.ndim - 1))
        return x.index_copy(0, free_slots, torch.where(
            m, values[order], x[free_slots]))

    ones = torch.ones((capacity,), dtype=torch.bool, device=dev)
    alive_new = place(keep, ones)
    dead = ~alive_new
    new = dict(
        means=place(means, birth_means),
        log_scales=torch.where(dead[:, None], _DEAD_LOG_SCALE,
                               place(log_scales, log_scales)),
        quats=place(params.quats, params.quats),
        opacities=torch.where(dead, _DEAD_OPACITY,
                              place(params.opacities, params.opacities)),
        sh=place(params.sh, params.sh))
    # Moments of rows that changed meaning: split parents, every birth
    # slot, every dead slot.
    touched = place(is_split | dead, ones)
    out = torch.stack([torch.sum(candidate), torch.sum(is_split),
                       torch.sum(is_clone), n_placed, n_birth - n_placed,
                       torch.sum(alive & ~keep), torch.sum(alive_new)])

    for k in FIELDS:
        getattr(params, k).copy_(new[k])
    _zero_rows(state.opt_state, touched)
    dstate.grad_sum.zero_()
    dstate.vis_count.zero_()
    alive.copy_(alive_new)
    return out


def densify_and_prune(state: trainer.TrainState, dstate: DensifyState,
                      cfg: DensifyConfig = DensifyConfig(),
                      counts: Optional[torch.Tensor] = None):
    """One density-control event (densify_and_prune_core with noise drawn
    from the key), the span "densify.event". The state's tensors are
    written in place, and the event's counts into `counts` when given
    (new_counts; nothing is read back); returns (state, dstate with the
    advanced key)."""
    dev = state.params.device
    rec = profiling.active
    if rec is not None:
        rec.counters["densify.events"] += 1
    with profiling.span("densify.event", dev):
        eps_a, eps_b, key = split_noise(dstate, state.params.num_gaussians,
                                        dev)
        out = densify_and_prune_core(state, dstate, cfg, eps_a, eps_b)
        if counts is not None:
            counts.copy_(out)
    return state, dstate._replace(key=key)


class Guard(NamedTuple):
    """What the pair-demand guard read after an event."""

    demand: int             # max over the views of live + dropped pairs
    overflow: int           # max over the views of pairs dropped
    exchange_overflow: int  # max over the views of exchange drops
    closes: bool            # demand > GUARD_SHARE x the pair capacity
    counts: Optional[dict]  # the event's counts by COUNT_NAMES, or None


def pair_demand_guard(engine: RenderEngine, params: GaussianModel, cameras,
                      pair_capacity: int, program: str = "render",
                      counts: Optional[torch.Tensor] = None) -> Guard:
    """The guard after a density event: one run of the registered render
    program `program` (fn(model, view, proj, env_rot) -> an output with
    count, overflow and exchange_overflow) per camera, reduced on the
    device and read back once, with the event's `counts` (densify_and_prune)
    when given. The guard closes densification when the worst view's
    demand (live + dropped pairs) passes GUARD_SHARE of `pair_capacity`.
    The span "densify.guard"; while spans are recorded the counters
    densify.births, .dropped, .pruned (summed), .alive and .pair_demand
    (the latest)."""
    with profiling.span("densify.guard"):
        per_view = []
        for c in cameras:
            o = engine.run(program, params, c.view, c.proj, c.env_rot)
            per_view.append(torch.stack([o.count + o.overflow, o.overflow,
                                         o.exchange_overflow]).to(
                                             torch.int64))
        read = torch.amax(torch.stack(per_view), dim=0)
        if counts is not None:
            read = torch.cat([read, counts.to(read.device)])
        values = read.tolist()
    demand, overflow, xovf = values[:3]
    got = dict(zip(COUNT_NAMES, values[3:])) if counts is not None else None
    rec = profiling.active
    if rec is not None:
        c = rec.counters
        c["densify.pair_demand"] = demand
        if got is not None:
            c["densify.births"] += got["placed"]
            c["densify.dropped"] += got["dropped"]
            c["densify.pruned"] += got["pruned"]
            c["densify.alive"] = got["alive"]
    return Guard(demand, overflow, xovf,
                 demand > int(GUARD_SHARE * pair_capacity), got)


@torch.no_grad()
def reset_opacity(state: trainer.TrainState, dstate: DensifyState,
                  cfg: DensifyConfig = DensifyConfig()
                  ) -> trainer.TrainState:
    """Clamp every live opacity to at most `reset_opacity_to` (post-sigmoid)
    and zero the Adam moments that are 1-D of length C (the opacity
    label's), in place: the periodic reset that lets pruning clear
    floaters."""
    p = cfg.reset_opacity_to
    ceiling = float(torch.log(torch.tensor(p / (1.0 - p),
                                           dtype=torch.float32)))
    op = state.params.opacities
    with profiling.span("densify.reset", op.device):
        op.copy_(torch.where(dstate.alive, torch.clamp_max(op, ceiling), op))
        c = op.shape[0]
        for st in state.opt_state.adam.values():
            for m in (st.mu, st.nu):
                if m.ndim == 1 and m.shape[0] == c:
                    m.zero_()
    return state


# ---------------------------------------------------------------------------
# Convenience fit loop
# ---------------------------------------------------------------------------

def fit_densify(model: GaussianModel, cameras, targets,
                raster_cfg: RasterConfig,
                train_cfg: trainer.TrainConfig = trainer.TrainConfig(),
                densify_cfg: DensifyConfig = DensifyConfig(),
                capacity: Optional[int] = None, num_steps: int = 1000,
                key: Optional[np.ndarray] = None, log_every: int = 0):
    """Single-device training with density control: each step a replay of
    the captured densify step on CUDA, the events eager between replays.
    Returns (compacted model, history of (step, loss, alive))."""
    n0 = model.num_gaussians
    if capacity is None:
        capacity = max(2 * n0, 1024)
    if train_cfg.ssim_weight > 0.0:
        scale = loss_mix_scale(model, cameras[0], targets[0], raster_cfg,
                               train_cfg.ssim_weight)
        densify_cfg = dataclasses.replace(
            densify_cfg, grad_threshold=densify_cfg.grad_threshold * scale)
    dev = model.device
    dstate = init_state(n0, capacity, key, device=dev)
    state = trainer.init_state(pad_model(model, capacity).trainable(),
                               train_cfg)
    engine = RenderEngine(RuntimeConfig(device=str(dev)))
    register_step(engine, state, dstate, cameras[0], targets[0], raster_cfg,
                  train_cfg)

    history = []
    n_views = len(cameras)
    c = densify_cfg
    for i in range(num_steps):
        loss = engine.run(STEP_PROGRAM, state, dstate.grad_sum,
                          dstate.vis_count, cameras[i % n_views],
                          targets[i % n_views])
        it = i + 1
        if (c.densify_from_step <= it <= c.densify_until_step
                and it % c.densify_every == 0):
            state, dstate = densify_and_prune(state, dstate, c)
        # Reset only while densification runs and with room to recover
        # before the end.
        if (c.reset_opacity_every and it % c.reset_opacity_every == 0
                and it <= min(num_steps - 500, c.densify_until_step)):
            reset_opacity(state, dstate, c)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            history.append((i, float(loss), int(torch.sum(dstate.alive))))
    return compact(state.params, dstate), history
