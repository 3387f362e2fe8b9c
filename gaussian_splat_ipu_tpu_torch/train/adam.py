"""Kernel H: the train step's optimizer update, every parameter group's
Adam step and the quaternion renormalisation in one pass over the state
(csrc/adam.cu), and its plain twin.

`apply_param_updates` is the update every step kind ends in
(trainer.gradient_step): on CUDA always kernel H, one launch for all five
groups, counted in cuda_lib.launches["adam"], which raises on any tensor
it does not take (check_inputs); on the CPU the plain twin,
`apply_param_updates_torch`, which is also the tests' reference. No TPU
kernel corresponds: the JAX package's update is optax's, which XLA fuses.
H follows the twin's arithmetic op for op and equals it bit for bit on
the card (csrc/adam.cu says how).

The update reproduces the reference's `make_optimizer` (trainer.py:53-96),
optax's `multi_transform` of one Adam per parameter family, written as
functions on tensors: torch.optim.Adam cannot scale half of one tensor
(the SH bands >= 1) after the Adam step.

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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib

B1, B2 = 0.9, 0.999
# The optimizer's parameter groups in sorted label order: the order of
# optax's multi_transform state, and so of the checkpoint's leaves; kernel
# H's group order too.
LABELS = tuple(sorted(FIELDS))
# The means schedule's forms in kernel H: optax's constant schedule, the
# decay floored at its end value, or capped at it.
_LR_CONST, _LR_DECAY_MIN, _LR_DECAY_MAX = 0, 1, 2


def _schedule(cfg) -> tuple:
    """(form, init, end, rate, 1 / decay steps) of the means rate's
    optax.exponential_decay; the reciprocal in f32, as PyTorch's CUDA
    division by a Python number takes it (kernel H multiplies by it)."""
    init = cfg.lr_means * cfg.scene_extent
    end = cfg.lr_means_final * cfg.scene_extent
    # Guarded ratio: lr_means == 0 (a frozen scene) must not divide by 0.
    rate = cfg.lr_means_final / cfg.lr_means if cfg.lr_means > 0 else 1.0
    if cfg.lr_means_decay_steps <= 0 or rate == 0.0:
        return _LR_CONST, init, end, rate, 0.0   # optax's constant schedule
    inv = np.float32(1.0) / np.float32(cfg.lr_means_decay_steps)
    return (_LR_DECAY_MIN if rate < 1.0 else _LR_DECAY_MAX, init, end, rate,
            float(inv))


def means_lr(count: torch.Tensor, cfg) -> torch.Tensor:
    """optax.exponential_decay of the means rate at schedule count
    `count` (a () i32 device tensor), as a () f32 device tensor."""
    form, init, end, rate, _ = _schedule(cfg)
    count_f = count.to(torch.float32)
    if form == _LR_CONST:
        return torch.full_like(count_f, init)
    decayed = torch.where(
        count <= 0, torch.full_like(count_f, init),
        init * torch.pow(torch.full_like(count_f, rate),
                         count_f / cfg.lr_means_decay_steps))
    return (torch.clamp_min if form == _LR_DECAY_MIN
            else torch.clamp_max)(decayed, end)


def adam_direction(grad: torch.Tensor, st, eps: float):
    """One optax scale_by_adam step: updates the AdamState `st` in place,
    returns the bias-corrected direction mu_hat / (sqrt(nu_hat) + eps)."""
    st.count.add_(1)
    st.mu.copy_((1.0 - B1) * grad + B1 * st.mu)
    st.nu.copy_((1.0 - B2) * (grad * grad) + B2 * st.nu)
    count_f = st.count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(count_f, B1), count_f)
    bc2 = 1.0 - torch.pow(torch.full_like(count_f, B2), count_f)
    return (st.mu / bc1) / (torch.sqrt(st.nu / bc2) + eps)


def _group_rates(cfg) -> dict:
    return {"log_scales": cfg.lr_log_scales, "quats": cfg.lr_quats,
            "opacities": cfg.lr_opacities, "sh": cfg.lr_sh}


@torch.no_grad()
def apply_param_updates_torch(params: GaussianModel, grads: dict, opt_state,
                              cfg) -> None:
    """The plain twin: per-group Adam update + quaternion renormalisation,
    in place, in PyTorch ops on any device."""
    lrs = _group_rates(cfg)
    for label in LABELS:
        p = getattr(params, label)
        d = adam_direction(grads[label], opt_state.adam[label],
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


def _groups(params: GaussianModel, grads: dict, opt_state) -> list:
    """(label, parameter, gradient, AdamState) per group, in LABELS
    order."""
    return [(label, getattr(params, label), grads[label],
             opt_state.adam[label]) for label in LABELS]


def check_inputs(params: GaussianModel, grads: dict, opt_state) -> None:
    """Raise unless kernel H takes these tensors, on whatever device they
    lie: each group's parameter, gradient and moments contiguous f32
    tensors of one shape on the parameters' device, quats (N, 4), sh (N,
    K, 3); each count and the means schedule's count a () i32 tensor
    there."""
    dev = params.means.device
    for label, p, g, st in _groups(params, grads, opt_state):
        if label == "quats" and (p.dim() != 2 or p.shape[1] != 4):
            raise ValueError(f"quats: shape {tuple(p.shape)}, expected "
                             "(N, 4)")
        if label == "sh" and (p.dim() != 3 or p.shape[2] != 3):
            raise ValueError(f"sh: shape {tuple(p.shape)}, expected "
                             "(N, K, 3)")
        for t, name in ((p, ""), (g, " grad"), (st.mu, " mu"),
                        (st.nu, " nu")):
            cuda_lib.require(t, label + name, torch.float32, p.shape, dev)
        cuda_lib.require(st.count, label + " count", torch.int32, (), dev)
    cuda_lib.require(opt_state.means_lr_count, "means_lr_count",
                     torch.int32, (), dev)


@torch.no_grad()
def adam_update(params: GaussianModel, grads: dict, opt_state, cfg) -> None:
    """Kernel H: apply_param_updates_torch's update in place, in one
    launch on the current stream, reading and raising the counts on the
    device. The tensors as check_inputs takes them, on one CUDA device;
    anything else raises."""
    cuda_lib.require_cuda(params.means, "means")
    check_inputs(params, grads, opt_state)
    groups = _groups(params, grads, opt_state)
    lrs = _group_rates(cfg)

    def ptrs(ts):
        return (ctypes.c_void_p * len(LABELS))(*(t.data_ptr() for t in ts))

    form, init, end, rate, inv_steps = _schedule(cfg)
    lib = cuda_lib.library()
    cuda_lib.check("adam", lib.gsplat_adam_update(
        ptrs(p for _, p, _, _ in groups), ptrs(g for _, _, g, _ in groups),
        ptrs(st.mu for *_, st in groups), ptrs(st.nu for *_, st in groups),
        ptrs(st.count for *_, st in groups),
        (ctypes.c_longlong * len(LABELS))(*(p.numel()
                                            for _, p, _, _ in groups)),
        (ctypes.c_float * len(LABELS))(*(-lrs.get(label, 0.0)
                                         for label in LABELS)),
        opt_state.means_lr_count.data_ptr(),
        (ctypes.c_float * 10)(B1, 1.0 - B1, B2, 1.0 - B2, cfg.adam_eps,
                              init, end, rate, inv_steps,
                              cfg.sh_rest_lr_scale),
        form, 3 * params.sh.shape[1],
        cuda_lib.stream_handle(params.means.device)))
    cuda_lib.launches["adam"] += 1


@torch.no_grad()
def apply_param_updates(params: GaussianModel, grads: dict, opt_state,
                        cfg) -> None:
    """Per-group Adam update + quaternion renormalisation, in place:
    kernel H on CUDA, the plain twin on the CPU (module docstring)."""
    if params.means.is_cuda:
        adam_update(params, grads, opt_state, cfg)
    else:
        apply_param_updates_torch(params, grads, opt_state, cfg)
