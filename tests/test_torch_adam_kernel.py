"""Kernel H (train/adam.py, csrc/adam.cu) and apply_param_updates' choice
of path: CPU calls take the plain twin and launch nothing; the wrapper's
input checks; the means schedule's constants. On a CUDA card (marked
`cuda`, skipped without one) H equals the plain twin bit for bit over
five updates, every leaf of the state, counts included, replayed from a
CUDA graph as eager, one launch an update; a CUDA call H does not take
raises and launches nothing. The
twin's agreement with optax is tests/test_torch_train.py's. This file
imports no JAX: its cuda tests run on the card with --noconftest."""

import dataclasses

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.train import adam, trainer

torch.set_num_threads(1)


def make_state(device, n, sh_degree, seed=0, dead=0, cfg=None):
    """A TrainState of n gaussians whose moments are those of a few
    earlier updates (normal mu, |normal| nu), the first `dead` rows' zero,
    as dead slots' are."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    p = dict(means=rng.normal(size=(n, 3)),
             log_scales=rng.uniform(-5.0, -2.0, (n, 3)),
             quats=rng.normal(size=(n, 4)),
             opacities=rng.normal(size=n),
             sh=rng.uniform(-1.0, 1.0, (n, k, 3)))
    state = trainer.init_state(
        GaussianModel.from_numpy(p, device).trainable(),
        cfg or trainer.TrainConfig())
    for label in adam.LABELS:
        st = state.opt_state.adam[label]
        mu = rng.normal(size=tuple(st.mu.shape)) * 1e-2
        nu = np.abs(rng.normal(size=tuple(st.nu.shape))) * 1e-4
        mu[:dead], nu[:dead] = 0.0, 0.0
        st.mu.copy_(torch.tensor(mu, dtype=torch.float32))
        st.nu.copy_(torch.tensor(nu, dtype=torch.float32))
        st.count.fill_(3)
    state.opt_state.means_lr_count.fill_(3)
    return state


def make_grads(state, seed, dead=0) -> dict:
    """Normal gradients of every parameter, the first `dead` rows zero."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    for k in FIELDS:
        p = getattr(state.params, k)
        g = torch.randn(p.shape, generator=gen) * 0.1
        g[:dead] = 0.0
        out[k] = g.to(p.device)
    return out


def copy_state(state):
    return trainer.TrainState.from_numpy(state.to_numpy(),
                                         state.params.device)


def assert_states_equal(got, want):
    """Every leaf of the two states equal bit for bit."""
    a, b = got.to_numpy(), want.to_numpy()
    assert len(a) == len(b) == 22
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert np.array_equal(x, y, equal_nan=True), (
            f"leaf {i}: {int((x != y).sum())} of {x.size} differ, max "
            f"{float(np.abs(x.astype(np.float64) - y).max())}")


# -- CPU --------------------------------------------------------------------

@pytest.mark.parametrize("sh_degree", [0, 1, 3])
def test_cpu_calls_take_the_plain_twin_and_launch_nothing(sh_degree):
    """A CPU call runs the plain twin: no launch, the twin's state bit
    for bit."""
    cfg = trainer.TrainConfig(lr_means_decay_steps=2)
    got = make_state("cpu", 37, sh_degree, dead=5)
    want = copy_state(got)
    launches = dict(cuda_lib.launches)
    for step in range(3):
        grads = make_grads(got, step, dead=5)
        trainer.apply_param_updates(got.params, grads, got.opt_state, cfg)
        adam.apply_param_updates_torch(want.params, grads, want.opt_state,
                                       cfg)
    assert dict(cuda_lib.launches) == launches
    assert_states_equal(got, want)
    assert int(got.opt_state.adam["sh"].count) == 6
    assert int(got.opt_state.means_lr_count) == 6


def refusal_cases():
    """name -> (what to change in a state's call, the message expected
    from the input checks, None where they take the call)."""
    return {
        "plain": (None, None),
        "f64_grad": (("grad", "means", torch.float64),
                     "means grad: dtype torch.float64"),
        "bf16_moment": (("mu", "sh", torch.bfloat16),
                        "sh mu: dtype torch.bfloat16"),
        "strided_grad": (("grad", "quats", "strided"),
                         "quats grad: not contiguous"),
        "strided_moment": (("nu", "opacities", "strided"),
                           "opacities nu: not contiguous"),
    }


def changed_call(change, device="cpu", n=16, sh_degree=1):
    """(params, grads, opt_state) of a state with `change` made: one
    tensor (kind, label) cast to a dtype, reshaped, or made non-contiguous
    with the same values ("strided")."""
    state = make_state(device, n, sh_degree)
    grads = make_grads(state, 0)
    opt = state.opt_state
    if change is not None:
        kind, label, how = change
        st = opt.adam[label]
        t = grads[label] if kind == "grad" else getattr(st, kind)
        if how == "strided":
            t = torch.stack([t, t], -1)[..., 0]
        elif isinstance(how, tuple):
            t = t.reshape(how)
        else:
            t = t.to(how)
        if kind == "grad":
            grads[label] = t
        else:
            adam_st = st._replace(**{kind: t})
            opt = opt._replace(adam={**opt.adam, label: adam_st})
    return state.params, grads, opt


@pytest.mark.parametrize("name", list(refusal_cases()))
def test_the_input_checks_take_only_contiguous_f32(name):
    """On the card every call goes to kernel H, so a dtype or a layout it
    does not take is refused, never sent down another path."""
    change, match = refusal_cases()[name]
    call = changed_call(change)
    if match is None:
        adam.check_inputs(*call)
    else:
        with pytest.raises(ValueError, match=match):
            adam.check_inputs(*call)


@pytest.mark.parametrize("change,match", [
    (("mu", "sh", torch.float64), "sh mu: dtype torch.float64"),
    (("grad", "log_scales", torch.float64), "log_scales grad: dtype"),
    (("nu", "means", "strided"), "means nu: not contiguous"),
    (("grad", "quats", "strided"), "quats grad: not contiguous"),
    (("mu", "opacities", (4, 4)), r"opacities mu: shape \(4, 4\)"),
    (("nu", "sh", (16, 2, 6)), r"sh nu: shape \(16, 2, 6\)"),
], ids=["f64_moment", "f64_grad", "strided_moment", "strided_grad",
        "misshaped_moment", "misshaped_sh_moment"])
def test_the_input_checks_refuse(change, match):
    with pytest.raises(ValueError, match=match):
        adam.check_inputs(*changed_call(change))


def test_the_input_checks_refuse_counts_and_shapes():
    params, grads, opt = changed_call(None)
    adam.check_inputs(params, grads, opt)
    bad = opt._replace(means_lr_count=opt.means_lr_count.long())
    with pytest.raises(ValueError, match="means_lr_count: dtype"):
        adam.check_inputs(params, grads, bad)
    st = opt.adam["quats"]
    bad = opt._replace(adam={**opt.adam, "quats": st._replace(
        count=st.count.reshape(1))})
    with pytest.raises(ValueError, match=r"quats count: shape \(1,\)"):
        adam.check_inputs(params, grads, bad)
    flat = GaussianModel(*(getattr(params, k).detach() for k in FIELDS[:4]),
                         params.sh.detach().reshape(16, -1))
    with pytest.raises(ValueError, match=r"sh: shape \(16, 12\)"):
        adam.check_inputs(flat, grads, opt)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    launches = dict(cuda_lib.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adam.adam_update(*changed_call(None), trainer.TrainConfig())
    assert dict(cuda_lib.launches) == launches


@pytest.mark.parametrize("change,form", [
    ({}, adam._LR_DECAY_MIN),
    (dict(lr_means_decay_steps=2, scene_extent=2.0), adam._LR_DECAY_MIN),
    (dict(lr_means_final=1e-2), adam._LR_DECAY_MAX),
    (dict(lr_means_decay_steps=0), adam._LR_CONST),
    (dict(lr_means_final=0.0), adam._LR_CONST),
    (dict(lr_means=0.0), adam._LR_DECAY_MAX),
], ids=["default", "decay2", "rising", "no_decay", "zero_final",
        "frozen"])
def test_schedule_constants_give_means_lr(change, form):
    """Kernel H's schedule (adam._schedule, evaluated as the kernel does,
    in f32 with the reciprocal of the step count) follows means_lr over
    the first steps and past the decay's end."""
    cfg = dataclasses.replace(trainer.TrainConfig(), **change)
    got_form, init, end, rate, inv = adam._schedule(cfg)
    assert got_form == form
    f32 = np.float32
    for count in (0, 1, 2, 3, 7, 40_000):
        want = float(adam.means_lr(torch.tensor(count, dtype=torch.int32),
                                   cfg))
        if form == adam._LR_CONST:
            got = f32(init)
        else:
            dec = f32(init) if count <= 0 else f32(init) * np.power(
                f32(rate), f32(count) * f32(inv))
            got = (max if form == adam._LR_DECAY_MIN else min)(dec, f32(end))
        # Within 1e-5: the CPU's pow and division may round apart from
        # numpy's by an ulp; on the card H is held to the twin bit for bit.
        np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=0.0,
                                   err_msg=f"count {count}")


# -- the card ---------------------------------------------------------------

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel H has no CPU mode "
                    "(chip_smoke.py runs it at full size)")


# (SH degree, gaussians, lr_means_decay_steps, dead rows, unaligned
# moments): SH 0, 1 and 3; an odd N and 2^20 + 3, so that a unit and a
# group end inside a block; a decay of 2 steps, which reaches its floor;
# zero-gradient rows with zero moments, as dead slots have; every group's
# moments 4 bytes off 16-byte alignment (the scalar path).
CASES = [(0, 1001, 30_000, 0, False), (1, 1001, 30_000, 0, False),
         (3, 1001, 2, 0, False), (3, (1 << 20) + 3, 30_000, 0, False),
         (3, 4099, 2, 1000, False), (1, 777, 30_000, 0, True)]


def case_id(case):
    degree, n, steps, dead, unaligned = case
    return (f"sh{degree},n={n},decay={steps}" + (f",dead={dead}" if dead
                                                  else "")
            + (",unaligned" if unaligned else ""))


def unaligned(state):
    """The state with every moment moved to a contiguous view 4 bytes past
    a 16-byte boundary, same values."""
    adam_states = {}
    for label, st in state.opt_state.adam.items():
        views = []
        for t in (st.mu, st.nu):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            v = buf[1:].view(t.shape)
            v.copy_(t)
            assert v.is_contiguous() and v.data_ptr() % 16 == 4
            views.append(v)
        adam_states[label] = st._replace(mu=views[0], nu=views[1])
    return state._replace(opt_state=state.opt_state._replace(
        adam=adam_states))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_matches_the_plain_twin_on_the_card(case):
    need_card()
    degree, n, steps, dead, shifted = case
    cfg = trainer.TrainConfig(lr_means_decay_steps=steps)
    got = make_state("cuda", n, degree, seed=degree, dead=dead)
    want = copy_state(got)
    if shifted:
        got = unaligned(got)
    cuda_lib.launches.clear()
    for step in range(5):
        grads = make_grads(got, 10 + step, dead=dead)
        trainer.apply_param_updates(got.params, grads, got.opt_state, cfg)
        adam.apply_param_updates_torch(want.params, grads, want.opt_state,
                                       cfg)
    torch.cuda.synchronize()
    assert cuda_lib.launches["adam"] == 5
    assert_states_equal(got, want)
    if dead:   # zero gradients and moments: the parameters stay
        start = make_state("cuda", n, degree, seed=degree, dead=dead)
        for k in ("means", "log_scales", "opacities", "sh"):
            assert torch.equal(getattr(got.params, k)[:dead],
                               getattr(start.params, k)[:dead]), k


@pytest.mark.cuda
def test_a_replayed_update_equals_the_eager_one():
    """One update captured in a CUDA graph and replayed twice equals two
    eager updates (and the plain twin's), the counts raised on the device
    at each replay."""
    need_card()
    cfg = trainer.TrainConfig(lr_means_decay_steps=2)
    state = make_state("cuda", 3001, 3, seed=5)
    eager, twin = copy_state(state), copy_state(state)
    grads = make_grads(state, 7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    warm = copy_state(state)
    with torch.cuda.stream(side):
        trainer.apply_param_updates(warm.params, grads, warm.opt_state, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        trainer.apply_param_updates(state.params, grads, state.opt_state,
                                    cfg)
    cuda_lib.launches.clear()
    for _ in range(2):
        graph.replay()
        trainer.apply_param_updates(eager.params, grads, eager.opt_state,
                                    cfg)
        adam.apply_param_updates_torch(twin.params, grads, twin.opt_state,
                                       cfg)
    torch.cuda.synchronize()
    assert cuda_lib.launches["adam"] == 2    # the eager ones only
    assert int(state.opt_state.adam["means"].count) == 5
    assert int(state.opt_state.means_lr_count) == 5
    assert_states_equal(state, eager)
    assert_states_equal(state, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["f64_grad", "strided_moment"])
def test_a_cuda_call_kernel_h_does_not_take_raises(name):
    """A CUDA call with another dtype or layout raises before kernel H
    launches, and leaves the state as it was: no plain path on the card."""
    need_card()
    change, match = refusal_cases()[name]
    params, grads, opt = changed_call(change, device="cuda")
    before = [t.clone() for st in opt.adam.values() for t in st] + [
        getattr(params, k).detach().clone() for k in FIELDS]
    cuda_lib.launches.clear()
    with pytest.raises(ValueError, match=match):
        trainer.apply_param_updates(params, grads, opt, trainer.TrainConfig())
    torch.cuda.synchronize()
    assert cuda_lib.launches["adam"] == 0
    after = [t for st in opt.adam.values() for t in st] + [
        getattr(params, k).detach() for k in FIELDS]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
