"""The train step as an engine program (train/trainer.py::register_step,
runtime/engine.py with grad=True). On the CPU the program runs eagerly:
3 runs equal 3 train_step calls bit for bit, register leaves the state as
it was, the example camera and target are the engine's own copies, and
fit's steps equal a loop of train_step. On a CUDA card (marked `cuda`,
skipped without one) the step is captured: after register the state
equals its snapshot bit for bit, replays count no launch, and each of 3
replays matches the eager step from the same state within kernel D's
row-scaled bound (atomics reorder the gradient sums)."""

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
from gaussian_splat_ipu_tpu_torch.train import trainer
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig)

torch.set_num_threads(1)

CFG = RasterConfig(image_width=64, image_height=48, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 13)
TC = trainer.TrainConfig(scene_extent=1.5)
# |got - ref| <= TOL_ROW * max |ref column| + TOL_REL * |ref|, the
# backward kernel's bound (chip_smoke.py TOL_BWD_*), per parameter
# component over all gaussians.
TOL_ROW, TOL_REL = 1e-4, 1e-3


def _views(device, n=3, seed=0):
    """n orbit cameras and targets rendered from another model, so every
    step has a gradient."""
    g = torch.Generator().manual_seed(seed)
    src = GaussianModel.random(400, generator=g, device="cpu")
    with torch.no_grad():
        src.log_scales += 1.0
    cams, targets = [], []
    for i in range(n):
        cam = Camera.orbit(-np.ones(3), np.ones(3), 0.8, 64 / 48,
                           rot_y_deg=40.0 * i, device="cpu")
        with torch.no_grad():
            targets.append(render(src, cam, CFG).image.to(device))
        cams.append(cam.to(device))
    return cams, targets


def _state(device, n=300, seed=1):
    g = torch.Generator().manual_seed(seed)
    model = GaussianModel.random(n, generator=g, device="cpu")
    with torch.no_grad():
        model.log_scales += 1.0
    return trainer.init_state(
        GaussianModel.from_numpy(model.to_numpy(), device).trainable(), TC)


def _copy(state, device):
    return trainer.TrainState.from_numpy(state.to_numpy(), device)


def _assert_leaves_equal(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


def test_registered_step_equals_train_step_bit_for_bit():
    cams, targets = _views("cpu")
    state = _state("cpu")
    twin = _copy(state, "cpu")
    before = state.to_numpy()
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    prog = trainer.register_step(eng, state, cams[0], targets[0], CFG, TC)
    assert prog.grad and prog.graph is None and prog.compile_seconds == 0.0
    _assert_leaves_equal(state.to_numpy(), before)
    for cam, target in zip(cams, targets):
        loss = eng.run(trainer.STEP_PROGRAM, state, cam, target)
        _, want = trainer.train_step(twin, cam, target, CFG, TC)
        assert torch.equal(loss, want) and float(loss) > 0.0
        assert not loss.requires_grad
    _assert_leaves_equal(state.to_numpy(), twin.to_numpy())
    assert int(state.step) == 3
    assert int(state.opt_state.adam["means"].count) == 3


def test_register_step_owns_copies_of_the_example_camera_and_target():
    cams, targets = _views("cpu", n=1)
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    prog = trainer.register_step(eng, _state("cpu"), cams[0], targets[0],
                                 CFG, TC)
    cam, target = prog.in_leaves[-2:]
    assert isinstance(cam, Camera) and cam.view is not cams[0].view
    assert torch.equal(cam.view, cams[0].view)
    assert target is not targets[0] and torch.equal(target, targets[0])


def test_fit_runs_its_steps_through_the_program():
    cams, targets = _views("cpu", n=2)
    model = GaussianModel.from_numpy(_state("cpu").params.to_numpy(), "cpu")
    trained, history = trainer.fit(model, cams, targets, CFG, TC,
                                   num_steps=4)
    twin = trainer.init_state(model.trainable(), TC)
    want = [float(trainer.train_step(twin, cams[i % 2], targets[i % 2],
                                     CFG, TC)[1]) for i in range(4)]
    assert history == want
    for k, v in trained.to_numpy().items():
        np.testing.assert_array_equal(v, getattr(twin.params, k)
                                      .detach().numpy(), err_msg=k)


def test_grad_programs_run_with_autograd_on_the_cpu_engine():
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    w = torch.ones(3, requires_grad=True)

    def step(x):
        (g,) = torch.autograd.grad((w * x).sum(), (w,))
        with torch.no_grad():
            w.sub_(g)
        return g

    eng.register("sgd", step, (torch.ones(3),), grad=True)
    assert torch.equal(w, torch.ones(3))          # nothing ran
    eng.run("sgd", torch.full((3,), 2.0))
    assert torch.equal(w.detach(), torch.full((3,), -1.0))
    # A render program runs under inference mode: no autograd.
    eng.register("render_like", step, (torch.ones(3),))
    with pytest.raises(RuntimeError):
        eng.run("render_like", torch.ones(3))


def _within(name, got, ref, extra=None):
    """got within the row-scaled bound of ref, by component column; extra
    (bool mask) marks entries allowed past it. Returns the max error."""
    g = got.reshape(got.shape[0], -1).double()
    r = ref.reshape(ref.shape[0], -1).double()
    bound = TOL_ROW * r.abs().amax(dim=0, keepdim=True) + TOL_REL * r.abs()
    bad = (g - r).abs() > bound
    if extra is not None:
        bad &= ~extra.reshape(bad.shape)
    assert not bool(bad.any()), (name, int(bad.sum()))
    return float((g - r).abs().max())


@pytest.mark.cuda
def test_captured_step_matches_eager_steps():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode "
                    "(chip_smoke.py's engine phase runs this at full size)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = RasterConfig(image_width=64, image_height=48, tile_width=16,
                       tile_height=16, chunk_size=32, pair_capacity=1 << 13,
                       tile_group=2, exact_tile_test=True)
    cams, targets = _views(dev)
    state = _state(dev, n=1500)
    snapshot = state.to_numpy()
    eng = RenderEngine(RuntimeConfig(device="cuda"))
    cuda_lib.launches.clear()
    prog = trainer.register_step(eng, state, cams[0], targets[0], cfg, TC)
    assert prog.graph is not None
    _assert_leaves_equal(state.to_numpy(), snapshot)
    captured = dict(cuda_lib.launches)
    for k in ("rasterize_strict_aux", "rasterize_bwd", "coverage_masks"):
        assert captured[k] == engine_lib.WARMUP_CALLS + 1, captured
    for cam, target in zip(cams, targets):
        eager = _copy(state, dev)       # each step from the same state
        before = dict(cuda_lib.launches)
        loss = eng.run(trainer.STEP_PROGRAM, state, cam, target)
        assert dict(cuda_lib.launches) == before     # a replay launches none
        _, want = trainer.train_step(eager, cam, target, cfg, TC)
        torch.cuda.synchronize()
        _within("loss", loss[None], want[None])
        for label in trainer.LABELS:
            a, b = state.opt_state.adam[label], eager.opt_state.adam[label]
            assert torch.equal(a.count, b.count)
            _within(f"{label} mu", a.mu, b.mu)
            _within(f"{label} nu", a.nu, b.nu)
            # Where the reference moment is itself within its bound of
            # zero, the bound does not fix the sign of Adam's step.
            mu = b.mu.reshape(b.mu.shape[0], -1).double()
            free = (mu.abs() <= TOL_ROW * mu.abs().amax(0, keepdim=True)
                    + TOL_REL * mu.abs()).any(dim=1, keepdim=True)
            p, q = getattr(state.params, label), getattr(eager.params, label)
            dp = (p - q).detach().reshape(p.shape[0], -1).abs()
            _within(label, p.detach(), q.detach(),
                    extra=free & (dp <= 4 * max(TC.lr_means * TC.scene_extent,
                                                TC.lr_log_scales, TC.lr_quats,
                                                TC.lr_opacities, TC.lr_sh)))
        assert torch.equal(state.opt_state.means_lr_count,
                           eager.opt_state.means_lr_count)
        assert torch.equal(state.step, eager.step)
    assert int(state.step) == 3
