"""The train step as an engine program (train/trainer.py::register_step,
runtime/engine.py with grad=True). On the CPU the program runs eagerly:
3 runs equal 3 train_step calls bit for bit, register leaves the state as
it was, the example camera and target are the engine's own copies, and
fit's steps equal a loop of train_step. On a CUDA card (marked `cuda`,
skipped without one) the step is captured: after register the state
equals its snapshot bit for bit, its projection runs kernels G and G-bwd
(no plain call), replays count no launch, and each of 3
replays matches the eager step from the same state within kernel D's
row-scaled bound (atomics reorder the gradient sums)."""

import dataclasses

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render import projection
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
from gaussian_splat_ipu_tpu_torch.train import (adam, aux_opt, densify,
                                                depth, trainer)
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
    projection.plain_calls.clear()
    prog = trainer.register_step(eng, state, cams[0], targets[0], cfg, TC)
    assert prog.graph is not None
    _assert_leaves_equal(state.to_numpy(), snapshot)
    captured = dict(cuda_lib.launches)
    for k in ("rasterize_strict_aux", "rasterize_bwd", "coverage_masks",
              "project_gaussians", "project_gaussians_bwd"):
        assert captured[k] == engine_lib.WARMUP_CALLS + 1, captured
    assert not projection.plain_calls
    for cam, target in zip(cams, targets):
        eager = _copy(state, dev)       # each step from the same state
        before = dict(cuda_lib.launches)
        loss = eng.run(trainer.STEP_PROGRAM, state, cam, target)
        assert dict(cuda_lib.launches) == before     # a replay launches none
        _, want = trainer.train_step(eager, cam, target, cfg, TC)
        torch.cuda.synchronize()
        _within("loss", loss[None], want[None])
        for label in adam.LABELS:
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


def _densify_state(device, n=300, cap=400):
    state = _state("cpu", n=n)
    model = densify.pad_model(GaussianModel.from_numpy(
        state.params.to_numpy(), device), cap)
    return (trainer.init_state(model.trainable(), TC),
            densify.init_state(n, cap, device=device))


def _depth_pack(device, views=3):
    rng = np.random.default_rng(3)
    return depth.pack_observations(
        [rng.uniform([0, 0, 2.0], [64, 48, 5.0], (20 + 5 * k, 3)).astype(
            np.float32) for k in range(views)], device=device)


def _densify_leaves(state, dstate):
    return state.to_numpy() + dstate.to_numpy()[:3]


def test_registered_densify_and_aux_steps_equal_their_eager_steps():
    """On the CPU the densify program (with depth, the view index picking
    the packed rows) and the aux program equal their step functions bit
    for bit."""
    cams, targets = _views("cpu")
    obs_all, mask_all = _depth_pack("cpu")
    state, d = _densify_state("cpu")
    twin, dtwin = (trainer.TrainState.from_numpy(state.to_numpy(), "cpu"),
                   densify.DensifyState.from_numpy(d.to_numpy(), "cpu"))
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    vi = torch.zeros((), dtype=torch.int64)
    densify.register_step(eng, state, d, cams[0], targets[0], CFG, TC, 0.1,
                          vi, obs_all, mask_all)
    step = densify.make_train_step(CFG, TC, 0.1)
    for k, (cam, target) in enumerate(zip(cams, targets)):
        loss = eng.run(densify.STEP_PROGRAM, state, d.grad_sum, d.vis_count,
                       torch.tensor(k), cam, target, obs_all, mask_all)
        want = step(twin, dtwin.grad_sum, dtwin.vis_count, cam, target,
                    obs_all[k], mask_all[k])
        assert torch.equal(loss, want)
    _assert_leaves_equal(_densify_leaves(state, d),
                         _densify_leaves(twin, dtwin))
    assert int(d.vis_count.max()) == 3

    state = _state("cpu")
    twin = _copy(state, "cpu")
    aux = aux_opt.init_aux_state(3, 1e-3, 1e-2, device="cpu")
    aux_twin = aux_opt.init_aux_state(3, 1e-3, 1e-2, device="cpu")
    aux_opt.register_step(eng, state, aux, vi, cams[0], targets[0], obs_all,
                          mask_all, CFG, TC, 1e-3, 1e-2, 0.1)
    step = aux_opt.make_aux_step(CFG, TC, 1e-3, 1e-2, 0.1)
    for k in (2, 0):
        loss = eng.run(aux_opt.STEP_PROGRAM, state, aux, torch.tensor(k),
                       cams[k], targets[k], obs_all, mask_all)
        want = step(twin, aux_twin, torch.tensor(k), cams[k], targets[k],
                    obs_all[k], mask_all[k])
        assert torch.equal(loss, want)
    _assert_leaves_equal(state.to_numpy() + aux.to_numpy(),
                         twin.to_numpy() + aux_twin.to_numpy())


def test_registering_a_name_again_replaces_its_program():
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    first = eng.register("p", lambda x: x + 1, (torch.ones(2),))
    second = eng.register("p", lambda x: x * 3, (torch.ones(2),))
    assert eng.programs["p"] is second and first.in_leaves == ()
    assert torch.equal(eng.run("p", torch.ones(2)), torch.full((2,), 3.0))
    eng.release("p")
    eng.release("p")                    # nothing left: a no-op
    assert "p" not in eng.programs


def _cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode "
                    "(chip_smoke.py phase 14 runs this at full size)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


GROUP_CFG = RasterConfig(image_width=64, image_height=48, tile_width=16,
                         tile_height=16, chunk_size=32,
                         pair_capacity=1 << 13, tile_group=2,
                         exact_tile_test=True)


@pytest.mark.cuda
def test_captured_densify_step_matches_eager_steps():
    """The densify step with depth captured: replays count no launch, and
    each matches the eager step from the same state (loss and grad_sum
    within D's row-scaled bound, vis_count equal)."""
    dev = _cuda_device()
    cams, targets = _views(dev)
    obs_all, mask_all = _depth_pack(dev)
    state, d = _densify_state(dev, n=1500, cap=2048)
    snapshot = _densify_leaves(state, d)
    eng = RenderEngine(RuntimeConfig(device="cuda"))
    cuda_lib.launches.clear()
    projection.plain_calls.clear()
    densify.register_step(eng, state, d, cams[0], targets[0], GROUP_CFG, TC,
                          0.1, torch.zeros((), dtype=torch.int64, device=dev),
                          obs_all, mask_all)
    _assert_leaves_equal(_densify_leaves(state, d), snapshot)
    captured = dict(cuda_lib.launches)
    # The image render (with the probe) and the depth render.
    for k in ("rasterize_strict_aux", "rasterize_bwd", "project_gaussians",
              "project_gaussians_bwd"):
        assert captured[k] == 2 * (engine_lib.WARMUP_CALLS + 1), captured
    assert not projection.plain_calls
    step = densify.make_train_step(GROUP_CFG, TC, 0.1)
    for k, (cam, target) in enumerate(zip(cams, targets)):
        eager = _copy(state, dev)
        ed = densify.DensifyState.from_numpy(d.to_numpy(), dev)
        before = dict(cuda_lib.launches)
        loss = eng.run(densify.STEP_PROGRAM, state, d.grad_sum, d.vis_count,
                       torch.tensor(k), cam, target, obs_all, mask_all)
        assert dict(cuda_lib.launches) == before
        want = step(eager, ed.grad_sum, ed.vis_count, cam, target,
                    obs_all[k], mask_all[k])
        torch.cuda.synchronize()
        _within("loss", loss[None], want[None])
        _within("grad_sum", d.grad_sum, ed.grad_sum)
        assert torch.equal(d.vis_count, ed.vis_count)
        assert torch.equal(state.step, eager.step)
    assert int(d.vis_count.max()) == 3


@pytest.mark.cuda
def test_captured_aux_step_matches_eager_steps():
    """Pose + exposure + depth in one captured program: replays match the
    eager aux step from the same state within D's bound."""
    dev = _cuda_device()
    cams, targets = _views(dev)
    obs_all, mask_all = _depth_pack(dev)
    state = _state(dev, n=1500)
    aux = aux_opt.init_aux_state(3, 1e-3, 1e-2, device=dev)
    eng = RenderEngine(RuntimeConfig(device="cuda"))
    aux_opt.register_step(eng, state, aux, torch.zeros(
        (), dtype=torch.int64, device=dev), cams[0], targets[0], obs_all,
        mask_all, GROUP_CFG, TC, 1e-3, 1e-2, 0.1)
    step = aux_opt.make_aux_step(GROUP_CFG, TC, 1e-3, 1e-2, 0.1)
    for k in (1, 2, 0):
        eager = _copy(state, dev)
        eaux = aux_opt.AuxState.from_numpy(aux.to_numpy(), dev, True, True)
        loss = eng.run(aux_opt.STEP_PROGRAM, state, aux, torch.tensor(k),
                       cams[k], targets[k], obs_all, mask_all)
        want = step(eager, eaux, torch.tensor(k, device=dev), cams[k],
                    targets[k], obs_all[k], mask_all[k])
        torch.cuda.synchronize()
        _within("loss", loss[None], want[None])
        _within("deltas", aux.pose.deltas, eaux.pose.deltas)
        _within("mats", aux.exposure.mats, eaux.exposure.mats)
        assert torch.equal(aux.pose.opt_state.count,
                           eaux.pose.opt_state.count)


@pytest.mark.cuda
def test_registering_again_frees_the_old_graph_pool():
    """Three more captures of one train program under the same name leave
    the allocator's reserved bytes where the first left them (within half
    a capture's own reservation)."""
    dev = _cuda_device()
    cams, targets = _views(dev)
    state = _state(dev, n=1500)
    eng = RenderEngine(RuntimeConfig(device="cuda"))
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved(dev)
    trainer.register_step(eng, state, cams[0], targets[0], GROUP_CFG, TC)
    r1 = torch.cuda.memory_reserved(dev)
    for degree in (0, 1, 2):
        cfg = dataclasses.replace(GROUP_CFG, active_sh_degree=degree)
        trainer.register_step(eng, state, cams[0], targets[0], cfg, TC)
    r4 = torch.cuda.memory_reserved(dev)
    assert r1 > r0 and r4 <= r1 + 0.5 * (r1 - r0), (r0, r1, r4)
