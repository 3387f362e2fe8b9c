"""Kernel G-bwd (render/kernels/project.py::project_bwd) and its plain
twin, project_gaussians_bwd_torch: on the CPU the twin equals autograd of
the plain projection in float64, the view matrix's gradient too,
compare_bwd's bound holds the twin in f32 and counts planted faults, and
projection.py's autograd Function (G forward, G-bwd backward) routes its
gradients as autograd does, the view's too, with the kernels replaced by
their plain versions; on a CUDA card (marked `cuda`, skipped without one)
G-bwd is as accurate as PyTorch's f32 autograd of the plain version,
gives exact zeros where its cotangents are zero, reads strided
cotangents, and its view gradient at 2^20 SH 3 is as accurate as the f32
twin's. This file imports no JAX: its cuda tests run on the card with
--noconftest."""

import dataclasses

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import FIELDS, GaussianModel
from gaussian_splat_ipu_tpu_torch.render import projection
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.render.kernels import project as kernel
from test_torch_project_kernel import CASES, CFG, camera, case_id, scene

torch.set_num_threads(1)

# Autograd and the twin sum the same terms in other orders: in float64
# that leaves a few ulps of the largest term, far under these.
RTOL64, ATOL64 = 1e-9, 1e-12


def active_degree(model, cfg):
    return (model.sh_degree if cfg.active_sh_degree < 0
            else min(model.sh_degree, cfg.active_sh_degree))


def cast(model, camera_, dtype, requires_grad=True):
    """The model (requiring grad) and camera in `dtype`."""
    m = GaussianModel(*(getattr(model, k).detach().to(dtype)
                        for k in FIELDS), requires_grad=requires_grad,
                      dtype=dtype)
    cam = Camera(camera_.view.to(dtype), camera_.proj.to(dtype))
    cam.env_rot = camera_.env_rot.to(dtype)
    return m, cam


def cotangents(splats, zero_culled: bool, seed=7):
    """Normal cotangents of the five differentiable outputs; zero for the
    culled gaussians (as kernel D gives them) when zero_culled."""
    rng = np.random.default_rng(seed)
    culled = splats.radius[:, 0] == 0
    out = []
    for t in splats[:5]:
        c = torch.tensor(rng.normal(size=t.shape), dtype=t.dtype,
                         device=t.device)
        if zero_culled:
            c = torch.where(culled.reshape(c.shape[:1] + (1,) * (c.dim() - 1)),
                            0.0, c)
        out.append(c)
    return out


def autograd_of_plain(model, cam, cfg, cots, probe: bool):
    """torch.autograd.grad of the plain projection: the five fields'
    gradients and, with `probe`, the xy probe's."""
    xy_probe = (torch.zeros_like(model.means[:, :2], requires_grad=True)
                if probe else None)
    sp = projection.project_gaussians_torch(model, cam, cfg, xy_probe)
    used = [(o, c) for o, c in zip(sp[:5], cots) if c is not None]
    inputs = [getattr(model, k) for k in FIELDS] + (
        [xy_probe] if probe else [])
    grads = torch.autograd.grad([o for o, _ in used], inputs,
                                [c for _, c in used], allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, inputs)]


def scale(t) -> float:
    """The largest finite magnitude in t (1.0 if none)."""
    fin = t[torch.isfinite(t)]
    return float(fin.abs().max()) if fin.numel() else 1.0


def structural_zeros_kept(got, want, name, also=None):
    """Where autograd's gradient `want` (and `also`, if given) is exactly
    zero, got is too: row by row for the per-gaussian vectors, whose
    components can cancel to zero in one order and not another, element by
    element for the opacity and SH gradients, which are single products."""
    zero = want == 0
    if also is not None:
        zero &= also == 0
    if name in ("opacities", "sh"):
        return not bool((zero & (got != 0)).any())
    return not bool((zero.all(-1) & (got != 0).any(-1)).any())


# -- CPU --------------------------------------------------------------------

@pytest.mark.parametrize("probe", [True, False], ids=["probe", "no_probe"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_twin_equals_autograd_of_the_plain_version_in_float64(case, probe):
    """The culled gaussians' cotangents zero (as D gives them); without a
    probe, no depth cotangent (as in a fit step). Live gaussians: the twin
    within RTOL64 / ATOL64 of autograd, NaN where autograd has NaN (the
    zero quaternion); autograd's structural zeros kept. Culled ones: exact
    zeros, where autograd gives zero or, through a 0 * inf, NaN."""
    degree, change, env_rot = case
    cfg = dataclasses.replace(CFG, **change)
    model, cam = cast(scene("cpu", sh_degree=degree, seed=degree + 1),
                      camera("cpu", env_rot), torch.float64)
    with torch.no_grad():
        sp = projection.project_gaussians_torch(model, cam, cfg)
    cots = cotangents(sp, zero_culled=True)
    if not probe:
        cots[1] = None
    want = autograd_of_plain(model, cam, cfg, cots, probe)
    got = kernel.project_gaussians_bwd_torch(
        *(getattr(model, k).detach() for k in FIELDS), cam.view, cam.proj,
        cam.env_rot, cfg, active_degree(model, cfg), cots, probe=probe)
    assert (got[-1] is None) == (not probe)
    live = sp.radius[:, 0] > 0
    assert 0 < int(live.sum()) < model.num_gaussians
    for name, g, w in zip(list(FIELDS) + ["probe"], got, want):
        torch.testing.assert_close(g[live], w[live], rtol=RTOL64,
                                   atol=ATOL64 * scale(w[live]),
                                   equal_nan=True, msg=name)
        assert structural_zeros_kept(g, w, name), name
        dead_g, dead_w = g[~live], w[~live]
        assert bool((dead_g == 0).all()), name
        assert bool(((dead_w == 0) | ~torch.isfinite(dead_w)).all()), name


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_twin_equals_autograd_with_every_cotangent_nonzero(case):
    """Nonzero cotangents on every gaussian, culled ones too: the twin
    follows autograd into the non-finite values of degenerate gaussians
    (the zero quaternion: quat_to_rotmat divides by a norm of 0; with
    antialias, a footprint of determinant 0)."""
    degree, change, env_rot = case
    cfg = dataclasses.replace(CFG, **change)
    model, cam = cast(scene("cpu", sh_degree=degree, seed=degree + 1),
                      camera("cpu", env_rot), torch.float64)
    with torch.no_grad():
        sp = projection.project_gaussians_torch(model, cam, cfg)
    cots = cotangents(sp, zero_culled=False)
    want = autograd_of_plain(model, cam, cfg, cots, probe=True)
    got = kernel.project_gaussians_bwd_torch(
        *(getattr(model, k).detach() for k in FIELDS), cam.view, cam.proj,
        cam.env_rot, cfg, active_degree(model, cfg), cots, probe=True)
    for name, g, w in zip(list(FIELDS) + ["probe"], got, want):
        torch.testing.assert_close(g, w, rtol=RTOL64,
                                   atol=ATOL64 * scale(w),
                                   equal_nan=True, msg=name)
        assert structural_zeros_kept(g, w, name), name
    zero_q = int(torch.nonzero((model.quats == 0).all(-1))[0, 0])
    assert bool(torch.isnan(got[2][zero_q]).all())


def test_the_scene_reaches_every_branch():
    """The scenes above hold gaussians behind the camera, off screen,
    beyond the 1.3 tan_fov clamp on both sides of both axes, with a
    colour channel clamped at 0, culled, and one zero quaternion; the SH
    bands above an active degree get zero gradient."""
    cfg = CFG
    model, cam = cast(scene("cpu", sh_degree=3, seed=4), camera("cpu"),
                      torch.float64)
    with torch.no_grad():
        sp = projection.project_gaussians_torch(model, cam, cfg)
        view_h = torch.cat([model.means, torch.ones_like(model.means[:, :1])],
                           -1) @ cam.view.T
        _, _, tan_x, tan_y = cam.focals(cfg.image_width, cfg.image_height)
        ratio = view_h[:, :2] / view_h[:, 2:3]
        lim = 1.3 * torch.stack([tan_x, tan_y])
    assert bool((sp.depth < 0).any())                      # behind
    assert bool(((sp.xy[:, 0] < 0) | (sp.xy[:, 0] > cfg.image_width)).any())
    for axis in (0, 1):
        assert bool((ratio[:, axis] > lim[axis]).any())
        assert bool((ratio[:, axis] < -lim[axis]).any())
    assert bool(((sp.color == 0) & (sp.radius[:, :1] > 0)).any())  # at 0
    assert bool((sp.radius[:, 0] == 0).any())
    assert bool((model.quats == 0).all(-1).any())
    # The conic's where() on det > eps takes its other side: the zero
    # quaternion's determinant is NaN.
    assert bool(torch.isnan(sp.conic).all(-1).any())
    cfg1 = dataclasses.replace(cfg, active_sh_degree=1)
    got = kernel.project_gaussians_bwd_torch(
        *(getattr(model, k).detach() for k in FIELDS), cam.view, cam.proj,
        cam.env_rot, cfg1, 1, cotangents(sp, zero_culled=True))
    assert bool((got[4][:, 4:] == 0).all())
    assert bool((got[4][:, :4] != 0).any())


def past_the_clamp(model, cam, cfg):
    """The model with 8 large, opaque gaussians appended, two past the 1.3
    tan_fov clamp on each side of each axis (at depths 2 and 3), each wide
    enough to reach the screen."""
    _, _, tan_x, tan_y = cam.focals(cfg.image_width, cfg.image_height)
    dt = model.means.dtype
    rows = []
    for axis, tan in ((0, tan_x), (1, tan_y)):
        for sign in (1.0, -1.0):
            for depth in (2.0, 3.0):
                p = torch.zeros(3, dtype=dt)
                p[2] = -depth
                p[axis] = sign * 1.6 * float(tan) * depth
                rows.append(p)
    p = torch.stack(rows)
    n, k = p.shape[0], model.sh.shape[1]
    r, t = cam.view[:3, :3].to(dt), cam.view[:3, 3].to(dt)
    g = torch.Generator().manual_seed(0)
    extra = dict(
        means=(p - t) @ r,
        log_scales=torch.log(0.2 * -p[:, 2:3]).expand(n, 3),
        quats=torch.randn((n, 4), generator=g, dtype=dt),
        opacities=torch.full((n,), 4.0, dtype=dt),
        sh=torch.rand((n, k, 3), generator=g, dtype=dt) - 0.5)
    return GaussianModel(*(torch.cat([getattr(model, f).detach(), extra[f]])
                           for f in FIELDS), dtype=dt)


def autograd_view_grad(model, cam, cfg, cots, rows):
    """torch.autograd.grad of the plain projection of the gaussians `rows`
    (a bool mask) with respect to the view matrix, as a leaf."""
    view = cam.view.detach().clone().requires_grad_(True)
    sub = GaussianModel(*(getattr(model, k).detach()[rows] for k in FIELDS),
                        dtype=model.means.dtype)
    posed = Camera(view, cam.proj)
    posed.env_rot = cam.env_rot
    sp = projection.project_gaussians_torch(sub, posed, cfg)
    used = [(o, c[rows]) for o, c in zip(sp[:5], cots)
            if c is not None and o.requires_grad]
    return torch.autograd.grad([o for o, _ in used], [view],
                               [c for _, c in used])[0]


VIEW_CASES = [(0, {}), (0, dict(antialias=True)), (3, {}),
              (3, dict(antialias=True))]


@pytest.mark.parametrize("case", VIEW_CASES,
                         ids=lambda c: case_id((*c, None)))
def test_twin_view_gradient_equals_autograd_in_float64(case):
    """The view matrix's gradient (project_bwd's seventh entry) of the
    twin against autograd of the plain projection with the view a leaf, in
    float64, at SH degrees 0 and 3, antialias off and on, an environment
    rotation on, depth's cotangent given: the culled gaussians' cotangents
    are zero (dead slots), and autograd is taken over the live gaussians
    alone (a dead zero quaternion's NaN would spread through autograd's
    sum; the twin adds nothing for a dead gaussian). Live gaussians lie
    past the 1.3 tan_fov clamp on both sides of both axes. Every
    cotangent zero: exact zeros."""
    degree, change = case
    cfg = dataclasses.replace(CFG, **change)
    model, cam = cast(scene("cpu", sh_degree=degree, seed=degree + 1),
                      camera("cpu", (0.3, -0.5)), torch.float64)
    model = past_the_clamp(model, cam, cfg)
    with torch.no_grad():
        sp = projection.project_gaussians_torch(model, cam, cfg)
        view_h = torch.cat([model.means, torch.ones_like(model.means[:, :1])],
                           -1) @ cam.view.T
        _, _, tan_x, tan_y = cam.focals(cfg.image_width, cfg.image_height)
        ratio = view_h[:, :2] / view_h[:, 2:3]
    live = sp.radius[:, 0] > 0
    for axis, tan in enumerate((tan_x, tan_y)):
        assert bool((live & (ratio[:, axis] > 1.3 * tan)).any())
        assert bool((live & (ratio[:, axis] < -1.3 * tan)).any())
    assert bool((~live).any()) and bool((model.quats[~live] == 0).all(-1)
                                        .any())
    cots = cotangents(sp, zero_culled=True)
    args = [getattr(model, k).detach() for k in FIELDS] + [
        cam.view, cam.proj, cam.env_rot, cfg, degree]
    got = kernel.project_gaussians_bwd_torch(*args, cots, view_grad=True)
    assert len(got) == 7 and got[-1].shape == (4, 4)
    want = autograd_view_grad(model, cam, cfg, cots, live)
    torch.testing.assert_close(got[-1], want, rtol=RTOL64,
                               atol=ATOL64 * scale(want))
    assert bool((want[:3].abs() > 1e-6 * scale(want)).all())
    zero = kernel.project_gaussians_bwd_torch(
        *args, [torch.zeros_like(c) for c in cots], view_grad=True)
    assert bool((zero[-1] == 0).all())


def test_zero_cotangents_give_exact_zeros():
    """Every cotangent zero (or absent): every gradient exactly zero, the
    probe's too, NaN-making gaussians included."""
    model, cam = cast(scene("cpu", sh_degree=3, seed=2), camera("cpu"),
                      torch.float32, requires_grad=False)
    n = model.num_gaussians
    cots = [torch.zeros((n, 2)), None, torch.zeros((n, 3)),
            torch.zeros((n, 3)), torch.zeros(n)]
    got = kernel.project_gaussians_bwd_torch(
        *(getattr(model, k) for k in FIELDS), cam.view, cam.proj,
        cam.env_rot, dataclasses.replace(CFG, antialias=True), 3, cots,
        probe=True)
    for g in got:
        assert bool((g == 0).all())


@pytest.mark.parametrize("zero_culled", [True, False],
                         ids=["culled_zero", "all_nonzero"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_compare_bwd_passes_the_f32_twin(case, zero_culled):
    """compare_bwd's bound on the CPU: the twin in f32, another order of
    the same f32 roundings than autograd's, reads within it, at a
    gaussian on the camera's origin too (huge a, b, c: the antialias
    factor's quotients)."""
    degree, change, env_rot = case
    cfg = dataclasses.replace(CFG, **change)
    model, cam = cast(scene("cpu", sh_degree=degree, seed=degree + 1),
                      camera("cpu", env_rot), torch.float32)
    with torch.no_grad():
        sp = projection.project_gaussians_torch(model, cam, cfg)
    cots = cotangents(sp, zero_culled)
    got = kernel.project_gaussians_bwd_torch(
        *(getattr(model, k).detach() for k in FIELDS), cam.view, cam.proj,
        cam.env_rot, cfg, active_degree(model, cfg), cots, probe=True)
    plain = autograd_of_plain(model, cam, cfg, cots, probe=True)
    m64, c64 = cast(model, cam, torch.float64)
    exact = autograd_of_plain(m64, c64, cfg, [c.double() for c in cots],
                              probe=True)
    live = (sp.radius[:, 0] > 0) if zero_culled else torch.ones_like(
        sp.radius[:, 0], dtype=torch.bool)
    res = kernel.compare_bwd(got, plain, exact, live)
    assert not kernel.compare_bwd_failures(res), res


def test_compare_bwd_counts_faults():
    """Autograd's gradients with the culled gaussians zeroed pass; a
    gradient off by 1e-3 of its row, a NaN autograd has not, a lost
    structural zero and a nonzero culled gaussian each count."""
    model, cam = cast(scene("cpu", n=600, sh_degree=1, seed=2),
                      camera("cpu"), torch.float32)
    with torch.no_grad():
        sp = projection.project_gaussians_torch(model, cam, CFG)
    cots = cotangents(sp, zero_culled=True)
    cfg = dataclasses.replace(CFG, active_sh_degree=0)
    plain = autograd_of_plain(model, cam, cfg, cots, probe=False)
    m64, c64 = cast(model, cam, torch.float64)
    exact = autograd_of_plain(m64, c64, cfg, [c.double() for c in cots],
                              probe=False)
    live = sp.radius[:, 0] > 0
    got = [torch.where((~live).reshape((-1,) + (1,) * (p.dim() - 1)), 0.0,
                       p) for p in plain] + [None]
    assert not kernel.compare_bwd_failures(kernel.compare_bwd(
        got, plain, exact, live))
    i = int(torch.nonzero(live & torch.isfinite(plain[0]).all(-1))[0, 0])
    j = int(torch.nonzero(~live)[0, 0])
    got[0][i] += 1e-3 * got[0][i].norm()
    got[2][i] = float("nan")
    got[4][i, 3, 0] = 1.0                    # band 1 above degree 0
    got[3][j] = 1.0
    fails = kernel.compare_bwd_failures(kernel.compare_bwd(
        got, plain, exact, live))
    assert {"d_means_ratio", "d_quats_nan_differ", "d_sh_zeros_lost",
            "d_opacities_dead_nonzero"} <= set(fails), fails


def plain_kernels(monkeypatch):
    """Replace G and G-bwd in projection.py with the plain forward and the
    twin, so that the autograd Function runs on CPU tensors."""
    def project(means, log_scales, quats, opacities, sh, view, proj, env_rot,
                cfg, degree):
        cam = Camera(view, proj)
        cam.env_rot = env_rot
        model = GaussianModel(means, log_scales, quats, opacities, sh,
                              dtype=means.dtype)
        return tuple(projection.project_gaussians_torch(
            model, cam, dataclasses.replace(cfg, active_sh_degree=degree)))

    launches = []

    def project_bwd(*args, **kw):
        launches.append(kw.get("probe"))
        return kernel.project_gaussians_bwd_torch(*args, **kw)

    monkeypatch.setattr(projection.kernel, "project", project)
    monkeypatch.setattr(projection.kernel, "project_bwd", project_bwd)
    return launches


def function_call(model, cam, cfg, probe):
    degree = active_degree(model, cfg)
    return projection.ProjectedSplats(*projection._Project.apply(
        cfg, degree, *(getattr(model, k) for k in FIELDS), cam.view,
        cam.proj, cam.env_rot, probe))


@pytest.mark.parametrize("who", ["fit", "densify", "mix_scale"])
def test_the_function_routes_gradients_as_autograd(monkeypatch, who):
    """The autograd Function with the plain kernels, against autograd of
    the plain version, in float64: a fit step (the model requires grad, no
    probe), a densify step (the model and the probe) and the mix scale's
    eager pass (a frozen model, a probe that requires grad: no kernel runs,
    the probe's gradient is xy's cotangent). The loss reads the outputs
    through one packed row as binning does, so the cotangents arrive as
    column views; depth is left out, so its cotangent is None."""
    launches = plain_kernels(monkeypatch)
    cfg = CFG
    frozen = who == "mix_scale"
    model, cam = cast(scene("cpu", n=600, sh_degree=3, seed=5),
                      camera("cpu", (0.3, 0.2)), torch.float64,
                      requires_grad=not frozen)
    n = model.num_gaussians
    weights = torch.tensor(np.random.default_rng(1).normal(size=(n, 9)))

    def loss_of(sp):
        packed = torch.cat([sp.xy, sp.conic, sp.color, sp.opacity[:, None]],
                           -1)
        return (packed * weights).sum()

    def grads(fn):
        probe = (torch.zeros((n, 2), dtype=torch.float64, requires_grad=True)
                 if who != "fit" else None)
        inputs = ([] if frozen else [getattr(model, k) for k in FIELDS]) + (
            [] if probe is None else [probe])
        return torch.autograd.grad(loss_of(fn(probe)), inputs)

    got = grads(lambda p: function_call(model, cam, cfg, p))
    want = grads(lambda p: projection.project_gaussians_torch(model, cam, cfg,
                                                              p))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL64,
                                   atol=ATOL64 * scale(w), equal_nan=True)
    assert launches == ({"fit": [False], "densify": [True]}.get(who, []))
    if frozen:
        torch.testing.assert_close(got[0], weights[:, :2], rtol=0, atol=0)


@pytest.mark.parametrize("frozen", [False, True],
                         ids=["pose_and_scene", "pose_alone"])
def test_the_function_routes_the_view_gradient(monkeypatch, frozen):
    """A view matrix made from a leaf (a pose delta's corrected camera,
    V' = (I + D) V) through the autograd Function with the plain kernels,
    against autograd of the plain version, in float64: the leaf's gradient
    (and the model's, when it trains) as autograd's; G-bwd runs once, with
    the view's gradient."""
    launches = []
    plain_kernels(monkeypatch)
    twin = projection.kernel.project_bwd

    def counted(*args, **kw):
        launches.append(kw.get("view_grad"))
        return twin(*args, **kw)

    monkeypatch.setattr(projection.kernel, "project_bwd", counted)
    model, cam = cast(scene("cpu", n=600, sh_degree=3, seed=5),
                      camera("cpu", (0.3, 0.2)), torch.float64,
                      requires_grad=not frozen)
    n = model.num_gaussians
    weights = torch.tensor(np.random.default_rng(1).normal(size=(n, 9)))

    def grads(project):
        d = torch.zeros((4, 4), dtype=torch.float64, requires_grad=True)
        posed = Camera((torch.eye(4, dtype=torch.float64) + d) @ cam.view,
                       cam.proj)
        posed.env_rot = cam.env_rot
        sp = project(model, posed, CFG)
        packed = torch.cat([sp.xy, sp.conic, sp.color, sp.opacity[:, None]],
                           -1)
        inputs = [d] + ([] if frozen else [getattr(model, k)
                                           for k in FIELDS])
        return torch.autograd.grad((packed * weights).sum(), inputs)

    got = grads(lambda m, c, cfg: function_call(m, c, cfg, None))
    want = grads(projection.project_gaussians_torch)
    assert len(got) == len(want) == (1 if frozen else 6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL64,
                                   atol=ATOL64 * scale(w), equal_nan=True)
    assert launches == [True]


def test_radius_is_not_differentiable(monkeypatch):
    plain_kernels(monkeypatch)
    model, cam = cast(scene("cpu", n=200, sh_degree=1), camera("cpu"),
                      torch.float64)
    sp = function_call(model, cam, CFG, None)
    assert sp.xy.requires_grad and not sp.radius.requires_grad


def test_the_bwd_wrapper_refuses_other_devices():
    model = scene("cpu", n=8)
    cam = camera("cpu")
    args = [model.means, model.log_scales, model.quats, model.opacities,
            model.sh, cam.view, cam.proj, cam.env_rot]
    cots = [torch.zeros((8, 2)), None, torch.zeros((8, 3)),
            torch.zeros((8, 3)), torch.zeros(8)]
    launches = dict(cuda_lib.launches)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel.project_bwd(*(a.to(device) for a in args), CFG, 3,
                               [None if c is None else c.to(device)
                                for c in cots])
    assert dict(cuda_lib.launches) == launches


# -- the card ---------------------------------------------------------------

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel G-bwd has no CPU mode "
                    "(chip_smoke.py runs it at full size)")


@pytest.mark.cuda
@pytest.mark.parametrize("zero_culled", [True, False],
                         ids=["culled_zero", "all_nonzero"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_bwd_is_as_accurate_as_autograd_on_the_card(case,
                                                           zero_culled):
    """G-bwd against PyTorch's f32 autograd of the plain version, both
    against the float64 gradient (the plain version's autograd in float64
    on the same f32 inputs), by project.compare_bwd: per gaussian and
    gradient, G-bwd's error at most ACC_FACTOR times autograd's, floored
    at ACC_FLOOR of the row's norm; NaN where f32 autograd has NaN; zeros
    where autograd's are zero in f32 and float64 (structural zeros, not
    cancellations); exact zeros for gaussians whose cotangents are
    zero."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    degree, change, env_rot = case
    cfg = dataclasses.replace(CFG, **change)
    model = scene("cuda", sh_degree=degree, seed=degree + 1).trainable()
    cam = camera("cuda", env_rot)
    with torch.no_grad():
        sp = projection.project_gaussians_torch(model, cam, cfg)
    cots = cotangents(sp, zero_culled)
    cuda_lib.launches.clear()
    got = kernel.project_bwd(*(getattr(model, k).detach() for k in FIELDS),
                             cam.view, cam.proj, cam.env_rot, cfg,
                             active_degree(model, cfg), cots, probe=True)
    torch.cuda.synchronize()
    assert cuda_lib.launches["project_gaussians_bwd"] == 1
    plain = autograd_of_plain(model, cam, cfg, cots, probe=True)
    m64, c64 = cast(model, cam, torch.float64)
    exact = autograd_of_plain(m64, c64, cfg, [c.double() for c in cots],
                              probe=True)
    live = torch.stack([c.reshape(c.shape[0], -1).ne(0).any(-1)
                        for c in cots], -1).any(-1)
    res = kernel.compare_bwd(got, plain, exact, live)
    assert not kernel.compare_bwd_failures(res), res
    n = model.num_gaussians
    assert 0 < int((sp.radius[:, 0] > 0).sum()) < n


@pytest.mark.cuda
def test_zero_cotangents_give_exact_zeros_on_the_card():
    """Whole blocks of zero cotangents (a density-control buffer's dead
    slots) and zero rows among live ones: exact zeros in every field."""
    need_card()
    model = scene("cuda", n=1000, sh_degree=3, seed=3)
    cam = camera("cuda")
    n = model.num_gaussians
    cots = [torch.randn((n, 2), device="cuda"), None,
            torch.randn((n, 3), device="cuda"),
            torch.randn((n, 3), device="cuda"), torch.randn(n, device="cuda")]
    dead = torch.zeros(n, dtype=torch.bool, device="cuda")
    dead[256:640] = True                     # three whole blocks
    dead[::7] = True
    cots = [None if c is None else torch.where(
        dead.reshape((n,) + (1,) * (c.dim() - 1)), 0.0, c) for c in cots]
    got = kernel.project_bwd(*(getattr(model, k) for k in FIELDS), cam.view,
                             cam.proj, cam.env_rot,
                             dataclasses.replace(CFG, antialias=True), 3,
                             cots, probe=True)
    for g in got:
        assert bool((g[dead] == 0).all())
        assert bool((g[~dead] != 0).any())


@pytest.mark.cuda
def test_strided_cotangents_read_as_contiguous_ones_on_the_card():
    """Cotangents handed as column views of one (N, 16) row, as the pair
    table's VJP gives them, read as their contiguous copies do."""
    need_card()
    model = scene("cuda", n=700, sh_degree=2, seed=6)
    cam = camera("cuda")
    n = model.num_gaussians
    wide = torch.randn((n, 16), device="cuda")
    views = [wide[:, 0:2], wide[:, 9], wide[:, 2:5], wide[:, 5:8],
             wide[:, 8]]
    args = [getattr(model, k) for k in FIELDS] + [cam.view, cam.proj,
                                                  cam.env_rot]
    a = kernel.project_bwd(*args, CFG, 2, views)
    b = kernel.project_bwd(*args, CFG, 2, [v.contiguous() for v in views])
    for x, y in zip(a[:5], b[:5]):          # NaN at the zero quaternion
        torch.testing.assert_close(x, y, rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.cuda
def test_view_gradient_at_capture_scale_on_the_card():
    """G-bwd's view gradient at 2^20 gaussians, SH degree 3, 1280x720,
    every gaussian given normal cotangents (depth's none, as in a render),
    against the twin's in float64 on the same f32 inputs: G-bwd's error at
    most ACC_FACTOR times the f32 twin's (floored at ACC_FLOOR of the
    gradient's norm), and its parameter gradients equal to the camera-free
    launch's bit for bit."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    model = GaussianModel.random(1 << 20, generator=gen, device=dev,
                                 sh_degree=3)
    cfg = dataclasses.replace(CFG, image_width=1280, image_height=720,
                              tile_width=32, tile_height=32)
    cam = camera("cuda")
    with torch.no_grad():
        sp = projection.project_gaussians_torch(model, cam, cfg)
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in sp[:5]]
    cots[1] = None
    args = [getattr(model, k) for k in FIELDS] + [cam.view, cam.proj,
                                                  cam.env_rot, cfg, 3]
    cuda_lib.launches.clear()
    got = kernel.project_bwd(*args, cots, view_grad=True)
    plain = kernel.project_bwd(*args, cots)
    twin = kernel.project_gaussians_bwd_torch(*args, cots, view_grad=True)
    m64 = [a.double() if isinstance(a, torch.Tensor) else a for a in args]
    exact = kernel.project_gaussians_bwd_torch(
        *m64, [None if c is None else c.double() for c in cots],
        view_grad=True)[-1]
    torch.cuda.synchronize()
    assert cuda_lib.launches["project_gaussians_bwd"] == 2
    for a, b in zip(got[:6], plain):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0.0, atol=0.0,
                                       equal_nan=True)
    err = float((got[-1].double() - exact).norm())
    bound = kernel.ACC_FACTOR * max(float((twin[-1].double() - exact).norm()),
                                    kernel.ACC_FLOOR * float(exact.norm()))
    print(f"view gradient: G-bwd error {err:.3e}, bound {bound:.3e}, "
          f"norm {float(exact.norm()):.3e}")
    assert err <= bound
