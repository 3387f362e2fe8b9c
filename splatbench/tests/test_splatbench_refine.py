"""The cells capture1m-refine-fit and capture1m-flythrough on the CPU: both
drivers end to end at a tiny size (the drivers, the references, the limits
and the comparison are the real ones), the refine fit's planted fault
failing its check, the port's aux step against reference/refine.py, the
flythrough's loop, and the readers of the two new per-layer metrics."""

from __future__ import annotations

import copy
import math
import time

import pytest
import torch

from _tiny import run_module
from splatbench import harness, inputs
from splatbench.reference import refine as refr
from splatbench.reference import render as ref
from splatbench.reference import work_project as WP

REFINE, FLY = "capture1m-refine-fit", "capture1m-flythrough"
SEED = 2_200_000_017


def tiny_cell(name: str):
    """The cell at 400 gaussians and 96x64 pixels, 6 views (the refine
    fit) or a loop of 40 poses (the flythrough), 4 profiled frames."""
    cell = harness.find_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["raster"].update(image_width=96, image_height=64)
    cell.config["scene"]["gaussians"] = 400
    cell.traffic = copy.deepcopy(cell.traffic)
    if name == REFINE:
        cell.traffic["views_per_ring"] = 3
    else:
        cell.traffic.update(poses=40, profiled_frames=4)
    return cell


def run_tiny(name, trace=False, control="", seconds=0.2):
    return run_module().run_one(tiny_cell(name), SEED, seconds, trace,
                                torch.device("cpu"), time.perf_counter(),
                                control=control)


def test_refine_fit_runs_end_to_end_and_reads_its_spans():
    """A traced run: correct on every reading (fit's four, and the deltas'
    and maps' first moments and changes), no failed step, the end-to-end
    metrics left out as in every traced run, and the aux step's spans read
    by aux_ms (the CPU runs no kernel: no roofline, no G-bwd count)."""
    out = run_tiny(REFINE, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(harness.find_cell(REFINE).limits)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["aux_ms"]["value"] > 0
    assert "project_bwd_roofline" not in out["metrics"]
    assert "step_ms" not in out["metrics"]
    info = out["info"]
    assert info["projection_plain_calls"] == {}
    assert info["start_failed"] == info["final_failed"] == 0


def test_refine_fit_fault_and_control_fail(monkeypatch):
    """The maps' Adam step left out (REFINE_FAULT=maps_frozen) fails the
    maps' readings and leaves the pose's first moment as it was; the
    bfloat16 control fails."""
    from gaussian_splat_ipu_tpu_torch.train import trainer
    monkeypatch.setattr(trainer, "adam_apply", trainer.adam_apply)
    monkeypatch.setenv("REFINE_FAULT", "maps_frozen")
    out = run_tiny(REFINE, seconds=0.05)
    c = {k: v["value"] for k, v in out["checks"].items()}
    assert not out["correct"]
    assert c["exposure_grad_gap"] == pytest.approx(1.0)
    assert c["exposure_change_gap"] == pytest.approx(1.0)
    assert c["pose_grad_gap"] < out["checks"]["pose_grad_gap"]["limit"]
    monkeypatch.delenv("REFINE_FAULT")
    control = run_tiny(REFINE, control="bfloat16")
    assert not control["correct"], control["checks"]


def test_the_aux_step_follows_the_reference():
    """The port's aux step (pose and exposure, plain path on the CPU) and
    reference/refine.steps from the same start, over 3 steps on seeded
    random weights with a camera off its pose: losses, the scene's first
    gradients, the deltas' and the maps' first moments after step 1 and
    the state after step 3, each within 1e-4 relative."""
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.train import aux_opt, trainer

    cell = tiny_cell(REFINE)
    drv = cell.driver
    rc = cell.config["raster"]
    tc = drv.fit.train_settings(cell.config, cell.traffic)
    rates = cell.config["aux"]
    true_cams = drv.fit._cameras(cell.config, cell.traffic, "cpu")
    n = len(true_cams)
    errors = drv.pose_errors(n, dict(rotation_deg=2.0, translation=0.02), 7)
    cams = [(e @ v, p, r) for e, (v, p, r) in zip(errors, true_cams)]
    maps = drv.exposure_maps(n, cell.traffic["exposure_drift"], 7, "cpu")
    gt = inputs.make_scene(cell.config["scene"], 7, "cpu")
    init = inputs.perturb(gt, cell.traffic["perturb"], 7)
    views = [4, 1, 2]
    targets = [refr.exposure(ref.render(gt, *true_cams[v], rc)["image"],
                             maps[v]) for v in views]
    cfg = harness.raster_config(cell.config, 1 << 14)
    tcfg = trainer.TrainConfig(**tc)
    state = trainer.init_state(GaussianModel(
        *(init[k].clone() for k in inputs.FIELDS), requires_grad=True), tcfg)
    aux = aux_opt.init_aux_state(n, rates["pose_lr"], rates["exposure_lr"],
                                 device="cpu")
    step = aux_opt.make_aux_step(cfg, tcfg, rates["pose_lr"],
                                 rates["exposure_lr"])
    losses, first = [], None
    for v, target in zip(views, targets):
        losses.append(float(step(state, aux, torch.tensor(v),
                                 Camera(*cams[v]), target, None, None)))
        if first is None:
            first = dict(
                grads={k: state.opt_state.adam[k].mu / (1 - drv.fit.B1)
                       for k in inputs.FIELDS},
                mu_pose=aux.pose.opt_state.mu.clone(),
                mu_exposure=aux.exposure.opt_state.mu.clone())
    want = refr.steps(init, torch.zeros((n, 6)),
                      torch.eye(3, 4).repeat(n, 1, 1), cams, views, targets,
                      rc, tc, rates, torch.float32)
    assert bool((want["mu_pose"][views[0]] != 0).all())
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor(want["losses"]), rtol=1e-4,
                               atol=0)
    for k in inputs.FIELDS:
        assert harness.rel_l2(first["grads"][k], want["grads"][k]) < 1e-4, k
        assert harness.rel_l2(getattr(state.params, k).detach(),
                              want["params"][k]) < 1e-4, k
    for k in ("mu_pose", "mu_exposure"):
        assert harness.rel_l2(first[k], want[k]) < 1e-4, k
    assert harness.rel_l2(aux.pose.deltas, want["deltas"]) < 1e-4
    assert harness.rel_l2(aux.exposure.mats, want["mats"]) < 1e-4


def test_se3_exp_is_the_ports():
    """The reference's exponential against the port's, at zero, in the
    series' range and beyond it, with the gradient at zero."""
    from gaussian_splat_ipu_tpu_torch.train import pose_opt
    for d in ([0.0] * 6, [1e-5, -2e-5, 3e-5, 0.1, 0.2, -0.3],
              [0.3, -0.2, 0.5, 0.01, -0.02, 0.03]):
        d = torch.tensor(d, dtype=torch.float64)
        torch.testing.assert_close(refr.se3_exp(d), pose_opt.se3_exp(d),
                                   rtol=1e-12, atol=1e-12)
    d = torch.zeros(6, dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(refr.se3_exp(d).sum(), d)
    assert bool(torch.isfinite(g).all())


def test_flythrough_runs_end_to_end():
    out = run_tiny(FLY, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["enqueue_ms.view"]["value"] > 0
    assert out["info"]["truncated"] == out["info"]["overflowed"] == 0


def test_the_flythrough_loop_closes_inside_the_box():
    """628 poses 0.005 world units apart (0.5% of the extent, to within
    rounding of the loop's length) close the loop; every eye lies inside
    the box on the horizontal circle; the camera looks along the tangent
    (the view's third row is minus the direction of travel), level, with
    the configuration's field of view."""
    cell = harness.find_cell(FLY)
    t, drv = cell.traffic, cell.driver
    lo = torch.tensor(cell.config["scene"]["box_min"])
    hi = torch.tensor(cell.config["scene"]["box_max"])
    eyes, ahead = [], []
    for k in range(t["poses"] + 1):
        view, proj, env = drv.loop_camera(cell.config, t, k)
        r, tr = view[:3, :3].double(), view[:3, 3].double()
        eyes.append(-(r.T @ tr))
        ahead.append(-r[2])
    eyes = torch.stack(eyes)
    assert bool(((eyes > lo) & (eyes < hi)).all())
    torch.testing.assert_close(eyes[0], eyes[-1], rtol=0, atol=1e-5)
    center = (lo + hi).double() / 2
    radii = (eyes - center)[:, [0, 2]].norm(dim=-1)
    torch.testing.assert_close(radii, torch.full_like(radii, 0.5),
                               rtol=0, atol=1e-5)
    assert bool(((eyes - center)[:, 1].abs() < 1e-6).all())
    steps = (eyes[1:] - eyes[:-1]).norm(dim=-1)
    assert float((steps - 0.005).abs().max()) < 1e-5
    travel = eyes[1:] - eyes[:-1]
    cos = (torch.stack(ahead[:-1]) * travel).sum(-1) / steps
    assert float(cos.min()) > 0.9999
    assert float(proj[3, 2]) == -1.0 and bool((env == 0).all())
    fov = math.radians(cell.config["fov_deg"])
    assert float(proj[1, 1]) == pytest.approx(1.0 / math.tan(fov / 2),
                                              rel=1e-6)
    starts = {drv.start_pose(s, t["poses"]) for s in (SEED, 7, 2 ** 33 + 5)}
    assert len(starts) > 1 and all(0 <= s < t["poses"] for s in starts)


def _reading(kernels: dict, items=64, work=(), **kw):
    scene = harness.find_cell(REFINE).config["scene"]
    return dict(kind="train", enqueue_s=[], work=list(work), items=items,
                profile=dict(kernel_s=kernels), rc={}, scene=scene, **kw)


def test_the_project_bwd_roofline_reads_the_kernel_it_finds():
    """Bytes at 2^20 SH 3: 508 a live gaussian, 272 one whose cotangents
    are zero, and with the view's gradient 112 a block of 128 more; the
    share is the bound over the kernel's seconds, with each profiled
    step's live gaussians where the work counts them for every step, else
    every gaussian live; None where both kernels or neither ran."""
    scene = harness.find_cell(REFINE).config["scene"]
    n = 1 << 20
    assert WP.project_bwd_bytes(scene, False) == 508 * n
    assert WP.project_bwd_bytes(scene, True) == 508 * n + 112 * 8192
    assert WP.project_bwd_bytes(scene, False, 1000) == 272 * n + 236 * 1000
    reader = harness.metric_reader("project_bwd_roofline")
    plain = "(anonymous namespace)::project_bwd_kernel(float const*)"
    view = "(anonymous namespace)::project_bwd_view_kernel(float const*)"
    bound = WP.project_bwd_bound_s(scene, True)
    got = reader.read(_reading({view: 64 * 2 * bound, "other": 1.0}))
    assert got == pytest.approx(50.0)
    got = reader.read(_reading({plain: 64 * 4 * WP.project_bwd_bound_s(
        scene, False)}))
    assert got == pytest.approx(25.0)
    work = [dict(pairs=1, live=1, live_gaussians=n // 4)] * 2
    live_bound = 2 * WP.project_bwd_bound_s(scene, True, n // 4)
    assert live_bound < 2 * bound
    got = reader.read(_reading({view: 2 * live_bound}, items=2, work=work))
    assert got == pytest.approx(50.0)
    got = reader.read(_reading({view: 4 * bound}, items=2,
                               work=[work[0], dict(pairs=1, live=1)]))
    assert got == pytest.approx(50.0)
    assert reader.read(_reading({plain: 1.0, view: 1.0})) is None
    assert reader.read(_reading({"other": 1.0})) is None


def test_frame_work_counts_the_gaussians_with_a_gradient():
    """The reference's live gaussians of a frame are the rows to which its
    loss gives a gradient (those with a live evaluation): fewer than the
    scene's, where gaussians are culled or hidden; its pairs and live
    evaluations are render's."""
    cell = tiny_cell(REFINE)
    rc = cell.config["raster"]
    params = inputs.make_scene(cell.config["scene"], SEED,
                               torch.device("cpu"))
    box = cell.config["scene"]
    cam = inputs.orbit_camera(box["box_min"], box["box_max"],
                              math.radians(cell.config["fov_deg"]),
                              rc["image_width"] / rc["image_height"],
                              -15.0, 30.0)
    got = WP.frame_work(params, *cam, rc)
    r = ref.render(params, *cam, rc)
    assert (got["pairs"], got["live"]) == (r["pairs"], r["live"])
    target = torch.rand(r["image"].shape, generator=torch.Generator()
                        .manual_seed(3))
    _, grads, _ = ref.loss_and_grads(params, *cam, target, rc, 0.2)
    moved = torch.zeros(params["means"].shape[0], dtype=torch.bool)
    for g in grads.values():
        moved |= (g.reshape(g.shape[0], -1) != 0).any(dim=-1)
    assert got["live_gaussians"] == int(moved.sum())
    assert 0 < got["live_gaussians"] < params["means"].shape[0]


def test_aux_ms_is_the_median_of_the_aux_spans_a_step():
    reader = harness.metric_reader("aux_ms")
    steps = [dict(pose=0.05, exposure=0.1, render=5.0),
             {"pose": 0.05, "exposure": 0.1, "aux.adam": 0.05},
             {"pose": 0.1, "exposure": 0.2, "aux.adam": 0.1}, dict(render=4.0)]
    assert reader.read(_reading({}, step_spans=steps)) == pytest.approx(0.2)
    assert reader.read(_reading({}, step_spans=[dict(render=4.0)])) is None
