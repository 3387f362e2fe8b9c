"""Kernel G (render/kernels/project.py) and project_gaussians' choice of
path: CPU calls, and CUDA calls that record a gradient for the projection
or hold another dtype, take the plain version; on a CUDA card (marked
`cuda`, skipped without one) G equals the plain version within the
kernel's tolerances (project.compare), a rendered frame equals the plain
path's, and calls that record a gradient for the model, an xy_probe or
the view matrix run G and G-bwd. This file imports no JAX: its cuda tests
run on the card with --noconftest."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render import pipeline, projection
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.render.kernels import project as kernel
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RasterConfig(image_width=160, image_height=96, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 15)


def scene(device, n=3000, sh_degree=3, seed=0):
    """Gaussians around the [-1, 1]^3 box the camera orbits, some behind
    the camera or off screen (means over [-4, 4]^3), tiny (log-scale -30)
    and large ones, a zero quaternion (NaN everywhere, culled in both
    versions), one at the camera's origin and raw opacities around
    alpha_min."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    p = dict(
        means=rng.uniform(-1.2, 1.2, (n, 3)),
        log_scales=rng.uniform(-5.0, -2.0, (n, 3)),
        quats=rng.normal(size=(n, 4)),
        opacities=rng.uniform(-6.0, 4.0, n),
        sh=rng.uniform(-1.0, 1.0, (n, k, 3)))
    s, m = n // 6, max(1, n // 150)
    p["means"][:s] = rng.uniform(-4.0, 4.0, (s, 3))
    p["log_scales"][s:s + m] = -30.0
    p["log_scales"][s + m:s + 2 * m] = rng.uniform(-0.5, 0.5, (m, 3))
    p["quats"][s + 2 * m] = 0.0
    p["means"][s + 2 * m + 1] = camera("cpu").cam_origin.numpy()
    return GaussianModel.from_numpy(p, device)


def camera(device, env_rot=None):
    return Camera.orbit(-np.ones(3), np.ones(3), float(np.radians(50.0)),
                        160 / 96, rot_x_deg=10.0, rot_y_deg=30.0,
                        env_rot=env_rot, device=device)


# (model SH degree, RasterConfig changes, env_rot): SH degrees 0-3, an
# active degree below the model's, antialias, raw opacities, no extent cap
# and a nonzero environment rotation.
CASES = [(0, {}, None), (1, {}, None), (2, {}, None), (3, {}, None),
         (3, dict(active_sh_degree=1), None),
         (3, dict(active_sh_degree=0, antialias=True), None),
         (2, dict(sigmoid_opacity=False, extent_sigma=0.0), None),
         (3, dict(antialias=True), (0.4, -0.9))]


def case_id(case):
    degree, change, env_rot = case
    parts = [f"sh{degree}"] + [f"{k}={v}" for k, v in change.items()]
    return ",".join(parts + (["env_rot"] if env_rot else []))


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel G has no CPU mode "
                    "(chip_smoke.py and project_ab.py run it at full size)")


# -- CPU --------------------------------------------------------------------

def reason_cases(device):
    """name -> (model, camera, xy_probe, grad mode, the reason expected).
    A gradient for the model, a probe or the view matrix (pose
    refinement), or a probe, is no reason (G and G-bwd, on CUDA); one for
    the projection is."""
    model = scene(device, n=64, sh_degree=1)
    trainable = model.trainable()
    probe = torch.zeros((64, 2), device=device)
    cam = camera(device)
    focal = Camera(cam.view, cam.proj.clone().requires_grad_(), cam.env_rot)
    posed = Camera(cam.view.clone().requires_grad_(), cam.proj, cam.env_rot)
    return {
        "inference": (model, cam, None, True, None),
        "grad": (trainable, cam, None, True, None),
        "trainable_no_grad": (trainable, cam, None, False, None),
        "xy_probe": (trainable, cam, probe, True, None),
        "xy_probe_no_grad": (model, cam, probe, False, None),
        "dtype": (model.astype(torch.bfloat16), cam, None, False, "dtype"),
        "camera_grad": (model, focal, None, True, "camera_grad"),
        "camera_grad_no_grad": (model, focal, None, False, None),
        "view_grad": (model, posed, None, True, None),
    }


@pytest.mark.parametrize("name", list(reason_cases("cpu")))
def test_plain_reason(name):
    model, cam, probe, grad, want = reason_cases("cpu")[name]
    with torch.set_grad_enabled(grad):
        assert projection.plain_reason(model, cam, probe) == want


@pytest.mark.parametrize("name", list(reason_cases("cpu")))
def test_cpu_calls_take_the_plain_version_and_launch_nothing(name):
    """Whatever the reason, a CPU call runs the plain version: no launch,
    nothing counted (plain_calls counts CUDA calls), the plain version's
    splats bit for bit."""
    model, cam, probe, grad, _ = reason_cases("cpu")[name]
    launches, plain = dict(cuda_lib.launches), dict(projection.plain_calls)
    with torch.set_grad_enabled(grad):
        got = projection.project_gaussians(model, cam, CFG, xy_probe=probe)
        want = projection.project_gaussians_torch(model, cam, CFG,
                                                  xy_probe=probe)
    assert dict(cuda_lib.launches) == launches
    assert dict(projection.plain_calls) == plain
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)
    assert got.xy.requires_grad == (grad and (name in (
        "grad", "xy_probe", "camera_grad", "view_grad")))


def test_the_wrapper_refuses_other_devices():
    model = scene("cpu", n=8)
    cam = camera("cpu")
    args = (model.means, model.log_scales, model.quats, model.opacities,
            model.sh, cam.view, cam.proj, cam.env_rot, CFG, 3)
    launches = dict(cuda_lib.launches)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel.project(*(a.to(device) if isinstance(a, torch.Tensor)
                             else a for a in args))
    assert dict(cuda_lib.launches) == launches


def test_importing_builds_nothing():
    code = ("import gaussian_splat_ipu_tpu_torch.render.projection, "
            "gaussian_splat_ipu_tpu_torch.render.pipeline\n"
            "from gaussian_splat_ipu_tpu_torch.render.kernels import "
            "cuda_lib, project\n"
            "print(cuda_lib._lib is None, cuda_lib.BuildInfo.path is None, "
            "'triton' in __import__('sys').modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "False"]


def test_compare_counts_radius_flips_off_threshold():
    """compare on the plain version against itself reads zero; a changed
    colour counts outside the tolerance, and a radius changed where the
    plain version is far from every threshold counts off threshold."""
    want = projection.project_gaussians_torch(scene("cpu", n=500),
                                              camera("cpu"), CFG)
    same = kernel.compare(want, want, CFG)
    assert all(v == 0 for v in same.values()), same
    margins = kernel.threshold_margins(want, CFG)
    far = int(torch.nonzero((want.radius[:, 0] > 0)
                            & (margins > 10 * kernel.MARGIN)
                            & (want.color[:, 1] > 0.1))[0, 0])
    radius, color = want.radius.clone(), want.color.clone()
    radius[far, 0] += 1.0
    color[far, 1] *= 1.0 + 1e-3
    got = kernel.compare(want._replace(radius=radius, color=color), want,
                         CFG)
    assert got["radius_differ"] == 1
    assert got["radius_differ_off_threshold"] == 1
    assert got["visible_differ"] == 0
    assert got["color_outside"] == 1 and got["xy_outside"] == 0


# -- the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_matches_the_plain_version_on_the_card(case):
    need_card()
    degree, change, env_rot = case
    cfg = dataclasses.replace(CFG, **change)
    model = scene("cuda", sh_degree=degree, seed=degree + 1)
    cam = camera("cuda", env_rot)
    cuda_lib.launches.clear()
    with torch.inference_mode():
        got = projection.project_gaussians(model, cam, cfg)
        want = projection.project_gaussians_torch(model, cam, cfg)
        torch.cuda.synchronize()
    assert cuda_lib.launches["project_gaussians"] == 1
    res = kernel.compare(got, want, cfg)
    assert all(res[f"{k}_outside"] == 0
               for k in kernel.OUTPUTS[:-1]), res
    assert res["radius_differ_off_threshold"] == 0, res
    visible = int((want.radius[:, 0] > 0).sum())
    assert 0 < visible < model.num_gaussians


@pytest.mark.cuda
def test_frames_and_the_choice_of_path_on_the_card(monkeypatch):
    """render() through G against render() through the plain version
    (img_rel_l2 <= 1e-5); an xy_probe runs G, and a call that records a
    gradient for the model, or for the view matrix alone, G and then
    G-bwd; a bf16 model and a projection that requires grad take the plain
    version, each counted under its reason; the wrapper refuses a
    non-contiguous or f64 input."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = scene("cuda")
    cam = camera("cuda")
    cuda_lib.launches.clear()
    projection.plain_calls.clear()
    with torch.inference_mode():
        img = pipeline.render(model, cam, CFG).image
        with monkeypatch.context() as mp:
            mp.setattr(pipeline, "project_gaussians",
                       projection.project_gaussians_torch)
            ref = pipeline.render(model, cam, CFG).image
        rel = float(torch.linalg.vector_norm(img - ref)
                    / torch.linalg.vector_norm(ref))
        assert rel <= 1e-5
        assert float(ref[..., 3].max()) > 0.5
        projection.project_gaussians(model.astype(torch.bfloat16), cam, CFG)
        probe = torch.zeros((model.num_gaussians, 2), device="cuda")
        projection.project_gaussians(model, cam, CFG, xy_probe=probe)
    trainable = model.trainable()
    sp = projection.project_gaussians(trainable, cam, CFG)
    sp.color.sum().backward()
    assert trainable.sh.grad is not None
    focal = Camera(cam.view, cam.proj.clone().requires_grad_(), cam.env_rot)
    projection.project_gaussians(model, focal, CFG).xy.sum().backward()
    assert focal.proj.grad is not None
    posed = Camera(cam.view.clone().requires_grad_(), cam.proj, cam.env_rot)
    sp = projection.project_gaussians(model, posed, CFG)
    # The culled gaussians' cotangents zero, as kernel D gives them: the
    # zero quaternion's and the origin's NaN stay out of the sum.
    (sp.xy * (sp.radius[:, :1] > 0)).sum().backward()
    assert bool(torch.isfinite(posed.view.grad).all())
    torch.cuda.synchronize()
    assert cuda_lib.launches["project_gaussians"] == 4
    assert cuda_lib.launches["project_gaussians_bwd"] == 2
    assert dict(projection.plain_calls) == {"dtype": 1, "camera_grad": 1}
    args = [model.means, model.log_scales, model.quats, model.opacities,
            model.sh, cam.view, cam.proj, cam.env_rot, CFG, 3]
    wide = torch.zeros((model.num_gaussians, 4), device="cuda")
    wide[:, :3] = model.means
    for i, bad, match in ((0, wide[:, :3], "not contiguous"),
                          (4, model.sh.double(), "dtype")):
        with pytest.raises(ValueError, match=match):
            kernel.project(*args[:i], bad, *args[i + 1:])
    assert cuda_lib.launches["project_gaussians"] == 4
