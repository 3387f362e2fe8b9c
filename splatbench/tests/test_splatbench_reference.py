"""The plain reference on the CPU: its counts against a brute-force walk,
its frame and train step against the port's CPU path, and its imports."""

from __future__ import annotations

import math
import os
import subprocess
import sys

import pytest
import torch

from _tiny import ROOT, tiny_cell  # noqa: F401  (puts ROOT on sys.path)
from splatbench import inputs
from splatbench.drivers import fit as fit_driver
from splatbench.reference import render as ref


def _setup(cell_name, n, w=96, h=64, seed=7):
    cell = tiny_cell(cell_name)
    rc = dict(cell.config["raster"], image_width=w, image_height=h)
    scene = dict(cell.config["scene"], gaussians=n)
    params = inputs.make_scene(scene, seed, "cpu")
    fov = math.radians(cell.config["fov_deg"])
    cam = inputs.orbit_camera(scene["box_min"], scene["box_max"], fov,
                              w / h, 10.0, 37.0)
    return cell, rc, scene, params, cam


def _brute_force(sp, rc):
    """Pairs by testing every (gaussian, group) of the grid, and a
    one-gaussian-at-a-time strict walk of every pixel over its whole
    group list in key order: (pairs, live evaluations, image)."""
    gr = ref.grid(rc)
    g, tw, th = rc["tile_group"], rc["tile_width"], rc["tile_height"]
    gx_n = gr["groups_x"]
    gy_n = -(-gr["tiles_y"] // g)
    n = sp["xy"].shape[0]
    lists = {}
    pairs = 0
    for i in range(n):
        rx, ry = float(sp["radius"][i, 0]), float(sp["radius"][i, 1])
        if rx <= 0.0:
            continue
        x, y = float(sp["xy"][i, 0]), float(sp["xy"][i, 1])
        x0 = max(math.floor(torch.tensor((x - rx) / tw).item()), 0)
        x1 = min(math.floor(torch.tensor((x + rx) / tw).item()),
                 gr["tiles_x"] - 1)
        y0 = max(math.floor(torch.tensor((y - ry) / th).item()), 0)
        y1 = min(math.floor(torch.tensor((y + ry) / th).item()),
                 gr["tiles_y"] - 1)
        nx = min(max(x1 - x0 + 1, 0), rc["max_tiles_per_axis"])
        ny = min(max(y1 - y0 + 1, 0), rc["max_tiles_per_axis"])
        if nx == 0 or ny == 0:
            continue
        x1, y1 = x0 + nx - 1, y0 + ny - 1
        for gy in range(gy_n):
            for gx in range(gx_n):
                if not (x0 // g <= gx <= x1 // g and y0 // g <= gy <= y1 // g):
                    continue
                cx0, cy0 = x0 // g, y0 // g
                ncx, ncy = x1 // g - cx0 + 1, y1 // g - cy0 + 1
                if rc["exact_tile_test"] and ncx <= 8 and ncy <= 8:
                    con = sp["conic"][i]
                    cw, ch = float(g * tw), float(g * th)
                    u0 = torch.tensor(float(gx) * cw) - sp["xy"][i, 0]
                    v0 = torch.tensor(float(gy) * ch) - sp["xy"][i, 1]
                    fmin = ref._quad_min(con[0], con[1], con[2], u0,
                                         u0 + (cw - 1.0), v0,
                                         v0 + (ch - 1.0))
                    q = 2.0 * torch.log(torch.clamp_min(
                        sp["opacity"][i], 1e-12) / rc["alpha_min"])
                    if not bool(fmin <= q * (1.0 + 1e-4) + 1e-4):
                        continue
                pairs += 1
                lists.setdefault(gy * gx_n + gx, []).append(i)
    dq = sp["depth"].contiguous().view(torch.int32).to(torch.int64) \
        >> gr["depth_shift"]
    rows = ref.splat_rows(sp)
    h, w = rc["image_height"], rc["image_width"]
    img = torch.zeros((h, w, 4))
    live = 0
    for py in range(h):
        for px in range(w):
            grp = (py // th // g) * gx_n + (px // tw // g)
            order = sorted(lists.get(grp, []), key=lambda i: (int(dq[i]), i))
            t, rgb = 1.0, torch.zeros(3)
            for i in order:
                gx_, gy_, ca, cb, cc, r, gg, b, op = rows[i].tolist()
                dx, dy = gx_ - px, gy_ - py
                power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                alpha = min(op * math.exp(power), rc["alpha_clamp"])
                if power > 0.0 or alpha < rc["alpha_min"]:
                    continue
                if t * (1.0 - alpha) < rc["transmittance_eps"]:
                    break
                rgb += alpha * t * torch.tensor([r, gg, b])
                t *= 1.0 - alpha
                live += 1
            img[py, px, :3] = rgb
            img[py, px, 3] = 1.0 - t
    return pairs, live, img


@pytest.mark.parametrize("cell_name,n", [("capture1m-orbit", 60),
                                         ("demo38k-orbit", 40)])
def test_counts_equal_brute_force(cell_name, n):
    _, rc, _, params, cam = _setup(cell_name, n)
    out = ref.render(params, *cam, rc)
    sp = ref.project(params, *cam, rc)
    pairs, live, img = _brute_force(sp, rc)
    assert out["pairs"] == pairs > 0
    assert out["live"] == live > 0
    assert float((out["image"] - img).abs().max()) < 1e-5


def _port_cfg(rc):
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
    r = dict(rc)
    r["background"] = tuple(r["background"])
    return RasterConfig(pair_capacity=1 << 14, **r)


@pytest.mark.parametrize("cell_name,n", [("capture1m-orbit", 800),
                                         ("demo38k-orbit", 300)])
def test_frame_matches_the_port(cell_name, n):
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render.pipeline import render
    _, rc, _, params, cam = _setup(cell_name, n, w=192, h=128)
    model = GaussianModel(*(params[k].clone() for k in inputs.FIELDS))
    got = render(model, Camera(*cam), _port_cfg(rc))
    assert int(got.overflow) == 0 and int(got.truncated) == 0
    want = ref.render(params, *cam, rc)
    assert int(got.num_pairs) == want["pairs"]
    assert float((got.image - want["image"]).abs().max()) < 1e-5


@pytest.mark.parametrize("cell_name,n", [("capture1m-fit", 600),
                                         ("demo38k-fit", 300)])
def test_step_matches_the_port(cell_name, n):
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render.pipeline import render
    from gaussian_splat_ipu_tpu_torch.train import trainer
    cell, rc, _, gt, cam = _setup(cell_name, n, w=160, h=96)
    init = inputs.perturb(gt, cell.traffic["perturb"], 7)
    tc = fit_driver.train_settings(cell.config, cell.traffic)
    cfg = _port_cfg(rc)
    target = render(GaussianModel(*(gt[k] for k in inputs.FIELDS)),
                    Camera(*cam), cfg).image
    state = trainer.init_state(GaussianModel(
        *(init[k].clone() for k in inputs.FIELDS), requires_grad=True))
    tcfg = trainer.TrainConfig(**tc)
    _, loss = trainer.train_step(state, Camera(*cam), target, cfg, tcfg)
    loss_r, grads, _ = ref.loss_and_grads(init, *cam, target, rc,
                                          tc["ssim_weight"])
    after = ref.Adam(init, tc).step(init, grads)
    assert abs(float(loss) - float(loss_r)) <= 1e-5 * float(loss_r)
    for k in inputs.FIELDS:
        g_p = state.opt_state.adam[k].mu / (1.0 - fit_driver.B1)
        assert torch.allclose(g_p, grads[k], rtol=1e-3, atol=1e-7), k
        d_p = getattr(state.params, k).detach() - init[k]
        assert torch.allclose(d_p, after[k] - init[k], rtol=1e-3,
                              atol=1e-7), k


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import splatbench.reference.render, splatbench.reference.work\n"
            "bad = {'jax', 'jaxlib', 'flax', 'gaussian_splat_ipu_tpu',\n"
            "       'gaussian_splat_ipu_tpu_torch'}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
