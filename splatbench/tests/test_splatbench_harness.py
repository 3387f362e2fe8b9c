"""The harness on the CPU: BENCHMARK.json against the contract and the
files it names, cells found by name, traffic made from the seed, the
camera the app's, and the run's refusals."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from _tiny import ROOT, run_module, tiny_cell
from splatbench import harness, inputs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNITS = {"ms", "s", "%"}


def _bench():
    return harness.benchmark()


def test_benchmark_json_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["splatbench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        assert c["file"] == f"splatbench/configs/{c['name']}.json"
    names = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        names.add(w["name"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["unit"] in UNITS and NAME.match(m["name"])
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", names)) <= names
    for m in b["per_layer"]:
        assert m["unit"] in UNITS and NAME.match(m["name"])
        assert m["moves"] in e2e and set(m["workloads"]) <= names
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", names)
    for cell in names:
        reported = [m for m in b["end_to_end"]
                    if cell in m.get("workloads", names)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_finds_its_files():
    b = _bench()
    here = os.path.join(ROOT, "splatbench")
    for w in b["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert os.path.isfile(os.path.join(
            here, "drivers", cell.traffic["driver"] + ".py"))
        assert set(cell.limits) and all(
            isinstance(v, float) for v in cell.limits.values())
    for m in b["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert reader.LAYER == m["layer"]
        assert reader.MOVES == m["moves"]
        assert reader.UNIT == m["unit"]


def test_a_new_config_is_found_without_editing_the_harness(tmp_path):
    shutil.copytree(os.path.join(ROOT, "splatbench"), tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = _bench()
    cfg = json.loads((tmp_path / "splatbench/configs/demo-38k.json")
                     .read_text())
    cfg["name"] = "demo-76k"
    cfg["scene"]["gaussians"] = 75_882
    (tmp_path / "splatbench/configs/demo-76k.json").write_text(
        json.dumps(cfg))
    (tmp_path / "splatbench/limits/demo76k-orbit.json").write_text(
        (tmp_path / "splatbench/limits/demo38k-orbit.json").read_text())
    b["configs"].append(dict(b["configs"][1], name="demo-76k",
                             file="splatbench/configs/demo-76k.json"))
    b["workloads"].append(dict(name="demo76k-orbit", config="demo-76k",
                               traffic="orbit", chips=1, why="a test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.find_cell("demo76k-orbit", root=str(tmp_path))
    assert cell.config["scene"]["gaussians"] == 75_882
    assert cell.traffic["driver"] == "orbit"
    assert {m["name"] for m in cell.e2e} == {"setup_s"}


def test_traffic_repeats_for_a_seed_and_differs_between_seeds():
    cell = harness.find_cell("capture1m-fit")
    scene = dict(cell.config["scene"], gaussians=500)
    a = inputs.make_scene(scene, 3_000_000_019, "cpu")
    b = inputs.make_scene(scene, 3_000_000_019, "cpu")
    c = inputs.make_scene(scene, 3_000_000_021, "cpu")
    for k in inputs.FIELDS:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    pa = inputs.perturb(a, cell.traffic["perturb"], 3_000_000_019)
    pb = inputs.perturb(b, cell.traffic["perturb"], 3_000_000_019)
    pc = inputs.perturb(a, cell.traffic["perturb"], 3_000_000_021)
    for k in inputs.FIELDS:
        assert torch.equal(pa[k], pb[k]) and not torch.equal(pa[k], pc[k])
    seeds = (3_000_000_019, 3_000_000_021, 7, 2 ** 33 + 5)
    orders = [inputs.epoch_order(64, s, 0) for s in seeds]
    assert orders[0] == inputs.epoch_order(64, seeds[0], 0)
    assert len({tuple(o) for o in orders}) == len(seeds)
    assert inputs.epoch_order(64, seeds[0], 1) != orders[0]
    assert sorted(orders[0]) == list(range(64))
    yaws = [inputs.orbit_start_yaw(s) for s in seeds]
    assert yaws[0] == inputs.orbit_start_yaw(seeds[0])
    assert len(set(yaws)) > 1 and all(0 <= y < 360 for y in yaws)


def test_the_cameras_are_the_apps():
    from gaussian_splat_ipu_tpu_torch.app.main import orbit_camera
    from gaussian_splat_ipu_tpu_torch.io.scene import Scene

    cell = harness.find_cell("capture1m-orbit")
    s = cell.config["scene"]
    rc = cell.config["raster"]
    fov = __import__("math").radians(cell.config["fov_deg"])
    aspect = rc["image_width"] / rc["image_height"]
    import numpy as np
    scene = Scene(model=None, bb_min=np.asarray(s["box_min"], np.float32),
                  bb_max=np.asarray(s["box_max"], np.float32))
    for pitch, yaw in ((0.0, 0.0), (0.0, 137.0), (-15.0, 11.25),
                       (20.0, 348.75)):
        cam = orbit_camera(scene, dict(fov=fov, rx=pitch, ry=yaw, x=0.0,
                                       y=0.0, z=0.0, erx=0.0, ery=0.0),
                           aspect)
        view, proj, env = inputs.orbit_camera(s["box_min"], s["box_max"],
                                              fov, aspect, pitch, yaw)
        assert torch.equal(view, cam.view) and torch.equal(proj, cam.proj)
        assert torch.equal(env, cam.env_rot)


def _run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "splatbench/run.py", "--workload", "demo38k-orbit",
         "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_refuses_without_a_card():
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "{" not in out.stdout


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(os.path.join(ROOT, "splatbench"), tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run_cli(str(tmp_path))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_the_harness_loads_no_jax():
    code = (
        "import sys, glob, os\n"
        "sys.path.insert(0, %r)\n"
        "from splatbench import harness, inputs, metrics_common\n"
        "import splatbench.reference.render, splatbench.reference.work\n"
        "for f in glob.glob(os.path.join(%r, 'splatbench', 'drivers', "
        "'*.py')) + glob.glob(os.path.join(%r, 'splatbench', 'metrics', "
        "'*.py')):\n"
        "    harness.load_module(f, 'm_' + os.path.basename(f)"
        ".replace('.', '_'))\n"
        "harness.load_module(os.path.join(%r, 'splatbench', 'run.py'), "
        "'sb_run')\n"
        "import gaussian_splat_ipu_tpu_torch.app.main\n"
        "import gaussian_splat_ipu_tpu_torch.train.trainer\n"
        "print(harness.blocked_modules())" % (ROOT, ROOT, ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_blocked_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gaussian_splat_ipu_tpu_torchish",
                        sys)
    assert harness.blocked_modules() == []
    monkeypatch.setitem(sys.modules, "gaussian_splat_ipu_tpu.x", sys)
    assert harness.blocked_modules() == ["gaussian_splat_ipu_tpu.x"]


@pytest.mark.parametrize("name", [m["name"] for m in _bench()["per_layer"]])
def test_readers_return_nothing_without_a_reading(name):
    reader = harness.metric_reader(name)
    for kind in ("view", "train"):
        r = dict(kind=kind, enqueue_s=[], profile={}, work=[], items=0,
                 rc={}, scene={}, ssim_weight=0.2)
        assert reader.read(r) is None


class _Event:
    """A profiler event as read_profile reads it."""

    def __init__(self, name, start, dur, device, kind):
        self._v = (name, start, dur, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return types.SimpleNamespace(name=self._v[3])

    def is_user_annotation(self):
        return self._v[4] in ("user_annotation", "gpu_user_annotation")


def test_read_profile_counts_only_kernels_copies_and_fills():
    events = [
        _Event("rasterize_fwd_kernel", 100, 100, "CUDA", "kernel"),
        _Event("Memcpy DtoH (Device -> Pinned)", 300, 50, "CUDA",
               "gpu_memcpy"),
        _Event("Memset (Device)", 340, 20, "CUDA", "gpu_memset"),
        # An annotation mirrored onto the device's timeline, as a
        # record_function range inside the program would be: it spans the
        # gaps and names a kernel, and is no work.
        _Event("render rasterize_fwd_kernel", 0, 1000, "CUDA",
               "gpu_user_annotation"),
        _Event("render", 0, 1000, "CPU", "user_annotation"),
        _Event("cudaGraphLaunch", 10, 5, "CPU", "cuda_runtime"),
    ]
    marks = [(0, 90, "enqueue"), (200, 300, "to_host")]
    r = harness.read_profile(events, marks, 0, 1000)
    assert r["kernel_s"] == pytest.approx(
        {"rasterize_fwd_kernel": 100e-9,
         "Memcpy DtoH (Device -> Pinned)": 50e-9,
         "Memset (Device)": 20e-9})
    assert r["busy_s"] == pytest.approx(160e-9)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"enqueue": 100e-9, "to_host": 100e-9,
         "outside the harness's spans": 640e-9})


@pytest.mark.parametrize("name", ["demo38k-orbit", "demo38k-fit"])
def test_a_traced_run_profiles_the_windows_own_loop(name):
    cell = tiny_cell(name)
    if "profiled_frames" in cell.traffic:
        cell.traffic["profiled_frames"] = 5
    out = run_module().run_one(cell, 2_200_000_029, 0.3, True,
                               torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    info = out["info"]
    stretch = info.get("stretch_frame_ms") or info.get("stretch_step_ms")
    assert stretch and stretch > 0
    kind = "view" if name.endswith("orbit") else "train"
    assert f"enqueue_ms.{kind}" in out["metrics"]
    # No kernel runs on the CPU: the rooflines find nothing to read.
    assert not any("roofline" in m for m in out["metrics"])
