"""Density control of the port (train/densify.py) against the benchmark's
plain reference of it (splatbench/reference/densify.py) on the CPU, at a
small size: about 300 live gaussians in a buffer of 512 slots, 64x48,
SH 3, weights drawn from a seed. The densify step's statistics after a few
steps, events with splits, clones, prunes and a full buffer, the event's
counts tensor, the pair-demand guard against the train CLI's rule, the
spans and counters with recording on and off, and the benchmark's densify
driver on a tiny cell: correct when sound, not correct under its control
and its faults."""

from __future__ import annotations

import copy
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gaussian_splat_ipu_tpu_torch.app.main import splat_program  # noqa: E402
from gaussian_splat_ipu_tpu_torch.models.camera import Camera  # noqa: E402
from gaussian_splat_ipu_tpu_torch.models.gaussians import (  # noqa: E402
    FIELDS, GaussianModel)
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib  # noqa: E402
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine  # noqa: E402,E501
from gaussian_splat_ipu_tpu_torch.train import densify, trainer  # noqa: E402
from gaussian_splat_ipu_tpu_torch.utils import profiling  # noqa: E402
from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig  # noqa: E402,E501
from splatbench import harness, inputs  # noqa: E402
from splatbench.reference import densify as refd  # noqa: E402
from splatbench.reference import render as ref  # noqa: E402

torch.set_num_threads(1)

CELL = "capture1m-densify"
LIVE, SLOTS, W, H = 300, 512, 64, 48
SEED = 2_300_000_011


def tiny_config() -> dict:
    config = copy.deepcopy(harness.find_cell(CELL).config)
    config["raster"].update(image_width=W, image_height=H)
    config["scene"]["gaussians"] = LIVE
    config["slots"] = SLOTS
    return config


def tiny_cell():
    """The benchmark's cell at the tiny size: 4 views, an event every
    epoch from step 504."""
    cell = harness.find_cell(CELL)
    cell.config = tiny_config()
    cell.config["start_step"] = 504
    cell.config["densify"]["densify_every"] = 4
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["views_per_ring"] = 2
    return cell


def _run_module():
    return harness.load_module(os.path.join(ROOT, "splatbench", "run.py"),
                               "splatbench_run")


@pytest.fixture(scope="module")
def setup():
    """The scene, its start in the slot buffer, three views and their
    targets (the reference's renders of the ground truth), the raster and
    train settings."""
    config = tiny_config()
    rc = config["raster"]
    gt = inputs.make_scene(config["scene"], SEED, "cpu")
    init = inputs.perturb(gt, {"means": 0.01, "log_scales": 0.1,
                               "quats": 0.05, "opacities": 0.5, "sh": 0.1},
                          SEED)
    box = config["scene"]
    cams = [inputs.orbit_camera(box["box_min"], box["box_max"],
                                math.radians(config["fov_deg"]), W / H, p, y)
            for p, y in ((-15.0, 0.0), (20.0, 120.0), (-15.0, 240.0))]
    cap = harness.probe_capacity(config, [gt, init], cams)
    cfg = harness.raster_config(config, cap)
    fit = harness.load_module(os.path.join(ROOT, "splatbench", "drivers",
                                           "fit.py"), "splatbench_fit_t")
    tc = fit.train_settings(config, {})
    targets = [ref.render(gt, *c, rc)["image"] for c in cams]
    init_slots = {k: v.clone() for k, v in refd_padded(init).items()}
    return dict(rc=rc, cfg=cfg, tc=tc, cams=cams, targets=targets,
                init=init, init_slots=init_slots, cap=cap)


def refd_padded(params):
    drv = harness.load_module(os.path.join(ROOT, "splatbench", "drivers",
                                           "densify.py"),
                              "splatbench_densify_t")
    return drv.padded(params, SLOTS)


def port_state(params: dict, tc: dict):
    model = GaussianModel(*(params[k].clone() for k in FIELDS))
    return trainer.init_state(densify.pad_model(model, SLOTS).trainable(),
                              trainer.TrainConfig(**tc))


# -- (a) the step's statistics --------------------------------------------------

def test_statistics_after_steps_match_the_reference(setup):
    s = setup
    state = port_state(s["init"], s["tc"])
    d = densify.init_state(LIVE, SLOTS, device="cpu")
    step = densify.make_train_step(s["cfg"], trainer.TrainConfig(**s["tc"]))
    losses = []
    for (v, p, e), target in zip(s["cams"], s["targets"]):
        losses.append(float(step(state, d.grad_sum, d.vis_count,
                                 Camera(v, p, e), target)))
    want = refd.steps(s["init_slots"], s["cams"], [0, 1, 2], s["targets"],
                      s["rc"], s["tc"], torch.float32)
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    assert int(d.vis_count.sum()) > 3 * LIVE // 2
    assert torch.equal(d.vis_count, want[4])
    assert harness.rel_l2(d.grad_sum, want[3]) < 1e-4
    for k in FIELDS:
        assert harness.rel_l2(getattr(state.params, k).detach(),
                              want[2][k]) < 1e-5, k
    assert not d.vis_count[LIVE:].any() and not d.grad_sum[LIVE:].any()


# -- (b) the event ----------------------------------------------------------------

def _event_state(setup, alive_n: int, prune_n: int, seed: int):
    """A state for an event: the start in the buffer with `alive_n` slots
    alive, `prune_n` of them below the opacity floor, statistics drawn so
    that about half the live slots are candidates (some tied), and
    moments drawn at random."""
    gen = torch.Generator().manual_seed(seed)
    base = setup["init"]
    rows = torch.randint(0, LIVE, (alive_n,), generator=gen)
    params = refd_padded({k: v[rows] for k, v in base.items()})
    # Half the live slots large (splits), half small (clones).
    params["log_scales"][:alive_n] += torch.where(
        torch.rand((alive_n, 1), generator=gen) < 0.5, 1.5, -1.5)
    params["opacities"][:prune_n] = -8.0
    state = port_state({k: v[:LIVE] for k, v in params.items()},
                       setup["tc"])
    with torch.no_grad():
        for k in FIELDS:
            getattr(state.params, k).copy_(params[k])
        for st in state.opt_state.adam.values():
            st.mu.copy_(torch.randn(st.mu.shape, generator=gen))
            st.nu.copy_(torch.rand(st.nu.shape, generator=gen))
    d = densify.init_state(alive_n, SLOTS, device="cpu")
    d.vis_count.copy_(torch.randint(0, 4, (SLOTS,), generator=gen,
                                    dtype=torch.int32))
    gs = torch.rand((SLOTS,), generator=gen) * 4e-4
    gs[::7] = 3e-4     # ties among the candidates
    d.grad_sum.copy_(gs * d.vis_count)
    eps = [torch.randn((SLOTS, 3), generator=gen) for _ in range(2)]
    return state, d, eps


CASES = {"splits_clones_prunes": (LIVE, 40), "full_buffer": (500, 3),
         "no_births": (LIVE, 0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_event_matches_the_reference(setup, case):
    alive_n, prune_n = CASES[case]
    state, d, (eps_a, eps_b) = _event_state(setup, alive_n, prune_n,
                                            seed=len(case))
    cfg = densify.DensifyConfig(
        scene_extent=setup["tc"]["scene_extent"],
        grad_threshold=1.0 if case == "no_births" else 2e-4)
    before = {k: getattr(state.params, k).detach().clone() for k in FIELDS}
    moments = {f"{label}.{m}": getattr(st, m).clone()
               for label, st in state.opt_state.adam.items()
               for m in ("mu", "nu")}
    want = refd.event(before, d.grad_sum.clone(), d.vis_count.clone(),
                      d.alive.clone(), eps_a, eps_b,
                      dict(grad_threshold=cfg.grad_threshold,
                           scene_extent=cfg.scene_extent), moments)
    out = densify.densify_and_prune_core(state, d, cfg, eps_a, eps_b)
    assert out.dtype == torch.int64 and out.shape == (7,)
    got = dict(zip(densify.COUNT_NAMES, out.tolist()))
    assert got == want["counts"]
    assert torch.equal(d.alive, want["alive"])
    for k in FIELDS:
        torch.testing.assert_close(getattr(state.params, k).detach(),
                                   want["params"][k], rtol=1e-6, atol=1e-6,
                                   msg=k)
    for label, st in state.opt_state.adam.items():
        for m in ("mu", "nu"):
            assert torch.equal(getattr(st, m), want["moments"][
                f"{label}.{m}"]), (label, m)
    assert not d.grad_sum.any() and not d.vis_count.any()
    if case == "splits_clones_prunes":
        assert got["splits"] > 0 and got["clones"] > 0
        assert got["pruned"] == prune_n and got["dropped"] == 0
        assert got["placed"] == got["splits"] + got["clones"]
    elif case == "full_buffer":
        assert got["dropped"] > 0 and got["alive"] == SLOTS
        assert got["placed"] == SLOTS - alive_n + prune_n
    else:
        assert got["candidates"] == got["placed"] == 0
        assert got["alive"] == alive_n - prune_n


# -- the guard --------------------------------------------------------------------

def _engine_and_model(setup):
    state = port_state(setup["init"], setup["tc"])
    engine = RenderEngine(RuntimeConfig(device="cpu"))
    cams = [Camera(v, p, e) for v, p, e in setup["cams"]]
    engine.register("render", splat_program(setup["cfg"]), (
        state.params, cams[0].view, cams[0].proj, cams[0].env_rot))
    return engine, state, cams


def _inline_guard(engine, params, cams, capacity):
    """The guard as the train CLI had it inline: every view rendered, the
    worst demand, overflow and exchange overflow, and densification
    closed above 0.8 of the capacity."""
    probe = [engine.run("render", params, c.view, c.proj, c.env_rot)
             for c in cams]
    demand = max(int(o.count + o.overflow) for o in probe)
    ovf = max(int(o.overflow) for o in probe)
    xovf = max(int(o.exchange_overflow) for o in probe)
    return demand, ovf, xovf, demand > int(0.8 * capacity)


@pytest.mark.parametrize("share", [0.5, 1.2, 2.0])
def test_the_guard_reads_what_the_inline_guard_read(setup, share):
    engine, state, cams = _engine_and_model(setup)
    demand = _inline_guard(engine, state.params, cams, 1)[0]
    capacity = int(demand * share)
    counts = torch.arange(7, dtype=torch.int64)
    g = densify.pair_demand_guard(engine, state.params, cams, capacity,
                                  counts=counts)
    assert (g.demand, g.overflow, g.exchange_overflow, g.closes) == \
        _inline_guard(engine, state.params, cams, capacity)
    assert g.closes == (share < 1.25)
    assert g.counts == dict(zip(densify.COUNT_NAMES, range(7)))
    assert densify.pair_demand_guard(engine, state.params, cams,
                                     capacity).counts is None


# -- spans and counters ---------------------------------------------------------------

def _event_guard_reset(setup):
    engine, state, cams = _engine_and_model(setup)
    d = densify.init_state(LIVE, SLOTS, device="cpu")
    d.vis_count[:LIVE] = 1
    d.grad_sum[:LIVE] = torch.linspace(0.0, 1e-3, LIVE)
    cfg = densify.DensifyConfig(scene_extent=setup["tc"]["scene_extent"])
    counts = densify.new_counts("cpu")
    state, d = densify.densify_and_prune(state, d, cfg, counts)
    g = densify.pair_demand_guard(engine, state.params, cams, 1 << 20,
                                  counts=counts)
    densify.reset_opacity(state, d, cfg)
    return g


def test_spans_and_counters_with_recording_on(setup):
    rec = profiling.start("cpu")
    try:
        g = _event_guard_reset(setup)
        spans = rec.collect()
        summary = rec.summary()
    finally:
        profiling.stop()
    got = {(s.name, s.track) for s in spans}
    for name in ("densify.event", "densify.reset"):
        assert (name, "host") in got and (name, "device") in got
    assert ("densify.guard", "host") in got
    # The guard's renders are engine runs inside its host span.
    guard = next(i for i, s in enumerate(spans)
                 if s.name == "densify.guard" and s.track == "host")
    assert sum(s.parent == guard and s.name == "engine.run"
               for s in spans) == len(setup["cams"])
    assert summary["densify.events"] == 1
    assert summary["densify.births"] == g.counts["placed"] > 0
    assert summary["densify.dropped"] == g.counts["dropped"]
    assert summary["densify.pruned"] == g.counts["pruned"]
    assert summary["densify.alive"] == g.counts["alive"]
    assert summary["densify.pair_demand"] == g.demand


def test_nothing_is_recorded_or_launched_with_recording_off(setup,
                                                           monkeypatch):
    assert profiling.active is None
    before = profiling.tracepoint_summary()
    launches = dict(cuda_lib.launches)

    def no_stamp(*a, **k):
        raise AssertionError("a stamp with recording off")

    monkeypatch.setattr(profiling, "stamp_torch", no_stamp)
    _event_guard_reset(setup)
    after = profiling.tracepoint_summary()
    for name in ("densify.event", "densify.guard", "densify.reset"):
        assert after.get(name) == before.get(name)
        assert profiling.span(name, "cpu") is profiling._NULL
    assert dict(cuda_lib.launches) == launches


# -- the benchmark's driver ----------------------------------------------------------

def test_the_densify_driver_on_a_tiny_cell_is_within_its_limits():
    cell = tiny_cell()
    out = _run_module().run_one(cell, SEED, 0.2, True, torch.device("cpu"),
                                time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    assert set(out["checks"]) == set(cell.limits)
    info = out["info"]
    assert info["events_in_window"] >= 1 and not info["guard_closed"]
    assert all(e["placed"] > 0 and e["overflow"] == 0
               for e in info["events"])
    assert info["checked_event"]["placed"] == \
        info["reference_event"]["placed"] > 0
    for m in ("densify_event_ms", "densify_guard_ms", "enqueue_ms.train"):
        assert out["metrics"][m]["value"] > 0, m
    assert info["recorder_counters"]["densify.events"] == \
        info["events_in_window"] + 1
    assert profiling.active is None


@pytest.mark.parametrize("control,fault", [
    ("bfloat16", None), ("", "step_unchanged"), ("", "half_batch"),
    ("", "answer")])
def test_the_drivers_control_and_faults_are_not_correct(control, fault):
    out = _run_module().run_one(tiny_cell(), SEED, 0.2, False,
                                torch.device("cpu"), time.perf_counter(),
                                control=control, fault=fault)
    assert not out["correct"], out["checks"]
