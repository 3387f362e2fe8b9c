"""The render engine (runtime/engine.py). On the CPU: register, run and
manifest, the unregistered KeyError, argument checks, and the device
choice, which falls back to nothing. On a CUDA card (marked `cuda`,
skipped without one): a replayed frame equals the eager frame bit for
bit, and the outputs of replay k survive replay k+1."""

import json
import logging

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu_torch.app import main as app
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig)

torch.set_num_threads(1)

CPU = RuntimeConfig(device="cpu")


def test_register_run_and_manifest_on_the_cpu():
    eng = RenderEngine(CPU)
    x = torch.arange(8.0)
    prog = eng.register("double", lambda v, k: v * k, (x, 2.0))
    assert prog.graph is None and prog.compile_seconds == 0.0
    torch.testing.assert_close(eng.run("double", x, 2.0), x * 2.0)
    # The CPU runs the function as it is, on whatever it is given.
    torch.testing.assert_close(eng.run("double", torch.ones(3), 3.0),
                               torch.full((3,), 3.0))
    manifest = json.loads(eng.manifest())
    assert manifest == {"programs": {"double": {"compile_seconds": 0.0,
                                                "cuda_graph": False}},
                        "device": "cpu"}
    assert eng.memory_stats() is None


def test_unregistered_program_raises():
    eng = RenderEngine(CPU)
    with pytest.raises(KeyError, match="unregistered program: 'nope'"):
        eng.run("nope")


def test_register_refuses_tensors_off_the_engine_device():
    eng = RenderEngine(CPU)
    with pytest.raises(ValueError, match="example tensor is on meta"):
        eng.register("f", lambda v: v, (torch.empty(2, device="meta"),))


def test_select_device_never_falls_back_to_the_cpu(monkeypatch):
    assert engine_lib.select_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        engine_lib.select_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_lib.select_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderEngine(RuntimeConfig(device="cuda"))


def test_setup_logging_maps_the_reference_levels(monkeypatch):
    seen = {}
    monkeypatch.setattr(logging, "basicConfig",
                        lambda **kw: seen.update(kw))
    for name, level in (("trace", logging.DEBUG), ("warn", logging.WARNING),
                        ("off", logging.CRITICAL), ("bogus", logging.INFO)):
        engine_lib.setup_logging(name)
        assert seen["level"] == level


def test_app_programs_on_the_cpu_engine():
    """The app's two programs, registered and run through a CPU engine,
    return the eager pipeline's FrameOutput."""
    cfg = RasterConfig(image_width=64, image_height=48, tile_width=16,
                       tile_height=16, chunk_size=32, pair_capacity=4096)
    g = torch.Generator().manual_seed(0)
    model = GaussianModel.random(300, generator=g, device="cpu")
    cam = Camera.orbit(-np.ones(3), np.ones(3), 0.7, 64 / 48,
                       rot_y_deg=15.0, env_rot=(0.1, 0.2), device="cpu")
    eng = RenderEngine(CPU)
    args = (model, cam.view, cam.proj, cam.env_rot)
    for name, prog in (("project", app.splat_program(cfg)),
                       ("points", app.points_program(cfg))):
        eng.register(name, prog, args)
        got = eng.run(name, *args)
        with torch.inference_mode():
            want = prog(*args)
        assert isinstance(got, app.FrameOutput)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert int(got.count) == int(got.tile_counts.sum()) > 0
    assert int(got.overflow) == int(got.truncated) == 0


def _frame_args(model, angle, device):
    cam = Camera.orbit(-np.ones(3), np.ones(3), 0.7, 160 / 96,
                       rot_y_deg=angle, device="cpu")
    return (model, cam.view.to(device), cam.proj.to(device),
            cam.env_rot.to(device))


@pytest.mark.cuda
def test_replay_equals_eager_and_outputs_survive_the_next_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode "
                    "(chip_smoke.py's engine phase runs this at full size)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = RasterConfig(image_width=160, image_height=96, tile_width=16,
                       tile_height=16, chunk_size=32, pair_capacity=1 << 14,
                       tile_group=2, exact_tile_test=True,
                       strict_termination=False)
    g = torch.Generator(device=dev).manual_seed(3)
    model = GaussianModel.random(1500, generator=g, device=dev)
    eng = RenderEngine(RuntimeConfig(device="cuda"))
    splat = app.splat_program(cfg)
    cuda_lib.launches.clear()
    prog = eng.register("project", splat, _frame_args(model, 0.0, dev))
    assert prog.graph is not None
    # Warm-up calls and the captured call launch; replays do not count.
    captured = dict(cuda_lib.launches)
    assert captured["rasterize_relaxed"] == engine_lib.WARMUP_CALLS + 1
    angles = (10.0, 75.0, 140.0, 205.0)
    outs = [eng.run("project", *_frame_args(model, a, "cpu"))
            for a in angles]
    assert dict(cuda_lib.launches) == captured
    with torch.inference_mode():
        for a, out in zip(angles, outs):
            want = splat(*_frame_args(model, a, dev))
            for name, x, y in zip(out._fields, out, want):
                assert torch.equal(x, y), (a, name)
    assert not torch.equal(outs[0].image, outs[1].image)
    # The registered model is passed as it is: no copy; a new model of the
    # same shape is copied in.
    other = GaussianModel.random(1500, generator=g, device=dev)
    got = eng.run("project", *_frame_args(other, 10.0, "cpu"))
    with torch.inference_mode():
        want = splat(*_frame_args(other, 10.0, dev))
    assert torch.equal(got.image, want.image)
    with pytest.raises(ValueError, match="captured"):
        eng.run("project", model, torch.zeros(3, 3), torch.zeros(4, 4),
                torch.zeros(2))
    assert eng.memory_stats()["allocation.all.current"] > 0
