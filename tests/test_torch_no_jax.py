"""The port must run where JAX and the JAX package are absent: a
subprocess blocks every `jax` import and every import of
`gaussian_splat_ipu_tpu` (not of the port), imports the whole port,
renders a tiny frame, bins it into row buckets, takes one train step on
the CPU and one through the engine's step program, writes and reads a
.splat and a COLMAP capture, seeds a model from points, runs the
training extras (a densify step and event, an aux step (pose + exposure)
and the sparse depth loss) and the distributed path, renders the
dense oracle inside a profiling trace and Tracepoint, runs the scene tool
and builds the native host library into a temporary directory."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys

    REF = "gaussian_splat_ipu_tpu"

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError("jax is blocked: " + name)
            if name == REF or name.startswith(REF + "."):
                raise ImportError("the JAX package is blocked: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())
    import numpy as np
    import torch
    import gaussian_splat_ipu_tpu_torch as port
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(m.name)
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.render.pipeline import render
    from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    model = GaussianModel.random(200, generator=g, device="cpu")
    cam = Camera.orbit(-np.ones(3), np.ones(3), 0.7, 1.5, device="cpu")
    cfg = RasterConfig(image_width=48, image_height=32, tile_width=16,
                       tile_height=16, chunk_size=32, pair_capacity=2048,
                       exact_tile_test=True)
    out = render(model, cam, cfg)
    assert out.image.shape == (32, 48, 4)
    assert bool(torch.isfinite(out.image).all())
    assert int(out.num_pairs) > 0

    import dataclasses
    from gaussian_splat_ipu_tpu_torch.render import binning
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    seg = binning.bin_splats(project_gaussians(model, cam, cfg),
                             dataclasses.replace(cfg, rowseg_buckets=2))
    assert int(seg.num_pairs) == int(out.num_pairs)
    assert int(seg.tile_starts.max()) > int(seg.num_pairs)  # 2 segments

    from gaussian_splat_ipu_tpu_torch.train import trainer
    tc = trainer.TrainConfig()
    state = trainer.init_state(model.trainable(), tc)
    state, loss = trainer.train_step(state, cam, out.image * 0.5, cfg, tc)
    assert bool(torch.isfinite(loss)) and float(loss) > 0.0
    assert int(state.step) == 1
    assert not torch.equal(state.params.means, model.means)

    import os, tempfile
    from gaussian_splat_ipu_tpu_torch.io import colmap, splat
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    from gaussian_splat_ipu_tpu_torch.utils.image import write_png
    eng = RenderEngine(RuntimeConfig(device="cpu"))
    trainer.register_step(eng, state, cam, out.image * 0.5, cfg, tc)
    assert float(eng.run(trainer.STEP_PROGRAM, state, cam,
                         out.image * 0.5)) > 0.0 and int(state.step) == 2
    d = tempfile.mkdtemp()
    splat.write_splat(os.path.join(d, "m.splat"), model)
    assert splat.read_splat(os.path.join(d, "m.splat"))["means"].shape == (
        200, 3)
    os.makedirs(os.path.join(d, "images"))
    write_png(os.path.join(d, "images", "a.png"), np.zeros((32, 48, 3)))
    colmap.write_binary_model(
        os.path.join(d, "sparse", "0"),
        {1: ("PINHOLE", 48, 32, [40.0, 40.0, 24.0, 16.0])},
        {1: ("a.png", np.array([1.0, 0, 0, 0]), np.array([0, 0, 3.0]), 1,
             [])}, {1: ((0.0, 0.0, 0.0), (9, 9, 9), [])})
    fs, xyz, rgb = colmap.load_colmap(d, device="cpu")
    assert len(fs) == 1 and xyz.shape == (1, 3)
    GaussianModel.from_points(np.random.rand(5, 3), np.random.rand(5, 3),
                              device="cpu")

    from gaussian_splat_ipu_tpu_torch.train import aux_opt, densify, depth
    dstate = densify.init_state(200, 240, device="cpu")
    dst = trainer.init_state(densify.pad_model(model, 240).trainable(), tc)
    loss = densify.make_train_step(cfg, tc)(
        dst, dstate.grad_sum, dstate.vis_count, cam, out.image * 0.5)
    assert float(loss) > 0.0 and int(dstate.vis_count.sum()) > 0
    _, dstate = densify.densify_and_prune(
        dst, dstate, densify.DensifyConfig(grad_threshold=1e-9))
    assert int(dstate.alive.sum()) > 200
    aux = aux_opt.init_aux_state(2, 1e-3, 1e-2, device="cpu")
    loss = aux_opt.make_aux_step(cfg, tc, 1e-3, 1e-2)(
        state, aux, torch.tensor(1), cam, out.image * 0.5, None, None)
    assert float(loss) > 0.0 and float(aux.pose.deltas.abs().sum()) > 0.0
    obs = torch.tensor([[20.0, 16.0, 3.0], [30.0, 10.0, 4.0]])
    d = depth.sparse_depth_loss(model, cam, obs, torch.ones(2, dtype=bool),
                                cfg)
    assert bool(torch.isfinite(d))

    from gaussian_splat_ipu_tpu_torch.app import main as app_main
    from gaussian_splat_ipu_tpu_torch.app import train as app_train
    from gaussian_splat_ipu_tpu_torch.io.scene import write_ply
    from gaussian_splat_ipu_tpu_torch.parallel import distributed
    from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
    msh = mesh_lib.make_mesh(2, device="cpu")
    sm = mesh_lib.shard_model(model, msh)
    so = distributed.render_sharded(sm, cam, cfg, msh, pair_capacity=2048)
    assert float((so.image - out.image).abs().max()) <= 1e-5
    assert int(so.exchange_overflow) == 0
    views = distributed.render_views_sharded(
        sm, [cam, cam], cfg, mesh_lib.make_mesh_2d(2, 1, device="cpu"))
    assert views.shape == (2, 32, 48, 4)
    st = trainer.init_state(sm.trainable(), tc)
    _, loss = distributed.make_sharded_train_step(msh, cfg, tc)(
        st, cam, out.image * 0.5)
    assert bool(torch.isfinite(loss)) and int(st.step) == 1
    td = tempfile.mkdtemp()
    write_ply(os.path.join(td, "s.ply"), model)
    small = ["--input", os.path.join(td, "s.ply"), "--device", "cpu",
             "--width", "48", "--height", "32", "--pair-capacity", "2048",
             "--log-level", "off"]
    assert app_main.run(small + ["--distributed", "2", "--output",
                                 os.path.join(td, "o.png")])["shards"] == 2
    got = app_train.run(small + ["--views", "2", "--steps", "2",
                                 "--distributed", "2", "--view-batch", "2"])
    assert got["shards"] == 2 and got["step"] == 1

    from gaussian_splat_ipu_tpu_torch.render.oracle import render_oracle
    from gaussian_splat_ipu_tpu_torch.utils import profiling
    with profiling.trace(os.path.join(td, "trace")):
        with profiling.Tracepoint("oracle"):
            ref = render_oracle(model, cam, cfg)
    assert float((ref - out.image).abs().max()) <= 1e-4
    assert profiling.tracepoint_summary()["oracle"]["count"] == 1
    assert os.path.isfile(os.path.join(td, "trace", "trace.json"))

    from gaussian_splat_ipu_tpu_torch.app import scene_tool
    from gaussian_splat_ipu_tpu_torch.io import native
    assert scene_tool.main([
        "--input", os.path.join(td, "s.ply"), "--prune-opacity", "0.2",
        "--max-sh", "1", "--center-flip", "--output",
        os.path.join(td, "t.ply"), "--output-splat",
        os.path.join(td, "t.splat"), "--stats", "--log-level", "off"],
        device="cpu") == 0
    assert splat.count_records(os.path.join(td, "t.splat")) > 0
    native.BUILD_DIR = os.path.join(td, "native")
    assert native.build().startswith(native.BUILD_DIR) and native.available()
    write_png(os.path.join(td, "p.png"), np.full((6, 5, 3), 0.5))
    pf = native.ImagePrefetcher(1)
    img, size = pf.fetch(pf.submit(os.path.join(td, "p.png"), 2))
    pf.close()
    assert img.shape == (3, 2, 3) and size == (5, 6)
    assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
    assert not any(k == REF or k.startswith(REF + ".") for k in sys.modules)
    print("OK")
""")


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
