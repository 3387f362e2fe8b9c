"""The port must run where JAX is absent: a subprocess blocks every `jax`
import, imports the whole port, renders a tiny frame, bins it into row
buckets and takes one train step on the CPU."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError("jax is blocked: " + name)
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
    assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
    print("OK")
""")


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
