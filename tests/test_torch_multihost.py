"""The port's multi-process path (parallel/multihost.py) on the CPU: two
processes in a gloo group, each under its own time limit, load their
shards of a 97-gaussian PLY (an odd count: the last shard is padded),
render them sharded with a gradient and export the PLY by positional
writes. Held to the JAX package's single-process load (rows, bounds) and
export (bytes), and to the port's one-process render over a 2-shard mesh
(image and pairs equal, gradient norm rtol 1e-5)."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from gaussian_splat_ipu_tpu.io.scene import load_scene as j_load_scene
from gaussian_splat_ipu_tpu.train import checkpoint as jcheckpoint
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import FIELDS
from gaussian_splat_ipu_tpu_torch.io.scene import load_scene
from gaussian_splat_ipu_tpu_torch.parallel import distributed, mesh, multihost
from tests._torch_multihost_child import CFG
from tests.test_multihost import _write_gaussian_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_multihost_child.py")
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_load_render_and_export(tmp_path):
    ply = str(tmp_path / "scene.ply")
    _write_gaussian_ply(ply, n=97)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(r), "2", coord, ply, str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip().endswith("OK"), err[-3000:]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    # Loading: each process's rows are the JAX package's single-process
    # load (centred on the global box), the last one padded to 49 rows.
    want = j_load_scene(ply)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["bb_min"], want.bb_min)
        np.testing.assert_array_equal(g["bb_max"], want.bb_max)
        assert tuple(g["bounds"]) == (49 * r, min(49 * (r + 1), 97))
        lo, hi = 49 * r, min(49 * (r + 1), 97)
        for k in FIELDS:
            np.testing.assert_array_equal(
                g[k][:hi - lo], np.asarray(getattr(want.model, k))[lo:hi],
                err_msg=k)
    assert float(got[1]["opacities"][-1]) == -30.0

    # The export: the JAX package's PLY of the padded model, byte for byte.
    ref = str(tmp_path / "ref.ply")
    jcheckpoint.export_ply(ref, want.model.pad_to(98))
    assert (tmp_path / "export.ply").read_bytes() == open(ref, "rb").read()

    # The render: both processes hold the frame of the one-process render
    # over a 2-shard mesh, and the same gradient norm.
    scene = load_scene(ply, device="cpu")
    msh = mesh.make_mesh(2, device="cpu")
    model = mesh.shard_model(scene.model, msh).trainable()
    cam = Camera.orbit(scene.bb_min, scene.bb_max, float(np.radians(45.0)),
                       0.25, device="cpu")
    out = distributed.render_sharded(model, cam, CFG, msh)
    grads = torch.autograd.grad(out.image.abs().mean(),
                                tuple(model.parameters()))
    sumsq = float(sum((g * g).sum() for g in grads))
    for g in got:
        np.testing.assert_array_equal(g["image"], out.image.detach().numpy())
        assert int(g["num_pairs"]) == int(out.num_pairs) > 0
        np.testing.assert_allclose(float(g["sumsq"]), sumsq, rtol=1e-5)
    assert sumsq > 0


def test_single_process_helpers():
    """Without a coordinator: no group, this process is the primary and
    owns every row."""
    assert multihost.initialize(device="cpu") is False
    assert multihost.is_primary() and multihost.process_count() == 1
    assert multihost.local_shard_bounds(100) == (0, 100)
