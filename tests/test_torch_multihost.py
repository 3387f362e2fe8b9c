"""The port's multi-process path (parallel/multihost.py) on the CPU: two
processes in a gloo group, each under its own time limit, load their
shards of a 97-gaussian PLY (an odd count: the last shard is padded),
render them sharded with a gradient and export the PLY by positional
writes. Held to the JAX package's single-process load (rows, bounds) and
export (bytes), and to the port's one-process render over a 2-shard mesh
(image and pairs equal, gradient norm rtol 1e-5). A second pair renders a
random model with every exchange bucket capped at 128 rows: the rows past
the cap are dropped and counted, and no other row is lost."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from gaussian_splat_ipu_tpu.io.scene import load_scene as j_load_scene
from gaussian_splat_ipu_tpu.train import checkpoint as jcheckpoint
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.io.scene import load_scene
from gaussian_splat_ipu_tpu_torch.parallel import distributed, mesh, multihost
from tests._torch_multihost_child import CFG
from tests.test_multihost import _write_gaussian_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_multihost_child.py")
CAPPED_CHILD = os.path.join(REPO, "tests", "_torch_capped_exchange_child.py")
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


def _strip_demand(model, cam, cfg, d) -> list:
    """Rows a shard sends each of d strips, by a loop over its splats:
    one row to each strip whose tile rows the splat's footprint touches."""
    from gaussian_splat_ipu_tpu_torch.render import binning
    from gaussian_splat_ipu_tpu_torch.render.projection import (
        project_gaussians)
    rows = distributed._rows_per_device(cfg, d)
    with torch.no_grad():
        _, y0, nx, ny = binning.tile_ranges_of(
            project_gaussians(model, cam, cfg), cfg)
    demand = [0] * d
    for y, w, h in zip(y0.tolist(), nx.tolist(), ny.tolist()):
        if w > 0 and h > 0:
            for j in range(y // rows, (y + h - 1) // rows + 1):
                demand[j] += 1
    return demand


def test_two_processes_drop_and_count_rows_past_a_capped_bucket(tmp_path):
    """Buckets sized by the demand still honour the capacity: with
    _exchange_capacity patched to 128 rows, the frame's exchange_overflow
    is the sum of max(demand - 128, 0) over every (source, destination)
    bucket, and every other row is sent and received."""
    from tests._torch_capped_exchange_child import CAP_ROWS, scene
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, CAPPED_CHILD, str(r), "2", coord, outs[r]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0 and out.strip().endswith("OK"), err[-3000:]
    got = [torch.load(o) for o in outs]

    model, cam = scene()
    half = model.num_gaussians // 2
    demand = [_strip_demand(GaussianModel(*(
        getattr(model, k)[r * half:(r + 1) * half] for k in FIELDS)),
        cam, CFG, 2) for r in range(2)]
    dropped = sum(max(m - CAP_ROWS, 0) for row in demand for m in row)
    kept = sum(min(m, CAP_ROWS) for row in demand for m in row)
    assert dropped > 0
    for g in got:
        assert g["exchange_overflow"] == dropped
        c = g["counters"]
        assert c["exchange.bucket_rows"] == c["exchange.rows_sent"]
    assert sum(g["counters"]["exchange.rows_sent"] for g in got) == kept
    assert sum(g["counters"]["exchange.recv_rows"] for g in got) == kept
    assert torch.equal(got[0]["image"], got[1]["image"])
    assert float(got[0]["image"][..., 3].max()) > 0


def test_single_process_helpers():
    """Without a coordinator: no group, this process is the primary and
    owns every row."""
    assert multihost.initialize(device="cpu") is False
    assert multihost.is_primary() and multihost.process_count() == 1
    assert multihost.local_shard_bounds(100) == (0, 100)
