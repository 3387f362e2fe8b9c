"""Multi-process training in the port's train CLI on the CPU: two
processes in a gloo group (tests/_torch_train_child.py, each under its own
time limit) train tests/test_torch_distributed_app.py's COLMAP capture
with --distributed, a shard per process, and are held to the one-process
--distributed 2 run: per-step losses within rtol 1e-6 (measured: equal),
the checkpoint's leaves equal, the exported PLY's values within 1e-6;
with --densify and births, the events at the same steps with the same
alive counts. The final loss and PSNR are held to the JAX CLI's
--distributed run at that file's bars. A replicated run (no
--distributed) trains as one process and only the primary writes."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.app import train as japp_train
from gaussian_splat_ipu_tpu_torch.app import train as app_train
from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
from tests.test_torch_distributed_app import _capture, _close, _printed
from tests.test_torch_multihost import REPO, _free_port

torch.set_num_threads(1)
CHILD = os.path.join(REPO, "tests", "_torch_train_child.py")
TIMEOUT_S = 180
PROCESSES = 2
STEP_RTOL = 1e-6


def run_processes(tmp_path, argv) -> list:
    """The train CLI in PROCESSES processes; each one's statistics. On a
    time-out every process is killed and their stderr reported."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = [str(tmp_path / f"stats{r}.json") for r in range(PROCESSES)]
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(r), str(PROCESSES), coord, outs[r],
         *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(PROCESSES)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1][-2000:] for p in procs]
        pytest.fail(f"a process outlived {TIMEOUT_S} s: {errs}")
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0 and out.strip().endswith("OK"), err[-3000:]
    stats = []
    for path in outs:
        with open(path) as f:
            stats.append(json.load(f))
    return stats


def _leaves(path) -> list:
    with np.load(path) as d:
        return [d[f"leaf_{i}"] for i in range(len(d.files))]


def _ply_rows(path) -> np.ndarray:
    v = ply_io.read_ply(str(path))["vertex"]
    return np.stack([v.column(n) for n, _ in v.properties], -1)


COMMON = ["--pair-capacity", "8192", "--device", "cpu", "--log-level",
          "off"]


def test_sharded_training_matches_one_process_and_jax(tmp_path, capsys):
    cap = _capture(tmp_path)
    argv = ["--dataset", cap, "--steps", "6"] + COMMON
    outputs = ["--checkpoint", str(tmp_path / "{rank}.npz"), "--export-ply",
               str(tmp_path / "mp.ply")]
    got = run_processes(tmp_path, argv + ["--distributed"] + outputs)
    want = app_train.run(argv + [
        "--distributed", "2", "--checkpoint", str(tmp_path / "one.npz"),
        "--export-ply", str(tmp_path / "one.ply")])
    capsys.readouterr()
    assert japp_train.main(argv[:4] + ["--pair-capacity", "8192",
                                       "--log-level", "off",
                                       "--distributed"]) == 0
    jax_line = _printed(capsys)
    for g in got:
        assert g["processes"] == g["shards"] == 2
        assert g["num_gaussians"] == want["num_gaussians"]
        np.testing.assert_allclose(g["losses"], want["losses"],
                                   rtol=STEP_RTOL)
        assert g["final_overflow"] == 0
        assert abs(g["psnr"] - want["psnr"]) <= 1e-4
        _close(g, jax_line)
    # Every process gathered the state; only the primary wrote it.
    assert not os.path.exists(tmp_path / "1.npz")
    for a, b in zip(_leaves(tmp_path / "0.npz"), _leaves(tmp_path /
                                                         "one.npz")):
        np.testing.assert_array_equal(a, b)
    mp, one = _ply_rows(tmp_path / "mp.ply"), _ply_rows(tmp_path / "one.ply")
    assert mp.shape == one.shape
    np.testing.assert_allclose(mp, one, atol=1e-6, rtol=0)


@pytest.mark.parametrize("slots", [["--capacity", "400"],
                                   ["--capacity", "100", "--auto-grow"]],
                         ids=["births", "auto-grow"])
def test_sharded_densify_matches_one_process(tmp_path, slots):
    """Births at both events: the slot buffer all-gathered, the event run
    on every process with the same key, each process keeping its rows;
    with --auto-grow each process pads its own slice of the full buffer
    (twice here), as the one-process mesh pads each shard's."""
    cap = _capture(tmp_path)
    argv = ["--dataset", cap, "--steps", "8", "--densify",
            "--densify-from", "4", "--densify-every", "4",
            "--densify-grad-threshold", "1e-7"] + slots + COMMON
    got = run_processes(tmp_path, argv + [
        "--distributed", "--checkpoint", str(tmp_path / "mp.npz"),
        "--export-ply", str(tmp_path / "mp.ply")])
    want = app_train.run(argv + [
        "--distributed", "2", "--checkpoint", str(tmp_path / "one.npz"),
        "--export-ply", str(tmp_path / "one.ply")])
    alive = [e["alive"] for e in want["events"]]
    assert [e["step"] for e in want["events"]] == [4, 8]
    # The capture's 60 SfM points grow at both events.
    assert 60 < alive[0] < alive[1]
    assert want["num_gaussians"] == 400
    for g in got:
        assert [(e["step"], e["alive"], e["slots"], e["overflow"],
                 e["exchange_overflow"]) for e in g["events"]] == [
            (e["step"], e["alive"], e["slots"], e["overflow"],
             e["exchange_overflow"]) for e in want["events"]]
        np.testing.assert_allclose(g["losses"], want["losses"],
                                   rtol=STEP_RTOL)
        assert g["final_alive"] == want["final_alive"]
    for a, b in zip(_leaves(tmp_path / "mp.npz"), _leaves(tmp_path /
                                                          "one.npz")):
        np.testing.assert_array_equal(a, b)
    mp, one = _ply_rows(tmp_path / "mp.ply"), _ply_rows(tmp_path / "one.ply")
    assert mp.shape == one.shape == (want["final_alive"], mp.shape[1])
    np.testing.assert_allclose(mp, one, atol=1e-6, rtol=0)


def test_replicated_run_trains_as_one_process(tmp_path):
    """Without --distributed each process trains the whole model on the
    single-device path; only the primary writes its files."""
    cap = _capture(tmp_path)
    argv = ["--dataset", cap, "--steps", "6"] + COMMON
    got = run_processes(tmp_path, argv + [
        "--checkpoint", str(tmp_path / "{rank}.npz"), "--export-ply",
        str(tmp_path / "{rank}.ply")])
    want = app_train.run(argv + ["--checkpoint", str(tmp_path / "one.npz")])
    for g in got:
        assert g["processes"] == 2 and g["shards"] == 1
        assert g["losses"] == want["losses"] and g["psnr"] == want["psnr"]
    assert os.path.exists(tmp_path / "0.npz")
    assert os.path.exists(tmp_path / "0.ply")
    assert not os.path.exists(tmp_path / "1.npz")
    assert not os.path.exists(tmp_path / "1.ply")
    for a, b in zip(_leaves(tmp_path / "0.npz"), _leaves(tmp_path /
                                                         "one.npz")):
        np.testing.assert_array_equal(a, b)

