"""The port's app with --ui-port on the CPU (64x64): a remote session
(ready, camera control, preview frames and histograms, the points
toggle and back, detach and reconnect on a key frame, stop, rc 0) and the
viewer CLI against it. The app runs on a thread; every socket has a
timeout, every wait a wall-clock deadline of at most 30 s, and a session
that fails is stopped in teardown, so a hang fails instead of running on."""

import json
import socket
import threading
import time

import numpy as np
import pytest

from gaussian_splat_ipu_tpu_torch.app import main as app
from gaussian_splat_ipu_tpu_torch.ui import viewer
from gaussian_splat_ipu_tpu_torch.ui.server import InterfaceClient
from gaussian_splat_ipu_tpu_torch.utils.image import decode_png

DEADLINE_S = 30.0
# Dim grey splats (the .xyz default colour) against white 1-px points.
SPLAT_MAX, POINTS_MIN = 64, 128


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def connect(port: int) -> InterfaceClient:
    deadline = time.monotonic() + DEADLINE_S
    while True:
        try:
            return InterfaceClient("127.0.0.1", port, timeout=2.0)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def next_packet(cli, accept):
    """The first (type, payload) that `accept` takes, within the
    deadline."""
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        try:
            ptype, payload = cli.recv()
        except socket.timeout:
            continue
        if accept(ptype, payload):
            return ptype, payload
    raise AssertionError("timed out waiting for a packet")


def frame_where(cli, pred):
    """The next decoded preview frame for which pred holds."""
    found = {}

    def accept(ptype, payload):
        if ptype != "render_preview":
            return False
        frame = cli.decode_preview(payload)
        if frame is not None and pred(frame):
            found["frame"] = frame
            return True
        return False

    next_packet(cli, accept)
    return found["frame"]


@pytest.fixture
def served_app(tmp_path):
    """Start the app on a thread with a UI port; yields (port, result
    dict, thread, output PNG path); stops a session the test left
    running."""
    xyz = tmp_path / "pts.xyz"
    np.savetxt(xyz, np.random.default_rng(0).uniform(-1, 1, (64, 3)),
               fmt="%.5f")
    out = tmp_path / "final.png"
    port = free_port()
    result = {}

    def run_app():
        try:
            result["rc"] = app.main([
                "--input", str(xyz), "--device", "cpu", "--width", "64",
                "--height", "64", "--ui-port", str(port), "--output",
                str(out), "--pair-capacity", str(1 << 12),
                "--log-level", "off"])
        except BaseException as e:     # reported by the test
            result["error"] = e

    thread = threading.Thread(target=run_app, daemon=True)
    thread.start()
    try:
        yield port, result, thread, out
    finally:
        if thread.is_alive():
            try:
                cli = InterfaceClient("127.0.0.1", port, timeout=2.0)
                cli.send("stop")
                cli.close()
            except OSError:
                pass
            thread.join(timeout=DEADLINE_S)


def finished(result, thread) -> int:
    thread.join(timeout=DEADLINE_S)
    assert not thread.is_alive(), "the app did not stop"
    assert "error" not in result, result.get("error")
    return result["rc"]


def test_remote_session(served_app):
    port, result, thread, out = served_app
    cli = connect(port)
    assert next_packet(cli, lambda t, _: t == "ready")[1] == b"{}"
    cli.send("lambda2", 90.0)
    cli.send("fov", 0.6)
    frame = frame_where(cli, lambda f: True)
    assert frame.shape == (64, 64, 3)
    _, payload = next_packet(cli, lambda t, _: t == "tile_histogram")
    hist = json.loads(payload.decode())
    assert len(hist["counts"]) == 4
    assert (hist["overflow"], hist["truncated"],
            hist["exchange_overflow"]) == (0, 0, 0)

    # The device toggle: "cpu" selects the 1-px points, anything else the
    # splat pipeline.
    cli.send("device", "cpu")
    frame_where(cli, lambda f: f.max() >= POINTS_MIN)
    cli.send("device", "cuda")
    frame_where(cli, lambda f: f.max() <= SPLAT_MAX)

    # Detach: this viewer is dropped and the app renders on.
    cli.send("detach")
    cli.sock.settimeout(0.2)

    def dropped(*_):
        return False

    with pytest.raises((ConnectionError, OSError)):
        next_packet(cli, dropped)
    cli.close()
    assert thread.is_alive()

    # Reconnect: the stream restarts on a key frame, control still works.
    cli = connect(port)
    next_packet(cli, lambda t, _: t == "ready")
    _, key = next_packet(cli, lambda t, _: t == "render_preview")
    assert key[4] == 0 and cli.decode_preview(key).shape == (64, 64, 3)
    cli.send("stop")
    assert finished(result, thread) == 0
    cli.close()
    assert decode_png(out.read_bytes()).shape == (64, 64, 4)


def test_viewer_cli_against_the_app(served_app, tmp_path, capsys):
    port, result, thread, _ = served_app
    view = tmp_path / "view"
    deadline = time.monotonic() + DEADLINE_S
    while True:
        try:
            assert viewer.main(["--port", str(port), "--seconds", "2",
                                "--spin", "45", "--fov", "0.6", "--out",
                                str(view), "--stop"]) == 0
            break
        except ConnectionRefusedError:
            assert time.monotonic() < deadline, "the app never listened"
            time.sleep(0.1)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] > 0 and summary["saved"] == summary["frames"]
    assert summary["histogram"]
    assert decode_png((view / "view_00000.png").read_bytes()).shape == (
        64, 64, 3)
    hist = json.loads((view / "histogram.json").read_text())
    assert hist["overflow"] == 0 and len(hist["counts"]) == 4
    assert finished(result, thread) == 0
