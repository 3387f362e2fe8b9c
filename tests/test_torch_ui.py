"""The remote UI protocol across packages: the port's InterfaceServer
driven by the JAX package's InterfaceClient, the JAX server by the port's
client, and the port by itself, over real sockets on ephemeral ports —
`ready` on connect, consume semantics, a histogram, the video stream and
the raw HDR transfer, and `detach` dropping only the client that sent
it. Every wait has a deadline of at most 10 s and every socket a
timeout, so a hang fails the test instead of stalling the suite."""

import json
import socket
import time

import numpy as np
import pytest

from gaussian_splat_ipu_tpu.ui import server as jserver
from gaussian_splat_ipu_tpu_torch.ui import server

DEADLINE_S = 10.0
PAIRS = {"port-server,jax-client": (server, jserver),
         "jax-server,port-client": (jserver, server),
         "port-server,port-client": (server, server)}


def wait_for(pred, what: str):
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def recv_type(cli, ptype: str):
    """The payload of the next `ptype` packet, skipping others."""
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        try:
            got, payload = cli.recv()
        except socket.timeout:
            continue
        if got == ptype:
            return payload
    raise AssertionError(f"no {ptype} packet")


def connect(client_mod, port):
    cli = client_mod.InterfaceClient("127.0.0.1", port, timeout=2.0)
    assert recv_type(cli, "ready") == b"{}"
    return cli


def dropped(cli) -> bool:
    """True once the server has closed this client's connection."""
    try:
        cli.recv()
    except socket.timeout:
        return False
    except (ConnectionError, OSError):
        return True
    return False


@pytest.fixture(params=list(PAIRS))
def session(request):
    server_mod, client_mod = PAIRS[request.param]
    srv = server_mod.InterfaceServer(0)
    srv.start()
    port = srv._server.getsockname()[1]
    try:
        yield srv, client_mod, port
    finally:
        srv.stop()


def test_ready_consume_histogram_and_stream(session):
    srv, client_mod, port = session
    cli = connect(client_mod, port)
    try:
        assert not srv.state_changed()
        for ptype, value in (("fov", 0.5), ("lambda2", 30.0), ("X", 0.25),
                             ("env_rotation_y", 0.1), ("exposure", 1.5),
                             ("device", "points"), ("bogus", 1),
                             ("lambda1", -12.0)):
            cli.send(ptype, value)
        snap = wait_for(lambda: srv.state_changed()
                        and srv.consume_state(), "the control packets")
        if snap.rot_x_deg != -12.0:     # consumed before the last packet
            snap = wait_for(lambda: srv.state_changed()
                            and srv.consume_state(), "lambda1")
        assert (snap.fov, snap.rot_y_deg, snap.x, snap.env_rotation_y,
                snap.exposure, snap.device, snap.rot_x_deg) == (
            0.5, 30.0, 0.25, 0.1, 1.5, "points", -12.0)
        assert not snap.stop and not snap.detach
        assert not srv.state_changed()
        again = srv.consume_state()
        assert again.consumed and again.fov == 0.5

        counts = np.arange(12, dtype=np.int32)
        srv.send_histogram(counts, overflow=3, truncated=1)
        hist = json.loads(recv_type(cli, "tile_histogram").decode())
        assert hist == {"counts": counts.tolist(), "overflow": 3,
                        "truncated": 1, "exchange_overflow": 0}

        rng = np.random.default_rng(0)
        img = rng.uniform(0, 1, (24, 40, 4)).astype(np.float32)
        for _ in range(3):
            srv.send_video_frame(img)
            frame = cli.decode_preview(recv_type(cli, "render_preview"))
            assert frame.shape == (24, 40, 3)
        srv.send_hdr_image(img, chunk_bytes=1000)
        meta = recv_type(cli, "hdr_header")
        assert cli.feed_hdr("hdr_header", meta) is None
        out = None
        while out is None:
            out = cli.feed_hdr("hdr_chunk", recv_type(cli, "hdr_chunk"))
        np.testing.assert_array_equal(out, img)

        cli.send("stop")
        assert wait_for(lambda: srv.state_changed()
                        and srv.consume_state(), "stop").stop
    finally:
        cli.close()


def test_detach_drops_only_its_requester(session):
    srv, client_mod, port = session
    a = connect(client_mod, port)
    a.sock.settimeout(0.2)
    a.send("detach")
    snap = wait_for(lambda: srv.state_changed() and srv.consume_state(),
                    "detach")
    assert snap.detach
    assert not srv.consume_state().detach    # an event, consumed once
    srv.drop_client()
    wait_for(lambda: dropped(a), "the requester to be dropped")
    a.close()

    # The requester hangs up on its own and a new viewer connects before
    # the render loop acts on the detach: the newcomer stays.
    b = connect(client_mod, port)
    b.send("detach")
    wait_for(lambda: srv.state_changed() and srv.consume_state(), "detach")
    b.close()
    wait_for(lambda: not srv.connected(), "the server to see b hang up")
    c = connect(client_mod, port)
    try:
        srv.drop_client()
        assert srv.connected()
        srv.send_histogram([1, 2], overflow=0, truncated=0)
        hist = json.loads(recv_type(c, "tile_histogram").decode())
        assert hist["counts"] == [1, 2]
        # A reconnecting viewer's stream starts on a key frame.
        img = np.zeros((8, 8, 3), np.uint8)
        srv.send_video_frame(img)
        assert recv_type(c, "render_preview")[4] == 0
    finally:
        c.close()


def test_a_read_timeout_mid_packet_keeps_the_framing():
    """A read that times out inside a packet keeps what arrived: the next
    read returns that packet whole, then the one after it (reading on from
    inside a payload would take its bytes for a header)."""
    import struct
    a, b = socket.socketpair()
    try:
        b.settimeout(0.2)
        reader = server._PacketReader(b)
        big = bytes(range(256)) * 400
        pkt = struct.pack(">II", len(big), 14) + b"render_preview" + big
        a.sendall(pkt[:5000])
        with pytest.raises(socket.timeout):
            reader.packet()
        a.sendall(pkt[5000:] + struct.pack(">II", 2, 5) + b"ready{}")
        assert reader.packet() == ("render_preview", big)
        assert reader.packet() == ("ready", b"{}")
    finally:
        a.close()
        b.close()


def test_concurrent_sends_do_not_interleave():
    """Two threads pushing packets through one server connection (the
    receive thread's `ready` and the render loop's frames): every packet
    reaches the client whole."""
    import threading
    a, b = socket.socketpair()
    srv = server.InterfaceServer(0)
    srv._client = a
    b.settimeout(DEADLINE_S)
    reader = server._PacketReader(b)
    payloads = {name: bytes([k]) * (1 << 18)
                for k, name in enumerate(("one", "two"))}
    count = 16

    def push(name):
        for _ in range(count):
            srv._send(name, payloads[name])

    threads = [threading.Thread(target=push, args=(n,), daemon=True)
               for n in payloads]
    try:
        for t in threads:
            t.start()
        got = [reader.packet() for _ in range(2 * count)]
        for t in threads:
            t.join(timeout=DEADLINE_S)
        assert not any(t.is_alive() for t in threads)
        assert all(payloads[name] == payload for name, payload in got)
        assert sorted(name for name, _ in got) == ["one"] * count + \
            ["two"] * count
    finally:
        a.close()
        b.close()
