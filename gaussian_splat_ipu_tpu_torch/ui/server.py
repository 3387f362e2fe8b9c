"""Remote UI server: TCP packet protocol for interactive viewing (the port's
own copy of gaussian_splat_ipu_tpu/ui/server.py, on the same wire
protocol byte for byte: a viewer of either package drives a server of
either package).

Each packet is

    [4-byte big-endian payload length][4-byte big-endian type length]
    [type name utf-8][payload bytes]

with JSON payloads ({"value": v}) for control packets and the GSV1 video
stream (ui/stream.py) or compressed stills for frames. The vocabulary is
the reference's (InterfaceServer.hpp:24-43): stop, detach, env_rotation_x
/ env_rotation_y, exposure, gamma, X, Y, Z (translation), lambda1 /
lambda2 (rot x / y), fov, device from the viewer; ready, render_preview,
tile_histogram, hdr_header / hdr_chunk to it. A `device` of "cpu" or
"points" selects the app's points program, any other value its splat
program.

State is consumed like the reference's (InterfaceServer.hpp:230-251):
consume_state() marks it read, so the render loop tells fresh input from
stale; detach is an event, cleared by the consume that reports it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import socket
import struct
import threading
from typing import Optional

import numpy as np

from gaussian_splat_ipu_tpu_torch.ui import stream as stream_lib
from gaussian_splat_ipu_tpu_torch.utils import image as image_util

log = logging.getLogger("gsplat")


@dataclasses.dataclass
class UiState:
    """Consumable UI state (InterfaceServer.hpp:230-244 parity)."""

    fov: float = np.radians(40.0)
    rot_x_deg: float = 0.0       # reference lambda1
    rot_y_deg: float = 0.0       # reference lambda2
    env_rotation_x: float = 0.0
    env_rotation_y: float = 0.0
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    exposure: float = 1.0
    gamma: float = 1.0
    device: str = "cuda"
    stop: bool = False
    detach: bool = False
    consumed: bool = True


def _send_packet(sock: socket.socket, ptype: str, payload: bytes) -> None:
    name = ptype.encode()
    sock.sendall(struct.pack(">II", len(payload), len(name)) + name
                 + payload)


class _PacketReader:
    """Length-prefixed packets from a socket whose reads time out. The
    bytes that arrived before a timeout stay buffered and the next call
    resumes the same packet, so a timeout in the middle of a packet never
    loses the stream's framing (reading on from inside a payload would
    take its bytes for a header and wait for a length of garbage)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = bytearray()

    def _fill(self, n: int) -> None:
        while len(self._buf) < n:
            chunk = self.sock.recv(max(n - len(self._buf), 1 << 16))
            if not chunk:
                raise ConnectionError("peer closed")
            self._buf += chunk

    def packet(self):
        """(type, payload) of the next packet; socket.timeout leaves what
        has arrived for the next call."""
        self._fill(8)
        plen, nlen = struct.unpack(">II", self._buf[:8])
        end = 8 + nlen + plen
        self._fill(end)
        ptype = self._buf[8:8 + nlen].decode()
        payload = bytes(self._buf[8 + nlen:end])
        del self._buf[:end]
        return ptype, payload


class InterfaceServer:
    """TCP UI server for one viewer at a time. start() spawns the accept /
    receive thread; the render loop polls state_changed() /
    consume_state() and pushes frames with send_video_frame() /
    send_histogram()."""

    def __init__(self, port: int):
        self.port = port
        self._state = UiState()
        self._lock = threading.Lock()
        # One packet on the wire at a time: the receive thread's `ready`
        # and the render loop's frames must not interleave.
        self._send_lock = threading.Lock()
        self._client: Optional[socket.socket] = None
        self._server: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._encoder = stream_lib.VideoEncoder()
        self._encoder_client = None
        self._detach_requester: Optional[socket.socket] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", self.port))
        self._server.listen(1)
        self._server.settimeout(0.5)
        self._thread = threading.Thread(target=self._communicate,
                                        daemon=True)
        self._thread.start()
        log.info("UI server listening on :%d", self.port)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        for s in (self._client, self._server):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def connected(self) -> bool:
        return self._client is not None

    def drop_client(self) -> None:
        """Close the connection of the client that sent `detach`, and keep
        serving (reference detach semantics, InterfaceServer.hpp:26-27): a
        viewer can reconnect, and the video stream restarts on a key frame
        for it. The render loop consumes the detach event later, so the
        requester may have hung up and another viewer connected by then:
        only the socket that sent the packet is closed."""
        requester, self._detach_requester = self._detach_requester, None
        if requester is None or requester is not self._client:
            return  # requester already disconnected on its own
        self._client = None
        try:
            requester.close()
        except OSError:
            pass
        log.info("UI client detached")

    # -- state (consume semantics, InterfaceServer.hpp:246-251) ------------
    def state_changed(self) -> bool:
        with self._lock:
            return not self._state.consumed

    def consume_state(self) -> UiState:
        with self._lock:
            snap = dataclasses.replace(self._state)
            self._state.consumed = True
            self._state.detach = False   # an event, not a level
        return snap

    # -- outgoing telemetry --------------------------------------------
    def send_ready(self) -> None:
        self._send("ready", b"{}")

    def send_preview_image(self, image, exposure: float = 1.0,
                           gamma: float = 1.0) -> None:
        """Push one independent still: JPEG when PIL is available, else
        PNG (clients tell them apart by the magic bytes)."""
        arr = image_util.to_uint8(np.asarray(image), exposure, gamma)
        payload = image_util.encode_jpeg(arr)
        if payload is None:
            payload = image_util.encode_png(arr)
        self._send("render_preview", payload)

    def send_video_frame(self, image, exposure: float = 1.0,
                         gamma: float = 1.0) -> None:
        """Push one frame of the continuous preview stream (ui/stream.py,
        the role of the reference's persistent FFmpeg encoder,
        InterfaceServer.hpp:100-108,322-328). A newly connected client
        always starts on a key frame."""
        client = self._client
        if client is None:
            return
        if self._encoder_client is not client:
            self._encoder.force_keyframe()
            self._encoder_client = client
        arr = image_util.to_uint8(np.asarray(image), exposure, gamma)
        self._send("render_preview", self._encoder.encode(arr))

    def send_hdr_image(self, image, chunk_bytes: int = 1 << 20) -> None:
        """Chunked raw float32 transfer (the reference's sendImage path,
        InterfaceServer.hpp:335-386): an `hdr_header` JSON packet with
        shape and chunk count, then `hdr_chunk` packets of raw f32
        bytes."""
        arr = np.ascontiguousarray(np.asarray(image, np.float32))
        raw = arr.tobytes()
        nchunks = max(-(-len(raw) // chunk_bytes), 1)
        self._send("hdr_header", json.dumps(
            {"shape": list(arr.shape), "dtype": "float32",
             "chunks": nchunks, "chunk_bytes": chunk_bytes}).encode())
        for i in range(nchunks):
            self._send("hdr_chunk",
                       raw[i * chunk_bytes:(i + 1) * chunk_bytes])

    def send_histogram(self, counts, overflow: int = 0,
                       truncated: int = 0,
                       exchange_overflow: int = 0) -> None:
        """Per-tile counts plus drop telemetry: `overflow` pairs lost to
        the pair table, `truncated` past the per-tile work bound,
        `exchange_overflow` at the all_to_all buckets of the distributed
        path (app/main.py --distributed; 0 on one device)."""
        payload = json.dumps(
            {"counts": np.asarray(counts).tolist(),
             "overflow": int(overflow),
             "truncated": int(truncated),
             "exchange_overflow": int(exchange_overflow)}).encode()
        self._send("tile_histogram", payload)

    def _send(self, ptype: str, payload: bytes) -> None:
        client = self._client
        if client is None:
            return
        try:
            with self._send_lock:
                _send_packet(client, ptype, payload)
        except OSError:
            # Part of the packet may be on the wire: the stream cannot go
            # on, so the connection closes (the receive loop then waits
            # for the next viewer).
            log.info("UI client disconnected (send)")
            if self._client is client:
                self._client = None
            try:
                client.shutdown(socket.SHUT_RDWR)
                client.close()
            except OSError:
                pass

    # -- receive loop --------------------------------------------------
    def _communicate(self) -> None:
        while not self._stop.is_set():
            try:
                client, addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            log.info("UI client connected from %s", addr)
            client.settimeout(0.5)
            reader = _PacketReader(client)
            self._client = client
            self.send_ready()
            while not self._stop.is_set():
                try:
                    ptype, payload = reader.packet()
                except socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    log.info("UI client disconnected")
                    self._client = None
                    break
                self._handle(ptype, payload)

    def _handle(self, ptype: str, payload: bytes) -> None:
        try:
            value = json.loads(payload.decode() or "{}")
        except json.JSONDecodeError:
            value = {}
        v = value.get("value")
        with self._lock:
            s = self._state
            if ptype == "stop":
                s.stop = True
            elif ptype == "detach":
                s.detach = True
                self._detach_requester = self._client
            elif ptype == "fov":
                s.fov = float(v)
            elif ptype == "lambda1":
                s.rot_x_deg = float(v)
            elif ptype == "lambda2":
                s.rot_y_deg = float(v)
            elif ptype == "env_rotation_x":
                s.env_rotation_x = float(v)
            elif ptype == "env_rotation_y":
                s.env_rotation_y = float(v)
            elif ptype in ("X", "x"):
                s.x = float(v)
            elif ptype in ("Y", "y"):
                s.y = float(v)
            elif ptype in ("Z", "z"):
                s.z = float(v)
            elif ptype == "exposure":
                s.exposure = float(v)
            elif ptype == "gamma":
                s.gamma = float(v)
            elif ptype == "device":
                s.device = str(v)
            else:
                log.debug("unknown packet type %r", ptype)
                return
            s.consumed = False


class InterfaceClient:
    """Minimal client (for tests, scripted control and the viewer CLI)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._reader = _PacketReader(self.sock)
        self._decoder = None
        self._hdr = None  # (meta, [chunks]) in-flight raw transfer

    def send(self, ptype: str, value=None) -> None:
        _send_packet(self.sock, ptype, json.dumps({"value": value}).encode())

    def recv(self):
        """(type, payload) of the next packet; on socket.timeout the bytes
        received so far are kept for the next call."""
        return self._reader.packet()

    def decode_preview(self, payload: bytes):
        """render_preview payload -> (H, W, C) u8 frame, or None for a
        P-frame before the stream's first key frame. Handles the GSV1
        stream and JPEG / PNG stills."""
        if stream_lib.is_video_packet(payload):
            if self._decoder is None:
                self._decoder = stream_lib.VideoDecoder()
            return self._decoder.decode(payload)
        if payload[:8] == b"\x89PNG\r\n\x1a\n":
            return image_util.decode_png(payload)
        import io

        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(payload)))

    def feed_hdr(self, ptype: str, payload: bytes):
        """Assemble the chunked raw transfer; the f32 array when its last
        chunk arrives, else None."""
        if ptype == "hdr_header":
            self._hdr = (json.loads(payload.decode()), [])
            return None
        if ptype == "hdr_chunk" and self._hdr is not None:
            meta, chunks = self._hdr
            chunks.append(payload)
            if len(chunks) == meta["chunks"]:
                self._hdr = None
                return np.frombuffer(b"".join(chunks),
                                     np.float32).reshape(meta["shape"])
        return None

    def close(self) -> None:
        self.sock.close()
