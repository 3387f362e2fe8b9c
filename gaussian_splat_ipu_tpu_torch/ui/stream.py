"""Continuous preview video stream: a long-lived stateful encoder (the
port's own copy of gaussian_splat_ipu_tpu/ui/stream.py; the packets are
byte for byte the reference's, and each package decodes the other's).

  - I-frames: JPEG (PIL) when available, else PNG;
  - P-frames: the zlib-compressed modular residual against the decoder's
    reference frame, with a dead zone;
  - per frame the encoder codes both and ships the smaller, except that
    the frame after a key frame is always predicted;
  - a key frame every `keyframe_interval` frames, and on demand
    (`force_keyframe`, e.g. for a newly connected client).

Both ends track the same reference frame (the encoder decodes its own
JPEG key frames), so the stream does not drift. Packet layout (after the
framing of ui/server.py):

    b"GSV1" | u8 frame_type (0=I,1=P) | u8 codec (0=png,1=jpeg,2=zlib)
    | u16 reserved | u32 seq | u32 h | u32 w | u32 c | payload
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from gaussian_splat_ipu_tpu_torch.utils import image as image_util

MAGIC = b"GSV1"
_HDR = struct.Struct(">4sBBHIIII")
FRAME_I, FRAME_P = 0, 1
CODEC_PNG, CODEC_JPEG, CODEC_ZLIB = 0, 1, 2


def _decode_intra(codec: int, payload: bytes) -> np.ndarray:
    if codec == CODEC_JPEG:
        import io

        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
    return image_util.decode_png(payload)


class VideoEncoder:
    """Stateful per-connection encoder. Not thread-safe; one per stream."""

    def __init__(self, keyframe_interval: int = 60, quality: int = 80,
                 deadzone: int = 2):
        """deadzone: residual magnitudes <= this are coded as zero. Each
        residual is taken against the encoder's own reconstruction, so
        every P-frame is within `deadzone` of the true frame; 0 = P-frames
        lossless against the last key frame's reconstruction."""
        self.keyframe_interval = keyframe_interval
        self.quality = quality
        self.deadzone = deadzone
        self.seq = 0
        self._ref: Optional[np.ndarray] = None  # decoder's current frame
        self._after_key = False  # force-P the frame after a keyframe

    def force_keyframe(self) -> None:
        """Next frame is intra-coded (new client / after packet loss)."""
        self._ref = None

    def encode(self, frame_u8: np.ndarray) -> bytes:
        img = np.asarray(frame_u8)
        if img.dtype != np.uint8:
            img = image_util.to_uint8(img)
        if img.ndim == 3 and img.shape[-1] == 4:
            img = img[..., :3]
        if img.ndim == 2:
            img = img[:, :, None]
        h, w, c = img.shape

        need_key = (self._ref is None
                    or self._ref.shape != img.shape
                    or self.seq % self.keyframe_interval == 0)

        chosen = None
        if not need_key:
            signed = ((img.astype(np.int16) - self._ref.astype(np.int16)
                       + 128) % 256) - 128
            if self.deadzone:
                signed = np.where(np.abs(signed) <= self.deadzone, 0,
                                  signed)
            resid = (signed % 256).astype(np.uint8)
            inter = zlib.compress(resid.tobytes(), 1)
            # The frame after a key frame carries the key frame's JPEG
            # error once, making the reference exact; other frames take
            # the smaller coding.
            take_p = self._after_key
            if not take_p:
                jpeg = (image_util.encode_jpeg(img, self.quality)
                        if c == 3 else None)
                intra = (jpeg if jpeg is not None
                         else image_util.encode_png(img))
                take_p = len(inter) < len(intra)
            if take_p:
                chosen = (FRAME_P, CODEC_ZLIB, inter)
                # Track our own reconstruction (ref + coded residual).
                self._ref = ((self._ref.astype(np.int16) + signed) % 256
                             ).astype(np.uint8)
                self._after_key = False
        if chosen is None:
            jpeg = image_util.encode_jpeg(img, self.quality) if c == 3 \
                else None
            if jpeg is not None:
                intra_codec, intra = CODEC_JPEG, jpeg
            else:
                intra_codec, intra = CODEC_PNG, image_util.encode_png(img)
            chosen = (FRAME_I, intra_codec, intra)
            # Track the DECODED intra frame: JPEG is lossy.
            self._ref = (_decode_intra(intra_codec, intra)
                         if intra_codec == CODEC_JPEG else img.copy())
            self._after_key = True

        ftype, codec, payload = chosen
        hdr = _HDR.pack(MAGIC, ftype, codec, 0, self.seq, h, w, c)
        self.seq += 1
        return hdr + payload


class VideoDecoder:
    """Mirror of VideoEncoder; feed packets in order, get frames out."""

    def __init__(self):
        self._ref: Optional[np.ndarray] = None
        self.last_seq: Optional[int] = None

    def decode(self, packet: bytes) -> Optional[np.ndarray]:
        """The decoded (H, W, C) u8 frame, or None for a P-frame that
        arrives before any key frame (a late join waits for the next)."""
        magic, ftype, codec, _, seq, h, w, c = _HDR.unpack(
            packet[:_HDR.size])
        if magic != MAGIC:
            raise ValueError("not a GSV1 packet")
        payload = packet[_HDR.size:]
        self.last_seq = seq
        if ftype == FRAME_I:
            img = _decode_intra(codec, payload)
            if img.ndim == 2:
                img = img[:, :, None]
            self._ref = img.reshape(h, w, -1)
        else:
            if self._ref is None:
                return None
            resid = np.frombuffer(zlib.decompress(payload),
                                  np.uint8).reshape(h, w, c)
            self._ref = ((self._ref.astype(np.int16)
                          + resid.astype(np.int16)) % 256).astype(np.uint8)
        return self._ref


def is_video_packet(payload: bytes) -> bool:
    return payload[:4] == MAGIC
