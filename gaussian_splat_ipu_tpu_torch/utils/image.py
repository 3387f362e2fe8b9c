"""PNG encode/decode with the standard library alone, and JPEG through PIL
where PIL is installed: the port's own copy of the reference's codecs
(gaussian_splat_ipu_tpu/utils/image.py), the same bytes out, and it reads
what either package writes."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from gaussian_splat_ipu_tpu_torch.io import native


def to_uint8(image: np.ndarray, exposure: float = 1.0,
             gamma: float = 1.0) -> np.ndarray:
    """f32 [0,1]-ish image -> u8, with optional exposure and gamma; through
    the native library when it is built (io/native.py)."""
    fast = native.to_uint8(np.asarray(image, np.float32), exposure, gamma)
    if fast is not None:
        return fast
    img = np.asarray(image, np.float32) * exposure
    if gamma != 1.0:
        img = np.power(np.clip(img, 0.0, None), 1.0 / gamma)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    out = struct.pack(">I", len(payload)) + tag + payload
    return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)


def encode_png(image: np.ndarray) -> bytes:
    """u8 (H, W), (H, W, 3) or (H, W, 4) -> PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", ihdr),
        _chunk(b"IDAT", zlib.compress(raw, 6)),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def encode_jpeg(image: np.ndarray, quality: int = 85):
    """u8 (H, W[, C]) -> JPEG bytes via PIL, or None when PIL is absent
    (the preview stream then codes its key frames as PNG). Alpha is
    dropped."""
    try:
        from PIL import Image
    except ImportError:
        return None
    import io

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> u8 array. Supports 8-bit, non-interlaced images with
    filter types 0-4."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", payload[:10])
            if depth != 8:
                raise ValueError(f"{depth}-bit PNG: only 8-bit is supported")
            c = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1)
        line = line.astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):  # sub / average / paeth: sequential
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = int(prev[x])
                if ftype == 1:
                    cur[x] = (line[x] + a) & 0xFF
                elif ftype == 3:
                    cur[x] = (line[x] + (a + b) // 2) & 0xFF
                else:
                    cc = int(prev[x - c]) if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else cc)
                    cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = out[y]
    return out.reshape(h, w, c) if c > 1 else out.reshape(h, w)
