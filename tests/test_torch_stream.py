"""The port's preview stream (ui/stream.py), JPEG encoder and AsyncTask
against the JAX package's: over seeded frame sequences the port's
VideoEncoder emits the JAX encoder's packets byte for byte (tolerance 0),
and each package's decoder decodes the other's stream to the same
frames."""

import threading

import numpy as np
import pytest

from gaussian_splat_ipu_tpu.ui import stream as jstream
from gaussian_splat_ipu_tpu.utils import image as jimage
from gaussian_splat_ipu_tpu_torch.ui import stream
from gaussian_splat_ipu_tpu_torch.ui.async_task import AsyncTask
from gaussian_splat_ipu_tpu_torch.utils import image


def frames(n, h=48, w=64, seed=0, rgba_f32=False):
    """Smooth render-like content (gradient + a moving blob + a little
    noise), so that both codings compete; f32 RGBA on request."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        img = np.stack([xx / w, yy / h, 0.3 + 0 * xx], -1)
        blob = np.exp(-(((xx - 8 - 4 * i) ** 2 + (yy - 20) ** 2) / 40.0))
        img = np.clip(img + blob[..., None]
                      + rng.normal(0, 0.01, img.shape), 0, 1)
        if rgba_f32:
            alpha = np.ones((h, w, 1))
            out.append(np.concatenate([img, alpha], -1).astype(np.float32))
        else:
            out.append((img * 255).astype(np.uint8))
    return out


# (keyframe_interval, deadzone, frames, seed, f32 RGBA input, frame
# indices before which the encoders are forced to a key frame)
CASES = [(60, 2, 10, 0, False, ()), (4, 2, 11, 1, False, ()),
         (1000, 0, 8, 2, False, ()), (1000, 2, 9, 3, False, (3, 7)),
         (5, 0, 9, 4, True, (6,))]


@pytest.mark.parametrize("interval,deadzone,n,seed,rgba,forced", CASES)
def test_packets_byte_identical_and_cross_decodable(interval, deadzone, n,
                                                    seed, rgba, forced):
    seq = frames(n, seed=seed, rgba_f32=rgba)
    ours = stream.VideoEncoder(keyframe_interval=interval,
                               deadzone=deadzone)
    ref = jstream.VideoEncoder(keyframe_interval=interval,
                               deadzone=deadzone)
    pkts, ref_pkts = [], []
    for i, f in enumerate(seq):
        if i in forced:
            ours.force_keyframe()
            ref.force_keyframe()
        pkts.append(ours.encode(f))
        ref_pkts.append(ref.encode(f))
    assert pkts == ref_pkts
    kinds = {p[4] for p in pkts}
    assert kinds == {stream.FRAME_I, stream.FRAME_P}
    assert pkts[0][4] == stream.FRAME_I and stream.is_video_packet(pkts[0])
    dec, jdec = stream.VideoDecoder(), jstream.VideoDecoder()
    for p in pkts:
        a, b = dec.decode(p), jdec.decode(p)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (48, 64, 3)


def test_decoders_decode_each_others_streams_and_wait_for_a_key():
    seq = frames(6, seed=5)
    jkey = jstream.VideoEncoder(keyframe_interval=1000).encode(seq[0])
    enc = stream.VideoEncoder(keyframe_interval=1000)
    ours = [enc.encode(f) for f in seq]
    jdec, dec = jstream.VideoDecoder(), stream.VideoDecoder()
    for p in ours:
        np.testing.assert_array_equal(jdec.decode(p), dec.decode(p))
    assert dec.last_seq == jdec.last_seq == 5
    # A late join at a P-frame waits for the next key frame.
    assert ours[1][4] == stream.FRAME_P
    assert stream.VideoDecoder().decode(ours[1]) is None
    np.testing.assert_array_equal(stream.VideoDecoder().decode(jkey),
                                  jstream.VideoDecoder().decode(jkey))
    with pytest.raises(ValueError, match="GSV1"):
        dec.decode(b"NOPE" + ours[0][4:])


def test_jpeg_bytes_equal_the_reference():
    rng = np.random.default_rng(6)
    for shape in ((16, 24, 3), (16, 24, 4), (9, 7)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        assert image.encode_jpeg(img, 70) == jimage.encode_jpeg(img, 70)
    f = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    assert image.encode_jpeg(f) == jimage.encode_jpeg(f)


def test_async_task_joins_and_rethrows():
    hits = []
    task = AsyncTask()
    task.run(lambda: hits.append(1))
    task.wait_for_completion()
    assert hits == [1]

    def boom():
        raise ValueError("boom")

    task.run(boom)
    with pytest.raises(ValueError, match="boom"):
        task.wait_for_completion()
    task.wait_for_completion()          # the error is raised once
    gate = threading.Event()
    task.run(lambda: gate.wait(10.0))
    with pytest.raises(RuntimeError, match="already running"):
        task.run(lambda: None)
    gate.set()
    task.wait_for_completion()
    assert hits == [1]
