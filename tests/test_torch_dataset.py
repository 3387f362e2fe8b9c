"""The port's transforms.json loader (gaussian_splat_ipu_tpu_torch.io.
dataset) against the JAX package's on the same files: blender and
nerfstudio intrinsics, RGB, RGBA, gray and gray + alpha PNGs, downscale 1
and 2 (odd sizes, so the resize floors). Cameras' view and projection
within 1e-6 of JAX's; images equal at downscale 1 and within 1/255 at 2
(the JAX loader may decode and resize natively)."""

import os

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.io import dataset as jdataset
from gaussian_splat_ipu_tpu_torch.io import dataset

from _torch_posed import orbit_w2c, write_transforms

W, H = 21, 15
CHANNELS = {"rgb": 3, "rgba": 4, "gray": 1, "gray_alpha": 2}


def _images(n, channels, seed=0):
    rng = np.random.default_rng(seed)
    c = CHANNELS[channels]
    return [rng.integers(0, 256, (H, W, c), dtype=np.uint8)
            for _ in range(n)]


def _same(got, want, downscale):
    assert len(got) == len(want)
    assert (got.width, got.height) == (want.width, want.height)
    for a, b in zip(got.cameras, want.cameras):
        assert np.isfinite(a.view.numpy()).all()
        for name in ("view", "proj", "env_rot"):
            np.testing.assert_allclose(getattr(a, name).numpy(),
                                       np.asarray(getattr(b, name)),
                                       atol=1e-6, rtol=0, err_msg=name)
    for a, b in zip(got.images, want.images):
        assert a.dtype == np.float32 and a.shape == b.shape
        if downscale == 1:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1.0 / 255.0 + 1e-7)


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("channels", list(CHANNELS))
@pytest.mark.parametrize("kind", ["blender", "nerfstudio"])
def test_transforms_match_jax(tmp_path, kind, channels, downscale):
    root = write_transforms(str(tmp_path), _images(3, channels),
                            orbit_w2c(3, radius=2.5), kind=kind)
    got = dataset.load_transforms(root, downscale=downscale, device="cpu")
    want = jdataset.load_transforms(root, downscale=downscale)
    _same(got, want, downscale)
    c = got.images[0].shape[-1]
    assert c == (4 if channels in ("rgba", "gray_alpha") else 3)
    assert got.width == W // downscale and got.height == H // downscale


def test_per_frame_intrinsics_train_json_and_max_frames(tmp_path):
    """nerfstudio per-frame fl_x/fl_y/cx/cy, found through
    transforms_train.json when there is no transforms.json, and
    max_frames."""
    intr = [(17.0 + i, 18.5 - i, 10.0 + 0.5 * i, 7.0) for i in range(4)]
    root = write_transforms(str(tmp_path), _images(4, "rgb", seed=1),
                            orbit_w2c(4), kind="nerfstudio",
                            intrinsics=intr, name="transforms_train.json")
    for max_frames in (None, 2):
        got = dataset.load_transforms(root, downscale=2,
                                      max_frames=max_frames, device="cpu")
        want = jdataset.load_transforms(root, downscale=2,
                                        max_frames=max_frames)
        assert len(got) == (4 if max_frames is None else 2)
        _same(got, want, 2)
    # The focal lengths follow the actual resize ratio (21 -> 10 pixels).
    fx = float(got.cameras[1].proj[0, 0]) * got.width / 2.0
    np.testing.assert_allclose(fx, 18.0 * 10 / 21, rtol=1e-6)


def test_the_json_file_itself_and_errors(tmp_path):
    root = write_transforms(str(tmp_path / "a"), _images(2, "rgb"),
                            orbit_w2c(2), kind="blender")
    path = os.path.join(root, "transforms.json")
    _same(dataset.load_transforms(path, device="cpu"),
          jdataset.load_transforms(path), 1)
    with pytest.raises(FileNotFoundError, match="transforms"):
        dataset.load_transforms(str(tmp_path), device="cpu")
    empty = tmp_path / "b"
    empty.mkdir()
    (empty / "transforms.json").write_text('{"frames": []}')
    with pytest.raises(ValueError, match="no frames"):
        dataset.load_transforms(str(empty), device="cpu")


def test_expand_channels_matches_jax():
    rng = np.random.default_rng(3)
    for c in (1, 2, 3, 4):
        arr = rng.uniform(size=(4, 5, c)).astype(np.float32)
        np.testing.assert_array_equal(dataset._expand_channels(arr),
                                      jdataset._expand_channels(arr))


def test_cameras_live_on_the_given_device(tmp_path):
    root = write_transforms(str(tmp_path), _images(1, "rgb"), orbit_w2c(1))
    fs = dataset.load_transforms(root, device=torch.device("meta"))
    assert fs.cameras[0].view.device.type == "meta"
    assert isinstance(fs.images[0], np.ndarray)
