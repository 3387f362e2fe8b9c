"""The points program and the tile algebra: the port's render/points.py and
utils/tiling.py against the JAX package's on identical numpy inputs, bit
for bit (tolerance 0: adding 1.0 per point is exact in f32, both packages
round half to even, and the tile arithmetic is integer)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.models.camera import Camera as JCamera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.render import points as jpoints
from gaussian_splat_ipu_tpu.utils import tiling as jtiling
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render import points
from gaussian_splat_ipu_tpu_torch.utils import tiling
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests.test_torch_config import jax_config

torch.set_num_threads(1)


def scene(seed, n, extent=1.0):
    rng = np.random.default_rng(seed)
    params = dict(
        means=rng.uniform(-extent, extent, (n, 3)).astype(np.float32),
        log_scales=rng.uniform(-4.5, -2.5, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(-2, 4, n).astype(np.float32),
        sh=rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32))
    return (JModel(**{k: jnp.asarray(v) for k, v in params.items()}),
            GaussianModel.from_numpy(params, device="cpu"))


def cameras(width, height, **orbit):
    bb = np.ones(3, np.float32)
    jc = JCamera.orbit(-bb, bb, np.radians(40.0), width / height, **orbit)
    return jc, Camera.from_numpy(np.asarray(jc.view), np.asarray(jc.proj),
                                 device="cpu")


# (seed, gaussians, extent, width, height, tile, orbit): points behind
# the camera and off screen (extent 3), a ragged tile grid, a dense
# 1280x720 frame.
CASES = [
    (0, 3000, 1.0, 160, 96, 16, dict(rot_y_deg=30.0)),
    (1, 4000, 3.0, 200, 120, 32, dict(rot_x_deg=20.0, rot_y_deg=-75.0,
                                      translation=(0.2, 0.1, 1.5))),
    (2, 20000, 1.0, 1280, 720, 32, dict(rot_y_deg=135.0)),
]


@pytest.mark.parametrize("seed,n,extent,w,h,tile,orbit", CASES)
def test_points_and_histogram_bit_equal_to_jax(seed, n, extent, w, h, tile,
                                               orbit):
    cfg = RasterConfig(image_width=w, image_height=h, tile_width=tile,
                       tile_height=tile)
    jm, tm = scene(seed, n, extent)
    jc, tc = cameras(w, h, **orbit)
    want = jpoints.render_points(jm, jc, jax_config(cfg))
    got = points.render_points(tm, tc, cfg)
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    assert int(got.count) == int(want.count)
    hist = points.tile_histogram(tm, tc, cfg)
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(jpoints.tile_histogram(jm, jc,
                                                        jax_config(cfg))))
    assert hist.dtype == torch.int32 and hist.shape == (cfg.num_tiles,)
    assert int(hist.sum()) == int(got.count)
    assert 0 < int(got.count) <= n
    if extent > 1.0:
        assert int(got.count) < n    # some points culled


def test_points_colour_and_view_proj():
    cfg = RasterConfig(image_width=96, image_height=64)
    jm, tm = scene(3, 500)
    jc, tc = cameras(96, 64, rot_y_deg=10.0)
    np.testing.assert_array_equal(tc.view_proj.numpy(),
                                  np.asarray(jc.view_proj))
    colour = (0.25, 0.5, 1.0)
    want = jpoints.render_points(jm, jc, jax_config(cfg), color=colour)
    got = points.render_points(tm, tc, cfg, color=colour)
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    assert float(got.image[..., 2].max()) == 1.0


FB_CASES = [(64, 64, 32, 32), (96, 40, 16, 8), (160, 96, 32, 16)]


@pytest.mark.parametrize("w,h,tw,th", FB_CASES)
def test_tiled_framebuffer_matches_jax(w, h, tw, th):
    ref = jtiling.TiledFramebuffer(w, h, tw, th)
    fb = tiling.TiledFramebuffer(w, h, tw, th)
    assert (fb.tiles_x, fb.tiles_y, fb.num_tiles) == (
        ref.tiles_x, ref.tiles_y, ref.num_tiles)
    rng = np.random.default_rng(w + h)
    ys = rng.uniform(-10, h + 10, 500).astype(np.float32)
    xs = rng.uniform(-10, w + 10, 500).astype(np.float32)
    np.testing.assert_array_equal(fb.pix_coord_to_tile(ys, xs).numpy(),
                                  np.asarray(ref.pix_coord_to_tile(ys, xs)))
    tids = np.arange(-3, ref.num_tiles + 3, dtype=np.int32)
    for a, b in zip(fb.tile_bounds(tids), ref.tile_bounds(tids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(fb.tile_centroid(tids), ref.tile_centroid(tids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dirs = np.arange(5, dtype=np.int32)
    tt, dd = np.meshgrid(np.arange(ref.num_tiles, dtype=np.int32), dirs)
    np.testing.assert_array_equal(fb.nearby_tile(tt, dd).numpy(),
                                  np.asarray(ref.nearby_tile(tt, dd)))
    src = rng.uniform(-50, 200, (400, 2)).astype(np.float32)
    dst = rng.uniform(-50, 200, (400, 2)).astype(np.float32)
    dst[:50] = src[:50] + 0.2 * min(tw, th)   # same cell: NONE
    np.testing.assert_array_equal(fb.best_direction(src, dst).numpy(),
                                  np.asarray(ref.best_direction(src, dst)))
    for a, b in zip(fb.check_image_boundaries(tids[3:-3]),
                    ref.check_image_boundaries(tids[3:-3])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("w,h,tw,th", FB_CASES)
def test_tile_image_round_trip_matches_jax(w, h, tw, th):
    ref = jtiling.TiledFramebuffer(w, h, tw, th)
    fb = tiling.TiledFramebuffer(w, h, tw, th)
    img = np.random.default_rng(1).uniform(size=(h, w, 3)).astype(np.float32)
    tiles = tiling.tile_image(torch.from_numpy(img), fb)
    np.testing.assert_array_equal(tiles.numpy(),
                                  np.asarray(jtiling.tile_image(img, ref)))
    np.testing.assert_array_equal(tiling.untile_image(tiles, fb).numpy(), img)
    counts = np.arange(ref.num_tiles, dtype=np.int32)
    np.testing.assert_array_equal(
        tiling.tile_histogram(torch.from_numpy(counts), fb),
        jtiling.tile_histogram(counts, ref))


def test_framebuffer_from_config_matches_jax():
    cfg = RasterConfig(image_width=333, image_height=97, tile_width=16,
                       tile_height=8)
    ref = jtiling.TiledFramebuffer.from_config(jax_config(cfg))
    assert dataclasses.asdict(tiling.TiledFramebuffer.from_config(cfg)) == \
        dataclasses.asdict(ref)
