"""The port keeps its own copies of the reference's jax-free modules: its
RasterConfig has the reference's fields, defaults and derived properties,
and PNG and PLY files written by one package read back the same in the
other. `jax_config` is the helper the parity tests use to hand a port
config to the JAX package."""

import dataclasses

import numpy as np
import pytest

from gaussian_splat_ipu_tpu.io import ply as jply
from gaussian_splat_ipu_tpu.utils import image as jimage
from gaussian_splat_ipu_tpu.utils.config import RasterConfig as JConfig
from gaussian_splat_ipu_tpu_torch.io import ply
from gaussian_splat_ipu_tpu_torch.utils import image
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

DERIVED = ("tiles_x", "tiles_y", "num_tiles", "padded_width",
           "padded_height", "pixels_per_tile", "max_chunks_per_range")


def jax_config(cfg: RasterConfig) -> JConfig:
    """The reference's RasterConfig with the fields of the port's `cfg`."""
    return JConfig(**dataclasses.asdict(cfg))


def test_fields_order_and_defaults_match_the_reference():
    ours, ref = dataclasses.fields(RasterConfig), dataclasses.fields(JConfig)
    assert [f.name for f in ours] == [f.name for f in ref]
    assert dataclasses.asdict(RasterConfig()) == dataclasses.asdict(JConfig())
    assert RasterConfig.__dataclass_params__.frozen
    assert hash(RasterConfig()) == hash(RasterConfig())


@pytest.mark.parametrize("change", [
    dict(), dict(tile_group=2), dict(tile_group=3, exact_tile_test=True),
    dict(image_width=333, image_height=97, tile_width=16, tile_height=8),
    dict(image_width=1001, image_height=555, tile_group=3,
         max_chunks_per_tile=7, rowseg_buckets=3, rowseg_bounds=(0, 2, 9)),
])
def test_derived_properties_and_round_trip(change):
    cfg = RasterConfig(**change)
    ref = jax_config(cfg)
    for name in DERIVED:
        assert getattr(cfg, name) == getattr(ref, name), name
    assert RasterConfig(**dataclasses.asdict(ref)) == cfg


def test_png_bytes_equal_and_read_back_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((7, 5), (6, 9, 3), (4, 11, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        data = image.encode_png(img)
        assert data == jimage.encode_png(img)
        np.testing.assert_array_equal(jimage.decode_png(data), img)
        np.testing.assert_array_equal(image.decode_png(
            jimage.encode_png(img)), img)
    f = rng.uniform(-0.2, 1.2, (5, 6, 4)).astype(np.float32)
    np.testing.assert_array_equal(image.to_uint8(f, 1.3, 2.2),
                                  jimage.to_uint8(f, 1.3, 2.2))
    image.write_png(str(tmp_path / "a.png"), f)
    np.testing.assert_array_equal(
        jimage.decode_png((tmp_path / "a.png").read_bytes()),
        jimage.to_uint8(f))


def _columns(n, rest=9):
    rng = np.random.default_rng(1)
    names = (["x", "y", "z"] + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(rest)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    return {k: rng.normal(size=n).astype(np.float32) for k in names}


def _assert_fields_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_written_by_one_package_reads_the_same_in_the_other(
        tmp_path, writer):
    cols = _columns(50)
    path = str(tmp_path / "s.ply")
    (ply if writer == "port" else jply).write_ply(path, cols)
    other = str(tmp_path / "t.ply")
    (jply if writer == "port" else ply).write_ply(other, cols)
    assert open(path, "rb").read() == open(other, "rb").read()
    ours = ply.gaussian_fields_from_ply(ply.read_ply(path))
    _assert_fields_equal(ours, jply.gaussian_fields_from_ply(
        jply.read_ply(path)))
    _assert_fields_equal(ours, ply.load_points(path))
    assert ours["f_rest"].shape == (50, 3, 3)


def test_ascii_ply_with_faces_and_xyz_read_as_the_reference(tmp_path):
    body = ["ply", "format ascii 1.0", "comment made by hand",
            "element vertex 3", "property float x", "property float y",
            "property double z", "property uchar red",
            "element face 2", "property list uchar int vertex_indices",
            "end_header", "0 1 2 255", "3.5 -4 5e-1 7", "6 7 8 0",
            "3 0 1 2", "4 0 1 2 0"]
    path = tmp_path / "m.ply"
    path.write_text("\n".join(body) + "\n")
    ours, ref = ply.read_ply(str(path)), jply.read_ply(str(path))
    assert ours.fmt == ref.fmt == "ascii"
    for name in ("x", "y", "z", "red"):
        np.testing.assert_array_equal(ours["vertex"].column(name),
                                      ref["vertex"].column(name))
    assert [list(v) for v in ours["face"].lists["vertex_indices"]] == \
        [[0, 1, 2], [0, 1, 2, 0]]
    xyz = tmp_path / "p.xyz"
    xyz.write_text("0 1 2\n3 4 5 9\n")
    np.testing.assert_array_equal(ply.read_xyz(str(xyz)),
                                  jply.read_xyz(str(xyz)))
    with pytest.raises(ValueError, match="extension"):
        ply.load_points(str(tmp_path / "x.obj"))
