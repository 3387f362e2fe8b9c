"""The port's native host library (gaussian_splat_ipu_tpu_torch.io.native,
built from its own copy of the sources under csrc/host/) against its numpy
versions and against the JAX package's library built from the root csrc/,
in both of the library's states.

Both libraries are built into a temporary directory (never into the port's
_build/ or the root csrc/); each test sets both packages' state through
their module globals: the port's BUILD_DIR, _lib and _tried, the JAX
package's _LIB_PATH, _lib and _tried. Built, the prefetcher's decode equals
`decode_png_torch` and the JAX library's bit for bit at downscale 1-3, and
the port's loaders equal the JAX loaders with their library; not built,
they equal the JAX loaders without it (PIL). At downscale 2 the two states
differ, as the reference's do."""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from gaussian_splat_ipu_tpu.io import colmap as jcolmap
from gaussian_splat_ipu_tpu.io import dataset as jdataset
from gaussian_splat_ipu_tpu.io import native as jnative
from gaussian_splat_ipu_tpu_torch.io import colmap, dataset, native
from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
from gaussian_splat_ipu_tpu_torch.models.gaussians import center_and_flip
from gaussian_splat_ipu_tpu_torch.utils import image as image_util

from _torch_posed import orbit_w2c, write_colmap, write_transforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The root csrc/Makefile's command, which the JAX package's library needs.
JAX_BUILD = ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC",
             "-pthread", "-Wall", "-Wextra", "-shared"]
MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(the port's BUILD_DIR holding its library, the JAX package's
    library path), both built here."""
    root = tmp_path_factory.mktemp("native")
    port_dir = str(root / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", port_dir)
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_tried", False)
        native.build()
    jax_lib = str(root / "jax" / "libgsplat_native.so")
    os.makedirs(os.path.dirname(jax_lib))
    srcs = [os.path.join(REPO, "csrc", f)
            for f in ("gsplat_native.cpp", "dataloader.cpp")]
    subprocess.run(JAX_BUILD + ["-o", jax_lib, *srcs, "-lz"], check=True,
                   capture_output=True)
    return port_dir, jax_lib


@pytest.fixture
def with_libs(monkeypatch, built):
    """Both packages with their library, loaded through load_library."""
    port_dir, jax_lib = built
    monkeypatch.setattr(native, "BUILD_DIR", port_dir)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(jnative, "_LIB_PATH", jax_lib)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert native.available() and jnative.available()


@pytest.fixture
def without_libs(monkeypatch):
    """Both packages without their library."""
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert not native.available() and not jnative.available()


# -- the four functions -------------------------------------------------------


def test_stack_f32_columns(with_libs):
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("pad", "<u1"), ("z", "<f4"),
                   ("i", "<i4")])
    rng = np.random.default_rng(0)
    rec = np.zeros(10_000, dt)
    for name in ("x", "y", "z"):
        rec[name] = rng.normal(size=10_000).astype(np.float32)
    got = native.stack_f32_columns(rec, ["z", "x", "y"])
    want = np.stack([rec["z"], rec["x"], rec["y"]], -1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jnative.stack_f32_columns(rec, ["z", "x", "y"]))
    # Inputs the library does not take: numpy stacks them.
    assert native.stack_f32_columns(rec, ["x", "i"]) is None
    assert native.stack_f32_columns(rec, ["x", "missing"]) is None
    assert native.stack_f32_columns(rec[::2], ["x"]) is None
    assert native.stack_f32_columns(rec["x"], ["x"]) is None


def test_center_flip(with_libs):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 3, (5_000, 3)).astype(np.float32)
    got, jgot = pts.copy(), pts.copy()
    bb = native.center_flip(got)
    np.testing.assert_array_equal(got, center_and_flip(pts))
    np.testing.assert_array_equal(bb, np.stack([pts.min(0), pts.max(0)]))
    np.testing.assert_array_equal(bb, jnative.center_flip(jgot))
    np.testing.assert_array_equal(got, jgot)
    assert native.center_flip(pts.astype(np.float64)) is None
    assert native.center_flip(np.asfortranarray(pts)) is None
    assert native.center_flip(pts[:, :2].copy()) is None


def _tone_map(img, exposure, gamma):
    scaled = img * np.float32(exposure)
    if gamma != 1.0:
        scaled = np.power(np.clip(scaled, 0, None), 1.0 / gamma)
    return (np.clip(scaled, 0, 1) * 255 + 0.5).astype(np.uint8)


@pytest.mark.parametrize("exposure,gamma", [(1.0, 1.0), (2.0, 1.0),
                                            (0.7, 2.2)])
def test_to_uint8(with_libs, exposure, gamma):
    rng = np.random.default_rng(2)
    img = rng.random((37, 53, 4)).astype(np.float32) * 1.5 - 0.2
    got = native.to_uint8(img, exposure, gamma)
    assert got.dtype == np.uint8 and got.shape == img.shape
    # pow() may round 1 ulp apart at a bin edge: 1 count.
    assert np.abs(got.astype(int)
                  - _tone_map(img, exposure, gamma).astype(int)).max() <= 1
    np.testing.assert_array_equal(got, jnative.to_uint8(img, exposure,
                                                        gamma))
    # utils/image.to_uint8 takes the library when it is built.
    np.testing.assert_array_equal(image_util.to_uint8(img, exposure, gamma),
                                  got)


def test_without_the_library_every_function_returns_none(without_libs):
    rec = np.zeros(4, np.dtype([("x", "<f4")]))
    assert native.stack_f32_columns(rec, ["x"]) is None
    assert native.center_flip(np.zeros((4, 3), np.float32)) is None
    assert native.to_uint8(np.zeros((2, 2, 3), np.float32)) is None
    with pytest.raises(RuntimeError, match="not built"):
        native.ImagePrefetcher()
    img = np.random.default_rng(3).random((5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(image_util.to_uint8(img, 0.9, 2.2),
                                  _tone_map(img, 0.9, 2.2))


@pytest.mark.parametrize("state", ["with", "without"])
def test_ply_fields_in_both_states(request, monkeypatch, tmp_path, state):
    request.getfixturevalue(f"{state}_libs")
    from gaussian_splat_ipu_tpu.io import ply as jply

    stacked = []
    stack = native.stack_f32_columns
    monkeypatch.setattr(native, "stack_f32_columns", lambda rec, names: (
        stacked.append(stack(rec, names)) or stacked[-1]))

    rng = np.random.default_rng(4)
    names = (["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"]
             + [f"f_rest_{i}" for i in range(9)]
             + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1",
                "rot_2", "rot_3"])
    cols = {n: rng.normal(size=300).astype(np.float32) for n in names}
    path = str(tmp_path / "t.ply")
    ply_io.write_ply(path, cols)
    got = ply_io.gaussian_fields_from_ply(ply_io.read_ply(path))
    want = jply.gaussian_fields_from_ply(jply.read_ply(path))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        got["means"], np.stack([cols["x"], cols["y"], cols["z"]], -1))
    # Each stack went through the library exactly when it is built.
    assert len(stacked) == 5
    assert all((x is not None) == (state == "with") for x in stacked)


# -- the build and the two states ---------------------------------------------


def test_load_library_finds_only_a_library_of_the_current_hash(
        monkeypatch, built):
    port_dir, _ = built
    monkeypatch.setattr(native, "BUILD_DIR", port_dir)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available()
    lib_dirs = os.listdir(port_dir)
    assert len(lib_dirs) == 1 and lib_dirs[0].startswith("native-")
    # Other flags name another library, which is not built.
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    # An empty build directory: not built.
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS[:-1])
    monkeypatch.setattr(native, "BUILD_DIR", str(os.path.join(port_dir,
                                                              "none")))
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                        tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("int f() { return undeclared; }\n")
    monkeypatch.setattr(native, "HOST_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with pytest.raises(RuntimeError, match="undeclared"):
        native.build()
    assert native._lib is None


def test_processes_building_at_once_share_one_library(tmp_path):
    """Three processes build into one empty directory together: each loads
    the same complete library (the build goes through a temporary file
    and an atomic rename)."""
    code = ("import sys\n"
            "from gaussian_splat_ipu_tpu_torch.io import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "path = native.build()\n"
            "assert native.available()\n"
            "print(path)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(3)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert len(set(outs)) == 1
    lib_dir = os.path.dirname(outs[0])
    assert os.listdir(lib_dir) == [native.LIB_NAME]


# -- the prefetcher -----------------------------------------------------------


def _png(path, arr, filters=None, interlace=False, bit_depth=8):
    """Write a PNG by hand: each row with the filter type filters[y % 5]
    (0-4), or the whole image Adam7-interlaced with filter 0."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    flat = arr.reshape(h, w * c)
    if bit_depth == 16:
        flat = flat.astype(">u2").view(np.uint8).reshape(h, -1)
    bpp = c * bit_depth // 8

    def filtered(rows, kind_of):
        out, prev = [], np.zeros(rows.shape[1], np.int32)
        for y, row in enumerate(rows.astype(np.int32)):
            kind = kind_of(y)
            left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            if kind == 0:
                pred = np.zeros_like(row)
            elif kind == 1:
                pred = left
            elif kind == 2:
                pred = prev
            elif kind == 3:
                pred = (left + prev) // 2
            else:
                p = left + prev - upleft
                pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                              np.abs(p - upleft))
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prev, upleft))
            out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(
                np.uint8).tobytes())
            prev = row
        return b"".join(out)

    if interlace:
        raw = b""
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                               (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                               (0, 1, 1, 2)):
            sub = flat.reshape(h, w, -1)[y0::dy, x0::dx]
            if sub.size:
                raw += filtered(sub.reshape(sub.shape[0], -1), lambda y: 0)
    else:
        raw = filtered(flat, (lambda y: filters[y % len(filters)])
                       if filters else (lambda y: 0))

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth,
                                             ctype, 0, 0, int(interlace)))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _noise(mode, h=29, w=41, seed=5):
    shape = (h, w) if MODES[mode] == 1 else (h, w, MODES[mode])
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _fetch_all(mod, paths, downscale):
    pf = mod.ImagePrefetcher(nthreads=3)
    try:
        jobs = [pf.submit(p, downscale) for p in paths]
        return [pf.fetch(j) for j in jobs]
    finally:
        pf.close()


@pytest.mark.parametrize("downscale", [1, 2, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_prefetcher_equals_decode_png_torch_and_jax(with_libs, tmp_path,
                                                    mode, downscale):
    """PIL-written PNGs (its adaptive filters) and one PNG per filter type
    0-4 written by hand, at sides that are not multiples of 2 or 3."""
    arr = _noise(mode)
    paths = [str(tmp_path / "pil.png")]
    Image.fromarray(arr, mode).save(paths[0])
    for k in range(5):
        paths.append(str(tmp_path / f"filter{k}.png"))
        _png(paths[-1], arr, filters=[k])
    paths.append(str(tmp_path / "mixed.png"))
    _png(paths[-1], arr, filters=[0, 1, 2, 3, 4])
    got = _fetch_all(native, paths, downscale)
    jgot = _fetch_all(jnative, paths, downscale)
    c = MODES[mode]
    for p, g, j in zip(paths, got, jgot):
        assert np.array_equal(np.asarray(Image.open(p)), arr), p
        assert g is not None, p
        img, (w0, h0) = g
        want, want_size = native.decode_png_torch(p, downscale)
        assert img.dtype == np.float32 and want.dtype == np.float32
        assert img.shape == (29 // downscale, 41 // downscale, c)
        assert (w0, h0) == want_size == (41, 29)
        np.testing.assert_array_equal(img, want, err_msg=p)
        np.testing.assert_array_equal(img, j[0], err_msg=p)
        assert j[1] == (w0, h0)


def test_decode_png_torch_is_the_block_mean(tmp_path):
    """The plain version's numbers are block means of the bytes over 255,
    rounded once to f32."""
    arr = _noise("RGB", 12, 18, seed=6)
    path = str(tmp_path / "block.png")
    Image.fromarray(arr).save(path)
    for d in (1, 2, 3):
        got, size = native.decode_png_torch(path, d)
        mean = arr.reshape(12 // d, d, 18 // d, d, 3).astype(
            np.float64).mean(axis=(1, 3)) / 255.0
        assert size == (18, 12)
        np.testing.assert_allclose(got, mean, rtol=2e-7, atol=0)


def test_prefetcher_rejects_what_it_does_not_decode(with_libs, tmp_path):
    rgb = _noise("RGB")
    pal = str(tmp_path / "palette.png")
    Image.fromarray(rgb).convert("P").save(pal)
    deep = str(tmp_path / "sixteen.png")
    gray16 = (np.random.default_rng(7).integers(0, 65536, (29, 41))
              .astype(np.uint16))
    _png(deep, gray16, bit_depth=16)
    laced = str(tmp_path / "interlaced.png")
    _png(laced, rgb, interlace=True)
    jpg = str(tmp_path / "photo.jpg")
    Image.fromarray(rgb).save(jpg, quality=90)
    missing = str(tmp_path / "missing.png")
    # The files are what they claim to be.
    assert Image.open(pal).mode == "P"
    assert np.array_equal(np.asarray(Image.open(deep)).astype(np.uint16),
                          gray16)
    with Image.open(laced) as im:
        assert im.info.get("interlace") and np.array_equal(np.asarray(im),
                                                           rgb)
    paths = [pal, deep, laced, jpg, missing]
    assert _fetch_all(native, paths, 1) == [None] * 5
    assert _fetch_all(jnative, paths, 1) == [None] * 5
    for p in (pal, deep, jpg):
        with pytest.raises(ValueError):
            native.decode_png_torch(p)


# -- the loaders in the two states --------------------------------------------


def _sets(tmp_path, n=3):
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (31, 43, 3), dtype=np.uint8)
            for _ in range(n)]
    w2cs = orbit_w2c(n, radius=2.5)
    tj = write_transforms(str(tmp_path / "tj"), imgs, w2cs)
    cm = write_colmap(str(tmp_path / "cm"), imgs, w2cs,
                      [(40.0, 41.0, 21.5, 15.5)] * n,
                      rng.normal(size=(6, 3)), rng.integers(0, 256, (6, 3)))
    return tj, cm


def _loaded(tj, cm, downscale):
    port = (dataset.load_transforms(tj, downscale=downscale, device="cpu"),
            colmap.load_colmap(cm, downscale=downscale, device="cpu")[0])
    ref = (jdataset.load_transforms(tj, downscale=downscale),
           jcolmap.load_colmap(cm, downscale=downscale)[0])
    return port, ref


def _equal_sets(got, want):
    assert (got.width, got.height) == (want.width, want.height)
    for a, b in zip(got.images, want.images):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got.cameras, want.cameras):
        np.testing.assert_allclose(a.view.numpy(), np.asarray(b.view),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(a.proj.numpy(), np.asarray(b.proj),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("downscale", [1, 2])
def test_loaders_equal_jax_in_each_state(request, monkeypatch, tmp_path,
                                         downscale):
    tj, cm = _sets(tmp_path)
    request.getfixturevalue("with_libs")
    (tj_lib, cm_lib), ref = _loaded(tj, cm, downscale)
    for got, want in zip((tj_lib, cm_lib), ref):
        _equal_sets(got, want)
    for img, name in zip(cm_lib.images, sorted(os.listdir(
            os.path.join(cm, "images")))):
        np.testing.assert_array_equal(img, native.decode_png_torch(
            os.path.join(cm, "images", name), downscale)[0])
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    (tj_pil, cm_pil), ref = _loaded(tj, cm, downscale)
    for got, want in zip((tj_pil, cm_pil), ref):
        _equal_sets(got, want)
    # The two states: one ulp apart at most at downscale 1 (the byte times
    # f32(1/255) against the byte over 255), a block mean against PIL's
    # bilinear resize at 2.
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(cm_lib.images, cm_pil.images))
    if downscale == 1:
        assert 0.0 < diff <= np.spacing(np.float32(1.0))
    else:
        assert diff > 0.05
    assert tj_lib.width == tj_pil.width == 43 // downscale


def test_a_rejected_file_is_decoded_by_pil(with_libs, tmp_path):
    """A palette PNG in a transforms set goes to load_image."""
    tj, _ = _sets(tmp_path)
    meta = json.load(open(os.path.join(tj, "transforms.json")))
    first = os.path.join(tj, meta["frames"][0]["file_path"] + ".png")
    Image.open(first).convert("P").save(first)
    got = dataset.load_transforms(tj, downscale=2, device="cpu")
    want = dataset.load_image(first, 2)[0]
    np.testing.assert_array_equal(got.images[0], want)
    _equal_sets(got, jdataset.load_transforms(tj, downscale=2))
