"""The port's CLI (gaussian_splat_ipu_tpu_torch.app.main) on the CPU: the
PNG it writes equals the port's render at the app's camera, the demand
probe sizes the table and its cache is read back, --rowseg and any
--frames-in-flight render the same frames, --distributed with the points
program is refused, and scene loading matches the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

from gaussian_splat_ipu_tpu.io.scene import load_scene as j_load_scene
from gaussian_splat_ipu_tpu_torch.app import main as app
from gaussian_splat_ipu_tpu_torch.io.scene import load_scene, write_ply
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from gaussian_splat_ipu_tpu_torch.utils.image import decode_png, to_uint8

torch.set_num_threads(1)


@pytest.fixture
def ply(tmp_path):
    gen = torch.Generator().manual_seed(7)
    path = str(tmp_path / "scene.ply")
    model = GaussianModel.random(600, generator=gen, device="cpu",
                                 sh_degree=1)
    with torch.no_grad():
        model.log_scales += 1.5     # larger splats for a tiny image
    write_ply(path, model)
    return path


def test_cli_png_matches_render(ply, tmp_path):
    out = str(tmp_path / "out.png")
    assert app.main(["--input", ply, "--width", "96", "--height", "64",
                     "--device", "cpu", "--output", out,
                     "--pair-capacity", "8192", "--log-level", "warn"]) == 0
    got = decode_png(open(out, "rb").read())

    scene = load_scene(ply, device="cpu")
    cam = Camera.orbit(scene.bb_min, scene.bb_max, float(np.radians(40.0)),
                       96 / 64, rot_y_deg=0.0, device="cpu")
    cfg = RasterConfig(image_width=96, image_height=64, pair_capacity=8192,
                       strict_termination=False)
    with torch.inference_mode():
        want = to_uint8(render(scene.model, cam, cfg).image.numpy())
    np.testing.assert_array_equal(got, want)
    assert got[..., 3].max() > 0


def test_cli_probe_frames_and_dump(ply, tmp_path):
    frames = str(tmp_path / "frames")
    stats = app.run(["--input", ply, "--width", "96", "--height", "64",
                     "--device", "cpu", "--output", str(tmp_path / "o.png"),
                     "--pair-capacity", "0", "--frames", "3",
                     "--dump-frames", frames, "--exact-tiles",
                     "--tile-group", "2", "--strict-termination",
                     "--antialias", "--log-level", "warn"])
    assert stats["frames"] == 3 and len(stats["frame_ms"]) == 3
    assert stats["overflow"] == 0 and stats["truncated"] == 0
    assert 0 < stats["num_pairs"] <= stats["pair_capacity"]
    assert stats["pair_capacity"] % 128 == 0
    assert sorted(os.listdir(frames)) == [f"frame_{i:05d}.png"
                                          for i in range(3)]


def test_cli_rowseg_png_matches_flat(ply, tmp_path):
    """--rowseg 2 bins into two row buckets; every tile's pairs and their
    order are the flat path's, so the PNG is the same."""
    pngs = []
    for rowseg in ("1", "2"):
        out = str(tmp_path / f"rowseg{rowseg}.png")
        stats = app.run(["--input", ply, "--width", "96", "--height", "64",
                         "--device", "cpu", "--output", out, "--frames", "2",
                         "--pair-capacity", "8192", "--rowseg", rowseg,
                         "--log-level", "warn"])
        assert stats["overflow"] == 0 and stats["num_pairs"] > 0
        pngs.append(decode_png(open(out, "rb").read()))
    np.testing.assert_array_equal(pngs[1], pngs[0])
    assert pngs[1][..., 3].max() > 0


@pytest.mark.parametrize("flags", [["--distributed", "4", "--device",
                                    "points"]])
def test_cli_rejects_unported_flags(ply, flags, tmp_path):
    """--distributed runs the splat pipeline only: the points program has
    no sharded form (the reference refuses the pair too)."""
    assert app.parse_args(["--input", ply] + flags).distributed == 4
    with pytest.raises(SystemExit, match="requires the splat pipeline"):
        app.run(["--input", ply, "--output", str(tmp_path / "o.png")]
                + flags)


def test_cli_cuda_without_a_card_fails(ply, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the CPU-only case")
    with pytest.raises(SystemExit, match="no CUDA device"):
        app.run(["--input", ply, "--output", str(tmp_path / "o.png")])


def test_cli_points_without_a_card_fails(ply, tmp_path):
    """--device points runs the points program on the card, never on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the CPU-only case")
    with pytest.raises(SystemExit, match="no CUDA device"):
        app.run(["--input", ply, "--device", "points",
                 "--output", str(tmp_path / "o.png")])


@pytest.mark.parametrize("in_flight", ["1", "3"])
def test_frames_in_flight_give_the_same_frames(ply, tmp_path, in_flight):
    """Every retired frame, and the PNG, equal those of the default two
    frames in flight."""
    pngs = {}
    for depth in ("2", in_flight):
        frames = tmp_path / f"frames{depth}"
        out = tmp_path / f"out{depth}.png"
        stats = app.run(["--input", ply, "--width", "64", "--height", "48",
                         "--device", "cpu", "--output", str(out),
                         "--frames", "4", "--frames-in-flight", depth,
                         "--dump-frames", str(frames),
                         "--pair-capacity", "4096", "--log-level", "warn"])
        assert stats["frames"] == 4
        pngs[depth] = [decode_png(open(frames / f"frame_{i:05d}.png",
                                       "rb").read()) for i in range(4)]
        np.testing.assert_array_equal(decode_png(out.read_bytes()),
                                      pngs[depth][-1])
    for a, b in zip(pngs["2"], pngs[in_flight]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(pngs["2"][0], pngs["2"][1])  # orbit moves


def test_probe_cache_hit_and_stale_version(ply, tmp_path, monkeypatch):
    """--pair-capacity 0 with --compile-cache probes once, reads the
    capacity back on the next start, and probes again for another
    resolution or an entry of another cache version. The file is replaced
    whole (no temporary file stays)."""
    calls = []

    def probe(scene, width, height, fov, device, **kw):
        calls.append((width, height))
        return 1024 + 128 * len(calls)

    monkeypatch.setattr(app, "_auto_pair_capacity", probe)
    cache = tmp_path / "cache"
    common = ["--input", ply, "--device", "cpu", "--pair-capacity", "0",
              "--compile-cache", str(cache), "--output",
              str(tmp_path / "o.png"), "--log-level", "warn"]

    def start(w="64", h="48"):
        return app.run(common + ["--width", w, "--height", h])

    assert start()["pair_capacity"] == 1152 and len(calls) == 1
    assert start()["pair_capacity"] == 1152 and len(calls) == 1   # hit
    assert start("32", "32")["pair_capacity"] == 1280             # new key
    assert len(calls) == 2
    cache_file = cache / app.PROBE_CACHE_FILE
    data = json.loads(cache_file.read_text())
    assert data["version"] == app.PROBE_CACHE_VERSION
    assert len(data["entries"]) == 2
    assert sorted(os.listdir(cache)) == [app.PROBE_CACHE_FILE]
    data["version"] = app.PROBE_CACHE_VERSION - 1
    cache_file.write_text(json.dumps(data))
    assert start()["pair_capacity"] == 1408 and len(calls) == 3   # stale
    data = json.loads(cache_file.read_text())
    assert data["version"] == app.PROBE_CACHE_VERSION
    assert list(data["entries"].values()) == [1408]
    cache_file.write_text("{not json")
    assert start()["pair_capacity"] == 1536 and len(calls) == 4   # torn


def test_load_scene_matches_jax(ply):
    want = j_load_scene(ply)
    got = load_scene(ply, device="cpu")
    assert got.num_gaussians == want.num_gaussians == 600
    np.testing.assert_array_equal(got.bb_min, want.bb_min)
    np.testing.assert_array_equal(got.bb_max, want.bb_max)
    for k, v in got.model.to_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want.model, k)),
                                      err_msg=k)
    with pytest.raises(ValueError, match="unsupported"):
        load_scene(ply[:-4] + ".obj", device="cpu")
