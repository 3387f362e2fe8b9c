"""Application entry point: the interactive / offline render loop (torch
port of gaussian_splat_ipu_tpu/app/main.py).

Loads a scene, fits an orbit camera to its bounds and registers its
programs in a RenderEngine (runtime/engine.py; CUDA graphs on the card):
"project", the splat pipeline (the points program under --device
points), and with --ui-port also "points", the 1-px point renderer the
viewer can switch to. Headless it renders --frames orbit frames. With
--ui-port and --frames 0 it renders until the viewer sends `stop`: the
viewer's state drives the camera (fov, rot x / y, translation,
environment rotation), exposure, gamma and the program; `detach` drops
the viewer and rendering goes on, ready for a reconnect. Up to
--frames-in-flight frames are outstanding; each retired frame is logged
(time, overflow / truncation telemetry), optionally dumped as PNG, and
pushed to the viewer (a video frame and the tile histogram, encoded and
sent on a worker thread while the next frame renders). The last frame is
written as PNG.

--distributed N renders each frame over a mesh of N shards
(parallel/distributed.py, the reference's app/main.py:246-285): gaussians
sharded for projection, splats exchanged by all_to_all, each shard binning
and compositing its own row strip, the frame equal to the single-device
one. Every shard gets the full --pair-capacity and exchange buckets of
2 x N_local rows (an interactive camera may put every splat on one strip),
the tile counts are cropped to the grid, and exchange overflow joins the
telemetry and the viewer's histogram. The shards sit round-robin on the
visible devices of --device's kind (all N on one card share it, and the
frame is one graph replay). --device points has no sharded program and is
refused, as in the reference.

The camera is computed on the host each frame and handed to the engine as
three tensors (view, projection, environment rotation), which it copies
into the captured program's inputs. (The reference computes the camera
inside its jitted program; a CUDA graph cannot capture the host-to-device
copies that the camera's constants would need.)

Run:  python -m gaussian_splat_ipu_tpu_torch.app.main --input scene.ply
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.io.scene import load_scene
from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.parallel import distributed
from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib
from gaussian_splat_ipu_tpu_torch.render import points as points_render
from gaussian_splat_ipu_tpu_torch.render.binning import bin_splats
from gaussian_splat_ipu_tpu_torch.render.pipeline import render
from gaussian_splat_ipu_tpu_torch.render.projection import project_gaussians
from gaussian_splat_ipu_tpu_torch.runtime import engine as engine_lib
from gaussian_splat_ipu_tpu_torch.ui.async_task import AsyncTask
from gaussian_splat_ipu_tpu_torch.utils import image as image_util
from gaussian_splat_ipu_tpu_torch.utils import profiling
from gaussian_splat_ipu_tpu_torch.utils.config import (RasterConfig,
                                                      RuntimeConfig,
                                                      check_supported)

log = logging.getLogger("gsplat")

_TELEMETRY_EVERY = 30   # frames between overflow reads and timing logs
# Bump when the probe or its rounding changes: cached capacities of an
# older version are probed again.
PROBE_CACHE_VERSION = 1
PROBE_CACHE_FILE = "pair_capacity_cache.json"


def parse_args(argv=None):
    """Flags of the reference CLI, same defaults; --device cuda takes the
    place of its tpu."""
    p = argparse.ArgumentParser(
        description="CUDA gaussian splat renderer (PyTorch port)")
    p.add_argument("--input", "-o", required=True,
                   help="PLY or XYZ scene file")
    p.add_argument("--log-level", default="info",
                   choices=list(engine_lib.LOG_LEVELS))
    p.add_argument("--ui-port", type=int, default=0,
                   help="remote UI port (0 = headless)")
    p.add_argument("--device", default="cuda",
                   choices=["cuda", "cpu", "points"],
                   help="cuda = the CUDA kernels, captured as CUDA graphs; "
                        "cpu = their plain torch versions, eagerly; points "
                        "= 1-px point splats on the card")
    p.add_argument("--distributed", type=int, default=0, metavar="N",
                   help="render over a mesh of N shards (> 1), placed "
                        "round-robin on the visible devices of --device's "
                        "kind")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--fov", type=float, default=40.0, help="degrees")
    p.add_argument("--frames", type=int, default=0,
                   help="render N orbit frames then exit (0 = one frame, "
                        "or until the viewer stops the app with "
                        "--ui-port)")
    p.add_argument("--output", default="test.png",
                   help="final frame dump")
    p.add_argument("--dump-frames", default="",
                   help="directory to write every retired frame as "
                        "frame_%%05d.png")
    p.add_argument("--pair-capacity", type=int, default=1 << 19,
                   help="(gaussian, tile) pair-table size. 0 = probe the "
                        "worst demand over an orbit and right-size")
    p.add_argument("--exact-tiles", action="store_true",
                   help="exact tile-ellipse coverage test (fewer pairs, "
                        "identical image)")
    p.add_argument("--tile-group", type=int, default=1,
                   help="bin pairs over KxK super-tiles (1 = off)")
    p.add_argument("--rowseg", type=int, default=1,
                   help="row-bucket segmented binning into N buckets of "
                        "--pair-capacity / N pairs each (1 = off)")
    p.add_argument("--antialias", action="store_true",
                   help="energy-conserving lowpass (Mip-Splatting)")
    p.add_argument("--strict-termination", action="store_true",
                   help="exact reference break semantics. Default off: "
                        "the relaxed kernel is colour-identical and only "
                        "the alpha channel may exceed the strict value by "
                        "<= eps/(1-alpha_clamp)")
    p.add_argument("--compile-cache", default="",
                   help="directory of the --pair-capacity 0 probe cache "
                        "(empty = probe on every start)")
    p.add_argument("--frames-in-flight", type=int, default=2,
                   help="frames queued on the device before the oldest "
                        "is retired (1 = fully synchronous)")
    p.add_argument("--spans", default="", metavar="PATH",
                   help="record the engine's and the frame program's "
                        "spans (utils/profiling.py) and write them to PATH "
                        "as a Chrome trace at exit")
    return p.parse_args(argv)


def _auto_pair_capacity(scene, width: int, height: int, fov: float,
                        device, views: int = 8,
                        probe_cap: int = 1 << 21) -> int:
    """Probe the worst (gaussian, tile) pair demand over an orbit with the
    default binning, growing the probe table until nothing overflows, and
    return 1.3x that, chunk-aligned (every binning pass is O(capacity))."""
    aspect = width / height
    while True:
        cfg = RasterConfig(image_width=width, image_height=height,
                           pair_capacity=probe_cap)
        worst = 0
        for i in range(views):
            cam = Camera.orbit(scene.bb_min, scene.bb_max, fov, aspect,
                               rot_y_deg=360.0 * i / views,
                               device="cpu").to(device)
            b = bin_splats(project_gaussians(scene.model, cam, cfg), cfg)
            worst = max(worst, int(b.num_pairs + b.overflow))
        if worst <= probe_cap or probe_cap >= 1 << 24:
            break
        probe_cap *= 4
    cap = max(int(worst * 1.3), 4 * cfg.chunk_size)
    return -(-cap // cfg.chunk_size) * cfg.chunk_size


def _probe_key(path_of_scene: str, scene, width: int, height: int,
               fov: float, flavour: str) -> str:
    """The reference's cache key (app/main.py:157-164): the scene file's
    identity (path, size, mtime; hashing a large PLY would cost a probe's
    worth of IO), its gaussian count, the resolution, the fov and the
    kernel flavour."""
    try:
        st = os.stat(path_of_scene)
        ident = (f"{os.path.abspath(path_of_scene)}:{st.st_size}:"
                 f"{int(st.st_mtime)}")
    except OSError:
        ident = path_of_scene
    return (f"{ident}|{scene.model.num_gaussians}|{width}x{height}|"
            f"fov={fov:.5f}|kernels={flavour}")


def _cached_pair_capacity(path_of_scene: str, scene, width: int,
                          height: int, fov: float, device,
                          cache_dir: str) -> int:
    """The demand probe with a persistent result cache in `cache_dir`
    (none when it is empty): the capacity is a function of the scene,
    the resolution, the fov and the kernel flavour, so a second start
    reads it back. The file carries PROBE_CACHE_VERSION (an entry of
    another version is probed again) and is replaced atomically, so a
    concurrent start never reads a torn file."""
    flavour = "cuda" if device.type == "cuda" else "cpu"
    if not cache_dir:
        return _auto_pair_capacity(scene, width, height, fov, device)
    key = _probe_key(path_of_scene, scene, width, height, fov, flavour)
    cache_file = os.path.join(cache_dir, PROBE_CACHE_FILE)
    entries = {}
    try:
        with open(cache_file) as f:
            data = json.load(f)
        if data.get("version") == PROBE_CACHE_VERSION:
            entries = dict(data.get("entries", {}))
    except (OSError, ValueError, AttributeError, TypeError):
        pass
    if key in entries:
        log.info("pair capacity from probe cache: %d", entries[key])
        return int(entries[key])
    cap = _auto_pair_capacity(scene, width, height, fov, device)
    entries[key] = cap
    tmp = None
    try:
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix=".probe_",
                                   suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump({"version": PROBE_CACHE_VERSION, "entries": entries},
                      f, indent=1)
        os.replace(tmp, cache_file)
    except OSError as e:
        log.warning("probe cache not written (%s)", e)
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
    return cap


class FrameOutput(NamedTuple):
    """What a program returns each frame."""

    image: torch.Tensor        # (H, W, 4) f32
    tile_counts: torch.Tensor  # (T,) i32 pairs (splat) / points per tile
    overflow: torch.Tensor     # () i32 pairs dropped at the capacity
    truncated: torch.Tensor    # () i32 pairs past the per-tile work bound
    count: torch.Tensor        # () i32 live pairs (splat) / points shown
    exchange_overflow: torch.Tensor  # () i32 splat rows dropped at the
    #                                  all_to_all buckets (--distributed)


def splat_program(cfg: RasterConfig):
    """The "project" program: the full splat pipeline."""
    def splat(model, view, proj, env_rot) -> FrameOutput:
        out = render(model, Camera(view, proj, env_rot), cfg)
        return FrameOutput(out.image, out.tile_counts, out.overflow,
                           out.truncated, out.num_pairs,
                           torch.zeros_like(out.overflow))
    return splat


def sharded_program(cfg: RasterConfig, mesh, **kw):
    """The splat pipeline over a mesh, on a model sharded on it:
    distributed.render_sharded with the keywords `kw` (capacities, the
    exchange), its tile counts cropped to the grid."""
    def splat(model, view, proj, env_rot) -> FrameOutput:
        out = distributed.render_sharded(model, Camera(view, proj, env_rot),
                                         cfg, mesh, **kw)
        return FrameOutput(out.image, out.tile_counts[:cfg.num_tiles],
                           out.overflow, out.truncated, out.num_pairs,
                           out.exchange_overflow)
    return splat


def points_program(cfg: RasterConfig):
    """The "points" program: 1-px point splats and the per-tile point
    histogram; nothing is dropped."""
    def points(model, view, proj, env_rot) -> FrameOutput:
        cam = Camera(view, proj, env_rot)
        out = points_render.render_points(model, cam, cfg)
        zero = torch.zeros((), dtype=torch.int32, device=view.device)
        return FrameOutput(out.image,
                           points_render.tile_histogram(model, cam, cfg),
                           zero, zero, out.count, zero)
    return points


def orbit_camera(scene, state: dict, aspect: float) -> Camera:
    """The frame's camera, on the host, from the loop state (fov radians,
    rotations in degrees, translation, environment rotation)."""
    return Camera.orbit(scene.bb_min, scene.bb_max, state["fov"], aspect,
                        rot_x_deg=state["rx"], rot_y_deg=state["ry"],
                        translation=(state["x"], state["y"], state["z"]),
                        env_rot=(state["erx"], state["ery"]), device="cpu")


def run(argv=None) -> dict:
    """The body of main: render the frames and return their statistics —
    frame_ms (on CUDA the device span of each frame's engine.run, from
    the start of its copy-in to the end of its output clones; host time
    on the CPU), the last frame's overflow, truncated, num_pairs (its
    FrameOutput.count), exchange_overflow and tile_counts, the program it
    ran, each program's capture seconds and the mesh's shard count (0
    without --distributed)."""
    args = parse_args(argv)
    if args.distributed > 1 and args.device == "points":
        raise SystemExit("--distributed requires the splat pipeline "
                         "(--device cuda or cpu)")
    engine_lib.setup_logging(args.log_level)
    on_cuda = args.device != "cpu"
    if on_cuda:
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is "
                             "available")
        # Full f32 matmuls, as the reference's HIGHEST precision.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    engine = engine_lib.RenderEngine(RuntimeConfig(
        device="cuda" if on_cuda else "cpu",
        compile_cache_dir=args.compile_cache))
    device = engine.device
    # Frame times on the card are the engine's engine.run device spans: a
    # recorder of that span alone unless --spans records every span (or
    # the caller already records).
    rec, own = profiling.active, profiling.active is None
    if own and (args.spans or on_cuda):
        rec = profiling.start(device, only=None if args.spans
                              else ("engine.run",))
    try:
        return _run(args, engine, rec, on_cuda,
                    clear_spans=own and not args.spans)
    finally:
        if own and rec is not None:
            if args.spans:
                profiling.export_spans(args.spans, rec)
                log.info("spans -> %s", args.spans)
            profiling.stop()


def _run(args, engine, rec, on_cuda: bool, clear_spans: bool) -> dict:
    device = engine.device
    with torch.inference_mode():
        scene = load_scene(args.input, device=device)
        model = scene.model
        n = model.num_gaussians
        log.info("loaded %d gaussians from %s", n, args.input)
        fov = float(np.radians(args.fov))
        aspect = args.width / args.height
        if args.pair_capacity == 0 and args.device != "points":
            args.pair_capacity = _cached_pair_capacity(
                args.input, scene, args.width, args.height, fov, device,
                engine.config.compile_cache_dir)
            log.info("auto pair capacity: %d", args.pair_capacity)
        elif args.pair_capacity == 0:
            args.pair_capacity = 1 << 12  # the points path builds no pairs
        cfg = RasterConfig(image_width=args.width, image_height=args.height,
                           pair_capacity=args.pair_capacity,
                           exact_tile_test=args.exact_tiles,
                           antialias=args.antialias,
                           tile_group=args.tile_group,
                           rowseg_buckets=args.rowseg,
                           strict_termination=args.strict_termination)
        check_supported(cfg)

        state = {"fov": fov, "rx": 0.0, "ry": 0.0, "x": 0.0, "y": 0.0,
                 "z": 0.0, "erx": 0.0, "ery": 0.0}
        mesh, eager = None, ""
        splat = splat_program(cfg)
        if args.distributed > 1:
            mesh = mesh_lib.make_mesh(args.distributed, device=device.type)
            model = mesh_lib.shard_model(model, mesh)
            splat = sharded_program(
                cfg, mesh, pair_capacity=cfg.pair_capacity,
                exchange_capacity=2 * model.num_gaussians // mesh.size)
            if mesh.spans_devices:
                eager = (f"its {mesh.size} shards span "
                         f"{len(set(mesh.devices))} devices")
            log.info("distributed: %d shards on %s, %d tile rows each",
                     mesh.size, sorted({str(d) for d in mesh.devices}),
                     distributed._rows_per_device(cfg, mesh.size))
        cam0 = orbit_camera(scene, state, aspect)
        # The programs' camera inputs, owned by the engine from here on.
        example = (model, cam0.view.to(device), cam0.proj.to(device),
                   cam0.env_rot.to(device))
        points = points_program(cfg)
        # Two switchable programs, as the reference's runtime cpu / ipu
        # device toggle: "project" the splat pipeline, "points" the 1-px
        # positional renderer.
        engine.register("project", points if args.device == "points"
                        else splat, example, eager=eager)
        if args.ui_port:
            engine.register("points", points, example)
        log.info("engine ready: %s", engine.manifest())

        ui = None
        if args.ui_port:
            from gaussian_splat_ipu_tpu_torch.ui.server import InterfaceServer
            ui = InterfaceServer(args.ui_port)
            ui.start()
        if args.dump_frames:
            os.makedirs(args.dump_frames, exist_ok=True)

        ui_task = AsyncTask()
        exposure, gamma = 1.0, 1.0
        program = "project"
        nframes = max(args.frames, 1)
        interactive = ui is not None and args.frames == 0
        inflight = collections.deque()
        frame_ms = []   # host ms on the CPU, engine items on the card
        device_ms = {}  # engine item -> its engine.run device ms
        # (overflow, truncated, exchange_overflow) at the telemetry cadence
        drops = (0, 0, 0)
        last = None
        t_last = None

        def read_spans():
            # Called with the device idle (collect synchronises), so the
            # app's own recorder of engine.run alone can be cleared.
            device_ms.update(profiling.item_ms(rec.collect(), "engine.run"))
            if clear_spans:
                rec.clear()

        def retire_one():
            nonlocal last, drops, t_last
            out, done, tag, t_submit = inflight.popleft()
            k = len(frame_ms)
            frame_ms.append(tag)
            if done is not None:
                done.synchronize()
            now = time.perf_counter()
            if k % _TELEMETRY_EVERY == 0:
                drops = (int(out.overflow), int(out.truncated),
                         int(out.exchange_overflow))
                if on_cuda:
                    read_spans()
                if any(drops):
                    log.warning("frame %d: dropped splat pairs (overflow=%d "
                                "over --pair-capacity, truncated=%d past the "
                                "per-tile work bound, exchange_overflow=%d "
                                "at the all_to_all buckets)", k, *drops)
                log.info("frame %d: %.3f ms %s, %.2f ms since the last "
                         "retire, latency %.1f ms (count %d)", k,
                         device_ms.get(tag, float("nan")) if on_cuda
                         else tag, "device" if on_cuda else "host",
                         (now - (t_last or t_submit)) * 1e3,
                         (now - t_submit) * 1e3, int(out.count))
            t_last = now
            if args.dump_frames:
                image_util.write_png(
                    os.path.join(args.dump_frames, f"frame_{k:05d}.png"),
                    out.image.cpu().numpy())
            last = out
            if ui is not None:
                # Encode and send while the next frame renders.
                ui_task.wait_for_completion()
                img, cnt = out.image.cpu().numpy(), \
                    out.tile_counts.cpu().numpy()

                def push(img=img, cnt=cnt, ex=exposure, gm=gamma,
                         ov=drops[0], tr=drops[1], xo=drops[2]):
                    ui.send_video_frame(img, ex, gm)
                    ui.send_histogram(cnt, overflow=ov, truncated=tr,
                                      exchange_overflow=xo)

                ui_task.run(push)

        i = 0
        stop = False
        try:
            while not stop:
                if ui is not None and ui.state_changed():
                    s = ui.consume_state()
                    stop = s.stop
                    exposure, gamma = s.exposure, s.gamma
                    program = ("points" if s.device in ("cpu", "points")
                               else "project")
                    state.update(fov=s.fov, rx=s.rot_x_deg, ry=s.rot_y_deg,
                                 x=s.x, y=s.y, z=s.z, erx=s.env_rotation_x,
                                 ery=s.env_rotation_y)
                    if s.detach:
                        # Drop the viewer, keep rendering and listening.
                        ui_task.wait_for_completion()
                        ui.drop_client()
                        log.info("UI detached: rendering continues headless")
                elif not interactive:
                    state["ry"] = 360.0 * i / nframes
                cam = orbit_camera(scene, state, aspect)
                t_submit = time.perf_counter()
                out = engine.run(program, model, cam.view, cam.proj,
                                 cam.env_rot)
                # The retire waits for the frame on this event; its time
                # is the engine's span.
                done = torch.cuda.Event() if on_cuda else None
                if on_cuda:
                    done.record()
                inflight.append((out, done, engine.last_item if on_cuda
                                 else (time.perf_counter() - t_submit) * 1e3,
                                 t_submit))
                if len(inflight) >= max(args.frames_in_flight, 1):
                    retire_one()
                i += 1
                if not interactive and i >= nframes:
                    break
            # Drain through the same retire path, so every frame reaches
            # the dump and the viewer.
            while inflight:
                retire_one()
        finally:
            if ui is not None:
                ui_task.wait_for_completion()
                ui.stop()

        image_util.write_png(args.output, last.image.cpu().numpy())
        if on_cuda:
            read_spans()
            frame_ms = [device_ms.get(k, float("nan")) for k in frame_ms]
        stats = dict(frames=len(frame_ms), frame_ms=frame_ms,
                     median_ms=float(np.median(frame_ms)),
                     overflow=int(last.overflow),
                     truncated=int(last.truncated),
                     num_pairs=int(last.count),
                     exchange_overflow=int(last.exchange_overflow),
                     shards=mesh.size if mesh is not None else 0,
                     tile_counts=last.tile_counts.cpu().numpy(),
                     pair_capacity=cfg.pair_capacity, program=program,
                     capture_seconds={k: p.compile_seconds
                                      for k, p in engine.programs.items()})
    log.info("wrote %s; median frame %.3f ms over %d frames, overflow=%d, "
             "truncated=%d, count=%d", args.output, stats["median_ms"],
             stats["frames"], stats["overflow"], stats["truncated"],
             stats["num_pairs"])
    return stats


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
