"""Remote viewer CLI: connect to a running app's UI port, drive the
camera, and record the preview stream (port of
gaussian_splat_ipu_tpu/ui/viewer.py; it drives the app of either
package).

    python -m gaussian_splat_ipu_tpu_torch.app.main --input s.ply \
        --ui-port 5005 &
    python -m gaussian_splat_ipu_tpu_torch.ui.viewer --port 5005 \
        --seconds 5 --spin 45 --out /tmp/view

Connects, optionally spins the orbit camera, decodes the GSV1 video
stream (or stills), writes frames and the last tile histogram, prints one
JSON line of what it received, and leaves with `detach` (the app keeps
rendering) or, with --stop, `stop` (the app exits).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="gsplat-viewer",
                                description=__doc__.split("\n")[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0,
                   help="how long to watch before detaching")
    p.add_argument("--spin", type=float, default=0.0,
                   help="orbit degrees/second sent as lambda2 control")
    p.add_argument("--fov", type=float, default=0.0,
                   help="if set, push this fov once, in radians: the "
                        "server's state and the app's camera take radians "
                        "(the reference viewer's help says degrees)")
    p.add_argument("--out", default="",
                   help="directory for received frames (PNG) + histogram")
    p.add_argument("--save-every", type=int, default=1,
                   help="write every k-th decoded frame")
    p.add_argument("--stop", action="store_true",
                   help="send stop (shut the app down) instead of detach")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from gaussian_splat_ipu_tpu_torch.ui.server import InterfaceClient
    from gaussian_splat_ipu_tpu_torch.utils import image as image_util

    cli = InterfaceClient(args.host, args.port, timeout=10.0)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    if args.fov:
        cli.send("fov", args.fov)

    t0 = time.perf_counter()
    n_frames = 0
    n_saved = 0
    last_hist = None
    cli.sock.settimeout(0.25)
    try:
        while time.perf_counter() - t0 < args.seconds:
            if args.spin:
                cli.send("lambda2",
                         args.spin * (time.perf_counter() - t0))
            try:
                ptype, payload = cli.recv()
            except socket.timeout:
                continue
            if ptype == "render_preview":
                frame = cli.decode_preview(payload)
                if frame is None:
                    continue  # P-frame before the first key frame
                n_frames += 1
                if args.out and n_frames % max(args.save_every, 1) == 0:
                    image_util.write_png(
                        os.path.join(args.out,
                                     f"view_{n_saved:05d}.png"), frame)
                    n_saved += 1
            elif ptype == "tile_histogram":
                last_hist = json.loads(payload.decode())
            elif ptype in ("hdr_header", "hdr_chunk"):
                hdr = cli.feed_hdr(ptype, payload)
                if hdr is not None and args.out:
                    np.save(os.path.join(args.out, "raw_hdr.npy"), hdr)
        dt = max(time.perf_counter() - t0, 1e-6)
        if args.out and last_hist is not None:
            with open(os.path.join(args.out, "histogram.json"), "w") as f:
                json.dump(last_hist, f)
        cli.send("stop" if args.stop else "detach")
        print(json.dumps({"frames": n_frames, "saved": n_saved,
                          "fps": round(n_frames / dt, 2),
                          "histogram": last_hist is not None}))
    finally:
        cli.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
