"""Build, load and count the port's hand-written CUDA kernels.

The sources under gaussian_splat_ipu_tpu_torch/csrc/*.cu have a plain C
interface (csrc/*.cuh are headers they include). At first use each source
is compiled by its own nvcc process for sm_90a, all started together, and
the objects are linked into one shared library, cached under
gaussian_splat_ipu_tpu_torch/_build/<hash>/ (the hash covers the sources,
the headers and the flags) and loaded with ctypes. Nothing is
built or imported when this module is imported.

Every C entry launches on the stream it is given and returns
cudaGetLastError(); `check` turns a non-zero code into an exception.
`launches` counts, per kernel, the launches the wrappers made.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libgsplat_cuda.so"
# -fmad=false: no a*b+c contraction, so every kernel rounds each product
# and sum the way PyTorch's one-op-at-a-time plain versions do (the
# coverage-mask bits must match them exactly). -Xptxas=-v reports each
# kernel's registers and shared memory into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # geomf, geomi, n, tw, th, alpha_min, out, stream
    "gsplat_coverage_masks": (_P, _P, _I, _F, _F, _F, _P, _P),
    # packed, offsets_ext, n, p, cols, gid, rank, stream
    "gsplat_stream_expand": (_P, _P, _I, _I, _P, _P, _P, _P),
    # packed, offs, offs2, live_end, n, r, cap, cols, gid, rank, stream
    "gsplat_stream_expand_seg": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                 _P),
    # packed, gid, p, cols, stream
    "gsplat_expand_pairs": (_P, _P, _I, _P, _P),
    # r, n -> 64-bit scratch words of the row scan
    "gsplat_row_cumsum_scratch_words": (_I, _I),
    # x, r, n, out, scratch, stream
    "gsplat_row_cumsum_exclusive": (_P, _I, _I, _P, _P, _P),
    # feats, p, starts, ends, num_tiles, tile_offset, tiles_x, tile_w,
    # tile_h, chunk, max_pairs, eps, alpha_clamp, alpha_min, bg0, bg1, bg2,
    # mode, out, nc, stream
    "gsplat_rasterize_fwd": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _F, _F, _F, _F, _F, _F, _I, _P, _P, _P),
    # feats, p, starts, ends, gout, t_n, nc, num_tiles, tile_offset,
    # tiles_x, tile_w, tile_h, chunk, max_pairs, alpha_clamp, alpha_min,
    # bg0, bg1, bg2, dfeat, stream
    "gsplat_rasterize_bwd": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _F, _F, _F, _F, _F, _P, _P),
    # log, state, capacity, tag, stream
    "gsplat_stamp": (_P, _P, ctypes.c_longlong, ctypes.c_longlong, _P),
    # words (page-locked host memory), timeout_ns, stream
    "gsplat_anchor": (_P, ctypes.c_longlong, _P),
}

launches: collections.Counter = collections.Counter()


class BuildInfo:
    """What the first library() call in this process did."""

    seconds: float | None = None   # nvcc wall time; 0.0 when cached
    path: str | None = None
    log: str = ""


_lib = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def _build() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, LIB_NAME)
    BuildInfo.path = lib_path
    if os.path.isfile(lib_path):
        BuildInfo.seconds = 0.0
        log = os.path.join(out_dir, "build.log")
        if os.path.isfile(log):
            with open(log) as f:
                BuildInfo.log = f.read()
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(" ".join(cmd))
        tmp = os.path.join(work, LIB_NAME)
        if not failed:
            cmd = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs.append(proc.stdout)
            if proc.returncode != 0:
                failed.append(" ".join(cmd))
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = "".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed) + "\n"
                               + BuildInfo.log)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(BuildInfo.log)
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.gsplat_error_string.argtypes = [ctypes.c_int]
        lib.gsplat_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().gsplat_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype and shape on
    this CUDA device."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {t.device}; the kernel runs "
                         "on CUDA tensors and the plain version on CPU "
                         "tensors")
