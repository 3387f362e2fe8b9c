"""ctypes binding of the port's native host library (torch port of
gaussian_splat_ipu_tpu/io/native.py).

The sources are the port's own copies under
gaussian_splat_ipu_tpu_torch/csrc/host/: gsplat_native.cpp (PLY column
extraction, centre-and-flip, tone map) and dataloader.cpp (a threaded PNG
decoder). `build()` compiles them with g++ into
gaussian_splat_ipu_tpu_torch/_build/native-<hash>/libgsplat_native.so (the
hash covers the sources, the flags, `g++ --version` and what
`-march=native` resolves to), through a temporary directory and an atomic
rename, so processes that build at the same moment never load half a file.

    python -m gaussian_splat_ipu_tpu_torch.io.native   # build, print the path

is the port's `make -C csrc`. As in the reference, the library has two
states, and the callers' results depend on which holds:
- built for the current hash: `load_library()` loads it, and the loaders
  (io/dataset.py, io/colmap.py) decode PNGs through `ImagePrefetcher`,
  whose downscale averages d x d blocks in f32 (csrc/host/dataloader.cpp);
- not built: every function here returns None and its caller takes the
  numpy path; the loaders then decode with PIL, whose downscale is a
  bilinear resize. The two decodes differ at --downscale > 1.
Nothing builds the library at import or at first use.
`decode_png_torch` is the plain numpy version of the native decode, for
the tests.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_DIR = os.path.join(_PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libgsplat_native.so"
# The reference's csrc/Makefile flags.
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-Wall", "-Wextra", "-shared")
LIBS = ("-lz",)

_lib = None
_tried = False


def _sources() -> list:
    return sorted(glob.glob(os.path.join(HOST_DIR, "*.cpp")))


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout


def _lib_path(cxx: str) -> str:
    """Where the library built from the current sources, flags and
    compiler lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_run([cxx, "--version"]).encode())
    h.update(_run([cxx, "-march=native", "-Q", "--help=target"]).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"native-{h.hexdigest()[:16]}", LIB_NAME)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    lib.deinterleave_f32.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.POINTER(i64), i64,
        ctypes.c_void_p]
    lib.deinterleave_f32.restype = None
    lib.center_flip_f32.argtypes = [ctypes.c_void_p, i64, i64,
                                    ctypes.c_void_p]
    lib.center_flip_f32.restype = None
    lib.u8_from_f32.argtypes = [ctypes.c_void_p, i64, ctypes.c_float,
                                ctypes.c_float, ctypes.c_void_p]
    lib.u8_from_f32.restype = None
    lib.loader_create.argtypes = [i64]
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64]
    lib.loader_submit.restype = i64
    lib.loader_fetch.argtypes = [
        ctypes.c_void_p, i64, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.loader_fetch.restype = i64
    lib.loader_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.loader_free.restype = None
    return lib


def build() -> str:
    """Build the library for the current hash unless it is built, load it
    and return its path. Raises with the compiler's output when g++ is
    missing or fails."""
    global _lib, _tried
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot "
                           "be built")
    path = _lib_path(cxx)
    if not os.path.isfile(path):
        out_dir = os.path.dirname(path)
        os.makedirs(out_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as work:
            tmp = os.path.join(work, LIB_NAME)
            cmd = [cxx, *CXX_FLAGS, "-o", tmp, *_sources(), *LIBS]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError("g++ failed:\n" + " ".join(cmd) + "\n"
                                   + proc.stdout)
            os.replace(tmp, path)   # atomic: no process loads half a file
    _lib = _bind(ctypes.CDLL(path))
    _tried = True
    return path


def load_library() -> Optional[ctypes.CDLL]:
    """The library built for the current hash, loaded once; None when it
    is not built (or there is no g++ that names the hash)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    try:
        path = _lib_path(cxx)
    except (OSError, subprocess.CalledProcessError):
        return None
    if os.path.isfile(path):
        _lib = _bind(ctypes.CDLL(path))
    return _lib


def available() -> bool:
    return load_library() is not None


def stack_f32_columns(rec: np.ndarray,
                      names: Sequence[str]) -> Optional[np.ndarray]:
    """Gather float32 fields of a structured array into (n, k) f32; None
    without the library, or when a field is not little-endian f32 or the
    records are not contiguous (the caller then stacks with numpy)."""
    lib = load_library()
    if lib is None or rec.dtype.fields is None:
        return None
    if not rec.flags.c_contiguous:
        return None
    f4 = np.dtype("<f4")
    offsets = []
    for n in names:
        fld = rec.dtype.fields.get(n)
        if fld is None or fld[0] != f4:
            return None
        offsets.append(fld[1])
    n_rows = rec.shape[0]
    out = np.empty((n_rows, len(names)), np.float32)
    offs = np.asarray(offsets, np.int64)
    lib.deinterleave_f32(
        ctypes.c_void_p(rec.ctypes.data), n_rows, rec.dtype.itemsize,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(names),
        out.ctypes.data_as(ctypes.c_void_p))
    return out


def center_flip(xyz: np.ndarray) -> Optional[np.ndarray]:
    """In place: centre an (n, k >= 3) f32 C-contiguous array's first three
    columns on their bounding-box midpoint and negate z. Returns the
    pre-centering (2, 3) bbox; None without the library or for another
    array."""
    lib = load_library()
    if (lib is None or xyz.dtype != np.float32 or xyz.ndim != 2
            or xyz.shape[1] < 3 or not xyz.flags.c_contiguous
            or not xyz.flags.writeable):
        return None
    bb = np.empty(6, np.float32)
    lib.center_flip_f32(xyz.ctypes.data_as(ctypes.c_void_p), xyz.shape[0],
                        xyz.shape[1], bb.ctypes.data_as(ctypes.c_void_p))
    return bb.reshape(2, 3)


def to_uint8(img: np.ndarray, exposure: float = 1.0,
             gamma: float = 1.0) -> Optional[np.ndarray]:
    """Tone-map an f32 image to u8 (utils/image.to_uint8's native path);
    None without the library."""
    lib = load_library()
    if lib is None:
        return None
    flat = np.ascontiguousarray(img, np.float32)
    out = np.empty(flat.shape, np.uint8)
    lib.u8_from_f32(flat.ctypes.data_as(ctypes.c_void_p), flat.size,
                    exposure, 1.0 / gamma,
                    out.ctypes.data_as(ctypes.c_void_p))
    return out


class ImagePrefetcher:
    """Threaded native PNG decoder (csrc/host/dataloader.cpp).

    submit() the paths up front; fetch() blocks until that image is
    decoded while the workers run ahead on the rest. A fetch whose status
    is nonzero (palette, 16-bit or interlaced PNG, JPEG, a missing file)
    returns None, and the caller decodes that file with PIL."""

    def __init__(self, nthreads: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library not built (python -m "
                               "gaussian_splat_ipu_tpu_torch.io.native)")
        self._lib = lib
        self._handle = lib.loader_create(nthreads)

    def submit(self, path: str, downscale: int = 1) -> int:
        return int(self._lib.loader_submit(
            self._handle, path.encode(), max(int(downscale), 1)))

    def fetch(self, job_id: int):
        """-> (array (h, w, c) f32 in [0, 1], (w0, h0)) or None; c is the
        PNG's own channel count (1-4)."""
        data = ctypes.POINTER(ctypes.c_float)()
        w, h, c, w0, h0 = (ctypes.c_int64() for _ in range(5))
        status = self._lib.loader_fetch(
            self._handle, job_id, ctypes.byref(data), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(c), ctypes.byref(w0),
            ctypes.byref(h0))
        if status != 0:
            return None
        try:
            n = w.value * h.value * c.value
            arr = np.ctypeslib.as_array(data, shape=(n,)).reshape(
                h.value, w.value, c.value).copy()
        finally:
            self._lib.loader_free(data)
        return arr, (w0.value, h0.value)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:
            pass


def decode_png_torch(path: str, downscale: int = 1):
    """The plain version of the native decode of an 8-bit gray, gray +
    alpha, RGB or RGBA PNG: (array (h, w, c) f32, (w0, h0)), the numbers
    ImagePrefetcher.fetch gives. PIL decodes the bytes; downscale d crops
    to whole d x d blocks, sums each block as integers (exact in f32) and
    multiplies by (1/255) / (d*d), both rounded to f32 as the C++ does
    (at d = 1: the byte times f32(1/255), which is not always the byte
    divided by 255 in f32)."""
    from PIL import Image

    with Image.open(path) as img:
        if img.format != "PNG" or img.mode not in ("L", "LA", "RGB",
                                                   "RGBA"):
            raise ValueError(f"{path}: {img.format} {img.mode}, not an "
                             "8-bit gray, gray + alpha, RGB or RGBA PNG")
        arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    h0, w0 = arr.shape[:2]
    d = max(int(downscale), 1)
    oh, ow = h0 // d, w0 // d
    if oh < 1 or ow < 1:
        raise ValueError(f"{path}: {w0}x{h0} is smaller than one "
                         f"{d}x{d} block")
    blocks = arr[:oh * d, :ow * d].astype(np.int64).reshape(
        oh, d, ow, d, arr.shape[2])
    sums = blocks.sum(axis=(1, 3)).astype(np.float32)
    norm = (np.float32(1.0) / np.float32(255.0)) / np.float32(d * d)
    return sums * norm, (w0, h0)


if __name__ == "__main__":
    print(build())
