"""ctypes binding for the port's C++ decode pool (``native/decode_pool.cpp``).

The port's counterpart of ``emr2a_tpu/data/native_loader.py``, with its
functions and signatures: ``get_lib``, ``native_available``,
``decode_batch`` and ``load_images_batch``. The pool decodes PNG and JPEG
with its own decoders (``native/inflate.h``, ``png_decode.h``,
``jpeg_decode.h``), written to give the bytes libpng and libjpeg-turbo give
the JAX package's pool, and resizes with the same integer box filter and
bilinear upscale, across threads, straight into one uint8 batch.

Build: at first use, the host C++ compiler (``$CXX``, else ``g++``, else
``c++``) compiles ``decode_pool.cpp`` with ``-O3 -fPIC -std=c++17 -shared
-pthread`` and links nothing else. The library goes to ``build/native/``
under a name that carries a hash of the sources and flags; it is built in a
temporary directory and renamed into place, so processes that build it at
the same moment do not see each other's half-written file (``ops/_build``'s
``digest`` and ``install``, as for the CUDA kernels).

    python -m emr2a_tpu_torch.data.native_loader      # build now, print the path

Where this differs from the JAX package's module:
- that module builds with ``make`` against libpng and libjpeg, and when the
  build or the load fails it logs a warning and ``native_available()``
  returns False, so callers fall back to the per-image path. Here
  ``native_available()`` is False only where no C++ compiler is found (and
  no library was built before); a build or load that fails raises with the
  compiler's output;
- ``resize_rgb_reference`` (a plain numpy version of the pool's resize) and
  the ``POOL_BATCHES`` counter are new.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from emr2a_tpu_torch.ops._build import digest, install

SOURCE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

# Pool runs (calls of decode_batch with paths); chip_smoke.py reads it to show
# that a run went through the pool. Incremented under _lock: callers may
# decode from several threads.
POOL_BATCHES = 0

_lib = None
_lock = threading.Lock()


def _sources() -> list:
    return sorted(SOURCE_DIR.glob("*.cpp")) + sorted(SOURCE_DIR.glob("*.h"))


def source_digest() -> str:
    return digest(_sources(), CXX_FLAGS)


def library_path() -> Path:
    return BUILD_DIR / f"libemr2a_decode_{source_digest()}.so"


def compiler() -> Optional[str]:
    """The host C++ compiler the pool builds with, or None."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name:
            found = shutil.which(name)
            if found:
                return found
    return None


def build() -> Path:
    """Compile the pool if this version of the sources has not been built
    yet; return the library's path. Raises with the compiler's output."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, g++, c++) to build the "
                           "decode pool")

    def make(tmp: Path) -> Path:
        lib = tmp / out.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE_DIR / "decode_pool.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"decode pool build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        return lib

    return install(out, make)


def get_lib():
    """The loaded shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.emr2a_decode_batch.restype = ctypes.c_int
            lib.emr2a_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte)]
            _lib = lib
    return _lib


def native_available() -> bool:
    """True when the pool can run here: it is built (building it now if a
    compiler is found). False only when there is no compiler and no built
    library; a build or load that fails raises."""
    if compiler() is None and not library_path().exists():
        return False
    return get_lib() is not None


def decode_batch(paths: Sequence, out_h: int, out_w: int,
                 n_threads: int = 0) -> tuple:
    """Decode+resize paths into one (n, out_h, out_w, 3) uint8 batch with
    ``n_threads`` threads (0: one per core, never more than the paths).

    Returns (batch, ok_mask); failed files have ok=False and zeroed rows
    (the skip-and-continue contract). Each call allocates a fresh batch."""
    global POOL_BATCHES
    lib = get_lib()
    n = len(paths)
    out = np.zeros((n, out_h, out_w, 3), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return out, ok.astype(bool)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode("utf-8") for p in paths])
    lib.emr2a_decode_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out_h, out_w, n_threads,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    with _lock:
        POOL_BATCHES += 1
    return out, ok.astype(bool)


def load_images_batch(paths: Sequence, size: int,
                      n_threads: int = 0) -> tuple:
    """Native-or-fallback batch loader producing a (n, size, size, 3)
    uint8 array + validity mask."""
    if native_available():
        return decode_batch(paths, size, size, n_threads)
    from emr2a_tpu_torch.data.images import load_image_rgb, resize_to
    n = len(paths)
    out = np.zeros((n, size, size, 3), dtype=np.uint8)
    ok = np.zeros(n, dtype=bool)
    for i, p in enumerate(paths):
        arr = load_image_rgb(p)
        if arr is not None:
            out[i] = resize_to(arr, size, shortest_edge=False)
            ok[i] = True
    return out, ok


def resize_rgb_reference(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The pool's resize in plain numpy, with its integer and rounding
    points: a copy at the same size; when both sides shrink, the mean over
    the source box [floor(y * sy), max(y0 + 1, ceil((y + 1) * sy))) (clipped)
    by truncating division; otherwise align-corners bilinear in float64,
    summed in the pool's order, + 0.5 and truncated."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    if out_h <= h and out_w <= w:
        sy, sx = h / out_h, w / out_w

        def bounds(n_out, scale, n_in):
            i = np.arange(n_out, dtype=np.float64)
            lo = np.floor(i * scale).astype(np.int64)
            hi = np.maximum(lo + 1, np.ceil((i + 1) * scale).astype(np.int64))
            return lo, np.minimum(hi, n_in)

        y0, y1 = bounds(out_h, sy, h)
        x0, x1 = bounds(out_w, sx, w)
        integral = np.zeros((h + 1, w + 1, 3), dtype=np.int64)
        integral[1:, 1:] = img.astype(np.int64).cumsum(0).cumsum(1)
        box = (integral[y1][:, x1] - integral[y0][:, x1]
               - integral[y1][:, x0] + integral[y0][:, x0])
        cnt = ((y1 - y0)[:, None] * (x1 - x0)[None, :])[..., None]
        return (box // cnt).astype(np.uint8)
    sy = (h - 1) / max(out_h - 1, 1)
    sx = (w - 1) / max(out_w - 1, 1)
    fy = np.arange(out_h, dtype=np.float64) * sy
    fx = np.arange(out_w, dtype=np.float64) * sx
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    src = img.astype(np.float64)
    v00, v01 = src[y0][:, x0], src[y0][:, x1]
    v10, v11 = src[y1][:, x0], src[y1][:, x1]
    v = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
         + v10 * wy * (1 - wx) + v11 * wy * wx)
    return (v + 0.5).astype(np.uint8)


if __name__ == "__main__":
    print(build())
