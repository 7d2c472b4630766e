"""Build and load the port's CUDA kernel library.

The sources under ``emr2a_tpu_torch/csrc`` are compiled once, at first use,
with ``nvcc`` for ``sm_90a``: one ``nvcc`` per ``.cu`` file, all started
together, then one link into a shared library with a plain C interface,
which is loaded with ``ctypes``. The library's name carries a
hash of the sources and flags, so an edit rebuilds it. Nothing here runs at
import time: the package imports, and its CPU tests run, where there is no
``nvcc`` and no card.

    python -m emr2a_tpu_torch.ops._build      # build now, print the path
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels need the CUDA toolkit to build")


def library_path() -> Path:
    return BUILD_DIR / f"libemr2a_kernels_{source_digest()}.so"


def build() -> Path:
    """Compile the kernel library if this version of the sources has not
    been built yet; return its path. Raises with nvcc's output on failure.
    nvcc's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for cu in sorted(CSRC_DIR.glob("*.cu")):
            obj = Path(tmp) / f"{cu.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj),
                   str(cu)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, _, proc in jobs:
            text = proc.communicate()[0]
            log.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                for _, _, other in jobs:
                    other.communicate()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-1]}")
        lib = Path(tmp) / out.name
        cmd = [nvcc, "-shared", "-o", str(lib), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text("".join(log))
        os.replace(lib, out)
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        import ctypes
        _lib = ctypes.CDLL(str(build()))
    return _lib


def kernel_function(name: str, argtypes: list):
    """One C entry point of the library with its ctypes signature set;
    every entry point returns a ``cudaError_t`` as int."""
    import ctypes
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        import ctypes
        fn = library().emr2a_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()})")


if __name__ == "__main__":
    print(build())
