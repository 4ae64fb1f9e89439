"""Build and load the port's hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``.  The build happens at the first CUDA use of a kernel
(or an explicit :func:`build`), never at import, into
``paddle_tpu_torch/csrc/build/`` (listed in ``.gitignore``).  All
sources build in parallel: one ``nvcc`` process per source, started
together.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "build", "build_log", "check",
           "kernel"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("paged_attention", "flash_mask", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_log: dict[str, str] = {}      # source name -> nvcc/ptxas output
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels build on a machine with "
            "the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(names=SOURCES) -> float:
    """Compile the named sources, all ``nvcc`` processes at once.
    Returns the wall seconds; raises with the compiler output on any
    failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode:
            errors.append(f"{name}.cu: nvcc exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def kernel(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` as a ctypes function
    returning an int ``cudaError_t``; builds the library on first use
    (or when its source is newer than the built file).  Wrappers call
    this once and keep the function, so a launch costs only the call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            src = CSRC / f"{name}.cu"
            if (not path.exists()
                    or path.stat().st_mtime < src.stat().st_mtime):
                build((name,))
            lib = _libs[name] = ctypes.CDLL(str(path))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int, what: str):
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = getattr(_libs[name], f"{name}_error_string")(err)
        raise RuntimeError(
            f"{what}: CUDA error {err} ({msg.decode(errors='replace')})")
