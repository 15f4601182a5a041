"""Build the port's CUDA kernels from ``kernels/csrc`` and load them.

Each ``.cu`` source becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with ``ctypes``.
Libraries go to ``build/repro_torch_kernels/`` at the repository root,
named by a hash of the source and the flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.  A failed build raises;
nothing falls back to the plain versions.

Nothing is compiled at import: the first kernel launch builds its library,
and :func:`build_all` builds every source at once, one ``nvcc`` each, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SOURCES", "build_all", "check", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
#: source name -> its C entry points as (name, argtypes)
SOURCES = {
    "quant": (
        ("repro_gather_quant", [ctypes.c_void_p] * 6
         + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]),
        ("repro_stoch_quant", [ctypes.c_void_p] * 4
         + [ctypes.c_int64, ctypes.c_void_p]),
    ),
    "votes": (
        ("repro_pack", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_void_p]),
        ("repro_vote_pack", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]),
        ("repro_unpack", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                          ctypes.c_int64, ctypes.c_void_p]),
        ("repro_popcount", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]),
    ),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Launch nvcc for one source; None when its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> float:
    """Wait for nvcc and install the library; returns compile seconds."""
    if started is None:
        return 0.0
    proc, tmp, out, t0 = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):"
                           f"\n{stdout}\n{stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file
    return time.perf_counter() - t0


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SOURCES[name]:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all() -> dict[str, float]:
    """Compile every source that is not built yet, in parallel, and load
    them all.  Returns the compile seconds per source (0.0 when cached)."""
    seconds = {n: 0.0 for n in SOURCES}
    with _lock:
        todo = [n for n in SOURCES if n not in _loaded]
        started = {n: _start(n) for n in todo}
        for n in todo:
            seconds[n] = _finish(n, started[n])
            _loaded[n] = _load(n)
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            if name not in _loaded:
                _finish(name, _start(name))
                _loaded[name] = _load(name)
            lib = _loaded[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")
