"""Build the hand-written CUDA kernels at first use and load them.

Each ``src/repro_torch/csrc/<name>.cu`` exports a plain C interface.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by a hash of its source,
of every ``csrc`` header it includes and of the compiler flags, so an
edited kernel or header is never served from a stale build, and loaded
with ``ctypes``.  Nothing is built when the package is imported: the CPU
tests import every module and never reach a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("cache_write", "paged_attention", "selective_scan",
           "flash_attention")
# --split-compile=0: nvcc optimizes a file's kernels in parallel on all the
# host's cores (paged_attention.cu holds about 70 template instances)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (CUDA toolkit needed)")
    return path


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes with
    ``#include "..."``, transitively."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            todo += [CSRC / m.decode()
                     for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc build into a temporary file; returns (proc, tmp, out)
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)           # atomic: concurrent builders agree
    return log


def build_all(names=KERNELS) -> dict:
    """Compile every kernel library that is not built yet, all nvcc
    processes at once.  Returns {name: compiler log} for the ones built
    (ptxas register and shared-memory report included)."""
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, job) for n, job in jobs.items() if job is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes: list):
    """C entry point ``fn_name`` of kernel library ``lib_name``, with its
    argument types declared (every pointer and the stream as c_void_p, so
    ctypes never truncates them) and a C int (cudaError_t) result."""
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
