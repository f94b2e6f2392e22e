"""Build and load the port's CUDA kernels.

Each source under ``porqua_tpu_torch/csrc`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``. The build runs on first use, never at import,
into ``build/porqua_tpu_torch/`` beside the package; the library's
file name carries a hash of its source and of the headers beside it,
so an edited source or header is rebuilt and an unchanged one is
loaded as it is. :func:`build` compiles several sources at once, one
``nvcc`` each.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "porqua_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict = {}
# name -> {"seconds": build time (0 when a built library was reused),
#          "log": the compiler's output, with ptxas' registers and spills,
#                 kept beside the library and read back on reuse}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the fused "
            "CUDA kernels cannot be built on this machine")
    return path


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    header beside it (``csrc/*.cuh``)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(*names: str) -> None:
    """Build the libraries of ``csrc/<name>.cu`` that are not built yet:
    one ``nvcc`` for each source, all started together, all waited for."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            # Keep what this process's own build recorded, if it made one.
            log = lib.with_suffix(".log")
            build_info.setdefault(name, {"seconds": 0.0, "log": (
                log.read_text() if log.exists() else "reused " + lib.name)})
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc, time.perf_counter()))
    failed = []
    for name, lib, tmp, proc, t0 in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        # Atomic rename: a concurrent build of the same source either
        # finds the finished library or writes its own identical copy.
        os.replace(tmp, lib)
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            build(name)
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        return _loaded[name]
