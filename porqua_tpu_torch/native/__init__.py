"""Native C++ QP solver: build and ctypes binding.

The counterpart of the compiled solver backends the reference reaches
through ``qpsolvers`` (reference ``src/qp_problems.py:211``). The C++
core (``qp_solver.cpp``, this package's own copy) runs the same ADMM
splitting as the device solver, serially, one problem per call — the
reference's execution model — which makes it both the serial CPU
baseline and an independent implementation for cross-checking the
device solver (:mod:`porqua_tpu_torch.compare`).

The shared library is built with ``g++`` on first use, never at import,
into ``build/porqua_tpu_torch/`` beside the package (as the CUDA
kernels are, ``ops/_build.py``). Its file name carries a hash of the
source, the flags and the machine's architecture, so an edited source
is rebuilt and a checkout copied to another architecture never loads a
foreign binary. The flags name no ``-march``: the portable build does
the same floating-point operations on every host of an architecture
(no fused multiply-add contraction), so a solve on the card's host
reproduces one made here. ``ctypes`` provides the binding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "qp_solver.cpp"
BUILD_DIR = _DIR.parent.parent / "build" / "porqua_tpu_torch"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _library_name() -> str:
    """The library's file name: a hash of the source, the flags and the
    machine's architecture."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(platform.machine().encode())
    return f"libporqua_qp-{digest.hexdigest()[:16]}.so"


def build_library(force: bool = False) -> str:
    """Compile ``qp_solver.cpp`` to a shared library, unless a library
    of the same name is already built; returns its path.

    The compile writes a temporary file that is renamed into place: the
    in-process lock cannot serialize other processes (several test
    workers, or a job array, building at once), and loading a
    half-written library is a segfault."""
    so = BUILD_DIR / _library_name()
    with _lock:
        if force or not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.build-{os.getpid()}")
            try:
                subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if tmp.exists():
                    tmp.unlink()
    return str(so)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        fn = lib.porqua_solve_qp
        d = ctypes.POINTER(ctypes.c_double)
        fn.restype = ctypes.c_int32
        fn.argtypes = [d, d, d, d, d, d, d,
                       ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_double, ctypes.c_double,
                       ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_double, ctypes.c_double,
                       ctypes.c_double, ctypes.c_double,
                       d, d, d, d]
        _lib = lib
    return _lib


class NativeSolution(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    mu: np.ndarray
    status: int          # porqua_tpu_torch.qp.admm.Status codes
    iters: int
    prim_res: float
    dual_res: float
    obj_val: float


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def solve_qp_native(P: np.ndarray,
                    q: np.ndarray,
                    C: Optional[np.ndarray] = None,
                    l: Optional[np.ndarray] = None,
                    u: Optional[np.ndarray] = None,
                    lb: Optional[np.ndarray] = None,
                    ub: Optional[np.ndarray] = None,
                    eps_abs: float = 1e-8,
                    eps_rel: float = 1e-8,
                    max_iter: int = 20000,
                    check_interval: int = 25,
                    rho0: float = 0.1,
                    rho_eq_scale: float = 1e3,
                    sigma: float = 1e-6,
                    alpha: float = 1.6) -> NativeSolution:
    """Solve one dense QP with the C++ ADMM core (float64, numpy in and
    out).

    ``rho_eq_scale`` keeps the OSQP-style 1e3 default of the serial
    baseline, where the device solver's default is 1.0
    (``qp/admm.py``): on the tracking workloads the native core
    converges identically at both values, so baseline numbers stay
    comparable.
    """
    q = np.ascontiguousarray(q, dtype=np.float64).reshape(-1)
    n = q.shape[0]
    P = np.ascontiguousarray(P, dtype=np.float64).reshape(n, n)
    if C is None or np.size(C) == 0:
        C = np.zeros((0, n))
        l = np.zeros(0)
        u = np.zeros(0)
    C = np.ascontiguousarray(C, dtype=np.float64).reshape(-1, n)
    m = C.shape[0]
    l = np.ascontiguousarray(l, dtype=np.float64).reshape(-1)
    u = np.ascontiguousarray(u, dtype=np.float64).reshape(-1)
    if l.shape[0] != m or u.shape[0] != m:
        raise ValueError(
            f"l/u must have one entry per constraint row: m={m}, "
            f"got l={l.shape[0]}, u={u.shape[0]}"
        )
    # Scalars broadcast to the full box (raw pointers cross the ABI —
    # lengths must be exact).
    lb = (np.full(n, -np.inf) if lb is None
          else np.ascontiguousarray(np.broadcast_to(lb, (n,)), dtype=np.float64))
    ub = (np.full(n, np.inf) if ub is None
          else np.ascontiguousarray(np.broadcast_to(ub, (n,)), dtype=np.float64))

    # A non-positive interval would never advance the C loop counter
    # (the GIL is released inside the call — an uninterruptible hang).
    check_interval = max(1, int(check_interval))

    out_x = np.empty(n)
    out_y = np.empty(max(m, 1))
    out_mu = np.empty(n)
    out_info = np.empty(4)

    status = _load().porqua_solve_qp(
        _ptr(P), _ptr(q), _ptr(C), _ptr(l), _ptr(u), _ptr(lb), _ptr(ub),
        n, m, eps_abs, eps_rel, max_iter, check_interval,
        rho0, rho_eq_scale, sigma, alpha,
        _ptr(out_x), _ptr(out_y), _ptr(out_mu), _ptr(out_info),
    )
    return NativeSolution(
        x=out_x, y=out_y[:m], mu=out_mu,
        status=int(status),
        iters=int(out_info[0]),
        prim_res=float(out_info[1]),
        dual_res=float(out_info[2]),
        obj_val=float(out_info[3]),
    )
