"""Host-side decoding of the on-device convergence rings (the port of
``porqua_tpu/obs/rings.py``).

With ``SolverParams(ring_size=K)`` every backend's segment loop writes
``(prim_res, dual_res, third)`` into a K-slot circular buffer per lane
at every residual check, on the device with no host read (the third
ring is rho for ADMM and the cumulative restart count for PDHG and
NAPG). Segment ``j`` (0-based) writes slot ``j % K``, so once a solve
runs more than K segments the ring holds the last K checks. This
module rebuilds the chronological trajectory from the rings and the
iteration count.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def _host(a):
    """A numpy array of a tensor (on any device) or array-like."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def ring_history(ring_prim, ring_dual, ring_rho, iters: int,
                 check_interval: int) -> Dict[str, Any]:
    """Decode one problem's rings into a chronological trajectory:
    ``{"iters", "prim_res", "dual_res", "rho"}`` lists, ``iters[j]``
    the iteration count at the end of sample ``j``'s segment. When the
    solve ran more than ``ring_size`` segments only the trailing window
    survives."""
    prim, dual, rho = _host(ring_prim), _host(ring_dual), _host(ring_rho)
    ring_size = int(prim.shape[-1])
    segments = int(iters) // int(check_interval)
    k = min(segments, ring_size)
    start = segments - k  # first surviving segment index
    idx = [(start + j) % ring_size for j in range(k)]
    return {
        "iters": [(start + j + 1) * int(check_interval) for j in range(k)],
        "prim_res": [float(prim[i]) for i in idx],
        "dual_res": [float(dual[i]) for i in idx],
        "rho": [float(rho[i]) for i in idx],
    }


def solution_ring_history(solution, check_interval: int,
                          index: Optional[int] = None) -> Optional[Dict]:
    """Decode the rings of a :class:`porqua_tpu_torch.qp.solve.QPSolution`;
    ``index`` selects one problem of a batched solution, ``None`` an
    unbatched one. ``None`` when the solve ran without rings."""
    rp = getattr(solution, "ring_prim", None)
    if rp is None:
        return None
    rd, rr = solution.ring_dual, solution.ring_rho
    iters = _host(solution.iters)
    if index is not None:
        rp, rd, rr = rp[index], rd[index], rr[index]
        iters = iters[index]
    return ring_history(rp, rd, rr, int(iters), check_interval)
