"""Cross-solver validation harness.

Automated port of the reference's de-facto correctness harness
(reference ``example/compare_solver.ipynb`` cells 6/8/12): run the
*same* problem through every available solver backend and tabulate

* accuracy — objective value at the solution found,
* reliability — primal residual
  ``max(||Ax-b||_inf, [Gx-h]+, [lb-x]+, [x-ub]+)``, dual residual
  ``||Px + q + C'y + mu||_inf``, duality gap, and the per-constraint
  residuals ``max|Ax-b|`` / ``max(Gx-h)``,
* runtime.

Where the reference compares qpsolvers' C backends against each other,
this harness compares the device ADMM solver (f32 and f64, on the card
unless a ``device`` is named) against the native C++ ADMM core, the f64
interior-point oracle and a scipy reference — all metrics recomputed
uniformly from the returned primal/dual vectors against the original
problem data, never trusting a backend's self-reported residuals.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.utils.helpers import to_numpy

_EQ_TOL = 1e-9  # rows with u - l below this are equalities


def _numpy_parts(qp: CanonicalQP) -> dict:
    """Unpadded float64 views of a single canonical problem (no batch
    axis)."""
    vm = to_numpy(qp.var_mask).astype(bool)
    rm = to_numpy(qp.row_mask).astype(bool)
    f64 = lambda t: to_numpy(t).astype(np.float64)
    return {
        "P": f64(qp.P)[np.ix_(vm, vm)],
        "q": f64(qp.q)[vm],
        "C": f64(qp.C)[np.ix_(rm, vm)],
        "l": f64(qp.l)[rm],
        "u": f64(qp.u)[rm],
        "lb": f64(qp.lb)[vm],
        "ub": f64(qp.ub)[vm],
        "constant": float(to_numpy(qp.constant)),
    }


def solution_metrics(parts: dict,
                     x: np.ndarray,
                     y: Optional[np.ndarray] = None,
                     mu: Optional[np.ndarray] = None) -> dict:
    """The notebook cell-8 metric set, recomputed from first principles."""
    P, q, C = parts["P"], parts["q"], parts["C"]
    l, u, lb, ub = parts["l"], parts["u"], parts["lb"], parts["ub"]
    x = np.asarray(x, np.float64)
    Cx = C @ x if C.size else np.zeros(0)

    eq = (u - l) <= _EQ_TOL
    res_eq = np.abs(Cx[eq] - u[eq]) if eq.any() else np.zeros(0)
    viol_hi = np.maximum(Cx - u, 0.0)
    viol_lo = np.maximum(l - Cx, 0.0)
    box_lo = np.maximum(lb - x, 0.0)
    box_hi = np.maximum(x - ub, 0.0)
    prim = max(
        res_eq.max() if res_eq.size else 0.0,
        viol_hi.max() if viol_hi.size else 0.0,
        viol_lo.max() if viol_lo.size else 0.0,
        box_lo.max() if box_lo.size else 0.0,
        box_hi.max() if box_hi.size else 0.0,
    )

    out = {
        "objective_value": float(0.5 * x @ P @ x + q @ x + parts["constant"]),
        "primal_residual": float(prim),
        "max_residual_Ab": float(res_eq.max()) if res_eq.size else 0.0,
        "max_residual_Gh": float(np.maximum(viol_hi, viol_lo)[~eq].max())
        if (~eq).any() else 0.0,
    }
    if y is not None and mu is not None:
        y = np.asarray(y, np.float64)
        mu = np.asarray(mu, np.float64)
        stat = P @ x + q + (C.T @ y if C.size else 0.0) + mu
        out["dual_residual"] = float(np.abs(stat).max()) if stat.size else 0.0

        def support(upper, lower, dual):
            # inf-aware (the form of qp.admm._support): a dual pushing
            # against an infinite bound means an unbounded dual
            # objective -> gap = inf, not silently zero
            pos = np.maximum(dual, 0.0)
            neg = np.minimum(dual, 0.0)
            up = np.sum(np.where(pos > 0, upper * pos, 0.0))
            lo = np.sum(np.where(neg < 0, lower * neg, 0.0))
            return float(up + lo)

        gap = (x @ P @ x + q @ x + support(u, l, y) + support(ub, lb, mu))
        out["duality_gap"] = float(abs(gap))
    else:
        out["dual_residual"] = np.nan
        out["duality_gap"] = np.nan
    return out


# ---------------------------------------------------------------------------
# Backends: name -> callable(parts, params) -> (x, y, mu, found)
# ---------------------------------------------------------------------------

def _backend_device(dtype, device=None):
    def run(parts, params):
        from porqua_tpu_torch.qp.solve import resolve_device, solve_qp

        dev = resolve_device(device)
        if dtype == torch.float32:
            # f32's residual floor is ~1e-6; below that the stopping test
            # can never fire even when the polished solution is exact.
            # Metrics are recomputed uniformly in f64 afterwards, so this
            # only affects the backend's own found/iteration behavior.
            params = dataclasses.replace(
                params,
                eps_abs=max(params.eps_abs, 3e-6),
                eps_rel=max(params.eps_rel, 3e-6),
            )
        qp = CanonicalQP.build(
            parts["P"], parts["q"], parts["C"], parts["l"], parts["u"],
            parts["lb"], parts["ub"], constant=parts["constant"],
            dtype=dtype, device=dev)
        sol = solve_qp(qp, params, device=dev)
        return (to_numpy(sol.x).astype(np.float64),
                to_numpy(sol.y).astype(np.float64),
                to_numpy(sol.mu).astype(np.float64), bool(sol.found))
    return run


def _backend_native(parts, params):
    from porqua_tpu_torch.native import solve_qp_native

    sol = solve_qp_native(
        parts["P"], parts["q"], parts["C"], parts["l"], parts["u"],
        parts["lb"], parts["ub"],
        eps_abs=params.eps_abs, eps_rel=params.eps_rel,
        max_iter=params.max_iter)
    return sol.x, sol.y, sol.mu, bool(sol.status == 1)


def _backend_scipy(parts, params):
    import scipy.optimize

    P, q, C = parts["P"], parts["q"], parts["C"]
    l, u = parts["l"], parts["u"]
    n = len(q)
    cons = []
    if C.size:
        eq = (u - l) <= _EQ_TOL
        if eq.any():
            A = C[eq]
            cons.append({"type": "eq", "fun": lambda x, A=A, b=u[eq]: A @ x - b,
                         "jac": lambda x, A=A: A})
        ineq = ~eq
        if ineq.any():
            G, lo, hi = C[ineq], l[ineq], u[ineq]
            fin_hi = np.isfinite(hi)
            if fin_hi.any():
                cons.append({"type": "ineq",
                             "fun": lambda x, G=G[fin_hi], h=hi[fin_hi]: h - G @ x,
                             "jac": lambda x, G=G[fin_hi]: -G})
            fin_lo = np.isfinite(lo)
            if fin_lo.any():
                cons.append({"type": "ineq",
                             "fun": lambda x, G=G[fin_lo], h=lo[fin_lo]: G @ x - h,
                             "jac": lambda x, G=G[fin_lo]: G})
    res = scipy.optimize.minimize(
        lambda x: 0.5 * x @ P @ x + q @ x,
        jac=lambda x: P @ x + q,
        x0=np.full(n, 1.0 / max(n, 1)),
        bounds=list(zip(
            np.where(np.isfinite(parts["lb"]), parts["lb"], None),
            np.where(np.isfinite(parts["ub"]), parts["ub"], None))),
        constraints=cons,
        method="SLSQP",
        options={"maxiter": 500, "ftol": 1e-12},
    )
    return res.x, None, None, bool(res.success)


def _backend_ipm(parts, params):
    """Algorithmically independent high-accuracy reference: dense f64
    Mehrotra predictor-corrector interior point (the method family of
    the reference's default cvxopt backend) — see
    :mod:`porqua_tpu_torch.qp.ipm`. The ADMM implementations (device,
    CUDA kernels, C++) share one algorithm and could share a bug; this
    one cannot."""
    from porqua_tpu_torch.qp.ipm import dual_for_canonical, solve_ipm

    sol = solve_ipm(parts, tol=max(params.eps_abs * 1e-4, 1e-12))
    y_rows, mu_box = dual_for_canonical(parts, sol)
    return sol.x, y_rows, mu_box, sol.found


def _backend_qpsolvers(name):
    def run(parts, params):
        import qpsolvers

        eq = (parts["u"] - parts["l"]) <= _EQ_TOL
        A = parts["C"][eq] if eq.any() else None
        b = parts["u"][eq] if eq.any() else None
        # interval rows l <= Cx <= u become one-sided pairs
        # Cx <= u (finite u) and -Cx <= -l (finite l)
        G_rows, h_rows = [], []
        if (~eq).any():
            C_in, lo, hi = parts["C"][~eq], parts["l"][~eq], parts["u"][~eq]
            fin_hi, fin_lo = np.isfinite(hi), np.isfinite(lo)
            if fin_hi.any():
                G_rows.append(C_in[fin_hi])
                h_rows.append(hi[fin_hi])
            if fin_lo.any():
                G_rows.append(-C_in[fin_lo])
                h_rows.append(-lo[fin_lo])
        G = np.concatenate(G_rows) if G_rows else None
        h = np.concatenate(h_rows) if h_rows else None
        x = qpsolvers.solve_qp(
            parts["P"], parts["q"], G=G, h=h, A=A, b=b,
            lb=parts["lb"], ub=parts["ub"], solver=name)
        return x, None, None, x is not None
    return run


def available_backends(device=None) -> Dict[str, Callable]:
    """Backends runnable in this environment, discovery-ordered.

    The device rows solve on ``device`` (default: the card, resolved
    when a row runs). The f64 device row is always present: PyTorch
    runs float64 wherever it is asked to, so there is no counterpart of
    the JAX package's ``jax_enable_x64`` switch that hides it. The
    native row is present where ``g++`` builds the C++ core; the
    ``qpsolvers-*`` rows where that package is installed.
    """
    backends: Dict[str, Callable] = {
        "device-admm-f32": _backend_device(torch.float32, device),
        "device-admm-f64": _backend_device(torch.float64, device),
        "scipy-slsqp": _backend_scipy,
        "ipm-f64": _backend_ipm,
    }
    try:
        from porqua_tpu_torch.native import build_library

        build_library()
        backends["native-cpp-admm"] = _backend_native
    except Exception:
        pass
    try:
        import qpsolvers

        for name in qpsolvers.available_solvers:
            backends[f"qpsolvers-{name}"] = _backend_qpsolvers(name)
    except ImportError:
        pass
    return backends


def compare_solvers(qp: CanonicalQP,
                    params=None,
                    solvers: Optional[Sequence[str]] = None,
                    device=None) -> pd.DataFrame:
    """Run one problem (no batch axis) through every (selected)
    backend; tabulate metrics. The device rows run on ``device``
    (default: the card).

    Returns a DataFrame indexed by solver name with the notebook's
    columns: solution_found, objective_value, primal_residual,
    dual_residual, duality_gap, max_residual_Ab, max_residual_Gh,
    runtime. Failures are recorded (found=False, NaN metrics, the
    exception in an ``error`` column), never raised — matching the
    notebook's keep-going loop. An unknown solver name raises
    ``KeyError``.
    """
    from porqua_tpu_torch.qp.solve import SolverParams

    if params is None:
        params = SolverParams(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000)
    parts = _numpy_parts(qp)
    registry = available_backends(device)
    if solvers is not None:
        unknown = set(solvers) - set(registry)
        if unknown:
            raise KeyError(f"unknown solvers {sorted(unknown)}; "
                           f"available: {sorted(registry)}")
        registry = {k: registry[k] for k in solvers}

    rows = {}
    for name, run in registry.items():
        row = {"solution_found": False, "runtime": np.nan}
        try:
            run(parts, params)  # warm-up: kernel build, library load
            t0 = time.perf_counter()
            x, y, mu, found = run(parts, params)
            row["runtime"] = time.perf_counter() - t0
            row["solution_found"] = found
            if x is not None:
                row.update(solution_metrics(parts, x, y, mu))
        except Exception as exc:  # keep-going, like the notebook loop
            row["error"] = f"{type(exc).__name__}: {exc}"
        rows[name] = row
    df = pd.DataFrame.from_dict(rows, orient="index")
    front = ["solution_found", "objective_value", "primal_residual",
             "dual_residual", "duality_gap", "max_residual_Ab",
             "max_residual_Gh", "runtime"]
    cols = [c for c in front if c in df.columns] + [
        c for c in df.columns if c not in front]
    return df[cols]
