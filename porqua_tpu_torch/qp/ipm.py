"""Dense primal-dual interior-point QP solver (host-side, float64).

An *algorithmically independent* high-accuracy reference for the
cross-solver harness (:mod:`porqua_tpu_torch.compare`). The device
solver, its CUDA segment kernels, and the native C++ core all implement
the same OSQP-style ADMM splitting, so agreement among them could in
principle share a bug; this module solves the same QPs by a completely different
method — a Mehrotra predictor-corrector interior point, the family the
reference's default backend (cvxopt, ``src/optimization.py:45``)
belongs to — giving the parity tables a genuinely independent column.

Pure numpy, deliberately: this is a correctness oracle, not a device
path. Problems arrive in the canonical interval form and are expanded
to the standard IPM shape

    min 1/2 x'Px + q'x   s.t.  A x = b,  G x <= h

with box bounds and finite interval sides folded into G.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

_EQ_TOL = 1e-9


class IPMSolution(NamedTuple):
    x: np.ndarray
    y: np.ndarray            # equality multipliers
    z: np.ndarray            # inequality multipliers (>= 0)
    found: bool
    iters: int
    mu: float                # final complementarity
    prim_res: float
    dual_res: float


def _standard_form(parts: dict):
    """Interval rows + box -> (A, b, G, h); infinite sides dropped."""
    C, l, u = parts["C"], parts["l"], parts["u"]
    lb, ub = parts["lb"], parts["ub"]
    n = len(parts["q"])

    eq = (u - l) <= _EQ_TOL if C.size else np.zeros(0, bool)
    A = C[eq] if C.size and eq.any() else np.zeros((0, n))
    b = u[eq] if C.size and eq.any() else np.zeros(0)

    G_blocks, h_blocks = [], []
    if C.size and (~eq).any():
        Ci, li, ui = C[~eq], l[~eq], u[~eq]
        hi_ok, lo_ok = np.isfinite(ui), np.isfinite(li)
        if hi_ok.any():
            G_blocks.append(Ci[hi_ok])
            h_blocks.append(ui[hi_ok])
        if lo_ok.any():
            G_blocks.append(-Ci[lo_ok])
            h_blocks.append(-li[lo_ok])
    eye = np.eye(n)
    ub_ok, lb_ok = np.isfinite(ub), np.isfinite(lb)
    if ub_ok.any():
        G_blocks.append(eye[ub_ok])
        h_blocks.append(ub[ub_ok])
    if lb_ok.any():
        G_blocks.append(-eye[lb_ok])
        h_blocks.append(-lb[lb_ok])

    G = np.concatenate(G_blocks) if G_blocks else np.zeros((0, n))
    h = np.concatenate(h_blocks) if h_blocks else np.zeros(0)
    return A, b, G, h


def solve_ipm(parts: dict,
              tol: float = 1e-10,
              max_iter: int = 60) -> IPMSolution:
    """Mehrotra predictor-corrector on the QP KKT system.

    Each iteration eliminates the slack/multiplier pair into the
    condensed system ``[P + G'(z/s)G, A'; A, 0]`` and takes an affine
    (predictor) step to pick the centering weight, then a corrected
    step. Converges quadratically near the solution; 20-40 iterations
    reach mu ~ 1e-12 on the portfolio problems in the suite.
    """
    P = np.asarray(parts["P"], np.float64)
    q = np.asarray(parts["q"], np.float64)
    A, b, G, h = _standard_form(parts)
    n, me, mi = len(q), len(b), len(h)

    # Strictly feasible-ish start: centered x, unit slacks/multipliers.
    x = np.zeros(n)
    if np.isfinite(parts["lb"]).all() and np.isfinite(parts["ub"]).all():
        x = 0.5 * (parts["lb"] + parts["ub"])
    y = np.zeros(me)
    s = np.maximum(h - G @ x, 1.0) if mi else np.zeros(0)
    z = np.ones(mi)

    def residuals(x, y, s, z):
        r_d = P @ x + q + (A.T @ y if me else 0.0) + (G.T @ z if mi else 0.0)
        r_e = (A @ x - b) if me else np.zeros(0)
        r_i = (G @ x + s - h) if mi else np.zeros(0)
        return r_d, r_e, r_i

    def kkt_solve(w, r1, r2):
        """Solve [P + G' diag(w) G, A'; A, 0] [dx, dy] = [r1, r2]."""
        H = P + (G.T * w) @ G if mi else P.copy()
        H[np.diag_indices_from(H)] += 1e-12  # keep factorizable at mu->0
        if me:
            K = np.block([[H, A.T], [A, np.zeros((me, me))]])
            sol = np.linalg.solve(K, np.concatenate([r1, r2]))
            return sol[:n], sol[n:]
        return np.linalg.solve(H, r1), np.zeros(0)

    def max_step(v, dv):
        """Largest alpha in (0, 1] keeping v + alpha dv > 0."""
        shrink = dv < 0
        if not shrink.any():
            return 1.0
        return min(1.0, float(np.min(-v[shrink] / dv[shrink])))

    found = False
    it = 0
    for it in range(1, max_iter + 1):
        r_d, r_e, r_i = residuals(x, y, s, z)
        mu = float(s @ z / mi) if mi else 0.0
        prim = max(np.abs(r_e).max() if me else 0.0,
                   np.abs(r_i).max() if mi else 0.0)
        dual = np.abs(r_d).max() if n else 0.0
        if prim < tol and dual < tol and mu < tol:
            found = True
            break

        # Condensed Newton step: substituting ds = -r_i - G dx and
        # dz = (z/s) G dx + (z .* r_i - rc)/s into the dual equation
        # gives  [P + G'(z/s)G] dx + A' dy = -r_d + G'[(rc - z .* r_i)/s]
        # where rc is the complementarity residual of the step (s .* z
        # for the predictor; Mehrotra-corrected for the final step).
        def direction(rc):
            if mi:
                r1 = -r_d + G.T @ ((rc - z * r_i) / s)
            else:
                r1 = -r_d
            dx, dy = kkt_solve(z / s if mi else None, r1, -r_e)
            if mi:
                ds = -r_i - G @ dx
                dz = -(rc + z * ds) / s
            else:
                ds = dz = np.zeros(0)
            return dx, dy, ds, dz

        dx_a, dy_a, ds_a, dz_a = direction(s * z)
        if mi:
            # One step length for ALL variables: with P != 0 the dual
            # residual couples x and z, so the LP-style split
            # primal/dual steps destroy the Newton decrement and the
            # iteration oscillates.
            a_aff = min(max_step(s, ds_a), max_step(z, dz_a))
            mu_aff = float((s + a_aff * ds_a) @ (z + a_aff * dz_a) / mi)
            sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0
            rc = s * z + ds_a * dz_a - sigma * mu
            dx, dy, ds, dz = direction(rc)
            alpha = 0.995 * min(max_step(s, ds), max_step(z, dz))
        else:
            dx, dy, ds, dz = dx_a, dy_a, ds_a, dz_a
            alpha = 1.0

        x = x + alpha * dx
        y = y + alpha * dy
        if mi:
            s = s + alpha * ds
            z = z + alpha * dz

    r_d, r_e, r_i = residuals(x, y, s, z)
    return IPMSolution(
        x=x, y=y, z=z, found=found, iters=it,
        mu=float(s @ z / mi) if mi else 0.0,
        prim_res=float(max(np.abs(r_e).max() if me else 0.0,
                           np.abs(np.maximum(G @ x - h, 0.0)).max()
                           if mi else 0.0)),
        dual_res=float(np.abs(r_d).max() if n else 0.0),
    )


def dual_for_canonical(parts: dict, sol: IPMSolution):
    """Map the (y, z) multipliers back onto the canonical interval rows
    and box, so the harness can compute a dual residual uniformly.

    Returns ``(y_rows, mu_box)`` matching the layout of ``parts['C']``
    rows and the n box constraints.
    """
    C, l, u = parts["C"], parts["l"], parts["u"]
    lb, ub = parts["lb"], parts["ub"]
    n = len(parts["q"])
    m = C.shape[0] if C.size else 0

    y_rows = np.zeros(m)
    mu_box = np.zeros(n)
    eq = (u - l) <= _EQ_TOL if m else np.zeros(0, bool)
    y_rows[eq] = sol.y[: eq.sum()] if eq.any() else y_rows[eq]

    k = 0
    if m and (~eq).any():
        idx = np.flatnonzero(~eq)
        ui, li = u[~eq], l[~eq]
        hi_ok, lo_ok = np.isfinite(ui), np.isfinite(li)
        nh = int(hi_ok.sum())
        y_rows[idx[hi_ok]] += sol.z[k:k + nh]
        k += nh
        nl = int(lo_ok.sum())
        y_rows[idx[lo_ok]] -= sol.z[k:k + nl]
        k += nl
    ub_ok, lb_ok = np.isfinite(ub), np.isfinite(lb)
    nu = int(ub_ok.sum())
    mu_box[ub_ok] += sol.z[k:k + nu]
    k += nu
    nl = int(lb_ok.sum())
    mu_box[lb_ok] -= sol.z[k:k + nl]
    return y_rows, mu_box
