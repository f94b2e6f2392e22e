"""Dimension-expanding L1 linearizations (host-side numpy; a copy of
``porqua_tpu/qp/lift.py``), in canonical interval form:

* turnover constraint  ||w - w0||_1 <= budget  -> n aux vars t with
  w - t <= w0, -w - t <= -w0, sum(t) <= budget;
* leverage constraint  sum|w_i| <= L  -> 2n aux vars (p, m) with
  w + p - m = 0, sum(p + m) <= L, p, m >= 0;
* turnover transaction-cost objective  tc * ||w - w0||_1  -> n aux vars
  with cost tc each and the same absolute-value rows.

These keep shapes static across rebalance dates (only the right-hand
side x0 varies), so a turnover-coupled backtest can chain its dates
through one problem shape.

All functions take and return a dict with keys
``P, q, C, l, u, lb, ub`` (numpy, unpadded).
"""

from __future__ import annotations

import numpy as np

INF = np.inf


def _as_parts(P, q, C, l, u, lb, ub):
    n = len(q)
    if C is None or C.size == 0:
        C = np.zeros((0, n))
        l = np.zeros((0,))
        u = np.zeros((0,))
    return dict(P=P, q=q, C=C, l=l, u=u, lb=lb, ub=ub)


def lift_turnover_constraint(parts: dict, x_init: np.ndarray, to_budget: float) -> dict:
    """Reference ``linearize_turnover_constraint`` (``qp_problems.py:40-77``)."""
    P, q, C, l, u = parts["P"], parts["q"], parts["C"], parts["l"], parts["u"]
    lb, ub = parts["lb"], parts["ub"]
    n = len(q)
    m = C.shape[0]
    x_init = np.asarray(x_init, dtype=float).reshape(-1)

    P_new = np.zeros((2 * n, 2 * n))
    P_new[:n, :n] = P
    q_new = np.concatenate([q, np.zeros(n)])

    eye = np.eye(n)
    C_new = np.zeros((m + 2 * n + 1, 2 * n))
    C_new[:m, :n] = C
    C_new[m:m + n, :n] = eye
    C_new[m:m + n, n:] = -eye
    C_new[m + n:m + 2 * n, :n] = -eye
    C_new[m + n:m + 2 * n, n:] = -eye
    C_new[m + 2 * n, n:] = 1.0

    l_new = np.concatenate([l, np.full(2 * n + 1, -INF)])
    u_new = np.concatenate([u, x_init, -x_init, [to_budget]])

    lb_new = np.concatenate([lb, np.zeros(n)])
    ub_new = np.concatenate([ub, np.full(n, INF)])
    return dict(P=P_new, q=q_new, C=C_new, l=l_new, u=u_new, lb=lb_new, ub=ub_new)


def lift_leverage_constraint(parts: dict, leverage_budget: float) -> dict:
    """Reference ``linearize_leverage_constraint`` (``qp_problems.py:79-118``),
    with its two latent bugs fixed (SURVEY.md section 2): aux vars p, m >= 0
    split w = m - p so sum(p + m) bounds the leverage."""
    P, q, C, l, u = parts["P"], parts["q"], parts["C"], parts["l"], parts["u"]
    lb, ub = parts["lb"], parts["ub"]
    n = len(q)
    m_rows = C.shape[0]

    P_new = np.zeros((3 * n, 3 * n))
    P_new[:n, :n] = P
    q_new = np.concatenate([q, np.zeros(2 * n)])

    eye = np.eye(n)
    # Equality block: w + p - m = 0
    C_eq = np.concatenate([eye, eye, -eye], axis=1)
    # Leverage row: sum(p + m) <= L
    C_lev = np.concatenate([np.zeros(n), np.ones(2 * n)])[None, :]
    C_orig = np.concatenate([C, np.zeros((m_rows, 2 * n))], axis=1)
    C_new = np.concatenate([C_orig, C_eq, C_lev], axis=0)

    l_new = np.concatenate([l, np.zeros(n), [-INF]])
    u_new = np.concatenate([u, np.zeros(n), [leverage_budget]])

    lb_new = np.concatenate([lb, np.zeros(2 * n)])
    ub_new = np.concatenate([ub, np.full(2 * n, INF)])
    return dict(P=P_new, q=q_new, C=C_new, l=l_new, u=u_new, lb=lb_new, ub=ub_new)


def lift_turnover_objective(parts: dict, x_init: np.ndarray, transaction_cost: float) -> dict:
    """Reference ``linearize_turnover_objective`` (``qp_problems.py:120-157``):
    adds tc * sum(t) to the objective with t >= |w - x0|."""
    P, q, C, l, u = parts["P"], parts["q"], parts["C"], parts["l"], parts["u"]
    lb, ub = parts["lb"], parts["ub"]
    n = len(q)
    m = C.shape[0]
    x_init = np.asarray(x_init, dtype=float).reshape(-1)

    P_new = np.zeros((2 * n, 2 * n))
    P_new[:n, :n] = P
    q_new = np.concatenate([q, np.full(n, transaction_cost)])

    eye = np.eye(n)
    C_new = np.zeros((m + 2 * n, 2 * n))
    C_new[:m, :n] = C
    C_new[m:m + n, :n] = eye
    C_new[m:m + n, n:] = -eye
    C_new[m + n:, :n] = -eye
    C_new[m + n:, n:] = -eye

    l_new = np.concatenate([l, np.full(2 * n, -INF)])
    u_new = np.concatenate([u, x_init, -x_init])

    lb_new = np.concatenate([lb, np.zeros(n)])
    ub_new = np.concatenate([ub, np.full(n, INF)])
    return dict(P=P_new, q=q_new, C=C_new, l=l_new, u=u_new, lb=lb_new, ub=ub_new)
