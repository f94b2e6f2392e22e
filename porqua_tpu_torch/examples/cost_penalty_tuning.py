"""Tune the optimizer's turnover-penalty knob by gradient descent.

The port's twin of the JAX package's ``examples/cost_penalty_tuning.py``.
A cost-aware strategy solves  min ‖Xw − y‖² + λ·‖w − w_prev‖₁, but the
right λ is NOT the market's transaction cost: it is a churn-control
knob whose best value depends on signal stability, and the reference
can only grid-search it with a full backtest per point. Here the
lifted form of the L1 term (reference ``qp_problems.py:120-157``,
``porqua_tpu_torch/qp/lift.py``) is an ordinary QP in 2n variables
whose ``q`` carries λ, so realized NET performance (out-of-sample
tracking error + actual costs paid on turnover) is differentiable in λ
through the solver (``porqua_tpu_torch.qp.diff``), and the knob tunes
itself. The native n-variable prox path (``solve_qp_l1_diff``) must
give the same gradient.

    python -m porqua_tpu_torch.examples.cost_penalty_tuning [--device cpu]
"""

import numpy as np
import torch

from porqua_tpu_torch.examples._common import parse_device

REAL_TC = 0.003          # the market's actual cost per unit turnover
N, T, B = 16, 40, 8
GRID = (-5.0, -4.0, -3.0, -2.5, -2.0, -1.5, -1.0)


def solver_params():
    from porqua_tpu_torch.qp.solve import SolverParams

    return SolverParams(max_iter=20000, eps_abs=1e-10, eps_rel=1e-10)


def make_data(seed=11):
    """w_prev, and the fit and evaluation windows (numpy)."""
    rng = np.random.default_rng(seed)
    w_prev = rng.dirichlet(np.ones(N))
    w_true = rng.dirichlet(np.ones(N))
    Xs = rng.standard_normal((B, 2 * T, N)) * 0.01
    ys = Xs @ w_true + rng.standard_normal((B, 2 * T)) * 0.002
    return w_prev, Xs[:, :T], ys[:, :T], Xs[:, T:], ys[:, T:]


def lifted_tracking_qp(X, y, w_prev, lam):
    """The reference's turnover-cost lift over a batch of windows ``X``
    (B, T, n): variables [w, t], objective ‖Xw−y‖² + λ Σt, rows t >=
    |w − w_prev|; a plain QP, so the solve is differentiable in λ (via
    q) and w_prev (via the row bounds)."""
    from porqua_tpu_torch import CanonicalQP

    Bn, _, n = X.shape
    dt, dev = X.dtype, X.device
    inf = float("inf")
    full = lambda shape, v: torch.full(shape, v, dtype=dt, device=dev)
    P = torch.zeros((Bn, 2 * n, 2 * n), dtype=dt, device=dev)
    P[:, :n, :n] = 2.0 * X.transpose(1, 2) @ X
    lam = torch.as_tensor(lam, dtype=dt, device=dev)
    q = torch.cat([-2.0 * torch.einsum("btn,bt->bn", X, y),
                   lam * full((Bn, n), 1.0)], dim=-1)
    eye = torch.eye(n, dtype=dt, device=dev)
    zero = torch.zeros((1, n), dtype=dt, device=dev)
    C = torch.cat([
        torch.cat([full((1, n), 1.0), zero], dim=1),
        torch.cat([eye, -eye], dim=1),      # w - t <=  w_prev
        torch.cat([-eye, -eye], dim=1),     # -w - t <= -w_prev
    ], dim=0).expand(Bn, 1 + 2 * n, 2 * n)
    l = torch.cat([full((Bn, 1), 1.0), full((Bn, 2 * n), -inf)], dim=-1)
    wp = w_prev.expand(Bn, n)
    u = torch.cat([full((Bn, 1), 1.0), wp, -wp], dim=-1)
    return CanonicalQP(
        P=P, q=q, C=C, l=l, u=u,
        lb=full((Bn, 2 * n), 0.0),
        ub=torch.cat([full((Bn, n), 1.0), full((Bn, n), inf)], dim=-1),
        var_mask=full((Bn, 2 * n), 1.0), row_mask=full((Bn, 1 + 2 * n), 1.0),
        constant=torch.einsum("bt,bt->b", y, y),
    )


def plain_qp(X, y):
    """The tracking QPs of ``X`` (B, T, n) with budget and box only."""
    from porqua_tpu_torch import CanonicalQP

    Bn, _, n = X.shape
    dt, dev = X.dtype, X.device
    full = lambda shape, v: torch.full(shape, v, dtype=dt, device=dev)
    return CanonicalQP(
        P=2.0 * X.transpose(1, 2) @ X,
        q=-2.0 * torch.einsum("btn,bt->bn", X, y),
        C=full((Bn, 1, n), 1.0), l=full((Bn, 1), 1.0), u=full((Bn, 1), 1.0),
        lb=full((Bn, n), 0.0), ub=full((Bn, n), 1.0),
        var_mask=full((Bn, n), 1.0), row_mask=full((Bn, 1), 1.0),
        constant=torch.einsum("bt,bt->b", y, y),
    )


def objectives(dev):
    """The realized net loss on ``dev`` as a function of log10(lambda)
    (a 0-d float64 tensor) through the lifted QP, and the same through
    the native n-variable prox path; both differentiable."""
    from porqua_tpu_torch.qp.diff import (solve_qp_batch_diff,
                                          solve_qp_batch_l1_diff)

    params = solver_params()
    w_prev, *panel = make_data()
    w_prev = torch.as_tensor(w_prev, device=dev)
    X_fit, y_fit, X_oos, y_oos = (torch.as_tensor(a, device=dev)
                                  for a in panel)
    f64 = torch.float64

    def net(w):
        te = torch.sqrt(torch.mean(
            (torch.einsum("btn,bn->bt", X_oos, w) - y_oos) ** 2, dim=-1))
        return torch.mean(te + REAL_TC * torch.sum(torch.abs(w - w_prev),
                                                   dim=-1))

    def net_loss(log_lam):
        lam = 10.0 ** log_lam
        wt = solve_qp_batch_diff(
            lifted_tracking_qp(X_fit, y_fit, w_prev, lam), params,
            device=dev)
        return net(wt[:, :N])

    def net_loss_native(log_lam):
        lam = 10.0 ** log_lam
        wv = solve_qp_batch_l1_diff(
            plain_qp(X_fit, y_fit), lam * torch.ones((B, N), dtype=f64,
                                                     device=dev),
            w_prev.expand(B, N), params, device=dev)
        return net(wv)

    return net_loss, net_loss_native


def main(device=None, steps=60, grid=GRID):
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    f64 = torch.float64
    net_loss, net_loss_native = objectives(dev)

    def value(loss, log_l):
        with torch.no_grad():
            return float(loss(torch.tensor(log_l, dtype=f64, device=dev)))

    def value_and_grad(loss, log_l):
        th = torch.tensor(log_l, dtype=f64, device=dev, requires_grad=True)
        v = loss(th)
        v.backward()
        return float(v.detach()), float(th.grad)

    log_l = -5.0
    start = value(net_loss, log_l)
    print(f"start: lambda=1e{log_l:.2f} net={start:.6e}")
    # Gradient descent with best-iterate tracking: past the point where
    # lambda pins w = w_prev exactly, the loss is a flat plateau (the
    # L1 solution map is piecewise constant there, gradient identically
    # zero), so the final iterate can stall on the plateau; the best
    # iterate seen cannot.
    lr, cap = 2e3, 0.2
    best_log, best_net = log_l, start
    path, values, grads = [log_l], [], []
    for _ in range(steps):
        v, g = value_and_grad(net_loss, log_l)
        values.append(v)
        grads.append(g)
        if v < best_net:
            best_net, best_log = v, log_l
        log_l = log_l - float(np.clip(lr * g, -cap, cap))
        path.append(log_l)
    # The loop scores iterates 0..steps-1; score the final update too.
    v_last = value(net_loss, log_l)
    if v_last < best_net:
        best_net, best_log = v_last, log_l
    net_tuned = best_net
    print(f"tuned: lambda=1e{best_log:.2f} net={net_tuned:.6e}")

    nets = [value(net_loss, g) for g in grid]
    best = int(np.argmin(nets))
    print("grid  :", ", ".join(f"1e{g:.1f}->{v:.4e}"
                               for g, v in zip(grid, nets)))
    print(f"grid best: lambda=1e{grid[best]:.1f} net={nets[best]:.6e}")
    assert net_tuned <= nets[best] * 1.001, (
        "gradient tuning should match or beat the grid")
    print("OK: gradient-tuned turnover penalty matches/beats the grid")

    # The same gradient through the NATIVE n-variable prox path (no 2n
    # lift) must agree with the lifted one: two independent
    # formulations of the identical piecewise-smooth solution map.
    probe = -3.2
    g_lift = value_and_grad(net_loss, probe)[1]
    g_native = value_and_grad(net_loss_native, probe)[1]
    print(f"d(net)/d(log lambda) at 1e-3.2: lifted {g_lift:+.6e}, "
          f"native prox {g_native:+.6e}")
    assert abs(g_lift - g_native) <= 1e-6 + 1e-3 * abs(g_lift)
    print("OK: native-prox gradient agrees with the lifted-QP gradient")
    return {"start": start, "path": np.asarray(path),
            "values": np.asarray(values), "grads": np.asarray(grads),
            "best_log": best_log, "net_tuned": net_tuned,
            "grid_net": np.asarray(nets), "g_lift": g_lift,
            "g_native": g_native}


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
