"""Gradient-based hyperparameter tuning THROUGH the QP solver.

The port's twin of the JAX package's ``examples/differentiable_tuning.py``.
The reference tunes hyperparameters (ridge strength, turnover penalty,
box widths) by grid search over whole backtests: its solver boundary
(``src/qp_problems.py:211``) is opaque to derivatives. Here the solve
is differentiable (``porqua_tpu_torch.qp.diff``, an implicit-function
vjp), so "pick the ridge that minimizes NEXT-window tracking error" is
a first-order optimization: every gradient step backpropagates through
objective assembly -> batched QP solve -> out-of-sample tracking error.

    python -m porqua_tpu_torch.examples.differentiable_tuning [--device cpu]
"""

import numpy as np
import torch

from porqua_tpu_torch.examples._common import parse_device


def solver_params():
    from porqua_tpu_torch.qp.solve import SolverParams

    return SolverParams(max_iter=20000, eps_abs=1e-10, eps_rel=1e-10)


def make_panel(rng, n_dates=12, T=60, n=24, noise=0.004):
    """Rolling factor-model windows with noisy observations: in-sample
    LS overfits, so an out-of-sample-optimal ridge exists. numpy arrays
    (fit X, fit y, evaluation X, evaluation y)."""
    w_true = rng.dirichlet(np.ones(n))
    Xs = rng.standard_normal((n_dates, 2 * T, n)) * 0.01
    ys = Xs @ w_true + rng.standard_normal((n_dates, 2 * T)) * noise
    # Fit window = first T rows, evaluation window = next T rows.
    return Xs[:, :T], ys[:, :T], Xs[:, T:], ys[:, T:]


def build_qp(X, y, ridge):
    """The ridge-tracking QPs of a batch of windows ``X`` (B, T, n)."""
    from porqua_tpu_torch import CanonicalQP

    B, _, n = X.shape
    dt, dev = X.dtype, X.device
    ones = torch.ones((B, 1), dtype=dt, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev)
    return CanonicalQP(
        P=2.0 * X.transpose(1, 2) @ X + 2.0 * ridge * eye,
        q=-2.0 * torch.einsum("btn,bt->bn", X, y),
        C=torch.ones((B, 1, n), dtype=dt, device=dev), l=ones, u=ones,
        lb=torch.zeros((B, n), dtype=dt, device=dev),
        ub=torch.ones((B, n), dtype=dt, device=dev),
        var_mask=torch.ones((B, n), dtype=dt, device=dev), row_mask=ones,
        constant=torch.einsum("bt,bt->b", y, y),
    )


def objective(dev):
    """The tuning objective on ``dev``: the mean out-of-sample tracking
    error over the date batch as a function of log10(ridge) (a 0-d
    float64 tensor), differentiable through the solve."""
    from porqua_tpu_torch.qp.diff import solve_qp_batch_diff

    params = solver_params()
    rng = np.random.default_rng(7)
    X_fit, y_fit, X_oos, y_oos = (torch.as_tensor(a, device=dev)
                                  for a in make_panel(rng))

    def oos_te(log_ridge):
        ridge = 10.0 ** log_ridge
        w = solve_qp_batch_diff(build_qp(X_fit, y_fit, ridge), params,
                                device=dev)
        r = torch.einsum("btn,bn->bt", X_oos, w) - y_oos
        return torch.sqrt(torch.mean(r * r, dim=-1)).mean()

    return oos_te


def main(device=None, steps=40, grid=(-7.0, -6.0, -5.0, -4.0, -3.0, -2.0,
                                      -1.0)):
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    oos_te = objective(dev)

    def value(log_r):
        with torch.no_grad():
            return float(oos_te(torch.tensor(log_r, dtype=torch.float64,
                                             device=dev)))

    def grad(log_r):
        th = torch.tensor(log_r, dtype=torch.float64, device=dev,
                          requires_grad=True)
        oos_te(th).backward()
        return float(th.grad)

    # Plain gradient descent on log10(ridge). The landscape is gentle
    # (TE moves ~1e-5 per log-unit), so the raw gradient needs a large
    # learning rate with a trust-region-style step cap.
    log_r = -5.0
    te_start = value(log_r)
    print(f"start: ridge=1e{log_r:.2f} oos_te={te_start:.6e}")
    lr, cap = 2e4, 0.5
    path, grads = [log_r], []
    for _ in range(steps):
        g = grad(log_r)
        grads.append(g)
        log_r = log_r - float(np.clip(lr * g, -cap, cap))
        path.append(log_r)
    te_tuned = value(log_r)
    print(f"tuned: ridge=1e{log_r:.2f} oos_te={te_tuned:.6e}")

    # Compare against a coarse grid: the reference's only option.
    tes = [value(g) for g in grid]
    best = int(np.argmin(tes))
    print("grid  :", ", ".join(f"1e{g:.0f}->{t:.3e}"
                               for g, t in zip(grid, tes)))
    print(f"grid best: ridge=1e{grid[best]:.0f} oos_te={tes[best]:.6e}")
    assert te_tuned <= tes[best] * 1.02, (
        "gradient tuning should match or beat the coarse grid")
    print("OK: gradient-tuned ridge matches/beats the grid search")
    return {"te_start": te_start, "path": np.asarray(path),
            "grads": np.asarray(grads), "log_ridge": log_r,
            "te_tuned": te_tuned, "grid_te": np.asarray(tes)}


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
