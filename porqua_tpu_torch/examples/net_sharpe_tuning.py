"""Differentiable END-TO-END P&L: tune the turnover knob on net Sharpe.

The port's twin of the JAX package's ``examples/net_sharpe_tuning.py``.
It composes the two engines nothing in the reference can chain a
gradient through (its solver boundary is qpsolvers, its P&L a pandas
loop: ``src/qp_problems.py:211``, ``src/portfolio.py:205-245``):

    lambda -> [rebalances in order: tracking QP + native L1 turnover
               prox, each date's solution the next date's L1 center]
                                            (porqua_tpu_torch.qp.diff)
           -> rebalance weights (D, N)
           -> the accounting engine: drifted weights, levels, turnover,
              NET returns after variable costs
                                            (porqua_tpu_torch.accounting)
           -> annualized net Sharpe

and differentiates the whole pipeline in ONE backward pass: the
optimizer's churn-control knob lambda is tuned directly against the
money the strategy keeps, costs, drift and compounding included. A
finite-difference check validates the gradient at the optimum found.

    python -m porqua_tpu_torch.examples.net_sharpe_tuning [--device cpu]
"""

import numpy as np
import torch

from porqua_tpu_torch.examples._common import parse_device

VC = 0.01               # the market's actual cost per unit turnover
N, WINDOW, D, STEP = 12, 42, 10, 21
ANN = 252


def solver_params():
    from porqua_tpu_torch.qp.solve import SolverParams

    return SolverParams(max_iter=20000, eps_abs=1e-9, eps_rel=1e-9)


def make_market(seed=7):
    """Synthetic market where the *benchmark carries alpha*: a sparse
    basket that slowly rotates into the assets whose drift is
    temporarily high. Tracking it closely captures the alpha but
    churns; freezing the portfolio saves costs but loses the rotation.
    The knob lambda trades exactly that off, so net Sharpe has an
    interior optimum in lambda. numpy (R, y, reb_idx)."""
    rng = np.random.default_rng(seed)
    T = WINDOW + D * STEP + 1
    k = 3
    B = 0.5 + 0.5 * rng.random((N, k))
    F = 0.009 * rng.standard_normal((T, k))
    noise = 0.004 * rng.standard_normal((T, N))
    mu = np.full((T, N), 0.0006)     # common market drift
    w_bm = np.zeros((T, N))
    idx = rng.choice(N, 4, replace=False)
    hold = rng.dirichlet(np.ones(4))
    for t in range(T):
        if t % (2 * STEP) == 0 and t:
            idx = rng.choice(N, 4, replace=False)
            hold = rng.dirichlet(np.ones(4))
        w_bm[t, idx] = hold
        mu[t, idx] += 0.0035         # the rotating alpha (~0.35%/day)
    R = F @ B.T + mu + noise
    y = np.einsum("tn,tn->t", R, w_bm) + 0.0005 * rng.standard_normal(T)
    reb_idx = np.arange(WINDOW, WINDOW + D * STEP, STEP)
    return R, y, reb_idx


def market_windows(R, y, reb_idx):
    """Each rebalance's trailing WINDOW of returns and benchmark."""
    Xs = np.stack([R[i - WINDOW:i] for i in reb_idx])
    ys = np.stack([y[i - WINDOW:i] for i in reb_idx])
    return Xs, ys


def main(device=None, iterations=14):
    from porqua_tpu_torch.accounting import simulate
    from porqua_tpu_torch.qp.diff import solve_qp_l1_diff
    from porqua_tpu_torch.qp.solve import resolve_device
    from porqua_tpu_torch.tracking import build_tracking_qp

    dev = resolve_device(device)
    params = solver_params()
    R_np, y_np, reb_idx = make_market()
    Xs_np, ys_np = market_windows(R_np, y_np, reb_idx)
    R = torch.as_tensor(R_np, device=dev)
    Xs = torch.as_tensor(Xs_np, device=dev)
    ys = torch.as_tensor(ys_np, device=dev)
    w0 = torch.full((N,), 1.0 / N, dtype=torch.float64, device=dev)
    ones = torch.ones(N, dtype=torch.float64, device=dev)
    qps = [build_tracking_qp(Xs[d], ys[d]) for d in range(D)]

    def weights_chain(lam):
        """All D rebalance solves, turnover-coupled through the L1
        center."""
        w, ws = w0, []
        for d in range(D):
            w = solve_qp_l1_diff(qps[d], lam * ones, w, params, device=dev)
            ws.append(w)
        return torch.stack(ws)

    def net_sharpe(lam):
        sim = simulate(weights_chain(lam), R, reb_idx, vc=VC)
        valid = sim.valid
        nv = valid.sum().to(sim.returns.dtype)
        mean = torch.sum(sim.returns) / nv
        var = torch.sum(torch.where(valid, (sim.returns - mean) ** 2,
                                    torch.zeros_like(sim.returns))) / (
            nv - 1.0)
        return mean / torch.sqrt(var) * float(np.sqrt(ANN))

    def scalar(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def value(lam):
        with torch.no_grad():
            return float(net_sharpe(scalar(lam)))

    def value_and_grad(f, x):
        t = scalar(x).requires_grad_(True)
        v = f(t)
        v.backward()
        return float(v.detach()), float(t.grad)

    # Tune theta = log(lambda): multiplicative steps cannot rail the
    # knob against a clip bound in one update, and the scale of
    # dS/dtheta = lambda * dS/dlambda is self-normalizing. Start on the
    # disciplined (high-lambda) side of the live region: the landscape
    # is multimodal (chase-everything is a separate, worse local basin
    # at lambda ~ 1e-4) and above ~3e-3 every coordinate kink-rests,
    # the solution is locally constant in lambda, and the (correct)
    # gradient is identically zero.
    theta = float(np.log(8e-4))
    lr = 0.4
    print(f"actual cost vc={VC}; tuning the solver's lambda on NET Sharpe")
    trace = {"lambda": [], "sharpe": [], "grad": [], "turnover": []}
    for it in range(iterations):
        s, g = value_and_grad(lambda th: net_sharpe(torch.exp(th)), theta)
        lam = float(np.exp(theta))
        with torch.no_grad():
            to = float(torch.sum(simulate(weights_chain(scalar(lam)), R,
                                          reb_idx, vc=VC).turnover))
        print(f"  it {it:2d}: lambda {lam:.5f}  net Sharpe "
              f"{s:+.3f}  dS/dtheta {g:+8.3f}  "
              f"total turnover {to:.2f}", flush=True)
        for k, v in zip(trace, (lam, s, g, to)):
            trace[k].append(v)
        theta = theta + lr * float(np.clip(g, -2.0, 2.0))

    # Gradient sanity at the end point: central finite difference.
    lam = float(np.exp(theta))
    h = 1e-6
    fd = (value(lam + h) - value(lam - h)) / (2 * h)
    g = value_and_grad(net_sharpe, lam)[1]
    print(f"FD check at lambda={lam:.5f}: grad {g:+.4f} vs FD {fd:+.4f}")
    s_final = value(lam)
    s_zero = value(1e-6)
    s_frozen = value(0.1)
    print(f"net Sharpe: chase-everything (lambda~0) {s_zero:+.3f}, "
          f"frozen (lambda=0.1) {s_frozen:+.3f}, tuned {s_final:+.3f}")
    return {**{k: np.asarray(v) for k, v in trace.items()},
            "lambda_final": lam, "grad_final": g, "fd_final": fd,
            "sharpe_final": s_final, "sharpe_zero": s_zero,
            "sharpe_frozen": s_frozen}


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
