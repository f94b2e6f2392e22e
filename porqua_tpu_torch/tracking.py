"""Index-tracking backtest step: the flagship end-to-end program.

Per rebalance date, minimize ``||X w - y||^2`` over the budget/box
polytope: the Gram build, the batched ADMM solve and the tracking-error
evaluation, all on one device for a whole batch of date windows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from porqua_tpu_torch.qp.canonical import (HP, CanonicalQP, SketchDraws,
                                           sketch_draws, sketch_rows)
from porqua_tpu_torch.qp.solve import SolverParams, _solve_impl, resolve_device


def _sketch_window(X: torch.Tensor,
                   y: torch.Tensor,
                   sketch_dim: int,
                   draws: SketchDraws):
    """Embed (..., T, N) windows and (..., T) benchmarks through one
    count-sketch, applied to the stacked ``[X | y]`` so the sketched
    problem is exactly ``min ||S(Xw - y)||^2`` over the same polytope;
    returns ``(Xs, ys)`` with ``sketch_dim`` rows. The one place the
    embedding is applied: :func:`build_tracking_qp` (the solve path)
    and ``qp.sketch.sketched_tracking_qp`` (the certificate path) both
    call it, so the two sketch bit-identically."""
    stacked = torch.cat([X, y[..., None]], dim=-1)
    sk = sketch_rows(stacked, sketch_dim, draws.bucket, draws.sign)
    return sk[..., :-1], sk[..., -1]


def build_tracking_qp(X: torch.Tensor,
                      y: torch.Tensor,
                      ridge: float = 0.0,
                      lb: float = 0.0,
                      ub: float = 1.0,
                      sketch_dim: int = 0,
                      sketch_seed: int = 0,
                      draws: Optional[SketchDraws] = None) -> CanonicalQP:
    """Lower (B, T, N) windows and (B, T) benchmarks to the tracking QPs.

    P = 2 XᵀX (+ 2·ridge·I), q = −2 Xᵀy, budget row Σw = 1, box
    [lb, ub], and the factor ``Pf = X`` (P = 2 Pf'Pf + diag(2 ridge))
    that the Woodbury solve and factored scaling use. ``ridge`` is a
    float, a 0-dim tensor or one value per window (B,); a tensor that
    carries a gradient reaches ``P`` (and the ``Pdiag`` alias) through
    autograd, as the differentiable solve (``qp/diff.py``) needs.

    ``0 < sketch_dim < T`` first embeds each window through the
    count-sketch (one embedding for every lane, as the JAX package's
    vmap over one seed gives): ``Pf`` then carries ``sketch_dim`` rows.
    ``draws`` are the embedding's buckets and signs, by default
    :func:`~porqua_tpu_torch.qp.canonical.sketch_draws` of
    ``sketch_seed``. ``sketch_dim = 0``, or one that would not
    compress, runs the unsketched build untouched.
    """
    T = X.shape[-2]
    if 0 < sketch_dim < T:
        if draws is None:
            draws = sketch_draws(T, sketch_dim, sketch_seed)
        X, y = _sketch_window(X, y, sketch_dim,
                              draws.to(X.device, X.dtype))
    dtype, device = X.dtype, X.device
    n = X.shape[-1]
    lead = X.shape[:-2]
    full = lambda shape, v: torch.full(lead + shape, v, dtype=dtype,
                                       device=device)
    eye = torch.eye(n, dtype=dtype, device=device)
    # A float, a 0-dim tensor or one per lane (lead shape), kept in the
    # graph when it carries a gradient; doubling is exact, so a float
    # ridge gives the bits it always gave.
    ridge2 = 2.0 * torch.as_tensor(ridge, dtype=dtype,
                                   device=device).unsqueeze(-1)
    return CanonicalQP(
        P=(2.0 * torch.matmul(X.transpose(-1, -2), X)
           + ridge2.unsqueeze(-1) * eye),
        q=-2.0 * torch.einsum("...t,...tn->...n", y, X),
        C=full((1, n), 1.0),
        l=full((1,), 1.0),
        u=full((1,), 1.0),
        lb=full((n,), lb),
        ub=full((n,), ub),
        var_mask=full((n,), 1.0),
        row_mask=full((1,), 1.0),
        constant=torch.sum(y * y, dim=-1),
        Pf=X,
        Pdiag=ridge2 * torch.ones(lead + (n,), dtype=dtype, device=device),
    )


class TrackingResult(NamedTuple):
    weights: torch.Tensor         # (B, N)
    tracking_error: torch.Tensor  # (B,) in-sample RMSE of X w - y
    status: torch.Tensor          # (B,)
    iters: torch.Tensor           # (B,)
    prim_res: torch.Tensor        # (B,)
    dual_res: torch.Tensor        # (B,)


def tracking_step(Xs,
                  ys,
                  params: SolverParams = SolverParams(),
                  ridge: float = 0.0,
                  device=None,
                  draws: Optional[SketchDraws] = None) -> TrackingResult:
    """One full backtest step over a batch of date windows.

    ``Xs``: (B, T, N) asset-return windows; ``ys``: (B, T) benchmark
    windows, as tensors or numpy arrays (their dtype is kept). Runs on
    the card unless ``device`` names another; with no card and no
    ``device`` it raises. Applies the precision policy (no TF32).

    ``params.sketch_dim > 0`` feeds the Gram build through the seeded
    count-sketch (``params.sketch_seed``, or the given ``draws``): the
    solve sees the embedded problem, while the tracking error is always
    evaluated against the true window.
    """
    dev = resolve_device(device)
    HP.apply()
    Xs = torch.as_tensor(Xs, device=dev)
    ys = torch.as_tensor(ys, device=dev)
    qp = build_tracking_qp(Xs, ys, ridge=ridge,
                           sketch_dim=params.sketch_dim,
                           sketch_seed=params.sketch_seed, draws=draws)
    sol = _solve_impl(qp, params)
    resid = torch.matmul(Xs, sol.x.unsqueeze(-1)).squeeze(-1) - ys
    te = torch.sqrt(torch.mean(resid * resid, dim=-1))
    return TrackingResult(
        weights=sol.x,
        tracking_error=te,
        status=sol.status,
        iters=sol.iters,
        prim_res=sol.prim_res,
        dual_res=sol.dual_res,
    )


def synthetic_universe_np(seed: int,
                          n_dates: int,
                          window: int,
                          n_assets: int,
                          n_factors: int = 8):
    """Synthetic factor-model return windows + benchmark (numpy RNG):
    B Gaussian factor windows with idiosyncratic noise, benchmark = a
    noisy random-weight portfolio at daily-return scale. Returns float32
    ``(Xs, ys)`` numpy arrays. The draw depends on the requested shape,
    so take a subset of dates by slicing a full draw."""
    rng = np.random.default_rng(seed)
    factors = rng.standard_normal((n_dates, window, n_factors)).astype(
        np.float32) * 0.01
    loadings = rng.standard_normal((n_dates, n_factors, n_assets)).astype(
        np.float32)
    idio = rng.standard_normal((n_dates, window, n_assets)).astype(
        np.float32) * 0.005
    Xs = np.einsum("btf,bfn->btn", factors, loadings) + idio
    w_true = rng.dirichlet(np.ones(n_assets), n_dates).astype(np.float32)
    ys = np.einsum("btn,bn->bt", Xs, w_true)
    ys = ys + rng.standard_normal(ys.shape).astype(np.float32) * 0.001
    return Xs, ys


def benchmark_grid_np(Xs, ys, n_columns: int):
    """A grid of benchmarks over one universe, ``(n_columns, dates,
    window)`` float32: column 0 is ``ys``; column b >= 1 tracks the
    portfolio ``w_b = default_rng(1000 + b).dirichlet(ones(n_assets))``
    with daily noise of 0.001 standard deviation from the same
    generator."""
    cols = [np.asarray(ys, np.float32)]
    for b in range(1, n_columns):
        rng = np.random.default_rng(1000 + b)
        w_b = rng.dirichlet(np.ones(Xs.shape[-1])).astype(np.float32)
        noise = rng.standard_normal(Xs.shape[:2]).astype(np.float32)
        cols.append(np.einsum("btn,n->bt", Xs, w_b) + 0.001 * noise)
    return np.stack(cols)
