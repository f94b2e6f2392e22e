"""Vectorized portfolio accounting on tensors: the whole P&L of a
backtest in a handful of batched ops (the port of
``porqua_tpu/accounting.py``).

* one global ``cumprod`` of gross returns replaces the per-period
  cumprods of the pandas engine: the drifted weight at day t under the
  segment that started at day s is ``w_s * G[t] / G[s]`` with
  ``G = cumprod(1 + R)``;
* each day is assigned to its rebalance segment with a ``searchsorted``
  (a day that *is* a rebalance date belongs to the *previous* segment,
  as in the pandas engine, where the new weights seed that day's level
  and produce their first return the day after);
* margin / cash / loan sleeves, turnover, variable and fixed costs are
  computed per segment and broadcast.

The pandas engine (:mod:`porqua_tpu_torch.portfolio`) is the reference
in tests. :func:`simulate_strategy` runs on the card unless the caller
passes ``device``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import pandas as pd
import torch

from porqua_tpu_torch.qp.solve import resolve_device


def _renormalize_long_short(w: torch.Tensor) -> torch.Tensor:
    """Row-wise long/short renormalization: each row's long side is
    scaled to sum to +1 and the short side to -1; a row with an empty
    side contributes zero for that side."""
    longs = torch.clamp_min(w, 0.0)
    shorts = w - longs
    long_gross = longs.sum(dim=-1, keepdim=True)
    short_gross = shorts.abs().sum(dim=-1, keepdim=True)

    def safe(part, tot):
        return torch.where(tot > 0.0, part / torch.clamp_min(tot, 1e-30),
                           torch.zeros_like(part))

    return safe(longs, long_gross) + safe(shorts, short_gross)


def _segments(reb_idx, T, n_seg):
    """Per day: the last rebalance strictly before it (-1 before the
    first) and that index clipped into [0, n_seg)."""
    days = torch.arange(T, device=reb_idx.device)
    seg = torch.searchsorted(reb_idx, days, right=False) - 1
    return days, seg, torch.clamp(seg, 0, n_seg - 1)


def drift_weights(weights: torch.Tensor,
                  returns: torch.Tensor,
                  reb_idx,
                  rescale: bool = False) -> torch.Tensor:
    """Drifted weights for every day under its active segment (with
    ``rescale``, long/short renormalized row-wise). Days before the
    first rebalance hold the first segment's seed."""
    weights = torch.as_tensor(weights, dtype=returns.dtype,
                              device=returns.device)
    reb_idx = torch.as_tensor(reb_idx, dtype=torch.int64,
                              device=returns.device)
    G = torch.cumprod(1.0 + returns, dim=0)
    _, _, seg = _segments(reb_idx, returns.shape[0], weights.shape[0])
    w_float = weights[seg] * G / G[reb_idx[seg]]
    return _renormalize_long_short(w_float) if rescale else w_float


class SimulationResult(NamedTuple):
    returns: torch.Tensor   # (T,) daily strategy returns; 0 before the first rebdate
    valid: torch.Tensor     # (T,) bool, True where a return is defined
    turnover: torch.Tensor  # (D,) two-sided turnover at each rebalance
    levels: torch.Tensor    # (T,) portfolio level under the active segment


def simulate(weights: torch.Tensor,
             returns: torch.Tensor,
             reb_idx,
             vc: float = 0.0,
             fc: float = 0.0,
             day_gaps: Optional[torch.Tensor] = None,
             n_days_per_year: int = 252,
             rescale_turnover: bool = False) -> SimulationResult:
    """Simulate a rebalanced strategy on the tensors' device.

    Args:
      weights: (D, N) portfolio weights decided at each rebalance date.
      returns: (T, N) daily asset returns.
      reb_idx: (D,) int positions of the rebalance dates within the T
        axis (strictly increasing).
      vc: variable (turnover-proportional) cost rate.
      fc: fixed cost rate per year, compounded by calendar-day gaps.
      day_gaps: (T,) calendar days since the previous row (0 for the
        first); required when ``fc != 0``.
      rescale_turnover: measure turnover against the long/short
        renormalized drift of the previous portfolio instead of the
        raw drift.
    """
    dtype, device = returns.dtype, returns.device
    T = returns.shape[0]
    weights = torch.as_tensor(weights, dtype=dtype, device=device)
    reb_idx = torch.as_tensor(reb_idx, dtype=torch.int64, device=device)
    D = weights.shape[0]

    # Global growth G[t] = prod_{s<=t} (1 + r_s); drifted weights under
    # the segment seeded at s are w_s * G[t] / G[s].
    G = torch.cumprod(1.0 + returns, dim=0)
    days, seg, seg_clip = _segments(reb_idx, T, D)

    w_seg = weights[seg_clip]                       # (T, N)
    g_seed = G[reb_idx[seg_clip]]                   # (T, N) growth at seed day
    w_float = w_seg * G / g_seed                    # (T, N) drifted weights
    g_prev = torch.where((days > 0)[:, None],
                         G[torch.clamp_min(days - 1, 0)],
                         torch.ones_like(G))
    w_float_prev = w_seg * g_prev / g_seed

    # Margin / cash / loan sleeves per rebalance: constants within a
    # segment.
    short_sum = torch.clamp_max(weights, 0.0).sum(dim=1)       # (D,)
    long_sum = torch.clamp_min(weights, 0.0).sum(dim=1)
    margin = short_sum.abs()
    cash = torch.clamp(1.0 - long_sum, 0.0, 1.0)
    loan = 1.0 - (long_sum + cash) - (short_sum + margin)
    sleeves = (margin + cash + loan)[seg_clip]                  # (T,)

    level = sleeves + w_float.sum(dim=1)
    level_prev = sleeves + w_float_prev.sum(dim=1)
    ret = level / level_prev - 1.0

    valid = (seg >= 0) & (days > reb_idx[0])
    zero = torch.zeros_like(ret)
    ret = torch.where(valid, ret, zero)

    # Turnover: drifted previous weights at the rebalance date vs the
    # new weights, the drift optionally long/short-renormalized first.
    prev_seg = torch.clamp_min(torch.arange(D, device=device) - 1, 0)
    w_drift_prev = weights[prev_seg] * G[reb_idx] / G[reb_idx[prev_seg]]
    if rescale_turnover:
        w_drift_prev = _renormalize_long_short(w_drift_prev)
    to = (w_drift_prev - weights).abs().sum(dim=1)
    to[0] = weights[0].abs().sum()

    if vc != 0.0:
        # Cost lands on the first defined return for the first
        # rebalance and on the rebalance-date return otherwise.
        cost_t = torch.zeros(T, dtype=dtype, device=device)
        cost_t.index_add_(0, reb_idx, to * vc)
        first = reb_idx[0]
        if int(first) + 1 < T:
            cost_t[first + 1] += cost_t[first]
        cost_t[first] = 0.0
        ret = ret - torch.where(valid, cost_t, zero)

    if fc != 0.0:
        if day_gaps is None:
            raise ValueError("day_gaps is required when fc != 0")
        gaps = torch.as_tensor(day_gaps, dtype=dtype, device=device)
        fixcost = (1.0 + fc) ** (gaps / n_days_per_year) - 1.0
        # No fixed cost on the very first return row.
        charge = valid & (days > reb_idx[0] + 1)
        ret = ret - torch.where(charge, fixcost, zero)

    return SimulationResult(returns=ret, valid=valid, turnover=to,
                            levels=torch.where(seg >= 0, level,
                                               torch.ones_like(level)))


def simulate_strategy(strategy,
                      return_series: pd.DataFrame,
                      fc: float = 0.0,
                      vc: float = 0.0,
                      n_days_per_year: int = 252,
                      device=None) -> pd.Series:
    """Pandas-friendly wrapper: a ``Strategy`` in, a return Series out,
    computed in float64 on ``device`` (default: the card). The asset
    universe may vary by date (weights are aligned to the full column
    set)."""
    dev = resolve_device(device)
    rebdates = strategy.get_rebalancing_dates()
    W = (
        strategy.get_weights_df()
        .reindex(columns=return_series.columns)
        .fillna(0.0)
        .to_numpy(dtype=float)
    )
    dates = pd.to_datetime(pd.Index(rebdates))
    reb_idx = return_series.index.get_indexer(dates, method="pad")
    if (reb_idx < 0).any():
        raise ValueError("all rebalance dates must fall inside the return series")

    day_gaps = np.zeros(len(return_series.index))
    day_gaps[1:] = (
        (return_series.index[1:] - return_series.index[:-1])
        .to_numpy().astype("timedelta64[D]").astype(float)
    )

    as_dev = lambda a: torch.tensor(a, device=dev)
    out = simulate(
        as_dev(W),
        as_dev(return_series.to_numpy(dtype=float)),
        as_dev(reb_idx),
        vc=vc, fc=fc,
        day_gaps=as_dev(day_gaps),
        n_days_per_year=n_days_per_year,
    )
    ret = out.returns.cpu().numpy()
    valid = out.valid.cpu().numpy()
    return pd.Series(ret[valid], index=return_series.index[valid])


def performance_summary(returns: pd.Series,
                        benchmark: Optional[pd.Series] = None,
                        n_days_per_year: int = 252) -> dict:
    """Per-strategy performance report: the quantstats-style metric set
    the reference notebooks print (Sharpe / VaR / drawdown,
    ``example/backtest.ipynb`` cell 2, ``index_replication.ipynb`` cell
    11) computed from first principles — no external dependency.

    Returns a dict with annualized return/volatility/Sharpe, max
    drawdown (on the compounded level path), daily 95% historical VaR,
    cumulative return, and — when a benchmark series is given —
    annualized tracking error, beta, and active (excess) return.
    """
    r = returns.dropna()
    ann = float(n_days_per_year)
    if r.empty:
        # A strategy with no valid days has no performance — report it
        # as NaN metrics, not an IndexError.
        nan = float("nan")
        out = {"n_days": 0, "annual_return": nan, "annual_volatility": nan,
               "sharpe": nan, "max_drawdown": nan, "var_95": nan,
               "cumulative_return": nan}
        if benchmark is not None:
            out.update(tracking_error=nan, beta=nan, active_return=nan)
        return out
    mean_d, std_d = float(r.mean()), float(r.std())
    levels = (1.0 + r).cumprod()
    final = float(levels.iloc[-1])
    out = {
        "n_days": int(r.size),
        # CAGR from the compounded level path (the quantstats
        # convention; round-3 advisor finding): consistent with
        # cumulative_return by construction, where compounding the
        # arithmetic daily mean overstates growth for volatile series.
        # A wiped-out path (level <= 0) annualizes to -100%.
        "annual_return": (float(final ** (ann / r.size) - 1.0)
                          if final > 0 else -1.0),
        "annual_volatility": std_d * float(np.sqrt(ann)),
        # A zero/undefined-variance series has no defined risk-adjusted
        # return; NaN, never +inf for a flat losing strategy.
        "sharpe": (mean_d / std_d * float(np.sqrt(ann))
                   if std_d > 0 else float("nan")),
        "max_drawdown": float((levels / levels.cummax() - 1.0).min()),
        "var_95": float(r.quantile(0.05)),
        "cumulative_return": float(levels.iloc[-1] - 1.0),
    }
    if benchmark is not None:
        # One aligned, pairwise-complete sample for every benchmark
        # metric: covariance and variance from different subsets would
        # bias beta whenever the two series' calendars differ.
        pair = pd.DataFrame(
            {"r": r, "b": benchmark.reindex(r.index).astype(float)}
        ).dropna()
        active = pair["r"] - pair["b"]
        bv = float(pair["b"].var())
        out["tracking_error"] = float(active.std() * np.sqrt(ann))
        out["beta"] = (float(pair["r"].cov(pair["b"]) / bv)
                       if bv > 0 else float("nan"))
        out["active_return"] = (
            float((1.0 + active.mean()) ** ann - 1.0)
            if len(active) else float("nan"))
    return out
