"""Large-universe backtest: ~500 assets, monthly rebalance, one batch.

The port's twin of the JAX package's ``examples/backtest_usa.py`` (the
reference's ``example/backtest.ipynb``: S&P 500 TR tracking over the
~489-stock USA universe, monthly rebalance, width=252). The
``usa_returns`` blob is missing from the reference snapshot, so the
universe and the benchmark are a synthetic factor market at the same
scale (``porqua_tpu_torch.synthetic``). Reports the quantstats-style
summary the notebook prints: Sharpe, max drawdown, VaR, tracking error.

Two configurations:

* **notebook parity**: the notebook's cell-1 setup (budget + LongOnly
  box, LeastSquares) over the full universe through the batched engine
  (``run_batch``), f32.
* **filtered + turnover**: a min-volume selection filter (520 raw ->
  489 admitted) plus a turnover budget chaining consecutive dates
  through the previous portfolio, f64. Runs through BOTH engines: the
  serial loop (per-date selection + ``prev_weights`` threading) and the
  date scan (``solve_scan_turnover``, the holdings vector carried from
  date to date), and checks that they produce the same weights.

    python -m porqua_tpu_torch.examples.backtest_usa [--device cpu]
"""

import time

import numpy as np
import pandas as pd
import torch

from porqua_tpu_torch.examples._common import parse_device
from porqua_tpu_torch.synthetic import (MIN_VOLUME, synthetic_usa_np,
                                        usa_benchmark_np, usa_rebdates)


def common_opt_builders(width=252, upper=0.05):
    from porqua_tpu_torch import OptimizationItemBuilder
    from porqua_tpu_torch.builders import (bibfn_bm_series,
                                           bibfn_box_constraints,
                                           bibfn_budget_constraint,
                                           bibfn_return_series)

    return {
        "returns": OptimizationItemBuilder(bibfn=bibfn_return_series,
                                           width=width),
        "bm": OptimizationItemBuilder(bibfn=bibfn_bm_series, width=width,
                                      align=True),
        "budget": OptimizationItemBuilder(bibfn=bibfn_budget_constraint),
        "box": OptimizationItemBuilder(bibfn=bibfn_box_constraints,
                                       upper=upper),
    }


def main(device=None, n_rebdates=None, n_check=12):
    """``n_rebdates`` cuts the calendar to its first dates (default: all
    55); ``n_check``: the dates the serial engine runs in configuration
    2 (the example's 12)."""
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    X, V = synthetic_usa_np()
    # cap-weight-style composite of the universe itself, like SPTR over
    # the real USA stocks in the notebook
    bm = usa_benchmark_np(X)
    rebdates = usa_rebdates(X.index)[:n_rebdates]
    print(f"universe {X.shape[1]} raw assets x {X.shape[0]} days, "
          f"{len(rebdates)} monthly rebalances, width 252")
    out = {"rebdates": rebdates}
    out.update(notebook_config(X, bm, rebdates, dev))
    out.update(turnover_config(X, V, bm, rebdates, n_check, dev))
    return out


def notebook_config(X, bm, rebdates, dev):
    """Configuration 1: the notebook's setup through the batched engine,
    f32."""
    from porqua_tpu_torch import (BacktestService, LeastSquares,
                                  SelectionItemBuilder, run_batch)
    from porqua_tpu_torch.builders import bibfn_selection_data
    from porqua_tpu_torch.qp import SolverParams

    bs = BacktestService(
        data={"return_series": X, "bm_series": bm},
        selection_item_builders={
            "data": SelectionItemBuilder(bibfn=bibfn_selection_data),
        },
        optimization_item_builders=common_opt_builders(),
        optimization=LeastSquares(),
        settings={"rebdates": rebdates, "quiet": True},
    )

    # f32: loose in-loop tolerance + polish (pushing f32 ADMM to 1e-6
    # stalls at the residual floor while the polish already lands on
    # the active set)
    _sync(dev)
    t0 = time.perf_counter()
    bt = run_batch(bs, params=SolverParams(eps_abs=1e-3, eps_rel=1e-3),
                   device=dev)
    wall = time.perf_counter() - t0
    stats = bt.output["batch"]
    solved = int((stats["status"] == 1).sum())
    print(f"[notebook parity] solved {solved}/{len(rebdates)} "
          f"dates in {wall:.2f}s (build + one batched solve)")
    perf = _summary(bt.strategy, X, bm, dev)
    print(f"  Sharpe {perf['sharpe']:.2f} | "
          f"max drawdown {perf['max_drawdown']:.2%} | "
          f"daily VaR(95) {perf['var_95']:.4f} | "
          f"tracking error {perf['tracking_error']:.4f}")
    out = {"config1/status": np.asarray(stats["status"]),
           "config1/iters": np.asarray(stats["iters"]),
           "config1/weights": _weights(bt.strategy, rebdates, X.columns),
           "config1/solved": solved, "config1/seconds": wall}
    out.update({f"config1/{k}": perf[k] for k in PERF_KEYS})
    return out


PERF_KEYS = ("sharpe", "max_drawdown", "var_95", "tracking_error")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _weights(strategy, rebdates, columns):
    return (strategy.get_weights_df().reindex(index=rebdates, columns=columns)
            .fillna(0.0).to_numpy(float))


def _summary(strategy, X, bm, dev):
    from porqua_tpu_torch.accounting import (performance_summary,
                                             simulate_strategy)

    sim = simulate_strategy(strategy, X, fc=0.0, vc=0.001, device=dev)
    perf = performance_summary(sim, benchmark=bm.iloc[:, 0])
    return {k: float(perf[k]) for k in PERF_KEYS}


TURNOVER_BUDGET = 0.25


def filtered_service(X, V, bm, rebdates):
    """Configuration 2's service: the min-volume selection filter and a
    turnover budget against the previous portfolio, LeastSquares in f64
    with a small ridge."""
    from porqua_tpu_torch import (BacktestService, LeastSquares,
                                  OptimizationItemBuilder,
                                  SelectionItemBuilder)
    from porqua_tpu_torch.builders import (bibfn_selection_min_volume,
                                           bibfn_turnover_constraint)

    return BacktestService(
        data={"return_series": X, "bm_series": bm, "volume_series": V},
        selection_item_builders={
            "volume": SelectionItemBuilder(
                bibfn=bibfn_selection_min_volume, width=90,
                min_volume=MIN_VOLUME),
        },
        optimization_item_builders={
            **common_opt_builders(),
            "turnover": OptimizationItemBuilder(
                bibfn=bibfn_turnover_constraint,
                turnover_budget=TURNOVER_BUDGET),
        },
        # Small ridge: with N ~ 489 assets against a 252-row window the
        # Gram objective is rank-deficient (n > T), so the minimizer is
        # a whole affine set; l2_penalty pins a unique one.
        optimization=LeastSquares(dtype=torch.float64, l2_penalty=1e-4),
        settings={"rebdates": rebdates, "quiet": True},
    )


def initial_holdings(X, V, bm, rebdates):
    """Pre-backtest holdings: equal weight over the set the filter
    admits on the first date (a cash start is infeasible under sum w =
    1 + turnover < 1)."""
    bs_probe = filtered_service(X, V, bm, rebdates)
    bs_probe.prepare_rebalancing(rebalancing_date=rebdates[0])
    universe = list(bs_probe.optimization.constraints.selection)
    return {a: 1.0 / len(universe) for a in universe}


def tight_params():
    from porqua_tpu_torch.qp import SolverParams

    return SolverParams(eps_abs=1e-8, eps_rel=1e-8)


def serial_engine(X, V, bm, rebdates, w0, dev):
    """The serial engine: per-date selection, prev_weights threaded by
    the loop (reference backtest.py:201-224 semantics). Returns the
    backtest and its seconds."""
    from porqua_tpu_torch import Backtest

    bs = filtered_service(X, V, bm, rebdates)
    bs.settings["prev_weights"] = dict(w0)
    bs.optimization.params.update(tight_params().__dict__)
    _sync(dev)
    t0 = time.perf_counter()
    bt = Backtest()
    bt.run(bs, device=dev)
    return bt, time.perf_counter() - t0


def scan_engine(X, V, bm, rebdates, w0, dev):
    """The date scan: problems built once (placeholder x0), then one
    chain carrying the holdings vector through the lifted turnover rows
    with warm starts. Returns the backtest, the solution and its
    seconds."""
    from porqua_tpu_torch.batch import (assemble_backtest, build_problems,
                                        solve_scan_turnover)

    bs = filtered_service(X, V, bm, rebdates)
    bs.settings["prev_weights"] = dict(w0)
    t0 = time.perf_counter()
    problems = build_problems(bs, dtype=torch.float64)
    w_init = np.array([w0.get(a, 0.0) for a in problems.universes[0]])
    sols = solve_scan_turnover(
        problems.qp, n_assets=len(problems.universes[0]), row_start=1,
        w_init=torch.as_tensor(w_init), params=tight_params(),
        universes=problems.universes, device=dev)
    bt = assemble_backtest(problems, sols)
    _sync(dev)
    return bt, sols, time.perf_counter() - t0


def turnover_config(X, V, bm, rebdates, n_check, dev):
    """Configuration 2 through the serial engine on the first
    ``n_check`` dates (the turnover chain over a shared date prefix is
    identical) and the date scan on all of them."""
    w0 = initial_holdings(X, V, bm, rebdates)
    print(f"[filtered + turnover] min-volume filter admits "
          f"{len(w0)}/{X.shape[1]} assets; "
          f"turnover budget {TURNOVER_BUDGET}")
    n_check = min(n_check, len(rebdates))
    bt_serial, t_serial = serial_engine(X, V, bm, rebdates[:n_check], w0,
                                        dev)
    bt_scan, sols, t_scan = scan_engine(X, V, bm, rebdates, w0, dev)

    # The two engines must agree date by date (over the checked prefix).
    # skipna=False + np.maximum: a missing asset's NaN propagates into
    # max_dw and fails the finiteness assert.
    max_dw = 0.0
    for date in rebdates[:n_check]:
        ws = pd.Series(bt_serial.strategy.get_weights(date))
        wb = pd.Series(bt_scan.strategy.get_weights(date))
        d = (wb.reindex(ws.index) - ws).abs().max(skipna=False)
        max_dw = float(np.maximum(max_dw, d))
    print(f"  serial {t_serial:.1f}s/{n_check} dates vs scan "
          f"{t_scan:.1f}s/{len(rebdates)} dates; "
          f"max |dw| serial-vs-scan {max_dw:.2e} over {n_check} dates")
    # 5e-4: the ridge-conditioning bound of the JAX package's own
    # serial-vs-scan check (tests/test_backtest_usa.py).
    assert np.isfinite(max_dw) and max_dw < 5e-4, max_dw

    perf_to = _summary(bt_scan.strategy, X, bm, dev)
    wdf = bt_scan.strategy.get_weights_df().fillna(0.0)
    realized = wdf.diff().abs().sum(axis=1).iloc[1:]
    print(f"  Sharpe {perf_to['sharpe']:.2f} | "
          f"max drawdown {perf_to['max_drawdown']:.2%} | "
          f"tracking error {perf_to['tracking_error']:.4f} | "
          f"realized turnover median {realized.median():.3f} "
          f"(budget {TURNOVER_BUDGET})")
    out = {"config2/universe": len(w0),
           "config2/serial_weights": _weights(bt_serial.strategy,
                                              rebdates[:n_check], X.columns),
           "config2/scan_weights": _weights(bt_scan.strategy, rebdates,
                                            X.columns),
           "config2/status": np.asarray(sols.status.cpu()),
           "config2/max_dw": max_dw,
           "config2/realized_median": float(realized.median()),
           "config2/serial_seconds": t_serial,
           "config2/scan_seconds": t_scan}
    out.update({f"config2/{k}": perf_to[k] for k in PERF_KEYS})
    return out


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
