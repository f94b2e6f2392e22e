"""End-to-end tour: four strategies, serial + batched engines, P&L.

The port's twin of the JAX package's ``examples/quickstart.py`` (the
reference's interactive smoke script,
``src/_quick_and_dirty_interactive_testing.py``): MSCI data ->
quarterly rebalance dates -> selection/optimization item builders ->
``BacktestService`` -> backtests of QEQW / LeastSquares /
WeightedLeastSquares / LAD -> ``simulate_strategy`` with costs ->
cumulative log-returns. Then the same LeastSquares backtest again
through the batched engine (``run_batch``: every date in one batched
solve) to show the two paths agree.

    python -m porqua_tpu_torch.examples.quickstart [--device cpu]
"""

import numpy as np
import torch

from porqua_tpu_torch.examples._common import (load_msci_or_synthetic,
                                               parse_device,
                                               quarterly_rebdates)


def make_service(data, rebdates, optimization, width=252):
    from porqua_tpu_torch import (BacktestService, OptimizationItemBuilder,
                                  SelectionItemBuilder)
    from porqua_tpu_torch.builders import (bibfn_bm_series,
                                           bibfn_box_constraints,
                                           bibfn_budget_constraint,
                                           bibfn_return_series,
                                           bibfn_selection_data)

    return BacktestService(
        data=data,
        selection_item_builders={
            "data": SelectionItemBuilder(bibfn=bibfn_selection_data),
        },
        optimization_item_builders={
            "returns": OptimizationItemBuilder(bibfn=bibfn_return_series,
                                               width=width),
            "bm": OptimizationItemBuilder(bibfn=bibfn_bm_series, width=width,
                                          align=True),
            "budget": OptimizationItemBuilder(bibfn=bibfn_budget_constraint),
            "box": OptimizationItemBuilder(bibfn=bibfn_box_constraints),
        },
        optimization=optimization,
        settings={"rebdates": rebdates, "quiet": True},
    )


def main(device=None, n_rebdates=12):
    from porqua_tpu_torch import (LAD, QEQW, Backtest, LeastSquares,
                                  WeightedLeastSquares, run_batch)
    from porqua_tpu_torch.accounting import simulate_strategy
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    data = load_msci_or_synthetic()
    returns = data["return_series"]
    rebdates = quarterly_rebdates(returns.index, start="2018-01-01",
                                  k=n_rebdates)
    print(f"universe: {returns.shape[1]} assets, {len(rebdates)} rebalances "
          f"({rebdates[0]} .. {rebdates[-1]})")

    f64 = torch.float64
    strategies = {
        "qeqw": QEQW(dtype=f64),
        "ls": LeastSquares(dtype=f64),
        "wls": WeightedLeastSquares(tau=126, dtype=f64),
        "lad": LAD(dtype=f64),
    }
    out = {"rebdates": rebdates}
    sims = {}
    for name, opt in strategies.items():
        bs = make_service(data, rebdates, opt)
        bt = Backtest()
        bt.run(bs, device=dev)
        sim = simulate_strategy(bt.strategy, returns, fc=0.0, vc=0.002,
                                device=dev)
        sims[name] = sim
        cum = float(np.log1p(sim).sum())
        per_date = bt.strategy.turnover(return_series=returns)
        to = float(per_date.mean())
        print(f"{name:5s}: cumulative log-return {cum:+.4f}, "
              f"mean turnover {to:.3f}")
        out[f"{name}/cum"] = cum
        out[f"{name}/turnover"] = to
        out[f"{name}/turnover_series"] = per_date.to_numpy(float)
        out[f"{name}/weights"] = weights_of(bt.strategy, rebdates,
                                            returns.columns)

    # Batched engine on the same LeastSquares service: one batched solve.
    bs = make_service(data, rebdates, LeastSquares(dtype=f64))
    batched = run_batch(bs, dtype=f64, device=dev)
    W_batch = batched.strategy.get_weights_df()
    sim_b = simulate_strategy(batched.strategy, returns, fc=0.0, vc=0.002,
                              device=dev)
    drift = float(np.abs(np.log1p(sims["ls"]).sum() - np.log1p(sim_b).sum()))
    print(f"batched engine: {W_batch.shape[0]} dates solved in one program; "
          f"|serial - batched| cumulative log-return = {drift:.2e}")
    assert drift < 1e-6
    out["batched/drift"] = drift
    out["batched/weights"] = weights_of(batched.strategy, rebdates,
                                        returns.columns)

    # Percentile (quintile) portfolios on geometric-mean momentum scores,
    # recorded per date via append_custom, then one strategy per quantile
    # (the second half of the reference's script, lines 230-270).
    out.update(percentile_backtest(data, rebdates, returns, dev))
    return out


def weights_of(strategy, rebdates, columns):
    """The strategy's weights as a (dates, assets) array, in the
    rebalance order and the universe's column order."""
    return (strategy.get_weights_df().reindex(index=rebdates,
                                              columns=columns)
            .to_numpy(float))


def percentile_backtest(data, rebdates, returns, dev):
    from porqua_tpu_torch import Backtest, PercentilePortfolios
    from porqua_tpu_torch.accounting import simulate_strategy
    from porqua_tpu_torch.backtest import append_custom
    from porqua_tpu_torch.estimators.mean import MeanEstimator
    from porqua_tpu_torch.utils.helpers import output_to_strategies

    bs = make_service(
        data, rebdates,
        PercentilePortfolios(
            n_percentiles=5,
            estimator=MeanEstimator(method="geometric", n_mom=252, n_rev=21)),
    )
    bs.settings["append_fun"] = append_custom
    bs.settings["append_fun_args"] = ["w_dict"]
    bt = Backtest()
    bt.run(bs, device=dev)
    per_quantile = output_to_strategies(bt.output)
    print("quintile portfolios (top minus bottom spread):")
    cums = {}
    for name, strat in per_quantile.items():
        sim = simulate_strategy(strat, returns, fc=0.0, vc=0.0, device=dev)
        cums[name] = float(np.log1p(sim).sum())
    spread = cums["q1"] - cums["q5"]
    print("  " + ", ".join(f"{k}: {v:+.3f}" for k, v in cums.items())
          + f" | q1-q5 spread {spread:+.3f}")
    return {**{f"percentile/{k}": v for k, v in cums.items()},
            "percentile/spread": spread}


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
