"""Index replication: track a benchmark with a constrained LS portfolio.

The port's twin of the JAX package's ``examples/index_replication.py``
(the reference's ``example/index_replication.ipynb``): minimize
||Xw - y||^2 in log-return space over the constraint polytope (budget +
long-only box), backtest it monthly, and report tracking error and
cumulative performance vs the benchmark. The solve path is the batched
engine: all rebalance dates in one batched solve.

    python -m porqua_tpu_torch.examples.index_replication [--device cpu]
"""

import numpy as np
import pandas as pd
import torch

from porqua_tpu_torch.examples._common import (load_msci_or_synthetic,
                                               parse_device)


def monthly_rebdates(index, start="2018-01-01", k=36):
    me = pd.Series(index=index, data=1).resample("ME").last().index
    out = [str(index[index <= d][-1].date()) for d in me
           if str(start) <= str(d.date()) and (index <= d).any()]
    return out[:k]


def main(device=None, n_rebdates=36):
    from porqua_tpu_torch import (BacktestService, LeastSquares,
                                  OptimizationItemBuilder,
                                  SelectionItemBuilder, run_batch)
    from porqua_tpu_torch.accounting import simulate_strategy
    from porqua_tpu_torch.builders import (bibfn_bm_series,
                                           bibfn_box_constraints,
                                           bibfn_budget_constraint,
                                           bibfn_return_series,
                                           bibfn_selection_data)
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    data = load_msci_or_synthetic()
    returns = data["return_series"]
    bm = data["bm_series"]
    rebdates = monthly_rebdates(returns.index, k=n_rebdates)
    print(f"tracking {bm.columns[0]} with {returns.shape[1]} assets, "
          f"{len(rebdates)} monthly rebalances")

    bs = BacktestService(
        data=data,
        selection_item_builders={
            "data": SelectionItemBuilder(bibfn=bibfn_selection_data),
        },
        optimization_item_builders={
            "returns": OptimizationItemBuilder(bibfn=bibfn_return_series,
                                               width=252),
            "bm": OptimizationItemBuilder(bibfn=bibfn_bm_series, width=252,
                                          align=True),
            "budget": OptimizationItemBuilder(bibfn=bibfn_budget_constraint),
            "box": OptimizationItemBuilder(bibfn=bibfn_box_constraints,
                                           upper=0.5),
        },
        # log-space LS objective, as in the notebook's formulation
        optimization=LeastSquares(log_transform=True, dtype=torch.float64),
        settings={"rebdates": rebdates, "quiet": True},
    )
    bt = run_batch(bs, dtype=torch.float64, device=dev)
    stats = bt.output["batch"]
    solved = int((stats["status"] == 1).sum())
    print(f"solved {solved}/{len(rebdates)} dates, "
          f"median iters n/a, max primal residual "
          f"{stats['prim_res'].max():.2e}")

    sim = simulate_strategy(bt.strategy, returns, fc=0.0, vc=0.0, device=dev)
    bm_ret = bm.iloc[:, 0].reindex(sim.index)
    te = float((sim - bm_ret).std() * np.sqrt(252))
    cum, cum_bm = float(np.log1p(sim).sum()), float(np.log1p(bm_ret).sum())
    print(f"annualized tracking error vs benchmark: {te:.4f}")
    print(f"cumulative log-return: portfolio {cum:+.4f}, "
          f"benchmark {cum_bm:+.4f}")
    return {
        "rebdates": rebdates,
        "status": np.asarray(stats["status"]),
        "iters": np.asarray(stats["iters"]),
        "weights": (bt.strategy.get_weights_df()
                    .reindex(index=rebdates, columns=returns.columns)
                    .to_numpy(float)),
        "solved": solved,
        "max_prim_res": float(np.max(stats["prim_res"])),
        "tracking_error": te,
        "cum": cum,
        "cum_bm": cum_bm,
    }


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
