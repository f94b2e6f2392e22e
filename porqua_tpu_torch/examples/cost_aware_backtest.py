"""Turnover-cost-aware backtest three ways + checkpoint/resume + profiling.

The port's twin of the JAX package's ``examples/cost_aware_backtest.py``:
the capabilities around the reference's transaction-cost machinery
(reference ``qp_problems.py:120-157`` + ``optimization.py:126-137``):

1. **Lifted** (reference-faithful): each date's QP doubles to 2n
   variables with the |w - x0|_1 epigraph rows.
2. **Native prox** (``l1_native=True``): the same cost term handled
   inside the ADMM w-block soft-threshold at n variables.
3. **Sequential scan** (``solve_scan_l1``): the cost chains *solved*
   dates (w_prev feeds the next date's L1 center), warm-started, the
   same chain for a strategy grid split over a device mesh
   (``solve_scan_l1_grid(mesh=)``).

Plus chunk-granular checkpoint/resume (``run_batch_checkpointed``) and
the stage tracer (``porqua_tpu_torch.profiling``).

    python -m porqua_tpu_torch.examples.cost_aware_backtest [--device cpu]
"""

import shutil
import tempfile

import numpy as np
import torch

from porqua_tpu_torch.examples._common import (load_msci_or_synthetic,
                                               parse_device,
                                               quarterly_rebdates)

TC = 0.005  # 50 bps per unit of one-way turnover


def make_service(data, rebdates, **opt_kwargs):
    from porqua_tpu_torch import (BacktestService, LeastSquares,
                                  OptimizationItemBuilder,
                                  SelectionItemBuilder)
    from porqua_tpu_torch.builders import (bibfn_bm_series,
                                           bibfn_box_constraints,
                                           bibfn_budget_constraint,
                                           bibfn_return_series,
                                           bibfn_selection_data)

    n = data["return_series"].shape[1]
    x0 = {a: 1.0 / n for a in data["return_series"].columns}
    return BacktestService(
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
            "box": OptimizationItemBuilder(bibfn=bibfn_box_constraints),
        },
        optimization=LeastSquares(
            transaction_cost=TC, x0=x0, dtype=np.float64,
            eps_abs=1e-8, eps_rel=1e-8, max_iter=20000, **opt_kwargs,
        ),
        settings={"rebdates": rebdates, "quiet": True},
    )


def main(device=None, n_rebdates=12):
    from porqua_tpu_torch import CanonicalQP, run_batch
    from porqua_tpu_torch.batch import (build_problems, solve_scan_l1,
                                        solve_scan_l1_grid)
    from porqua_tpu_torch.checkpoint import run_batch_checkpointed
    from porqua_tpu_torch.parallel import make_mesh
    from porqua_tpu_torch.profiling import Tracer
    from porqua_tpu_torch.qp.solve import SolverParams, resolve_device

    dev = resolve_device(device)
    data = load_msci_or_synthetic()
    rebdates = quarterly_rebdates(data["return_series"].index, k=n_rebdates)
    tracer = Tracer()
    tight = SolverParams(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000)
    f64 = torch.float64

    # 1) Reference-style lifted formulation (2n variables per date).
    with tracer.stage("lifted", dates=len(rebdates)):
        bt_lift = run_batch(make_service(data, rebdates), dtype=f64,
                            device=dev)
    w_lift = bt_lift.strategy.get_weights_df()

    # 2) Native prox path at n variables.
    with tracer.stage("l1_native"):
        bt_nat = run_batch(make_service(data, rebdates, l1_native=True),
                           dtype=f64, device=dev)
    w_nat = bt_nat.strategy.get_weights_df()
    dw_lift = float(np.abs(w_lift.values - w_nat.values).max())
    print("lifted vs native-prox max|dw|:", f"{dw_lift:.2e}")
    iters_nat = np.asarray(bt_nat.output["batch"]["iters"])
    print("per-date iters (native):", iters_nat.tolist())

    # 3) Sequential chain: each date pays cost against the *previous
    #    solved* weights.
    bs = make_service(data, rebdates, l1_native=True)
    problems = build_problems(bs, dtype=f64)
    n = problems.n_assets_max
    with tracer.stage("scan_chain") as holder:
        sols = solve_scan_l1(
            problems.qp, n_assets=n,
            w_init=np.full(n, 1.0 / n), transaction_cost=TC, params=tight,
            universes=problems.universes, device=dev,
        )
        holder["value"] = sols.x
    x_chain = sols.x.cpu().numpy()
    chain_turnover = float(np.abs(np.diff(x_chain[:, :n], axis=0)).sum())
    static_turnover = float(np.abs(np.diff(w_nat.values, axis=0)).sum())
    print(f"chained-cost turnover {chain_turnover:.4f} "
          f"vs static-x0 turnover {static_turnover:.4f}")

    # 3b) The same chained-cost engine for a whole strategy grid: the
    #     dates chained, the strategies one batch, the strategy axis
    #     split over the device mesh (every visible card, up to two).
    n_dev = min(2, torch.cuda.device_count()) if dev.type == "cuda" else 1
    t_demo = min(4, problems.n_dates)  # keep the demo horizon short
    grid = CanonicalQP(*(None if f is None else
                         f[:t_demo].expand((n_dev,) + f[:t_demo].shape)
                         for f in problems.qp))
    mesh = make_mesh(n_dev, axis_names=("bench",), device=dev.type)
    with tracer.stage("scan_grid_sharded") as holder:
        grid_sols = solve_scan_l1_grid(
            grid, n_assets=n, w_init=np.full((n_dev, n), 1.0 / n),
            transaction_cost=TC, mesh=mesh, params=tight,
            universes=problems.universes[:t_demo], device=dev,
        )
        holder["value"] = grid_sols.x
    dgrid = float(np.abs(grid_sols.x.cpu().numpy()
                         - x_chain[None, :t_demo]).max())
    print(f"grid engine ({n_dev}-way sharded, {t_demo} dates) vs single "
          f"column max|dx|: {dgrid:.2e}")

    # 4) Checkpoint/resume: run chunked, then resume from disk (no-op
    #    second pass: all chunks present).
    ckdir = tempfile.mkdtemp(prefix="porqua_ck_")
    try:
        bt_ck = run_batch_checkpointed(
            make_service(data, rebdates, l1_native=True), ckdir,
            chunk_size=4, params=tight, dtype=f64, device=dev)
        bt_resume = run_batch_checkpointed(
            make_service(data, rebdates, l1_native=True), ckdir,
            chunk_size=4, params=tight, dtype=f64, device=dev)
        print("checkpoint chunks:", bt_ck.output["checkpoint"],
              "-> resume:", bt_resume.output["checkpoint"])
        dw_ck = float(np.abs(bt_ck.strategy.get_weights_df().values
                             - bt_resume.strategy.get_weights_df().values)
                      .max())
        print(f"checkpointed vs resumed max|dw|: {dw_ck:.2e}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    print(tracer.report())
    return {"rebdates": rebdates,
            "w_lift": w_lift.reindex(index=rebdates).to_numpy(float),
            "w_native": w_nat.reindex(index=rebdates).to_numpy(float),
            "status_native": np.asarray(bt_nat.output["batch"]["status"]),
            "iters_native": iters_nat,
            "dw_lift": dw_lift,
            "x_chain": x_chain[:, :n],
            "status_chain": sols.status.cpu().numpy(),
            "iters_chain": sols.iters.cpu().numpy(),
            "chain_turnover": chain_turnover,
            "static_turnover": static_turnover,
            "dgrid": dgrid, "n_dev": n_dev,
            "checkpoint": dict(bt_ck.output["checkpoint"]),
            "resume": dict(bt_resume.output["checkpoint"]),
            "dw_checkpoint": dw_ck,
            "stages": tracer.as_dict()}


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
