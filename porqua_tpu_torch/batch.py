"""Batched backtest: every rebalance date of a backtest in one batched
solve (the port of ``porqua_tpu/batch.py``, in part).

* **Pass 1 (host)** — run every selection / optimization item builder
  for every rebalance date (the plug-in bibfn API of the serial
  engine), lower each date to unpadded canonical parts, find the
  largest variable and row counts across dates, and pad everything to
  one shape (CPU tensors, stacked along a leading dates axis).
* **Pass 2 (device)** — move the stacked problems to the device once
  and solve all dates in one batched solve (equilibrate, ADMM through
  the fused segment kernels with ``backend="pallas"``, polish,
  unscale).

The result converts back into the ``Strategy``/``Portfolio`` objects
the serial engine produces, so accounting and reporting are shared.

Not ported yet, and raising ``NotImplementedError`` where reached: the
date-chained scans (``solve_scan_turnover``, ``solve_scan_l1``,
``solve_scan_l1_grid``, including its device-mesh sharding), the
compacted solve (``solve_batch_compacted``), the telemetry ``harvest=``
sink, and the JAX package's ``PORQUA_SANITIZE=1`` transfer guard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from porqua_tpu_torch.backtest import Backtest, BacktestService
from porqua_tpu_torch.portfolio import Portfolio, Strategy
from porqua_tpu_torch.qp.canonical import CanonicalQP, as_torch_dtype, stack_qps
from porqua_tpu_torch.qp.solve import (
    QPSolution,
    SolverParams,
    Status,
    solve_qp_batch,
)
from porqua_tpu_torch.utils.helpers import to_numpy


@dataclasses.dataclass
class BatchProblems:
    """Host-built batch of per-date problems (CPU tensors)."""

    qp: CanonicalQP                 # stacked, leading axis = dates
    rebdates: List[str]
    universes: List[List[str]]      # per-date asset names (len <= n_assets_max)
    n_assets_max: int               # weights live in x[:n_assets_max]
    turnover_rows: Optional[slice] = None   # rows of C holding the x0 bounds
    constants: Optional[np.ndarray] = None
    l1_weight: Optional[torch.Tensor] = None   # (dates, n) native L1 term weights
    l1_center: Optional[torch.Tensor] = None   # (dates, n) native L1 term centers

    @property
    def n_dates(self) -> int:
        return len(self.rebdates)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP queue A, {item})")


def build_problems(bs: BacktestService,
                   rebdates: Optional[Sequence[str]] = None,
                   dtype=torch.float32) -> BatchProblems:
    """Pass 1: run builders for every date, pad to one shape.

    The per-date orchestration of the serial engine
    (``BacktestService.prepare_rebalancing`` + ``set_objective`` +
    canonical lowering), with padding deferred until all dates are
    known. ``dtype`` goes through ``as_torch_dtype``.
    """
    dtype = as_torch_dtype(dtype)
    rebdates = list(bs.settings["rebdates"] if rebdates is None else rebdates)

    parts_list, universes = [], []
    for date in rebdates:
        bs.prepare_rebalancing(rebalancing_date=date)
        bs.optimization.set_objective(optimization_data=bs.optimization_data)
        parts = bs.optimization.canonical_parts()
        parts_list.append(parts)
        universes.append(list(bs.optimization.constraints.selection))

    n_max = max(len(p["q"]) for p in parts_list)
    m_max = max(p["C"].shape[0] for p in parts_list)
    n_assets_max = max(len(u) for u in universes)

    # Carry the objective factor (P == 2 Pf' Pf + diag(Pdiag)) into the
    # batch only when every date has one with the same row count:
    # stacking needs one factor shape. A mixed batch falls back to
    # dense P.
    use_pf = (all("Pf" in p for p in parts_list)
              and len({p["Pf"].shape[0] for p in parts_list}) == 1)
    qps = [
        CanonicalQP.build(
            p["P"], p["q"], C=p["C"], l=p["l"], u=p["u"],
            lb=p["lb"], ub=p["ub"], constant=p.get("constant", 0.0),
            n_max=n_max, m_max=m_max, dtype=dtype,
            Pf=p["Pf"] if use_pf else None,
            Pdiag=p.get("Pdiag") if use_pf else None,
            device="cpu",
        )
        for p in parts_list
    ]
    # build() may have dropped individual dates' factors (rounding-grade
    # drift); a mixed batch cannot stack, so the whole batch goes dense.
    if use_pf and any(qp.Pf is None for qp in qps):
        qps = [qp._replace(Pf=None, Pdiag=None) for qp in qps]
    l1_weight = l1_center = None
    if any("l1_weight" in p for p in parts_list):
        def stacked(key):
            rows = [np.pad(np.asarray(p[key], float), (0, n_max - len(p[key])))
                    if key in p else np.zeros(n_max) for p in parts_list]
            return torch.as_tensor(np.stack(rows), dtype=dtype)

        l1_weight, l1_center = stacked("l1_weight"), stacked("l1_center")

    return BatchProblems(
        qp=stack_qps(qps),
        rebdates=rebdates,
        universes=universes,
        n_assets_max=n_assets_max,
        constants=np.array([p.get("constant", 0.0) for p in parts_list]),
        l1_weight=l1_weight,
        l1_center=l1_center,
    )


def solve_batch(problems: BatchProblems,
                params: SolverParams = SolverParams(),
                harvest=None,
                device=None) -> QPSolution:
    """Pass 2, independent dates: one batched solve on ``device``
    (default: the card). The results stay on the device."""
    if harvest is not None:
        raise _not_ported("the telemetry harvest (harvest=)", "item 18")
    if os.environ.get("PORQUA_SANITIZE") == "1":
        raise _not_ported(
            "the PORQUA_SANITIZE=1 transfer guard of the batched solve",
            "item 23")
    return solve_qp_batch(problems.qp, params,
                          l1_weight=problems.l1_weight,
                          l1_center=problems.l1_center, device=device)


def solve_batch_compacted(problems: BatchProblems,
                          params: SolverParams = SolverParams(),
                          segment_budget: Optional[int] = None,
                          compact: bool = True,
                          driver=None,
                          harvest=None):
    """Pass 2 with segment-level batch compaction (``compaction.py``)."""
    raise _not_ported("solve_batch_compacted (batch compaction)", "item 15")


# Sentinel for scan-coupled entry points: the caller attests that every
# date's problem was built over one identically-ordered asset universe.
FIXED_UNIVERSE = "attested-fixed"


def _require_fixed_universe(universes) -> None:
    """The scan paths carry holdings positionally: variable j must mean
    the same asset on every date. Raise when per-date universes differ,
    and on None; :data:`FIXED_UNIVERSE` attests a fixed universe."""
    if universes is None:
        raise ValueError(
            "scan-coupled solves carry holdings positionally, so they "
            "require the per-date asset universes to verify variable j "
            "means the same asset on every date. Pass "
            "universes=problems.universes (from BatchProblems), or "
            "porqua_tpu_torch.batch.FIXED_UNIVERSE to attest the batch "
            "was built over one identically-ordered universe.")
    if isinstance(universes, str):
        if universes == FIXED_UNIVERSE:
            return
        raise ValueError(
            f"unknown universes attestation {universes!r}; expected "
            f"per-date asset lists or porqua_tpu_torch.batch.FIXED_UNIVERSE")
    first = list(universes[0])
    for i, uni in enumerate(universes):
        if list(uni) != first:
            raise ValueError(
                f"scan-coupled solves require one fixed asset universe "
                f"across dates (the scan carry is positional); date {i} "
                f"differs from date 0. Mask exits with lb = ub = 0 "
                f"instead of shrinking the selection.")


def solve_scan_turnover(qp: CanonicalQP, n_assets: int, row_start: int,
                        w_init, params: SolverParams = SolverParams(), *,
                        universes: Sequence[Sequence[str]]) -> QPSolution:
    """Turnover-constraint-coupled dates, each warm-started from the
    previous solution (the next slice)."""
    raise _not_ported("solve_scan_turnover", "item 12")


def solve_scan_l1(qp: CanonicalQP, n_assets: int, w_init,
                  transaction_cost: float,
                  params: SolverParams = SolverParams(), *,
                  universes: Sequence[Sequence[str]]) -> QPSolution:
    """Turnover-cost-coupled dates through the native L1 prox (the next
    slice)."""
    raise _not_ported("solve_scan_l1", "item 12")


def solve_scan_l1_grid(qp_grid: CanonicalQP, n_assets: int, w_init,
                       transaction_cost: float,
                       params: SolverParams = SolverParams(), mesh=None, *,
                       universes: Sequence[Sequence[str]]) -> QPSolution:
    """Turnover-cost backtests for a benchmark grid, optionally sharded
    over a device mesh (the next slice; the mesh with item 21)."""
    raise _not_ported("solve_scan_l1_grid", "item 12")


def as_requests(problems: BatchProblems) -> List[CanonicalQP]:
    """Unstack a host-built batch into per-date single problems (views
    into the stacked tensors), the bridge to a per-request solve
    service. Batches with a native L1 objective term are rejected: a
    request ``(qp, x0, y0)`` cannot carry it, and dropping it would
    solve a different problem."""
    if problems.l1_weight is not None or problems.l1_center is not None:
        raise ValueError(
            "as_requests cannot bridge a batch with a native L1 "
            "objective term (l1_weight/l1_center): a request carries no "
            "L1 inputs, so it would silently solve a different problem. "
            "Lower the cost term into the constraint rows (qp.lift) "
            "before bridging.")
    return [CanonicalQP(*(None if f is None else f[i] for f in problems.qp))
            for i in range(problems.n_dates)]


def to_strategy(problems: BatchProblems, solution: QPSolution) -> Strategy:
    """Convert batched results into the host ``Strategy`` object."""
    xs = to_numpy(solution.x)
    status = to_numpy(solution.status)
    strategy = Strategy([])
    for i, date in enumerate(problems.rebdates):
        uni = problems.universes[i]
        if status[i] == Status.SOLVED:
            weights = {a: float(xs[i, j]) for j, a in enumerate(uni)}
        else:
            weights = {a: None for a in uni}
        strategy.portfolios.append(Portfolio(rebalancing_date=date, weights=weights))
    return strategy


def assemble_backtest(problems: BatchProblems,
                      solution: QPSolution) -> Backtest:
    """Wrap a batched solution in the serial engine's output type
    (``Backtest`` + ``Strategy``), with the per-date solver counters in
    ``output['batch']`` (numpy)."""
    backtest = Backtest()
    backtest._strategy = to_strategy(problems, solution)
    backtest.output["batch"] = {
        k: to_numpy(getattr(solution, k))
        for k in ("status", "iters", "prim_res", "dual_res", "obj_val")
    }
    return backtest


def run_batch(bs: BacktestService,
              params: Optional[SolverParams] = None,
              dtype=torch.float32,
              harvest=None,
              device=None) -> Backtest:
    """End-to-end batched backtest with the serial engine's output type:
    ``Backtest.run(bs)`` for date-independent strategies, every date
    solved at once on ``device`` (default: the card; with no card and
    no ``device`` it raises)."""
    # Build first, then default to the strategy's own resolved solver
    # configuration for the batch dtype (LAD's overlay keys on the
    # dtype actually solved).
    problems = build_problems(bs, dtype=dtype)
    if params is None:
        params = bs.optimization.solver_params(solve_dtype=dtype)
    solution = solve_batch(problems, params, harvest=harvest, device=device)
    return assemble_backtest(problems, solution)
