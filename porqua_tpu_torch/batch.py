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
* **Pass 2, chained dates** — where a turnover constraint or cost
  couples each date to the previous solution, a host loop over dates
  (the JAX package's ``lax.scan``) solves one date at a time on the
  device, warm-started from the previous date's (x, y) and carrying the
  holdings: ``solve_scan_turnover`` (the constraint's rows),
  ``solve_scan_l1`` (the native L1 prox) and ``solve_scan_l1_grid``
  (one lane per benchmark column, every column's date solved as one
  batch).

The result converts back into the ``Strategy``/``Portfolio`` objects
the serial engine produces, so accounting and reporting are shared.

* **Pass 2, compacted** — ``solve_batch_compacted`` runs the segment
  loop on the host (``compaction.py``): converged dates retire at the
  boundary they converge, and the dispatch width walks down the slot
  ladder.

Not ported yet, and raising ``NotImplementedError`` where reached: the
device-mesh sharding of ``solve_scan_l1_grid`` (``mesh=``), the
telemetry ``harvest=`` sink, and the JAX package's ``PORQUA_SANITIZE=1``
transfer guard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from porqua_tpu_torch.backtest import Backtest, BacktestService
from porqua_tpu_torch.portfolio import Portfolio, Strategy
from porqua_tpu_torch.qp.canonical import (HP, CanonicalQP, as_torch_dtype,
                                           stack_qps)
from porqua_tpu_torch.qp.solve import (
    QPSolution,
    SolverParams,
    Status,
    _solve_impl,
    resolve_device,
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
                          harvest=None,
                          device=None):
    """Pass 2 with segment-level batch compaction: wall clock tracks the
    useful work instead of the slowest lane (:mod:`porqua_tpu_torch.compaction`).
    Converged dates match :func:`solve_batch`'s (bit for bit where the
    segment's arithmetic does not depend on the width, README's port
    section); a date past ``segment_budget`` segments retires as
    MAX_ITER with the polish fallback. Returns ``(QPSolution,
    CompactionReport)``. A shared ``driver`` reuses its warmed entries
    and must carry these ``params``; otherwise a new one runs on
    ``device`` (default: the card). ``harvest=`` and
    ``PORQUA_SANITIZE=1`` raise, as in :func:`solve_batch`."""
    from porqua_tpu_torch.compaction import solve_batch_compacted as _solve

    return _solve(problems.qp, params, segment_budget=segment_budget,
                  l1_weight=problems.l1_weight,
                  l1_center=problems.l1_center, compact=compact,
                  driver=driver, harvest=harvest, device=device)


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


def _lanes(qp: CanonicalQP) -> CanonicalQP:
    """A single column's stacked dates ``(T, ...)`` as one lane
    ``(1, T, ...)`` (views)."""
    return CanonicalQP(*(None if f is None else f.unsqueeze(0) for f in qp))


def _date(qp: CanonicalQP, t: int) -> CanonicalQP:
    """Date ``t`` of a ``(lanes, T, ...)`` batch: a ``(lanes, ...)``
    view, never written."""
    return CanonicalQP(*(None if f is None else f[:, t] for f in qp))


def _stack_dates(sols: List[QPSolution]) -> QPSolution:
    """Per-date ``(lanes, ...)`` solutions stacked as ``(lanes, T, ...)``,
    the layout ``lax.scan`` under ``vmap`` gives."""
    return QPSolution(*(None if f[0] is None else torch.stack(f, dim=1)
                        for f in zip(*sols)))


def _one_lane(sol: QPSolution) -> QPSolution:
    return QPSolution(*(None if f is None else f[0] for f in sol))


def _on_device(qp: CanonicalQP, device) -> CanonicalQP:
    """The stacked problems on the entry point's device (default: the
    card), under the precision policy."""
    HP.apply()
    return qp.to(resolve_device(device))


def _l1_weight(nvar: int, n_assets: int, transaction_cost: float, dtype,
               device) -> torch.Tensor:
    """``transaction_cost`` on the first ``n_assets`` variables, 0 on
    padding."""
    tc = torch.tensor(transaction_cost, dtype=dtype, device=device)
    return torch.where(torch.arange(nvar, device=device) < n_assets, tc,
                       torch.zeros((), dtype=dtype, device=device))


def _holdings(w_init, n_assets: int, lanes: int, nvar: int, dtype,
              device) -> torch.Tensor:
    """The pre-backtest holdings, ``(lanes, nvar)``, zero on padding."""
    w = torch.as_tensor(w_init, dtype=dtype).to(device)
    w0 = torch.zeros((lanes, nvar), dtype=dtype, device=device)
    w0[:, :n_assets] = w.reshape(lanes, -1)[:, :n_assets]
    return w0


def solve_scan_turnover(qp: CanonicalQP,
                        n_assets: int,
                        row_start: int,
                        w_init,
                        params: SolverParams = SolverParams(),
                        *,
                        universes: Sequence[Sequence[str]],
                        device=None) -> QPSolution:
    """Turnover-constraint-coupled dates, one date at a time with warm
    starts, on ``device`` (default: the card).

    The lifted problem's constraint rows ``[row_start, row_start+n)``
    carry the upper bound ``x0`` and rows ``[row_start+n,
    row_start+2n)`` carry ``-x0`` (:func:`porqua_tpu_torch.qp.lift.
    lift_turnover_constraint`). Each date writes the previous date's
    holdings into a copy of ``u`` at those rows and warm-starts from
    the previous primal/dual point. ``qp`` is a stacked batch (leading
    axis = dates) built with placeholder x0 = 0; ``w_init`` the
    pre-backtest holdings; ``universes`` the per-date asset lists or
    :data:`FIXED_UNIVERSE` (checked, not optional). Holdings advance
    only on a SOLVED date (the reference keeps the previous portfolio
    when a date fails)."""
    _require_fixed_universe(universes)
    qp = _lanes(_on_device(qp, device))
    dtype, dev = qp.q.dtype, qp.q.device
    w0 = _holdings(w_init, n_assets, 1, qp.q.shape[-1], dtype, dev)
    return _one_lane(_scan_dates(
        qp, w0, params, _turnover_rows(row_start, n_assets)))


def _turnover_rows(row_start: int, n: int):
    """The turnover scan's per-date problem: the holdings ``w`` (their
    first ``n`` entries) written into a copy of ``u`` at rows
    ``[row_start, row_start+n)`` and their negation at ``[row_start+n,
    row_start+2n)``, the JAX package's ``dynamic_update_slice`` pair."""
    def date_problem(qp_t: CanonicalQP, w):
        u = qp_t.u.clone()
        u[:, row_start:row_start + n] = w[:, :n]
        u[:, row_start + n:row_start + 2 * n] = -w[:, :n]
        return qp_t._replace(u=u), {}
    return date_problem


def solve_scan_l1(qp: CanonicalQP,
                  n_assets: int,
                  w_init,
                  transaction_cost: float,
                  params: SolverParams = SolverParams(),
                  *,
                  universes: Sequence[Sequence[str]],
                  device=None) -> QPSolution:
    """Turnover-cost-coupled dates through the native L1 prox, on
    ``device`` (default: the card).

    Each date pays ``transaction_cost * |w - w_prev|_1`` against the
    previous date's *solved* weights through the solver's L1 prox at n
    variables, warm-started from the previous date's (x, y). ``qp`` is
    a stacked batch (leading axis = dates) over one identically-ordered
    asset universe: the carry is positional. ``universes``: the per-date
    asset lists or :data:`FIXED_UNIVERSE`. ``w_init``: the pre-backtest
    holdings (zeros for a cash start). Returns a :class:`QPSolution`
    with a leading dates axis."""
    _require_fixed_universe(universes)
    qp = _lanes(_on_device(qp, device))
    dtype, dev = qp.q.dtype, qp.q.device
    nvar = qp.q.shape[-1]
    l1w = _l1_weight(nvar, n_assets, transaction_cost, dtype, dev)
    w0 = _holdings(w_init, n_assets, 1, nvar, dtype, dev)
    return _one_lane(_scan_l1_core(qp, w0, l1w, params))


def _scan_l1_core(qp: CanonicalQP, w0, l1w,
                  params: SolverParams,
                  x_init=None, y_init=None,
                  return_carry: bool = False):
    """The chained-L1 backtest, shared by :func:`solve_scan_l1` (one
    lane), :func:`solve_scan_l1_grid` (a lane per benchmark column) and
    the checkpointed runner: :func:`_scan_dates` with the L1 term
    ``l1w`` (broadcast against the ``(lanes, nvar)`` holdings) centered
    on the holdings."""
    return _scan_dates(qp, w0, params, _l1_cost(l1w), x_init, y_init,
                       return_carry)


def _l1_cost(l1w):
    """The L1 scans' per-date problem: the date as built, with the L1
    term ``l1w`` centered on the holdings ``w``."""
    def date_problem(qp_t: CanonicalQP, w):
        return qp_t, dict(l1_weight=l1w.expand_as(w), l1_center=w)
    return date_problem


def _scan_dates(qp: CanonicalQP, w0, params: SolverParams, date_problem,
                x_init=None, y_init=None, return_carry: bool = False):
    """The one date loop of every chained backtest, so the carry and
    failed-date semantics cannot drift between them.

    ``qp`` has leading ``(lanes, T)`` axes on the device; ``w0`` is the
    ``(lanes, nvar)`` holdings before date 0. ``date_problem(qp_t, w)``
    gives date t's problem and the L1 keywords of ``_solve_impl`` from
    the date's ``(lanes, ...)`` view (never written) and the holdings.
    ``x_init`` / ``y_init`` seed the warm-start half of the carry
    (default zeros, a cold start) and ``return_carry=True`` also
    returns the final ``(w, x, y)`` carry: together they let
    :func:`porqua_tpu_torch.checkpoint.solve_scan_l1_checkpointed` cut
    the dates into segments whose chained run is bit-identical to one
    uncut run."""
    dtype, dev = qp.q.dtype, qp.q.device
    lanes, T, nvar = qp.q.shape
    m = qp.l.shape[-1]
    w_prev = w0
    x_prev = (torch.zeros((lanes, nvar), dtype=dtype, device=dev)
              if x_init is None else torch.as_tensor(x_init, dtype=dtype)
              .to(dev).reshape(lanes, nvar))
    y_prev = (torch.zeros((lanes, m), dtype=dtype, device=dev)
              if y_init is None else torch.as_tensor(y_init, dtype=dtype)
              .to(dev).reshape(lanes, m))
    sols = []
    for t in range(T):
        qp_t, kw = date_problem(_date(qp, t), w_prev)
        sol = _solve_impl(qp_t, params, x_prev, y_prev, **kw)
        # Holdings advance only on a SOLVED date (the reference keeps
        # the previous portfolio when a date fails), with no host read.
        ok = (sol.status == Status.SOLVED)[:, None]
        w_prev = torch.where(ok, sol.x, w_prev)
        x_prev, y_prev = sol.x, sol.y
        sols.append(sol)
    sols = _stack_dates(sols)
    if return_carry:
        return sols, (w_prev, x_prev, y_prev)
    return sols


def solve_scan_l1_grid(qp_grid: CanonicalQP,
                       n_assets: int,
                       w_init,
                       transaction_cost: float,
                       params: SolverParams = SolverParams(),
                       mesh=None,
                       *,
                       universes: Sequence[Sequence[str]],
                       device=None) -> QPSolution:
    """Turnover-cost backtests for a whole benchmark grid on one
    ``device`` (default: the card): the dates are chained, the columns
    independent, so each date's problems of all B columns are solved as
    one batch of B lanes, each lane with its own holdings and warm
    start (the JAX package's ``vmap`` of the scan).

    ``qp_grid`` has leading ``(B, T)`` axes over one fixed asset
    universe per column (``universes`` checks it); ``w_init`` is
    ``(B, n)``. The device-mesh sharding (``mesh=``) is not ported."""
    _require_fixed_universe(universes)
    if qp_grid.P.dim() != 4:
        raise ValueError(
            f"qp_grid must have leading (benchmarks, dates) axes: P of "
            f"shape (B, T, n, n), got {tuple(qp_grid.P.shape)}; for a "
            f"single column use solve_scan_l1")
    if mesh is not None:
        raise _not_ported(
            "the device-mesh sharding of solve_scan_l1_grid (mesh=)",
            "item 21")
    qp_grid = _on_device(qp_grid, device)
    dtype, dev = qp_grid.q.dtype, qp_grid.q.device
    B, nvar = qp_grid.q.shape[0], qp_grid.q.shape[-1]
    l1w = _l1_weight(nvar, n_assets, transaction_cost, dtype, dev)
    w0 = _holdings(w_init, n_assets, B, nvar, dtype, dev)
    return _scan_l1_core(qp_grid, w0, l1w, params)


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
