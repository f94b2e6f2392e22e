"""Segment-level batch compaction: straggler-free batched solving (the
port of ``porqua_tpu/compaction.py``).

The fused batch solve runs one segment loop for the whole batch, so
every lane pays for the slowest. This driver runs the loop on the host
over the stepped batch API (:func:`porqua_tpu_torch.qp.solve.prepare_batch`
/ ``segment_step_batch`` / ``finalize_batch``):

1. run one residual-check segment for the current lane group;
2. repack on the device: lanes that had already retired are frozen by
   a per-lane select (the fused loop's semantics), the still-running
   lanes are stably sorted to the front, and every lane's state is
   scattered into a full-batch result buffer at its original index;
3. read back one scalar (the active-lane count, the only host read per
   boundary) and cut the group down the serving slot ladder
   (:func:`porqua_tpu_torch.serve.bucketing.slot_ladder`), so every
   compacted width is one of about log2(B) warmed entries;
4. when no lane is left running, one full-batch ``finalize`` polishes,
   unscales and grades every lane in its original order.

Per-lane arithmetic is the code the fused path runs. On the CPU the
segment's batched products give every lane the same bits at every
width from 2 up (width 1 is excluded by ``min_dispatch``, as in the
JAX package), so converged lanes are bit-identical to the fused
``solve_qp_batch``; on the card the kernels run one thread-block
cluster per problem, while the operator build's batched library calls
may pick another algorithm at another width (README's port section
and ROADMAP section C give what was measured). A per-lane
``segment_budget`` retires stragglers to MAX_ITER with the polish
fallback.

"Compiling" an entry here means what it means for the serving entries
(``qp/solve.py::aot_compile_batch``): bind the step to a width, resolve
the kernel form that width launches (``kernel_form`` raises where none
fits) and run it once on a neutral group, which loads the kernel
library and creates the solver handles. ``prewarm`` does that for the
whole ladder, so a measured solve demands no compile; every demand is
reported to :mod:`porqua_tpu_torch.analysis.sanitize`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from porqua_tpu_torch.analysis import sanitize, tsan
from porqua_tpu_torch.obs import profile as _profile
from porqua_tpu_torch.qp.admm import Status
from porqua_tpu_torch.qp.canonical import HP, CanonicalQP
from porqua_tpu_torch.qp.solve import (
    SolverParams,
    batch_shape_struct,
    default_segment_budget,
    finalize_batch,
    kernel_form,
    map_tensors,
    neutral_batch,
    prepare_batch,
    resolve_device,
    segment_step_batch,
    select_lanes,
)
from porqua_tpu_torch.serve.batcher import device_kind, device_label
from porqua_tpu_torch.serve.bucketing import slot_ladder

__all__ = [
    "CompactingDriver",
    "CompactionReport",
    "iter_segments",
    "lane_active",
    "step_and_repack",
    "solve_batch_compacted",
]


def iter_segments(iters, check_interval: int):
    """Per-lane executed segments from recorded iteration counts
    (``iters`` advances by exactly ``check_interval`` per segment)."""
    it = np.asarray(iters, dtype=np.int64)
    return np.maximum(-(-it // int(check_interval)), 1)


def lane_active(state, seg_left, params: SolverParams):
    """Which lanes still step: RUNNING, inside the fused path's
    iteration budget, and inside the driver's per-lane segment budget
    (at the default budget the last two agree, so compaction-off
    semantics match ``solve_qp_batch``)."""
    return ((state.status == Status.RUNNING)
            & (state.iters < params.max_iter)
            & (seg_left > 0))


def _take(tree, index):
    """Every tensor of a (nested) group indexed on its lane axis."""
    return map_tensors(lambda a: a[index], tree)


def step_and_repack(buf, group, params: SolverParams):
    """One compacted segment and the device-side repack.

    ``buf`` is the full-batch ``ADMMState`` result buffer; ``group`` the
    working set ``(scaled, scaling, carry, l1w_s, l1c_s, idx,
    seg_left)`` where ``idx`` maps a compacted position to its original
    lane. Returns ``(buf', group', n_active)`` with the still-active
    lanes stably sorted to the front of ``group'`` and ``n_active`` a
    device scalar (the caller reads it: the one host read per
    boundary)."""
    scaled, scaling, carry, l1w_s, l1c_s, idx, seg_left = group
    active_in = lane_active(carry.state, seg_left, params)
    stepped = segment_step_batch(scaled, scaling, carry, params,
                                 l1w_s, l1c_s)
    # Freeze lanes that had already retired (ladder-padding slots), as
    # the fused loop's per-lane select does.
    carry = select_lanes(active_in, stepped, carry)
    seg_left = torch.where(active_in, seg_left - 1, seg_left)
    # Scatter back at the original lane order; frozen lanes rewrite
    # their unchanged state.
    buf = type(buf)(*(None if f is None else f.index_copy(0, idx, v)
                      for f, v in zip(buf, carry.state)))
    active = lane_active(carry.state, seg_left, params)
    order = torch.argsort(torch.logical_not(active).to(torch.int32),
                          stable=True)
    group = _take((scaled, scaling, carry, l1w_s, l1c_s, idx, seg_left),
                  order)
    return buf, group, torch.sum(active).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class CompactionReport:
    """Work accounting for one compacted solve (the A/B evidence)."""

    batch: int
    segments: int                  # boundaries executed (dispatch count)
    lane_segments: int             # sum of dispatch widths: work executed
    dense_lane_segments: int       # batch * max per-lane segments (the
    #                                fused loop's cost)
    useful_lane_segments: int      # sum of per-lane segments needed
    wasted_fraction_dense: float   # 1 - useful/dense, compaction off
    wasted_fraction: float         # 1 - useful/executed, compaction on
    dispatch_sizes: Tuple[int, ...]
    compiles: int                  # entries built during this solve
    max_iter_lanes: int            # lanes graded MAX_ITER after polish
    # Per-solve stage/roofline profile (obs.profile.qp_solve_profile:
    # the analytic model against the solve's wall seconds, with the
    # init / segment_step / finalize stage seconds).
    profile: Optional[dict] = None

    @property
    def savings_vs_dense(self) -> float:
        """Fraction of the fused path's lane-segments not executed."""
        if not self.dense_lane_segments:
            return 0.0
        return 1.0 - self.lane_segments / self.dense_lane_segments


class CompactingDriver:
    """Host orchestration and a cache of warmed entries for compacted
    solves.

    One driver holds one :class:`SolverParams` and warms three entry
    kinds per batch shape and device: ``init`` (equilibrate and build
    the carry, full batch), ``step`` (one segment and the repack, one
    per slot-ladder width) and ``finalize`` (polish, unscale, grade,
    full batch). :meth:`prewarm` warms the whole ladder, so a measured
    solve demands none; each demand is reported to
    :mod:`porqua_tpu_torch.analysis.sanitize` (one after prewarm raises
    under ``PORQUA_SANITIZE=1``). Runs on ``device`` (default: the
    card).
    """

    def __init__(self,
                 params: SolverParams = SolverParams(),
                 segment_budget: Optional[int] = None,
                 min_dispatch: int = 2,
                 device=None,
                 profiler=None) -> None:
        self.params = params
        # Optional porqua_tpu_torch.obs.StageProfiler: the dispatches
        # are bracketed with porqua/<stage> profiler ranges either way;
        # a profiler also accumulates per-stage host seconds.
        self.profiler = profiler
        if segment_budget is not None and segment_budget < 1:
            raise ValueError("segment_budget must be >= 1")
        self.segment_budget = int(segment_budget
                                  or default_segment_budget(params))
        # Never compact below this width (clamped to the batch size):
        # a width-1 batched product may take another summation order,
        # as in the JAX package.
        self.min_dispatch = max(1, int(min_dispatch))
        self.device = resolve_device(device)
        self._lock = tsan.lock("CompactingDriver")
        self._cache: dict = {}          # guarded-by: self._lock
        self.compiles = 0               # guarded-by: self._lock
        self._sealed = False            # guarded-by: self._lock
        self._neutral: dict = {}        # warm-up inputs, per shape key

    # -- warmed entries ----------------------------------------------

    def _shape_key(self, B: int, n: int, m: int, factor_rows, dtype,
                   has_warm: bool, has_l1: bool) -> tuple:
        # The segment budget is a runtime input, not part of an entry's
        # identity: one warmed ladder serves every budget.
        return (B, n, m, factor_rows, dtype, bool(has_warm),
                bool(has_l1), str(self.device))

    def _get(self, key: tuple, build):
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                return entry
            sealed = self._sealed
        # Note the demand before building, so a refused post-warmup
        # compile under PORQUA_SANITIZE=1 never half-fills the cache.
        sanitize.note_compile(f"compaction {key}", post_warmup=sealed)
        entry = build()
        with self._lock:
            self._cache[key] = entry
            self.compiles += 1
        return entry

    @staticmethod
    def _struct(skey):
        B, n, m, fr, dtype = skey[:5]
        return batch_shape_struct(B, n, m, dtype=dtype, factor_rows=fr)

    def _neutral_group(self, skey):
        """A full-width group of neutral problems (and their full-batch
        QP) on the driver's device: what warming runs on. Kept for the
        rest of one prewarm."""
        if skey not in self._neutral:
            B, n, m, _, dtype, has_warm, has_l1, _ = skey
            qp = neutral_batch(self._struct(skey), self.device)
            zeros = lambda k: torch.zeros((B, k), dtype=dtype,
                                          device=self.device)
            extra = ((zeros(n), zeros(m)) if has_warm else ()) + \
                ((zeros(n), zeros(n)) if has_l1 else ())
            self._neutral[skey] = (
                qp, self._init_fn(has_warm, has_l1)(qp, 1, *extra))
        return self._neutral[skey]

    def _init_fn(self, has_warm: bool, has_l1: bool):
        params = self.params

        def entry(qp, budget, *extra):
            x0 = y0 = l1w = l1c = None
            if has_warm:
                x0, y0, extra = extra[0], extra[1], extra[2:]
            if has_l1:
                l1w, l1c = extra
            scaled, scaling, carry, l1w_s, l1c_s = prepare_batch(
                qp, params, x0, y0, l1w, l1c)
            B = qp.q.shape[0]
            idx = torch.arange(B, device=qp.q.device)
            seg_left = torch.full((B,), int(budget), dtype=torch.int32,
                                  device=qp.q.device)
            return scaled, scaling, carry, l1w_s, l1c_s, idx, seg_left

        return entry

    def _entry_init(self, skey):
        def build():
            self._neutral_group(skey)
            return self._init_fn(*skey[5:7])

        return self._get(("init",) + skey, build)

    def _entry_step(self, skey, b: int):
        params = self.params

        def entry(buf, group):
            return step_and_repack(buf, group, params)

        def build():
            struct = self._struct(skey)
            sub = map_tensors(lambda t: t[:b], struct)
            kernel_form(sub, params, self.device)
            _, group = self._neutral_group(skey)
            group = _take(group, slice(0, b))
            entry(group[2].state, group)
            return entry

        return self._get(("step", b) + skey, build)

    def _entry_finalize(self, skey):
        params = self.params

        def entry(qp, scaled, scaling, state, *l1):
            return finalize_batch(qp, scaled, scaling, state, params, *l1)

        def build():
            qp, group = self._neutral_group(skey)
            scaled, scaling, carry, l1w_s, l1c_s = group[:5]
            l1 = ((torch.zeros_like(qp.q), torch.zeros_like(qp.q), l1w_s,
                   l1c_s) if skey[6] else ())
            entry(qp, scaled, scaling, carry.state, *l1)
            return entry

        return self._get(("finalize",) + skey, build)

    # -- public API ---------------------------------------------------

    def prewarm(self, batch: int, n: int, m: int,
                dtype=torch.float32, factor_rows: Optional[int] = None,
                has_warm: bool = False, has_l1: bool = False) -> int:
        """Warm init, finalize and every slot-ladder step entry for one
        batch shape; returns the number warmed. Afterwards a solve at
        this shape demands no compile, and under ``PORQUA_SANITIZE=1``
        any further demand raises."""
        HP.apply()
        skey = self._shape_key(batch, n, m, factor_rows, dtype,
                               has_warm, has_l1)
        with self._lock:
            before = self.compiles
            self._sealed = False
        self._entry_init(skey)
        for b in slot_ladder(batch):
            self._entry_step(skey, b)
        self._entry_finalize(skey)
        self._neutral.clear()
        with self._lock:
            self._sealed = True
            return self.compiles - before

    def solve(self, qp: CanonicalQP,
              x0=None,
              y0=None,
              l1_weight=None,
              l1_center=None,
              compact: bool = True,
              segment_budget: Optional[int] = None):
        """Solve a stacked batch; returns ``(QPSolution,
        CompactionReport)`` with the solution on the driver's device.
        ``compact=False`` runs the same segment-stepped loop at full
        width every boundary (the A/B control). ``segment_budget``
        overrides the driver's default for this call."""
        if (x0 is None) != (y0 is None):
            raise ValueError("x0 and y0 must be given together")
        if (l1_weight is None) != (l1_center is None):
            raise ValueError("l1_weight and l1_center must be given "
                             "together")
        if segment_budget is not None and segment_budget < 1:
            raise ValueError("segment_budget must be >= 1")
        HP.apply()
        budget = int(segment_budget or self.segment_budget)
        dev = self.device
        move = lambda t: None if t is None else torch.as_tensor(t).to(dev)
        qp = qp.to(dev)
        B, n, m = int(qp.q.shape[0]), qp.n, qp.m
        fr = None if qp.Pf is None else int(qp.Pf.shape[-2])
        has_warm, has_l1 = x0 is not None, l1_weight is not None
        skey = self._shape_key(B, n, m, fr, qp.q.dtype, has_warm, has_l1)
        with self._lock:
            compiles0 = self.compiles
        ladder = slot_ladder(B)
        extra = tuple(move(t) for t in (x0, y0, l1_weight, l1_center)
                      if t is not None)

        sizes: List[int] = []
        # Host brackets around the dispatches; the step loop reads the
        # active count at every boundary and the finalize is read
        # below, so the brackets cover dispatch and completion.
        stage_s = {"init": 0.0, "segment_step": 0.0, "finalize": 0.0}
        t_solve0 = time.perf_counter()
        with sanitize.transfer_guard():
            with _profile.profiled_stage(self.profiler, "init",
                                         "init") as prof:
                out = self._entry_init(skey)(qp, budget, *extra)
            stage_s["init"] += prof["seconds"]
            scaled, scaling, carry, l1w_s, l1c_s, idx, seg_left = out
            # Full-batch references for the finalize pass.
            scaled_full, scaling_full = scaled, scaling
            l1ws_full, l1cs_full = l1w_s, l1c_s
            buf = carry.state
            group = (scaled, scaling, carry, l1w_s, l1c_s, idx, seg_left)
            b = B
            while True:
                with _profile.profiled_stage(self.profiler, "segment_step",
                                             "segment_step") as prof:
                    buf, group, n_active = self._entry_step(skey, b)(
                        buf, group)
                    sizes.append(b)
                    # The one declared host read per segment boundary.
                    with sanitize.explicit_transfer():
                        n_act = int(n_active)
                stage_s["segment_step"] += prof["seconds"]
                if n_act == 0:
                    break
                if compact:
                    floor = min(self.min_dispatch, B)
                    b_next = next(s for s in ladder
                                  if s >= max(n_act, floor))
                    if b_next < b:
                        group = _take(group, slice(0, b_next))
                        b = b_next
            l1_args = ((move(l1_weight), move(l1_center), l1ws_full,
                        l1cs_full) if has_l1 else ())
            with _profile.profiled_stage(self.profiler, "finalize",
                                         "finalize") as prof:
                sol = self._entry_finalize(skey)(qp, scaled_full,
                                                 scaling_full, buf, *l1_args)
                with sanitize.explicit_transfer():
                    iters = sol.iters.cpu().numpy()
            stage_s["finalize"] += prof["seconds"]
        self._neutral.clear()

        solve_wall = time.perf_counter() - t_solve0
        status = sol.status.cpu().numpy()
        segs = iter_segments(iters, self.params.check_interval)
        useful = int(segs.sum())
        dense = int(B * segs.max())
        executed = int(sum(sizes))
        with self._lock:
            compiled = self.compiles - compiles0
        profile = _profile.qp_solve_profile(
            n, m, float(iters.mean()) if iters.size else 0.0, solve_wall,
            params=self.params, batch=B, factor_rows=fr,
            device_kind=device_kind(device_label(dev)),
            stage_seconds=stage_s)
        report = CompactionReport(
            batch=B,
            segments=len(sizes),
            lane_segments=executed,
            dense_lane_segments=dense,
            useful_lane_segments=useful,
            wasted_fraction_dense=(1.0 - useful / dense) if dense else 0.0,
            wasted_fraction=(1.0 - useful / executed) if executed else 0.0,
            dispatch_sizes=tuple(sizes),
            compiles=compiled,
            max_iter_lanes=int(np.sum(status == Status.MAX_ITER)),
            profile=profile,
        )
        return sol, report


def solve_batch_compacted(qp: CanonicalQP,
                          params: SolverParams = SolverParams(),
                          segment_budget: Optional[int] = None,
                          x0=None, y0=None,
                          l1_weight=None, l1_center=None,
                          compact: bool = True,
                          driver: Optional[CompactingDriver] = None,
                          harvest=None,
                          device=None):
    """One-shot convenience over :class:`CompactingDriver`; returns
    ``(QPSolution, CompactionReport)``. A shared ``driver`` reuses its
    warmed entries across calls; its SolverParams must match
    ``params`` (a mismatch raises rather than solving at the driver's
    tolerance). ``device`` builds a new driver there (default: the
    card); a given driver keeps its own. ``harvest`` (a
    :class:`porqua_tpu_torch.obs.HarvestSink`) appends one SolveRecord
    per lane with the report's compaction accounting and stage profile
    attached (source ``batch.compacted``)."""
    if driver is None:
        driver = CompactingDriver(params, segment_budget=segment_budget,
                                  device=device)
    elif driver.params != params:
        raise ValueError(
            "the shared driver was built for different SolverParams "
            "than this call requests; construct a CompactingDriver "
            "with these params (or omit driver)")
    sol, report = driver.solve(qp, x0=x0, y0=y0, l1_weight=l1_weight,
                               l1_center=l1_center, compact=compact,
                               segment_budget=segment_budget)
    if harvest is not None:
        from porqua_tpu_torch.obs.harvest import (device_label_of,
                                                  harvest_solution)

        harvest_solution(
            harvest, sol, params, "batch.compacted",
            warm=x0 is not None,
            warm_src=None if x0 is None else "caller",
            solve_s=(report.profile or {}).get("seconds"),
            device=device_label_of(sol),
            compaction={
                "lane_segments": report.lane_segments,
                "dense_lane_segments": report.dense_lane_segments,
                "useful_lane_segments": report.useful_lane_segments,
                "segments": report.segments,
                "compiles": report.compiles,
            },
            profile=report.profile)
    return sol, report
