"""Continuous batching: freed cohort slots refill at segment boundaries
(the port of ``porqua_tpu/serve/continuous.py``).

The classic :class:`~porqua_tpu_torch.serve.batcher.MicroBatcher`
dispatches a batch as one fused solve, so every request in it waits
for the slowest lane. This batcher runs a **cohort** of fixed device
shape one residual-check segment at a time
(:func:`porqua_tpu_torch.qp.solve.aot_compile_continuous`; with
``backend="pallas"`` on the card, one fused kernel launch per segment),
and at every boundary

* lanes whose status left ``RUNNING``, or that used up their per-lane
  ``segment_budget``, retire at once: one cohort-wide ``finalize``
  (polish + unscale + grade; an out-of-budget lane becomes
  ``MAX_ITER`` with the polish fallback) and their futures resolve now;
* freed slots are refilled from the queue through ``admit``
  (equilibrate + carry init for the new lanes; the select keeps every
  other lane's state intact).

All three entries are compiled per ``(bucket, slots, device)`` through
the same :class:`~porqua_tpu_torch.serve.bucketing.ExecutableCache`
(prewarm with ``continuous=True``), so steady state compiles nothing.

Solver routing binds at cohort creation: a cohort's compiled triple is
one backend's, so every lane admitted over its life runs that backend,
and a route flip takes effect at the next cohort.

Device faults: a cohort's carry lives on one device, so a mid-flight
failure cannot migrate — the cohort's requests fail (``SolveError``),
the breaker records the fault, and the next cohort forms on whatever
device the health manager then trusts. Sanitizer violations fail the
cohort without opening the breaker.

Known cost (as in the JAX package): ``admit`` takes the whole stacked
cohort problem buffer, so each admission boundary pays a full-cohort
host-to-device copy and an all-slots equilibration of which only the
admitted rows survive the select.
"""

from __future__ import annotations

import collections
import queue
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from porqua_tpu_torch.analysis import sanitize
from porqua_tpu_torch.obs import profile as _profile
from porqua_tpu_torch.qp.admm import Status
from porqua_tpu_torch.qp.canonical import CanonicalQP, stack_qps
from porqua_tpu_torch.qp.solve import (
    batch_shape_struct,
    default_segment_budget,
    map_tensors,
    neutral_batch,
)
from porqua_tpu_torch.resilience import faults as _faults
from porqua_tpu_torch.serve.batcher import (
    MicroBatcher,
    SolveError,
    SolveRequest,
    _corrupt_lanes,
    device_label,
    host_solution,
)
from porqua_tpu_torch.serve.bucketing import Bucket, slot_count
from porqua_tpu_torch.serve.tenancy import DEFAULT_TENANT

__all__ = ["ContinuousBatcher"]


def _neutral_qp(bucket: Bucket, dtype) -> CanonicalQP:
    """The problem an empty slot holds (host tensors):
    :func:`porqua_tpu_torch.qp.solve.neutral_batch` at the bucket's
    shape — identity objective, free rows, variables pinned to zero."""
    struct = batch_shape_struct(1, bucket.n, bucket.m, dtype=dtype,
                                factor_rows=bucket.factor_rows)
    return CanonicalQP(*(None if f is None else f[0]
                         for f in neutral_batch(struct, "cpu")))


class _Cohort:
    """One fixed-shape, device-resident lane group."""

    def __init__(self, bucket: Bucket, slots: int, dtype, device,
                 exes) -> None:
        self.slots = slots
        self.device = device
        self.admit_exe, self.step_exe, self.fin_exe, structs = exes
        self.reqs: List[Optional[SolveRequest]] = [None] * slots
        self.warm = [False] * slots
        self.seg_count = np.zeros(slots, np.int64)
        # Span-tiling anchor: the monotonic time each slot's request
        # was admitted (its queue_wait ends, its "solve" span starts).
        self.admit_t = np.zeros(slots, np.float64)
        self.active = np.zeros(slots, bool)
        self.neutral = _neutral_qp(bucket, dtype)
        # One persistent stacked host buffer for the cohort's problem
        # data: admissions write only their slot's rows in place.
        self.qp_stack: CanonicalQP = stack_qps([self.neutral] * slots)
        self.x0 = torch.zeros((slots, bucket.n), dtype=dtype)
        self.y0 = torch.zeros((slots, bucket.m), dtype=dtype)
        # Device state: every slot starts from the neutral problem's
        # own prepared state (one admit over the neutral buffer), so
        # the segments computed for empty slots stay well conditioned.
        zeros = map_tensors(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            structs)
        self.qp_dev, self.scaled, self.scaling, self.carry = self.admit_exe(
            self.qp_stack, self.x0, self.y0,
            torch.ones(slots, dtype=torch.bool), *zeros)
        self.staged: List[int] = []     # slots awaiting an admit
        # Set when the queue outgrows this cohort: stop refilling so it
        # drains and a larger replacement forms from the backlog.
        self.no_refill = False
        # Which backend's triple this cohort runs and its SolverParams,
        # stamped by the batcher at creation.
        self.method: str = "admm"
        self.params = None

    def write_slot(self, slot: int, qp: CanonicalQP) -> None:
        """Overwrite one slot's rows of the stacked problem buffer."""
        for name, dst in zip(self.qp_stack._fields, self.qp_stack):
            if dst is None:
                continue
            dst[slot] = getattr(qp, name)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.reqs) if r is None]

    def occupied(self) -> int:
        return sum(r is not None for r in self.reqs)

    def empty(self) -> bool:
        return self.occupied() == 0


class ContinuousBatcher(MicroBatcher):
    """Drop-in MicroBatcher variant running the continuous loop.

    Cohorts form under the same size/age policy as classic batches (at
    the same power-of-two ladder sizes), but once running they admit
    and retire lanes at every segment boundary. ``segment_budget``
    bounds any single lane's segments; the default is the solver's own
    ``ceil(max_iter / check_interval)``, i.e. plain ``max_iter``
    semantics.
    """

    #: Harvest-record provenance tag (continuous-mode retirements).
    harvest_source = "serve.continuous"

    def __init__(self, *args, params=None,
                 segment_budget: Optional[int] = None, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if params is None:
            params = self.cache.params
        self.params = params
        if segment_budget is not None and segment_budget < 1:
            raise ValueError("segment_budget must be >= 1")
        # Clamped to max_iter expressed in segments: the step has no
        # iters < max_iter gate (the host budget is the only brake).
        self.segment_budget = min(
            int(segment_budget or default_segment_budget(params)),
            default_segment_budget(params))
        self._cohorts: Dict[Bucket, _Cohort] = {}

    # -- loop ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            draining = self._stopping.is_set()
            busy = any(not c.empty() for c in self._cohorts.values())
            try:
                timeout = (1e-4 if busy or draining
                           else self._next_wakeup(time.monotonic()))
                req = self.queue.get(timeout=timeout)
                self._route(req)
                while True:  # drain whatever arrived together
                    try:
                        self._route(self.queue.get_nowait())
                    except queue.Empty:
                        break
            except queue.Empty:
                pass

            now = time.monotonic()
            for bucket in list(self._pending):
                dq = self._pending[bucket]
                if not dq:
                    del self._pending[bucket]
                    continue
                if bucket not in self._cohorts and (
                        draining
                        or len(dq) >= self.max_batch
                        or now - dq[0].submitted >= self.max_wait_s):
                    self._make_cohort_safe(bucket, dq)

            for bucket, cohort in list(self._cohorts.items()):
                self._tick_safe(bucket, cohort)
                if cohort.empty() and not cohort.staged \
                        and (cohort.no_refill
                             or not self._pending.get(bucket)):
                    # A drained no-refill cohort makes way for a larger
                    # replacement sized from today's backlog.
                    del self._cohorts[bucket]

            if draining and self.queue.empty() and not self._pending \
                    and all(c.empty() and not c.staged
                            for c in self._cohorts.values()):
                return

    # -- cohort lifecycle --------------------------------------------

    def _fail_pending(self, dq, exc) -> None:
        reqs = []
        while dq:
            reqs.append(dq.popleft())
        self._fail(reqs, SolveError(
            f"continuous cohort creation failed: {exc!r}"))

    def _make_cohort_safe(self, bucket: Bucket,
                          dq: "collections.deque") -> None:
        try:
            device = self.health.device()
            dtype = dq[0].qp.q.dtype
            slots = slot_count(min(len(dq), self.max_batch),
                               self.max_batch)
            if self.router is not None:
                method, cache = self.router.decide(bucket)
                params = cache.params
            else:
                cache, params = self.cache, self.params
                method = params.method
            exes = cache.get_continuous(bucket, slots, dtype, device)
            cohort = _Cohort(bucket, slots, dtype, device, exes)
            cohort.method = method
            cohort.params = params
            self._cohorts[bucket] = cohort
        except sanitize.SanitizerError as exc:
            # A policy violation is not a device fault: fail these
            # requests loudly and leave the breaker closed.
            if self.obs is not None:
                self.obs.events.emit(
                    "sanitizer_violation", "error", what="cohort_create",
                    bucket=f"{bucket.n}x{bucket.m}", detail=str(exc))
            self._fail_pending(dq, exc)
        except Exception as exc:  # noqa: BLE001 - containment boundary
            self.health.record_failure(exc)
            self.metrics.inc("dispatch_failures")
            self._fail_pending(dq, exc)

    def _stage_admissions(self, bucket: Bucket, cohort: _Cohort) -> None:
        dq = self._pending.get(bucket)
        if not dq:
            return
        free = cohort.free_slots()
        now = time.monotonic()
        m = self.metrics
        while dq and free:
            r = dq.popleft()
            if r.deadline is not None and now > r.deadline:
                self._expire(r, now, "admission")
                continue
            slot = free.pop(0)
            m.observe_queue_wait(now - r.submitted)
            if self.obs is not None and r.trace_id is not None:
                self.obs.spans.record("queue_wait", r.submitted, now,
                                      trace_id=r.trace_id)
            cohort.reqs[slot] = r
            cohort.write_slot(slot, r.qp)
            cohort.seg_count[slot] = 0
            cohort.warm[slot] = False
            cohort.admit_t[slot] = now
            cohort.x0[slot] = 0.0
            cohort.y0[slot] = 0.0
            if self.warm_cache is not None and r.warm_key is not None:
                hit = self.warm_cache.get((r.warm_key, bucket))
                if hit is not None:
                    cohort.x0[slot] = torch.from_numpy(hit[0])
                    cohort.y0[slot] = torch.from_numpy(hit[1])
                    cohort.warm[slot] = True
                    m.inc("warm_hits")
                    m.inc_tenant(r.tenant or DEFAULT_TENANT, "warm_hits")
            # The routing decision this lane rides (bound at cohort
            # creation), counted at admission.
            m.inc(f"routed_{cohort.method}")
            m.inc_tenant(r.tenant or DEFAULT_TENANT,
                         f"routed_{cohort.method}")
            cohort.staged.append(slot)

    def _tick_safe(self, bucket: Bucket, cohort: _Cohort) -> None:
        try:
            self._tick(bucket, cohort)
        except sanitize.SanitizerError as exc:
            # Policy violations never open the breaker: fail this
            # cohort loudly.
            if self.obs is not None:
                self.obs.events.emit(
                    "sanitizer_violation", "error", what="cohort_tick",
                    bucket=f"{bucket.n}x{bucket.m}", detail=str(exc))
            self._fail_cohort(bucket, cohort, exc)
        except Exception as exc:  # noqa: BLE001 - containment boundary
            self.health.record_failure(exc)
            self.metrics.inc("dispatch_failures")
            if self.obs is not None:
                self.obs.events.emit(
                    "dispatch_failure", "error",
                    bucket=f"{bucket.n}x{bucket.m}", continuous=True,
                    error=f"{type(exc).__name__}: {exc}")
            self._fail_cohort(bucket, cohort, exc)

    def _fail_cohort(self, bucket: Bucket, cohort: _Cohort, exc) -> None:
        self._fail([r for r in cohort.reqs if r is not None],
                   SolveError(f"continuous cohort failed: {exc!r}"))
        self._cohorts.pop(bucket, None)

    @staticmethod
    def _call(exe, device, *args):
        """One compiled dispatch with the sanitizer's transfer
        discipline (as ``MicroBatcher._call_executable``): the upload
        of the staged host tensors is explicit and the dispatch runs
        inside the transfer guard."""
        return sanitize.guarded_call(exe, device, *args)

    def _tick(self, bucket: Bucket, cohort: _Cohort) -> None:
        m = self.metrics
        dq = self._pending.get(bucket)
        if (dq and not cohort.no_refill and cohort.slots < self.max_batch
                and len(dq) > cohort.slots):
            # The queue outgrew this cohort: stop refilling; in-flight
            # lanes finish, the cohort drains, and a larger one forms
            # from the backlog.
            cohort.no_refill = True
            m.inc("cohort_replacements")
        if not cohort.no_refill:
            self._stage_admissions(bucket, cohort)

        if cohort.staged:
            mask = torch.zeros(cohort.slots, dtype=torch.bool)
            mask[cohort.staged] = True
            with _profile.profiled_stage(self.profiler, "serve/admit",
                                         "admit"):
                out = self._call(
                    cohort.admit_exe, cohort.device, cohort.qp_stack,
                    cohort.x0, cohort.y0, mask, cohort.scaled,
                    cohort.scaling, cohort.carry)
            cohort.qp_dev, cohort.scaled, cohort.scaling, cohort.carry = out
            cohort.active[cohort.staged] = True
            m.inc("lanes_admitted", len(cohort.staged))
            cohort.staged = []

        if not cohort.active.any():
            return

        m.observe_queue_depth(self.queue.qsize() + sum(
            len(d) for d in self._pending.values()))
        t0 = time.monotonic()
        if _faults.enabled():
            # serve.continuous seam: an injected device loss raises
            # into _tick_safe's containment.
            _faults.fire("serve.continuous",
                         bucket=f"{bucket.n}x{bucket.m}",
                         slots=cohort.slots)
        active_dev = cohort.active.copy()
        with _profile.profiled_stage(self.profiler, "serve/segment_step",
                                     "segment_step"):
            carry, status, _iters = self._call(
                cohort.step_exe, cohort.device, cohort.scaled,
                cohort.scaling, cohort.carry, torch.from_numpy(active_dev))
            cohort.carry = carry
            # The per-boundary control readout: one small host copy.
            status_h = status.cpu().numpy()
        step_s = time.monotonic() - t0
        n_live = int(np.sum(active_dev & np.array(
            [r is not None for r in cohort.reqs])))
        m.observe_segments(n_live, cohort.slots, step_s)
        cohort.seg_count[active_dev] += 1

        retire: List[int] = []
        for i, r in enumerate(cohort.reqs):
            if r is None or not cohort.active[i]:
                continue
            if status_h[i] != Status.RUNNING:
                retire.append(i)
            elif cohort.seg_count[i] >= self.segment_budget:
                m.inc("lanes_retired_budget")
                retire.append(i)

        if not retire:
            return

        with _profile.profiled_stage(self.profiler, "serve/finalize",
                                     "finalize"):
            sol = self._call(cohort.fin_exe, cohort.device, cohort.qp_dev,
                             cohort.scaled, cohort.scaling,
                             cohort.carry.state)
            t_fin = time.monotonic()
            # Fetch only the retiring lanes' rows.
            rows = host_solution(sol, retire)
        if _faults.enabled():
            rows["x"] = _corrupt_lanes(rows["x"], len(retire),
                                       "serve.result",
                                       f"{bucket.n}x{bucket.m}")
        done = time.monotonic()
        label = device_label(cohort.device)
        for j, i in enumerate(retire):
            r = cohort.reqs[i]
            if self.obs is not None and r.trace_id is not None:
                # Tile the request's wall clock like the classic path:
                # "solve" covers the admit and every segment through
                # the finalize, "resolve" the host copy and fan-out.
                self.obs.spans.record(
                    "solve", cohort.admit_t[i], t_fin,
                    trace_id=r.trace_id,
                    bucket=f"{bucket.n}x{bucket.m}",
                    slots=cohort.slots, continuous=True,
                    segments=int(cohort.seg_count[i]), device=label)
                self.obs.spans.record("resolve", t_fin, done,
                                      trace_id=r.trace_id)
            self._finish_request(r, bucket, j, rows, done, label,
                                 cohort.warm[i],
                                 segments=int(cohort.seg_count[i]),
                                 params=cohort.params)
            cohort.reqs[i] = None
            cohort.write_slot(i, cohort.neutral)
            cohort.active[i] = False
        self.health.record_success()
        m.observe_iters(float(rows["iters"].mean()), len(retire))
        self._plane_tick()
