"""Per-(bucket, eps) solver routing: pick the winning backend at admission.

With N first-order backends behind one segment-stepper contract
(``SolverParams(method="admm" | "pdhg" | "napg")``), which one wins is
an empirical, per-workload-cell question: ADMM's factorization
amortizes beautifully at small n and tight eps, PDHG's
factorization-free segments win where the per-segment n^3/3
factorization dominates, and NAPG's projection-only iterations own the
box+budget tracking buckets. Everything below is N-ary over
``METHODS`` — adding a backend is one tuple entry, not a router
rewrite. The
:class:`SolverRouter` (the port of ``porqua_tpu/serve/routing.py``)
makes that choice data-driven and *host-side only* — routing picks
which pre-compiled entry runs, it never changes what an entry
launches:

* one :class:`~porqua_tpu_torch.serve.bucketing.ExecutableCache` per backend
  (identical ``SolverParams`` except ``method``, so the caches' params
  hashes — and hence every executable identity — differ exactly by
  backend), with :meth:`prewarm` compiling EVERY backend's ladder so a
  routing flip mid-stream dispatches into an already-compiled
  executable (0 recompiles, the chaos ``solver_route_flap``
  invariant);
* a route table ``(bucket_label, eps_abs) -> method`` seeded from the
  harvest warehouse's per-solver aggregates
  (:func:`porqua_tpu_torch.obs.harvest.aggregate` ``by_solver`` sub-tables,
  the same evidence ``harvest_report`` renders): per cell the backend
  with the lower count-weighted mean dispatch latency wins, iteration
  p95 breaking ties when latency was not recorded;
* per-tenant routing attribution (one ``routed_<method>`` counter per
  backend in :class:`~porqua_tpu_torch.serve.metrics.ServeMetrics`, bumped
  by the batcher per routed request);
* a **shadow-compare** mode: a sampled fraction of dispatches re-solve
  the same padded batch on one of the *losing* backends — chosen
  uniformly from the seeded sampling RNG, so with three backends every
  loser keeps accumulating evidence — after the primary
  answer has already been returned, and each shadow lane lands in the
  harvest warehouse as a ``source="serve.shadow"`` record carrying the
  loser's outcome plus the per-lane delta vs the served answer
  (``shadow_of``, ``delta_iters``, ``delta_obj``) — the routing
  tables keep re-seeding themselves from live evidence instead of
  fossilizing on the traffic mix they were born under.

``force(method)`` pins every decision to one backend (chaos drills,
manual rollback); ``force(None)`` returns to the table.

The table itself is **versioned**: every swap — a
:meth:`seed_from_aggregate` bootstrap, a :meth:`set_table` promotion
from the live calibration plane (:mod:`porqua_tpu_torch.obs.calibrate`), a
rollback — bumps the monotonic ``route_table_version`` counter.
Versions are never reused: a rollback to a previous table is a NEW
version carrying old content, so the audit chain in the harvest
warehouse replays linearly to the active table. ``shadow_budget_per_
tick`` caps how many shadow re-solves may run between calibration
ticks (excess dispatches are deferred and counted ``shadow_deferred``)
so evidence gathering cannot tax dispatch latency unboundedly.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Dict, Optional, Tuple


from porqua_tpu_torch.analysis import tsan
from porqua_tpu_torch.obs.harvest import solve_record
from porqua_tpu_torch.qp.admm import Status
from porqua_tpu_torch.serve.batcher import host_solution
from porqua_tpu_torch.serve.bucketing import Bucket, ExecutableCache
from porqua_tpu_torch.serve.tenancy import DEFAULT_TENANT

__all__ = ["SolverRouter", "METHODS"]

#: The routable backends (the ``SolverParams.method`` domain).
METHODS = ("admm", "pdhg", "napg")


class SolverRouter:
    """Host-side backend chooser over per-method executable caches.

    ``params`` is the service's :class:`~porqua_tpu_torch.qp.solve.
    SolverParams`; its ``method`` is the default route for cells the
    table has no evidence on. ``shadow_rate`` in [0, 1] samples that
    fraction of classic dispatches for a shadow solve on a losing
    backend (0 = off; the sampling RNG is seeded so runs replay).
    """

    def __init__(self,
                 params,
                 metrics=None,
                 events=None,
                 cost_log=None,
                 shadow_rate: float = 0.0,
                 shadow_seed: int = 0,
                 shadow_budget_per_tick: Optional[int] = None) -> None:
        if params.method not in METHODS:
            raise ValueError(
                f"unknown method {params.method!r}; expected one of "
                f"{METHODS}")
        if not 0.0 <= float(shadow_rate) <= 1.0:
            raise ValueError("shadow_rate must be in [0, 1]")
        if shadow_budget_per_tick is not None \
                and int(shadow_budget_per_tick) < 0:
            raise ValueError("shadow_budget_per_tick must be >= 0")
        self.default_method = params.method
        self.metrics = metrics
        self.events = events
        #: One cache per backend. The shared metrics/events/cost_log
        #: mean compiles and cache health aggregate service-wide
        #: whichever backend paid them.
        self.caches: Dict[str, ExecutableCache] = {
            m: ExecutableCache(dataclasses.replace(params, method=m),
                               metrics=metrics, events=events,
                               cost_log=cost_log)
            for m in METHODS}
        self.shadow_rate = float(shadow_rate)
        self.shadow_budget_per_tick = (
            None if shadow_budget_per_tick is None
            else int(shadow_budget_per_tick))
        self._shadow_rng = random.Random(shadow_seed)
        self._lock = tsan.lock("SolverRouter")
        # guarded-by: self._lock
        self._table: Dict[Tuple[str, float], str] = {}
        self._table_version = 0
        self._force: Optional[str] = None
        self._decisions: Dict[str, int] = {m: 0 for m in METHODS}
        self._shadow_solves = 0
        self._shadow_failures = 0
        self._shadow_deferred = 0
        self._shadow_in_tick = 0

    # -- identity ----------------------------------------------------

    @property
    def params(self):
        """The default backend's params (what a router-less service
        would run) — ``SolveService`` validates its own params against
        this, so a shared router cannot silently solve at a different
        tolerance than the service promises."""
        return self.caches[self.default_method].params

    def params_for(self, method: str):
        return self.caches[method].params

    @staticmethod
    def _label(bucket: Bucket) -> str:
        # The harvest/anomaly bucket label ("NxM") — route keys must
        # join against harvest aggregate rows, whose label the batcher
        # writes as f"{bucket.n}x{bucket.m}".
        return f"{bucket.n}x{bucket.m}"

    # -- decisions ---------------------------------------------------

    def route(self, bucket: Bucket) -> str:
        """The backend this bucket's next dispatch should run —
        forced > table[(bucket, eps)] > the service default. Counted
        per decision (the batcher adds per-tenant attribution)."""
        eps = float(self.params.eps_abs)
        with self._lock:
            if self._force is not None:
                method = self._force
            else:
                method = self._table.get((self._label(bucket), eps),
                                         self.default_method)
            self._decisions[method] += 1
        return method

    def decide(self, bucket: Bucket) -> Tuple[str, ExecutableCache]:
        """:meth:`route` plus the chosen backend's executable cache —
        what the batchers call at dispatch/cohort-creation time."""
        method = self.route(bucket)
        return method, self.caches[method]

    def force(self, method: Optional[str]) -> None:
        """Pin every decision to ``method`` (``None`` unpins). The
        chaos ``solver_route_flap`` cell flips this mid-stream; a
        prewarmed router serves the flip with zero recompiles."""
        if method is not None and method not in METHODS:
            raise ValueError(
                f"unknown method {method!r}; expected one of {METHODS}")
        with self._lock:
            self._force = method
        if self.events is not None:
            self.events.emit("solver_route_forced", "info",
                             method=method or "(table)")

    # -- seeding -----------------------------------------------------

    def seed_from_aggregate(self, agg: Dict[str, Any]) -> Dict[str, str]:
        """Seed the route table from a harvest aggregate
        (:func:`porqua_tpu_torch.obs.harvest.aggregate` output — the same
        rollup ``harvest_report`` renders). Evidence for one
        ``(bucket, eps)`` cell is pooled across tenants (the compiled
        programs are tenant-blind, so the winner must be too): per
        backend, solved share first (a backend that runs out of
        iterations must never win on being fast about it), then the
        count-weighted mean dispatch latency (``solve_s_mean``) when
        every contender recorded it, the count-weighted iteration p95
        otherwise. Cells with only one backend observed keep the
        default route — one-sided evidence is no comparison. Returns
        the (label, eps) -> winner entries written."""
        # (bucket, eps) -> method -> [count, weighted_lat, lat_count,
        #                            weighted_p95, solved_count]
        pooled: Dict[Tuple[str, float], Dict[str, list]] = {}
        for g in agg.get("groups", ()):
            bs = g.get("by_solver")
            if not bs or g.get("eps_abs") is None:
                continue
            key = (str(g["bucket"]), float(g["eps_abs"]))
            cell = pooled.setdefault(key, {})
            for method, entry in bs.items():
                if method not in METHODS or not entry.get("count"):
                    continue
                acc = cell.setdefault(method, [0, 0.0, 0, 0.0, 0])
                cnt = int(entry["count"])
                acc[0] += cnt
                if entry.get("solve_s_mean") is not None:
                    acc[1] += float(entry["solve_s_mean"]) * cnt
                    acc[2] += cnt
                acc[3] += float(entry["iters"]["p95"]) * cnt
                acc[4] += int(entry.get("status_counts", {})
                              .get(str(int(Status.SOLVED)), 0))

        written: Dict[str, str] = {}
        with self._lock:
            for key, cell in pooled.items():
                if len(cell) < 2:
                    continue
                have_lat = all(acc[2] for acc in cell.values())

                def score(item):
                    method, acc = item
                    primary = (acc[1] / acc[2] if have_lat
                               else acc[3] / acc[0])
                    # Deterministic tie-break: p95 then name.
                    return (-(acc[4] / acc[0]), primary,
                            acc[3] / acc[0], method)

                winner = min(cell.items(), key=score)[0]
                self._table[key] = winner
                written[f"{key[0]}@{key[1]:.0e}"] = winner
            if written:
                self._table_version += 1
        if self.events is not None and written:
            self.events.emit("solver_routes_seeded", "info",
                             routes=dict(sorted(written.items())))
        return written

    # -- versioned table swap ----------------------------------------

    @property
    def table_version(self) -> int:
        """Monotonic route-table version: 0 at birth, +1 on every
        swap (seed, promotion, rollback). Never reused — a rollback to
        prior content is a NEW version, so the calibration audit chain
        replays linearly."""
        with self._lock:
            return self._table_version

    def table(self) -> Dict[Tuple[str, float], str]:
        """A copy of the active route table keyed ``(label, eps)`` —
        what the calibrator diffs candidates against and stashes as
        the rollback target before a promotion."""
        with self._lock:
            return dict(self._table)

    def set_table(self, table: Dict[Tuple[str, float], str]) -> int:
        """Atomically replace the whole route table and bump the
        version; returns the new version. The calibration plane's
        single mutation point for both promotion and rollback —
        callers own eventing/auditing (the router stays a dumb,
        versioned switch). Entries must name known backends; the
        prewarmed-every-ladder invariant makes any swap 0-recompile."""
        clean: Dict[Tuple[str, float], str] = {}
        for (label, eps), method in table.items():
            if method not in METHODS:
                raise ValueError(
                    f"unknown method {method!r} for cell "
                    f"{label}@{eps}; expected one of {METHODS}")
            clean[(str(label), float(eps))] = method
        with self._lock:
            self._table = clean
            self._table_version += 1
            return self._table_version

    # -- prewarm -----------------------------------------------------

    def prewarm(self, bucket: Bucket, max_batch: int, dtype,
                device=None, continuous: bool = False,
                include_solve: bool = True) -> int:
        """Compile EVERY backend's ladder for ``bucket`` (each cache's
        own prewarm — sanitizer warmup sealing and cost harvesting
        included), so any later routing decision — table reseed, a
        force(), a chaos flap — dispatches into an existing
        executable. Returns total executables compiled."""
        return sum(
            cache.prewarm(bucket, max_batch, dtype, device,
                          continuous=continuous,
                          include_solve=include_solve)
            for cache in self.caches.values())

    # -- shadow-compare ----------------------------------------------

    def maybe_shadow(self, bucket: Bucket, slots: int, dtype, device,
                     qp, x0, y0, method: str, primary: Dict[str, Any],
                     live, harvest, calibrator=None) -> bool:
        """Sampled re-solve of an already-served batch on one of the
        losing backends (uniform over the non-served methods, from the
        same seeded RNG as the fire decision, so the three-way evidence
        stream replays); per-live-lane delta records into
        ``harvest``. Runs on
        the dispatch thread strictly AFTER the primary futures
        resolved — shadow work may add throughput cost (that is the
        price of fresh tables) but never request latency. At most
        ``shadow_budget_per_tick`` shadows run between
        :meth:`reset_shadow_budget` calls (the calibration tick);
        sampled dispatches over budget are deferred and counted
        ``shadow_deferred``. Best-effort: any failure counts
        ``shadow_failures`` and is swallowed (a broken shadow must not
        fail served traffic). Each shadow record is also fed to the
        live ``calibrator`` when one is wired — the evidence stream
        the route table re-seeds itself from. Returns whether a shadow
        ran."""
        if harvest is None or self.shadow_rate <= 0.0:
            return False
        losers = [m for m in METHODS if m != method]
        if not losers:
            return False
        with self._lock:
            fire = self._shadow_rng.random() < self.shadow_rate
            if fire and self.shadow_budget_per_tick is not None:
                if self._shadow_in_tick >= self.shadow_budget_per_tick:
                    self._shadow_deferred += 1
                    fire = False
                else:
                    self._shadow_in_tick += 1
            elif fire:
                self._shadow_in_tick += 1
            # Which loser runs is drawn under the same lock as the fire
            # decision, so the (fire, alt) stream is one deterministic
            # replayable sequence.
            alt = losers[self._shadow_rng.randrange(len(losers))] \
                if fire else None
        if not fire:
            return False
        try:
            exe = self.caches[alt].get(bucket, slots, dtype, device)
            t0 = time.monotonic()
            # One host copy per field and batch; the copy ends the
            # dispatch, so solve_s is honest.
            sol = host_solution(exe(qp, x0, y0))
            solve_s = time.monotonic() - t0
            status, iters = sol["status"], sol["iters"]
            prim, dual, obj = sol["prim_res"], sol["dual_res"], sol["obj_val"]
        except Exception as exc:  # noqa: BLE001 - best-effort by design
            with self._lock:
                self._shadow_failures += 1
            if self.events is not None:
                self.events.emit(
                    "shadow_solve_failed", "warn",
                    bucket=self._label(bucket), method=alt,
                    error=f"{type(exc).__name__}: {exc}")
            return False
        params_alt = self.caches[alt].params
        primary_solve_s = primary.get("solve_s")
        for i, r in enumerate(live):
            rec = solve_record(
                "serve.shadow", r.n_orig, r.m_orig, int(status[i]),
                int(iters[i]), float(prim[i]), float(dual[i]),
                float(obj[i]), params=params_alt,
                bucket=self._label(bucket),
                solve_s=solve_s, tenant=r.tenant or DEFAULT_TENANT,
                # The delta vs the answer actually served: what the
                # route-table refresh (and a human reading the
                # warehouse) judges the alternative on.
                shadow_of=method,
                delta_iters=int(iters[i]) - int(primary["iters"][i]),
                delta_obj=float(obj[i]) - float(primary["obj"][i]),
                agree=bool(int(status[i]) == int(primary["status"][i])),
            )
            if r.trace_id is not None:
                # The served request's trace id (a field the JAX
                # package's shadow records lack): joins a shadow lane
                # to its request.
                rec["trace_id"] = r.trace_id
            if primary_solve_s is not None:
                rec["delta_solve_s"] = solve_s - float(primary_solve_s)
            harvest.emit(rec)
            if calibrator is not None:
                calibrator.observe(rec)
        with self._lock:
            self._shadow_solves += 1
        if self.metrics is not None:
            self.metrics.inc("shadow_solves")
        return True

    def reset_shadow_budget(self) -> None:
        """Open a fresh shadow-budget window (the calibration tick
        calls this; without a calibrator a budget-capped router keeps
        one window for its whole life, which is still a hard bound)."""
        with self._lock:
            self._shadow_in_tick = 0

    # -- readers -----------------------------------------------------

    def decisions(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._decisions)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able routing state: the table, decision counts, the
        force pin, shadow accounting — what ``ROUTE_rNN`` artifacts
        and the chaos cell read."""
        with self._lock:
            return {
                "default_method": self.default_method,
                "forced": self._force,
                "table": {f"{b}@{eps:.0e}": m
                          for (b, eps), m in sorted(self._table.items())},
                "table_version": self._table_version,
                "decisions": dict(self._decisions),
                "shadow_rate": self.shadow_rate,
                "shadow_budget_per_tick": self.shadow_budget_per_tick,
                "shadow_solves": self._shadow_solves,
                "shadow_failures": self._shadow_failures,
                "shadow_deferred": self._shadow_deferred,
            }
