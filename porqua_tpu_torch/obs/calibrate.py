"""Closed-loop route calibration: live re-seeding with guarded promotion.

Every passive plane is already in place — the harvest warehouse
records per-solve outcomes, the shadow-compare stream records how the
*losing* backend would have done on served traffic, the SLO engine
tracks burn rates and the anomaly detector tracks convergence EWMAs.
This module closes the telemetry→action loop (the open half of the
multi-backend ROADMAP item, and the template the learned-policy work
will reuse): a :class:`Calibrator` folds the live shadow/harvest
stream into bounded per-``(bucket, eps)`` rolling evidence and drives
a staged promotion state machine over the
:class:`~porqua_tpu_torch.serve.routing.SolverRouter`'s versioned route
table:

``idle`` → (candidate computed, gates pass) → ``canary`` (dwell;
evidence must *hold* ``min_samples`` per changed cell and a
``win_rate`` threshold on the shadow comparisons) → **promoted**
(:meth:`SolverRouter.set_table` — a version bump, 0 recompiles thanks
to the prewarmed-every-ladder invariant) → ``guard`` (a window
watching the EXISTING :class:`~porqua_tpu_torch.obs.anomaly.AnomalyDetector`
fired count and :class:`~porqua_tpu_torch.obs.slo.SLOEngine` firing alerts
for policy-induced drift) → ``idle``; a guard breach auto-reverts to
the prior table (another version bump — versions are never reused)
and emits one ``route_rollback`` event, which the flight recorder
turns into exactly one incident bundle.

Every transition emits a ``route_reseed`` event carrying the full
evidence diff (old/new route, per-cell iteration / latency deltas,
sample counts) and lands a **versioned audit record** in the harvest
warehouse (``source="calibration.audit"``): :func:`replay_audit`
rebuilds the active table from the audit chain alone, which is the
regression bar for version monotonicity.

The whole plane is host-side: calibration only ever picks which
already-compiled entry runs (every backend's ladder is prewarmed, so a
promotion costs zero compiles).

Pure host code: stdlib + the tsan lock factory (the port of
``porqua_tpu/obs/calibrate.py``), zero wall-clock sleeps — ticking is driven by the
batchers' ``_plane_tick`` through an injectable clock
(:class:`~porqua_tpu_torch.resilience.faults.FaultClock` in tests).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from porqua_tpu_torch.analysis import tsan

__all__ = ["CALIBRATION_AUDIT_SOURCE", "Calibrator", "replay_audit"]

#: ``source`` field of audit records in the harvest warehouse. The
#: aggregator treats these as annotations (no solve fields), readers
#: like ``harvest_report`` render them as the calibration table.
CALIBRATION_AUDIT_SOURCE = "calibration.audit"

#: Audit-record schema version (bump when a field changes meaning).
AUDIT_SCHEMA_VERSION = 1

#: Mirrors ``porqua_tpu_torch.serve.routing.METHODS`` — restated so
#: this module imports nothing of the solver (the router re-validates
#: methods on every swap).
_METHODS = ("admm", "pdhg", "napg")

#: ``int(porqua_tpu_torch.qp.admm.Status.SOLVED)`` restated for the same
#: reason; harvest records carry the status as this integer.
_SOLVED = 1

#: Numeric encoding of the state machine for /metrics gauges.
_STATE_GAUGE = {"idle": 0.0, "canary": 1.0, "guard": 2.0}

Cell = Tuple[str, float]


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(float(x))


def _cell_str(cell: Cell) -> str:
    # The router-snapshot key format, so audit tables compare 1:1
    # against ``SolverRouter.snapshot()["table"]``.
    return f"{cell[0]}@{cell[1]:.0e}"


class Calibrator:
    """Live route-table calibration over a :class:`SolverRouter`.

    Wire as ``SolveService(calibrator=...)`` — the service binds the
    router / harvest sink / event bus / anomaly detector / SLO engine
    and the batchers feed every retired harvest record (and every
    shadow-compare record) through :meth:`observe`, then call
    :meth:`maybe_tick` from ``_plane_tick`` after each dispatch.

    Knobs (the README's calibration table):

    ``min_interval_s``
        clock gate between ticks (evidence folds continuously; the
        state machine advances at most this often).
    ``min_samples``
        evidence-maturity bar: per cell, only backends with at least
        this many valid evidence records are scored as contenders (at
        least two must mature for any comparison), AND the incoming
        winner needs this many shadow comparisons before a candidate
        may enter canary.
    ``win_rate``
        fraction of the winner's shadow comparisons that must be wins
        (served answer agreed AND the shadow was strictly faster —
        dispatch latency when recorded, iterations otherwise).
    ``canary_dwell_s``
        how long a candidate must keep its gates green before the
        table is swapped.
    ``guard_window_s``
        post-promotion watch: any NEW anomaly-detector firing or any
        NEWLY-firing SLO alert inside the window is a breach →
        auto-rollback.
    ``cooldown_s``
        no new candidate until this long after a rollback (the
        discredited cells' evidence is also dropped, so the same bad
        table cannot ping-pong back in).
    ``max_records_per_cell``
        bound on each (cell, backend) evidence deque — the rolling
        window live reseeding judges on.
    """

    def __init__(self,
                 router=None,
                 harvest=None,
                 events=None,
                 anomaly=None,
                 slo=None,
                 min_interval_s: float = 5.0,
                 min_samples: int = 8,
                 win_rate: float = 0.6,
                 canary_dwell_s: float = 10.0,
                 guard_window_s: float = 30.0,
                 cooldown_s: Optional[float] = None,
                 max_records_per_cell: int = 256,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if not 0.0 <= float(win_rate) <= 1.0:
            raise ValueError("win_rate must be in [0, 1]")
        if int(min_samples) < 1:
            raise ValueError("min_samples must be >= 1")
        if int(max_records_per_cell) < 1:
            raise ValueError("max_records_per_cell must be >= 1")
        self.router = router
        self.harvest = harvest
        self.events = events
        self.anomaly = anomaly
        self.slo = slo
        self.min_interval_s = float(min_interval_s)
        self.min_samples = int(min_samples)
        self.win_rate = float(win_rate)
        self.canary_dwell_s = float(canary_dwell_s)
        self.guard_window_s = float(guard_window_s)
        self.cooldown_s = (float(guard_window_s) if cooldown_s is None
                           else float(cooldown_s))
        self.max_records_per_cell = int(max_records_per_cell)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = tsan.lock("Calibrator")
        # guarded-by: self._lock
        # (cell -> method -> deque of (ok, iters, solve_s|None)): ALL
        # valid solve evidence (routed + shadow), the scoring input.
        self._evidence: Dict[Cell, Dict[str, deque]] = {}
        # (cell -> method -> deque of (win, agree, d_iters, d_solve_s)):
        # the shadow comparisons only — the promotion gate's input.
        self._shadow: Dict[Cell, Dict[str, deque]] = {}
        self._state = "idle"
        self._candidate: Optional[Dict[Cell, str]] = None
        self._candidate_diff: Dict[str, Dict[str, Any]] = {}
        self._canary_since = 0.0
        self._prior_table: Optional[Dict[Cell, str]] = None
        self._promoted_at = 0.0
        self._guard_base_anomaly = 0
        self._guard_base_slo: set = set()
        self._cooldown_until = 0.0
        self._last_tick = float(self._clock())
        self._last_reseed_t: Optional[float] = None
        self._audit: List[Dict[str, Any]] = []
        self._counters = {
            "ticks": 0, "tick_errors": 0, "observed": 0,
            "rejected": 0, "candidates": 0, "promotions": 0,
            "rollbacks": 0, "abandoned": 0, "settled": 0,
        }

    # -- wiring ------------------------------------------------------

    def bind(self, router=None, harvest=None, events=None,
             anomaly=None, slo=None) -> None:
        """Late wiring from ``SolveService`` — fills only the planes
        the constructor left unset, so a pre-configured calibrator
        keeps its own sinks."""
        if self.router is None:
            self.router = router
        if self.harvest is None:
            self.harvest = harvest
        if self.events is None:
            self.events = events
        if self.anomaly is None:
            self.anomaly = anomaly
        if self.slo is None:
            self.slo = slo

    # -- evidence ingestion ------------------------------------------

    def observe(self, rec: Dict[str, Any]) -> bool:
        """Fold one harvest record into the rolling evidence. Accepts
        the full live stream — routed serve records and
        ``serve.shadow`` comparisons alike — and REJECTS (counted,
        never raised) anything that cannot be trusted as evidence:
        missing cell coordinates, unknown backend, non-finite
        outcome fields. A poisoned feed (chaos ``data.feed`` seam)
        produces exactly such records, and rejecting them here is what
        keeps corrupted evidence from ever driving a promotion.

        Tenancy: the ``tenant`` attribution field is deliberately
        ignored — compiled programs are tenant-blind, so evidence
        pools across tenants and the calibrator can never build a
        per-tenant route table.
        """
        bucket = rec.get("bucket")
        eps = rec.get("eps_abs")
        method = rec.get("solver")
        status = rec.get("status")
        iters = rec.get("iters")
        solve_s = rec.get("solve_s")
        obj = rec.get("obj_val", rec.get("obj"))
        is_shadow = (rec.get("shadow_of") is not None
                     or rec.get("source") == "serve.shadow")
        ok_fields = (
            isinstance(bucket, str) and bucket
            and _finite(eps)
            and method in _METHODS
            and isinstance(status, int)
            and isinstance(iters, int) and iters >= 0
            and (solve_s is None or (_finite(solve_s) and solve_s >= 0))
            and (obj is None or _finite(obj)))
        d_iters = rec.get("delta_iters")
        d_solve = rec.get("delta_solve_s")
        if ok_fields and is_shadow:
            ok_fields = (_finite(d_iters)
                         and (d_solve is None or _finite(d_solve))
                         and isinstance(rec.get("agree"), bool))
        if not ok_fields:
            with self._lock:
                self._counters["rejected"] += 1
            return False
        cell: Cell = (bucket, float(eps))
        solved = int(status) == _SOLVED
        with self._lock:
            self._counters["observed"] += 1
            dq = self._evidence.setdefault(cell, {}).setdefault(
                method, deque(maxlen=self.max_records_per_cell))
            dq.append((solved, int(iters),
                       None if solve_s is None else float(solve_s)))
            if is_shadow:
                agree = bool(rec["agree"])
                # A "win" is the promotion currency: the served answer
                # agreed AND the shadow backend was strictly better —
                # dispatch latency when both sides recorded it,
                # iterations otherwise.
                if d_solve is not None:
                    better = float(d_solve) < 0.0
                else:
                    better = int(d_iters) < 0
                win = agree and solved and better
                sdq = self._shadow.setdefault(cell, {}).setdefault(
                    method, deque(maxlen=self.max_records_per_cell))
                sdq.append((win, agree,
                            int(d_iters),
                            None if d_solve is None else float(d_solve)))
        return True

    # -- candidate computation ---------------------------------------

    def _active_route(self, table: Dict[Cell, str], cell: Cell) -> str:
        default = (self.router.default_method
                   if self.router is not None else _METHODS[0])
        return table.get(cell, default)

    def _cell_stats(self, cell: Cell) -> Dict[str, Dict[str, Any]]:
        # caller holds self._lock
        out: Dict[str, Dict[str, Any]] = {}
        for method, dq in self._evidence.get(cell, {}).items():
            n = len(dq)
            if not n:
                continue
            lats = [s for (_, _, s) in dq if s is not None]
            out[method] = {
                "count": n,
                "solved_share": sum(1 for (ok, _, _) in dq if ok) / n,
                "iters_mean": sum(it for (_, it, _) in dq) / n,
                "solve_s_mean": (sum(lats) / len(lats)) if lats else None,
            }
        return out

    def _shadow_stats(self, cell: Cell,
                      method: str) -> Optional[Dict[str, Any]]:
        # caller holds self._lock
        sdq = self._shadow.get(cell, {}).get(method)
        if not sdq:
            return None
        n = len(sdq)
        d_solves = [d for (_, _, _, d) in sdq if d is not None]
        return {
            "samples": n,
            "wins": sum(1 for (w, _, _, _) in sdq if w),
            "win_rate": sum(1 for (w, _, _, _) in sdq if w) / n,
            "agree_rate": sum(1 for (_, a, _, _) in sdq if a) / n,
            "delta_iters_mean": sum(d for (_, _, d, _) in sdq) / n,
            "delta_solve_s_mean": (sum(d_solves) / len(d_solves)
                                   if d_solves else None),
        }

    def _compute_candidate(self) -> Tuple[Dict[Cell, str],
                                          Dict[str, Dict[str, Any]]]:
        """The would-be next table plus the gated evidence diff.
        Scoring per cell matches ``seed_from_aggregate`` (solved share
        first, then mean dispatch latency when every contender has
        one, then mean iterations, then name) over every backend with
        ``min_samples`` evidence records — with three backends a cell
        is scored across all contenders that have matured, and a
        still-thin third stream cannot block the two thick ones from
        comparing (it simply is not a contender yet); a changed cell
        enters the diff only when the incoming winner's shadow
        comparisons also clear the ``win_rate`` bar on at least
        ``min_samples`` samples — the staged-promotion gate."""
        active = (self.router.table() if self.router is not None else {})
        candidate = dict(active)
        diff: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for cell in sorted(self._evidence):
                # Only matured contenders score: a method below
                # min_samples has no seat at the table this tick.
                stats = {m: e for m, e in self._cell_stats(cell).items()
                         if e["count"] >= self.min_samples}
                if len(stats) < 2:
                    continue
                have_lat = all(e["solve_s_mean"] is not None
                               for e in stats.values())

                def score(item):
                    m, e = item
                    primary = (e["solve_s_mean"] if have_lat
                               else e["iters_mean"])
                    return (-e["solved_share"], primary,
                            e["iters_mean"], m)

                winner = min(stats.items(), key=score)[0]
                incumbent = self._active_route(active, cell)
                if winner == incumbent:
                    continue
                shadow = self._shadow_stats(cell, winner)
                if (shadow is None
                        or shadow["samples"] < self.min_samples
                        or shadow["win_rate"] < self.win_rate):
                    continue
                candidate[cell] = winner
                diff[_cell_str(cell)] = {
                    "old": incumbent, "new": winner,
                    "evidence": {"per_method": stats, "shadow": shadow},
                }
        return candidate, diff

    # -- state machine -----------------------------------------------

    def maybe_tick(self) -> bool:
        """The ``_plane_tick`` entry: advance the state machine at
        most every ``min_interval_s`` on the injected clock. Returns
        whether a tick ran. Never raises — a broken calibration plane
        must not fail served traffic (same bar as every obs plane)."""
        now = float(self._clock())
        with self._lock:
            if now - self._last_tick < self.min_interval_s:
                return False
            self._last_tick = now
        try:
            self.tick(now)
        except Exception:  # noqa: BLE001 - plane must not fail serving
            with self._lock:
                self._counters["tick_errors"] += 1
            return False
        return True

    def tick(self, now: Optional[float] = None) -> None:
        """One state-machine step (the gate-free entry tests drive
        directly). Also opens a fresh shadow-budget window on the
        router — evidence-gathering cost is bounded per tick."""
        now = float(self._clock()) if now is None else float(now)
        with self._lock:
            self._counters["ticks"] += 1
            state = self._state
        if self.router is not None:
            self.router.reset_shadow_budget()
        if self.router is None:
            return
        if state == "guard":
            self._tick_guard(now)
        elif state == "canary":
            self._tick_canary(now)
        else:
            self._tick_idle(now)

    def _tick_idle(self, now: float) -> None:
        with self._lock:
            if now < self._cooldown_until:
                return
        candidate, diff = self._compute_candidate()
        if not diff:
            return
        with self._lock:
            self._state = "canary"
            self._candidate = candidate
            self._candidate_diff = diff
            self._canary_since = now
            self._counters["candidates"] += 1
        self._emit_reseed("candidate", now, diff,
                          table=candidate, action="candidate")

    def _tick_canary(self, now: float) -> None:
        candidate, diff = self._compute_candidate()
        with self._lock:
            held = (self._candidate is not None
                    and diff
                    and all(k in diff
                            and diff[k]["new"] == d["new"]
                            for k, d in self._candidate_diff.items()))
            if held:
                # Evidence may have sharpened mid-dwell; promote the
                # freshest view of the same decision.
                self._candidate = candidate
                self._candidate_diff = {
                    k: diff[k] for k in self._candidate_diff}
            dwelled = now - self._canary_since >= self.canary_dwell_s
        if not held:
            with self._lock:
                dropped = self._candidate_diff
                self._state = "idle"
                self._candidate = None
                self._candidate_diff = {}
                self._counters["abandoned"] += 1
            self._emit_reseed("abandoned", now, dropped)
            return
        if dwelled:
            self._promote(now)

    def _promote(self, now: float) -> None:
        with self._lock:
            candidate = dict(self._candidate or {})
            diff = self._candidate_diff
        prior = self.router.table()
        version = self.router.set_table(candidate)
        anomaly_fired = 0
        if self.anomaly is not None:
            anomaly_fired = int(
                self.anomaly.counters().get("anomalies_fired", 0))
        slo_firing: set = set()
        if self.slo is not None:
            slo_firing = set(self.slo.status().get("firing", ()))
        with self._lock:
            self._state = "guard"
            self._prior_table = prior
            self._promoted_at = now
            self._guard_base_anomaly = anomaly_fired
            self._guard_base_slo = slo_firing
            self._candidate = None
            self._last_reseed_t = now
            self._counters["promotions"] += 1
        self._emit_reseed("promoted", now, diff, table=candidate,
                          prior_table=prior, version=version,
                          action="promote")

    def _guard_breaches(self) -> List[str]:
        reasons: List[str] = []
        if self.anomaly is not None:
            fired = int(
                self.anomaly.counters().get("anomalies_fired", 0))
            with self._lock:
                base = self._guard_base_anomaly
            if fired > base:
                reasons.append(
                    f"anomaly_fired +{fired - base} since promotion")
        if self.slo is not None:
            firing = set(self.slo.status().get("firing", ()))
            with self._lock:
                fresh = sorted(firing - self._guard_base_slo)
            if fresh:
                reasons.append("slo_firing " + ",".join(fresh))
        return reasons

    def _tick_guard(self, now: float) -> None:
        reasons = self._guard_breaches()
        if reasons:
            self._rollback(now, reasons)
            return
        with self._lock:
            expired = now - self._promoted_at >= self.guard_window_s
            if expired:
                self._state = "idle"
                self._prior_table = None
                diff = self._candidate_diff
                self._candidate_diff = {}
                self._counters["settled"] += 1
        if expired:
            self._emit_reseed("settled", now, diff)

    def _rollback(self, now: float, reasons: List[str]) -> None:
        with self._lock:
            prior = dict(self._prior_table or {})
            diff = self._candidate_diff
        promoted = self.router.table()
        version = self.router.set_table(prior)
        with self._lock:
            self._state = "idle"
            self._prior_table = None
            self._candidate_diff = {}
            self._cooldown_until = now + self.cooldown_s
            self._counters["rollbacks"] += 1
            # Evidence that promoted a table the guard then shot down
            # is discredited: drop it so the same candidate must earn
            # a whole fresh window before it can come back.
            for key in diff:
                for cell in list(self._evidence):
                    if _cell_str(cell) == key:
                        self._evidence.pop(cell, None)
                        self._shadow.pop(cell, None)
        reason = "; ".join(reasons)
        audit = self._audit_record("rollback", now, version,
                                   table=prior, prior_table=promoted,
                                   diff=diff, reason=reason)
        if self.events is not None:
            # severity "error": this is the plane admitting a policy
            # it promoted degraded live traffic. The flight recorder
            # triggers on the kind — exactly one bundle per rollback
            # (debounce handles event-storm multiplicity).
            self.events.emit(
                "route_rollback", "error", reason=reason,
                table_version=version,
                restored_table={_cell_str(c): m
                                for c, m in sorted(prior.items())},
                diff=diff)

    # -- eventing / audit --------------------------------------------

    def _emit_reseed(self, state: str, now: float,
                     diff: Dict[str, Dict[str, Any]],
                     table: Optional[Dict[Cell, str]] = None,
                     prior_table: Optional[Dict[Cell, str]] = None,
                     version: Optional[int] = None,
                     action: Optional[str] = None) -> None:
        if version is None and self.router is not None:
            version = self.router.table_version
        if action is not None:
            self._audit_record(action, now, int(version or 0),
                               table=table or {},
                               prior_table=prior_table, diff=diff)
        if self.events is not None:
            fields: Dict[str, Any] = {
                "state": state,
                "table_version": int(version or 0),
                "n_cells": len(diff),
                "diff": diff,
            }
            if table is not None:
                fields["table"] = {_cell_str(c): m
                                   for c, m in sorted(table.items())}
            self.events.emit("route_reseed", "info", **fields)

    def _audit_record(self, action: str, now: float, version: int,
                      table: Dict[Cell, str],
                      prior_table: Optional[Dict[Cell, str]] = None,
                      diff: Optional[Dict[str, Any]] = None,
                      reason: Optional[str] = None) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "v": AUDIT_SCHEMA_VERSION,
            "source": CALIBRATION_AUDIT_SOURCE,
            "t": float(now),
            "action": action,
            "table_version": int(version),
            "table": {_cell_str(c): m
                      for c, m in sorted(table.items())},
            "diff": dict(diff or {}),
        }
        if prior_table is not None:
            rec["prior_table"] = {_cell_str(c): m
                                  for c, m in sorted(prior_table.items())}
        if reason is not None:
            rec["reason"] = reason
        with self._lock:
            self._audit.append(rec)
        if self.harvest is not None:
            self.harvest.emit(rec)
        return rec

    # -- readers -----------------------------------------------------

    def audit_records(self) -> List[Dict[str, Any]]:
        """Copies of every audit record this calibrator produced (the
        same records landed in the harvest warehouse)."""
        with self._lock:
            return [dict(r) for r in self._audit]

    def evidence(self) -> Dict[str, Dict[str, Any]]:
        """Per-cell rolling-evidence summary (JSON-able): per-backend
        sample counts / solved share / means plus the shadow win-rate
        table — what the bench payload and ``harvest_report`` render."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for cell in sorted(self._evidence):
                entry: Dict[str, Any] = {
                    "per_method": self._cell_stats(cell)}
                shadows = {m: self._shadow_stats(cell, m)
                           for m in self._shadow.get(cell, {})}
                shadows = {m: s for m, s in shadows.items()
                           if s is not None}
                if shadows:
                    entry["shadow"] = shadows
                out[_cell_str(cell)] = entry
        return out

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {f"calibration_{k}": int(v)
                    for k, v in self._counters.items()}

    def gauges(self) -> Dict[str, float]:
        """/metrics calibration gauges: table version, last-reseed
        age, promotion/rollback totals, the state-machine position."""
        now = float(self._clock())
        with self._lock:
            last = self._last_reseed_t
            state = self._state
            promotions = self._counters["promotions"]
            rollbacks = self._counters["rollbacks"]
        out = {
            "calibration_route_table_version": float(
                self.router.table_version if self.router is not None
                else 0),
            "calibration_promotions_total": float(promotions),
            "calibration_rollbacks_total": float(rollbacks),
            "calibration_state": _STATE_GAUGE.get(state, -1.0),
        }
        if last is not None:
            out["calibration_last_reseed_age_s"] = max(0.0, now - last)
        return out

    def status(self) -> Dict[str, Any]:
        """The ``/healthz`` calibration section: state, versioning,
        counters, the live candidate diff, and knob settings."""
        now = float(self._clock())
        with self._lock:
            last = self._last_reseed_t
            payload: Dict[str, Any] = {
                "state": self._state,
                "candidate_cells": sorted(self._candidate_diff),
                "cooldown_remaining_s": max(
                    0.0, self._cooldown_until - now),
                "evidence_cells": len(self._evidence),
                "counters": {k: int(v)
                             for k, v in self._counters.items()},
            }
        payload["table_version"] = (
            self.router.table_version if self.router is not None else 0)
        payload["last_reseed_age_s"] = (
            None if last is None else max(0.0, now - last))
        payload["knobs"] = {
            "min_interval_s": self.min_interval_s,
            "min_samples": self.min_samples,
            "win_rate": self.win_rate,
            "canary_dwell_s": self.canary_dwell_s,
            "guard_window_s": self.guard_window_s,
            "cooldown_s": self.cooldown_s,
            "max_records_per_cell": self.max_records_per_cell,
        }
        return payload


def replay_audit(records: Iterable[Dict[str, Any]]
                 ) -> Tuple[Dict[str, str], int]:
    """Rebuild ``(active_table, version)`` from an audit chain — the
    warehouse is the source of truth for what the router served with,
    and this is the machine check that versions are monotonic and
    never reused. Non-audit records are skipped (pass a whole harvest
    dataset); ``candidate`` entries annotate but do not swap. Raises
    ``ValueError`` on a non-monotonic version sequence."""
    table: Dict[str, str] = {}
    version = 0
    chain = sorted(
        (r for r in records
         if r.get("source") == CALIBRATION_AUDIT_SOURCE),
        key=lambda r: (int(r.get("table_version", 0)),
                       float(r.get("t", 0.0))))
    for rec in chain:
        if rec.get("action") not in ("promote", "rollback"):
            continue
        v = int(rec.get("table_version", 0))
        if v <= version:
            raise ValueError(
                f"audit chain not monotonic: version {v} after "
                f"{version} (action {rec.get('action')!r})")
        version = v
        table = dict(rec.get("table", {}))
    return table, version
