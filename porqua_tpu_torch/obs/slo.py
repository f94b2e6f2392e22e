"""Live SLO engine: sliding windows, multi-window burn-rate alerts.

The obs stack could so far only explain a run after the fact; nothing
watched the service *live* against an objective. This module is the
declarative half of the live operational plane (README "SLOs, alerting
& incident response"):

* :class:`SLO` — one service-level objective over the serve stack's
  own counters: ``availability`` (completed / (completed + failed +
  expired + retry give-ups) — attempt-level, a deadline expiry is a
  failed request from the caller's view), ``latency`` (share of
  requests under a latency
  target, read from the ``solve_latency_seconds`` histogram so SLO
  targets and histogram edges align — see ``ServeMetrics(
  latency_buckets=)``), and ``wrong_answers`` (validation failures
  against a zero budget).
* :class:`BurnRateRule` — one Google-SRE-style multi-window
  multi-burn-rate alert rule: the alert condition is an AND over a
  short and a long window both burning error budget faster than
  ``burn_rate`` (the short window makes alerts reset quickly once the
  bleeding stops; the long window keeps a blip from paging).
* :class:`SLOEngine` — feeds sliding windows from
  :meth:`porqua_tpu_torch.serve.metrics.ServeMetrics.slo_sample` cumulative
  counters, computes per-(SLO, rule) burn rates, and drives the alert
  state machine ``inactive -> pending -> firing -> resolved`` with a
  ``for_s`` dwell before firing and a ``resolve_s`` clear dwell (flap
  debounce) before resolving. Transitions emit ``slo_alert`` events on
  the :class:`~porqua_tpu_torch.obs.events.EventBus` — a firing alert is a
  flight-recorder trigger (:mod:`porqua_tpu_torch.obs.flight`) — and the
  current burn rates / alert states export as ``slo_burn_rate`` /
  ``slo_alert_state`` gauges through ``prometheus_text(extra_gauges=)``
  plus the ``/healthz`` payload.

Everything is clocked on an injectable monotonic clock (any zero-arg
float callable — :class:`porqua_tpu_torch.resilience.FaultClock` included),
so burn-rate tests step time deterministically with no wall-clock
sleeps. The engine is pure host code fed by counters the serve stack
already maintains; a live engine changes nothing the card runs. The
port of ``porqua_tpu/obs/slo.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from porqua_tpu_torch.analysis import tsan

__all__ = [
    "SLO",
    "BurnRateRule",
    "DEFAULT_RULES",
    "SLOEngine",
    "TenantSLOSet",
    "default_slos",
]

#: SLO kinds the engine can evaluate (each maps to one good/bad counter
#: extraction from ``ServeMetrics.slo_sample``).
KINDS = ("availability", "latency", "wrong_answers")

#: Alert states, in escalation order (the ``slo_alert_state`` gauge
#: exports the index: 0 inactive, 1 pending, 2 firing).
STATES = ("inactive", "pending", "firing")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative service-level objective.

    ``objective`` is the good-events fraction the service promises
    (e.g. 0.999 = three nines); the error budget is ``1 - objective``.
    ``latency_target_s`` applies to ``kind="latency"`` only and should
    sit on a histogram bucket edge (``ServeMetrics(latency_buckets=)``)
    — the engine snaps it to the largest edge <= the target otherwise
    (conservative: borderline requests count as slow) and reports the
    effective target in ``status()``.
    """

    name: str
    kind: str
    objective: float = 0.999
    latency_target_s: float = 0.25
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if not (0.0 < self.objective <= 1.0):
            raise ValueError("objective must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """One multi-window burn-rate alert rule (Google SRE workbook ch.5).

    Fires when BOTH the ``short_s`` and ``long_s`` windows burn error
    budget at >= ``burn_rate`` x the sustainable rate. ``for_s`` is the
    pending dwell before firing; ``resolve_s`` is how long the
    condition must stay clear before a firing alert resolves (the flap
    debounce — a condition flickering inside ``resolve_s`` keeps ONE
    firing alert instead of a resolve/fire storm).
    """

    name: str
    long_s: float
    short_s: float
    burn_rate: float
    for_s: float = 0.0
    resolve_s: float = 60.0
    severity: str = "page"

    def __post_init__(self) -> None:
        if self.short_s <= 0 or self.long_s <= 0:
            raise ValueError("window lengths must be positive")
        if self.short_s > self.long_s:
            raise ValueError("short_s must be <= long_s (the short "
                             "window is the fast-reset gate)")


#: The canonical two-rule ladder: a fast page (5 m + 1 h at 14.4x —
#: 2% of a 30-day budget in one hour) and a slow ticket (30 m + 6 h at
#: 6x — 5% in six hours).
DEFAULT_RULES = (
    BurnRateRule("fast", long_s=3600.0, short_s=300.0, burn_rate=14.4,
                 for_s=0.0, resolve_s=300.0, severity="page"),
    BurnRateRule("slow", long_s=21600.0, short_s=1800.0, burn_rate=6.0,
                 for_s=0.0, resolve_s=900.0, severity="ticket"),
)


def default_slos(latency_target_s: float = 0.25,
                 availability_objective: float = 0.999,
                 latency_objective: float = 0.99) -> Tuple[SLO, ...]:
    """The serve stack's standard SLO set: availability, latency-p99
    (objective 0.99 under the target == "p99 <= target"), and
    zero-wrong-answers (objective 1.0 — any validation failure burns
    an empty budget, so a single wrong answer alerts immediately)."""
    return (
        SLO("availability", "availability",
            objective=availability_objective,
            description="completed / (completed + failed + expired "
                        "+ giveups)"),
        SLO("latency", "latency", objective=latency_objective,
            latency_target_s=latency_target_s,
            description=f"share of requests under "
                        f"{latency_target_s * 1e3:g} ms"),
        SLO("wrong_answers", "wrong_answers", objective=1.0,
            description="validation failures against a zero budget"),
    )


#: Floor for the error budget: an objective of exactly 1.0 (the
#: zero-wrong-answers SLO) would otherwise divide by zero; the floor
#: keeps burn rates finite (and JSON-serializable) while still making
#: any bad event an effectively-infinite burn.
_BUDGET_FLOOR = 1e-9


class _AlertState:
    """Mutable per-(SLO, rule) alert state (guarded by the engine lock)."""

    __slots__ = ("state", "pending_since", "clear_since",
                 "burn_short", "burn_long")

    def __init__(self) -> None:
        self.state = "inactive"
        self.pending_since = 0.0
        self.clear_since: Optional[float] = None
        self.burn_short = 0.0
        self.burn_long = 0.0


class SLOEngine:
    """Sliding-window burn-rate evaluation + the alert state machine.

    Thread-safety: ``evaluate``/``maybe_evaluate`` run on the dispatch
    thread (via ``MicroBatcher._finish_request``) and on scrape threads
    (``/metrics`` and ``/healthz`` evaluate before reading); ``status``
    / ``gauges`` read from whichever thread polls. All engine state is
    guarded by the instance lock; metric sampling and event emission
    happen OUTSIDE it (the flight recorder's dump path reads
    ``status()`` from inside an event listener, and emitting under the
    engine lock would re-enter it).
    """

    def __init__(self,
                 slos: Optional[Sequence[SLO]] = None,
                 rules: Sequence[BurnRateRule] = DEFAULT_RULES,
                 clock: Optional[Callable[[], float]] = None,
                 min_eval_interval_s: float = 1.0,
                 max_samples: int = 4096,
                 labels: Optional[Dict[str, str]] = None) -> None:
        # Static labels merged into every emitted slo_alert event —
        # the per-tenant engines (TenantSLOSet) ride this to stamp
        # their alerts with {"tenant": ...} so a flight bundle's
        # trigger names the tenant that burned its budget.
        self.labels: Dict[str, str] = dict(labels or {})
        self.slos: Tuple[SLO, ...] = tuple(
            default_slos() if slos is None else slos)
        if not self.slos:
            raise ValueError("SLOEngine needs at least one SLO")
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.rules: Tuple[BurnRateRule, ...] = tuple(rules)
        if not self.rules:
            raise ValueError("SLOEngine needs at least one BurnRateRule")
        self.clock = time.monotonic if clock is None else clock
        self.min_eval_interval_s = float(min_eval_interval_s)
        self._max_samples = int(max_samples)
        self._max_window = max(r.long_s for r in self.rules)
        # Samples closer together than this replace their predecessor
        # instead of appending: the bounded sample buffer then always
        # spans the longest rule window (a 1 s eval cadence would
        # otherwise cap retained history at max_samples seconds and
        # silently truncate a 6 h long window to a partial one).
        self._min_spacing = (self._max_window * 1.5
                             / max(self._max_samples - 2, 1))
        self.metrics = None
        self.events = None
        self._lock = tsan.lock("SLOEngine")
        # (t, {slo_name: (good, bad)}) cumulative samples, oldest
        # first.                              guarded-by: self._lock
        self._samples: List[Tuple[float, Dict[str, Tuple[int, int]]]] = []
        # guarded-by: self._lock
        self._alerts: Dict[Tuple[str, str], _AlertState] = {
            (s.name, r.name): _AlertState()
            for s in self.slos for r in self.rules}
        self._compliance: Dict[str, float] = {
            s.name: 1.0 for s in self.slos}       # guarded-by: self._lock
        self._effective_latency_target: Dict[str, float] = {}  # guarded-by: self._lock
        self._last_eval = float("-inf")           # guarded-by: self._lock
        self._alerts_fired = 0                    # guarded-by: self._lock
        self._evaluations = 0                     # guarded-by: self._lock

    # -- wiring -------------------------------------------------------

    def bind(self, metrics, events=None) -> "SLOEngine":
        """Point the engine at a :class:`ServeMetrics` (the sample
        source) and optionally an :class:`EventBus` (where
        ``slo_alert`` transitions land). ``SolveService`` calls this."""
        self.metrics = metrics
        if events is not None:
            self.events = events
        return self

    # -- sampling -----------------------------------------------------

    def _extract(self, sample: Dict[str, Any]
                 ) -> Tuple[Dict[str, Tuple[int, int]],
                            Dict[str, float]]:
        """Cumulative (good, bad) per SLO from one
        ``ServeMetrics.slo_sample`` reading, plus the effective
        (snapped) latency targets. Pure — runs outside the engine
        lock; the caller stores the results under it."""
        out: Dict[str, Tuple[int, int]] = {}
        eff_targets: Dict[str, float] = {}
        for slo in self.slos:
            if slo.kind == "availability":
                good = int(sample["completed"])
                # Attempt-level accounting, like the counters it reads:
                # a deadline expiry is a failed request from the
                # caller's view (the "deadline storm" case), and with a
                # retry layer an expired attempt that later gives up
                # counts once per stage — slightly overstating burn,
                # never hiding it.
                bad = (int(sample["failed"]) + int(sample["expired"])
                       + int(sample["retry_giveups"]))
            elif slo.kind == "wrong_answers":
                good = int(sample["completed"])
                bad = int(sample["validation_failures"])
            else:  # latency
                le = sample["latency_le"]
                counts = sample["latency_counts"]
                idx = -1
                for i, bound in enumerate(le):
                    if bound <= slo.latency_target_s:
                        idx = i
                    else:
                        break
                if idx < 0:
                    # No edge at or under the target: snap UP to the
                    # smallest edge (optimistic there is no conservative
                    # choice left) — align the ladder via
                    # ServeMetrics(latency_buckets=) instead.
                    idx = 0
                eff_targets[slo.name] = float(le[idx])
                good = int(sum(counts[:idx + 1]))
                bad = int(sample["latency_count"]) - good
            out[slo.name] = (good, bad)
        return out, eff_targets

    @staticmethod
    def _window_delta(samples, latest, name: str, now: float,
                      window_s: float) -> Tuple[int, int]:
        """(good, bad) accumulated inside the trailing window: latest
        minus the newest sample at or before ``now - window_s`` (or the
        oldest sample while the window is still filling — partial-
        window burn, the standard practical choice)."""
        cutoff = now - window_s
        base = samples[0][1]
        for t, vals in samples:
            if t <= cutoff:
                base = vals
            else:
                break
        g0, b0 = base.get(name, (0, 0))
        g1, b1 = latest.get(name, (0, 0))
        return max(g1 - g0, 0), max(b1 - b0, 0)

    # -- evaluation ---------------------------------------------------

    def maybe_evaluate(self) -> List[Dict[str, Any]]:
        """Clock-gated :meth:`evaluate` — safe to call per dispatch.
        The gate's clock read is advisory only; evaluate re-reads the
        clock under the engine lock, so a thread preempted between the
        gate and the evaluation cannot append an older-timestamped
        sample after a fresher one (explicit ``evaluate(now=...)`` is
        the single-threaded test path)."""
        with self._lock:
            if self.clock() - self._last_eval < self.min_eval_interval_s:
                return []
        return self.evaluate()

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Take one sample, recompute burn rates, and step every alert
        state machine. Returns the transition events emitted (also
        emitted on the bound event bus). Deterministic under an
        injected clock: time only moves when the caller's clock does.
        """
        if self.metrics is None:
            raise RuntimeError("SLOEngine.bind(metrics) first")
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            # Clock read AND metrics sample under the engine lock: a
            # dispatch-thread sample taken outside it could be
            # preempted, land AFTER a fresher scrape-thread sample,
            # and masquerade as a metrics-window reset — wiping the
            # burn history. The engine->metrics lock edge is one-way
            # (metrics never calls back into the engine).
            now = self.clock() if now is None else float(now)
            vals, eff_targets = self._extract(self.metrics.slo_sample())
            self._last_eval = now
            self._evaluations += 1
            self._effective_latency_target.update(eff_targets)
            if self._samples:
                prev = self._samples[-1][1]
                if any(sum(vals[n]) < sum(prev.get(n, (0, 0)))
                       for n in vals):
                    # A cumulative counter moved backwards: the metrics
                    # window was reset (loadgen does this after
                    # prewarm). Old deltas are meaningless — restart.
                    self._samples.clear()
            if (len(self._samples) >= 2
                    and now - self._samples[-2][0] < self._min_spacing):
                # Thin by replacement: keep the freshest sample per
                # spacing slot so max_samples always spans the longest
                # window, however fast evaluations arrive.
                self._samples[-1] = (now, vals)
            else:
                self._samples.append((now, vals))
            cutoff = now - self._max_window * 1.5
            while (len(self._samples) > 2
                   and (self._samples[1][0] <= cutoff
                        or len(self._samples) > self._max_samples)):
                self._samples.pop(0)

            for slo in self.slos:
                budget = max(1.0 - slo.objective, _BUDGET_FLOOR)
                g, b = self._window_delta(self._samples, vals, slo.name,
                                          now, self._max_window)
                total = g + b
                self._compliance[slo.name] = (
                    1.0 - b / total if total else 1.0)
                for rule in self.rules:
                    st = self._alerts[(slo.name, rule.name)]
                    burns = []
                    for w in (rule.short_s, rule.long_s):
                        gw, bw = self._window_delta(
                            self._samples, vals, slo.name, now, w)
                        tw = gw + bw
                        rate = bw / tw if tw else 0.0
                        burns.append(rate / budget)
                    st.burn_short, st.burn_long = burns
                    cond = (st.burn_short >= rule.burn_rate
                            and st.burn_long >= rule.burn_rate)
                    ev = self._step_alert(st, slo, rule, cond, now)
                    if ev is not None:
                        transitions.append(ev)
        for ev in transitions:
            if self.events is not None:
                self.events.emit(**ev)
        return transitions

    def _step_alert(self, st: _AlertState, slo: SLO,  # guarded-by: self._lock
                    rule: BurnRateRule, cond: bool,
                    now: float) -> Optional[Dict[str, Any]]:
        """One state-machine step; returns the ``slo_alert`` event to
        emit (outside the lock) on a reportable transition."""
        def event(state: str, severity: str) -> Dict[str, Any]:
            return dict(
                kind="slo_alert", severity=severity, slo=slo.name,
                rule=rule.name, state=state,
                burn_short=round(st.burn_short, 4),
                burn_long=round(st.burn_long, 4),
                threshold=rule.burn_rate,
                short_s=rule.short_s, long_s=rule.long_s,
                rule_severity=rule.severity, **self.labels)

        if st.state == "inactive":
            if cond:
                st.pending_since = now
                if now - st.pending_since >= rule.for_s:
                    st.state = "firing"
                    st.clear_since = None
                    self._alerts_fired += 1
                    return event("firing", "error")
                st.state = "pending"
                return event("pending", "warn")
            return None
        if st.state == "pending":
            if not cond:
                st.state = "inactive"  # silent cancel, Prometheus-style
                return None
            if now - st.pending_since >= rule.for_s:
                st.state = "firing"
                st.clear_since = None
                self._alerts_fired += 1
                return event("firing", "error")
            return None
        # firing
        if cond:
            st.clear_since = None  # flap: the bleeding resumed
            return None
        if st.clear_since is None:
            st.clear_since = now
        if now - st.clear_since >= rule.resolve_s:
            st.state = "inactive"
            st.clear_since = None
            return event("resolved", "info")
        return None

    # -- readers ------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The ``/healthz`` payload section: per-SLO compliance over
        the longest rule window, current burn rates per rule, and any
        firing alerts. Pure read of the last evaluation — safe to call
        from the flight recorder's dump path."""
        with self._lock:
            slos: Dict[str, Any] = {}
            firing: List[str] = []
            for slo in self.slos:
                alerts: Dict[str, Any] = {}
                for rule in self.rules:
                    st = self._alerts[(slo.name, rule.name)]
                    alerts[rule.name] = {
                        "state": st.state,
                        "burn_short": round(st.burn_short, 4),
                        "burn_long": round(st.burn_long, 4),
                        "threshold": rule.burn_rate,
                    }
                    if st.state == "firing":
                        firing.append(f"{slo.name}/{rule.name}")
                entry: Dict[str, Any] = {
                    "kind": slo.kind,
                    "objective": slo.objective,
                    "compliance": round(self._compliance[slo.name], 6),
                    "alerts": alerts,
                }
                if slo.kind == "latency":
                    entry["latency_target_s"] = slo.latency_target_s
                    eff = self._effective_latency_target.get(slo.name)
                    if eff is not None:
                        entry["effective_target_s"] = eff
                slos[slo.name] = entry
            return {
                "slos": slos,
                "firing": firing,
                "alerts_fired": self._alerts_fired,
                "evaluations": self._evaluations,
            }

    def gauges(self) -> Dict[str, float]:
        """Flat gauge dict for ``prometheus_text(extra_gauges=)``:
        ``slo_compliance_<slo>``, ``slo_burn_rate_<slo>_<rule>_short``
        / ``_long``, and ``slo_alert_state_<slo>_<rule>`` (0 inactive,
        1 pending, 2 firing)."""
        with self._lock:
            out: Dict[str, float] = {}
            for slo in self.slos:
                out[f"slo_compliance_{slo.name}"] = round(
                    self._compliance[slo.name], 6)
                for rule in self.rules:
                    st = self._alerts[(slo.name, rule.name)]
                    key = f"{slo.name}_{rule.name}"
                    out[f"slo_burn_rate_{key}_short"] = round(
                        st.burn_short, 4)
                    out[f"slo_burn_rate_{key}_long"] = round(
                        st.burn_long, 4)
                    out[f"slo_alert_state_{key}"] = float(
                        STATES.index(st.state))
            return out

    def counters(self) -> Dict[str, int]:
        """Exposition counters (``/metrics`` extra_counters path)."""
        with self._lock:
            return {"slo_alerts_fired": self._alerts_fired,
                    "slo_evaluations": self._evaluations}


class TenantSLOSet:
    """Per-tenant SLO engines over one :class:`ServeMetrics`.

    The tenant axis of the live SLO plane, built by *reusing* the
    engine rather than duplicating it: one unmodified
    :class:`SLOEngine` per observed tenant, each bound to that
    tenant's :meth:`~porqua_tpu_torch.serve.metrics.ServeMetrics.
    tenant_view` (the same reader-surface adapter the fleet collector
    uses) and stamped with ``labels={"tenant": <id>}`` so its
    ``slo_alert`` events — and therefore any flight-recorder bundle
    they trigger — carry the tenant id. Engines are created lazily as
    tenants appear, bounded by ``max_tenants`` (beyond it new tenants
    are counted, not judged — same posture as the anomaly detector's
    unknown groups).

    Semantics note: a tenant's availability counts its quota sheds as
    bad events (:meth:`ServeMetrics.tenant_slo_sample`) — a
    noisy-neighbor burst therefore burns ONLY the offender's budget;
    the victims' engines see their own clean counters.

    Thread-safety: ``maybe_evaluate`` runs on the dispatch thread via
    ``MicroBatcher._plane_tick`` and on scrape threads; the set's own
    lock guards only the engine registry — each engine keeps its own
    lock and evaluates outside ours.
    """

    def __init__(self,
                 slos: Optional[Sequence[SLO]] = None,
                 rules: Sequence[BurnRateRule] = DEFAULT_RULES,
                 clock: Optional[Callable[[], float]] = None,
                 min_eval_interval_s: float = 1.0,
                 max_tenants: int = 64) -> None:
        self._slos = tuple(default_slos() if slos is None else slos)
        self._rules = tuple(rules)
        self._clock = clock
        self._min_eval_interval_s = float(min_eval_interval_s)
        self._max_tenants = int(max_tenants)
        self.metrics = None
        self.events = None
        self._lock = tsan.lock("TenantSLOSet")
        self._engines: Dict[str, SLOEngine] = {}  # guarded-by: self._lock
        self._overflow = 0                        # guarded-by: self._lock

    def bind(self, metrics, events=None) -> "TenantSLOSet":
        """Point the set at the serve stack's :class:`ServeMetrics`
        (``SolveService`` calls this)."""
        self.metrics = metrics
        if events is not None:
            self.events = events
        return self

    def _engines_for(self, tenants) -> List[SLOEngine]:
        # Missing engines are constructed AND bound before they are
        # published into the registry: a concurrent evaluator (the
        # dispatch thread's _plane_tick vs a /metrics scrape) that
        # sees a registered engine must be able to evaluate it — an
        # unbound one would raise "SLOEngine.bind(metrics) first" into
        # whichever thread lost the race. The double-read is benign:
        # two racers may both build an engine for a new tenant; the
        # second insert defers to the first (setdefault), and the
        # loser's unbound engine is simply dropped.
        with self._lock:
            missing = [t for t in tenants if t not in self._engines]
        for t in missing:
            engine = SLOEngine(
                self._slos, rules=self._rules, clock=self._clock,
                min_eval_interval_s=self._min_eval_interval_s,
                labels={"tenant": t})
            engine.bind(self.metrics.tenant_view(t), events=self.events)
            with self._lock:
                if t in self._engines:
                    continue
                if len(self._engines) >= self._max_tenants:
                    self._overflow += 1
                    continue
                self._engines[t] = engine
        with self._lock:
            return list(self._engines.values())

    def maybe_evaluate(self) -> None:
        """Clock-gated evaluation of every tenant's engine (each
        engine gates itself, so this is one lock hop + N cheap clock
        reads per dispatch)."""
        if self.metrics is None:
            return
        for engine in self._engines_for(self.metrics.tenant_ids()):
            engine.maybe_evaluate()

    def evaluate(self) -> None:
        """Force one evaluation per tenant engine (run-end closing
        evaluation, same role as ``SLOEngine.evaluate``)."""
        if self.metrics is None:
            return
        for engine in self._engines_for(self.metrics.tenant_ids()):
            engine.evaluate()

    def engine(self, tenant: str) -> Optional[SLOEngine]:
        with self._lock:
            return self._engines.get(str(tenant))

    def status(self) -> Dict[str, Any]:
        """Per-tenant ``SLOEngine.status()`` payloads (the
        ``/healthz`` tenancy section + the loadgen report)."""
        with self._lock:
            engines = dict(self._engines)
        return {t: e.status() for t, e in sorted(engines.items())}

    def alerts_fired(self) -> Dict[str, int]:
        """Per-tenant fired-alert totals — the fairness/isolation
        figure (offender fires, nobody else does)."""
        with self._lock:
            engines = dict(self._engines)
        return {t: e.status()["alerts_fired"]
                for t, e in sorted(engines.items())}

    def labeled_gauges(self) -> Dict[str, list]:
        """Per-tenant labeled series for
        ``prometheus_text(labeled_gauges=)``: each engine's flat
        gauges re-shaped as ``tenant_slo_*{tenant=...}``."""
        with self._lock:
            engines = dict(self._engines)
        out: Dict[str, list] = {}
        for t, engine in sorted(engines.items()):
            lbl = {"tenant": t}
            for key, value in engine.gauges().items():
                out.setdefault(f"tenant_{key}", []).append((lbl, value))
        return out

    def counters(self) -> Dict[str, int]:
        with self._lock:
            engines = dict(self._engines)
            overflow = self._overflow
        return {
            "tenant_slo_engines": len(engines),
            "tenant_slo_overflow": overflow,
            "tenant_slo_alerts_fired": sum(
                e.counters()["slo_alerts_fired"]
                for e in engines.values()),
        }
