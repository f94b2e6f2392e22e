"""Incident flight recorder: always-on rings, triggered evidence dumps.

When the breaker opens or a deadline storm hits, the evidence a
post-mortem needs — the events, spans, and metric trajectory leading
INTO the incident — is exactly what the bounded obs buffers are about
to evict. The :class:`FlightRecorder` is the black box: it rides along
holding bounded rings of recent history, and on a **trigger** dumps
one debounced, disk-bounded, self-contained incident bundle.

Triggers (:data:`DEFAULT_TRIGGERS`) are event kinds observed through
an :meth:`~porqua_tpu_torch.obs.events.EventBus.add_listener` hook: breaker
opens, retry give-ups, validation failures, sanitizer/TSAN errors,
harvest-sink death, firing SLO alerts (:mod:`porqua_tpu_torch.obs.slo`), and
convergence anomalies (:mod:`porqua_tpu_torch.obs.anomaly`). ``slo_alert``
and ``convergence_anomaly`` events trigger only in their ``firing``
state — resolutions are history, not incidents.

One bundle (``incident-<seq>-<kind>.json.gz``) is self-contained:
the trigger event, a config fingerprint, the full metrics snapshot,
the recent metric-snapshot ring, the event/span tails, recent
SolveRecords, per-device breaker history, and the SLO/anomaly status
at dump time — renderable offline by ``scripts/incident_report.py``.
Dumps are debounced (``debounce_s`` on an injectable monotonic clock:
one bundle per window however many triggers fire inside it) and
disk-bounded (``max_bundles`` newest kept, oldest deleted).

The recorder is pure host bookkeeping around buffers the serve stack
already fills: a live, dumping recorder changes nothing the card runs
(``chip_smoke.py`` phase 10 replays hooked batches bare and compares
launches and bits). Breaker history names devices by the port's labels
(``"cuda:0"``). The port of ``porqua_tpu/obs/flight.py``.
"""

from __future__ import annotations

import collections
import gzip
import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from porqua_tpu_torch.analysis import tsan

__all__ = [
    "BUNDLE_VERSION",
    "DEFAULT_TRIGGERS",
    "FlightRecorder",
    "load_bundle",
]

BUNDLE_VERSION = 1

#: Event kinds that open an incident (the trigger inventory — README
#: "SLOs, alerting & incident response" documents each). Stateful
#: kinds (``slo_alert``, ``convergence_anomaly``, ``vitals_anomaly``)
#: trigger only when their ``state`` field is ``firing``.
#: ``worker_lost`` and ``vitals_anomaly`` come from the fleet plane
#: (:mod:`porqua_tpu_torch.obs.federation` / :mod:`porqua_tpu_torch.obs.vitals`):
#: a crashed loadgen shard or a leaking worker must land an incident
#: bundle, not a silent throughput dip. ``route_rollback`` comes from
#: the calibration plane (:mod:`porqua_tpu_torch.obs.calibrate`): a promoted
#: route table the guard window had to revert is an incident — the
#: bundle carries the evidence diff that promoted it and the breach
#: that shot it down.
DEFAULT_TRIGGERS = (
    "breaker_open",
    "retry_giveup",
    "validation_failed",
    "sanitizer_violation",
    "harvest_sink_failed",
    "slo_alert",
    "convergence_anomaly",
    "worker_lost",
    "vitals_anomaly",
    "route_rollback",
)

#: Kinds whose events carry an alert ``state`` — only the firing edge
#: is an incident.
_STATEFUL_TRIGGERS = ("slo_alert", "convergence_anomaly",
                      "vitals_anomaly")

#: Event kinds folded into the bundle's per-device breaker history.
_BREAKER_KINDS = ("breaker_open", "breaker_close", "probe_failure")


def load_bundle(path: str) -> Dict[str, Any]:
    """Read one incident bundle back (``.json.gz`` or plain JSON)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


class FlightRecorder:
    """The always-on incident black box (see module docstring).

    ``out_dir=None`` keeps bundles as in-memory dicts (tests, the
    chaos suite's per-cell assertions still parse real written files
    when a directory is given). ``armed=False`` starts the recorder
    observing but not dumping — ``arm()`` when the window of interest
    opens (the chaos suite arms after prewarm so warmup compiles don't
    spend the debounce budget).

    Thread-safety: ``on_event`` runs on whatever thread emits the
    trigger (dispatch thread, health-manager threads, retry timer);
    ``record_solve``/``maybe_snapshot`` on the dispatch thread;
    readers anywhere. The recorder lock guards only recorder state —
    ring gathering at dump time reads the bus/spans/metrics through
    their own locks with the recorder lock RELEASED, so the lock graph
    stays acyclic.
    """

    def __init__(self,
                 out_dir: Optional[str] = None,
                 triggers: Tuple[str, ...] = DEFAULT_TRIGGERS,
                 debounce_s: float = 30.0,
                 max_bundles: int = 16,
                 armed: bool = True,
                 solve_capacity: int = 256,
                 snapshot_capacity: int = 64,
                 events_tail: int = 2048,
                 spans_tail: int = 1024,
                 snapshot_interval_s: float = 5.0,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.out_dir = out_dir
        self.triggers = frozenset(triggers)
        self.debounce_s = float(debounce_s)
        self.max_bundles = int(max_bundles)
        self.events_tail = int(events_tail)
        self.spans_tail = int(spans_tail)
        self.snapshot_interval_s = float(snapshot_interval_s)
        self.clock = time.monotonic if clock is None else clock
        self.metrics = None
        self.obs = None
        self.slo = None
        self.anomaly = None
        self.cache = None
        self._params_repr: Optional[str] = None
        self._extra_config: Dict[str, Any] = {}
        self._lock = tsan.lock("FlightRecorder")
        self._armed = bool(armed)          # guarded-by: self._lock
        self._seq = 0                      # guarded-by: self._lock
        self._last_dump = float("-inf")    # guarded-by: self._lock
        self._last_snapshot = float("-inf")  # guarded-by: self._lock
        self._suppressed = 0               # guarded-by: self._lock
        self._write_failures = 0           # guarded-by: self._lock
        # guarded-by: self._lock
        self._solves: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=int(solve_capacity)))
        # guarded-by: self._lock
        self._snapshots: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=int(snapshot_capacity)))
        # Written paths (file mode) or bundle dicts (memory mode),
        # oldest first.                      guarded-by: self._lock
        self._bundles: List[Any] = []
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)

    # -- wiring -------------------------------------------------------

    def attach(self, metrics=None, obs=None, params=None, slo=None,
               anomaly=None, cache=None,
               extra_config: Optional[Dict[str, Any]] = None
               ) -> "FlightRecorder":
        """Point the recorder at the serve stack's obs surfaces
        (``SolveService`` calls this and registers :meth:`on_event` as
        an event-bus listener). ``params`` feeds the bundle's config
        fingerprint; ``extra_config`` rides along verbatim. ``cache``
        (an :class:`~porqua_tpu_torch.serve.bucketing.ExecutableCache`)
        names the implicated bucket and supplies its CostRecords to
        each bundle."""
        if metrics is not None:
            self.metrics = metrics
        if obs is not None:
            self.obs = obs
        if slo is not None:
            self.slo = slo
        if anomaly is not None:
            self.anomaly = anomaly
        if cache is not None:
            self.cache = cache
        if params is not None:
            self._params_repr = repr(params)
        if extra_config:
            self._extra_config.update(extra_config)
        return self

    def arm(self) -> None:
        with self._lock:
            self._armed = True

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    # -- feeds --------------------------------------------------------

    def record_solve(self, record: Dict[str, Any]) -> None:
        """One resolved request's SolveRecord into the bounded ring
        (the batchers call this per retirement when a recorder is
        wired — same record the harvest sink receives)."""
        with self._lock:
            self._solves.append(record)

    def record_snapshot(self, snapshot: Dict[str, Any]) -> None:
        with self._lock:
            self._snapshots.append(snapshot)

    def maybe_snapshot(self) -> None:
        """Clock-gated metrics-snapshot sampling (called per request
        retirement; one snapshot per ``snapshot_interval_s``), so the
        bundle carries the metric TRAJECTORY into the incident, not
        just the end state."""
        if self.metrics is None:
            return
        now = self.clock()
        with self._lock:
            if now - self._last_snapshot < self.snapshot_interval_s:
                return
            self._last_snapshot = now
        snap = self.metrics.snapshot()
        self.record_snapshot(snap)

    # -- triggering ---------------------------------------------------

    def on_event(self, event: Dict[str, Any]) -> None:
        """EventBus listener: dump on a trigger kind. Never raises
        (the bus already shields listeners, but a recorder failure
        must degrade to a counter either way)."""
        kind = event.get("kind")
        if kind not in self.triggers:
            return
        if kind in _STATEFUL_TRIGGERS and event.get("state") != "firing":
            return
        self._trigger(event)

    def dump(self, kind: str = "manual", **fields) -> Optional[Any]:
        """Programmatic trigger (operator tooling, tests): dump now,
        subject to the same arming and debounce as event triggers."""
        event = {"t": time.time(), "kind": kind, "severity": "info"}
        event.update(fields)
        return self._trigger(event)

    def _trigger(self, event: Dict[str, Any]) -> Optional[Any]:
        now = self.clock()
        with self._lock:
            if not self._armed:
                return None
            if now - self._last_dump < self.debounce_s:
                self._suppressed += 1
                return None
            # Reserve the debounce window BEFORE building: concurrent
            # triggers on other threads debounce against this dump.
            prev_dump = self._last_dump
            self._last_dump = now
            self._seq += 1
            seq = self._seq
        try:
            bundle = self._build(event, seq)
            out = self._store(bundle, seq, str(event.get("kind", "?")))
        except Exception:  # noqa: BLE001 - the recorder must never
            # take down the path that triggered it (often the breaker's
            # own trip path); a failed dump is a counted loss — and it
            # must NOT consume the debounce window: a transient disk
            # error at the first trigger would otherwise suppress every
            # retrigger for the whole incident, capturing nothing.
            with self._lock:
                self._write_failures += 1
                if self._last_dump == now:
                    self._last_dump = prev_dump
            return None
        return out

    # -- bundle assembly ---------------------------------------------

    def _config(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = dict(self._extra_config)
        cfg["pid"] = os.getpid()
        if self._params_repr is not None:
            cfg["params"] = self._params_repr
            cfg["fingerprint"] = hashlib.blake2b(
                self._params_repr.encode(), digest_size=8).hexdigest()
        return cfg

    @staticmethod
    def _breaker_history(events: List[Dict[str, Any]]
                         ) -> Dict[str, List[Dict[str, Any]]]:
        """Per-device breaker/probe timeline from the event tail."""
        out: Dict[str, List[Dict[str, Any]]] = {}
        for e in events:
            kind = e.get("kind")
            if kind not in _BREAKER_KINDS:
                continue
            device = str(e.get("device") or e.get("primary") or "?")
            out.setdefault(device, []).append(
                {"t": e.get("t"), "kind": kind,
                 **{k: v for k, v in e.items()
                    if k not in ("t", "kind", "severity")}})
        return out

    def _build(self, trigger: Dict[str, Any], seq: int) -> Dict[str, Any]:
        """Assemble one bundle. Reads the bus/spans/metrics through
        their own locks with the recorder lock released."""
        events: List[Dict[str, Any]] = []
        spans: List[Dict[str, Any]] = []
        if self.obs is not None:
            events = self.obs.events.events()[-self.events_tail:]
            spans = [
                {"name": s.name, "t_start": s.t_start, "t_end": s.t_end,
                 "trace_id": s.trace_id, "args": s.args}
                for s in self.obs.spans.spans()[-self.spans_tail:]]
        bundle: Dict[str, Any] = {
            "v": BUNDLE_VERSION,
            "t": time.time(),
            "seq": seq,
            "trigger": dict(trigger),
            "config": self._config(),
            "events": events,
            "spans": spans,
            "breaker_history": self._breaker_history(events),
        }
        if self.metrics is not None:
            bundle["counters"] = self.metrics.snapshot()
        with self._lock:
            bundle["snapshots"] = list(self._snapshots)
            bundle["solves"] = list(self._solves)
        if self.slo is not None:
            bundle["slo"] = self.slo.status()
        if self.anomaly is not None:
            bundle["anomaly"] = self.anomaly.status()
        if self.cache is not None:
            # Device-truth cost evidence: the CostRecords of the
            # implicated bucket's executables (triggers that carry a
            # `bucket` field — dispatch failures, sanitizer refusals,
            # anomalies), falling back to the whole harvested set
            # when the trigger names none. Bounded: a cache holds a
            # handful of executables per bucket, not per request.
            try:
                records = self.cache.cost_records()
            except Exception:  # noqa: BLE001 - evidence, not dependency
                records = []
            implicated = trigger.get("bucket")
            if implicated is not None:
                # Exact bucket, or its factored variants ("NxM" events
                # cover "NxMxfR" labels) — a bare prefix would also
                # swallow unrelated buckets ("32x8" matching "32x80").
                b = str(implicated)
                matched = [r for r in records
                           if str(r.get("bucket", "")) == b
                           or str(r.get("bucket", "")).startswith(
                               b + "xf")]
                if matched:
                    records = matched
                bundle["implicated_bucket"] = str(implicated)
            bundle["cost_records"] = records[:64]
        return bundle

    def _store(self, bundle: Dict[str, Any], seq: int, kind: str):
        if self.out_dir is None:
            with self._lock:
                self._bundles.append(bundle)
                while len(self._bundles) > self.max_bundles:
                    self._bundles.pop(0)
            return bundle
        safe_kind = "".join(c if c.isalnum() or c in "-_" else "_"
                            for c in kind)
        path = os.path.join(self.out_dir,
                            f"incident-{seq:04d}-{safe_kind}.json.gz")
        with gzip.open(path, "wt") as f:
            json.dump(bundle, f, default=str)
        evict: List[str] = []
        with self._lock:
            self._bundles.append(path)
            while len(self._bundles) > self.max_bundles:
                evict.append(self._bundles.pop(0))
        for old in evict:  # disk-bounded: newest max_bundles kept
            try:
                os.remove(old)
            except OSError:
                pass
        return path

    # -- readers ------------------------------------------------------

    def bundles(self) -> List[Any]:
        """Written bundle paths (file mode) or bundle dicts (memory
        mode), oldest first."""
        with self._lock:
            return list(self._bundles)

    @property
    def suppressed(self) -> int:
        with self._lock:
            return self._suppressed

    def counters(self) -> Dict[str, int]:
        """Recorder health counters for ``/metrics`` + ``/healthz``."""
        with self._lock:
            # _seq counts reserved dumps; the ones that failed to
            # build/write are the write_failures — the rest landed
            # (retention may have evicted old files, but they existed).
            return {"flight_bundles": self._seq - self._write_failures,
                    "flight_dumps_suppressed": self._suppressed,
                    "flight_write_failures": self._write_failures}
