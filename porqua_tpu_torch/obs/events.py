"""Structured JSON-lines event bus for the serve stack (the port of
``porqua_tpu/obs/events.py``, a host copy).

Metrics answer "how much"; the event bus answers "what happened, when,
to which request": compile events from the executable cache,
circuit-breaker transitions from the device-health manager, sanitizer
violations, backpressure rejections, deadline expiries, and the
calibration plane's route-table lifecycle (``route_reseed`` on every
candidate/promoted/abandoned/settled transition with the evidence
diff; ``route_rollback`` when the post-promotion guard reverts a
table — a flight-recorder trigger) are each
one structured record stamped with a severity and (where one exists)
the request's trace id, so a latency outlier in the span timeline
cross-references to the compile or breaker flip that caused it.

Events are plain dicts — host-side, lock-protected, bounded (a serving
process must not grow its event buffer without limit), with an
optional streaming JSON-lines sink so a crash loses at most the last
buffered line. Event schema: README "Observability".
"""

from __future__ import annotations

import collections
import json
import time
from typing import Any, Dict, List, Optional

from porqua_tpu_torch.analysis import tsan

#: Severity order, least to most severe.
SEVERITIES = ("debug", "info", "warn", "error")


class EventBus:
    """Thread-safe bounded event sink with optional JSONL streaming.

    ``emit`` never raises and never blocks on anything but the lock —
    it is called from hot serving paths (dispatch thread, submitter
    threads), so a broken sink file degrades to counting drops rather
    than failing a batch. The buffer is a ring keeping the NEWEST
    ``capacity`` events (evictions are counted in ``dropped``): the
    recent tail — the breaker flip that just happened — is what a
    diagnostic read needs; use the streaming ``path`` sink to keep the
    complete history.
    """

    def __init__(self, capacity: int = 65536,
                 path: Optional[str] = None) -> None:
        self.capacity = int(capacity)
        self._lock = tsan.lock("EventBus")
        # guarded-by: self._lock
        self._events: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=self.capacity))
        self._dropped = 0                        # guarded-by: self._lock
        self._sink_failures = 0                  # guarded-by: self._lock
        self._listeners: List = []               # guarded-by: self._lock
        self._listener_failures = 0              # guarded-by: self._lock
        self._sink = open(path, "a") if path else None

    def emit(self, kind: str, severity: str = "info",
             trace_id: Optional[str] = None, **fields) -> Dict[str, Any]:
        """Record one event; returns the record (for tests/logging)."""
        if severity not in SEVERITIES:
            severity = "info"
        event: Dict[str, Any] = {
            "t": time.time(),
            "kind": kind,
            "severity": severity,
        }
        if trace_id is not None:
            event["trace_id"] = trace_id
        event.update(fields)
        # Serialize OUTSIDE the sink try-block (same as HarvestSink):
        # a json.dumps ValueError is a caller bug in the event fields,
        # not a dead sink, and must not permanently disable a healthy
        # stream. Only when a sink exists at all — the common
        # sink-less bus must not pay per-emit serialization on the
        # dispatch hot path (the unlocked read is a one-way race:
        # _sink only ever transitions to None).
        line = (json.dumps(event, default=str)
                if self._sink is not None else None)
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1  # deque evicts the oldest
            self._events.append(event)
            if self._sink is not None and line is not None:
                try:
                    self._sink.write(line + "\n")
                    self._sink.flush()
                except (OSError, ValueError):
                    # ValueError: write on a file something already
                    # closed (shutdown races included) — same posture.
                    # Dead sink: keep serving, but COUNT the failure —
                    # from the scrape's point of view a silently-dead
                    # stream sink looks identical to a healthy idle one
                    # otherwise (the counter is exported via
                    # /metrics and /healthz by SolveService).
                    self._sink_failures += 1
                    self._sink = None
            listeners = list(self._listeners) if self._listeners else None
        if listeners is not None:
            # OUTSIDE the lock: a listener (the flight recorder's
            # trigger path) reads this bus and other obs surfaces back
            # — calling it under the bus lock would self-deadlock and
            # put every other emitter behind a bundle dump.
            for fn in listeners:
                try:
                    fn(event)
                except Exception:  # noqa: BLE001 - a broken listener
                    # must not fail the emitting hot path; count it
                    # (exported with the other loss counters).
                    with self._lock:
                        self._listener_failures += 1
        return event

    def add_listener(self, fn) -> None:
        """Register a callback invoked (outside the bus lock, on the
        emitting thread) with every event record — the flight
        recorder's trigger feed. Listeners must be fast and must not
        raise; exceptions are swallowed and counted."""
        with self._lock:
            self._listeners.append(fn)

    # -- readers -----------------------------------------------------

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    @property
    def sink_failures(self) -> int:
        with self._lock:
            return self._sink_failures

    @property
    def listener_failures(self) -> int:
        with self._lock:
            return self._listener_failures

    def events(self, kind: Optional[str] = None,
               min_severity: str = "debug") -> List[Dict[str, Any]]:
        """Buffered events, optionally filtered by kind and severity."""
        floor = SEVERITIES.index(min_severity)
        with self._lock:
            return [e for e in self._events
                    if (kind is None or e["kind"] == kind)
                    and SEVERITIES.index(e["severity"]) >= floor]

    def write_jsonl(self, path: str) -> int:
        """Dump every buffered event to ``path``; returns the count."""
        events = self.events()
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e, default=str) + "\n")
        return len(events)

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read an event JSONL file back into a list of dicts (blank lines
    skipped) — the reader ``scripts/obs_report.py`` uses."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
