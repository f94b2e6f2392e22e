"""Fleet telemetry federation: N worker processes, one obs plane (the
port of ``porqua_tpu/obs/federation.py``).

Everything the obs stack built through the live operational plane is
single-process: every counter, alert, and incident bundle lives inside
one ``SolveService``. The millions-of-users loadgen regime (ROADMAP)
is multi-process by construction — N workers each with their own device
client, solve service, and open-loop arrival shard — so this module
federates their telemetry:

* :class:`WorkerStream` — the worker-side emitter: one append-only
  JSONL stream per worker (``hello`` / ``sample`` / ``event`` /
  ``heartbeat`` / ``report`` envelopes). ``emit`` never raises (same
  posture as :class:`~porqua_tpu_torch.obs.harvest.HarvestSink`): a dead
  stream degrades to counting ``write_failures``, never to failing a
  solve. Cumulative ``sample`` envelopes carry the worker's raw
  ``ServeMetrics.slo_sample()`` counters + histogram state, a
  snapshot subset, and :func:`porqua_tpu_torch.obs.vitals.process_vitals`.
* :class:`FleetCollector` — the parent-side aggregator: incrementally
  drains every worker stream (byte offsets, partial trailing lines
  left for the next drain), namespaces trace/request ids by worker
  (``w3/a1b2...``), merges fleet counters and **raw latency
  histograms** (bucket-count sums — never percentiles, which do not
  compose), evaluates fleet-wide SLOs and burn rates through the
  existing :class:`~porqua_tpu_torch.obs.slo.SLOEngine` (the collector IS
  the engine's metrics source: it implements ``slo_sample()``),
  forwards worker events onto a fleet :class:`EventBus` (where the
  :class:`~porqua_tpu_torch.obs.flight.FlightRecorder` listens), serves a
  fleet ``/metrics`` + ``/healthz`` with per-worker labeled gauges
  (``prometheus_text(labeled_gauges=)``), keeps **bounded** sustained-
  soak rollups (a fixed-size ring of per-window aggregates — never
  unbounded event retention), feeds per-worker vitals into
  :class:`~porqua_tpu_torch.obs.vitals.VitalsTrend` leak detection, and
  tracks worker **liveness**: a stream that goes stale past
  ``heartbeat_timeout_s`` without a clean final ``report`` fires ONE
  ``worker_lost`` event — a flight-recorder trigger — so a crashed
  loadgen shard produces a fleet incident bundle, not a silent
  throughput dip.

The JAX package's ``scripts/fleet_loadgen.py`` is the driver that
wires both halves. The whole plane is pure host file/dict code: it
launches nothing on the device and changes no solve.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from porqua_tpu_torch.analysis import tsan

__all__ = ["FleetCollector", "WorkerStream"]

#: Envelope kinds a worker stream may carry (unknown kinds are counted
#: and skipped — a newer worker must not wedge an older collector).
STREAM_KINDS = ("hello", "sample", "event", "heartbeat", "report")

#: Fields of ``ServeMetrics.slo_sample()`` merged by summation (the
#: latency histogram fields are merged element-wise separately).
_SLO_COUNTER_KEYS = ("completed", "failed", "expired", "retry_giveups",
                     "validation_failures")


class WorkerStream:
    """Worker-side JSONL telemetry emitter (one file per worker).

    Each line is one envelope: ``{"t": <unix>, "w": <worker_id>,
    "kind": <kind>, ...payload}``. Writes flush per line so the
    collector can tail the stream live; a mid-line crash leaves a
    partial trailing line the collector simply does not consume.
    Thread-safety: ``event`` runs on whatever thread emits (the
    worker's EventBus listener feed), ``sample``/``report`` on the
    worker's main loop — all writes are serialized by the lock.
    """

    def __init__(self, path: str, worker_id: str) -> None:
        self.path = str(path)
        self.worker_id = str(worker_id)
        self._lock = tsan.lock("WorkerStream")
        self._records = 0             # guarded-by: self._lock
        self._write_failures = 0      # guarded-by: self._lock
        self._sink = None             # guarded-by: self._lock
        try:
            self._sink = open(path, "a")
        except OSError:
            self._write_failures += 1

    def _emit(self, kind: str, **payload) -> None:
        """Append one envelope; never raises (a dead stream makes this
        worker go stale, which the collector's liveness tracking
        reports as ``worker_lost`` — exactly what it looks like from
        the fleet's side)."""
        rec = {"t": time.time(), "w": self.worker_id, "kind": kind}
        rec.update(payload)
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._sink is None:
                self._write_failures += 1
                return
            try:
                self._sink.write(line + "\n")
                self._sink.flush()
            except (OSError, ValueError):
                self._write_failures += 1
                self._sink = None  # dead stream: keep the worker alive
            else:
                self._records += 1

    # -- envelope constructors ---------------------------------------

    def hello(self, latency_le=(), **meta) -> None:
        """Stream header: the worker's pid and latency-histogram
        ladder (the collector refuses to merge mismatched ladders —
        summed bucket counts would be meaningless)."""
        self._emit("hello", pid=os.getpid(),
                   latency_le=[float(b) for b in latency_le], **meta)

    def sample(self, slo: Dict[str, Any],
               hist: Optional[Dict[str, Any]] = None,
               snap: Optional[Dict[str, Any]] = None,
               vitals: Optional[Dict[str, Any]] = None) -> None:
        """One cumulative telemetry sample: raw ``slo_sample()``
        counters (+ optional ``histograms()`` state, snapshot subset,
        process vitals). Samples double as heartbeats."""
        payload: Dict[str, Any] = {"slo": slo}
        if hist is not None:
            payload["hist"] = hist
        if snap is not None:
            payload["snap"] = snap
        if vitals is not None:
            payload["vitals"] = vitals
        self._emit("sample", **payload)

    def event(self, event: Dict[str, Any]) -> None:
        """Forward one structured event record (an EventBus listener
        feeds this, so the fleet sees breaker flips, SLO alerts, and
        fault injections from every worker)."""
        self._emit("event", event=event)

    def heartbeat(self) -> None:
        self._emit("heartbeat")

    def report(self, report: Dict[str, Any]) -> None:
        """The worker's final merged report — also the clean-shutdown
        marker: a worker that reported is *finished*, never *lost*."""
        self._emit("report", report=report)

    # -- readers / lifecycle -----------------------------------------

    @property
    def records(self) -> int:
        with self._lock:
            return self._records

    @property
    def write_failures(self) -> int:
        with self._lock:
            return self._write_failures

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    self._write_failures += 1
                self._sink = None


class _WorkerState:
    """Collector-side per-worker state (guarded by the collector lock)."""

    __slots__ = ("worker_id", "path", "offset", "last_seen", "lost",
                 "finished", "refused", "hello", "slo", "hist", "snap",
                 "vitals", "report", "records", "events", "parse_errors",
                 "vitals_pending")

    def __init__(self, worker_id: str, path: str, now: float) -> None:
        self.worker_id = worker_id
        self.path = path
        self.offset = 0                 # consumed byte offset
        self.last_seen = now            # collector clock, not stream t
        self.lost = False
        self.finished = False
        self.refused = False            # sticky: ladder mismatch at hello
        self.hello: Optional[Dict[str, Any]] = None
        self.slo: Optional[Dict[str, Any]] = None
        self.hist: Optional[Dict[str, Any]] = None
        self.snap: Dict[str, Any] = {}
        self.vitals: Dict[str, Any] = {}
        self.report: Optional[Dict[str, Any]] = None
        self.records = 0
        self.events = 0
        self.parse_errors = 0
        self.vitals_pending = False     # new vitals since last trend obs


class FleetCollector:
    """Aggregate N worker telemetry streams into one fleet plane.

    The collector deliberately implements the :class:`ServeMetrics`
    *reader* surface the rest of the obs stack consumes —
    ``slo_sample()`` (the SLO engine's feed), ``snapshot()`` (the
    flight recorder's counter dump + the ``/metrics`` exposition),
    ``histograms()`` (merged raw latency histograms) — so the existing
    :class:`~porqua_tpu_torch.obs.slo.SLOEngine` and
    :class:`~porqua_tpu_torch.obs.flight.FlightRecorder` run over the fleet
    unchanged. ``events`` is the fleet bus: every worker event is
    re-emitted there with its trace id namespaced ``<worker>/<id>``
    and a ``worker`` field, and collector-originated events
    (``worker_lost``) land next to them.

    Thread-safety: ``drain``/``check_liveness`` run on the driver
    loop; the reader surface on scrape threads and (via the engine /
    recorder) on listener threads. All collector state is guarded by
    the instance lock; event emission, SLO evaluation, and vitals
    trending run OUTSIDE it — the flight recorder's dump path calls
    ``snapshot()`` back from inside an event listener, and the engine
    holds its own lock while reading ``slo_sample()`` (one-way
    engine -> collector edge, mirroring engine -> metrics).
    """

    def __init__(self,
                 heartbeat_timeout_s: float = 15.0,
                 rollup_window_s: float = 30.0,
                 rollup_capacity: int = 512,
                 events=None,
                 slo=None,
                 flight=None,
                 vitals_trend=None,
                 clock=None) -> None:
        from porqua_tpu_torch.obs.events import EventBus

        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.rollup_window_s = float(rollup_window_s)
        self.clock = time.monotonic if clock is None else clock
        self.events = EventBus() if events is None else events
        self.slo = slo
        self.flight = flight
        self.vitals_trend = vitals_trend
        if slo is not None:
            slo.bind(self, events=self.events)
        if vitals_trend is not None and vitals_trend.events is None:
            vitals_trend.events = self.events
        if flight is not None:
            flight.attach(metrics=self, slo=slo)
            self.events.add_listener(flight.on_event)
        self._lock = tsan.lock("FleetCollector")
        # guarded-by: self._lock
        self._workers: Dict[str, _WorkerState] = {}
        self._records = 0               # guarded-by: self._lock
        self._events_forwarded = 0      # guarded-by: self._lock
        self._parse_errors = 0          # guarded-by: self._lock
        self._unknown_kinds = 0         # guarded-by: self._lock
        self._lost_total = 0            # guarded-by: self._lock
        self._refusals = 0              # guarded-by: self._lock
        self._latency_le: Optional[Tuple[float, ...]] = None  # guarded-by: self._lock
        self._start_mono = self.clock()
        self._start_wall = time.time()
        # Bounded soak rollups: one aggregate row per closed
        # rollup_window_s window, newest rollup_capacity kept.
        # guarded-by: self._lock
        self._rollups: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=int(rollup_capacity)))
        self._window_idx = 0            # guarded-by: self._lock
        self._window_base: Dict[str, float] = {}  # guarded-by: self._lock
        self._http = None

    # -- wiring -------------------------------------------------------

    def add_worker(self, worker_id: str, path: str) -> None:
        """Register one worker stream (before or after the file
        exists — a not-yet-created stream is simply empty). The
        liveness clock starts at registration."""
        with self._lock:
            if worker_id in self._workers:
                raise ValueError(f"worker {worker_id!r} already registered")
            self._workers[worker_id] = _WorkerState(
                str(worker_id), str(path), self.clock())

    # -- draining -----------------------------------------------------

    @staticmethod
    def _read_new(st: _WorkerState) -> List[Dict[str, Any]]:
        """New COMPLETE lines from one stream since the last drain.
        A partial trailing line (mid-write, or mid-crash) is left
        unconsumed — the byte offset only advances past newlines."""
        try:
            with open(st.path, "rb") as f:
                f.seek(st.offset)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        cut = chunk.rfind(b"\n")
        if cut < 0:
            return []
        chunk = chunk[:cut + 1]
        st.offset += len(chunk)
        out: List[Dict[str, Any]] = []
        for raw in chunk.split(b"\n"):
            if not raw.strip():
                continue
            try:
                out.append(json.loads(raw))
            except (ValueError, UnicodeDecodeError):
                st.parse_errors += 1
        return out

    def _ingest(self, st, rec, forward) -> Optional[str]:  # guarded-by: self._lock
        """Fold one envelope into the worker state. Returns an error
        string instead of raising so ``drain`` can finish the round
        (other workers' records and events must land — the byte
        offsets already advanced past them) before surfacing it."""
        kind = rec.get("kind")
        st.records += 1
        if kind == "hello":
            st.hello = rec
            le = tuple(float(b) for b in rec.get("latency_le", ()))
            if le:
                if self._latency_le is None:
                    self._latency_le = le
                elif self._latency_le != le:
                    # Sticky refusal: every merge surface skips this
                    # worker from now on — a caller that swallows the
                    # error and keeps draining must never see its
                    # mismatched buckets summed into the fleet's.
                    st.refused = True
                    st.slo = None
                    st.hist = None
                    return (
                        f"worker {st.worker_id!r} declares a latency "
                        f"histogram ladder different from the fleet's "
                        f"({le} vs {self._latency_le}); merged bucket "
                        f"counts would be meaningless — align "
                        f"ServeMetrics(latency_buckets=) across workers")
        elif kind == "sample":
            if st.refused:
                return None
            slo = rec.get("slo")
            if isinstance(slo, dict):
                st.slo = slo
            hist = rec.get("hist")
            if isinstance(hist, dict):
                st.hist = hist
            snap = rec.get("snap")
            if isinstance(snap, dict):
                st.snap = snap
            vitals = rec.get("vitals")
            if isinstance(vitals, dict):
                st.vitals = vitals
                st.vitals_pending = True
        elif kind == "event":
            ev = rec.get("event")
            if isinstance(ev, dict):
                st.events += 1
                forward.append((st.worker_id, ev))
        elif kind == "report":
            rep = rec.get("report")
            if isinstance(rep, dict):
                st.report = rep
            st.finished = True
        elif kind == "heartbeat":
            pass
        else:
            self._unknown_kinds += 1

    def drain(self) -> Dict[str, Any]:
        """Consume every stream's new lines, fold rollups, forward
        events, feed vitals trends, evaluate fleet SLOs, and check
        liveness. The driver loop calls this on its poll interval;
        call it one final time after the workers exit so the tail of
        every stream lands. Returns drain stats."""
        forward: List[Tuple[str, Dict[str, Any]]] = []
        vitals_obs: List[Tuple[str, Dict[str, Any]]] = []
        errors: List[str] = []
        now = self.clock()
        with self._lock:
            new_records = 0
            for st in self._workers.values():
                recs = self._read_new(st)
                if recs:
                    st.last_seen = now
                    new_records += len(recs)
                for rec in recs:
                    err = self._ingest(st, rec, forward)
                    if err is not None:
                        self._refusals += 1
                        errors.append(err)
                if st.vitals_pending:
                    st.vitals_pending = False
                    vitals_obs.append((st.worker_id, dict(st.vitals)))
                self._parse_errors += st.parse_errors
                st.parse_errors = 0
            self._records += new_records
            self._events_forwarded += len(forward)
            self._roll(now)
        # Everything below runs OUTSIDE the collector lock: emit()
        # fans out to the flight recorder, whose dump path reads
        # snapshot()/status() back through this collector's lock.
        for wid, ev in forward:
            self._forward(wid, ev)
        if self.vitals_trend is not None:
            for wid, v in vitals_obs:
                self.vitals_trend.observe(wid, v)
        if self._slo_ready():
            self.slo.maybe_evaluate()
        lost = self.check_liveness()
        if errors:
            # Raised once, on the drain that discovered the mismatch
            # — AFTER the round landed (the refusal itself is sticky,
            # so a supervisor that catches this and keeps polling gets
            # clean merges that simply exclude the refused worker).
            raise ValueError("; ".join(errors))
        return {"records": new_records, "events": len(forward),
                "workers_lost": lost}

    def _slo_ready(self) -> bool:
        """The fleet SLO engine only evaluates once at least one
        worker has declared its histogram ladder (``hello``): before
        that the merged latency histogram has no edges for the
        latency SLO to read a target off."""
        if self.slo is None:
            return False
        with self._lock:
            return self._latency_le is not None

    def _forward(self, worker_id: str, event: Dict[str, Any]) -> None:
        """Re-emit one worker event on the fleet bus, trace/request
        ids namespaced by worker so two workers' request #17 stay
        distinguishable in the merged log."""
        fields = {k: v for k, v in event.items()
                  if k not in ("kind", "severity", "trace_id")}
        for key in ("request_id",):
            if key in fields and fields[key] is not None:
                fields[key] = f"{worker_id}/{fields[key]}"
        fields["worker"] = worker_id
        trace_id = event.get("trace_id")
        self.events.emit(
            str(event.get("kind", "?")),
            str(event.get("severity", "info")),
            trace_id=(None if trace_id is None
                      else f"{worker_id}/{trace_id}"),
            **fields)

    # -- liveness -----------------------------------------------------

    def check_liveness(self, now: Optional[float] = None) -> List[str]:
        """Mark workers whose stream went stale past the heartbeat
        deadline as lost; emits ONE ``worker_lost`` event each (the
        flight-recorder trigger). A worker that sent its final
        ``report`` is finished, never lost. Returns the newly-lost
        worker ids."""
        now = self.clock() if now is None else float(now)
        newly: List[Tuple[str, float]] = []
        with self._lock:
            for st in self._workers.values():
                if st.lost or st.finished:
                    continue
                age = now - st.last_seen
                if age > self.heartbeat_timeout_s:
                    st.lost = True
                    self._lost_total += 1
                    newly.append((st.worker_id, age))
        for wid, age in newly:  # outside the lock: emit -> flight dump
            self.events.emit(
                "worker_lost", "error", worker=wid,
                stale_s=round(age, 3),
                heartbeat_timeout_s=self.heartbeat_timeout_s,
                last_completed=self._worker_completed(wid))
        return [wid for wid, _ in newly]

    def _worker_completed(self, worker_id: str) -> Optional[int]:
        with self._lock:
            st = self._workers.get(worker_id)
            if st is None or st.slo is None:
                return None
            return int(st.slo.get("completed", 0))

    # -- rollups ------------------------------------------------------

    def _totals(self) -> Dict[str, float]:  # guarded-by: self._lock
        out = {k: 0.0 for k in _SLO_COUNTER_KEYS}
        out["latency_count"] = 0.0
        for st in self._workers.values():
            if st.slo is None or st.refused:
                continue
            for k in _SLO_COUNTER_KEYS:
                out[k] += float(st.slo.get(k, 0))
            out["latency_count"] += float(st.slo.get("latency_count", 0))
        return out

    def _totals_tenants(self) -> Dict[str, Dict[str, float]]:  # guarded-by: self._lock
        """Fleet-wide per-tenant counter sums from the workers' latest
        snapshot sections (counters only — per-tenant latency
        percentiles do NOT compose across workers and are never
        merged; the fleet-level latency story stays with the raw
        merged histograms)."""
        out: Dict[str, Dict[str, float]] = {}
        for st in self._workers.values():
            if st.refused:
                continue
            tenants = st.snap.get("tenants")
            if not isinstance(tenants, dict):
                continue
            for tenant, row in tenants.items():
                if not isinstance(row, dict):
                    continue
                tgt = out.setdefault(str(tenant), {})
                for k, v in row.items():
                    if k.startswith("latency_"):
                        continue
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)):
                        continue
                    tgt[k] = tgt.get(k, 0.0) + float(v)
        return out

    def _roll(self, now: float) -> None:  # guarded-by: self._lock
        """Close any elapsed rollup window: one bounded aggregate row
        of the fleet's *deltas* over the window plus the vitals
        high-water marks — the whole sustained-soak record the
        collector retains (the ring is the memory bound; individual
        samples/events are never retained past their drain)."""
        idx = int((now - self._start_mono) // self.rollup_window_s)
        if idx <= self._window_idx:
            return
        totals = self._totals()
        base = self._window_base
        active = [st for st in self._workers.values()
                  if not st.lost and not st.finished]
        row = {
            "window": self._window_idx,
            "t": time.time(),
            # A poll stall can close several windows at once; the row
            # then carries every elapsed window's deltas, so its span
            # must say so — rates derived from rollups stay honest.
            "span_s": (idx - self._window_idx) * self.rollup_window_s,
            "workers_active": len(active),
            **{k: totals[k] - base.get(k, 0.0) for k in totals},
        }
        # Vitals aggregate over ACTIVE workers only: a dead worker's
        # process is gone, so folding its last pre-crash sample into
        # every later window would inflate the soak's memory record.
        rss = [float(st.vitals["rss_bytes"]) for st in active
               if st.vitals.get("rss_bytes") is not None]
        if rss:
            row["rss_max_bytes"] = max(rss)
            row["rss_sum_bytes"] = sum(rss)
        depth = [float(st.vitals["queue_depth"]) for st in active
                 if st.vitals.get("queue_depth") is not None]
        if depth:
            row["queue_depth_max"] = max(depth)
        self._rollups.append(row)
        self._window_base = totals
        self._window_idx = idx

    def rollups(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            rows = list(self._rollups)
        return rows if last is None else rows[-int(last):]

    # -- the ServeMetrics reader surface ------------------------------

    def slo_sample(self) -> Dict[str, Any]:
        """The fleet's cumulative SLO sample: worker counters summed,
        RAW latency histograms merged bucket-wise (the engine reads
        good/bad counts off exact bucket edges of the merged
        histogram — percentiles are never merged, they do not
        compose). Workers whose ladder disagrees were refused at
        ``hello``, so the element-wise sum is well-defined."""
        with self._lock:
            totals = self._totals()
            le = self._latency_le or ()
            counts = [0] * (len(le) + 1)
            for st in self._workers.values():
                if st.slo is None or st.refused:
                    continue
                wc = st.slo.get("latency_counts", ())
                for i, c in enumerate(wc):
                    if i < len(counts):
                        counts[i] += int(c)
            return {
                **{k: int(totals[k]) for k in _SLO_COUNTER_KEYS},
                "latency_le": tuple(le),
                "latency_counts": tuple(counts),
                "latency_count": int(totals["latency_count"]),
            }

    def histograms(self) -> Dict[str, Dict[str, Any]]:
        """Merged cumulative histogram state in the
        ``ServeMetrics.histograms()`` shape (the Prometheus renderer
        consumes it unchanged)."""
        with self._lock:
            merged: Dict[str, Dict[str, Any]] = {}
            for st in self._workers.values():
                if not st.hist or st.refused:
                    continue
                for name, h in st.hist.items():
                    le = tuple(float(b) for b in h.get("le", ()))
                    tgt = merged.get(name)
                    if tgt is None:
                        merged[name] = {"le": le,
                                        "counts": [int(c) for c
                                                   in h.get("counts", ())],
                                        "sum": float(h.get("sum", 0.0)),
                                        "count": int(h.get("count", 0))}
                        continue
                    if tgt["le"] != le:
                        continue  # refused at hello; belt-and-braces
                    for i, c in enumerate(h.get("counts", ())):
                        if i < len(tgt["counts"]):
                            tgt["counts"][i] += int(c)
                    tgt["sum"] += float(h.get("sum", 0.0))
                    tgt["count"] += int(h.get("count", 0))
            return merged

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able fleet snapshot: merged counters, liveness
        totals, and derived throughput — the ``/metrics`` exposition
        body and the flight bundle's ``counters`` section."""
        with self._lock:
            totals = self._totals()
            elapsed = self.clock() - self._start_mono
            snap_keys: Dict[str, float] = {}
            snap_n: Dict[str, int] = {}
            for st in self._workers.values():
                if st.refused:
                    continue
                for k, v in st.snap.items():
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    snap_keys[k] = snap_keys.get(k, 0.0) + float(v)
                    snap_n[k] = snap_n.get(k, 0) + 1
            # Mean-shaped keys (occupancy_mean, ...) average across the
            # contributing workers — 4 workers at 0.8 occupancy are a
            # fleet at 0.8, not an impossible 3.2.
            for k, n in snap_n.items():
                if k.endswith("_mean") and n > 1:
                    snap_keys[k] /= n
            lost = sum(1 for st in self._workers.values() if st.lost)
            finished = sum(1 for st in self._workers.values()
                           if st.finished)
            out: Dict[str, Any] = {
                "t": time.time(),
                "window_seconds": elapsed,
                **snap_keys,
                **{k: int(v) for k, v in totals.items()
                   if k != "latency_count"},
                "workers": len(self._workers),
                "workers_lost": lost,
                "workers_finished": finished,
                "throughput_solves_per_s": (
                    totals["completed"] / elapsed if elapsed > 0 else 0.0),
                "rollup_windows": len(self._rollups),
            }
            tenants = self._totals_tenants()
            if tenants:
                out["tenants"] = {t: {k: int(v) for k, v in row.items()}
                                  for t, row in sorted(tenants.items())}
            return out

    def worker_gauges(self) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
        """Per-worker labeled gauge series for
        ``prometheus_text(labeled_gauges=)``: completed/failed
        counters, liveness (``worker_up``), and the last vitals sample
        — each labeled ``{worker="<id>"}``."""
        with self._lock:
            series: Dict[str, List[Tuple[Dict[str, str], float]]] = {
                "worker_up": [], "worker_completed": [],
                "worker_failed": [], "worker_rss_bytes": [],
                "worker_open_fds": [], "worker_threads": [],
                "worker_queue_depth": [],
            }
            for wid, st in sorted(self._workers.items()):
                lbl = {"worker": wid}
                series["worker_up"].append(
                    (lbl, 0.0 if st.lost else 1.0))
                if st.slo is not None:
                    series["worker_completed"].append(
                        (lbl, float(st.slo.get("completed", 0))))
                    series["worker_failed"].append(
                        (lbl, float(st.slo.get("failed", 0))))
                if st.lost or st.finished or st.refused:
                    # The process is gone (or was never merged): a
                    # frozen last-known vitals gauge would read as a
                    # live sample. worker_up already says why.
                    continue
                for key, name in (("rss_bytes", "worker_rss_bytes"),
                                  ("open_fds", "worker_open_fds"),
                                  ("threads", "worker_threads"),
                                  ("queue_depth", "worker_queue_depth")):
                    v = st.vitals.get(key)
                    if v is not None:
                        series[name].append((lbl, float(v)))
            # Fleet-wide per-tenant labeled series (merged across
            # workers): porqua_fleet_tenant_<counter>{tenant="..."}.
            for tenant, row in sorted(self._totals_tenants().items()):
                lbl = {"tenant": tenant}
                for k, v in row.items():
                    series.setdefault(f"tenant_{k}", []).append(
                        (lbl, float(v)))
            return {k: v for k, v in series.items() if v}

    def counters(self) -> Dict[str, int]:
        """Collector health counters (``/metrics`` extra_counters)."""
        with self._lock:
            return {"fleet_records_drained": self._records,
                    "fleet_events_forwarded": self._events_forwarded,
                    "fleet_parse_errors": self._parse_errors,
                    "fleet_unknown_kinds": self._unknown_kinds,
                    "fleet_workers_lost": self._lost_total,
                    "fleet_ladder_refusals": self._refusals}

    # -- reporting ----------------------------------------------------

    def worker_rows(self) -> List[Dict[str, Any]]:
        """Per-worker summary rows. A finished worker's row comes from
        its final report; a lost/running worker's from its last-seen
        cumulative sample (so the merged totals reconcile over exactly
        the numbers the rows show)."""
        with self._lock:
            rows = []
            for wid, st in sorted(self._workers.items()):
                status = ("refused" if st.refused
                          else "lost" if st.lost
                          else "ok" if st.finished else "running")
                row: Dict[str, Any] = {"worker": wid, "status": status,
                                       "stream_records": st.records,
                                       "events": st.events}
                if st.report is not None:
                    for k in ("completed", "failed", "errors",
                              "dropped_arrivals", "harvest_records",
                              "recompiles_after_warmup",
                              "throughput_solves_per_s",
                              "latency_p50_ms", "latency_p99_ms",
                              "status_counts"):
                        if k in st.report:
                            row[k] = st.report[k]
                elif st.slo is not None:
                    row["completed"] = int(st.slo.get("completed", 0))
                    row["failed"] = int(st.slo.get("failed", 0))
                if st.vitals:
                    row["vitals"] = {k: st.vitals[k] for k in
                                     ("rss_bytes", "open_fds", "threads",
                                      "queue_depth") if k in st.vitals}
                rows.append(row)
            return rows

    def report(self) -> Dict[str, Any]:
        """The merged fleet report + exact reconciliation: fleet
        ``completed`` is DEFINED as the sum over the per-worker rows,
        and the ``reconciliation`` section re-derives it from the
        independently-merged SLO sample and the workers' harvest
        counts — over the surviving (non-lost) workers the three
        numbers must agree exactly, crash or no crash."""
        rows = self.worker_rows()
        sample = self.slo_sample()
        lost_ids = [r["worker"] for r in rows if r["status"] == "lost"]
        # Refused workers (ladder mismatch) were never merged into the
        # SLO sample, so they stay out of the row sums too — both sides
        # of every reconciliation identity cover the same workers.
        merged = [r for r in rows if r["status"] != "refused"]
        completed_rows = sum(int(r.get("completed", 0)) for r in merged)
        surv = [r for r in merged if r["status"] != "lost"]
        surv_completed = sum(int(r.get("completed", 0)) for r in surv)
        surv_harvest = sum(int(r["harvest_records"]) for r in surv
                           if "harvest_records" in r)
        harvest_known = any("harvest_records" in r for r in surv)
        recon = {
            # The merged cumulative sample vs the per-row sum: every
            # worker's latest counters made it through the merge.
            "completed_sample_equals_rows": (
                int(sample["completed"]) == completed_rows),
            # Survivors' harvest datasets vs survivors' completions:
            # one SolveRecord per resolved request, no double-count.
            "harvest_equals_completed": (
                surv_harvest == surv_completed if harvest_known
                else None),
        }
        reconciled = all(v for v in recon.values() if v is not None)
        elapsed = self.clock() - self._start_mono
        # Fleet throughput: the sum of the workers' own measured-window
        # rates (each worker times exactly its soak window). Collector
        # lifetime is NOT the denominator — it starts before spawn +
        # prewarm + warmup, so completed/elapsed would deflate with
        # host compile speed and poison the trend-gated ledger series.
        # Mid-run (no reports yet) the lifetime rate is all there is.
        row_thr = [float(r["throughput_solves_per_s"]) for r in surv
                   if isinstance(r.get("throughput_solves_per_s"),
                                 (int, float))]
        out: Dict[str, Any] = {
            "workers": len(rows),
            "workers_lost": lost_ids,
            "rows": rows,
            "fleet": {
                "completed": completed_rows,
                "failed": sum(int(r.get("failed", 0)) for r in merged),
                "dropped_arrivals": sum(
                    int(r.get("dropped_arrivals", 0)) for r in merged),
                "harvest_records": surv_harvest if harvest_known else None,
                "recompiles_after_warmup": (
                    sum(int(r["recompiles_after_warmup"]) for r in surv
                        if "recompiles_after_warmup" in r)
                    if any("recompiles_after_warmup" in r for r in surv)
                    else None),
                "throughput_solves_per_s": (
                    sum(row_thr) if row_thr
                    else completed_rows / elapsed if elapsed > 0
                    else 0.0),
            },
            "reconciliation": recon,
            "reconciled": reconciled,
            "collector": self.counters(),
            "rollups_tail": self.rollups(last=8),
            "rollup_windows": len(self.rollups()),
        }
        snap_tenants = self.snapshot().get("tenants")
        if snap_tenants:
            # The fleet tenant axis: merged per-tenant counters (the
            # per-worker split stays in the rows' own reports).
            out["tenants"] = snap_tenants
        if self.slo is not None:
            out["slo"] = self.slo.status()
        if self.vitals_trend is not None:
            vt = self.vitals_trend.status()
            out["vitals_anomalies"] = vt["fired"]
            out["vitals_anomalous"] = vt["anomalous"]
        if self.flight is not None:
            fc = self.flight.counters()
            out["incident_bundles"] = fc["flight_bundles"]
            out["incident_bundle_paths"] = [
                p for p in self.flight.bundles() if isinstance(p, str)][:8]
        return out

    # -- exposition ---------------------------------------------------

    def start_http(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """The fleet ``/metrics`` + ``/healthz`` endpoint: merged
        snapshot + merged histograms + per-worker labeled gauges +
        fleet SLO gauges, served by the same stdlib
        :class:`~porqua_tpu_torch.obs.exposition.ObsHTTPServer` the single
        service uses. Returns the bound port."""
        from porqua_tpu_torch.obs.exposition import ObsHTTPServer, prometheus_text

        def metrics_fn() -> str:
            extra_gauges = None
            if self._slo_ready():
                self.slo.maybe_evaluate()
                extra_gauges = self.slo.gauges()
            extra_counters = dict(self.counters())
            extra_counters["events_dropped"] = self.events.dropped
            if self.flight is not None:
                extra_counters.update(self.flight.counters())
            if self.vitals_trend is not None:
                extra_counters.update(self.vitals_trend.counters())
            return prometheus_text(
                self.snapshot(), prefix="porqua_fleet",
                histograms=self.histograms(),
                extra_counters=extra_counters,
                extra_gauges=extra_gauges,
                labeled_gauges=self.worker_gauges())

        def health_fn() -> Dict[str, Any]:
            snap = self.snapshot()
            payload: Dict[str, Any] = {
                # A fleet with every worker lost is down; a fleet with
                # SOME workers lost is degraded-but-serving (same
                # posture as the breaker: slowdown, not outage).
                "ok": snap["workers_lost"] < max(snap["workers"], 1),
                "workers": snap["workers"],
                "workers_lost": snap["workers_lost"],
                "workers_finished": snap["workers_finished"],
                "completed": snap.get("completed", 0),
                **self.counters(),
            }
            if self._slo_ready():
                self.slo.maybe_evaluate()
            if self.slo is not None:
                payload["slo"] = self.slo.status()
            if self.vitals_trend is not None:
                payload["vitals"] = self.vitals_trend.status()
            return payload

        if self._http is None:
            self._http = ObsHTTPServer(metrics_fn=metrics_fn,
                                       health_fn=health_fn,
                                       host=host, port=port)
        return self._http.start()

    def stop_http(self) -> None:
        if self._http is not None:
            self._http.stop()
            self._http = None
