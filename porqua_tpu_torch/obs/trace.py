"""Request span tracing with a Chrome-trace-event (Perfetto) exporter
(the port of ``porqua_tpu/obs/trace.py``, a host copy).

A *span* is one named interval of one request's life — ``submit``
(pad + enqueue), ``queue_wait``, ``assemble`` (batch formation),
``solve`` (device dispatch), ``resolve`` (future fan-out) — stamped
with the request's ``trace_id`` so a p99 outlier can be read as "this
request spent 48 ms waiting for its bucket's age trigger", not just
"p99 is 50 ms". The serve stack records spans through one shared
:class:`SpanRecorder`; nothing here touches JAX or the device — span
timestamps come from ``time.monotonic()`` on whatever host thread
observed the transition, which is exactly the layer the device
profiler (``torch.profiler``) cannot see.

The export format is the Chrome trace-event JSON (``"X"`` complete
events with microsecond ``ts``/``dur``), which Perfetto and
``chrome://tracing`` load directly — so a serving timeline renders in
the same UI, and on the same time axis style, as a ``torch.profiler``
device trace.
Span schema: README "Observability".
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional

from porqua_tpu_torch.analysis import tsan
# The span-cover readers live with the report; imported here for the
# callers that reach them through this module.
from porqua_tpu_torch.obs.report import coverage_stats, span_coverage  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed interval on the serving timeline.

    ``t_start``/``t_end`` are ``time.monotonic()`` seconds — the same
    clock the serve stack stamps ``SolveRequest.submitted`` with, so
    spans and request latencies subtract cleanly.
    """

    name: str
    t_start: float
    t_end: float
    trace_id: Optional[str] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


class SpanRecorder:
    """Thread-safe bounded span sink shared by the whole serve stack.

    Bounded on purpose: a long-lived serving process must not grow its
    trace buffer without limit — past ``capacity`` the recorder drops
    new spans and counts them (``dropped``), the same posture as the
    metrics latency reservoir. Trace ids are minted here
    (:meth:`new_trace`) so they are unique per recorder without any
    global state.
    """

    def __init__(self, capacity: int = 262144) -> None:
        self.capacity = int(capacity)
        self._lock = tsan.lock("SpanRecorder")
        self._spans: List[Span] = []      # guarded-by: self._lock
        self._dropped = 0                 # guarded-by: self._lock
        self._ids = itertools.count()
        # Anchor pair: monotonic spans export against a wall-clock
        # epoch so two artifacts from one run line up.
        self._anchor_mono = time.monotonic()
        self._anchor_wall = time.time()

    def new_trace(self) -> str:
        """Mint a per-request trace id (unique within this recorder)."""
        return f"{os.getpid():x}-{next(self._ids):08x}"

    # -- recording ---------------------------------------------------

    def record(self, name: str, t_start: float, t_end: float,
               trace_id: Optional[str] = None, **args) -> None:
        span = Span(name, float(t_start), float(t_end), trace_id,
                    dict(args))
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._dropped += 1
                return
            self._spans.append(span)

    def span(self, name: str, trace_id: Optional[str] = None, **args):
        """Context manager: time the block as one span."""
        return _SpanCtx(self, name, trace_id, args)

    # -- readers -----------------------------------------------------

    @property
    def anchor_mono(self) -> float:
        """The monotonic instant ``ts=0`` of this recorder's Chrome
        export maps to — other producers (the stage profiler's counter
        tracks) export against it so one trace file lines up."""
        return self._anchor_mono

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def by_trace(self) -> Dict[str, List[Span]]:
        """Spans grouped per trace id (anonymous spans excluded),
        chronological within each trace."""
        out: Dict[str, List[Span]] = {}
        for s in self.spans():
            if s.trace_id is not None:
                out.setdefault(s.trace_id, []).append(s)
        for spans in out.values():
            spans.sort(key=lambda s: s.t_start)
        return out

    # -- export ------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto-loadable).

        Each span becomes one ``"X"`` (complete) event; each trace id
        gets its own ``tid`` so Perfetto renders one lane per request.
        ``ts`` is microseconds since the recorder's anchor; the anchor's
        wall-clock epoch rides in ``metadata`` so device traces captured
        in the same run can be aligned by hand.
        """
        tids: Dict[Optional[str], int] = {None: 0}
        events: List[Dict[str, Any]] = []
        for s in self.spans():
            tid = tids.setdefault(s.trace_id, len(tids))
            args = dict(s.args)
            if s.trace_id is not None:
                args["trace_id"] = s.trace_id
            events.append({
                "name": s.name,
                "cat": "serve",
                "ph": "X",
                "ts": (s.t_start - self._anchor_mono) * 1e6,
                "dur": s.duration * 1e6,
                "pid": os.getpid(),
                "tid": tid,
                "args": args,
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "anchor_unix_time": self._anchor_wall,
                "dropped_spans": self.dropped,
            },
        }

    def write(self, path: str) -> Dict[str, Any]:
        """Write the Chrome trace JSON to ``path``; returns the object."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


class _SpanCtx:
    """Context manager returned by :meth:`SpanRecorder.span`."""

    def __init__(self, recorder: SpanRecorder, name: str,
                 trace_id: Optional[str], args: Dict[str, Any]) -> None:
        self._recorder = recorder
        self._name = name
        self._trace_id = trace_id
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._recorder.record(self._name, self._t0, time.monotonic(),
                              trace_id=self._trace_id, **self._args)
