"""Process vitals: RSS / fd / thread / queue-depth gauges + leak trends.

A sustained soak dies of different causes than a benchmark window: a
slow RSS leak, an fd leak from a reopened sink, a thread leak from
un-joined timers, a queue that grows a little every window. None of
those are visible in the solve counters — they are *process* health,
so this module samples them from ``/proc/self`` (portable fallbacks
where procfs is absent) and detects trends with a two-rate EWMA pair.

* :func:`process_vitals` — one cheap sample (two procfs reads): RSS
  bytes, open fd count, live thread count, and the caller-supplied
  queue depth. Exported as gauges on the single-service ``/metrics``
  + ``/healthz`` (``SolveService``) and per worker, labeled, on the
  fleet endpoint (:mod:`porqua_tpu_torch.obs.federation`).
* :class:`VitalsTrend` — EWMA leak/trend detection: per
  (worker, metric) a fast and a slow EWMA; when the fast average runs
  ``grow_margin`` above the slow one for ``min_samples`` samples the
  metric is *trending up faster than its own history* — the leak
  signature — and ONE ``vitals_anomaly`` event (``state="firing"``)
  is emitted, resolving with hysteresis. ``vitals_anomaly`` is a
  flight-recorder trigger (same firing-edge-only contract as
  ``convergence_anomaly``), so a leaking soak produces an incident
  bundle while the evidence still exists.

Pure host code, nothing on any hot path beyond lock-bounded
arithmetic (the port of ``porqua_tpu/obs/vitals.py``; the fleet
endpoint, ``obs/federation.py``, is not ported yet).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from porqua_tpu_torch.analysis import tsan

__all__ = ["TREND_METRICS", "VITAL_METRICS", "VitalsTrend",
           "process_vitals"]

#: The metric keys every vitals sample carries (``queue_depth`` only
#: when the caller supplied one).
VITAL_METRICS = ("rss_bytes", "open_fds", "threads", "queue_depth")

#: The metrics the trend detector judges by default: the LEAK-shaped
#: ones, which grow monotonically when something is wrong and sit flat
#: otherwise. ``queue_depth`` is deliberately excluded — it is bursty
#: by design (open-loop arrivals between batch drains), so a
#: fast-vs-slow EWMA ratio reads every load burst as a "leak"
#: (observed: a clean 4-worker soak fired 15 false queue-depth
#: anomalies). Queue *growth* is still covered: the latency SLO burns,
#: the rollup ring keeps per-window ``queue_depth_max``, and the gauge
#: is exported per worker; opt a queue back into trending via
#: ``VitalsTrend(metrics=...)`` if a deployment's arrivals are smooth.
TREND_METRICS = ("rss_bytes", "open_fds", "threads")

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> Optional[int]:
    """Resident set size via ``/proc/self/statm`` (second field, in
    pages); falls back to ``resource.getrusage`` off Linux."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux, bytes on macOS; either way it is
        # a high-water mark, not current RSS — good enough as a
        # fallback signal, and the trend detector only compares a
        # metric against its own history.
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:  # noqa: BLE001 - vitals must never fail a caller
        return None


def _open_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def process_vitals(queue_depth: Optional[int] = None) -> Dict[str, Any]:
    """One vitals sample for THIS process. Cheap (two procfs reads)
    and never raises: a metric that cannot be read is simply absent.
    ``queue_depth`` is caller-supplied (the process knows its own
    queues; procfs does not)."""
    out: Dict[str, Any] = {"t": time.time()}
    rss = _rss_bytes()
    if rss is not None:
        out["rss_bytes"] = rss
    fds = _open_fds()
    if fds is not None:
        out["open_fds"] = fds
    out["threads"] = threading.active_count()
    if queue_depth is not None:
        out["queue_depth"] = int(queue_depth)
    return out


class _TrendState:
    """Per-(worker, metric) EWMA pair (guarded by the trend lock)."""

    __slots__ = ("n", "fast", "slow", "anomalous")

    def __init__(self) -> None:
        self.n = 0
        self.fast = 0.0
        self.slow = 0.0
        self.anomalous = False


class VitalsTrend:
    """Two-rate EWMA leak/trend detector over vitals samples.

    ``observe(worker, vitals)`` folds one sample per metric into a
    fast (``alpha_fast``) and a slow (``alpha_slow``) EWMA. A steady
    process keeps the two averages together; a leak keeps the fast one
    persistently above the slow one. When ``fast > slow * (1 +
    grow_margin)`` after ``min_samples`` samples, ONE ``vitals_anomaly``
    event fires (``state="firing"``, a flight-recorder trigger);
    it resolves with hysteresis once the ratio falls back under
    ``1 + grow_margin * clear_fraction``. Metrics are judged
    independently per worker, so one leaking shard names itself.

    Thread-safety: ``observe`` runs on the collector's drain loop (or
    a single service's scrape thread), ``status``/``counters`` on
    whichever thread polls; state is guarded by the instance lock and
    events are emitted OUTSIDE it (the flight recorder's dump path
    reads ``status()`` from an event listener).
    """

    def __init__(self,
                 alpha_fast: float = 0.3,
                 alpha_slow: float = 0.03,
                 grow_margin: float = 0.25,
                 clear_fraction: float = 0.5,
                 min_samples: int = 20,
                 metrics: Tuple[str, ...] = TREND_METRICS,
                 events=None) -> None:
        if not 0.0 < alpha_slow < alpha_fast <= 1.0:
            raise ValueError("need 0 < alpha_slow < alpha_fast <= 1 "
                             "(the fast EWMA must actually be faster)")
        if grow_margin <= 0.0:
            raise ValueError("grow_margin must be positive")
        self.alpha_fast = float(alpha_fast)
        self.alpha_slow = float(alpha_slow)
        self.grow_margin = float(grow_margin)
        self.clear_fraction = float(clear_fraction)
        self.min_samples = int(min_samples)
        self.metrics = tuple(metrics)
        self.events = events
        self._lock = tsan.lock("VitalsTrend")
        # guarded-by: self._lock
        self._states: Dict[Tuple[str, str], _TrendState] = {}
        self._fired = 0            # guarded-by: self._lock
        self._resolved = 0         # guarded-by: self._lock
        self._observed = 0         # guarded-by: self._lock

    def observe(self, worker: str,
                vitals: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Fold one vitals sample; returns the transition events
        emitted (usually empty)."""
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            self._observed += 1
            for metric in self.metrics:
                value = vitals.get(metric)
                if value is None:
                    continue
                value = float(value)
                st = self._states.setdefault((str(worker), metric),
                                             _TrendState())
                if st.n == 0:
                    st.fast = st.slow = value
                else:
                    st.fast += self.alpha_fast * (value - st.fast)
                    st.slow += self.alpha_slow * (value - st.slow)
                st.n += 1
                denom = abs(st.slow) or 1.0
                ratio = st.fast / denom
                breach = (st.n >= self.min_samples
                          and ratio > 1.0 + self.grow_margin)
                clear = ratio <= 1.0 + self.grow_margin * self.clear_fraction
                if breach and not st.anomalous:
                    st.anomalous = True
                    self._fired += 1
                    transitions.append(self._event(
                        "firing", "warn", worker, metric, st, ratio))
                elif st.anomalous and clear:
                    st.anomalous = False
                    self._resolved += 1
                    transitions.append(self._event(
                        "resolved", "info", worker, metric, st, ratio))
        for ev in transitions:
            if self.events is not None:
                self.events.emit(**ev)
        return transitions

    @staticmethod
    def _event(state: str, severity: str, worker: str, metric: str,  # guarded-by: self._lock
               st: _TrendState, ratio: float) -> Dict[str, Any]:
        return dict(
            kind="vitals_anomaly", severity=severity, state=state,
            worker=str(worker), metric=metric,
            ewma_fast=round(st.fast, 2), ewma_slow=round(st.slow, 2),
            ratio=round(ratio, 4), n=st.n)

    # -- readers ------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """Per-(worker, metric) EWMA state + the anomalous set."""
        with self._lock:
            groups: Dict[str, Any] = {}
            anomalous: List[str] = []
            for (worker, metric), st in sorted(self._states.items()):
                label = f"{worker}/{metric}"
                denom = abs(st.slow) or 1.0
                groups[label] = {
                    "n": st.n,
                    "ewma_fast": round(st.fast, 2),
                    "ewma_slow": round(st.slow, 2),
                    "ratio": round(st.fast / denom, 4),
                    "anomalous": st.anomalous,
                }
                if st.anomalous:
                    anomalous.append(label)
            return {"groups": groups, "anomalous": anomalous,
                    "fired": self._fired, "resolved": self._resolved,
                    "observed": self._observed}

    def counters(self) -> Dict[str, int]:
        """Exposition counters (``/metrics`` extra_counters path)."""
        with self._lock:
            return {"vitals_anomalies_fired": self._fired,
                    "vitals_samples": self._observed}
