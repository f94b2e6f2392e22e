"""Serving observability: counters, latency percentiles, JSON-lines (a
host copy of ``porqua_tpu/serve/metrics.py``).

One :class:`ServeMetrics` instance is shared by the whole serve stack
(service / batcher / executable cache / device health) and is the
single source of truth the load generator reads. The snapshot schema is
the JAX package's (README, "Observability").

Thread-safety: every mutator takes the instance lock — submitters run
on caller threads, batch observations on the batcher thread, and
snapshot readers on whichever thread polls.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

from porqua_tpu_torch.analysis import tsan


#: Counter names, so consumers can rely on every key existing (a
#: counter that was never incremented reads 0, not KeyError).
COUNTERS = (
    "submitted",        # requests accepted into the queue
    "completed",        # futures resolved with a solution
    "failed",           # futures resolved with an error
    "expired",          # deadline passed before dispatch
    "rejected",         # backpressure: bounded queue full at submit
    "batches",          # device dispatches
    "batch_slots",      # total compiled batch slots dispatched
    "batch_occupied",   # slots carrying a real request
    "compiles",         # executable-cache misses (AOT compiles)
    "cache_hits",       # executable-cache hits
    "warm_hits",        # warm-start cache hits
    "dispatch_failures",  # device executions that raised
    "probe_failures",   # health probes that failed
    "device_switches",  # circuit-breaker transitions
    # Segment-level accounting (continuous batching / compaction):
    "segment_dispatches",    # segment-step device dispatches
    "lane_segments",         # slot-segments executed on live lanes
    "wasted_lane_segments",  # slot-segments on retired/empty slots
    "lanes_admitted",        # lanes admitted into a running cohort
    "lanes_retired_budget",  # lanes retired at their segment budget
    "cohort_replacements",   # cohorts drained for a larger replacement
    # Per-lane terminal Status surfaced at the API boundary:
    "status_solved",
    "status_max_iter",
    "status_primal_infeasible",
    "status_dual_infeasible",
    # Resilience plane (porqua_tpu.resilience):
    "retries",              # retry attempts scheduled after a failure
    "hedges_fired",         # duplicate (hedged) submissions issued
    "hedges_won",           # requests resolved by their hedge
    "resumed_requests",     # requests completed only via retry/hedge
    "retry_giveups",        # requests abandoned (attempts or deadline)
    "validation_failures",  # results withheld as non-finite
    "faults_injected",      # chaos: faults the injector fired
    # Solver routing (porqua_tpu.serve.routing):
    "routed_admm",          # live requests dispatched on the ADMM backend
    "routed_pdhg",          # live requests dispatched on the PDHG backend
    "routed_napg",          # live requests dispatched on the NAPG backend
    "shadow_solves",        # shadow-compare batches run on the alternate
)

#: Per-tenant counter names (the tenant axis of the snapshot /
#: exposition — README "Multi-tenant serving & workload library").
#: Deliberately a small subset of COUNTERS: the figures that attribute
#: load, outcome, and shed behavior to a tenant. Everything else
#: (batches, compiles, breaker state) is service-wide by construction
#: — tenants share executables and devices.
TENANT_COUNTERS = (
    "submitted",          # requests this tenant put into the queue
    "completed",          # resolved with a solution
    "failed",             # resolved with an error
    "expired",            # deadline passed before dispatch/admission
    "rejected",           # shed at the tenant's own quota OR the queue
    "retry_giveups",      # recovery layer abandoned the request
    "validation_failures",  # withheld non-finite answers
    "warm_hits",          # warm-start cache hits
    "routed_admm",        # this tenant's requests served by ADMM
    "routed_pdhg",        # this tenant's requests served by PDHG
    "routed_napg",        # this tenant's requests served by NAPG
)

#: Status code -> counter suffix (mirrors porqua_tpu_torch.qp.admm.Status —
#: kept literal here so the metrics layer stays import-light).
_STATUS_COUNTER = {
    1: "status_solved",
    2: "status_max_iter",
    3: "status_primal_infeasible",
    4: "status_dual_infeasible",
}

#: Prometheus histogram bucket upper bounds. Cumulative-histogram
#: series (``_bucket``/``_sum``/``_count``) let a scraper compute ANY
#: quantile over ANY scrape window server-side; the percentile gauges
#: in the snapshot stay (backward compatibility), but they describe
#: only this process's reservoir over its own window.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
ITERS_BUCKETS = (25, 50, 75, 100, 150, 250, 500, 1000, 2000, 4000)


class ServeMetrics:
    """Counters + reservoirs for the online solve service.

    ``latency_buckets`` sets the ``solve_latency_seconds`` histogram
    bucket upper bounds (strictly increasing, seconds; default
    :data:`LATENCY_BUCKETS_S`) — a deployment aligns them with its SLO
    latency targets so the burn-rate engine
    (:class:`porqua_tpu.obs.slo.SLOEngine`) reads good/bad counts off
    an exact bucket edge instead of a snapped one.
    """

    def __init__(self, latency_reservoir: int = 65536,
                 latency_buckets=LATENCY_BUCKETS_S,
                 max_tenants: int = 256,
                 tenant_reservoir: int = 8192) -> None:
        self._lock = tsan.lock("ServeMetrics")
        self._reservoir_cap = int(latency_reservoir)
        buckets = tuple(float(b) for b in latency_buckets)
        if not buckets or any(b2 <= b1 for b1, b2
                              in zip(buckets, buckets[1:])):
            raise ValueError("latency_buckets must be a non-empty, "
                             "strictly increasing sequence of seconds")
        self._latency_buckets = buckets
        # Tenant cardinality is caller-controlled input: bound it.
        # Tenant max_tenants+1 onward folds into one overflow bucket so
        # an id-spraying client cannot grow the metrics without limit.
        self._max_tenants = int(max_tenants)
        self._tenant_reservoir_cap = int(tenant_reservoir)
        self.reset_window()

    def reset_window(self) -> None:
        """Zero every counter and reservoir; the measurement window
        restarts now. The load generator calls this after prewarm so
        ``compiles`` counts only *re*compiles during measurement (the
        steady-state acceptance bar is 0). Device identity/degradation
        is service state, not window state — it survives the reset."""
        with self._lock:
            self.counters: Dict[str, int] = {k: 0 for k in COUNTERS}
            self._latencies: List[float] = []
            self._latency_observations = 0
            self._solve_seconds = 0.0
            self._queue_wait_seconds = 0.0
            self._compile_seconds = 0.0
            self._iters_sum = 0.0
            self._iters_n = 0
            self._queue_depth_sum = 0
            self._queue_depth_max = 0
            self._queue_depth_samples = 0
            # Real Prometheus histograms (solve latency, per-lane
            # iterations): per-bucket counts + sum + count, windowed
            # with everything else (scrapers treat window resets like
            # process restarts, same contract as the counters).
            self._hist = {
                "solve_latency_seconds": {
                    "le": self._latency_buckets,
                    "counts": [0] * (len(self._latency_buckets) + 1),
                    "sum": 0.0, "count": 0},
                "lane_iterations": {
                    "le": ITERS_BUCKETS,
                    "counts": [0] * (len(ITERS_BUCKETS) + 1),
                    "sum": 0.0, "count": 0},
            }
            # Per-tenant attribution (bounded — see __init__): each
            # tenant carries its TENANT_COUNTERS, a latency reservoir,
            # and a latency histogram on the same bucket ladder (the
            # per-tenant SLO engines read good/bad counts off its
            # edges exactly like the global engine does).
            self._tenants: Dict[str, Dict[str, Any]] = {}
            self._degraded = getattr(self, "_degraded", False)
            self._device_label: Optional[str] = getattr(
                self, "_device_label", None)
            self._window_start = time.monotonic()

    _TENANT_OVERFLOW = "(overflow)"

    def _tenant_state(self, tenant: str) -> Dict[str, Any]:  # guarded-by: self._lock
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= self._max_tenants:
                tenant = self._TENANT_OVERFLOW
                st = self._tenants.get(tenant)
            if st is None:
                st = self._tenants[tenant] = {
                    "counters": {k: 0 for k in TENANT_COUNTERS},
                    "lat": [],
                    "lat_obs": 0,
                    "hist": {"le": self._latency_buckets,
                             "counts": [0] * (len(self._latency_buckets)
                                              + 1),
                             "sum": 0.0, "count": 0},
                }
        return st

    # -- mutators ----------------------------------------------------

    def inc(self, name: str, k: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + k

    def inc_tenant(self, tenant: Optional[str], name: str,
                   k: int = 1) -> None:
        """Bump one per-tenant counter (``tenant=None`` is a no-op so
        call sites need no branching; untagged requests are accounted
        under :data:`porqua_tpu_torch.serve.tenancy.DEFAULT_TENANT` by their
        callers)."""
        if tenant is None:
            return
        with self._lock:
            st = self._tenant_state(str(tenant))
            st["counters"][name] = st["counters"].get(name, 0) + k

    def observe_tenant_latency(self, tenant: Optional[str],
                               seconds: float) -> None:
        """One request's end-to-end latency into its tenant's
        reservoir + histogram (the global ``observe_latency`` is
        called separately — tenant attribution never replaces the
        service-wide series)."""
        if tenant is None:
            return
        with self._lock:
            st = self._tenant_state(str(tenant))
            h = st["hist"]
            i = 0
            for i, le in enumerate(h["le"]):
                if seconds <= le:
                    break
            else:
                i = len(h["le"])
            h["counts"][i] += 1
            h["sum"] += float(seconds)
            h["count"] += 1
            if len(st["lat"]) < self._tenant_reservoir_cap:
                st["lat"].append(seconds)
            else:
                st["lat"][st["lat_obs"]
                          % self._tenant_reservoir_cap] = seconds
            st["lat_obs"] += 1

    def set_device(self, label: str, degraded: bool = False) -> None:
        with self._lock:
            self._device_label = label
            self._degraded = degraded

    def observe_compile(self, seconds: float) -> None:
        with self._lock:
            self.counters["compiles"] += 1
            self._compile_seconds += seconds

    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth_sum += depth
            self._queue_depth_max = max(self._queue_depth_max, depth)
            self._queue_depth_samples += 1

    def observe_batch(self, real: int, slots: int, solve_seconds: float,
                      iters_mean: float) -> None:
        with self._lock:
            self.counters["batches"] += 1
            self.counters["batch_slots"] += slots
            self.counters["batch_occupied"] += real
            self._solve_seconds += solve_seconds
            self._iters_sum += iters_mean * real
            self._iters_n += real

    def observe_segments(self, active: int, slots: int,
                         seconds: float = 0.0) -> None:
        """One segment-step dispatch over a cohort: ``active`` lanes
        did useful work, ``slots - active`` slots were stepped (or
        select-frozen) without a live request behind them. The ratio
        is the segment occupancy the snapshot reports. A segment step
        IS a device dispatch, so it also feeds the batch/occupancy/
        solve-seconds aggregates — in continuous mode every boundary
        is accounted, not just the ones where a lane retires."""
        with self._lock:
            self.counters["segment_dispatches"] += 1
            self.counters["lane_segments"] += int(active)
            self.counters["wasted_lane_segments"] += int(slots - active)
            self.counters["batches"] += 1
            self.counters["batch_slots"] += int(slots)
            self.counters["batch_occupied"] += int(active)
            self._solve_seconds += seconds

    def observe_iters(self, iters_mean: float, n: int) -> None:
        """Fold ``n`` requests' final device iteration counts into the
        ``iters_mean`` aggregate (continuous mode records them at
        retirement, separately from per-step dispatch accounting)."""
        with self._lock:
            self._iters_sum += iters_mean * n
            self._iters_n += n

    def observe_status(self, status: int) -> None:
        """Count one request's terminal solver Status (per-lane codes
        surfaced at the API boundary — a MAX_ITER lane is now
        distinguishable from a converged one in the aggregates)."""
        name = _STATUS_COUNTER.get(int(status))
        if name is not None:
            with self._lock:
                self.counters[name] += 1

    def _hist_observe(self, name: str, value: float) -> None:  # guarded-by: self._lock
        h = self._hist[name]
        i = 0
        for i, le in enumerate(h["le"]):
            if value <= le:
                break
        else:
            i = len(h["le"])  # the +Inf bucket
        h["counts"][i] += 1
        h["sum"] += float(value)
        h["count"] += 1

    def observe_request_iters(self, iters: int) -> None:
        """One request's final device iteration count into the
        per-lane-iterations histogram (per observation, unlike the
        ``observe_iters`` window-mean aggregate)."""
        with self._lock:
            self._hist_observe("lane_iterations", float(iters))

    def observe_queue_wait(self, seconds: float) -> None:
        """Accumulate one request's submit->dispatch wait (the batcher
        observes it at batch formation, so the figure covers queue time
        plus pending-list time — everything before device work)."""
        with self._lock:
            self._queue_wait_seconds += seconds

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._hist_observe("solve_latency_seconds", float(seconds))
            if len(self._latencies) < self._reservoir_cap:
                self._latencies.append(seconds)
            else:
                # Cheap reservoir: overwrite round-robin, indexed by the
                # reservoir's OWN observation counter — `completed` is
                # incremented on a different code path (and not at all
                # for some callers), which repeatedly clobbered the same
                # slot and biased the percentiles.
                i = self._latency_observations % self._reservoir_cap
                self._latencies[i] = seconds
            self._latency_observations += 1

    # -- readers -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able dict of everything (schema: profiling.py)."""
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
            c = dict(self.counters)
            elapsed = time.monotonic() - self._window_start
            slot_segments = (c["lane_segments"]
                             + c["wasted_lane_segments"])
            seg_occ = (c["lane_segments"] / slot_segments
                       if slot_segments else 0.0)
            out: Dict[str, Any] = {
                "t": time.time(),
                "window_seconds": elapsed,
                **c,
                "occupancy_mean": (c["batch_occupied"] / c["batch_slots"]
                                   if c["batch_slots"] else 0.0),
                # Serving-local definition: the share of stepped
                # slot-segments carrying a live request (and its exact
                # complement, exported under both names for scrape
                # ergonomics). Deliberately NOT named
                # wasted_iteration_fraction — that name belongs to
                # bench.py's distribution-derived figure
                # (1 - useful/dense segments), a different quantity.
                "segment_occupancy_mean": seg_occ,
                "wasted_lane_fraction": (1.0 - seg_occ
                                         if slot_segments else 0.0),
                "queue_depth_mean": (
                    self._queue_depth_sum / self._queue_depth_samples
                    if self._queue_depth_samples else 0.0),
                "queue_depth_max": self._queue_depth_max,
                "solve_seconds": self._solve_seconds,
                "queue_wait_seconds": self._queue_wait_seconds,
                "compile_seconds": self._compile_seconds,
                "iters_mean": (self._iters_sum / self._iters_n
                               if self._iters_n else 0.0),
                "throughput_solves_per_s": (c["completed"] / elapsed
                                            if elapsed > 0 else 0.0),
                "degraded": self._degraded,
                "device": self._device_label,
            }
            for name, pct in (("p50", 50), ("p90", 90), ("p99", 99)):
                out[f"latency_{name}_ms"] = (
                    float(np.percentile(lat, pct)) * 1e3 if lat.size else 0.0)
            out["latency_mean_ms"] = float(lat.mean()) * 1e3 if lat.size else 0.0
            if self._tenants:
                # The tenant axis: per-tenant counters + latency
                # percentiles (schema: README "Multi-tenant serving &
                # workload library"). Untagged requests are accounted
                # under the shared "default" lane, so the section
                # reconciles against `completed` even for callers that
                # never pass a tenant.
                tenants: Dict[str, Any] = {}
                for t, st in sorted(self._tenants.items()):
                    tl = np.asarray(st["lat"], dtype=np.float64)
                    row: Dict[str, Any] = dict(st["counters"])
                    for nm, pct in (("p50", 50), ("p99", 99)):
                        row[f"latency_{nm}_ms"] = (
                            float(np.percentile(tl, pct)) * 1e3
                            if tl.size else 0.0)
                    row["latency_mean_ms"] = (float(tl.mean()) * 1e3
                                              if tl.size else 0.0)
                    tenants[t] = row
                out["tenants"] = tenants
            return out

    def histograms(self) -> Dict[str, Dict[str, Any]]:
        """Cumulative histogram state for the Prometheus exposition:
        ``{name: {"le": bounds, "counts": per-bucket (non-cumulative,
        +Inf last), "sum": float, "count": int}}``. The renderer
        (:func:`porqua_tpu.obs.exposition.prometheus_text`) turns the
        per-bucket counts into the cumulative ``_bucket`` series."""
        with self._lock:
            return {name: {"le": tuple(h["le"]),
                           "counts": list(h["counts"]),
                           "sum": h["sum"], "count": h["count"]}
                    for name, h in self._hist.items()}

    def slo_sample(self) -> Dict[str, Any]:
        """The SLO engine's cumulative sample, in ONE lock crossing
        and with no percentile math: the availability / wrong-answer
        counters plus the raw latency-histogram state (the engine
        counts observations at or under its target's bucket edge).
        Values reset with the window, which the engine detects as a
        counter regression and restarts its sliding windows from."""
        with self._lock:
            h = self._hist["solve_latency_seconds"]
            return {
                "completed": self.counters["completed"],
                "failed": self.counters["failed"],
                "expired": self.counters["expired"],
                "retry_giveups": self.counters["retry_giveups"],
                "validation_failures": self.counters["validation_failures"],
                "latency_le": tuple(h["le"]),
                "latency_counts": tuple(h["counts"]),
                "latency_count": int(h["count"]),
            }

    def tenant_ids(self) -> List[str]:
        """Tenants with any attributed observation this window."""
        with self._lock:
            return sorted(self._tenants)

    def tenant_slo_sample(self, tenant: str) -> Dict[str, Any]:
        """One tenant's cumulative SLO sample, in the exact
        ``slo_sample`` shape so a per-tenant
        :class:`~porqua_tpu.obs.slo.SLOEngine` consumes it unchanged.

        One deliberate semantic difference from the service-wide
        sample: quota sheds (``rejected``) count toward the tenant's
        availability bad events — from the tenant's point of view a
        request shed at its own sub-queue IS unavailability (that is
        exactly the signal the noisy-neighbor alert must fire on),
        whereas service-wide backpressure is the caller's flow-control
        signal, not an outage."""
        with self._lock:
            st = self._tenants.get(str(tenant))
            if st is None:
                return {"completed": 0, "failed": 0, "expired": 0,
                        "retry_giveups": 0, "validation_failures": 0,
                        "latency_le": self._latency_buckets,
                        "latency_counts": tuple(
                            [0] * (len(self._latency_buckets) + 1)),
                        "latency_count": 0}
            c = st["counters"]
            h = st["hist"]
            return {
                "completed": c["completed"],
                "failed": c["failed"] + c["rejected"],
                "expired": c["expired"],
                "retry_giveups": c["retry_giveups"],
                "validation_failures": c["validation_failures"],
                "latency_le": tuple(h["le"]),
                "latency_counts": tuple(h["counts"]),
                "latency_count": int(h["count"]),
            }

    def tenant_view(self, tenant: str) -> "TenantMetricsView":
        """A per-tenant object implementing the ``slo_sample()``
        reader surface (the same adapter move the fleet collector
        makes) — ``SLOEngine.bind`` accepts it unchanged."""
        return TenantMetricsView(self, str(tenant))

    def tenant_labeled_gauges(self) -> Dict[str, list]:
        """Per-tenant labeled series for
        ``prometheus_text(labeled_gauges=)``:
        ``porqua_serve_tenant_<counter>{tenant="..."}`` plus the
        latency percentiles. Tenant ids are caller-supplied strings —
        the exposition layer escapes label values per the text-format
        spec (pinned by test with a hostile id)."""
        with self._lock:
            series: Dict[str, list] = {}
            for t, st in sorted(self._tenants.items()):
                lbl = {"tenant": t}
                for name, v in st["counters"].items():
                    series.setdefault(f"tenant_{name}", []).append(
                        (lbl, v))
                tl = np.asarray(st["lat"], dtype=np.float64)
                for nm, pct in (("p50", 50), ("p99", 99)):
                    series.setdefault(f"tenant_latency_{nm}_ms",
                                      []).append(
                        (lbl, float(np.percentile(tl, pct)) * 1e3
                         if tl.size else 0.0))
            return series

    def write_jsonl(self, path: str) -> Dict[str, Any]:
        """Append one snapshot line to ``path``; returns the snapshot."""
        snap = self.snapshot()
        with open(path, "a") as f:
            f.write(json.dumps(snap) + "\n")
        return snap

    def bridge_tracer(self, tracer) -> None:
        """Export the window's accumulated stage seconds into a
        :class:`porqua_tpu_torch.profiling.Tracer`, so serving runs
        render through the same ``Tracer.report()`` as one-shot runs.
        ``serve/queue_wait`` rides along: requests spend most of their
        lives waiting for a batch slot, not on the device."""
        from porqua_tpu_torch.profiling import StageTiming

        snap = self.snapshot()
        for stage, seconds in (
                ("serve/queue_wait", snap["queue_wait_seconds"]),
                ("serve/solve", snap["solve_seconds"]),
                ("serve/compile", snap["compile_seconds"])):
            tracer.timings.append(StageTiming(stage, seconds, {
                "batches": snap["batches"],
                "occupancy_mean": round(snap["occupancy_mean"], 4),
                "compiles": snap["compiles"],
            }))


class TenantMetricsView:
    """One tenant's read-only projection of a :class:`ServeMetrics`.

    Implements exactly the reader surface the per-tenant
    :class:`~porqua_tpu.obs.slo.SLOEngine` needs (``slo_sample()``),
    the same adapter pattern :class:`porqua_tpu.obs.federation.
    FleetCollector` uses to run fleet SLOs through the unmodified
    engine. Sheds (``rejected``) count as availability bad events —
    see :meth:`ServeMetrics.tenant_slo_sample`.
    """

    def __init__(self, metrics: ServeMetrics, tenant: str) -> None:
        self.metrics = metrics
        self.tenant = tenant

    def slo_sample(self) -> Dict[str, Any]:
        return self.metrics.tenant_slo_sample(self.tenant)
