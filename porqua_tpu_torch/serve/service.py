"""`SolveService`: the online front door, with device-health fallback
(the port of ``porqua_tpu/serve/service.py``).

``submit()`` accepts one :class:`CanonicalQP` at its natural shape and
returns a ticket; ``result()`` blocks on that ticket. Between the two,
the request is padded to its shape bucket (on the caller's thread),
queued with backpressure (a full queue raises :class:`QueueFull`),
coalesced by the micro-batcher (or the continuous batcher), and solved
by a compiled entry on whatever device the health manager trusts.

Device health is a circuit breaker: probes run with a hard thread
timeout, ``failure_threshold`` consecutive failures trip the breaker,
and a tripped service moves to its fallback device; after
``recovery_interval_s`` the primary is re-probed and traffic moves back
when it answers. Unlike the JAX package, whose fallback defaults to
XLA-CPU, the fallback here defaults to the primary: traffic moves to a
CPU only when the caller names that device, so a service never hides a
failing card behind a silent CPU fallback. The retry layer
(``retry=``) resubmits through the same breaker, so a retry, too, goes
back to the primary unless a fallback is named.

The production options are the JAX package's: ``router=`` (per-bucket
backend routing with shadow compares), ``calibrator=`` (the closed
calibration loop over the router's table), ``retry=``, ``obs=``
(spans and events), ``harvest=``, ``slo=``, ``flight=``,
``anomaly=``, ``tenant_slos=``, and the ``/metrics`` + ``/healthz``
endpoint (:meth:`SolveService.start_http`) with process
:meth:`SolveService.vitals`, and ``cost_log=``, the device-cost
warehouse (one CostRecord per built entry,
:mod:`porqua_tpu_torch.obs.devprof`): on by default in memory,
``False`` turns it off.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple, Optional

import torch

from porqua_tpu_torch.analysis import tsan
from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.qp.solve import SolverParams, resolve_device
from porqua_tpu_torch.resilience import faults as _faults
from porqua_tpu_torch.serve.batcher import (
    DeadlineExpired,
    MicroBatcher,
    SolveError,
    SolveRequest,
    SolveResult,
    WarmStartCache,
    device_label,
    problem_fingerprint,
)
from porqua_tpu_torch.serve.bucketing import BucketLadder, ExecutableCache
from porqua_tpu_torch.serve.metrics import ServeMetrics
from porqua_tpu_torch.serve.tenancy import DEFAULT_TENANT, TenantAdmission

__all__ = [
    "DeviceHealth", "QueueFull", "SolveService", "Ticket",
    "DeadlineExpired", "SolveError", "SolveResult",
]


class QueueFull(Exception):
    """Backpressure: the bounded submission queue is full."""


def _default_probe(device) -> bool:
    """Liveness = one tiny dispatch and a host read on ``device``."""
    x = torch.ones(8, dtype=torch.float32, device=device)
    return bool((x + 1.0)[0].item() == 2.0)


def _pinned(device) -> torch.device:
    """``device`` with its index: the card a bare ``"cuda"`` means."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def host_qp(qp: CanonicalQP) -> CanonicalQP:
    """A request's fields as host tensors (numpy arrays, scalars and
    tensors on any device are accepted)."""
    def host(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.cpu()
        return torch.as_tensor(a)
    return CanonicalQP(*(host(a) for a in qp))


class DeviceHealth:
    """Probe + circuit breaker over a (primary, fallback) device pair.

    ``primary`` defaults to the card (:func:`qp.solve.resolve_device`:
    with no card, construction raises); ``fallback`` defaults to the
    primary."""

    def __init__(self,
                 primary=None,
                 fallback=None,
                 probe_fn=None,
                 failure_threshold: int = 2,
                 probe_timeout_s: float = 30.0,
                 recovery_interval_s: float = 60.0,
                 metrics: Optional[ServeMetrics] = None,
                 events=None,
                 clock=None) -> None:
        self.primary = _pinned(resolve_device(primary))
        self.fallback = (self.primary if fallback is None
                         else _pinned(fallback))
        self.probe_fn = _default_probe if probe_fn is None else probe_fn
        self.failure_threshold = int(failure_threshold)
        self.probe_timeout_s = float(probe_timeout_s)
        self.recovery_interval_s = float(recovery_interval_s)
        self.metrics = metrics
        # Optional EventBus: breaker transitions and probe failures
        # become structured events.
        self.events = events
        # Injectable monotonic clock: every breaker timing decision
        # reads it, so chaos scenarios can replay recovery on a stepped
        # porqua_tpu_torch.resilience.FaultClock.
        self.clock = time.monotonic if clock is None else clock
        self._lock = tsan.lock("DeviceHealth")
        self._failures = 0            # guarded-by: self._lock
        self._degraded = False        # guarded-by: self._lock
        self._opened_at = 0.0         # guarded-by: self._lock
        self._recovery_inflight = False  # guarded-by: self._lock
        self._publish()

    # -- internals ---------------------------------------------------

    def _publish(self) -> None:
        if self.metrics is not None:
            dev = self.fallback if self._degraded else self.primary
            self.metrics.set_device(device_label(dev),
                                    degraded=self._degraded)

    def _probe_with_timeout(self, device) -> bool:
        """A hung device hangs probes rather than failing them: run the
        probe on a scrap daemon thread and treat a timeout as a failure
        (the thread is abandoned; it holds no locks)."""
        injected = None
        if _faults.enabled():
            # health.probe seam: a probe_fail directive reports the
            # device unhealthy without dispatching to it.
            injected = _faults.fire("health.probe",
                                    device=device_label(device))
        if injected is not None and injected.kind == "probe_fail":
            stall = float(injected.args.get("stall_s", 0.0))
            if stall:
                time.sleep(min(stall, self.probe_timeout_s))
            ok = False
        else:
            result = []

            def run():
                try:
                    result.append(bool(self.probe_fn(device)))
                except Exception:  # noqa: BLE001 - any fault = unhealthy
                    result.append(False)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            t.join(self.probe_timeout_s)
            ok = bool(result and result[0])
        if not ok:
            if self.metrics is not None:
                self.metrics.inc("probe_failures")
            if self.events is not None:
                self.events.emit("probe_failure", "warn",
                                 device=device_label(device),
                                 timeout_s=self.probe_timeout_s)
        return ok

    def _trip(self) -> None:  # guarded-by: self._lock
        self._degraded = True
        self._opened_at = self.clock()
        if self.metrics is not None:
            self.metrics.inc("device_switches")
        if self.events is not None:
            self.events.emit("breaker_open", "error",
                             primary=device_label(self.primary),
                             fallback=device_label(self.fallback),
                             failures=self._failures)
        self._publish()

    # -- API ---------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self._degraded

    def startup_check(self) -> None:
        """Probe the primary before accepting traffic; a dead primary
        trips the breaker at once. The probes run outside the lock."""
        if self.primary == self.fallback:
            return
        for _ in range(self.failure_threshold):
            if self._probe_with_timeout(self.primary):
                return
        with self._lock:
            self._trip()

    def device(self):
        """The device new dispatches should target. While degraded the
        fallback is returned at once; the half-open re-probe of the
        primary runs on a background thread."""
        with self._lock:
            if not self._degraded:
                return self.primary
            if (self.primary != self.fallback
                    and not self._recovery_inflight
                    and self.clock() - self._opened_at
                    >= self.recovery_interval_s):
                self._recovery_inflight = True
                threading.Thread(target=self._try_recover,
                                 name="porqua-serve-recovery",
                                 daemon=True).start()
            return self.fallback

    def _try_recover(self) -> None:
        ok = self._probe_with_timeout(self.primary)
        with self._lock:
            self._recovery_inflight = False
            if not self._degraded:
                return  # raced a concurrent close
            if ok:
                self._degraded = False
                self._failures = 0
                if self.metrics is not None:
                    self.metrics.inc("device_switches")
                if self.events is not None:
                    self.events.emit("breaker_close", "info",
                                     primary=device_label(self.primary))
                self._publish()
            else:
                self._opened_at = self.clock()

    def record_success(self) -> None:
        with self._lock:
            if not self._degraded:
                self._failures = 0

    def record_failure(self, exc: Exception) -> bool:
        """Count one dispatch failure; returns True when the caller
        should retry (the breaker tripped to a different device, or
        there is transient budget left on the primary)."""
        with self._lock:
            if self._degraded:
                return False
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._trip()
                return self.primary != self.fallback
            return True


class Ticket(NamedTuple):
    """Handle ``submit`` returns; redeem via ``SolveService.result``."""

    future: Future
    submitted: float


class SolveService:
    """Online QP solve service (see module docstring). ``device`` is
    the primary device (default: the card; with no card and no
    ``device`` construction raises); ``health_kwargs`` go to
    :class:`DeviceHealth` (``fallback=``, ``probe_fn=``, ...)."""

    def __init__(self,
                 params: SolverParams = SolverParams(),
                 ladder: Optional[BucketLadder] = None,
                 max_batch: int = 64,
                 max_wait_ms: float = 2.0,
                 queue_capacity: int = 4096,
                 warm_start: bool = True,
                 warm_capacity: int = 4096,
                 fingerprint_warm_keys: bool = False,
                 metrics: Optional[ServeMetrics] = None,
                 health: Optional[DeviceHealth] = None,
                 obs=None,
                 continuous: bool = False,
                 segment_budget: Optional[int] = None,
                 retry=None,
                 cache: Optional[ExecutableCache] = None,
                 cost_log=None,
                 harvest=None,
                 profiler=None,
                 slo=None,
                 flight=None,
                 anomaly=None,
                 tenant_quota=None,
                 tenant_weights=None,
                 tenant_slos=None,
                 router=None,
                 calibrator=None,
                 device=None,
                 **health_kwargs) -> None:
        self.params = params
        self.continuous = bool(continuous)
        self.fingerprint_warm_keys = bool(fingerprint_warm_keys)
        self.ladder = BucketLadder() if ladder is None else ladder
        self.metrics = ServeMetrics() if metrics is None else metrics
        # Optional HarvestSink: one SolveRecord per resolved request.
        self.harvest = harvest
        self.profiler = profiler
        # The live plane reports through the event bus: asking for any
        # of it without an Observability creates one, so alerts and
        # triggers always have somewhere to land.
        if obs is None and (slo is not None or flight is not None
                            or anomaly is not None
                            or calibrator is not None):
            from porqua_tpu_torch.obs import Observability

            obs = Observability()
        self.obs = obs
        events = None if obs is None else obs.events
        self.slo = slo
        self.flight = flight
        self.anomaly = anomaly
        # Tenancy: per-tenant admission quotas (a tenant over quota
        # sheds at its own bounded sub-queue), DRR dequeue weights and
        # the per-tenant SLO engine set.
        self.admission = TenantAdmission(quota=tenant_quota)
        self.tenant_slos = tenant_slos
        if tenant_slos is not None:
            tenant_slos.bind(self.metrics, events=events)
        if flight is not None:
            # The recorder observes what this service already produces
            # (metrics, event/span rings, recent SolveRecords, SLO and
            # anomaly status); its trigger feed is the event bus.
            flight.attach(metrics=self.metrics, obs=obs, params=params,
                          slo=slo, anomaly=anomaly)
            events.add_listener(flight.on_event)
        if slo is not None:
            slo.bind(self.metrics, events=events)
        if anomaly is not None and anomaly.events is None:
            anomaly.events = events
        if health is None:
            health = DeviceHealth(primary=device, metrics=self.metrics,
                                  events=events, **health_kwargs)
        else:
            if device is not None and _pinned(device) != health.primary:
                raise ValueError(
                    f"device={device!r} disagrees with the health "
                    f"manager's primary {health.primary}")
            if events is not None and health.events is None:
                # An externally built health manager reports through
                # this service's bus unless it has its own.
                health.events = events
        self.health = health
        # Optional SolverRouter: the service adopts the router's cache
        # for its own method as self.cache, and the batcher consults
        # the router per dispatch / cohort.
        self.router = router
        if router is not None:
            if cache is not None:
                raise ValueError(
                    "pass either router= or cache=, not both (the "
                    "router owns its per-backend caches)")
            if router.params_for(params.method) != params:
                raise ValueError(
                    "shared SolverRouter was built for different "
                    "SolverParams than this service's")
            if router.metrics is None:
                router.metrics = self.metrics
            if router.events is None:
                router.events = events
            for c in router.caches.values():
                if c.metrics is None:
                    c.metrics = self.metrics
                if c.events is None:
                    c.events = events
            cache = router.caches[params.method]
        if cache is None:
            cache = ExecutableCache(params, metrics=self.metrics,
                                    events=events, cost_log=cost_log)
        elif cache.params != params:
            # A shared cache must solve at this service's configuration.
            raise ValueError(
                "shared ExecutableCache was built for different "
                "SolverParams than this service's")
        self.cache = cache
        if flight is not None:
            flight.attach(cache=self.cache)
        # Optional Calibrator: the closed calibration loop over the
        # router's table. It needs a router, and late-binds this
        # service's planes.
        self.calibrator = calibrator
        if calibrator is not None:
            if router is None:
                raise ValueError(
                    "calibrator= requires router= (the calibration "
                    "loop re-seeds the router's route table)")
            calibrator.bind(router=router, harvest=harvest,
                            events=events, anomaly=anomaly, slo=slo)
        # Optional request-level recovery layer: retry with backoff and
        # jitter, idempotent resubmission by request id, deadline-aware
        # give-up, hedged duplicates, result validation. Its scheduler
        # keeps its own (real) clock; pass an explicit RetryManager for
        # full fake-time control.
        self._retry = None
        if retry is not None:
            from porqua_tpu_torch.resilience.retry import RetryManager

            self._retry = RetryManager(self, retry, self.metrics,
                                       events=events)
        batcher_kwargs = dict(
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            queue_capacity=queue_capacity,
            warm_cache=WarmStartCache(warm_capacity) if warm_start else None,
            obs=obs, harvest=harvest, profiler=profiler,
            slo=slo, flight=flight, anomaly=anomaly,
            admission=self.admission, tenant_weights=tenant_weights,
            tenant_slos=tenant_slos, router=router,
            calibrator=calibrator)
        if self.continuous:
            from porqua_tpu_torch.serve.continuous import ContinuousBatcher

            self.batcher = ContinuousBatcher(
                self.cache, self.health, self.metrics,
                params=params, segment_budget=segment_budget,
                **batcher_kwargs)
        else:
            self.batcher = MicroBatcher(
                self.cache, self.health, self.metrics, **batcher_kwargs)
        self._http = None
        self._started = False

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "SolveService":
        self.health.startup_check()
        self.batcher.start()
        if self._retry is not None:
            self._retry.start()
        self._started = True
        return self

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        if self._http is not None:
            self._http.stop()
            self._http = None
        if self._started:
            # Refuse new submits, flush the batcher, then stop the
            # retry layer last: the flush can still fail in-flight
            # attempts, which must land in a live retry layer; its
            # stop() then fails every still-unresolved future.
            self._started = False
            self.batcher.stop(timeout=timeout)
            if self._retry is not None:
                self._retry.stop()
        if self.harvest is not None:
            # Flush (not close): the sink is caller-owned.
            self.harvest.flush()

    def start_http(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Expose ``/metrics`` (Prometheus text) and ``/healthz``
        (JSON) on a stdlib HTTP daemon thread; returns the bound port
        (``port=0`` picks a free one). Stopped by ``stop()``."""
        from porqua_tpu_torch.obs.exposition import (ObsHTTPServer,
                                                     prometheus_text)

        if self._http is None:
            self._http = ObsHTTPServer(
                metrics_fn=lambda: prometheus_text(
                    self.snapshot(),
                    histograms=self.metrics.histograms(),
                    extra_counters=self._obs_counters(),
                    extra_gauges=self._extra_gauges(),
                    labeled_gauges=self._labeled_gauges()),
                health_fn=self._health_payload, host=host, port=port)
        return self._http.start()

    def _labeled_gauges(self) -> dict:
        """Label-carrying gauge series: the cache's per-bucket series,
        the per-tenant series and, with a TenantSLOSet, the per-tenant
        SLO series."""
        out = dict(self.cache.prometheus_gauges())
        out.update(self.metrics.tenant_labeled_gauges())
        if self.tenant_slos is not None:
            self.tenant_slos.maybe_evaluate()
            out.update(self.tenant_slos.labeled_gauges())
        return out

    def _extra_gauges(self) -> dict:
        """Scrape-time gauges: SLO burn rates and alert states (after
        a clock-gated evaluation), the calibration plane's, and the
        process vitals."""
        out: dict = {}
        if self.slo is not None:
            self.slo.maybe_evaluate()
            out.update(self.slo.gauges())
        if self.calibrator is not None:
            out.update(self.calibrator.gauges())
        for key, value in self.vitals().items():
            if key != "t":
                out[f"vitals_{key}"] = value
        return out

    def vitals(self) -> dict:
        """One :func:`porqua_tpu_torch.obs.vitals.process_vitals`
        sample for this serving process, queue depth included."""
        from porqua_tpu_torch.obs.vitals import process_vitals

        return process_vitals(queue_depth=self.batcher.queue.qsize())

    def _obs_counters(self) -> dict:
        """Observability-plane health counters outside the metrics
        snapshot: event-bus and span drops, harvest sink state, and the
        live plane's counters."""
        out: dict = {}
        if self.obs is not None:
            out["events_dropped"] = self.obs.events.dropped
            out["events_sink_failures"] = self.obs.events.sink_failures
            out["events_listener_failures"] = (
                self.obs.events.listener_failures)
            out["spans_dropped"] = self.obs.spans.dropped
        for plane in (self.harvest, self.cache.cost_log, self.slo,
                      self.tenant_slos, self.flight, self.anomaly,
                      self.calibrator):
            if plane is not None:
                out.update(plane.counters())
        return out

    def _health_payload(self) -> dict:
        """``/healthz``: degraded-but-serving is still ok; ok flips
        only when the service is not running. One metrics snapshot
        serves the whole payload."""
        snap = self.metrics.snapshot()
        payload = {
            "ok": self._started,
            "started": self._started,
            "degraded": self.health.degraded,
            "device": snap.get("device"),
            **self._obs_counters(),
            # Cache health: per-bucket compile seconds, hit/compile
            # counters, harvested peak device memory, and the cost
            # warehouse's record/failure counters.
            "cache": {
                "executables": len(self.cache),
                "buckets": self.cache.bucket_stats(),
                **(self.cache.cost_log.counters()
                   if self.cache.cost_log is not None else {}),
            },
            "vitals": self.vitals(),
        }
        if self.slo is not None:
            self.slo.maybe_evaluate()
            payload["slo"] = self.slo.status()
        if self.calibrator is not None:
            payload["calibration"] = self.calibrator.status()
        tenants = snap.get("tenants")
        if tenants:
            section: dict = {"tenants": tenants,
                             "queue_depths": self.admission.depths(),
                             "quota_sheds": self.admission.sheds()}
            if self.tenant_slos is not None:
                self.tenant_slos.maybe_evaluate()
                section["slo"] = self.tenant_slos.status()
            payload["tenancy"] = section
        return payload

    def __enter__(self) -> "SolveService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path ------------------------------------------------

    def prewarm(self, example: CanonicalQP, dtype=None) -> int:
        """Compile the full slot ladder for ``example``'s bucket before
        traffic, on the current device and on the fallback device (when
        it differs), so a breaker trip dispatches into compiled entries.
        With a router every backend's ladder compiles, so a later route
        flip builds nothing. Returns the number of entries compiled.
        Prewarm is the warmup boundary of the sanitizer: after it, a
        cache miss on that device is a steady-state recompile. A
        continuous service compiles only the continuous triple."""
        example = host_qp(example)
        bucket = self.ladder.select(example)
        dtype = example.q.dtype if dtype is None else dtype
        warm = (self.cache.prewarm if self.router is None
                else self.router.prewarm)
        current = self.health.device()
        n = warm(bucket, self.batcher.max_batch, dtype, current,
                 continuous=self.continuous,
                 include_solve=not self.continuous)
        if self.health.fallback != current:
            n += warm(bucket, self.batcher.max_batch, dtype,
                      self.health.fallback, continuous=self.continuous,
                      include_solve=not self.continuous)
        return n

    def submit(self,
               qp: CanonicalQP,
               deadline_s: Optional[float] = None,
               warm_key: Optional[str] = None,
               timeout: Optional[float] = None,
               request_id: Optional[str] = None,
               tenant: Optional[str] = None) -> Ticket:
        """Queue one problem. ``deadline_s`` is a relative deadline: a
        request still undispatched that much later completes with
        :class:`DeadlineExpired`. ``timeout`` bounds the backpressure
        wait for queue space (``None`` blocks; expiry raises
        :class:`QueueFull`). With ``fingerprint_warm_keys=True`` a
        request without a ``warm_key`` is keyed by its feasible-set
        fingerprint. With a retry policy the request routes through the
        :class:`~porqua_tpu_torch.resilience.retry.RetryManager`, and
        ``request_id`` keys idempotent resubmission; without one
        ``request_id`` raises. ``tenant`` tags the request for
        quota/fair-share scheduling (``None`` = the shared
        ``DEFAULT_TENANT`` lane)."""
        if not self._started:
            raise RuntimeError("service not started (use `with service:`)")
        if self._retry is not None:
            return self._retry.submit(qp, deadline_s=deadline_s,
                                      warm_key=warm_key, timeout=timeout,
                                      request_id=request_id,
                                      tenant=tenant)
        if request_id is not None:
            raise ValueError(
                "request_id requires a retry policy "
                "(SolveService(retry=RetryPolicy(...))): idempotent "
                "resubmission is tracked by the RetryManager registry")
        return self._submit_raw(qp, deadline_s=deadline_s,
                                warm_key=warm_key, timeout=timeout,
                                tenant=tenant)

    def _shed(self, tenant: str, reason: str, detail: str,
              trace_id=None, bucket=None) -> None:
        """Count and report one shed request, then raise QueueFull."""
        self.metrics.inc("rejected")
        self.metrics.inc_tenant(tenant, "rejected")
        if self.obs is not None:
            self.obs.events.emit(
                "backpressure_reject", "warn", trace_id=trace_id,
                tenant=tenant, reason=reason,
                **({} if bucket is None else {"bucket": bucket}))
        raise QueueFull(detail) from None

    def _submit_raw(self,
                    qp: CanonicalQP,
                    deadline_s: Optional[float] = None,
                    warm_key: Optional[str] = None,
                    timeout: Optional[float] = None,
                    tenant: Optional[str] = None) -> Ticket:
        """The raw admission path (one queue entry per call; the retry
        layer fans its attempts into this). Per-tenant quota is
        enforced here, before the shared queue."""
        if not self._started:
            raise RuntimeError("service not started (use `with service:`)")
        tenant = str(tenant) if tenant is not None else DEFAULT_TENANT
        if not self.admission.try_admit(tenant):
            self._shed(
                tenant, "tenant_quota",
                f"tenant {tenant!r} at its admission quota "
                f"({self.admission.quota_for(tenant)} queued); shed "
                f"load or raise its tenant_quota")
        t0 = time.monotonic()
        if _faults.enabled():
            # serve.admission seam: queue_stall sleeps the submitter;
            # clock_skew shortens this request's deadline budget.
            act = _faults.fire("serve.admission", n=qp.n, m=qp.m)
            if act is not None:
                if act.kind == "queue_stall":
                    time.sleep(float(act.args.get("stall_s", 0.01)))
                elif act.kind == "clock_skew" and deadline_s is not None:
                    deadline_s = max(
                        deadline_s - float(act.args.get("skew_s", 0.0)),
                        0.0)
        trace_id = (None if self.obs is None
                    else self.obs.spans.new_trace())
        qp = host_qp(qp)
        warm_src = None if warm_key is None else "explicit"
        if warm_key is None and self.fingerprint_warm_keys:
            warm_key = problem_fingerprint(qp)
            warm_src = "fingerprint"
        bucket, padded = self.ladder.pad(qp)
        now = time.monotonic()
        req = SolveRequest(
            qp=padded, bucket=bucket, n_orig=qp.n, m_orig=qp.m,
            future=Future(), submitted=now,
            deadline=None if deadline_s is None else now + deadline_s,
            warm_key=warm_key, warm_src=warm_src, trace_id=trace_id,
            tenant=tenant)
        try:
            if timeout is None:
                self.batcher.queue.put(req)
            else:
                self.batcher.queue.put(req, timeout=timeout)
        except _queue.Full:
            # The admitted slot never reaches a pending queue, so the
            # dequeue-side release can never fire for it.
            self.admission.release(tenant)
            self._shed(
                tenant, "queue_capacity",
                f"submission queue at capacity "
                f"({self.batcher.queue.maxsize}); shed load or raise "
                f"queue_capacity",
                trace_id=trace_id, bucket=f"{bucket.n}x{bucket.m}")
        self.metrics.inc("submitted")
        self.metrics.inc_tenant(tenant, "submitted")
        if self.obs is not None:
            # The submit span covers fingerprint + pad + enqueue; its
            # end abuts `submitted`, so a request's spans tile its wall
            # clock.
            self.obs.spans.record("submit", t0, now, trace_id=trace_id,
                                  bucket=f"{bucket.n}x{bucket.m}",
                                  n=qp.n, m=qp.m)
        return Ticket(future=req.future, submitted=now)

    def result(self, ticket: Ticket,
               timeout: Optional[float] = None) -> SolveResult:
        """Block for one ticket's solution; raises the request's
        terminal error (:class:`DeadlineExpired`, :class:`SolveError`)
        or ``concurrent.futures.TimeoutError`` on ``timeout``."""
        return ticket.future.result(timeout=timeout)

    def solve(self, qp: CanonicalQP, timeout: Optional[float] = None,
              **submit_kwargs) -> SolveResult:
        """Convenience: submit + result."""
        return self.result(self.submit(qp, **submit_kwargs),
                           timeout=timeout)

    def snapshot(self) -> dict:
        return self.metrics.snapshot()
