"""Dynamic micro-batching: many small requests -> few large dispatches
(the port of ``porqua_tpu/serve/batcher.py``).

The card solves a B-batch of shape-uniform QPs in barely more time than
one, so online throughput is won by coalescing whatever is queued into
the largest batch the latency budget allows. Policy: a bucket
dispatches when it holds ``max_batch`` requests (size trigger) or when
its oldest request has waited ``max_wait`` (age trigger), whichever
comes first; the batch is padded up the power-of-two slot ladder
(:func:`bucketing.slot_count`) by cycling the real problems, so every
dispatch hits a compiled entry and padding slots never perturb the
solver (their results are dropped).

Warm starts: a request may carry a ``warm_key`` (e.g. a portfolio id);
the previous solution under that key seeds ``(x0, y0)`` for the next
solve. Cold slots pass zeros, which is the solver's own cold start, so
one entry serves both.

The hooks are the JAX package's: ``obs`` (spans and events),
``harvest`` (one SolveRecord per resolved request), the live plane
(``slo``, ``flight``, ``anomaly``, ``tenant_slos``), solver routing
(``router``) and its calibration loop (``calibrator``). They are host
work around the dispatch: with every hook on, a batch launches the
same kernels, the same number of times, with the same bits, as the
bare service; shadow re-solves on the losing backends, after the
primary answers resolved, are the only extra device work.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from porqua_tpu_torch.analysis import sanitize, tsan
from porqua_tpu_torch.obs import profile as _profile
from porqua_tpu_torch.obs.harvest import solve_record
from porqua_tpu_torch.obs.rings import ring_history
from porqua_tpu_torch.qp.admm import Status
from porqua_tpu_torch.qp.canonical import CanonicalQP, stack_qps
from porqua_tpu_torch.resilience import faults as _faults
from porqua_tpu_torch.serve.bucketing import Bucket, ExecutableCache, slot_count
from porqua_tpu_torch.serve.tenancy import DEFAULT_TENANT, FairPendingQueue

def device_label(device) -> str:
    """``"type:index"`` of a device (``"cuda:0"``, ``"cpu:0"``), the
    label results and metrics carry."""
    if device is None:
        return "default"
    device = torch.device(device)
    return f"{device.type}:{0 if device.index is None else device.index}"


def device_kind(label: str) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a
    ``"cuda:N"`` label, ``""`` for any other device: the key of the
    peaks a profile's MFU fields are read against."""
    if not label.startswith("cuda"):
        return ""
    return torch.cuda.get_device_name(torch.device(label))


def problem_fingerprint(qp: CanonicalQP) -> str:
    """Stable fingerprint of a problem's feasible set (C, l, u, lb, ub
    and shapes): the identity of a portfolio across rebalances (its
    objective changes every date, its polytope rarely). Used when the
    service runs with ``fingerprint_warm_keys=True`` and a request has
    no explicit ``warm_key``."""
    h = hashlib.blake2b(digest_size=12)
    for a in (qp.C, qp.l, qp.u, qp.lb, qp.ub):
        arr = np.ascontiguousarray(
            a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _corrupt_lanes(xs: np.ndarray, n_live: int, seam: str,
                   bucket_label: str) -> np.ndarray:
    """serve.result seam body: a ``nan_lanes`` directive poisons up to
    ``lanes`` live result rows with NaN on the host copy (the device
    program is untouched)."""
    act = None
    if _faults.enabled():
        act = _faults.fire(seam, live=n_live, bucket=bucket_label)
    if act is None or act.kind != "nan_lanes" or n_live == 0:
        return xs
    k = min(int(act.args.get("lanes", 1)), n_live)
    rows = act.rng.choice(n_live, size=k, replace=False)
    xs = np.array(xs, copy=True)
    xs[rows] = np.nan
    return xs


#: The ``QPSolution`` fields the batchers read (the rings only when the
#: solve carried them).
_HOST_FIELDS = ("x", "y", "status", "iters", "prim_res", "dual_res",
                "obj_val", "ring_prim", "ring_dual", "ring_rho")


def host_solution(sol, lanes=None) -> dict:
    """The fields the batchers read of a batched ``QPSolution`` (only
    the rows ``lanes``, a list, when given), as host numpy arrays: one
    device-to-host copy each; a ring field is ``None`` when the solve
    ran without rings."""
    if lanes is not None:
        lanes = torch.as_tensor(lanes, device=sol.x.device)
    out = {}
    for k in _HOST_FIELDS:
        a = getattr(sol, k, None)
        out[k] = (None if a is None
                  else (a if lanes is None else a[lanes]).cpu().numpy())
    return out


class DeadlineExpired(Exception):
    """The request's deadline passed before its batch dispatched."""


class SolveError(Exception):
    """The dispatch failed on every available device."""


@dataclasses.dataclass
class SolveRequest:
    """One queued problem (already padded to its bucket, host tensors)."""

    qp: CanonicalQP
    bucket: Bucket
    n_orig: int                      # natural sizes, for trimming results
    m_orig: int
    future: Future
    submitted: float                 # monotonic seconds
    deadline: Optional[float] = None  # monotonic seconds, None = none
    warm_key: Optional[str] = None
    # Where the warm key came from ("explicit" | "fingerprint") — the
    # warm-start provenance harvest records carry; None = no key.
    warm_src: Optional[str] = None
    trace_id: Optional[str] = None   # obs span correlation id
    # Tenant id for quota/fair-share scheduling + attribution (None =
    # untagged, accounted under tenancy.DEFAULT_TENANT).
    tenant: Optional[str] = None


@dataclasses.dataclass
class SolveResult:
    """What ``SolveService.result`` hands back (host numpy, trimmed to
    the request's natural variable count)."""

    x: np.ndarray
    status: int
    iters: int
    prim_res: float
    dual_res: float
    obj_val: float
    latency_s: float
    warm_started: bool
    device: str
    trace_id: Optional[str] = None
    # Convergence rings (service params with ring_size > 0 only): this
    # request's raw ring slots; decode chronologically with
    # porqua_tpu_torch.obs.rings.ring_history(..., iters, check_interval).
    ring_prim: Optional[np.ndarray] = None
    ring_dual: Optional[np.ndarray] = None
    ring_rho: Optional[np.ndarray] = None

    @property
    def found(self) -> bool:
        return self.status == Status.SOLVED


class WarmStartCache:
    """LRU ``(warm_key, bucket) -> (x, y)`` in the bucket's padded
    frame. Bounded: a serving process must not grow with the number of
    distinct portfolios it has ever seen."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = int(capacity)
        self._lock = tsan.lock("WarmStartCache")
        # guarded-by: self._lock
        self._data: "collections.OrderedDict[tuple, Tuple[np.ndarray, np.ndarray]]" = (
            collections.OrderedDict())

    def get(self, key) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._data.move_to_end(key)
            return hit

    def put(self, key, x: np.ndarray, y: np.ndarray) -> None:
        with self._lock:
            # Copy at the boundary: callers pass rows viewing the whole
            # batch solution array.
            self._data[key] = (np.array(x, copy=True),
                               np.array(y, copy=True))
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)


class MicroBatcher:
    """The single dispatch thread: drains the submission queue into
    per-bucket pending lists, forms batches per the size/age policy,
    executes them on the health manager's current device, and resolves
    per-request futures."""

    def __init__(self,
                 cache: ExecutableCache,
                 health,
                 metrics,
                 max_batch: int = 64,
                 max_wait_ms: float = 2.0,
                 queue_capacity: int = 4096,
                 warm_cache: Optional[WarmStartCache] = None,
                 obs=None,
                 harvest=None,
                 profiler=None,
                 slo=None,
                 flight=None,
                 anomaly=None,
                 admission=None,
                 tenant_weights=None,
                 tenant_slos=None,
                 router=None,
                 calibrator=None) -> None:
        self.cache = cache
        # Optional SolverRouter: per-(bucket, eps) backend choice at
        # dispatch time, resolved on the host to one of the router's
        # per-method caches. None = every dispatch runs self.cache.
        self.router = router
        self.health = health
        self.metrics = metrics
        # Tenancy: the shared admission accountant (quota depths drop
        # when requests leave the pending window), the per-tenant DRR
        # weights the per-bucket FairPendingQueues dequeue under, and
        # the per-tenant SLO engine set evaluated in _plane_tick.
        self.admission = admission
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_slos = tenant_slos
        self.obs = obs  # optional porqua_tpu_torch.obs.Observability
        # Optional HarvestSink: one SolveRecord per resolved request.
        self.harvest = harvest
        # Optional StageProfiler: dispatch stages bracketed with
        # torch.profiler ranges + counters.
        self.profiler = profiler
        # The live plane (all optional, all host work): SLOEngine
        # evaluated at retirement boundaries, FlightRecorder fed recent
        # SolveRecords + metric snapshots, AnomalyDetector folding
        # per-lane iteration outcomes into its per-(bucket, eps) EWMAs,
        # and the Calibrator (fed every record, ticked on the same
        # clock gate).
        self.slo = slo
        self.flight = flight
        self.anomaly = anomaly
        self.calibrator = calibrator
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) * 1e-3
        self.queue: "queue.Queue[Optional[SolveRequest]]" = queue.Queue(
            maxsize=queue_capacity)
        self.warm_cache = warm_cache
        # Per-bucket pending requests: per-tenant FIFOs dequeued by
        # deficit round robin.
        self._pending: Dict[Bucket, FairPendingQueue] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    # -- lifecycle ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._run, name="porqua-serve-batcher", daemon=True)
        self._thread.start()

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        """Flush everything still queued/pending, then join."""
        if self._thread is None:
            return
        self._stopping.set()
        try:  # wake a blocked queue.get
            self.queue.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout)
        self._thread = None

    # -- dispatch loop ----------------------------------------------

    def _route(self, req: Optional[SolveRequest]) -> None:
        if req is None:
            return
        dq = self._pending.get(req.bucket)
        if dq is None:
            dq = self._pending[req.bucket] = FairPendingQueue(
                self.admission, weights=self.tenant_weights)
        dq.append(req)

    def _next_wakeup(self, now: float) -> float:
        """Seconds until the oldest pending request hits the age
        trigger (or a coarse idle tick)."""
        horizon = 0.05
        for dq in self._pending.values():
            if dq:
                horizon = min(
                    horizon, dq[0].submitted + self.max_wait_s - now)
        return max(horizon, 1e-4)

    def _run(self) -> None:
        while True:
            draining = self._stopping.is_set()
            try:
                req = self.queue.get(
                    timeout=self._next_wakeup(time.monotonic())
                    if not draining else 1e-3)
                self._route(req)
                while True:  # drain whatever arrived together
                    try:
                        self._route(self.queue.get_nowait())
                    except queue.Empty:
                        break
            except queue.Empty:
                pass

            now = time.monotonic()
            for bucket in list(self._pending):
                dq = self._pending[bucket]
                while len(dq) >= self.max_batch:
                    self._dispatch_safe(
                        bucket,
                        [dq.popleft() for _ in range(self.max_batch)])
                if dq and (draining
                           or now - dq[0].submitted >= self.max_wait_s):
                    self._dispatch_safe(
                        bucket, [dq.popleft() for _ in range(len(dq))])
                if not dq:
                    del self._pending[bucket]

            if draining and self.queue.empty() and not self._pending:
                return

    def _fail(self, reqs, exc) -> None:
        """Resolve every still-open future of ``reqs`` with ``exc``."""
        for r in reqs:
            if not r.future.done():
                self.metrics.inc("failed")
                self.metrics.inc_tenant(r.tenant or DEFAULT_TENANT,
                                        "failed")
                r.future.set_exception(exc)

    def _dispatch_safe(self, bucket: Bucket,
                       reqs: List["SolveRequest"]) -> None:
        """An internal batcher bug must fail this batch's futures, not
        kill the dispatch thread (which would hang every later
        request)."""
        try:
            self._dispatch(bucket, reqs)
        except Exception as exc:  # noqa: BLE001 - containment boundary
            self._fail(reqs, SolveError(f"batcher internal error: {exc!r}"))

    # -- one batch ---------------------------------------------------

    def _expire(self, r: SolveRequest, now: float, where: str) -> None:
        """Resolve one request whose deadline passed before ``where``
        (dispatch or admission) with :class:`DeadlineExpired`."""
        m = self.metrics
        m.inc("expired")
        m.inc_tenant(r.tenant or DEFAULT_TENANT, "expired")
        if self.obs is not None and r.trace_id is not None:
            self.obs.spans.record("queue_wait", r.submitted, now,
                                  trace_id=r.trace_id, expired=True)
            self.obs.events.emit(
                "deadline_expired", "warn", trace_id=r.trace_id,
                queued_s=round(now - r.submitted, 4),
                late_s=round(now - r.deadline, 4),
                tenant=r.tenant or DEFAULT_TENANT)
        r.future.set_exception(DeadlineExpired(
            f"deadline passed {now - r.deadline:.3f}s before "
            f"{where} (queued {now - r.submitted:.3f}s)"))

    def _dispatch(self, bucket: Bucket, reqs: List[SolveRequest]) -> None:
        m = self.metrics
        obs = self.obs
        now = time.monotonic()
        live: List[SolveRequest] = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._expire(r, now, "dispatch")
            else:
                live.append(r)
        if not live:
            return
        for r in live:
            m.observe_queue_wait(now - r.submitted)
            if obs is not None and r.trace_id is not None:
                obs.spans.record("queue_wait", r.submitted, now,
                                 trace_id=r.trace_id)
        m.observe_queue_depth(self.queue.qsize() + sum(
            len(d) for d in self._pending.values()))

        slots = slot_count(len(live), self.max_batch)
        padded = [r.qp for r in live]
        if slots > len(live):
            # Fill by cycling the real problems (conditioning-neutral;
            # the filler results are dropped).
            padded = padded + [padded[i % len(live)]
                               for i in range(slots - len(live))]
        qp = stack_qps(padded)
        dtype = qp.q.dtype
        x0 = torch.zeros((slots, bucket.n), dtype=dtype)
        y0 = torch.zeros((slots, bucket.m), dtype=dtype)
        warm = [False] * len(live)
        if self.warm_cache is not None:
            for i, r in enumerate(live):
                if r.warm_key is None:
                    continue
                hit = self.warm_cache.get((r.warm_key, bucket))
                if hit is not None:
                    x0[i] = torch.from_numpy(hit[0])
                    y0[i] = torch.from_numpy(hit[1])
                    warm[i] = True
                    m.inc("warm_hits")
                    m.inc_tenant(r.tenant or DEFAULT_TENANT, "warm_hits")

        # Solver routing: one backend decision per dispatch (every lane
        # of a batch runs the same entry). Host-side: the routed
        # cache's entries were built by SolverRouter.prewarm, so a
        # table flip is a different lookup, never a new build.
        if self.router is not None:
            method, cache = self.router.decide(bucket)
        else:
            cache = self.cache
            method = cache.params.method
        m.inc(f"routed_{method}", len(live))
        for r in live:
            m.inc_tenant(r.tenant or DEFAULT_TENANT, f"routed_{method}")

        t_exec0 = time.monotonic()
        out = self._execute(bucket, slots, dtype, qp, x0, y0, live,
                            cache=cache)
        if out is None:
            return
        sol, device_label_, solve_s = out
        t_exec1 = time.monotonic()
        if _faults.enabled():
            sol["x"] = _corrupt_lanes(sol["x"], len(live), "serve.result",
                                      f"{bucket.n}x{bucket.m}")
        iters = sol["iters"]
        profile = None
        if self.harvest is not None:
            # Per-dispatch roofline, shared by the dispatch's lanes: the
            # entry's counted warm-up (its CostRecord) against measured
            # seconds, the analytic model beside it as the drift probe.
            fr = None if qp.Pf is None else int(qp.Pf.shape[-2])
            cost = cache.cost_record_for(bucket, slots, dtype, kind="solve",
                                         device_label=device_label_)
            profile = _profile.qp_solve_profile(
                bucket.n, bucket.m, float(iters[:len(live)].mean()),
                solve_s, params=cache.params, batch=slots,
                factor_rows=fr, device_kind=device_kind(device_label_),
                cost=cost)
        done = time.monotonic()
        # The fused batch steps every lane until the slowest converges:
        # the executed segment count is the batch maximum, which the
        # anomaly detector's per-lane waste divides by.
        ci = max(int(cache.params.check_interval), 1)
        exec_segs = max(-(-int(iters[:len(live)].max()) // ci), 1)
        for i, r in enumerate(live):
            # Spans are recorded before the future resolves, so a
            # caller exporting the trace on its last result finds them.
            if obs is not None and r.trace_id is not None:
                batch_args = {"bucket": f"{bucket.n}x{bucket.m}",
                              "slots": slots, "real": len(live),
                              "device": device_label_}
                obs.spans.record("assemble", now, t_exec0,
                                 trace_id=r.trace_id, **batch_args)
                obs.spans.record("solve", t_exec0, t_exec1,
                                 trace_id=r.trace_id, **batch_args)
                obs.spans.record("resolve", t_exec1, done,
                                 trace_id=r.trace_id)
            self._finish_request(r, bucket, i, sol, done, device_label_,
                                 warm[i], solve_s=solve_s,
                                 executed_segments=exec_segs,
                                 params=cache.params, profile=profile)
        m.observe_batch(len(live), slots, solve_s,
                        float(iters[:len(live)].mean()))
        # Shadow-compare after every future resolved: the sampled
        # losing-backend solve feeds the route table's evidence without
        # sitting on a request's critical path.
        if self.router is not None:
            self.router.maybe_shadow(
                bucket, slots, dtype, self.health.device(), qp, x0, y0,
                method, {"status": sol["status"], "iters": iters,
                         "obj": sol["obj_val"], "solve_s": solve_s},
                live, self.harvest, calibrator=self.calibrator)
        self._plane_tick()

    def _plane_tick(self) -> None:
        """Per-dispatch live-plane upkeep (both batchers call it after
        a dispatch's retirements): clock-gated flight snapshot, SLO and
        per-tenant SLO evaluations, and the calibrator's state-machine
        tick."""
        if self.flight is not None:
            self.flight.maybe_snapshot()
        if self.slo is not None:
            self.slo.maybe_evaluate()
        if self.tenant_slos is not None:
            self.tenant_slos.maybe_evaluate()
        if self.calibrator is not None:
            self.calibrator.maybe_tick()

    #: Harvest-record provenance tag (the continuous batcher overrides).
    harvest_source = "serve"

    def _finish_request(self, r: SolveRequest, bucket: Bucket, i: int,
                        sol: dict, done: float, device_label_: str,
                        warm_started: bool,
                        segments: Optional[int] = None,
                        solve_s: Optional[float] = None,
                        executed_segments: Optional[int] = None,
                        params=None, profile=None) -> None:
        """Shared per-request retirement of both batchers: warm-start
        cache put, the latency / completed / per-lane-Status metrics,
        the one SolveRecord fanned out to harvest, flight and
        calibrator, future resolution with the trimmed, copied
        :class:`SolveResult`, then the anomaly hook. ``sol`` holds host
        rows indexed by ``i``; ``params`` are those the lane solved
        under (a routed dispatch's backend). ``executed_segments`` is
        the device-executed segment count for the anomaly waste signal
        where it differs from the record's per-lane ``segments``;
        ``profile`` the dispatch's roofline profile for the record."""
        m = self.metrics
        tenant = r.tenant or DEFAULT_TENANT
        xs, ys = sol["x"], sol["y"]
        rp, rd, rr = sol["ring_prim"], sol["ring_dual"], sol["ring_rho"]
        status, iters = int(sol["status"][i]), int(sol["iters"][i])
        if (status == Status.SOLVED and r.warm_key is not None
                and self.warm_cache is not None
                and np.all(np.isfinite(xs[i])) and np.all(np.isfinite(ys[i]))):
            # A non-finite row (injected nan_lanes corruption, or any
            # corrupted read-back) must not seed later solves.
            self.warm_cache.put((r.warm_key, bucket), xs[i], ys[i])
        m.observe_latency(done - r.submitted)
        m.inc("completed")
        m.inc_tenant(tenant, "completed")
        m.observe_tenant_latency(tenant, done - r.submitted)
        m.observe_status(status)
        m.observe_request_iters(iters)
        if params is None:
            params = self.cache.params
        if (self.harvest is not None or self.flight is not None
                or self.calibrator is not None):
            ring = None
            if rp is not None:
                ring = ring_history(rp[i], rd[i], rr[i], iters,
                                    params.check_interval)
            rec = solve_record(
                self.harvest_source, r.n_orig, r.m_orig, status, iters,
                float(sol["prim_res"][i]), float(sol["dual_res"][i]),
                float(sol["obj_val"][i]), params=params,
                bucket=f"{bucket.n}x{bucket.m}", warm=warm_started,
                warm_src=r.warm_src if warm_started else None,
                wall_s=done - r.submitted, solve_s=solve_s,
                device=device_label_, trace_id=r.trace_id, ring=ring,
                segments=segments, profile=profile, tenant=tenant)
            if self.harvest is not None:
                self.harvest.emit(rec)
            if self.flight is not None:
                self.flight.record_solve(rec)
            if self.calibrator is not None:
                self.calibrator.observe(rec)
        r.future.set_result(SolveResult(
            x=np.array(xs[i, :r.n_orig], copy=True),
            status=status,
            iters=iters,
            prim_res=float(sol["prim_res"][i]),
            dual_res=float(sol["dual_res"][i]),
            obj_val=float(sol["obj_val"][i]),
            latency_s=done - r.submitted,
            warm_started=warm_started,
            device=device_label_,
            trace_id=r.trace_id,
            ring_prim=None if rp is None else np.array(rp[i], copy=True),
            ring_dual=None if rd is None else np.array(rd[i], copy=True),
            ring_rho=None if rr is None else np.array(rr[i], copy=True),
        ))
        # Anomaly hook after the future resolves: the caller has its
        # answer before this retirement's telemetry can trigger an
        # incident dump.
        if self.anomaly is not None:
            self.anomaly.observe(
                f"{bucket.n}x{bucket.m}", float(params.eps_abs), iters,
                segments=(segments if executed_segments is None
                          else executed_segments),
                check_interval=int(params.check_interval),
                tenant=tenant)

    def _execute(self, bucket: Bucket, slots: int, dtype, qp, x0, y0,
                 live: List[SolveRequest], cache=None):
        """Run the batch on the current device through ``cache`` (the
        routed backend's, else ``self.cache``); on failure, let the
        health manager trip the breaker and retry on whatever device it
        then points at (the degrade path, where the caller named a
        fallback). Returns ``(host solution, device label, seconds)``
        or ``None`` when the batch failed."""
        if cache is None:
            cache = self.cache
        last_exc: Optional[Exception] = None
        for _attempt in range(4):  # bounded: threshold trips inside this
            device = self.health.device()
            try:
                if _faults.enabled():
                    # serve.dispatch seam: an injected device loss
                    # raises here, inside the containment loop, so it
                    # rides the breaker/fallback path a real fault
                    # takes.
                    _faults.fire("serve.dispatch",
                                 bucket=f"{bucket.n}x{bucket.m}",
                                 device=device_label(device))
                exe = cache.get(bucket, slots, dtype, device)
                with _profile.profiled_stage(
                        self.profiler, "serve/solve_batch",
                        "solve_batch") as prof:
                    # The host copy of the results ends the dispatch,
                    # so the stage is timed honestly.
                    sol = host_solution(
                        self._call_executable(exe, device, qp, x0, y0))
                self.health.record_success()
                return sol, device_label(device), prof["seconds"]
            except sanitize.SanitizerError as exc:
                # A policy violation (a post-warmup compile demand, an
                # implicit transfer) is not a device fault: fail this
                # batch loudly and leave the breaker alone.
                if self.obs is not None:
                    self.obs.events.emit(
                        "sanitizer_violation", "error",
                        what="dispatch", bucket=f"{bucket.n}x{bucket.m}",
                        detail=str(exc))
                self._fail(live, SolveError(f"sanitizer: {exc}"))
                return None
            except Exception as exc:  # noqa: BLE001 - device faults vary
                last_exc = exc
                self.metrics.inc("dispatch_failures")
                if self.obs is not None:
                    self.obs.events.emit(
                        "dispatch_failure", "error",
                        bucket=f"{bucket.n}x{bucket.m}",
                        device=device_label(device),
                        error=f"{type(exc).__name__}: {exc}")
                if not self.health.record_failure(exc):
                    break  # already on the last-resort device
        self._fail(live, SolveError(
            f"dispatch failed on every device: {last_exc!r}"))
        return None

    @staticmethod
    def _call_executable(exe, device, qp, x0, y0):
        """Run one compiled dispatch; under ``PORQUA_SANITIZE=1`` the
        one intentional host->device batch upload is made explicit and
        the dispatch itself runs inside the transfer guard: any other
        transfer the hot path picks up (a stray host operand, a hidden
        host read) raises :class:`SanitizerError` instead of silently
        serializing."""
        return sanitize.guarded_call(exe, device, qp, x0, y0)
