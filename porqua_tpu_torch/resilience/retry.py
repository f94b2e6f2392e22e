"""Recovery policies for the online solve service: retry, hedge, validate.

The batcher already contains one recovery loop — the in-dispatch
device-fault retry that rides the circuit breaker. In the port the
breaker fails over only to a device the caller names
(``SolveService(fallback="cpu")``): without one, a retry goes back to
the primary card and never to the CPU on its own. (The port of
``porqua_tpu/resilience/retry.py``.)
This module adds the *request-level* policies that sit above it,
because a production caller cares about exactly three things the
dispatch loop cannot provide:

* **Per-request retry with backoff + jitter.** A request whose batch
  failed (device fault that exhausted the dispatch loop, sanitizer
  refusal, a validation failure) is resubmitted after an exponential
  backoff with seeded jitter, bounded by ``max_attempts`` and — always
  — by the request's own deadline: a retry that cannot finish before
  the deadline is not scheduled (``retry_giveups``).
* **Idempotent resubmission keyed by request id.** ``submit(...,
  request_id=...)`` registers the request; submitting the same id
  again — a client retrying over a flaky transport, a replayed
  message — returns the SAME ticket, whether the request is in flight
  or already resolved. One id, one future, one resolution: no
  double-resolve, no double-counted metrics, no duplicate device work.
* **Hedged duplicates for tail latency.** With ``hedge_after_s`` set,
  a request still unresolved that long after submission fires one
  duplicate; first valid result wins, the loser is discarded at the
  resolution gate (``hedges_fired`` / ``hedges_won``).

Result validation (``validate=True``) is the zero-wrong-answers gate:
a solution whose primal vector or certificates are non-finite — a
corrupted lane, a numerically destroyed solve — is treated as a
*failure* (counted in ``validation_failures``, eligible for retry),
never handed to the caller as an answer.

All timing flows through an injectable ``clock`` (default
``time.monotonic``) so chaos scenarios replay deterministically
against a :class:`porqua_tpu_torch.resilience.faults.FaultClock`; the
scheduler thread polls in short bounded waits precisely so a stepped
fake clock is observed without real-time sleeps of the same length.

Everything here is host-side policy over the existing submit path —
what the card runs is untouched.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

import numpy as np

from porqua_tpu_torch.analysis import tsan
from porqua_tpu_torch.serve.batcher import DeadlineExpired, SolveError

__all__ = ["RetryPolicy", "RetryManager", "validate_result"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs for :class:`RetryManager` (frozen: policy is service
    identity, like SolverParams)."""

    max_attempts: int = 3          # primary attempts (1 = no retry)
    backoff_base_s: float = 0.02   # first retry delay
    backoff_mult: float = 2.0      # exponential growth per retry
    jitter: float = 0.5            # +- fraction of the delay, seeded
    hedge_after_s: Optional[float] = None  # None = no hedging
    validate: bool = True          # reject non-finite results
    registry_capacity: int = 8192  # idempotency window (LRU)
    seed: int = 0                  # jitter RNG seed

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        """Delay before retry number ``attempt`` (1-based)."""
        base = self.backoff_base_s * self.backoff_mult ** (attempt - 1)
        if self.jitter:
            base *= 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
        return max(base, 0.0)


def validate_result(res) -> Optional[str]:
    """None when ``res`` is fit to hand to a caller; otherwise the
    reason it is not. The gate is finiteness — a NaN/Inf primal vector
    or certificate is by definition not a solution, whatever status
    claims — so an injected ``nan_lanes`` corruption (or a real
    numerically destroyed lane) converts to a retryable failure
    instead of a wrong answer."""
    x = np.asarray(res.x)
    if not np.all(np.isfinite(x)):
        return "non-finite primal solution"
    for name in ("prim_res", "dual_res", "obj_val"):
        if not np.isfinite(getattr(res, name)):
            return f"non-finite {name}"
    return None


class _Entry:
    """One registered request's lifecycle state (guarded by the
    manager lock except the Future, which is its own sync point)."""

    __slots__ = ("request_id", "qp", "warm_key", "deadline", "future",
                 "submitted", "attempts", "hedges", "inflight",
                 "resolved", "last_exc", "tenant")

    def __init__(self, request_id: str, qp, warm_key, deadline,
                 submitted: float, tenant=None) -> None:
        self.request_id = request_id
        self.qp = qp
        self.warm_key = warm_key
        # Tenant id for per-tenant attribution of validation failures
        # and give-ups (and quota enforcement on every inner attempt).
        self.tenant = tenant
        self.deadline = deadline        # absolute, manager clock; None
        self.future: Future = Future()  # the caller's future
        self.submitted = submitted
        self.attempts = 0               # primary attempts issued
        self.hedges = 0
        self.inflight = 0               # inner futures not yet done
        self.resolved = False
        self.last_exc: Optional[BaseException] = None


class RetryManager:
    """Request-level recovery layer over one :class:`SolveService`.

    Created by ``SolveService(retry=RetryPolicy(...))``; every public
    ``submit`` routes through :meth:`submit` here, which fans inner
    attempts into the service's raw path (``SolveService._submit_raw``)
    and resolves exactly one caller-facing future per request id.
    """

    def __init__(self, service, policy: RetryPolicy, metrics,
                 events=None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.service = service
        self.policy = policy
        self.metrics = metrics
        self.events = events
        self.clock = time.monotonic if clock is None else clock
        self._rng = np.random.default_rng(policy.seed)
        self._lock = tsan.lock("RetryManager")
        # guarded-by: self._lock
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._timers: list = []         # guarded-by: self._lock (heap)
        self._timer_seq = 0             # guarded-by: self._lock
        self._cond = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False          # guarded-by: self._lock

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        with self._lock:
            self._stopping = False
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run_timers, name="porqua-serve-retry",
                daemon=True)
            self._thread.start()

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        with self._lock:
            self._stopping = True
            self._timers.clear()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # Stopping abandons every scheduled retry/hedge — each
        # unresolved entry's future must fail NOW, or a caller blocked
        # in service.result() waits forever on a timer that will never
        # fire. Marked resolved under the lock first so a late
        # _on_inner_done from a still-draining inner future discards
        # itself instead of racing the resolution.
        abandoned = []
        with self._lock:
            for entry in self._entries.values():
                if not entry.resolved:
                    entry.resolved = True
                    entry.qp = None
                    abandoned.append(entry)
        for entry in abandoned:
            self.metrics.inc("retry_giveups")
            self.metrics.inc_tenant(entry.tenant or "default",
                                    "retry_giveups")
            if self.events is not None:
                last = entry.last_exc
                self.events.emit(
                    "retry_giveup", "error",
                    request_id=entry.request_id, reason="stopped",
                    attempts=entry.attempts, hedges=entry.hedges,
                    tenant=entry.tenant or "default",
                    error=(None if last is None
                           else f"{type(last).__name__}: {last}"))
            entry.future.set_exception(SolveError(
                f"service stopped before request {entry.request_id} "
                f"resolved (attempts={entry.attempts})"))

    # -- public -------------------------------------------------------

    def submit(self, qp, deadline_s: Optional[float] = None,
               warm_key: Optional[str] = None,
               timeout: Optional[float] = None,
               request_id: Optional[str] = None,
               tenant: Optional[str] = None):
        """Register (or deduplicate) one request and issue its first
        attempt; returns the service's Ticket type over the caller's
        future. A ``request_id`` already registered — in flight OR
        resolved — returns the existing ticket untouched."""
        from porqua_tpu_torch.serve.service import Ticket

        now = self.clock()
        if request_id is None:
            request_id = uuid.uuid4().hex
        with self._lock:
            entry = self._entries.get(request_id)
            if entry is not None:
                # Idempotent resubmission: same id -> same future. No
                # inner work is issued, no counter moves; the LRU
                # refresh just extends the dedupe window.
                self._entries.move_to_end(request_id)
                return Ticket(future=entry.future, submitted=entry.submitted)
            entry = _Entry(request_id, qp, warm_key,
                           None if deadline_s is None else now + deadline_s,
                           submitted=time.monotonic(), tenant=tenant)
            self._entries[request_id] = entry
            # LRU-evict RESOLVED entries only: evicting an in-flight
            # one would fork its id (a duplicate submit registers a
            # second future) and orphan the original future at stop(),
            # which only fails entries still in the registry. If every
            # entry is unresolved the registry transiently exceeds
            # capacity — bounded by the caller's in-flight window.
            excess = len(self._entries) - self.policy.registry_capacity
            if excess > 0:
                # Walk oldest-first and stop once the excess is
                # covered: in steady state the head IS resolved, so
                # this is O(excess) under the lock, not a full
                # registry scan per submit.
                stale = []
                for rid, e in self._entries.items():
                    if len(stale) >= excess:
                        break
                    if e.resolved:
                        stale.append(rid)
                for rid in stale:
                    del self._entries[rid]
        self._issue(entry, kind="primary", submit_timeout=timeout,
                    propagate_queue_full=(timeout is not None
                                          and timeout <= 0))
        if self.policy.hedge_after_s is not None:
            self._schedule(now + self.policy.hedge_after_s,
                           lambda: self._maybe_hedge(entry))
        return Ticket(future=entry.future, submitted=entry.submitted)

    # -- attempts -----------------------------------------------------

    def _remaining(self, entry: _Entry) -> Optional[float]:
        return (None if entry.deadline is None
                else entry.deadline - self.clock())

    def _issue(self, entry: _Entry, kind: str,
               submit_timeout: Optional[float] = None,
               propagate_queue_full: bool = False) -> None:
        """Issue one inner attempt (primary/retry/hedge). A submit that
        fails synchronously (QueueFull, stopped service) flows through
        the same completion path as a failed future — except a
        ``QueueFull`` under ``propagate_queue_full``, which unregisters
        the entry and re-raises so a non-blocking caller (open-loop
        load generation) sees the backpressure it asked to observe."""
        with self._lock:
            if entry.resolved:
                return
            if kind != "hedge":
                entry.attempts += 1
            entry.inflight += 1
            qp = entry.qp  # read under the lock: resolution drops it
        remaining = self._remaining(entry)
        if remaining is not None and remaining <= 0:
            failed: Future = Future()
            failed.set_exception(DeadlineExpired(
                f"request {entry.request_id} deadline passed before "
                f"{kind} attempt could be issued"))
            self._on_inner_done(entry, kind, failed)
            return
        try:
            ticket = self.service._submit_raw(
                qp, deadline_s=remaining, warm_key=entry.warm_key,
                timeout=submit_timeout, tenant=entry.tenant)
        except Exception as exc:  # noqa: BLE001 - policy boundary
            from porqua_tpu_torch.serve.service import QueueFull

            if propagate_queue_full and isinstance(exc, QueueFull):
                with self._lock:
                    entry.inflight -= 1
                    self._entries.pop(entry.request_id, None)
                raise
            failed = Future()
            failed.set_exception(exc)
            self._on_inner_done(entry, kind, failed)
            return
        ticket.future.add_done_callback(
            lambda f, e=entry, k=kind: self._on_inner_done(e, k, f))

    def _maybe_hedge(self, entry: _Entry) -> None:
        with self._lock:
            if entry.resolved or self._stopping:
                return
            remaining = self._remaining(entry)
            if remaining is not None and remaining <= 0:
                return
            entry.hedges += 1
        self.metrics.inc("hedges_fired")
        if self.events is not None:
            self.events.emit("hedge_fired", "info",
                             request_id=entry.request_id,
                             attempt=entry.attempts)
        # Non-blocking submit: this runs on the single timer thread,
        # which must never block on a full queue — a QueueFull becomes
        # a failed attempt (eligible for backoff) instead of stalling
        # every other scheduled retry and hedge behind it.
        self._issue(entry, kind="hedge", submit_timeout=0.0)

    # -- completion ---------------------------------------------------

    def _on_inner_done(self, entry: _Entry, kind: str,
                       fut: Future) -> None:
        exc = fut.exception()
        res = None if exc is not None else fut.result()
        if exc is None and self.policy.validate:
            reason = validate_result(res)
            if reason is not None:
                self.metrics.inc("validation_failures")
                self.metrics.inc_tenant(entry.tenant or "default",
                                        "validation_failures")
                if self.events is not None:
                    # `kind` (the event kind) is emit's first
                    # positional; the attempt kind rides under its own
                    # name. The tenant rides along so a corrupt-feed
                    # incident bundle names the offending tenant.
                    self.events.emit(
                        "validation_failed", "error",
                        request_id=entry.request_id, attempt_kind=kind,
                        trace_id=getattr(res, "trace_id", None),
                        reason=reason, tenant=entry.tenant or "default")
                exc = SolveError(
                    f"result validation failed ({reason}); the answer "
                    f"was withheld and the attempt treated as a failure")
                res = None

        resolve_exc: Optional[BaseException] = None
        resolve_res = None
        retry_delay: Optional[float] = None
        giveup_reason: Optional[str] = None
        won_hedge = was_resumed = False
        with self._lock:
            entry.inflight -= 1
            if entry.resolved:
                return  # a sibling attempt already won; discard
            if exc is None:
                entry.resolved = True
                # Resolution drops the problem payload: the entry only
                # outlives this point as the idempotency record (id ->
                # future), and up to registry_capacity retained QP
                # matrices is real memory on real problem sizes.
                entry.qp = None
                resolve_res = res
                won_hedge = kind == "hedge"
                was_resumed = entry.attempts > 1 or won_hedge
            else:
                entry.last_exc = exc
                now = self.clock()
                if isinstance(exc, DeadlineExpired):
                    # Deadline-aware give-up: the budget is spent; a
                    # retry would expire in the queue all over again.
                    giveup_reason = "deadline"
                elif entry.attempts >= self.policy.max_attempts:
                    giveup_reason = "attempts"
                else:
                    delay = self.policy.backoff_s(entry.attempts,
                                                  self._rng)
                    if entry.deadline is not None \
                            and now + delay >= entry.deadline:
                        giveup_reason = "deadline"
                    else:
                        retry_delay = delay
                if giveup_reason is not None and entry.inflight > 0:
                    # A hedge is still racing: let it decide the
                    # request rather than failing a future its twin
                    # may yet resolve.
                    return
                if giveup_reason is not None:
                    entry.resolved = True
                    entry.qp = None
                    resolve_exc = exc

        if resolve_res is not None:
            if won_hedge:
                self.metrics.inc("hedges_won")
            if was_resumed:
                # The request completed only because the policy
                # re-drove it (a retry or a hedge) — the figure the
                # loadgen report surfaces as `resumed_requests`.
                self.metrics.inc("resumed_requests")
            entry.future.set_result(resolve_res)
            return
        if resolve_exc is not None:
            self.metrics.inc("retry_giveups")
            self.metrics.inc_tenant(entry.tenant or "default",
                                    "retry_giveups")
            if self.events is not None:
                self.events.emit(
                    "retry_giveup", "error",
                    request_id=entry.request_id, reason=giveup_reason,
                    attempts=entry.attempts, hedges=entry.hedges,
                    tenant=entry.tenant or "default",
                    error=f"{type(resolve_exc).__name__}: {resolve_exc}")
            entry.future.set_exception(resolve_exc)
            return
        if retry_delay is not None:
            self.metrics.inc("retries")
            if self.events is not None:
                self.events.emit(
                    "retry_scheduled", "warn",
                    request_id=entry.request_id,
                    attempt=entry.attempts + 1,
                    delay_s=round(retry_delay, 4),
                    error=f"{type(exc).__name__}: {exc}")
            # submit_timeout=0.0: retries are issued from the single
            # timer thread, which must never block on a full queue
            # (a QueueFull is just another failed attempt).
            self._schedule(self.clock() + retry_delay,
                           lambda: self._issue(entry, kind="retry",
                                               submit_timeout=0.0))

    # -- timer wheel --------------------------------------------------

    def _schedule(self, due: float, fn: Callable[[], None]) -> None:
        with self._lock:
            self._timer_seq += 1
            heapq.heappush(self._timers, (due, self._timer_seq, fn))
            self._cond.notify_all()

    def _run_timers(self) -> None:
        """Fire due timers; wait in SHORT bounded slices so a stepped
        FaultClock is observed promptly without busy-spinning (50 ms
        poll floor — far below any backoff/hedge delay that matters,
        invisible next to a real device dispatch)."""
        while True:
            fns = []
            with self._lock:
                if self._stopping:
                    return
                now = self.clock()
                while self._timers and self._timers[0][0] <= now:
                    _, _, fn = heapq.heappop(self._timers)
                    fns.append(fn)
                if not fns:
                    wait = 0.05
                    if self._timers:
                        wait = min(wait, max(self._timers[0][0] - now,
                                             1e-4))
                    self._cond.wait(timeout=wait)
            for fn in fns:
                try:
                    fn()
                except Exception:  # noqa: BLE001 - timer containment
                    # A policy bug must not kill the timer thread (it
                    # would silently disable every later retry/hedge).
                    pass

    # -- readers ------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if not e.resolved)

    def entry_stats(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._entries.get(request_id)
            if e is None:
                return None
            return {"attempts": e.attempts, "hedges": e.hedges,
                    "resolved": e.resolved, "inflight": e.inflight}
