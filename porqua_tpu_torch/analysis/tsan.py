"""Runtime lock-order sanitizer (``PORQUA_TSAN=1``): a host copy of the
JAX package's ``analysis/tsan.py`` (threading only).

* :func:`lock` is the drop-in factory the serve stack's classes use
  for their instance locks (``self._lock = tsan.lock("ServeMetrics")``).
  Disabled (the default), it returns a plain ``threading.Lock``. Under
  ``PORQUA_TSAN=1`` it returns a :class:`TSanLock`, which on every
  acquire/release keeps the calling thread's held-lock set and the
  process-wide acquisition-order graph over lock *names* (instances of
  one class share a name: the discipline is per lock class).
* **Order inversions**: acquiring ``B`` while holding ``A`` records
  ``A -> B``; a later acquire of ``A`` under ``B`` raises
  :class:`LockOrderError` before blocking. Re-acquiring a held name
  raises at once (a guaranteed self-deadlock with a non-reentrant
  lock).
* **Hold-time budget**: a critical section longer than
  ``PORQUA_TSAN_HOLD_BUDGET_S`` (default 5.0) raises
  :class:`LockHoldError` after the release.
* **Deadlock watchdog**: a blocking acquire polls with a bounded
  timeout and walks the wait-for graph on every timeout, raising
  :class:`DeadlockError` naming a closed cycle.
  ``PORQUA_TSAN_MAX_WAIT_S`` (default off) bounds any single acquire.

:class:`TSanLock` supports the full lock protocol and is a valid
``threading.Condition`` base lock.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from porqua_tpu_torch.analysis.sanitize import SanitizerError

__all__ = [
    "DeadlockError",
    "LockHoldError",
    "LockOrderError",
    "TSanLock",
    "enabled",
    "hold_budget_s",
    "lock",
    "order_graph",
    "reset",
    "violations",
]


class LockOrderError(SanitizerError):
    """Two locks were acquired in both orders (potential deadlock)."""


class LockHoldError(SanitizerError):
    """A lock was held longer than the configured budget."""


class DeadlockError(SanitizerError):
    """The wait-for graph closed a cycle (live deadlock)."""


def enabled() -> bool:
    """TSAN mode is on (checked at lock construction)."""
    return os.environ.get("PORQUA_TSAN") == "1"


def hold_budget_s() -> float:
    """Critical-section duration budget (seconds)."""
    return float(os.environ.get("PORQUA_TSAN_HOLD_BUDGET_S", "5.0"))


def max_wait_s() -> Optional[float]:
    """Optional hard bound on any single blocking acquire."""
    raw = os.environ.get("PORQUA_TSAN_MAX_WAIT_S")
    return float(raw) if raw else None


#: Watchdog poll interval for blocking acquires (seconds). Short
#: enough that a real deadlock is reported promptly, long enough that
#: a contended-but-live lock costs a handful of extra syscalls.
_POLL_S = 0.05

# The meta-lock guarding the order/wait-for graphs. A plain Lock on
# purpose (instrumenting it would recurse); every critical section
# under it is a few dict operations.
_graph_lock = threading.Lock()
#: name -> names acquired at least once while `name` was held
_order: Dict[str, Set[str]] = {}
#: (held name, acquired name) -> "file:line" of the first recording
_edge_sites: Dict[Tuple[str, str], str] = {}
#: id(TSanLock) -> owning thread ident (while held)
_owners: Dict[int, int] = {}
#: thread ident -> TSanLock it is currently blocked acquiring
_waiting: Dict[int, "TSanLock"] = {}
#: violations recorded (also raised) — readable by tests/reports
_violations: List[str] = []

_tls = threading.local()


def _held_stack() -> List["TSanLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def reset() -> None:
    """Clear the order graph, wait-for state, and violation log (test
    helper; live TSanLocks keep working against the fresh graph)."""
    with _graph_lock:
        _order.clear()
        _edge_sites.clear()
        _owners.clear()
        _waiting.clear()
        _violations.clear()


def order_graph() -> Dict[str, Set[str]]:
    """A copy of the acquisition-order edges recorded so far."""
    with _graph_lock:
        return {k: set(v) for k, v in _order.items()}


def violations() -> List[str]:
    """Messages of every violation raised so far (process-wide)."""
    with _graph_lock:
        return list(_violations)


def _from_stdlib_threading() -> bool:
    """Is the frame calling into this module threading.py itself
    (Condition._release_save / _acquire_restore)?"""
    import sys

    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith("tsan.py"):
        f = f.f_back
    return f is not None and f.f_code.co_filename == threading.__file__


def _call_site() -> str:
    """The acquiring frame outside this module (for edge messages)."""
    import sys

    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith("tsan.py"):
        f = f.f_back
    if f is None:  # pragma: no cover - interpreter teardown
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _path_exists(src: str, dst: str) -> bool:
    """Is there a path src ->* dst in the order graph? (called under
    ``_graph_lock``)"""
    if src == dst:
        return True
    seen = {src}
    stack = [src]
    while stack:
        node = stack.pop()
        for nxt in _order.get(node, ()):
            if nxt == dst:
                return True
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def _record_violation(msg: str) -> None:
    with _graph_lock:
        _violations.append(msg)


class TSanLock:
    """An instrumented non-reentrant mutex (see module docstring)."""

    __slots__ = ("name", "_inner", "_acquired_at", "_acquire_site")

    def __init__(self, name: str) -> None:
        self.name = name
        self._inner = threading.Lock()
        self._acquired_at = 0.0
        self._acquire_site = ""

    # -- protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        held = _held_stack()
        site = _call_site()
        me = threading.get_ident()
        if held:
            self._check_order(held, site)
        if blocking and timeout < 0:
            ok = self._acquire_watched(me)
        else:
            ok = self._inner.acquire(blocking, timeout)
        if ok:
            with _graph_lock:
                _owners[id(self)] = me
            self._acquired_at = time.monotonic()
            self._acquire_site = site
            held.append(self)
        return ok

    def release(self) -> None:
        held = _held_stack()
        if self not in held:
            # A thread releasing a lock it does not hold: threading.Lock
            # would let a FOREIGN release through silently (it is not
            # owner-checked), corrupting the owner table the watchdog
            # walks and setting the real owner up for a misattributed
            # "release unlocked lock". Refuse before touching any state.
            msg = (f"lock {self.name!r} released by thread "
                   f"{threading.get_ident()} which does not hold it "
                   f"(cross-thread or double release)")
            _record_violation(msg)
            raise SanitizerError(msg)
        duration = time.monotonic() - self._acquired_at
        # Snapshot the site BEFORE dropping the inner lock: the next
        # acquirer overwrites _acquire_site the instant it gets in, and
        # a violation naming the wrong critical section misdirects the
        # triage.
        site = self._acquire_site
        held.remove(self)
        with _graph_lock:
            _owners.pop(id(self), None)
        self._inner.release()
        budget = hold_budget_s()
        if duration > budget:
            msg = (f"lock {self.name!r} held {duration:.3f}s "
                   f"(budget {budget:.3f}s; acquired at "
                   f"{site}): blocking work does not "
                   f"belong inside this critical section")
            _record_violation(msg)
            # Raised AFTER the release: the violation must not wedge
            # every other thread behind a lock held by a raising frame.
            # EXCEPT when the release is Condition.wait's internal
            # _release_save — raising into threading's wait protocol
            # leaves the condition with a queued waiter and the lock
            # not re-acquired, so the enclosing `with cond:` exit then
            # masks this diagnostic with "release unlocked lock". The
            # violation is still recorded; tsan.violations() gates on
            # it in the smoke/stress passes.
            if not _from_stdlib_threading():
                raise LockHoldError(msg)

    def __enter__(self) -> "TSanLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        try:
            self.release()
        except LockHoldError:
            # An exception is already unwinding through this `with`
            # block: replacing it with the hold-budget violation would
            # misdiagnose the real failure (the original error would
            # survive only as __context__). The violation is recorded;
            # violations() still gates on it.
            if exc_type is None:
                raise

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        """threading.Condition's ownership probe."""
        return self in _held_stack()

    # -- instrumentation ----------------------------------------------

    def _check_order(self, held: List["TSanLock"], site: str) -> None:
        with _graph_lock:
            for h in held:
                if h is self or h.name == self.name:
                    msg = (f"re-acquisition of lock {self.name!r} "
                           f"at {site} while already held (acquired "
                           f"at {h._acquire_site}): guaranteed "
                           f"self-deadlock / unordered same-class pair")
                    _violations.append(msg)
                    raise DeadlockError(msg)
                if _path_exists(self.name, h.name):
                    first = _edge_sites.get((self.name, h.name), "?")
                    msg = (f"lock-order inversion: acquiring "
                           f"{self.name!r} at {site} while holding "
                           f"{h.name!r} (acquired at "
                           f"{h._acquire_site}), but the opposite "
                           f"order {self.name!r} -> {h.name!r} was "
                           f"recorded at {first}; acquire these locks "
                           f"in one global order")
                    _violations.append(msg)
                    raise LockOrderError(msg)
            for h in held:
                after = _order.setdefault(h.name, set())
                if self.name not in after:
                    after.add(self.name)
                    _edge_sites[(h.name, self.name)] = site

    def _acquire_watched(self, me: int) -> bool:
        """Blocking acquire as a bounded poll loop with the deadlock
        watchdog: each timeout, walk the wait-for graph and raise on a
        closed cycle; ``PORQUA_TSAN_MAX_WAIT_S`` optionally bounds the
        total wait."""
        deadline = None
        cap = max_wait_s()
        if cap is not None:
            deadline = time.monotonic() + cap
        with _graph_lock:
            _waiting[me] = self
        try:
            while True:
                if self._inner.acquire(timeout=_POLL_S):
                    return True
                self._watchdog_check(me)
                if deadline is not None and time.monotonic() > deadline:
                    msg = (f"acquire of lock {self.name!r} exceeded "
                           f"PORQUA_TSAN_MAX_WAIT_S={cap}s "
                           f"(possible deadlock or runaway hold)")
                    _record_violation(msg)
                    raise DeadlockError(msg)
        finally:
            with _graph_lock:
                _waiting.pop(me, None)

    def _watchdog_check(self, me: int) -> None:
        with _graph_lock:
            cycle = [f"thread {me} waits for {self.name!r}"]
            lock: Optional[TSanLock] = self
            seen_threads = {me}
            while lock is not None:
                owner = _owners.get(id(lock))
                if owner is None:
                    return  # released between poll and check
                if owner == me:
                    msg = ("deadlock: " + " -> ".join(
                        cycle + [f"owned by thread {owner}"]))
                    _violations.append(msg)
                    raise DeadlockError(msg)
                if owner in seen_threads:
                    return  # cycle not through us; their watchdog fires
                seen_threads.add(owner)
                nxt = _waiting.get(owner)
                if nxt is not None:
                    cycle.append(f"thread {owner} holds {lock.name!r} "
                                 f"and waits for {nxt.name!r}")
                lock = nxt


def lock(name: str):
    """The drop-in lock factory: a :class:`TSanLock` under
    ``PORQUA_TSAN=1``, a plain ``threading.Lock`` otherwise. ``name``
    should identify the lock *class* (usually the owning class name) —
    instances share ordering state, lockdep-style."""
    if enabled():
        return TSanLock(name)
    return threading.Lock()
