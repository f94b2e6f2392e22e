"""Deterministic fault injection: seeded seams at named chokepoints (a
host copy of ``porqua_tpu/resilience/faults.py``, numpy and threading
only).

A process-global :class:`FaultInjector` holds a :class:`Scenario` (a list
of :class:`FaultSpec` rules) and is consulted at **named seams**. The
scenario DSL, the seam and kind names and the seeded draw streams are
the JAX package's, so the same scenario, seed and sequence of seam hits
fire the same faults in both packages. The seams are the JAX
package's: ``backtest.chunk`` (the checkpointed backtest loops of
:mod:`porqua_tpu_torch.checkpoint`, after each chunk save), the serve
stack's ``serve.admission``, ``serve.dispatch``, ``serve.result``,
``serve.continuous``, ``health.probe``, ``cache.get`` and the load
generator's ``data.feed``; ``loadgen.worker`` keeps its name for the
fleet driver, which is not ported yet.

Every seam follows one pattern::

    from porqua_tpu_torch.resilience import faults as _faults
    ...
    if _faults.enabled():
        act = _faults.fire("backtest.chunk", idx=idx)

Disabled (the default) the seam is a single module-global ``is not
None`` predicate: no injector object, no RNG, no allocation.

Determinism: each ``(seam, kind)`` rule carries its own counter and its
own ``numpy`` Generator seeded from ``(scenario.seed, seam, kind,
start)``, so a seam's fault sequence depends only on how many times
*that seam* was hit, and replaying a scenario replays its faults.

Fault kinds (the scenario DSL):

``device_lost``     raise :class:`InjectedFault` at a dispatch seam.
``probe_fail``      directive ``fail`` at ``health.probe``.
``nan_lanes``       directive at ``serve.result``: corrupt ``lanes``
                    result rows to NaN/Inf on the host copy.
``compile_storm``   directive at ``cache.get``: evict a cache entry.
``queue_stall``     directive ``stall_s`` at ``serve.admission``.
``clock_skew``      directive ``skew_s`` at ``serve.admission``.
``feed_corrupt``    directive at ``data.feed``: poison the request's
                    objective vector with NaN (:func:`corrupt_feed`).
``crash``           raise :class:`InjectedCrash` at ``backtest.chunk``:
                    kill a checkpointed backtest mid-run to drive the
                    crash-resume parity checks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "FaultAction",
    "FaultClock",
    "FaultInjector",
    "FaultSpec",
    "InjectedCrash",
    "InjectedFault",
    "KINDS",
    "SEAMS",
    "Scenario",
    "active",
    "builtin_scenarios",
    "corrupt_feed",
    "enabled",
    "fire",
    "install",
    "uninstall",
]

#: Every seam name compiled into the stack (unknown names raise at
#: Scenario construction — a typo'd seam must not silently never fire).
SEAMS = (
    "serve.admission",
    "serve.dispatch",
    "serve.result",
    "serve.continuous",
    "health.probe",
    "cache.get",
    "data.feed",
    "backtest.chunk",
    "loadgen.worker",
)

#: kind -> seams it is allowed to target (the DSL's type system).
#: ``crash`` additionally targets ``loadgen.worker``: a fleet loadgen
#: shard (scripts/fleet_loadgen.py) dies mid-soak through the same
#: seeded kind the crash-resume backtests use — the fleet collector's
#: liveness tracking must turn that into a ``worker_lost`` incident.
KINDS: Dict[str, Tuple[str, ...]] = {
    "device_lost": ("serve.dispatch", "serve.continuous"),
    "probe_fail": ("health.probe",),
    "nan_lanes": ("serve.result",),
    "compile_storm": ("cache.get",),
    "queue_stall": ("serve.admission",),
    "clock_skew": ("serve.admission",),
    "feed_corrupt": ("data.feed",),
    "crash": ("backtest.chunk", "loadgen.worker"),
}


class InjectedFault(RuntimeError):
    """A deliberately induced device/dispatch fault. Deliberately a
    plain RuntimeError subclass: a caller must treat it through the
    same containment paths as a real device error; special-casing it
    would test nothing."""


class InjectedCrash(BaseException):
    """A deliberately induced process death for crash-resume tests.

    Derives from BaseException so ordinary ``except Exception``
    containment (the batcher's, the checkpoint loop's) cannot swallow
    it — a real ``kill -9`` wouldn't be swallowed either.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule: *at this seam, starting at hit index
    ``start``, fire ``count`` times with probability ``p`` per
    eligible hit*. ``args`` parameterizes the kind (``lanes``,
    ``stall_s``, ``skew_s``, ...)."""

    seam: str
    kind: str
    start: int = 0               # first eligible hit index (0-based)
    count: int = 1               # max fires (None/inf not allowed: bounded)
    p: float = 1.0               # per-hit probability, seeded RNG
    args: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(
                f"unknown seam {self.seam!r}; known: {', '.join(SEAMS)}")
        allowed = KINDS.get(self.kind)
        if allowed is None:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: "
                f"{', '.join(KINDS)}")
        if self.seam not in allowed:
            raise ValueError(
                f"fault kind {self.kind!r} cannot target seam "
                f"{self.seam!r} (allowed: {', '.join(allowed)})")
        if self.count < 1:
            raise ValueError("count must be >= 1")
        if not 0.0 < self.p <= 1.0:
            raise ValueError("p must be in (0, 1]")

    @staticmethod
    def make(seam: str, kind: str, start: int = 0, count: int = 1,
             p: float = 1.0, **args) -> "FaultSpec":
        """Keyword-args convenience constructor (``args`` as kwargs)."""
        return FaultSpec(seam=seam, kind=kind, start=int(start),
                         count=int(count), p=float(p),
                         args=tuple(sorted(args.items())))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seeded fault program: the unit the chaos suite runs."""

    name: str
    faults: Tuple[FaultSpec, ...]
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))


class FaultAction:
    """What :func:`fire` hands back to a directive-interpreting seam."""

    __slots__ = ("kind", "args", "rng")

    def __init__(self, kind: str, args: Dict[str, Any],
                 rng: np.random.Generator) -> None:
        self.kind = kind
        self.args = args
        self.rng = rng  # the spec's own stream, for e.g. lane choice

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultAction({self.kind!r}, {self.args!r})"


class _SpecState:
    """Per-spec mutable state: hit counter, fire counter, RNG."""

    __slots__ = ("spec", "hits", "fires", "rng")

    def __init__(self, spec: FaultSpec, seed: int) -> None:
        self.spec = spec
        self.hits = 0
        self.fires = 0
        # Seeded from (scenario seed, seam, kind, start): the stream is
        # a function of the rule's identity alone, so concurrent seams
        # cannot perturb each other's draw sequences.
        self.rng = np.random.default_rng(
            np.random.SeedSequence(
                [seed, _stable_hash(spec.seam), _stable_hash(spec.kind),
                 spec.start]))


def _stable_hash(s: str) -> int:
    """Deterministic across processes (builtin hash() is salted)."""
    h = 2166136261
    for ch in s.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


class FaultInjector:
    """One scenario's live state. Thread-safe; optional metrics/events
    hooks so every injected fault is a counter bump
    (``faults_injected``) and a ``fault_injected`` event next to the
    recovery it is supposed to trigger."""

    def __init__(self, scenario: Scenario, metrics=None,
                 events=None) -> None:
        self.scenario = scenario
        self.metrics = metrics
        self.events = events
        self._lock = threading.Lock()
        self._states: Dict[str, List[_SpecState]] = {}  # guarded-by: self._lock
        for spec in scenario.faults:
            self._states.setdefault(spec.seam, []).append(
                _SpecState(spec, scenario.seed))
        self._log: List[Dict[str, Any]] = []            # guarded-by: self._lock

    # -- seam side ----------------------------------------------------

    def fire(self, seam: str, **ctx) -> Optional[FaultAction]:
        """Consult the scenario at one seam hit. Raising kinds
        (``device_lost``, ``crash``) raise; directive kinds return a
        :class:`FaultAction` the seam interprets; a quiet hit returns
        None. At most one rule fires per hit (specs are consulted in
        scenario order)."""
        with self._lock:
            states = self._states.get(seam)
            if not states:
                return None
            fired: Optional[_SpecState] = None
            for st in states:
                idx = st.hits
                st.hits += 1
                spec = st.spec
                if fired is not None or idx < spec.start \
                        or st.fires >= spec.count:
                    continue
                if spec.p < 1.0 and st.rng.random() >= spec.p:
                    continue
                st.fires += 1
                fired = st
            if fired is None:
                return None
            spec = fired.spec
            self._log.append({"seam": seam, "kind": spec.kind,
                              "hit": fired.hits - 1, **ctx})
        # Hooks run outside the injector lock: emit/inc take their own.
        if self.metrics is not None:
            self.metrics.inc("faults_injected")
        if self.events is not None:
            reserved = ("kind", "fault_kind", "severity", "trace_id",
                        "seam", "scenario", "t")
            self.events.emit("fault_injected", "warn", seam=seam,
                             fault_kind=spec.kind,
                             scenario=self.scenario.name,
                             **{k: v for k, v in ctx.items()
                                if k not in reserved
                                and isinstance(v, (str, int, float, bool))})
        if spec.kind == "device_lost":
            raise InjectedFault(
                f"injected device loss at {seam} "
                f"(scenario {self.scenario.name!r})")
        if spec.kind == "crash":
            raise InjectedCrash(
                f"injected crash at {seam} "
                f"(scenario {self.scenario.name!r})")
        return FaultAction(spec.kind, dict(spec.args), fired.rng)

    # -- readers ------------------------------------------------------

    def log(self) -> List[Dict[str, Any]]:
        """Every fault fired so far (deterministic replay record)."""
        with self._lock:
            return list(self._log)

    def fires(self, seam: Optional[str] = None) -> int:
        with self._lock:
            return sum(st.fires for s, sts in self._states.items()
                       if seam is None or s == seam for st in sts)

    def exhausted(self) -> bool:
        """Every rule has fired its full count (the scenario's induced-
        failure window is over; recovery invariants may be asserted)."""
        with self._lock:
            return all(st.fires >= st.spec.count
                       for sts in self._states.values() for st in sts)


# ---------------------------------------------------------------------------
# process-global install point (the seams' single predicate)
# ---------------------------------------------------------------------------

_INJECTOR: Optional[FaultInjector] = None
_install_lock = threading.Lock()


def enabled() -> bool:
    """The seam predicate: True iff an injector is installed. One
    module-global read — the entire disabled-path cost."""
    return _INJECTOR is not None


def install(injector: FaultInjector) -> FaultInjector:
    """Install the process-global injector (exclusive: installing over
    a live one raises — two scenarios sharing seams would destroy both
    scenarios' determinism)."""
    global _INJECTOR
    with _install_lock:
        if _INJECTOR is not None:
            raise RuntimeError(
                f"a fault injector is already installed (scenario "
                f"{_INJECTOR.scenario.name!r}); uninstall() it first")
        _INJECTOR = injector
    return injector


def uninstall() -> None:
    global _INJECTOR
    with _install_lock:
        _INJECTOR = None


def fire(seam: str, **ctx) -> Optional[FaultAction]:
    """Module-level seam entry: delegates to the installed injector.
    Callers guard it with ``if faults.enabled():``; the injector
    reference is re-read here, so a concurrent uninstall degrades to a
    no-op rather than an AttributeError."""
    inj = _INJECTOR
    if inj is None:
        return None
    return inj.fire(seam, **ctx)


def corrupt_feed(qp, action: FaultAction):
    """Apply a ``feed_corrupt`` directive to one request: NaN the
    first ``lanes`` entries (default 1) of the objective vector of a
    copy of the problem's tensors, and return the poisoned problem."""
    bad_q = qp.q.clone()
    bad_q[: max(int(action.args.get("lanes", 1)), 1)] = float("nan")
    return qp._replace(q=bad_q)


@contextlib.contextmanager
def active(scenario: Scenario, metrics=None, events=None):
    """``with faults.active(scenario) as inj:`` — install for the
    block, uninstall on exit (exception-safe; the chaos suite's and
    the tests' entry point)."""
    inj = install(FaultInjector(scenario, metrics=metrics, events=events))
    try:
        yield inj
    finally:
        uninstall()


# ---------------------------------------------------------------------------
# injectable clock
# ---------------------------------------------------------------------------

class FaultClock:
    """A steppable monotonic clock for deterministic replay of time-
    dependent recovery paths (breaker re-close, deadline give-up).
    Thread-safe; call it like ``time.monotonic``."""

    def __init__(self, start: float = 0.0) -> None:
        self._lock = threading.Lock()
        self._now = float(start)   # guarded-by: self._lock

    def __call__(self) -> float:
        with self._lock:
            return self._now

    def advance(self, seconds: float) -> float:
        """Step time forward; returns the new now."""
        with self._lock:
            self._now += float(seconds)
            return self._now


# ---------------------------------------------------------------------------
# builtin scenario catalog (the chaos suite's degradation matrix)
# ---------------------------------------------------------------------------

def builtin_scenarios(seed: int = 0) -> Dict[str, Scenario]:
    """The JAX package's named scenario grid (its chaos suite's
    degradation matrix), the same rules and seeds. Counts are small and
    bounded on purpose: every scenario has a failure window that
    closes."""
    mk = FaultSpec.make
    return {
        # Two consecutive dispatch losses: exactly the breaker's
        # failure_threshold default, so the scenario proves open →
        # fallback-retry → (probe ok) → re-close.
        "device_lost": Scenario("device_lost", (
            mk("serve.dispatch", "device_lost", count=2),
            mk("serve.continuous", "device_lost", count=2),
        ), seed=seed),
        # The black-hole probe: probes fail (as timeouts do) until the
        # window closes, then the primary answers again.
        "probe_blackhole": Scenario("probe_blackhole", (
            mk("health.probe", "probe_fail", count=3),
        ), seed=seed),
        # Corrupt result lanes: the zero-wrong-answers invariant's
        # sharpest test — validation must catch every one.
        "nan_lanes": Scenario("nan_lanes", (
            mk("serve.result", "nan_lanes", count=3, lanes=2),
        ), seed=seed),
        # Post-warmup compile storm: evict executables mid-traffic.
        "compile_storm": Scenario("compile_storm", (
            mk("cache.get", "compile_storm", start=1, count=3),
        ), seed=seed),
        # Admission stalls age the queue into deadline territory.
        "queue_stall": Scenario("queue_stall", (
            mk("serve.admission", "queue_stall", count=4, stall_s=0.05),
        ), seed=seed),
        # Submitter clock running ahead: deadlines arrive pre-aged.
        "clock_skew": Scenario("clock_skew", (
            mk("serve.admission", "clock_skew", count=4, p=0.5,
               skew_s=30.0),
        ), seed=seed),
        # Poisoned feed data: the request must FAIL, never mis-answer.
        "feed_corrupt": Scenario("feed_corrupt", (
            mk("data.feed", "feed_corrupt", count=2),
        ), seed=seed),
    }
