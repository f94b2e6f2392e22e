"""Resilience: deterministic fault injection and request-level
recovery (the port of ``porqua_tpu/resilience``).

:mod:`porqua_tpu_torch.resilience.faults` is a host copy of the JAX
package's seeded :class:`FaultInjector` and its scenario DSL; the
checkpointed backtests fire its ``backtest.chunk`` seam and the service
its ``serve.*`` seams. :mod:`porqua_tpu_torch.resilience.retry` is the
recovery layer over the service (``RetryPolicy``, ``RetryManager``,
``validate_result``): retries resubmit through the service's breaker,
which moves work to a CPU only when the caller named it as fallback.
"""

from porqua_tpu_torch.resilience.faults import (
    FaultAction,
    FaultClock,
    FaultInjector,
    FaultSpec,
    InjectedCrash,
    InjectedFault,
    Scenario,
    builtin_scenarios,
)
_RETRY_NAMES = ("RetryManager", "RetryPolicy", "validate_result")


def __getattr__(name):
    # retry.py imports the serve stack, and the serve stack imports
    # `faults` for its seams: loading retry lazily keeps this package
    # importable from inside a serve module's own import (no cycle).
    if name in _RETRY_NAMES:
        import importlib

        mod = importlib.import_module("porqua_tpu_torch.resilience.retry")
        return getattr(mod, name)
    raise AttributeError(name)


__all__ = [
    "FaultAction",
    "FaultClock",
    "FaultInjector",
    "FaultSpec",
    "InjectedCrash",
    "InjectedFault",
    "RetryManager",
    "RetryPolicy",
    "Scenario",
    "builtin_scenarios",
    "validate_result",
]
