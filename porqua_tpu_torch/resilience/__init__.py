"""Resilience: deterministic fault injection (the port of
``porqua_tpu/resilience``, in part).

:mod:`porqua_tpu_torch.resilience.faults` is a host copy of the JAX
package's seeded :class:`FaultInjector` and its scenario DSL; the
checkpointed backtests of :mod:`porqua_tpu_torch.checkpoint` fire its
``backtest.chunk`` seam. The recovery side (``retry.py``:
``RetryPolicy``, ``RetryManager``, ``validate_result``) needs the serve
stack and is not ported yet: those names raise ``NotImplementedError``.
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
    if name in _RETRY_NAMES:
        raise NotImplementedError(
            f"porqua_tpu_torch.resilience.{name} (resilience/retry.py) is "
            "not ported to PyTorch yet (ROADMAP queue A, item 17)")
    raise AttributeError(name)


__all__ = [
    "FaultAction",
    "FaultClock",
    "FaultInjector",
    "FaultSpec",
    "InjectedCrash",
    "InjectedFault",
    "Scenario",
    "builtin_scenarios",
]
