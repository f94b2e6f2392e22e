"""Runtime sanitizer mode (``PORQUA_SANITIZE=1``): the compile
bookkeeping of the JAX package's ``analysis/sanitize.py``.

**Zero steady-state recompiles.** The serving executable cache calls
:func:`note_compile` on every entry it compiles, passing its own
per-cache warmed flag (closed by ``ExecutableCache.prewarm`` /
``SolveService.prewarm``); once closed, any further compile under
sanitize mode raises :class:`SanitizerError`, with the offending shape
in the message. Warmed state is scoped per cache so services cannot
close each other's windows; the module-level counters aggregate
process-wide for reporting.

The counters always run (two integer bumps); only the *raising*
behaviour is gated on the environment variable, so tests can assert on
:func:`compile_count` / :func:`post_warmup_compiles` without enabling
enforcement.

The other half of the JAX package's sanitizer, the guard against
implicit host-device transfers in the dispatch hot path, has no torch
counterpart yet: :func:`transfer_guard` raises under sanitize mode.
"""

from __future__ import annotations

import contextlib
import os
import threading

__all__ = [
    "SanitizerError",
    "enabled",
    "note_compile",
    "warmup_complete",
    "warmed_up",
    "compile_count",
    "post_warmup_compiles",
    "transfer_guard",
    "no_recompile",
    "reset",
]


class SanitizerError(RuntimeError):
    """A device-discipline invariant was violated at runtime."""


_lock = threading.Lock()
_compiles = 0
_post_warmup_compiles = 0
_warmed = False


def enabled() -> bool:
    """Sanitize mode is on (checked per call so tests can toggle)."""
    return os.environ.get("PORQUA_SANITIZE") == "1"


def reset() -> None:
    """Zero the counters and re-open the warmup window (test helper)."""
    global _compiles, _post_warmup_compiles, _warmed
    with _lock:
        _compiles = 0
        _post_warmup_compiles = 0
        _warmed = False


def note_compile(what: str = "",
                 post_warmup: "bool | None" = None) -> None:
    """Record one compile *demand*; raise under sanitize mode
    post-warmup. A refused post-warmup compile (this function raising
    before the compile runs) and a compile that fails both count.

    ``post_warmup`` scopes the warmup decision to the caller's own
    lifecycle (the serving ``ExecutableCache`` passes its per-device
    warmed flag); ``None`` falls back to the process-global flag set by
    :func:`warmup_complete`."""
    global _compiles, _post_warmup_compiles
    with _lock:
        _compiles += 1
        post = _warmed if post_warmup is None else bool(post_warmup)
        if post:
            _post_warmup_compiles += 1
    if post and enabled():
        raise SanitizerError(
            f"compile after warmup{f' ({what})' if what else ''}: the "
            "steady-state serving invariant is zero recompiles — prewarm "
            "the missing shape bucket, or widen the bucket ladder")


def warmup_complete() -> None:
    """Declare warmup over for callers relying on the process-global
    flag (integrations that own a cache pass ``post_warmup``)."""
    global _warmed
    with _lock:
        _warmed = True


def warmed_up() -> bool:
    with _lock:
        return _warmed


def compile_count() -> int:
    """Total compile demands recorded (see :func:`note_compile`)."""
    with _lock:
        return _compiles


def post_warmup_compiles() -> int:
    """Compile demands recorded after warmup (refusals included)."""
    with _lock:
        return _post_warmup_compiles


@contextlib.contextmanager
def transfer_guard(level: str = "disallow"):
    """The JAX package's transfer guard: a no-op when sanitize mode is
    off; under sanitize mode it raises, because no torch counterpart of
    ``jax.transfer_guard`` is ported yet."""
    if enabled():
        from porqua_tpu_torch.batch import _not_ported

        raise _not_ported(
            f"the transfer guard (transfer_guard({level!r}) under "
            "PORQUA_SANITIZE=1)", "item 23")
    yield


@contextlib.contextmanager
def no_recompile(what: str = ""):
    """Assert no compile was demanded inside the block (enforced only
    under sanitize mode; always measured)."""
    before = compile_count()
    yield
    delta = compile_count() - before
    if delta and enabled():
        raise SanitizerError(
            f"{delta} compile demand(s) inside a no-recompile window"
            f"{f' ({what})' if what else ''}")
