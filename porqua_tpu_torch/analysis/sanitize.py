"""Runtime sanitizer mode (``PORQUA_SANITIZE=1``), the port of the JAX
package's ``analysis/sanitize.py``.

**No implicit host<->device transfers in solver hot paths.** Under
sanitize mode the batched-solve dispatch sites wrap the device call in
:func:`transfer_guard`, the counterpart of
``jax.transfer_guard("disallow")``: a ``TorchDispatchMode`` that raises
:class:`SanitizerError` on

* a copy between devices (``aten._to_copy`` to another device,
  ``aten.copy_`` from another device): a stray host tensor reaching the
  dispatch, or a hidden fetch of a result;
* a host read of a tensor's value (``aten._local_scalar_dense``:
  ``.item()``, ``bool()``, ``int()`` or ``float()`` of a tensor), which
  syncs the host with the device;
* an op whose operands lie on different devices, apart from 0-dim CPU
  scalars (what a stray numpy array or host tensor inside the hot path
  looks like where no copy is dispatched).

A transfer the code means to make is declared with
:func:`explicit_transfer`, the counterpart of ``jax.device_put`` /
``jax.device_get``: the serving batcher's one batch upload, the batched
solve's upload of its problems, and the segment loop's one read per
segment (is any lane still active?). The dispatch mode sees only what
is dispatched: ``torch.as_tensor`` of an ndarray creates a CPU tensor
without dispatch (its later ``.to`` is what the guard sees), and the
hand-written kernels take raw pointers through their bindings, so a
launch is not an op here. With sanitize mode off the guard is not
entered and costs nothing; it nests with any other dispatch mode (the
cost plane's counter, a profiler), each of which sees every op once.

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
"""

from __future__ import annotations

import contextlib
import contextvars
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
    "explicit_transfer",
    "guarded_call",
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


# Depth of explicit_transfer() blocks on the calling thread/context.
_EXPLICIT: contextvars.ContextVar = contextvars.ContextVar(
    "porqua_sanitize_explicit", default=0)


@contextlib.contextmanager
def explicit_transfer():
    """Declare the copies and host reads inside the block intentional
    (the counterpart of ``jax.device_put``/``jax.device_get``): the
    transfer guard lets them through."""
    token = _EXPLICIT.set(_EXPLICIT.get() + 1)
    try:
        yield
    finally:
        _EXPLICIT.reset(token)


def _operand_devices(args, kwargs):
    """The devices of an op's tensor operands, skipping 0-dim CPU
    tensors (scalars every device's kernels take by value)."""
    import torch

    devs = set()
    for a in (*args, *kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor) and not (
                    t.dim() == 0 and t.device.type == "cpu"):
                devs.add(t.device)
    return devs


def _violation(func, args, kwargs):
    """What an op under the guard does wrong, or None."""
    import torch

    name = func._schema.name
    if name == "aten::_local_scalar_dense":
        t = args[0]
        return (f"host read of a tensor's value ({name} on "
                f"{t.device}, shape {tuple(t.shape)}): .item()/bool()/"
                "float() syncs the host with the device")
    if name == "aten::_to_copy":
        target = kwargs.get("device")
        src = args[0].device
        if target is not None and torch.device(target) != src:
            return (f"implicit copy {src} -> {torch.device(target)} "
                    f"({name}, shape {tuple(args[0].shape)})")
        return None
    if name == "aten::copy_":
        dst, src = args[0], args[1]
        if dst.device != src.device:
            return (f"implicit copy {src.device} -> {dst.device} "
                    f"({name}, shape {tuple(src.shape)})")
        return None
    devs = _operand_devices(args, kwargs)
    if len(devs) > 1:
        return (f"operands on several devices ({', '.join(sorted(map(str, devs)))}"
                f") in {name}")
    return None


def _guard_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _TransferGuardMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not _EXPLICIT.get():
                what = _violation(func, args, kwargs)
                if what is not None:
                    raise SanitizerError(
                        f"implicit transfer inside a guarded dispatch: "
                        f"{what}; declare an intended one with "
                        "sanitize.explicit_transfer()")
            return func(*args, **kwargs)

    return _TransferGuardMode()


@contextlib.contextmanager
def transfer_guard(level: str = "disallow"):
    """The transfer guard (see the module docstring) when sanitize mode
    is on; a no-op otherwise. ``level`` is the JAX package's argument;
    the port enforces ``"disallow"`` only."""
    if level != "disallow":
        raise ValueError(f"transfer_guard level {level!r}: the port "
                         "enforces 'disallow' only")
    if not enabled():
        yield
        return
    with _guard_mode():
        yield


def guarded_call(exe, device, *args):
    """One compiled dispatch with the sanitizer's transfer discipline:
    ``exe(*args)`` when sanitize mode is off; under it the arguments'
    tensors are uploaded to ``device`` explicitly (the one intended
    host->device copy) and the call runs inside :func:`transfer_guard`."""
    if not enabled():
        return exe(*args)
    if device is not None:
        with explicit_transfer():
            args = _upload(args, device)
    with transfer_guard():
        return exe(*args)


def _upload(tree, device):
    """Every tensor of nested (named) tuples on ``device``; other leaves
    as they are."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        parts = [_upload(a, device) for a in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


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
