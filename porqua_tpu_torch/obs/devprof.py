"""Device-cost plane: CostRecords of the port's compiled entries, the
CostRecord warehouse and the measured roofline (the port of
``porqua_tpu/obs/devprof.py``).

The JAX package reads what one compiled XLA executable costs from the
compiler (``cost_analysis``/``memory_analysis``). The port has no XLA
executable: what it compiles is an entry of
:func:`porqua_tpu_torch.qp.solve.aot_compile_batch` or
:func:`~porqua_tpu_torch.qp.solve.aot_compile_continuous`, a closure
bound to a shape and a device that runs once on a neutral cohort. That
warm-up call is what a CostRecord measures here: :func:`count_call`
runs it under a ``TorchDispatchMode`` counter and fills the JAX
package's schema (``COST_SCHEMA_VERSION`` 1, the same field names, so
every reader works on both packages' files):

* ``flops``: ``torch.utils.flop_counter``'s formula for each aten op
  it has one for (matrix products; elementwise ops, factorizations and
  triangular solves count 0), plus each hand-kernel launch's
  :func:`porqua_tpu_torch.ops.admm_kernel.launch_cost`;
* ``bytes_accessed``: each aten op's tensor inputs read once and its
  outputs written once, XLA's own definition of bytes accessed (views
  and bare allocations move nothing and count 0), plus each launch's
  bytes;
* ``kernel_flops``/``kernel_bytes``: the hand-kernel part of both,
  ``kernel_launches`` by kernel and form, ``segments`` (the segments
  the warm-up ran: the host segment loop runs as many as the neutral
  cohort needs, so the counts are stable for a fixed entry but are not
  per-dispatch truth) and ``cost_source: "torch"``;
* ``peak_bytes``: on ``cuda``, ``torch.cuda.max_memory_allocated``
  over the warm-up after ``reset_peak_memory_stats``, less what was
  allocated before it, plus the arguments already on the card;
  ``argument_bytes``/``output_bytes`` from the tensors, ``temp_bytes``
  the peak less both. The allocator's peak is process-wide: a compile
  during serving (another thread dispatching) reads an upper bound;
  the prewarm is serial, so its records are exact. On the CPU the
  memory fields are ``None``; ``alias_bytes`` and
  ``generated_code_bytes`` have no counterpart and are always
  ``None``;
* ``hlo_hash``: the counterpart of the HLO fingerprint, a blake2b
  digest of the counted call's op sequence (each aten op's name with
  its inputs' shapes and dtypes, each kernel launch by name and form).
  It names the program the port ran on the neutral cohort.

:class:`CostLog`, :func:`load_cost_records`, :func:`write_cost_records`,
:func:`measured_rates`, :data:`ENTRY_STAGES` and :func:`roofline_verdict`
are the JAX package's. :class:`ProfileWindow` is a timer-bounded
``torch.profiler`` trace. With no counter active (the plane off) every
hook here returns at once: a solve runs the code it runs without the
plane, and the served answers are the same bits.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import gzip
import hashlib
import json
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import torch

from porqua_tpu_torch.analysis import tsan

__all__ = [
    "COST_SCHEMA_VERSION",
    "CostLog",
    "CountedCall",
    "ENTRY_STAGES",
    "ProfileWindow",
    "cost_record",
    "count_call",
    "executable_cost",
    "executable_memory",
    "harvest_warmups",
    "hlo_fingerprint",
    "load_cost_records",
    "measured_rates",
    "roofline_verdict",
    "warmup_call",
    "write_cost_records",
]

#: Bump when a field changes meaning; additive fields don't need it.
COST_SCHEMA_VERSION = 1

# The counter of the calling thread's counted call (None: plane off).
_COUNTER: contextvars.ContextVar = contextvars.ContextVar(
    "porqua_devprof_counter", default=None)
# entry -> CountedCall of the calling thread's harvesting build.
_SESSION: contextvars.ContextVar = contextvars.ContextVar(
    "porqua_devprof_session", default=None)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CountedCall:
    """What one counted call cost (see the module docstring)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    segments: int = 0
    op_hash: Optional[str] = None
    argument_bytes: Optional[float] = None
    output_bytes: Optional[float] = None
    peak_bytes: Optional[float] = None


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


_Tensor = torch.Tensor


def _flat_tensors(args, kwargs) -> list:
    """The tensor arguments of one aten call (top level, and one level
    into lists: aten signatures nest no deeper)."""
    out = []
    for a in (*args, *kwargs.values()) if kwargs else args:
        if isinstance(a, _Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend([b for b in a if isinstance(b, _Tensor)])
    return out


class _Counter:
    """Accumulates one counted call (ops, launches, segments)."""

    # Allocations and the view ops aten does not mark as views move no
    # bytes (XLA counts none for a buffer or a bitcast).
    _NO_TRAFFIC = ("aten::empty", "aten::empty_like", "aten::empty_strided",
                   "aten::new_empty", "aten::new_empty_strided",
                   "aten::_unsafe_view", "aten::_reshape_alias")

    def __init__(self) -> None:
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.call = CountedCall()
        # func -> (flop formula or None, moves bytes)
        self._kinds: Dict[Any, tuple] = {}
        # The op sequence, hashed at the end: (name, input signatures).
        self.seq: List[tuple] = []

    def _kind(self, func) -> tuple:
        kind = self._kinds.get(func)
        if kind is None:
            kind = (self.registry.get(func._overloadpacket),
                    not (func.is_view or func._schema.name in self._NO_TRAFFIC))
            self._kinds[func] = kind
        return kind

    def op(self, func, args, kwargs, out) -> None:
        c = self.call
        ins = _flat_tensors(args, kwargs)
        sig = []
        nbytes = 0
        for t in ins:
            sig.append(t.dtype)
            sig.append(t.shape)
            nbytes += t.nbytes
        self.seq.append((func, tuple(sig)))
        formula, moves = self._kind(func)
        if formula is not None:
            c.flops += float(formula(*args, **kwargs, out_val=out))
        if moves:
            if isinstance(out, _Tensor):
                nbytes += out.nbytes
            elif isinstance(out, (list, tuple)):
                for t in out:
                    if isinstance(t, _Tensor):
                        nbytes += t.nbytes
            c.bytes_accessed += nbytes

    def kernel(self, name: str, form: str, flops: float,
               nbytes: float) -> None:
        c = self.call
        key = f"{name}/{form}"
        c.kernel_launches[key] = c.kernel_launches.get(key, 0) + 1
        c.kernel_flops += float(flops)
        c.kernel_bytes += float(nbytes)
        c.flops += float(flops)
        c.bytes_accessed += float(nbytes)
        self.seq.append((f"kernel:{key}", ()))

    def digest(self) -> Optional[str]:
        """blake2b of the op sequence: each op's name with its inputs'
        dtypes and shapes, each launch by kernel and form."""
        if not self.seq:
            return None
        h = hashlib.blake2b(digest_size=8)
        memo: Dict[tuple, bytes] = {}
        for entry in self.seq:
            text = memo.get(entry)
            if text is None:
                name, sig = entry
                text = (f"{name}(" + ",".join(
                    f"{str(d).replace('torch.', '')}{list(s)}"
                    for d, s in zip(sig[::2], sig[1::2])) + ");").encode()
                memo[entry] = text
            h.update(text)
        return h.hexdigest()


def _mode(counter: _Counter):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _CountingMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            counter.op(func, args, kwargs, out)
            return out

    return _CountingMode()


def active_counter() -> Optional[_Counter]:
    """The calling thread's active counter, or None (plane off)."""
    return _COUNTER.get()


def note_segment() -> None:
    """One segment of the host segment loop ran (no-op unless a counted
    call is running on this thread)."""
    counter = _COUNTER.get()
    if counter is not None:
        counter.call.segments += 1


def count_call(fn, *args, device=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the counter; returns
    ``(output, CountedCall)``. The ops run as they would without it
    (same kernels, same arguments), so the output is the same bits.
    On a card (``device``, else the first CUDA argument's) the call is
    synchronised and its peak device memory measured (see the module
    docstring)."""
    counter = _Counter()
    c = counter.call
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        dev = next((t.device for t in _leaves((args, kwargs))
                    if t.is_cuda), None)
    if dev is not None and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    token = _COUNTER.set(counter)
    try:
        if dev is not None:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        with _mode(counter):
            out = fn(*args, **kwargs)
        if dev is not None:
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - before
    finally:
        _COUNTER.reset(token)
    c.op_hash = counter.digest()
    if dev is not None:
        ins = list(_leaves((args, kwargs)))
        c.argument_bytes = float(sum(t.nbytes for t in ins))
        c.output_bytes = float(sum(t.nbytes for t in _leaves(out)))
        resident = sum(t.nbytes for t in ins if t.device == dev)
        c.peak_bytes = float(peak + resident)
    return out, c


@contextlib.contextmanager
def harvest_warmups():
    """Count every entry warm-up (:func:`warmup_call`) run by this
    thread inside the block; yields the dict ``entry -> CountedCall``
    they fill (the executable cache wraps each build in it while its
    cost plane is on)."""
    calls: Dict[str, CountedCall] = {}
    token = _SESSION.set(calls)
    try:
        yield calls
    finally:
        _SESSION.reset(token)


def warmup_call(entry: str, fn, *args, device=None):
    """``fn(*args)``, an entry's warm-up on ``device``: counted under
    ``entry`` inside :func:`harvest_warmups`, run bare otherwise."""
    calls = _SESSION.get()
    if calls is None:
        return fn(*args)
    out, counted = count_call(fn, *args, device=device)
    calls[entry] = counted
    return out


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def executable_cost(counted) -> Dict[str, Optional[float]]:
    """Flops and bytes accessed of one counted call; ``None`` values
    for anything that is not a :class:`CountedCall`. Never raises."""
    try:
        return {"flops": float(counted.flops),
                "bytes_accessed": float(counted.bytes_accessed)}
    except Exception:  # noqa: BLE001 - analysis must never fail a compile
        return {"flops": None, "bytes_accessed": None}


def executable_memory(counted) -> Dict[str, Optional[float]]:
    """Argument / output / temp / peak bytes of one counted call on the
    card (``temp_bytes`` = peak less arguments and outputs, floored at
    0); ``alias_bytes`` and ``generated_code_bytes`` have no
    counterpart and are ``None``, as is every field for a call on the
    CPU or a refused analysis. Never raises."""
    try:
        peak = counted.peak_bytes
        out: Dict[str, Optional[float]] = {
            "argument_bytes": counted.argument_bytes,
            "output_bytes": counted.output_bytes,
            "temp_bytes": None,
            "alias_bytes": None,
            "generated_code_bytes": None,
            "peak_bytes": peak,
        }
        if peak is not None:
            out["temp_bytes"] = max(
                float(peak) - float(counted.argument_bytes or 0.0)
                - float(counted.output_bytes or 0.0), 0.0)
        return out
    except Exception:  # noqa: BLE001 - analysis must never fail a compile
        return {"peak_bytes": None}


def hlo_fingerprint(counted) -> Optional[str]:
    """The op-sequence digest of one counted call (the program the port
    ran on the neutral cohort), or ``None``. Never raises."""
    try:
        return counted.op_hash
    except Exception:  # noqa: BLE001 - fingerprinting is best-effort
        return None


def cost_record(counted,
                entry: str,
                kind: str,
                bucket: Optional[str] = None,
                slots: Optional[int] = None,
                dtype: Optional[str] = None,
                device: Optional[str] = None,
                compile_s: Optional[float] = None,
                **extra) -> Dict[str, Any]:
    """One CostRecord dict from a counted call (the schema's single
    constructor). Never raises: refusals land as ``None`` fields."""
    rec: Dict[str, Any] = {
        "v": COST_SCHEMA_VERSION,
        "t": time.time(),
        "kind": str(kind),
        "entry": str(entry),
    }
    if bucket is not None:
        rec["bucket"] = str(bucket)
    if slots is not None:
        rec["slots"] = int(slots)
    if dtype is not None:
        rec["dtype"] = str(dtype)
    if device is not None:
        rec["device"] = str(device)
    if compile_s is not None:
        rec["compile_s"] = float(compile_s)
    rec.update(executable_cost(counted))
    rec.update(executable_memory(counted))
    rec["hlo_hash"] = hlo_fingerprint(counted)
    for field in ("kernel_flops", "kernel_bytes", "segments"):
        rec[field] = getattr(counted, field, None)
    rec["kernel_launches"] = dict(getattr(counted, "kernel_launches",
                                          None) or {})
    rec["cost_source"] = "torch"
    rec.update(extra)
    return rec


class CostLog:
    """Thread-safe append-only CostRecord warehouse (JSONL, ``.gz``
    transparently gzipped; ``path=None`` keeps a bounded in-memory
    buffer). ``emit`` never raises: it runs on the compile path, and a
    dead disk degrades to ``write_failures``, not failed compiles.
    ``append=False`` truncates an existing file."""

    def __init__(self, path: Optional[str] = None,
                 buffer_capacity: int = 4096,
                 append: bool = True) -> None:
        self.path = path
        self._lock = tsan.lock("CostLog")
        self._records = 0                 # guarded-by: self._lock
        self._write_failures = 0          # guarded-by: self._lock
        self._buffer_capacity = int(buffer_capacity)
        self._buffer: List[Dict[str, Any]] = []  # guarded-by: self._lock
        self._sink = None                 # guarded-by: self._lock
        if path is not None:
            mode = "at" if append else "wt"
            try:
                self._sink = (gzip.open(path, mode)
                              if str(path).endswith(".gz")
                              else open(path, mode[0]))
            except OSError:
                self._write_failures += 1

    def emit(self, record: Dict[str, Any]) -> None:
        """Append one record; never raises (see class docstring)."""
        line = (json.dumps(record, default=str)
                if self._sink is not None else None)
        with self._lock:
            self._records += 1
            if self._sink is not None and line is not None:
                try:
                    self._sink.write(line + "\n")
                except (OSError, ValueError):
                    self._write_failures += 1
                    self._sink = None  # dead sink: keep compiling
            elif len(self._buffer) < self._buffer_capacity:
                self._buffer.append(record)

    @property
    def records(self) -> int:
        with self._lock:
            return self._records

    @property
    def write_failures(self) -> int:
        with self._lock:
            return self._write_failures

    def buffered(self) -> List[Dict[str, Any]]:
        """In-memory records (``path=None`` logs only)."""
        with self._lock:
            return list(self._buffer)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"cost_records": self._records,
                    "cost_write_failures": self._write_failures}

    def flush(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.flush()
                except OSError:
                    self._write_failures += 1
                    self._sink = None

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    self._write_failures += 1
                self._sink = None

    def __enter__(self) -> "CostLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_cost_records(path: str) -> List[Dict[str, Any]]:
    """Read a CostRecord dataset back (JSONL, ``.gz`` transparently)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    out: List[Dict[str, Any]] = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_cost_records(path: str,
                       records: Iterable[Dict[str, Any]]) -> int:
    """Dump CostRecords as JSONL(.gz); returns the count. A one-shot
    export (``run_loadgen(cost_out=...)``), so the file is truncated."""
    n = 0
    with CostLog(path, append=False) as log:
        for rec in records:
            log.emit(rec)
            n += 1
    return n


def measured_rates(record: Dict[str, Any],
                   seconds: Optional[float] = None,
                   model_flops: Optional[float] = None,
                   model_bytes: Optional[float] = None
                   ) -> Dict[str, float]:
    """Achieved rates + model-drift ratios for one CostRecord, shared
    by :func:`porqua_tpu_torch.obs.profile.qp_solve_profile`. ``seconds``
    enables ``achieved_tflops``/``achieved_hbm_gbps``; ``model_flops``/
    ``model_bytes`` (the analytic figures) the ``*_model_ratio`` drift
    metrics. Fields appear only when both sides of their division
    exist."""
    out: Dict[str, float] = {}
    flops = record.get("flops")
    bytes_acc = record.get("bytes_accessed")
    if seconds and seconds > 0:
        if flops:
            out["achieved_tflops"] = flops / seconds / 1e12
        if bytes_acc:
            out["achieved_hbm_gbps"] = bytes_acc / seconds / 1e9
    if flops and model_flops is not None:
        out["flops_model_ratio"] = float(model_flops) / flops
    if bytes_acc and model_bytes is not None:
        out["bytes_model_ratio"] = float(model_bytes) / bytes_acc
    return out


# ---------------------------------------------------------------------------
# bounded programmatic profiler window
# ---------------------------------------------------------------------------

class ProfileWindow:
    """A bounded ``torch.profiler`` trace (CPU, and CUDA activity where
    a card is present), written as a Chrome trace into ``logdir``
    (:attr:`trace_file`).

    :meth:`start` opens the trace on a thread of its own, which closes
    it after ``window_s`` seconds (its timer) or when :meth:`stop` asks,
    whichever comes first: the profiler is started and stopped on the
    same thread, as ``torch.profiler`` requires. :meth:`stop` waits for
    the trace to be written and is idempotent (whichever of the timer
    and the caller's teardown comes second is a no-op). States:
    ``idle``, ``tracing``, then ``stopped`` or ``failed``;
    :attr:`stopped_by` says whether the ``timer`` or the ``caller``
    closed the window. Failures never propagate: profiling a run must
    not fail it (``error`` carries the first one). CUDA activity is
    recorded from every thread; CPU ops only where the installed torch
    records other threads' ops."""

    def __init__(self, logdir: str, window_s: Optional[float] = None) -> None:
        self.logdir = str(logdir)
        self.window_s = None if window_s is None else float(window_s)
        self._lock = tsan.lock("ProfileWindow")
        self._state = "idle"              # guarded-by: self._lock
        self._error: Optional[str] = None  # guarded-by: self._lock
        self._trace_file: Optional[str] = None  # guarded-by: self._lock
        self._stopped_by: Optional[str] = None  # guarded-by: self._lock
        self._stop = threading.Event()
        self._done = threading.Event()

    def _note_error(self, exc: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = f"{type(exc).__name__}: {exc}"

    def _finish(self, state: str, by: Optional[str] = None,
                path: Optional[str] = None) -> None:
        with self._lock:
            self._state = state
            self._stopped_by = by
            self._trace_file = path
        self._done.set()

    def _run(self, started: threading.Event) -> None:
        try:
            from porqua_tpu_torch.profiling import (profiler_activities,
                                                    trace_path)

            prof = torch.profiler.profile(activities=profiler_activities())
            prof.start()
        except Exception as exc:  # noqa: BLE001 - best-effort capture
            self._note_error(exc)
            self._finish("failed")
            started.set()
            return
        started.set()
        by = "caller" if self._stop.wait(self.window_s) else "timer"
        try:
            prof.stop()
            path = trace_path(self.logdir)
            prof.export_chrome_trace(path)
        except Exception as exc:  # noqa: BLE001 - best-effort capture
            self._note_error(exc)
            self._finish("failed", by)
            return
        self._finish("stopped", by, path)

    def start(self) -> bool:
        with self._lock:
            if self._state != "idle":
                return False
            self._state = "tracing"
        started = threading.Event()
        threading.Thread(target=self._run, args=(started,), daemon=True,
                         name="porqua-profile-window").start()
        started.wait()
        return self.state == "tracing"

    def stop(self) -> bool:
        """Close the window (if it is still open) and wait for its trace;
        True if this call closed it."""
        with self._lock:
            if self._state == "idle":
                return False
            first = not self._stop.is_set()
            self._stop.set()
        self._done.wait()
        with self._lock:
            return (first and self._stopped_by == "caller"
                    and self._state == "stopped")

    @property
    def error(self) -> Optional[str]:
        with self._lock:
            return self._error

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def stopped_by(self) -> Optional[str]:
        """``"timer"`` or ``"caller"`` once the window closed."""
        with self._lock:
            return self._stopped_by

    @property
    def trace_file(self) -> Optional[str]:
        """The Chrome trace the stopped window wrote, or ``None``."""
        with self._lock:
            return self._trace_file


# ---------------------------------------------------------------------------
# the roofline verdict
# ---------------------------------------------------------------------------

#: CostRecord ``entry`` -> the StageProfiler stage(s) whose measured
#: seconds describe dispatches of that entry (the join key between the
#: cost warehouse and a loadgen run's ``profile_stages``).
ENTRY_STAGES = {
    "solve": ("serve/solve_batch",),
    "admit": ("serve/admit",),
    "step": ("serve/segment_step", "segment_step"),
    "finalize": ("serve/finalize", "finalize"),
    "init": ("init",),
    "tracking_step": ("solve",),
}


def _identity(rec: Dict[str, Any]) -> tuple:
    return (rec.get("kind"), rec.get("entry"), rec.get("bucket"),
            rec.get("slots"), rec.get("dtype"), rec.get("device"))


def roofline_verdict(records: Iterable[Dict[str, Any]],
                     stage_seconds: Optional[Dict[str, float]] = None,
                     top: int = 5,
                     device_kind: str = "") -> Dict[str, Any]:
    """Rank entries by measured bytes and emit fusion targets.

    ``records`` is a CostRecord stream (the latest record per (kind,
    entry, bucket, slots, dtype, device) identity wins);
    ``stage_seconds`` a run's measured per-stage host seconds, joined
    per entry through :data:`ENTRY_STAGES`. Each ranked row carries
    arithmetic intensity (flops per byte accessed); with a card
    :func:`porqua_tpu_torch.profiling.device_peaks` knows, the row is
    classified against the ridge point (peak flops over peak
    bandwidth), otherwise intensity alone is reported. The verdict's
    ``fusion_candidates`` are the ``top`` rows by measured bytes."""
    from porqua_tpu_torch.profiling import device_peaks

    latest: Dict[tuple, Dict[str, Any]] = {}
    total_in = 0
    for rec in records:
        total_in += 1
        latest[_identity(rec)] = rec

    peak_flops, peak_bw = device_peaks(device_kind)
    ridge = (peak_flops / peak_bw) if peak_flops and peak_bw else None

    rows: List[Dict[str, Any]] = []
    for rec in latest.values():
        flops = rec.get("flops")
        bytes_acc = rec.get("bytes_accessed")
        row: Dict[str, Any] = {
            "kind": rec.get("kind"),
            "entry": rec.get("entry"),
            "bucket": rec.get("bucket"),
            "slots": rec.get("slots"),
            "device": rec.get("device"),
            "flops": flops,
            "bytes_accessed": bytes_acc,
            "peak_bytes": rec.get("peak_bytes"),
            "hlo_hash": rec.get("hlo_hash"),
        }
        if flops and bytes_acc:
            row["arithmetic_intensity"] = flops / bytes_acc
            if ridge is not None:
                row["bound"] = ("memory"
                                if row["arithmetic_intensity"] < ridge
                                else "compute")
        stages = {}
        for stage in ENTRY_STAGES.get(str(rec.get("entry")), ()):
            if stage_seconds and stage in stage_seconds:
                stages[stage] = float(stage_seconds[stage])
        if stages:
            row["stage_seconds"] = stages
            secs = sum(stages.values())
            if bytes_acc and secs > 0:
                # A floor, not a rate: one dispatch's bytes over the
                # stage's total seconds (every dispatch of the entry).
                row["min_achieved_gbps"] = bytes_acc / secs / 1e9
        rows.append(row)

    rows.sort(key=lambda r: (r.get("bytes_accessed") or 0.0),
              reverse=True)
    for i, row in enumerate(rows):
        row["rank"] = i + 1

    candidates = [r for r in rows if r.get("bytes_accessed")]
    if ridge is not None:
        mem_bound = [r for r in candidates if r.get("bound") == "memory"]
        if mem_bound:
            candidates = mem_bound
    candidates = candidates[:max(int(top), 0)]

    stages_ranked = []
    if stage_seconds:
        stages_ranked = sorted(
            ({"stage": k, "seconds": float(v)}
             for k, v in stage_seconds.items()),
            key=lambda s: s["seconds"], reverse=True)

    verdict: Dict[str, Any] = {
        "v": COST_SCHEMA_VERSION,
        "t": time.time(),
        "records_in": total_in,
        "executables": len(rows),
        "device_kind": device_kind or None,
        "ridge_flops_per_byte": ridge,
        "ranked": rows,
        "stages_ranked": stages_ranked,
        "fusion_candidates": [
            {"kind": r.get("kind"), "entry": r.get("entry"),
             "bucket": r.get("bucket"), "slots": r.get("slots"),
             "bytes_accessed": r.get("bytes_accessed"),
             "arithmetic_intensity": r.get("arithmetic_intensity"),
             "bound": r.get("bound"),
             "reason": ("largest measured byte traffic"
                        + ("" if r.get("bound") != "memory"
                           else " and memory-bound at this chip's "
                                "ridge point"))}
            for r in candidates],
    }
    verdict["verdict"] = (
        "no executables with measured bytes — harvest CostRecords first"
        if not candidates else
        f"top fusion target: {candidates[0].get('entry')} "
        f"{candidates[0].get('bucket')} x{candidates[0].get('slots')} "
        f"({(candidates[0].get('bytes_accessed') or 0) / 1e6:.1f} MB "
        f"accessed per dispatch)")
    return verdict
