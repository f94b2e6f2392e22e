"""Shape buckets + the compiled-entry cache (the port of
``porqua_tpu/serve/bucketing.py``).

Each incoming problem is padded up a small geometric ladder of
``(n_vars, m_rows)`` buckets, and each batch up a power-of-two slot
ladder, so the set of shapes that can reach a solve entry is the finite
product ``rungs x slot-sizes``. Every entry is compiled once per
``(bucket, slots, dtype, device)`` (:func:`qp.solve.aot_compile_batch`,
:func:`qp.solve.aot_compile_continuous`: bound to the shape, its kernel
form resolved, run once on a neutral batch) and cached; steady-state
serving compiles nothing (the ``compiles`` counter after warmup is the
regression signal).

The padding is :func:`porqua_tpu_torch.qp.canonical.pad_qp`, the
neutrality scheme the batched backtest uses, so a padded request solves
to the same solution with zeros in the padding slots.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from porqua_tpu_torch.analysis import sanitize, tsan
from porqua_tpu_torch.obs import devprof
from porqua_tpu_torch.qp.canonical import CanonicalQP, pad_qp
from porqua_tpu_torch.qp.solve import (
    SolverParams,
    aot_compile_batch,
    aot_compile_continuous,
    batch_shape_struct,
)
from porqua_tpu_torch.resilience import faults as _faults

#: Default shape ladder, the JAX package's rungs: n covers the repo's
#: workloads (24-asset MSCI grid -> 32; 500-asset north star -> 512;
#: headroom to 2048) at ratio 2; m is sparser (budget + a handful of
#: linear rows; the lifted turnover form adds 2n).
DEFAULT_N_RUNGS: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048)
DEFAULT_M_RUNGS: Tuple[int, ...] = (8, 32, 128, 512, 2048)


class Bucket(NamedTuple):
    """One shape bucket. ``factor_rows`` is part of the identity: a
    problem carrying the objective factor (``Pf``) runs a different
    entry than a dense one, and factor rows are never padded."""

    n: int
    m: int
    factor_rows: Optional[int] = None


class BucketOverflow(ValueError):
    """The problem exceeds the ladder's largest rung."""


class BucketLadder:
    """Maps a problem's natural shape to its padded bucket."""

    def __init__(self,
                 n_rungs: Sequence[int] = DEFAULT_N_RUNGS,
                 m_rungs: Sequence[int] = DEFAULT_M_RUNGS) -> None:
        if not n_rungs or not m_rungs:
            raise ValueError("ladder needs at least one rung per axis")
        self.n_rungs = tuple(sorted(int(r) for r in n_rungs))
        self.m_rungs = tuple(sorted(int(r) for r in m_rungs))

    @staticmethod
    def _select(rungs: Tuple[int, ...], value: int, axis: str) -> int:
        i = bisect.bisect_left(rungs, value)
        if i == len(rungs):
            raise BucketOverflow(
                f"problem {axis}={value} exceeds the ladder's largest "
                f"rung {rungs[-1]}; extend the ladder explicitly rather "
                f"than letting one request mint an unbounded shape")
        return rungs[i]

    def select(self, qp: CanonicalQP) -> Bucket:
        r = None if qp.Pf is None else int(qp.Pf.shape[-2])
        return Bucket(self._select(self.n_rungs, qp.n, "n_vars"),
                      self._select(self.m_rungs, qp.m, "m_rows"), r)

    def pad(self, qp: CanonicalQP) -> Tuple[Bucket, CanonicalQP]:
        """Select the bucket and pad the problem into it (tensors on
        the problem's device, the host for a request)."""
        bucket = self.select(qp)
        return bucket, pad_qp(qp, bucket.n, bucket.m)


def slot_count(n_requests: int, max_batch: int) -> int:
    """Batch-size ladder: next power of two >= n_requests, capped at
    ``max_batch``. Occupancy >= 50% for every partial batch, about
    log2(max_batch) entries per bucket."""
    if n_requests <= 0:
        raise ValueError("empty batch")
    if n_requests >= max_batch:
        return max_batch
    return min(1 << (n_requests - 1).bit_length(), max_batch)


def slot_ladder(max_batch: int) -> Tuple[int, ...]:
    """Every batch size :func:`slot_count` can produce for a cap."""
    out = []
    s = 1
    while s < max_batch:
        out.append(s)
        s <<= 1
    out.append(max_batch)
    return tuple(out)


class ExecutableCache:
    """(bucket, slots, dtype, device) -> compiled batch-solve entry.

    ``SolverParams`` is fixed per cache (it is part of the service
    identity, not the request); the device is part of the key so the
    circuit breaker's fallback device gets its own entries. Thread-safe;
    compiles happen outside the lock, so a multi-second warm-up of one
    cold shape never blocks another bucket's hits. Two threads racing
    the same miss compile once: the first claims the key with a pending
    marker and builds, the rest wait on the marker and re-read.

    ``events`` (an :class:`~porqua_tpu_torch.obs.events.EventBus`)
    receives one ``compile`` event per entry built — the build and
    warm-up of a compiled entry is the port's compile, counted where
    the JAX package counts an AOT compile, so zero compile events
    after prewarm means the same in both packages — and a
    ``sanitizer_violation`` event per refused post-warmup compile.

    ``cost_log`` is the device-cost warehouse
    (:mod:`porqua_tpu_torch.obs.devprof`): each entry's warm-up is
    counted while it is built and becomes one CostRecord (flops, bytes
    accessed, peak memory, compile seconds, op-sequence hash). Host-side
    and once per build; the served answers are the same bits with the
    plane on or off. ``None`` means a default in-memory ``CostLog``, so
    the per-bucket peak-memory gauges always have data; pass
    ``CostLog(path)`` to persist, ``False`` to turn the plane off.
    """

    def __init__(self, params: SolverParams = SolverParams(),
                 metrics=None, events=None, cost_log=None) -> None:
        self.params = params
        self.metrics = metrics
        self.events = events
        if cost_log is False:
            self.cost_log = None
        elif cost_log is None:
            self.cost_log = devprof.CostLog()
        else:
            self.cost_log = cost_log
        self._lock = tsan.lock("ExecutableCache")
        self._cache: Dict[tuple, object] = {}  # guarded-by: self._lock
        # Latest CostRecord per (kind, bucket, slots, dtype, device,
        # entry): what the batcher's per-dispatch profile and the flight
        # recorder's incident bundles read.
        self._cost_records: Dict[tuple, dict] = {}  # guarded-by: self._lock
        # Per-bucket cache health (hits / compiles / compile seconds),
        # keyed by the bucket label ("NxM"[xfR]); cumulative.
        self._bucket_stats: Dict[str, Dict[str, float]] = {}  # guarded-by: self._lock
        # key -> threading.Event while a compile for it is in flight.
        self._inflight: Dict[tuple, threading.Event] = {}  # guarded-by: self._lock
        # Sanitizer warmup state, scoped per cache and per device: a
        # device whose ladder prewarmed is sealed (misses on it are
        # steady-state recompiles, refused under PORQUA_SANITIZE=1); a
        # device never prewarmed pays its compiles lazily.
        self._warmed_devices: set = set()  # guarded-by: self._lock
        # (bucket, device_key) -> in-flight prewarm depth: those
        # compiles are warmup even on a sealed device, without
        # exempting concurrent misses on other buckets or devices.
        self._warming: Dict[tuple, int] = {}  # guarded-by: self._lock

    @staticmethod
    def _device_key(device) -> tuple:
        if device is None:
            return ("default",)
        device = torch.device(device)
        return (device.type, 0 if device.index is None else device.index)

    @staticmethod
    def _bucket_label(bucket: Bucket) -> str:
        label = f"{bucket.n}x{bucket.m}"
        if bucket.factor_rows is not None:
            label += f"xf{bucket.factor_rows}"
        return label

    def _bucket_stat(self, bucket: Bucket) -> Dict[str, float]:  # guarded-by: self._lock
        return self._bucket_stats.setdefault(
            self._bucket_label(bucket),
            {"cache_hits": 0, "compiles": 0, "compile_seconds": 0.0})

    def get(self, bucket: Bucket, slots: int, dtype, device=None):
        """The compiled entry for one (bucket, batch, device)."""
        return self._get(bucket, slots, dtype, device)[0]

    def get_continuous(self, bucket: Bucket, slots: int, dtype,
                       device=None):
        """The continuous-batching triple ``(admit, step, finalize,
        structs)`` for one cohort shape (see
        :func:`porqua_tpu_torch.qp.solve.aot_compile_continuous`); one
        cache entry and one compile event."""
        return self._get(bucket, slots, dtype, device,
                         kind="continuous")[0]

    def _get(self, bucket: Bucket, slots: int, dtype, device=None,
             kind: str = "solve"):
        """(entry, missed): ``missed`` lets prewarm count its own
        compiles exactly."""
        dev_key = self._device_key(device)
        key = (kind, bucket, int(slots), str(dtype), dev_key)
        if _faults.enabled():
            # cache.get seam: a compile_storm directive evicts this
            # entry, so a post-warmup dispatch pays a fresh compile —
            # the induced steady-state-recompile regression. Fired
            # outside the cache lock (the injector takes its own).
            act = _faults.fire("cache.get", cache_kind=kind,
                               slots=int(slots))
            if act is not None and act.kind == "compile_storm":
                with self._lock:
                    self._cache.pop(key, None)
        while True:
            wait_for = None
            with self._lock:
                exe = self._cache.get(key)
                if exe is not None:
                    hit = True
                    self._bucket_stat(bucket)["cache_hits"] += 1
                else:
                    hit = False
                    wait_for = self._inflight.get(key)
                    if wait_for is None:
                        # Claim the key; the warmup decision snapshots
                        # atomically with the claim.
                        self._inflight[key] = threading.Event()
                        post_warmup = (
                            dev_key in self._warmed_devices
                            and not self._warming.get((bucket, dev_key)))
            if hit:
                if self.metrics is not None:
                    self.metrics.inc("cache_hits")
                return exe, False
            if wait_for is not None:
                # Another thread is compiling this key: wait outside
                # the lock and re-read; if that compile failed, this
                # thread compiles the key itself.
                wait_for.wait()
                continue
            return self._build(key, bucket, slots, dtype, device,
                               kind, dev_key, post_warmup), True

    def _build(self, key, bucket: Bucket, slots: int, dtype, device,
               kind: str, dev_key, post_warmup: bool):
        """Compile one claimed entry outside the cache lock, publish it
        and release the waiters."""
        t0 = time.perf_counter()
        try:
            # Every compile is counted; after prewarm() sealed this
            # device, a miss raises under PORQUA_SANITIZE=1.
            try:
                sanitize.note_compile(
                    f"kind={kind} bucket={bucket} slots={int(slots)} "
                    f"device={dev_key}",
                    post_warmup=post_warmup)
            except sanitize.SanitizerError as exc:
                if self.events is not None:
                    self.events.emit(
                        "sanitizer_violation", "error",
                        what="post_warmup_compile_refused",
                        bucket=f"{bucket.n}x{bucket.m}",
                        slots=int(slots), device=str(dev_key),
                        detail=str(exc))
                raise
            struct = batch_shape_struct(
                int(slots), bucket.n, bucket.m, dtype=dtype,
                factor_rows=bucket.factor_rows)
            harvest = (devprof.harvest_warmups() if self.cost_log is not None
                       else contextlib.nullcontext({}))
            with harvest as warmups:
                if kind == "continuous":
                    exe = aot_compile_continuous(struct, self.params,
                                                 device=device)
                else:
                    exe = aot_compile_batch(struct, self.params,
                                            device=device)
            with self._lock:
                self._cache[key] = exe
        finally:
            # Success or failure, drop the claim and wake the waiters
            # (on failure they re-race the miss).
            with self._lock:
                pending = self._inflight.pop(key, None)
            if pending is not None:
                pending.set()
        seconds = time.perf_counter() - t0
        with self._lock:
            stat = self._bucket_stat(bucket)
            stat["compiles"] += 1
            stat["compile_seconds"] += seconds
        self._harvest_cost(bucket, slots, dtype, dev_key, kind, warmups,
                           seconds)
        if self.metrics is not None:
            self.metrics.observe_compile(seconds)
        if self.events is not None:
            self.events.emit(
                "compile", "warn" if post_warmup else "info",
                bucket=f"{bucket.n}x{bucket.m}",
                factor_rows=bucket.factor_rows, slots=int(slots),
                device=str(dev_key), seconds=round(seconds, 4),
                post_warmup=post_warmup)
        return exe

    def _harvest_cost(self, bucket: Bucket, slots: int, dtype, dev_key,
                      kind: str, warmups: dict, seconds: float) -> None:
        """The built entry's counted warm-ups as CostRecords: one for a
        one-shot solve, three for the continuous admit/step/finalize
        triple (the compile event stays one). Never raises."""
        if self.cost_log is None:
            return
        try:
            label = self._bucket_label(bucket)
            dev_label = ":".join(str(p) for p in dev_key)
            dtype_str = str(dtype).replace("torch.", "")
            entries = (("admit", "step", "finalize") if kind == "continuous"
                       else ("solve",))
            for entry in entries:
                rec = devprof.cost_record(
                    warmups.get(entry), entry=entry, kind=kind,
                    bucket=label, slots=int(slots), dtype=dtype_str,
                    device=dev_label, compile_s=seconds)
                with self._lock:
                    self._cost_records[
                        (kind, label, int(slots), dtype_str, dev_label,
                         entry)] = rec
                self.cost_log.emit(rec)
        except Exception:  # noqa: BLE001 - cost evidence must not fail
            # the build it describes.
            pass

    def cost_records(self) -> list:
        """Every harvested CostRecord (latest per entry identity)."""
        with self._lock:
            return [dict(r) for r in self._cost_records.values()]

    def cost_record_for(self, bucket: Bucket, slots: int, dtype,
                        kind: str = "solve",
                        entry: Optional[str] = None,
                        device_label: Optional[str] = None):
        """The CostRecord of one cached entry, or ``None``: the batcher
        reads it to switch a dispatch's MFU/bandwidth numerators from
        the analytic model to the counted warm-up. ``device_label``
        (``"type:index"``) narrows to one device; ``None`` matches any."""
        if entry is None:
            entry = "step" if kind == "continuous" else "solve"
        label = self._bucket_label(bucket)
        dtype_str = str(dtype).replace("torch.", "")
        with self._lock:
            if device_label is not None:
                rec = self._cost_records.get(
                    (kind, label, int(slots), dtype_str, device_label,
                     entry))
                return None if rec is None else dict(rec)
            for key, rec in self._cost_records.items():
                if key[:4] == (kind, label, int(slots), dtype_str) \
                        and key[5] == entry:
                    return dict(rec)
        return None

    def bucket_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-bucket cache health: hits, compiles (== misses that
        built), cumulative compile seconds, and the largest harvested
        peak memory / bytes accessed over the bucket's entries."""
        with self._lock:
            out = {label: dict(stat)
                   for label, stat in self._bucket_stats.items()}
            for (kind, label, slots, _dt, _dev, entry), rec \
                    in self._cost_records.items():
                stat = out.setdefault(
                    label, {"cache_hits": 0, "compiles": 0,
                            "compile_seconds": 0.0})
                for field, key in (("peak_bytes_max", "peak_bytes"),
                                   ("bytes_accessed_max",
                                    "bytes_accessed")):
                    v = rec.get(key)
                    if v is not None:
                        stat[field] = max(stat.get(field, 0.0), float(v))
        return out

    def prometheus_gauges(self) -> Dict[str, list]:
        """Per-bucket cache-health series for a ``/metrics`` exposition:
        compile seconds, compile and hit counters, and peak device
        memory (from the cost harvest; none on the CPU)."""
        stats = self.bucket_stats()
        out: Dict[str, list] = {
            "bucket_compile_seconds_total": [],
            "bucket_compiles_total": [],
            "bucket_cache_hits_total": [],
            "bucket_peak_bytes": [],
        }
        for label in sorted(stats):
            stat = stats[label]
            tag = {"bucket": label}
            out["bucket_compile_seconds_total"].append(
                (tag, stat.get("compile_seconds", 0.0)))
            out["bucket_compiles_total"].append(
                (tag, stat.get("compiles", 0)))
            out["bucket_cache_hits_total"].append(
                (tag, stat.get("cache_hits", 0)))
            if "peak_bytes_max" in stat:
                out["bucket_peak_bytes"].append(
                    (tag, stat["peak_bytes_max"]))
        return out

    @property
    def warmed(self) -> bool:
        """At least one device's ladder prewarmed successfully
        (sanitizer enforcement armed for that device)."""
        with self._lock:
            return bool(self._warmed_devices)

    def prewarm(self, bucket: Bucket, max_batch: int, dtype,
                device=None, continuous: bool = False,
                include_solve: bool = True) -> int:
        """Compile the whole slot ladder for one bucket; returns the
        number of entries compiled (cache misses). ``(bucket, device)``'s
        compiles count as warmup for the duration, while concurrent
        misses on other buckets or devices stay enforced. The device is
        sealed only when the whole ladder compiled. ``continuous=True``
        compiles the continuous triple for every rung;
        ``include_solve=False`` skips the one-shot solve entries (a
        continuous service never dispatches them)."""
        compiled = 0
        key = (bucket, self._device_key(device))
        with self._lock:
            self._warming[key] = self._warming.get(key, 0) + 1
        try:
            for s in slot_ladder(max_batch):
                if include_solve:
                    compiled += self._get(bucket, s, dtype, device)[1]
                if continuous:
                    compiled += self._get(bucket, s, dtype, device,
                                          kind="continuous")[1]
        finally:
            with self._lock:
                depth = self._warming[key] - 1
                if depth:
                    self._warming[key] = depth
                else:
                    del self._warming[key]
        with self._lock:
            self._warmed_devices.add(self._device_key(device))
        return compiled

    def __len__(self) -> int:
        return len(self._cache)
