"""The solver telemetry warehouse: per-solve harvest records (the port
of ``porqua_tpu/obs/harvest.py``).

The convergence rings (:mod:`porqua_tpu_torch.obs.rings`) already record the
residual trajectory of every solve on device, and the serve/bench
stacks ship iteration *distributions* — but nothing persisted
per-solve trajectories joined with problem features, so the ROADMAP's
learned-adaptive-policy work ("Learning context-aware adaptive solvers
to accelerate quadratic programming", "A Learning-Based Inexact ADMM",
PAPERS.md) had no dataset to fit on. This module closes that gap:

* :func:`solve_record` — ONE schema (``SCHEMA_VERSION``) for a solved
  problem wherever it was solved: problem features (n, m, eps bucket,
  warm-start provenance), outcomes (status, iters, segments, final
  residuals, objective), the decoded ring trajectory (rho trace
  included), timing (wall/solve seconds, device), correlation ids
  (trace id, source), and optional compaction / stage-profile stats.
* :class:`HarvestSink` — a thread-safe, append-only JSONL (``.gz``
  transparently gzipped) dataset writer. ``emit`` never raises and
  never blocks on anything but its lock + one buffered write: it runs
  on the serve dispatch thread, so a dead disk degrades to counting
  ``write_failures`` (surfaced in ``/metrics`` and ``/healthz``), not
  to failing solves.
* :func:`harvest_solution` — the batched-producer bridge: explode one
  stacked :class:`~porqua_tpu_torch.qp.solve.QPSolution` (a batch,
  compacted batch, or one scan-driver chunk) into per-lane records.
* :func:`load_harvest` / :func:`aggregate` — the reader half:
  ``scripts/harvest_report.py`` renders :func:`aggregate`'s
  policy-ready table (per-(bucket, eps) iteration quantiles,
  wasted-iteration attribution, warm-vs-cold deltas).

Harvesting is pure host post-processing of arrays the producers
already fetched (or fetch once, after the timed region, one host copy
per field and batch): a disabled sink is a ``None`` check, and the
enabled path reads device results without changing what the card
runs. A record's ``device`` is the label of the tensor's device
(``"cuda:0"`` on the card), read by :func:`device_label_of`.
"""

from __future__ import annotations

import gzip
import json
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from porqua_tpu_torch.analysis import tsan
from porqua_tpu_torch.obs.rings import ring_history

__all__ = [
    "SCHEMA_VERSION",
    "HarvestSink",
    "aggregate",
    "device_label_of",
    "harvest_solution",
    "load_harvest",
    "solve_record",
]


def device_label_of(tree) -> Optional[str]:
    """``"type:index"`` label (``"cuda:0"``) of the device holding the
    first tensor of a solution (a ``QPSolution`` or any tuple of
    tensors), through :func:`porqua_tpu_torch.serve.batcher.device_label`;
    ``None`` when it holds no tensor (host numpy)."""
    from porqua_tpu_torch.serve.batcher import device_label

    leaves = tree if isinstance(tree, (tuple, list)) else (tree,)
    for leaf in leaves:
        if hasattr(leaf, "device") and hasattr(leaf, "detach"):
            return device_label(leaf.device)
    return None


def _host(a) -> np.ndarray:
    """A numpy array of a tensor on any device (one host copy) or of
    an array-like."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)

#: Bump when a field changes meaning; additive fields don't need it.
#: v2: records carry a ``tenant`` id (always — untagged producers
#: write :data:`DEFAULT_TENANT`) and :func:`aggregate` groups per
#: ``(tenant, bucket, eps)``. v1 records (e.g. the committed
#: ``HARVEST_r07.json``) load unchanged with ``tenant`` defaulting to
#: :data:`LEGACY_TENANT` — the sentinel keeps pre-tenant history
#: distinguishable from a real ``"default"``-lane record.
SCHEMA_VERSION = 2

#: The tenant id a tenancy-unaware producer writes (matches
#: ``porqua_tpu_torch.serve.tenancy.DEFAULT_TENANT`` — literal here so the
#: warehouse stays import-light).
DEFAULT_TENANT = "default"

#: What a v1 record's missing ``tenant`` field reads as.
LEGACY_TENANT = "(pre-tenant)"

#: Known values of a record's ``source`` field (producer provenance).
SOURCES = ("serve", "serve.continuous", "serve.shadow", "batch",
           "batch.compacted", "backtest.scan")


def solve_record(source: str,
                 n: int,
                 m: int,
                 status: int,
                 iters: int,
                 prim_res: float,
                 dual_res: float,
                 obj_val: float,
                 params=None,
                 bucket: Optional[str] = None,
                 warm: bool = False,
                 warm_src: Optional[str] = None,
                 wall_s: Optional[float] = None,
                 solve_s: Optional[float] = None,
                 device: Optional[str] = None,
                 trace_id: Optional[str] = None,
                 ring: Optional[Dict[str, Any]] = None,
                 segments: Optional[int] = None,
                 batch: Optional[int] = None,
                 compaction: Optional[Dict[str, Any]] = None,
                 profile: Optional[Dict[str, Any]] = None,
                 tenant: Optional[str] = None,
                 **extra) -> Dict[str, Any]:
    """Build one SolveRecord dict (the schema's single constructor —
    every producer goes through here so fields cannot drift apart).

    ``params`` is the :class:`~porqua_tpu_torch.qp.solve.SolverParams` the
    solve ran with; its tolerance/iteration knobs are flattened into
    the record (they are problem features for a learned policy, not
    metadata). ``ring`` is a decoded trajectory from
    :func:`porqua_tpu_torch.obs.rings.ring_history` — its ``rho`` list IS
    the rho trace. ``segments`` defaults to the executed-segment count
    derived from ``iters`` and the params' check interval. ``batch``
    is the dispatch width this lane solved inside (``solve_s`` is the
    whole dispatch's device seconds, shared by its lanes)."""
    rec: Dict[str, Any] = {
        "v": SCHEMA_VERSION,
        "t": time.time(),
        "source": source,
        # Always present since v2 (DEFAULT_TENANT for tenancy-unaware
        # producers) so per-tenant reconciliation — tenant completed
        # == tenant records — holds by construction.
        "tenant": str(tenant) if tenant is not None else DEFAULT_TENANT,
        "n": int(n),
        "m": int(m),
        "status": int(status),
        "iters": int(iters),
        "prim_res": float(prim_res),
        "dual_res": float(dual_res),
        "obj_val": float(obj_val),
        "warm": bool(warm),
    }
    if params is not None:
        rec["eps_abs"] = float(params.eps_abs)
        rec["eps_rel"] = float(params.eps_rel)
        rec["max_iter"] = int(params.max_iter)
        rec["check_interval"] = int(params.check_interval)
        # Which first-order backend produced the lane ("admm" | "pdhg")
        # — the routing tables train on this axis. Additive: records
        # predating the field (or written without params) read back as
        # "admm" everywhere (aggregate / harvest_report), which is what
        # every pre-PDHG record actually ran. An explicit ``solver=``
        # kwarg (e.g. shadow-compare records) overrides via ``extra``.
        rec["solver"] = str(getattr(params, "method", "admm"))
        if segments is None:
            ci = int(params.check_interval)
            segments = max(-(-int(iters) // ci), 1)
    rec["bucket"] = bucket if bucket is not None else f"{int(n)}x{int(m)}"
    if segments is not None:
        rec["segments"] = int(segments)
    if warm_src is not None:
        rec["warm_src"] = str(warm_src)
    if wall_s is not None:
        rec["wall_s"] = float(wall_s)
    if solve_s is not None:
        rec["solve_s"] = float(solve_s)
    if batch is not None:
        rec["batch"] = int(batch)
    if device is not None:
        rec["device"] = str(device)
    if trace_id is not None:
        rec["trace_id"] = str(trace_id)
    if ring is not None:
        rec["ring"] = ring
    if compaction is not None:
        rec["compaction"] = compaction
    if profile is not None:
        rec["profile"] = profile
    rec.update(extra)
    return rec


class HarvestSink:
    """Thread-safe append-only SolveRecord dataset.

    ``path`` ending in ``.gz`` writes through :mod:`gzip`
    transparently; ``path=None`` keeps an in-memory bounded buffer
    (tests, short diagnostic runs). ``emit`` is called from serving
    hot paths, so it NEVER raises: a broken sink counts
    ``write_failures`` (and emits one ``harvest_sink_failed`` event
    when an :class:`~porqua_tpu_torch.obs.events.EventBus` was given) and
    keeps serving. Counters are exposed in the Prometheus exposition
    and the ``/healthz`` payload via ``SolveService``.
    """

    def __init__(self, path: Optional[str] = None,
                 events=None, buffer_capacity: int = 65536) -> None:
        self.path = path
        self.events = events
        self._lock = tsan.lock("HarvestSink")
        self._records = 0                 # guarded-by: self._lock
        self._write_failures = 0          # guarded-by: self._lock
        self._dropped = 0                 # guarded-by: self._lock
        self._buffer_capacity = int(buffer_capacity)
        self._buffer: List[Dict[str, Any]] = []  # guarded-by: self._lock
        self._sink = None                 # guarded-by: self._lock
        if path is not None:
            try:
                self._sink = (gzip.open(path, "at")
                              if str(path).endswith(".gz")
                              else open(path, "a"))
            except OSError as exc:
                self._write_failures += 1
                self._note_failure(exc)

    def _note_failure(self, exc) -> None:
        if self.events is not None:
            self.events.emit("harvest_sink_failed", "error",
                             path=str(self.path),
                             error=f"{type(exc).__name__}: {exc}")

    def emit(self, record: Dict[str, Any]) -> None:
        """Append one record; never raises (see class docstring)."""
        # Serialize only for a live file sink: the in-memory buffer
        # stores the dict, and a dead sink drops the record — neither
        # should pay a per-record json.dumps of the ring trajectory on
        # the dispatch thread (unlocked read is a one-way race: _sink
        # only ever transitions to None).
        line = (json.dumps(record, default=str)
                if self._sink is not None else None)
        failed = None
        with self._lock:
            self._records += 1
            if self._sink is not None and line is not None:
                try:
                    self._sink.write(line + "\n")
                except (OSError, ValueError) as exc:
                    # ValueError: write on a closed file — a racing
                    # close() is a shutdown artifact, not a crash.
                    self._write_failures += 1
                    self._sink = None  # dead sink: keep serving
                    failed = exc
            elif self.path is None:
                if len(self._buffer) < self._buffer_capacity:
                    self._buffer.append(record)
                else:
                    self._dropped += 1
            else:
                # File sink died earlier; count what the dataset lost.
                self._dropped += 1
        if failed is not None:
            self._note_failure(failed)

    # -- readers -----------------------------------------------------

    @property
    def records(self) -> int:
        with self._lock:
            return self._records

    @property
    def write_failures(self) -> int:
        with self._lock:
            return self._write_failures

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def buffered(self) -> List[Dict[str, Any]]:
        """In-memory records (``path=None`` sinks only)."""
        with self._lock:
            return list(self._buffer)

    def counters(self) -> Dict[str, int]:
        """One dict of the sink's health counters, for exposition."""
        with self._lock:
            return {"harvest_records": self._records,
                    "harvest_write_failures": self._write_failures,
                    "harvest_dropped": self._dropped}

    def flush(self) -> None:
        failed = None
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.flush()
                except OSError as exc:
                    # Same posture (and the same event) as an emit-time
                    # failure: a disk that fills between the last emit
                    # and the end-of-run flush lost buffered tail
                    # records, and the event log must say so.
                    self._write_failures += 1
                    self._sink = None
                    failed = exc
        if failed is not None:
            self._note_failure(failed)

    def close(self) -> None:
        failed = None
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError as exc:
                    self._write_failures += 1
                    failed = exc
                self._sink = None
        if failed is not None:
            self._note_failure(failed)

    def __enter__(self) -> "HarvestSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_harvest(path: str) -> List[Dict[str, Any]]:
    """Read a harvest dataset (JSONL, ``.gz`` transparently) back into
    a list of record dicts; blank lines skipped."""
    opener = gzip.open if str(path).endswith(".gz") else open
    out: List[Dict[str, Any]] = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# batched producers
# ---------------------------------------------------------------------------

def harvest_solution(sink: Optional[HarvestSink],
                     solution,
                     params,
                     source: str,
                     n: Optional[int] = None,
                     m: Optional[int] = None,
                     wall_s: Optional[float] = None,
                     solve_s: Optional[float] = None,
                     device: Optional[str] = None,
                     warm: bool = False,
                     warm_src: Optional[str] = None,
                     warm_mask=None,
                     compaction: Optional[Dict[str, Any]] = None,
                     profile: Optional[Dict[str, Any]] = None,
                     date_offset: int = 0,
                     tenant: Optional[str] = None) -> int:
    """Explode one (possibly batched) QPSolution into SolveRecords.

    The shared device->dataset bridge for every batched producer
    (``batch.solve_batch``, the compacting driver wrapper, the
    checkpointed scan driver): fetches the outcome arrays ONCE (one
    host copy per field — the producers have already left their timed
    region),
    decodes each lane's ring trajectory when the solve carried rings,
    and emits one record per lane. ``warm_mask`` (a per-lane boolean
    sequence) overrides the batch-wide ``warm`` flag where lanes
    differ — e.g. a scan chunk whose first date solves from the cold
    initial carry while the rest chain warm starts (a cold lane's
    record drops ``warm_src`` too, so the warm-vs-cold aggregation
    stays unbiased). Returns the number of records emitted;
    ``sink=None`` emits nothing and touches nothing."""
    if sink is None:
        return 0
    xs = np.atleast_2d(_host(solution.x))
    status = np.atleast_1d(_host(solution.status))
    iters = np.atleast_1d(_host(solution.iters))
    prim = np.atleast_1d(_host(solution.prim_res))
    dual = np.atleast_1d(_host(solution.dual_res))
    obj = np.atleast_1d(_host(solution.obj_val))
    ys = np.atleast_2d(_host(solution.y))
    rp = getattr(solution, "ring_prim", None)
    if rp is not None:
        rp = np.atleast_2d(_host(rp))
        rd = np.atleast_2d(_host(solution.ring_dual))
        rr = np.atleast_2d(_host(solution.ring_rho))
    B = int(status.shape[0])
    n = int(xs.shape[-1]) if n is None else int(n)
    m = int(ys.shape[-1]) if m is None else int(m)
    for i in range(B):
        ring = None
        if rp is not None:
            ring = ring_history(rp[i], rd[i], rr[i], int(iters[i]),
                                int(params.check_interval))
        lane_warm = bool(warm_mask[i]) if warm_mask is not None else warm
        sink.emit(solve_record(
            source, n, m, int(status[i]), int(iters[i]),
            float(prim[i]), float(dual[i]), float(obj[i]),
            params=params, warm=lane_warm,
            warm_src=warm_src if lane_warm else None,
            wall_s=wall_s, solve_s=solve_s, device=device,
            ring=ring, batch=B, compaction=compaction, profile=profile,
            tenant=tenant, lane=int(date_offset) + i))
    return B


# ---------------------------------------------------------------------------
# the policy-ready aggregation (scripts/harvest_report.py renders it)
# ---------------------------------------------------------------------------

def _quantiles(values: List[float]) -> Dict[str, float]:
    a = np.asarray(values, dtype=np.float64)
    if not a.size:
        return {"p50": 0.0, "p95": 0.0, "max": 0.0, "mean": 0.0}
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "max": float(a.max()),
            "mean": float(a.mean())}


def aggregate(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Roll a harvest dataset up into the policy-ready table.

    Per ``(tenant, bucket, eps_abs)`` group (since schema v2 —
    tenancy is the workload-segmentation axis the learned-policy loop
    needs; v1 records group under :data:`LEGACY_TENANT`): record
    count, iteration quantiles, status counts, the group's
    wasted-iteration attribution (``1 - sum(segments) /
    (count * max(segments))`` — the straggler tax a fused batch of
    exactly this group would pay), and the warm-vs-cold
    mean-iteration delta (negative = warm starts help, the figure a
    warm-start-seed policy trains against). The overall section
    carries totals and per-source / per-tenant counts."""
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    sources: Dict[str, int] = {}
    tenants: Dict[str, int] = {}
    ring_records = 0
    annotations = 0
    for rec in records:
        src = str(rec.get("source", "?"))
        if "iters" not in rec:
            # Annotation records (the calibration plane's
            # ``calibration.audit`` chain) share the dataset but are
            # not solves: counted per source, excluded from the
            # per-cell solve statistics.
            sources[src] = sources.get(src, 0) + 1
            annotations += 1
            continue
        tenant = str(rec.get("tenant", LEGACY_TENANT))
        key = (tenant, str(rec.get("bucket", "?")), rec.get("eps_abs"))
        groups.setdefault(key, []).append(rec)
        sources[src] = sources.get(src, 0) + 1
        tenants[tenant] = tenants.get(tenant, 0) + 1
        if rec.get("ring"):
            ring_records += 1

    table = []
    total = 0
    for (tenant, bucket, eps), recs in sorted(
            groups.items(),
            key=lambda kv: (kv[0][0], kv[0][1], kv[0][2] or 0.0)):
        total += len(recs)
        iters = [int(r["iters"]) for r in recs]
        segs = [int(r.get("segments", 1)) for r in recs]
        status: Dict[str, int] = {}
        for r in recs:
            s = str(r["status"])
            status[s] = status.get(s, 0) + 1
        dense = len(segs) * max(segs) if segs else 0
        warm_iters = [int(r["iters"]) for r in recs if r.get("warm")]
        cold_iters = [int(r["iters"]) for r in recs if not r.get("warm")]
        row: Dict[str, Any] = {
            "tenant": tenant,
            "bucket": bucket,
            "eps_abs": eps,
            "count": len(recs),
            "iters": _quantiles([float(v) for v in iters]),
            "segments_sum": int(sum(segs)),
            "wasted_iteration_fraction": (
                float(1.0 - sum(segs) / dense) if dense else 0.0),
            "status_counts": status,
            "warm_count": len(warm_iters),
            "cold_count": len(cold_iters),
        }
        if warm_iters and cold_iters:
            row["warm_minus_cold_iters_mean"] = float(
                np.mean(warm_iters) - np.mean(cold_iters))
        if any("solver" in r for r in recs):
            # The backend axis (records written since the PDHG backend
            # came in carry it; solver-absent records, every older
            # dataset, read back as "admm", which is what they ran). Per-backend
            # iteration quantiles + mean dispatch latency: the
            # comparison table harvest_report renders and the
            # SolverRouter's seed (serve/routing.py) — a backend's
            # entry is its evidence for winning this (tenant, bucket,
            # eps) cell.
            by_solver: Dict[str, Dict[str, Any]] = {}
            for sv in sorted({str(r.get("solver", "admm"))
                              for r in recs}):
                srecs = [r for r in recs
                         if str(r.get("solver", "admm")) == sv]
                sstat: Dict[str, int] = {}
                for r in srecs:
                    s = str(r["status"])
                    sstat[s] = sstat.get(s, 0) + 1
                entry: Dict[str, Any] = {
                    "count": len(srecs),
                    "iters": _quantiles([float(r["iters"])
                                         for r in srecs]),
                    "status_counts": sstat,
                }
                lat = [float(r["solve_s"]) for r in srecs
                       if r.get("solve_s") is not None]
                if lat:
                    entry["solve_s_mean"] = float(np.mean(lat))
                # Routed decisions: dispatches the router actually sent
                # to this backend, i.e. everything that is not a shadow
                # re-solve (source "serve.shadow" / shadow_of set). The
                # count harvest_report's solver table shows next to the
                # win column — evidence volume behind each cell.
                entry["routed"] = sum(
                    1 for r in srecs
                    if not r.get("shadow_of")
                    and str(r.get("source", "")) != "serve.shadow")
                by_solver[sv] = entry
            row["by_solver"] = by_solver
        table.append(row)
    return {
        "schema_version": SCHEMA_VERSION,
        "records": total,
        "ring_records": ring_records,
        "annotations": annotations,
        "sources": sources,
        "tenants": tenants,
        "groups": table,
    }
