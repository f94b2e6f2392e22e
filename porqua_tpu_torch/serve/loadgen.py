"""Load generation for the online solve service (the port of
``porqua_tpu/serve/loadgen.py``).

Replays a stream of per-date tracking problems as independent
requests, closed- or open-loop, and reports sustained throughput,
latency percentiles, batch occupancy and the recompile count.

Protocol (the JAX package's): requests are built before the clock
starts; the service is prewarmed so every slot-ladder entry exists; the
metrics window is reset after prewarm and a warm-up round, so
``compiles`` during measurement counts only recompiles (acceptance: 0);
closed-loop mode keeps a bounded in-flight window via a semaphore.

Not ported yet, and raising when asked: the observability options
(``trace_out``, ``events_out``, ``ring_size``, ``harvest_out``, ``slo``,
``flight_out``, ``anomaly_baseline``, ``tenant_slos``: ROADMAP queue A,
item 18; ``cost_out``, ``profile_window_s``, ``profile_dir``: item 19)
and the retry layer (``retry``, and ``chaos`` without ``no_retry``:
item 17).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from porqua_tpu_torch.batch import _not_ported
from porqua_tpu_torch.qp.admm import Status
from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.qp.solve import SolverParams
from porqua_tpu_torch.resilience import faults as _faults
from porqua_tpu_torch.serve.service import QueueFull, SolveService
from porqua_tpu_torch.tracking import synthetic_universe_np

#: Status code -> name for the report's per-lane breakdown.
_STATUS_NAMES = dict(Status.NAMES)

#: The serving solver defaults: the JAX package's loose-eps config
#: (serving trades the polish for latency).
SERVE_PARAMS = SolverParams(max_iter=2000, eps_abs=1e-3, eps_rel=1e-3,
                            polish=False, scaling_iters=2)

#: Options of the JAX package's run_loadgen -> the item that ports them.
_UNPORTED_OPTIONS = {
    "trace_out": "item 18", "events_out": "item 18", "ring_size": "item 18",
    "harvest_out": "item 18", "slo": "item 18", "flight_out": "item 18",
    "anomaly_baseline": "item 18", "tenant_slos": "item 18",
    "cost_out": "item 19", "profile_window_s": "item 19",
    "profile_dir": "item 19", "retry": "item 17",
}


def _qp(**fields) -> CanonicalQP:
    return CanonicalQP(**{k: None if v is None else torch.from_numpy(
        np.asarray(v)) for k, v in fields.items()})


def build_tracking_requests(n_requests: int,
                            n_assets: int = 24,
                            window: int = 252,
                            seed: int = 5,
                            factor: bool = False) -> List[CanonicalQP]:
    """Per-date index-replication QPs as independent requests (host
    float32 tensors at their natural shape; the service pads them).
    ``n_assets=24`` is the config-5 MSCI-grid shape, ``n_assets=500``
    the north star. The JAX package's numpy twin of its tracking
    problem at ridge 0: P = 2X'X, q = -2X'y, budget row, long-only box,
    constant = y'y. ``factor=True`` also carries the objective factor
    (``Pf = X``, ``Pdiag = 0``)."""
    Xs, ys = synthetic_universe_np(seed=seed, n_dates=n_requests,
                                   window=window, n_assets=n_assets)
    out = []
    for i in range(n_requests):
        X, y = Xs[i].astype(np.float32), ys[i].astype(np.float32)
        n = X.shape[1]
        out.append(_qp(
            P=2.0 * X.T @ X, q=-2.0 * (X.T @ y),
            C=np.ones((1, n), np.float32),
            l=np.ones(1, np.float32), u=np.ones(1, np.float32),
            lb=np.zeros(n, np.float32), ub=np.ones(n, np.float32),
            var_mask=np.ones(n, np.float32),
            row_mask=np.ones(1, np.float32),
            constant=np.float32(y @ y),
            Pf=X if factor else None,
            Pdiag=np.zeros(n, np.float32) if factor else None,
        ))
    return out


def build_exposure_requests(n_requests: int,
                            n_assets: int = 96,
                            n_rows: int = 16,
                            seed: int = 7,
                            box: float = 0.3) -> List[CanonicalQP]:
    """Risk-model mean-variance QPs with factor-exposure bands (the JAX
    package's second request family): a dense factor-model covariance
    objective, budget row, long-only box with a position cap, and
    ``n_rows - 1`` general rows holding random factor exposures inside
    ±1. The same numpy draws as the JAX package for the same seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_requests):
        F = rng.standard_normal((max(2, n_assets // 4), n_assets))
        P = (F.T @ F / n_assets
             + 0.1 * np.eye(n_assets)).astype(np.float32)
        q = rng.standard_normal(n_assets).astype(np.float32)
        C = np.vstack([
            np.ones((1, n_assets), np.float32),
            rng.standard_normal((n_rows - 1, n_assets)).astype(np.float32),
        ])
        lo = np.concatenate([[1.0], -np.ones(n_rows - 1)]).astype(np.float32)
        hi = np.concatenate([[1.0], np.ones(n_rows - 1)]).astype(np.float32)
        out.append(_qp(
            P=P, q=q, C=C, l=lo, u=hi,
            lb=np.zeros(n_assets, np.float32),
            ub=np.full(n_assets, box, np.float32),
            var_mask=np.ones(n_assets, np.float32),
            row_mask=np.ones(n_rows, np.float32),
            constant=np.float32(0.0),
        ))
    return out


def prewarm_buckets(service: SolveService, requests) -> tuple:
    """Prewarm every distinct bucket ``requests`` touches. Returns
    ``(n_compiled, warm_examples)``: one example request per bucket,
    for the caller's warm-up round."""
    n_compiled = 0
    seen = set()
    warm_examples = []
    for q in requests:
        bucket = service.ladder.select(q)
        if bucket in seen:
            continue
        seen.add(bucket)
        warm_examples.append(q)
        n_compiled += service.prewarm(q)
    return n_compiled, warm_examples


def _tenant_fields(snap: Dict, tenants: List[str], offenders) -> Dict:
    """The report's tenant axis: per-tenant counter/latency rows and the
    ``tenant_fairness`` block (quiet-tenant p99 ratio, victim shed
    share). Warm-up traffic runs untagged, so every figure covers
    exactly the measured window."""
    measured = sorted(set(tenants))
    snap_tenants = snap.get("tenants") or {}
    rows = {t: snap_tenants.get(t, {}) for t in measured}
    off = set(offenders or ())
    quiet = {t: r for t, r in rows.items() if t not in off}
    p99s = [float(r.get("latency_p99_ms", 0.0)) for r in quiet.values()
            if r.get("completed")]
    return {"tenants": rows, "tenant_fairness": {
        "tenants": len(measured),
        "offenders": sorted(off & set(measured)),
        # Fair share among the non-offending tenants.
        "quiet_p99_ratio": (max(p99s) / max(min(p99s), 1e-9)
                            if len(p99s) >= 2 else 1.0),
        # Quota isolation: quiet tenants shed nothing.
        "victim_shed_share": (
            sum(int(r.get("rejected", 0)) for r in quiet.values())
            / max(sum(int(r.get("submitted", 0))
                      for r in quiet.values()), 1)),
    }}


def run_loadgen(requests: List[CanonicalQP],
                params: SolverParams = SERVE_PARAMS,
                mode: str = "closed",
                rate: Optional[float] = None,
                inflight: Optional[int] = None,
                max_batch: int = 256,
                max_wait_ms: float = 2.0,
                warm_keys: bool = False,
                deadline_s: Optional[float] = None,
                service: Optional[SolveService] = None,
                jsonl_path: Optional[str] = None,
                trace_out: Optional[str] = None,
                events_out: Optional[str] = None,
                ring_size: int = 0,
                ring_samples: int = 8,
                harvest_out: Optional[str] = None,
                continuous: bool = False,
                segment_budget: Optional[int] = None,
                retry=None,
                chaos=None,
                chaos_seed: int = 0,
                no_retry: bool = False,
                slo=False,
                slo_latency_target_s: float = 0.25,
                flight_out=None,
                anomaly_baseline=None,
                cost_out: Optional[str] = None,
                profile_window_s: Optional[float] = None,
                profile_dir: Optional[str] = None,
                arrivals=None,
                tenants: Optional[List[str]] = None,
                tenant_quota=None,
                tenant_weights=None,
                tenant_slos=None,
                offenders=None,
                device=None) -> Dict:
    """Drive ``requests`` through a :class:`SolveService`; return the
    report dict (throughput, percentiles, occupancy, recompiles).

    ``mode="closed"``: a bounded in-flight window (default
    ``4 * max_batch``) is kept full until every request is submitted.
    ``mode="open"``: requests are submitted on a fixed-``rate``
    schedule (or at the per-request ``arrivals`` offsets) regardless of
    completions; a full queue drops the arrival. ``warm_keys`` tags
    each request with its stream index. An externally-managed
    ``service`` (already started) may be passed; otherwise one is
    created on ``device`` (default: the card) and torn down.

    ``chaos`` names a builtin fault scenario (or passes a ``Scenario``)
    installed for the measured phase only; it needs ``no_retry=True``
    until the retry layer is ported. ``tenants`` tags each request with
    a tenant id; ``tenant_quota`` / ``tenant_weights`` configure the
    service's admission quotas and DRR weights; ``offenders`` names the
    tenants the report's ``tenant_fairness`` treats as noisy. The JAX
    package's other options raise (module docstring; ``ring_samples``
    and ``slo_latency_target_s`` qualify two of them)."""
    asked = dict(trace_out=trace_out, events_out=events_out,
                 ring_size=ring_size, harvest_out=harvest_out, slo=slo,
                 flight_out=flight_out, anomaly_baseline=anomaly_baseline,
                 tenant_slos=tenant_slos, cost_out=cost_out,
                 profile_window_s=profile_window_s, profile_dir=profile_dir,
                 retry=retry)
    for name, value in asked.items():
        if value:
            raise _not_ported(f"run_loadgen({name}=)",
                              _UNPORTED_OPTIONS[name])
    if mode not in ("closed", "open"):
        raise ValueError(f"unknown mode {mode!r}; expected closed|open")
    if mode == "open" and not rate and arrivals is None:
        raise ValueError("open-loop mode requires a rate (solves/s) "
                         "or per-request arrival offsets (arrivals=)")
    if arrivals is not None and len(arrivals) != len(requests):
        raise ValueError("arrivals must align 1:1 with requests")
    if tenants is not None and len(tenants) != len(requests):
        raise ValueError("tenants must align 1:1 with requests")
    scenario = None
    if chaos is not None:
        if not no_retry:
            raise _not_ported("run_loadgen(chaos=) with its default retry "
                              "policy (pass no_retry=True for raw fault "
                              "behaviour)", "item 17")
        if isinstance(chaos, _faults.Scenario):
            scenario = chaos
        else:
            catalog = _faults.builtin_scenarios(seed=chaos_seed)
            if chaos not in catalog:
                raise ValueError(
                    f"unknown chaos scenario {chaos!r}; builtin: "
                    f"{', '.join(sorted(catalog))}")
            scenario = catalog[chaos]

    own_service = service is None
    if own_service:
        service = SolveService(params=params, max_batch=max_batch,
                               max_wait_ms=max_wait_ms,
                               queue_capacity=max(4 * max_batch, 1024),
                               continuous=continuous,
                               segment_budget=segment_budget,
                               tenant_quota=tenant_quota,
                               tenant_weights=tenant_weights,
                               device=device)
        service.start()
    elif tenant_quota is not None or tenant_weights:
        raise ValueError(
            "tenant_quota/tenant_weights require the service to be "
            "constructed here; build it with SolveService(tenant_quota="
            "..., tenant_weights=...)")
    injector = None
    try:
        # Prewarm every distinct bucket, then reset the window after a
        # warm-up round: measured `compiles` == recompiles.
        n_compiled, warm_examples = prewarm_buckets(service, requests)
        warm_tickets = [service.submit(q) for q in
                        requests[:min(len(requests), max_batch)]]
        warm_tickets += [service.submit(q) for q in warm_examples]
        for t in warm_tickets:
            service.result(t, timeout=120)
        service.metrics.reset_window()

        if scenario is not None:
            # Faults perturb steady-state traffic, not the compiles.
            injector = _faults.install(_faults.FaultInjector(
                scenario, metrics=service.metrics))

        errors: List[str] = []
        tickets = []
        dropped = 0
        window = (max(4 * max_batch, 64) if inflight is None
                  else int(inflight))
        sem = threading.Semaphore(window)
        t0 = time.perf_counter()
        next_due = t0
        for i, qp in enumerate(requests):
            if mode == "closed":
                sem.acquire()
            else:
                next_due = (t0 + float(arrivals[i])
                            if arrivals is not None
                            else next_due + 1.0 / rate)
                delay = next_due - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            if _faults.enabled():
                # data.feed seam: a feed_corrupt directive poisons this
                # request's objective vector before submission.
                act = _faults.fire("data.feed", i=i)
                if act is not None and act.kind == "feed_corrupt":
                    qp = _faults.corrupt_feed(qp, act)
            try:
                # Open-loop arrivals never block on a full queue: a full
                # queue is a dropped arrival, reported as such.
                ticket = service.submit(
                    qp, deadline_s=deadline_s,
                    warm_key=str(i) if warm_keys else None,
                    timeout=None if mode == "closed" else 0.0,
                    tenant=None if tenants is None else tenants[i])
            except QueueFull:
                dropped += 1
                if mode == "closed":
                    sem.release()
                continue
            if mode == "closed":
                ticket.future.add_done_callback(lambda _f: sem.release())
            tickets.append(ticket)
        solved = 0
        status_counts: Dict[str, int] = {}
        for ticket in tickets:
            try:
                res = service.result(ticket, timeout=300)
                solved += int(res.found)
                name = _STATUS_NAMES.get(res.status, str(res.status))
                status_counts[name] = status_counts.get(name, 0) + 1
            except Exception as exc:  # noqa: BLE001 - reported, not fatal
                errors.append(f"{type(exc).__name__}: {exc}")
        elapsed = time.perf_counter() - t0
        if injector is not None:
            _faults.uninstall()
            injector = None
        n_done = len(tickets) - len(errors)

        snap = service.snapshot()
        if jsonl_path:
            service.metrics.write_jsonl(jsonl_path)
        tenant_fields = ({} if tenants is None
                         else _tenant_fields(snap, tenants, offenders))
        return {
            **tenant_fields,
            "n_requests": len(requests),
            "n_assets": int(requests[0].n),
            "mode": mode,
            "rate": rate,
            "max_batch": max_batch,
            "max_wait_ms": max_wait_ms,
            "continuous": continuous,
            "elapsed_s": elapsed,
            "throughput_solves_per_s": (n_done / elapsed
                                        if elapsed > 0 else 0.0),
            "solved": solved,
            "status_counts": status_counts,
            "segment_occupancy_mean": snap["segment_occupancy_mean"],
            "wasted_lane_fraction": snap["wasted_lane_fraction"],
            "lane_segments": snap["lane_segments"],
            "lanes_retired_budget": snap["lanes_retired_budget"],
            "errors": len(errors),
            "dropped_arrivals": dropped,
            "error_sample": errors[:3],
            "chaos": None if scenario is None else scenario.name,
            "faults_injected": snap["faults_injected"],
            "latency_p50_ms": snap["latency_p50_ms"],
            "latency_p99_ms": snap["latency_p99_ms"],
            "latency_mean_ms": snap["latency_mean_ms"],
            "occupancy_mean": snap["occupancy_mean"],
            "batches": snap["batches"],
            "recompiles_after_warmup": snap["compiles"],
            "prewarm_compiles": n_compiled,
            "warm_hits": snap["warm_hits"],
            "queue_depth_max": snap["queue_depth_max"],
            "degraded": snap["degraded"],
            "device": snap["device"],
            "iters_mean": snap["iters_mean"],
        }
    finally:
        if injector is not None:
            _faults.uninstall()
        if own_service:
            service.stop()
