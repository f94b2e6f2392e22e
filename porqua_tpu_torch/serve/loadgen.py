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

The observability, retry, blend and device-cost options are the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from porqua_tpu_torch.obs import devprof
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


def _tenant_fields(snap: Dict, tenant_set, tenants: List[str],
                   offenders, sink) -> Dict:
    """The report's tenant axis: per-tenant counter/latency rows, the
    per-tenant SLO status, and the ``tenant_fairness`` block
    (quiet-tenant p99 ratio, victim shed share, alert isolation, exact
    per-tenant harvest reconciliation). Warm-up traffic runs untagged,
    so every figure covers exactly the measured window."""
    measured = sorted(set(tenants))
    snap_tenants = snap.get("tenants") or {}
    rows = {t: snap_tenants.get(t, {}) for t in measured}
    out: Dict = {"tenants": rows}
    fired: Dict[str, int] = {}
    if tenant_set is not None:
        out["tenant_slo"] = tenant_set.status()
        fired = tenant_set.alerts_fired()
    off = set(offenders or ())
    quiet = {t: r for t, r in rows.items() if t not in off}
    p99s = [float(r.get("latency_p99_ms", 0.0)) for r in quiet.values()
            if r.get("completed")]
    fairness: Dict = {
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
        # Alert isolation: the offender's burn fires its own engines.
        "offender_alerts": sum(v for t, v in fired.items() if t in off),
        "nonoffender_alerts": sum(v for t, v in fired.items()
                                  if t not in off and t in measured),
    }
    if sink is not None:
        # Exact per-tenant reconciliation: one SolveRecord per
        # completed request, per tenant.
        from porqua_tpu_torch.obs.harvest import load_harvest

        sink.flush()
        records = (load_harvest(sink.path) if sink.path is not None
                   else sink.buffered())
        counts: Dict[str, int] = {}
        for rec in records:
            t = str(rec.get("tenant", ""))
            if t in rows:
                counts[t] = counts.get(t, 0) + 1
        out["tenant_harvest_records"] = counts
        fairness["harvest_reconciled"] = int(all(
            counts.get(t, 0) == int(rows[t].get("completed", 0))
            for t in measured))
    out["tenant_fairness"] = fairness
    return out


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
    ``mode="open"``: requests are submitted on a fixed-``rate`` schedule
    (or at the per-request ``arrivals`` offsets) regardless of
    completions; a full queue drops the arrival. ``warm_keys`` tags
    each request with its stream index. An externally-managed
    ``service`` (already started) may be passed; otherwise one is
    created on ``device`` (default: the card) and torn down.

    Observability: ``trace_out`` writes the run's request spans as a
    Chrome trace (with span-coverage figures in the report, and a
    :class:`~porqua_tpu_torch.obs.profile.StageProfiler`'s counter
    tracks merged in); ``events_out`` the event log (JSONL);
    ``ring_size`` solves with convergence rings and emits a
    ``convergence_ring`` event for the first ``ring_samples`` results;
    ``harvest_out`` appends one SolveRecord per resolved request to a
    JSONL(.gz) dataset. ``slo`` (``True`` for the default set at
    ``slo_latency_target_s``, or an ``SLOEngine``), ``flight_out`` (a
    directory or a ``FlightRecorder``), ``anomaly_baseline`` (a harvest
    dataset path or an ``AnomalyDetector``) and ``tenant_slos``
    (``True`` or a ``TenantSLOSet``) arm the live plane. These, the
    tenancy knobs, ``ring_size`` and ``harvest_out`` wire at service
    construction and raise against an external service.

    Resilience: ``retry`` (a :class:`RetryPolicy`) routes every request
    through the recovery layer. ``chaos`` names a builtin fault
    scenario (or passes a ``Scenario``) installed for the measured
    phase only; with ``chaos`` and no ``retry`` the default
    ``RetryPolicy`` applies, unless ``no_retry=True`` asks for the raw
    fault behaviour. Retries go through the service's breaker: they
    reach a CPU only when the service names one as its fallback.

    Tenancy: ``tenants`` tags each request with a tenant id;
    ``arrivals`` replaces fixed-rate pacing with per-request offsets
    (the :mod:`porqua_tpu_torch.serve.workloads` blend shape);
    ``tenant_quota`` / ``tenant_weights`` configure admission quotas
    and DRR weights; ``offenders`` names the tenants the report's
    ``tenant_fairness`` treats as noisy.

    Device cost: the service's cache harvests one CostRecord per built
    entry by default; the report's ``cost_summary`` gives their count
    and largest bytes accessed and peak memory, and ``cost_out`` writes
    them as JSONL(.gz). ``profile_window_s`` opens a bounded
    ``torch.profiler`` window over the measured phase (stopped by its
    timer, or at the end of the run if sooner), written under
    ``profile_dir`` (default ``porqua_profile_trace``); the report
    links it as ``profile_trace_dir``."""
    if mode not in ("closed", "open"):
        raise ValueError(f"unknown mode {mode!r}; expected closed|open")
    if mode == "open" and not rate and arrivals is None:
        raise ValueError("open-loop mode requires a rate (solves/s) "
                         "or per-request arrival offsets (arrivals=)")
    if arrivals is not None and len(arrivals) != len(requests):
        raise ValueError("arrivals must align 1:1 with requests")
    if tenants is not None and len(tenants) != len(requests):
        raise ValueError("tenants must align 1:1 with requests")
    if no_retry and retry is not None:
        raise ValueError("no_retry=True contradicts an explicit retry "
                         "policy; pass one or the other")
    scenario = None
    retry_requested = retry is not None
    if chaos is not None:
        if isinstance(chaos, _faults.Scenario):
            scenario = chaos
        else:
            catalog = _faults.builtin_scenarios(seed=chaos_seed)
            if chaos not in catalog:
                raise ValueError(
                    f"unknown chaos scenario {chaos!r}; builtin: "
                    f"{', '.join(sorted(catalog))}")
            scenario = catalog[chaos]
        if retry is None and not no_retry:
            from porqua_tpu_torch.resilience.retry import RetryPolicy

            retry = RetryPolicy()

    obs = sink = profiler = slo_engine = flight = anomaly = None
    tenant_set = None
    own_service = service is None
    if own_service:
        from porqua_tpu_torch import obs as _obs

        if tenant_slos:
            tenant_set = (tenant_slos
                          if isinstance(tenant_slos, _obs.TenantSLOSet)
                          else _obs.TenantSLOSet())
        if ring_size:
            params = dataclasses.replace(params, ring_size=int(ring_size))
        if trace_out or events_out or ring_size or slo or flight_out \
                or anomaly_baseline:
            obs = _obs.Observability()
        if slo:
            slo_engine = (slo if isinstance(slo, _obs.SLOEngine)
                          else _obs.SLOEngine(_obs.default_slos(
                              latency_target_s=slo_latency_target_s)))
        if flight_out:
            flight = (flight_out
                      if isinstance(flight_out, _obs.FlightRecorder)
                      else _obs.FlightRecorder(out_dir=flight_out))
        if anomaly_baseline:
            anomaly = (anomaly_baseline
                       if isinstance(anomaly_baseline, _obs.AnomalyDetector)
                       else _obs.AnomalyDetector.from_harvest(
                           anomaly_baseline))
        if harvest_out:
            sink = _obs.HarvestSink(
                harvest_out, events=None if obs is None else obs.events)
        if trace_out:
            profiler = _obs.StageProfiler()
        service = SolveService(params=params, max_batch=max_batch,
                               max_wait_ms=max_wait_ms,
                               queue_capacity=max(4 * max_batch, 1024),
                               obs=obs, continuous=continuous,
                               segment_budget=segment_budget,
                               retry=retry, harvest=sink,
                               profiler=profiler, slo=slo_engine,
                               flight=flight, anomaly=anomaly,
                               tenant_quota=tenant_quota,
                               tenant_weights=tenant_weights,
                               tenant_slos=tenant_set,
                               device=device)
        service.start()
    else:
        obs, sink, profiler = service.obs, service.harvest, service.profiler
        slo_engine, flight, anomaly = (service.slo, service.flight,
                                       service.anomaly)
        tenant_set = service.tenant_slos
        if tenant_quota is not None or tenant_weights or tenant_slos:
            raise ValueError(
                "tenant_quota/tenant_weights/tenant_slos require the "
                "service to be constructed here; build it with "
                "SolveService(tenant_quota=..., tenant_weights=..., "
                "tenant_slos=TenantSLOSet(...))")
        if slo or flight_out or anomaly_baseline:
            raise ValueError(
                "slo/flight_out/anomaly_baseline require the service "
                "to be constructed here; build it with SolveService("
                "slo=..., flight=..., anomaly=...) and read those "
                "objects directly")
        if harvest_out is not None or ring_size:
            raise ValueError(
                "harvest_out/ring_size require the service to be "
                "constructed here; build it with SolveService(harvest="
                "HarvestSink(path), params=...ring_size...) instead")
        if service._retry is None:
            if retry_requested:
                raise ValueError(
                    "run_loadgen cannot apply a retry policy to an "
                    "externally-built service; construct it with "
                    "SolveService(retry=...)")
            if scenario is not None and not no_retry:
                raise ValueError(
                    "chaos against an externally-built service "
                    "requires it to carry a retry policy "
                    "(SolveService(retry=RetryPolicy(...))): the "
                    "validation gate keeps corrupting scenarios from "
                    "resolving wrong answers (pass no_retry=True to "
                    "measure raw fault behaviour)")
        elif no_retry:
            raise ValueError(
                "no_retry=True cannot be honored for an externally-"
                "built service that carries a retry policy")
    injector = None
    window_trace = None
    if profile_window_s is not None or profile_dir is not None:
        window_trace = devprof.ProfileWindow(
            profile_dir or "porqua_profile_trace",
            window_s=profile_window_s)
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
        # The sink saw the warm-up round too; remember the boundary so
        # the report reconciles the measured window's records.
        harvest_records0 = sink.records if sink is not None else 0

        if scenario is not None:
            # Faults perturb steady-state traffic, not the compiles.
            injector = _faults.install(_faults.FaultInjector(
                scenario, metrics=service.metrics,
                events=None if obs is None else obs.events))

        if window_trace is not None:
            # The window opens with the measured phase (after prewarm
            # and warm-up: steady-state dispatches, not builds) and is
            # bounded by its timer even if the run hangs.
            window_trace.start()

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
        sampled = []  # first few results, for convergence-ring events
        for ticket in tickets:
            try:
                res = service.result(ticket, timeout=300)
                solved += int(res.found)
                name = _STATUS_NAMES.get(res.status, str(res.status))
                status_counts[name] = status_counts.get(name, 0) + 1
                if res.ring_prim is not None and len(sampled) < ring_samples:
                    sampled.append(res)
            except Exception as exc:  # noqa: BLE001 - reported, not fatal
                errors.append(f"{type(exc).__name__}: {exc}")
        elapsed = time.perf_counter() - t0
        if window_trace is not None:
            # Stop before the report, so the linked trace is written (a
            # no-op when the timer already fired).
            window_trace.stop()
        if injector is not None:
            _faults.uninstall()
            injector = None
        n_done = len(tickets) - len(errors)

        snap = service.snapshot()
        if jsonl_path:
            service.metrics.write_jsonl(jsonl_path)
        # Closing evaluations before the event log is written: a burn
        # that crested between the clock-gated evaluations still lands
        # its alert transitions (and can still trigger a flight dump).
        if slo_engine is not None:
            slo_engine.evaluate()
        if tenant_set is not None:
            tenant_set.evaluate()

        obs_fields: Dict = {}
        if obs is not None:
            from porqua_tpu_torch.obs.rings import ring_history
            from porqua_tpu_torch.obs.report import coverage_stats

            for res in sampled:
                hist = ring_history(res.ring_prim, res.ring_dual,
                                    res.ring_rho, res.iters,
                                    service.params.check_interval)
                obs.events.emit(
                    "convergence_ring", "info", trace_id=res.trace_id,
                    iters_final=res.iters,
                    final_prim_res=res.prim_res,
                    final_dual_res=res.dual_res, **hist)
            trace = obs.spans.chrome_trace()
            cov = coverage_stats(trace)
            obs_fields = {
                "trace_events": len(trace["traceEvents"]),
                "spans_dropped": obs.spans.dropped,
                "span_cover_median": round(cov["cover_median"], 4),
                "span_cover_min": round(cov["cover_min"], 4),
            }
            if profiler is not None:
                from porqua_tpu_torch.obs.profile import (
                    chrome_counter_events)

                trace["traceEvents"].extend(chrome_counter_events(
                    profiler, obs.spans.anchor_mono))
                obs_fields["profile_stages"] = {
                    k: round(v, 4)
                    for k, v in profiler.stage_seconds().items()}
            if trace_out:
                with open(trace_out, "w") as f:
                    json.dump(trace, f)
                obs_fields["trace_out"] = trace_out
            if events_out:
                obs.events.write_jsonl(events_out)
                obs_fields["events_out"] = events_out
        if slo_engine is not None:
            obs_fields["slo"] = slo_engine.status()
        if flight is not None:
            fc = flight.counters()
            obs_fields["incident_bundles"] = fc["flight_bundles"]
            obs_fields["incident_dumps_suppressed"] = (
                fc["flight_dumps_suppressed"])
            obs_fields["incident_bundle_paths"] = [
                p for p in flight.bundles() if isinstance(p, str)][:8]
        if anomaly is not None:
            ast = anomaly.status()
            obs_fields["convergence_anomalies"] = ast["fired"]
            obs_fields["anomalous_groups"] = ast["anomalous"]
        # The run's cost records (harvested by the cache unless its
        # plane is off; cost_out persists them).
        cost_records = service.cache.cost_records()
        if cost_records:
            bytes_vals = [r["bytes_accessed"] for r in cost_records
                          if r.get("bytes_accessed")]
            peak_vals = [r["peak_bytes"] for r in cost_records
                         if r.get("peak_bytes")]
            obs_fields["cost_summary"] = {
                "executables": len(cost_records),
                "bytes_accessed_max": max(bytes_vals) if bytes_vals else None,
                "peak_bytes_max": max(peak_vals) if peak_vals else None,
            }
        if cost_out:
            obs_fields["cost_out"] = cost_out
            obs_fields["cost_records"] = devprof.write_cost_records(
                cost_out, cost_records)
        if window_trace is not None:
            obs_fields["profile_trace_dir"] = window_trace.logdir
            obs_fields["profile_window_s"] = profile_window_s
            if window_trace.error:
                obs_fields["profile_trace_error"] = window_trace.error
        if tenants is not None:
            obs_fields.update(_tenant_fields(
                snap, tenant_set, tenants, offenders, sink))
        if sink is not None:
            sink.flush()
            obs_fields.update({
                "harvest_out": sink.path,
                "harvest_records": sink.records,
                # Records of the measured window alone: reconciles with
                # the snapshot's `completed`.
                "harvest_records_measured": sink.records - harvest_records0,
                "harvest_write_failures": sink.write_failures,
            })
        if getattr(service, "router", None) is not None:
            rsnap = service.router.snapshot()
            obs_fields["route_table_version"] = rsnap["table_version"]
            obs_fields["route_table"] = rsnap["table"]
        return {
            **obs_fields,
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
            "retries": snap["retries"],
            "hedges_fired": snap["hedges_fired"],
            "hedges_won": snap["hedges_won"],
            "resumed_requests": snap["resumed_requests"],
            "retry_giveups": snap["retry_giveups"],
            "validation_failures": snap["validation_failures"],
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
        if window_trace is not None:
            # Exception path: a dangling profiler would outlive the run.
            window_trace.stop()
        if injector is not None:
            _faults.uninstall()
        if own_service:
            service.stop()
            if sink is not None:
                sink.close()
