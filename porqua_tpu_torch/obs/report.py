"""Render one serving run as text: waterfall, latency, sparklines (the
port of ``porqua_tpu/obs/report.py``: the same text from the same
files, either package's).

The reader side of the observability pillar — consumes the three
artifacts a traced run emits (the Chrome-trace span file, the event
JSONL, the metrics snapshot) and renders what an operator actually
asks: *where did the time go* (stage waterfall aggregated over every
request span), *what did callers see* (latency/throughput table), and
*what did the solver do on device* (convergence sparklines from ring
events). The JAX package's ``scripts/obs_report.py`` is the CLI. Pure
host/stdlib+numpy: rendering a report touches no device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Canonical request-span order, for waterfall sorting.
STAGE_ORDER = ("submit", "queue_wait", "assemble", "solve", "resolve")

_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _trace_events(trace: Any) -> List[Dict[str, Any]]:
    """Accept either the Chrome trace object or its event list."""
    if isinstance(trace, dict):
        return list(trace.get("traceEvents", []))
    return list(trace or [])


def span_aggregate(trace: Any) -> Dict[str, Dict[str, float]]:
    """Per-stage rollup over every ``"X"`` event: count, total/mean/max
    milliseconds."""
    agg: Dict[str, List[float]] = {}
    for e in _trace_events(trace):
        if e.get("ph") != "X":
            continue
        agg.setdefault(e["name"], []).append(float(e.get("dur", 0.0)))
    out: Dict[str, Dict[str, float]] = {}
    for name, durs in agg.items():
        a = np.asarray(durs)
        out[name] = {
            "count": float(a.size),
            "total_ms": float(a.sum()) * 1e-3,
            "mean_ms": float(a.mean()) * 1e-3,
            "p99_ms": float(np.percentile(a, 99)) * 1e-3,
            "max_ms": float(a.max()) * 1e-3,
        }
    return out


def span_coverage(trace: Any) -> List[Tuple[str, float, float]]:
    """Per-request ``(trace_id, spans_sum_s, extent_s)``.

    ``spans_sum_s`` adds every span duration carrying the trace id;
    ``extent_s`` is last-span-end minus first-span-start — the
    request's observed wall-clock. A well-instrumented pipeline has the
    two within a few percent (the acceptance bar: 10%); a gap means a
    stage is living outside any span.
    """
    per: Dict[str, List[Tuple[float, float]]] = {}
    for e in _trace_events(trace):
        if e.get("ph") != "X":
            continue
        tid = (e.get("args") or {}).get("trace_id")
        if tid is None:
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        per.setdefault(tid, []).append((ts, dur))
    out = []
    for tid, spans in per.items():
        total = sum(d for _, d in spans) * 1e-6
        extent = (max(ts + d for ts, d in spans)
                  - min(ts for ts, _ in spans)) * 1e-6
        out.append((tid, total, extent))
    return out


def coverage_stats(trace: Any) -> Dict[str, float]:
    """Summary of :func:`span_coverage`: median/min cover ratio."""
    cov = span_coverage(trace)
    if not cov:
        return {"n_traces": 0, "cover_median": 0.0, "cover_min": 0.0}
    ratios = sorted(t / e if e > 0 else 1.0 for _, t, e in cov)
    return {
        "n_traces": len(ratios),
        "cover_median": ratios[len(ratios) // 2],
        "cover_min": ratios[0],
    }


def sparkline(values: Sequence[float], width: int = 40,
              log: bool = False) -> str:
    """A one-line unicode sparkline (``log=True`` for residual decay —
    linear scale renders a 1e6-range trajectory as one step)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    if log:
        floor = 1e-300
        vals = [math.log10(max(abs(v), floor)) for v in vals]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_GLYPHS[0] * len(vals)
    return "".join(
        _SPARK_GLYPHS[min(int((v - lo) / span * len(_SPARK_GLYPHS)),
                          len(_SPARK_GLYPHS) - 1)]
        for v in vals)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def waterfall_section(trace: Any) -> str:
    agg = span_aggregate(trace)
    if not agg:
        return "stage waterfall: (no spans)"
    order = {name: i for i, name in enumerate(STAGE_ORDER)}
    names = sorted(agg, key=lambda n: (order.get(n, len(order)), n))
    width = max(len(n) for n in names)
    total = sum(agg[n]["total_ms"] for n in names)
    lines = ["stage waterfall (all requests)",
             f"{'stage':<{width}}  {'count':>7} {'total ms':>10} "
             f"{'mean ms':>9} {'p99 ms':>9}  share"]
    for n in names:
        a = agg[n]
        share = a["total_ms"] / total if total else 0.0
        bar = "#" * max(int(share * 30), 1 if a["total_ms"] else 0)
        lines.append(
            f"{n:<{width}}  {int(a['count']):>7} {a['total_ms']:>10.1f} "
            f"{a['mean_ms']:>9.3f} {a['p99_ms']:>9.3f}  {bar}")
    cov = coverage_stats(trace)
    if cov["n_traces"]:
        lines.append(
            f"span coverage: {cov['n_traces']} traces, median "
            f"{cov['cover_median']:.2f}x of request wall-clock "
            f"(min {cov['cover_min']:.2f}x)")
    return "\n".join(lines)


def latency_section(snapshot: Dict[str, Any]) -> str:
    rows = [
        ("completed", snapshot.get("completed", 0)),
        ("failed", snapshot.get("failed", 0)),
        ("expired", snapshot.get("expired", 0)),
        ("rejected", snapshot.get("rejected", 0)),
        ("throughput solves/s",
         round(float(snapshot.get("throughput_solves_per_s", 0.0)), 1)),
        ("latency p50 ms",
         round(float(snapshot.get("latency_p50_ms", 0.0)), 3)),
        ("latency p90 ms",
         round(float(snapshot.get("latency_p90_ms", 0.0)), 3)),
        ("latency p99 ms",
         round(float(snapshot.get("latency_p99_ms", 0.0)), 3)),
        ("occupancy mean",
         round(float(snapshot.get("occupancy_mean", 0.0)), 4)),
        ("queue wait s",
         round(float(snapshot.get("queue_wait_seconds", 0.0)), 3)),
        ("solve s", round(float(snapshot.get("solve_seconds", 0.0)), 3)),
        ("recompiles", snapshot.get("compiles", 0)),
        ("device", snapshot.get("device")),
        ("degraded", snapshot.get("degraded", False)),
    ]
    width = max(len(k) for k, _ in rows)
    return "\n".join(["latency / throughput"]
                     + [f"{k:<{width}}  {v}" for k, v in rows])


def convergence_section(events: Sequence[Dict[str, Any]],
                        max_rings: int = 8) -> str:
    """Sparklines from ``convergence_ring`` events (the decoded ring
    payloads the load generator emits for a sample of requests)."""
    rings = [e for e in events if e.get("kind") == "convergence_ring"]
    if not rings:
        return "convergence: (no ring events)"
    lines = ["convergence rings (log10 residual sparklines)"]
    for e in rings[:max_rings]:
        label = e.get("trace_id") or e.get("request", "?")
        iters = e.get("iters_final", (e.get("iters") or [0])[-1])
        prim = e.get("prim_res", [])
        dual = e.get("dual_res", [])
        final_p = prim[-1] if prim else float("nan")
        final_d = dual[-1] if dual else float("nan")
        lines.append(f"  {label}: {iters} iters, "
                     f"final prim {final_p:.2e} dual {final_d:.2e}")
        lines.append(f"    prim {sparkline(prim, log=True)}")
        lines.append(f"    dual {sparkline(dual, log=True)}")
    return "\n".join(lines)


#: Event kinds the faults/recovery section treats as recovery-side
#: (emitted by porqua_tpu_torch.resilience.retry and the breaker), keyed to
#: the injected faults they answer.
_RECOVERY_KINDS = ("retry_scheduled", "retry_giveup", "hedge_fired",
                   "validation_failed", "breaker_open", "breaker_close",
                   "probe_failure", "dispatch_failure")


def faults_section(events: Sequence[Dict[str, Any]],
                   max_shown: int = 8) -> str:
    """Faults vs recovery, from the event log: what the injector (or
    the real world) did, per seam and kind, next to what the recovery
    machinery did about it — the at-a-glance answer to "did the chaos
    scenario exercise the paths it claimed to" (the invariant-level
    verdicts live in ``scripts/chaos_suite.py``'s JSON report)."""
    injected = [e for e in events if e.get("kind") == "fault_injected"]
    recovery: Dict[str, int] = {}
    for e in events:
        k = e.get("kind")
        if k in _RECOVERY_KINDS:
            recovery[k] = recovery.get(k, 0) + 1
    if not injected and not recovery:
        return "faults / recovery: (no fault or recovery events)"
    lines = ["faults / recovery"]
    by_fault: Dict[Tuple[str, str], int] = {}
    for e in injected:
        key = (e.get("seam", "?"), e.get("fault_kind", "?"))
        by_fault[key] = by_fault.get(key, 0) + 1
    scenarios = sorted({e.get("scenario") for e in injected
                        if e.get("scenario")})
    if scenarios:
        lines.append(f"  scenario(s): {', '.join(scenarios)}")
    for (seam, kind), n in sorted(by_fault.items()):
        lines.append(f"  injected {seam:<18} {kind:<14} x{n}")
    for kind in _RECOVERY_KINDS:
        if kind in recovery:
            lines.append(f"  recovery {kind:<24} x{recovery[kind]}")
    # A breaker that opened and never re-closed is the one line an
    # operator must not miss.
    opens = recovery.get("breaker_open", 0)
    closes = recovery.get("breaker_close", 0)
    if opens or closes:
        state = ("re-closed" if closes >= opens else
                 "STILL OPEN (degraded)")
        lines.append(f"  breaker: {opens} open / {closes} close -> {state}")
    giveups = [e for e in events if e.get("kind") == "retry_giveup"]
    for e in giveups[-max_shown:]:
        detail = {k: v for k, v in e.items()
                  if k not in ("t", "kind", "severity")}
        lines.append(f"  ! giveup {detail}")
    return "\n".join(lines)


#: Status code -> short label for harvest convergence classes (mirrors
#: qp.admm.Status; literal so the report stays backend-free).
_STATUS_LABELS = {1: "solved", 2: "max_iter", 3: "primal_infeasible",
                  4: "dual_infeasible"}


def harvest_section(records: Sequence[Dict[str, Any]],
                    max_rings_per_class: int = 3) -> str:
    """Convergence analytics from a harvest dataset: ring-trajectory
    sparklines grouped per terminal-status class (a stalled MAX_ITER
    trajectory looks nothing like a converging one — the at-a-glance
    view of WHY the tail is slow), then the per-(bucket, eps)
    wasted-iteration attribution table the learned-policy work trains
    against (full aggregation: ``scripts/harvest_report.py``)."""
    from porqua_tpu_torch.obs.harvest import aggregate

    records = list(records)
    if not records:
        return "harvest: (no records)"
    lines = [f"harvest convergence analytics ({len(records)} records)"]
    by_class: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("ring"):
            label = _STATUS_LABELS.get(int(rec.get("status", 0)),
                                       str(rec.get("status")))
            by_class.setdefault(label, []).append(rec)
    if not by_class:
        lines.append("  (no ring trajectories in the dataset — "
                     "harvest with SolverParams(ring_size>0))")
    for label in sorted(by_class):
        recs = by_class[label]
        lines.append(f"  {label}: {len(recs)} trajectories")
        for rec in recs[:max_rings_per_class]:
            ring = rec["ring"]
            who = rec.get("trace_id") or f"lane {rec.get('lane', '?')}"
            lines.append(
                f"    {who}: {rec['iters']} iters, final prim "
                f"{rec['prim_res']:.2e} dual {rec['dual_res']:.2e}")
            lines.append(f"      prim {sparkline(ring['prim_res'], log=True)}")
            lines.append(f"      dual {sparkline(ring['dual_res'], log=True)}")
    agg = aggregate(records)
    lines.append("  wasted-iteration attribution by (bucket, eps):")
    for g in agg["groups"]:
        eps = g["eps_abs"]
        wc = g.get("warm_minus_cold_iters_mean")
        lines.append(
            f"    {g['bucket']:<12} eps "
            f"{(f'{eps:.0e}' if eps is not None else '-'):>7}  "
            f"x{g['count']:<5} iters p50/p95 "
            f"{g['iters']['p50']:.0f}/{g['iters']['p95']:.0f}  "
            f"wasted {g['wasted_iteration_fraction']:.3f}"
            + (f"  warm-cold {wc:+.1f} iters" if wc is not None else ""))
    return "\n".join(lines)


def costs_section(records: Sequence[Dict[str, Any]],
                  harvest: Optional[Sequence[Dict[str, Any]]] = None,
                  max_rows: int = 12) -> str:
    """Device cost / memory from a CostRecord dataset: per-bucket peak
    device memory and measured bytes per executable (what XLA's cost
    analysis, or the port's counted warm-up, said the programs cost),
    plus — when harvest records with measured (``cost_source`` ``"xla"``
    or ``"torch"``) profiles are given — the
    measured-vs-model table: the analytic flop model's drift against
    the compiler per bucket, the number that says whether the hand
    roofline can still be trusted."""
    records = list(records)
    if not records:
        return "device cost / memory: (no CostRecords)"
    lines = [f"device cost / memory ({len(records)} CostRecords)"]
    by_bucket: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        by_bucket.setdefault(str(rec.get("bucket", "?")), []).append(rec)
    lines.append(f"  {'bucket':<14} {'exes':>4} {'peak MB (max)':>13} "
                 f"{'MB accessed (max)':>17} {'compile s':>9}")
    for bucket in sorted(by_bucket):
        recs = by_bucket[bucket]
        peaks = [r["peak_bytes"] for r in recs if r.get("peak_bytes")]
        bytes_ = [r["bytes_accessed"] for r in recs
                  if r.get("bytes_accessed")]
        compile_s = sum(float(r.get("compile_s") or 0.0) for r in recs)
        lines.append(
            f"  {bucket:<14} {len(recs):>4} "
            f"{(max(peaks) / 1e6 if peaks else 0.0):>13.2f} "
            f"{(max(bytes_) / 1e6 if bytes_ else 0.0):>17.2f} "
            f"{compile_s:>9.2f}")
    rows = records[:max_rows]
    lines.append("  per executable (bytes = XLA cost analysis):")
    for r in rows:
        ba, pk = r.get("bytes_accessed"), r.get("peak_bytes")
        lines.append(
            f"    {str(r.get('kind')):<11} {str(r.get('entry')):<9} "
            f"{str(r.get('bucket')):<12} x{r.get('slots') or 0:<5} "
            f"{(ba or 0) / 1e6:>10.2f} MB acc  "
            f"{(pk or 0) / 1e6:>8.2f} MB peak  "
            f"hlo {str(r.get('hlo_hash'))[:8]}")
    if harvest:
        measured = [h for h in harvest
                    if (h.get("profile") or {}).get("cost_source")
                    in ("xla", "torch")]
        if measured:
            lines.append("  measured-vs-model (per bucket; ratio = "
                         "analytic model / XLA):")
            groups: Dict[str, List[Dict[str, Any]]] = {}
            for h in measured:
                groups.setdefault(str(h.get("bucket", "?")),
                                  []).append(h["profile"])
            for bucket in sorted(groups):
                profs = groups[bucket]
                fr = [p["flops_model_ratio"] for p in profs
                      if p.get("flops_model_ratio")]
                br = [p["bytes_model_ratio"] for p in profs
                      if p.get("bytes_model_ratio")]
                mfu = [p["mfu_bf16_peak"] for p in profs
                       if p.get("mfu_bf16_peak") is not None]
                line = (f"    {bucket:<14} x{len(profs):<5}"
                        f" flops model/xla "
                        f"{(np.mean(fr) if fr else 0.0):.3f}"
                        f"  bytes model/xla "
                        f"{(np.mean(br) if br else 0.0):.3f}")
                if mfu:
                    line += f"  mfu(bf16) {np.mean(mfu):.4f}"
                lines.append(line)
        else:
            lines.append("  measured-vs-model: (no harvest records "
                         "with XLA-measured profiles)")
    return "\n".join(lines)


#: Event kinds rendered on the SLO/alert timeline (alert transitions
#: interleaved with the breaker and anomaly activity that explains
#: them).
_TIMELINE_KINDS = ("slo_alert", "breaker_open", "breaker_close",
                   "convergence_anomaly")


def slo_section(events: Sequence[Dict[str, Any]],
                max_shown: int = 40) -> str:
    """The SLO / alert timeline: every ``slo_alert`` state transition
    (pending -> firing -> resolved, with its burn rates) interleaved
    chronologically with breaker open/close and convergence-anomaly
    events — the one view that answers "the alert fired; what was the
    service doing at that moment"."""
    rows = [e for e in events if e.get("kind") in _TIMELINE_KINDS]
    if not rows:
        return "slo / alert timeline: (no slo, breaker or anomaly events)"
    rows = sorted(rows, key=lambda e: float(e.get("t", 0.0)))
    t0 = float(rows[0].get("t", 0.0))
    lines = ["slo / alert timeline"]
    # Count over EVERY row (only the tail is rendered): a firing
    # transition trimmed out of the displayed window must still show
    # in the totals and the STILL-FIRING verdict.
    fired = sum(1 for e in rows if e.get("kind") == "slo_alert"
                and e.get("state") == "firing")
    resolved = sum(1 for e in rows if e.get("kind") == "slo_alert"
                   and e.get("state") == "resolved")
    for e in rows[-max_shown:]:
        dt = float(e.get("t", 0.0)) - t0
        kind = e.get("kind")
        if kind == "slo_alert":
            state = e.get("state", "?")
            lines.append(
                f"  +{dt:8.2f}s  slo_alert  {e.get('slo', '?')}/"
                f"{e.get('rule', '?')} -> {state}  "
                f"(burn short {e.get('burn_short', 0.0):.1f} / long "
                f"{e.get('burn_long', 0.0):.1f}, thr "
                f"{e.get('threshold', 0.0):g})")
        elif kind == "convergence_anomaly":
            lines.append(
                f"  +{dt:8.2f}s  anomaly    {e.get('bucket', '?')} -> "
                f"{e.get('state', '?')}  (ewma iters "
                f"{e.get('ewma_iters', 0.0):g} vs band "
                f"{e.get('iters_band', 0.0):g})")
        else:
            who = e.get("primary") or e.get("device") or "?"
            lines.append(f"  +{dt:8.2f}s  {kind:<10} {who}")
    lines.append(f"  alerts: {fired} fired / {resolved} resolved"
                 + ("  !! STILL FIRING" if fired > resolved else ""))
    return "\n".join(lines)


#: Event kinds rendered on the calibration timeline (the closed
#: route-calibration loop's lifecycle — porqua_tpu_torch/obs/calibrate.py).
_CALIBRATION_KINDS = ("route_reseed", "route_rollback",
                      "solver_routes_seeded")


def calibration_section(events: Sequence[Dict[str, Any]],
                        max_shown: int = 40) -> str:
    """The route-calibration timeline: every ``route_reseed`` state
    transition (candidate → promoted → settled, or abandoned) with its
    table version and changed cells, every ``route_rollback`` with the
    breach that caused it, plus offline ``solver_routes_seeded``
    bootstraps — the view that answers "who changed the route table,
    when, and on what evidence"."""
    rows = [e for e in events if e.get("kind") in _CALIBRATION_KINDS]
    if not rows:
        return ("calibration timeline: (no route_reseed / "
                "route_rollback events)")
    rows = sorted(rows, key=lambda e: float(e.get("t", 0.0)))
    t0 = float(rows[0].get("t", 0.0))
    lines = ["calibration timeline"]
    promoted = sum(1 for e in rows if e.get("kind") == "route_reseed"
                   and e.get("state") == "promoted")
    rolled = sum(1 for e in rows if e.get("kind") == "route_rollback")
    for e in rows[-max_shown:]:
        dt = float(e.get("t", 0.0)) - t0
        kind = e.get("kind")
        if kind == "route_reseed":
            diff = e.get("diff") or {}
            cells = ", ".join(
                f"{c}:{d.get('old', '?')}->{d.get('new', '?')}"
                for c, d in sorted(diff.items())) or "(no cells)"
            lines.append(
                f"  +{dt:8.2f}s  route_reseed   "
                f"{e.get('state', '?'):<9} v{e.get('table_version', 0)}"
                f"  {cells}")
        elif kind == "route_rollback":
            lines.append(
                f"  +{dt:8.2f}s  route_rollback v"
                f"{e.get('table_version', 0)}  "
                f"[{e.get('reason', '?')}]")
        else:
            routes = e.get("routes") or {}
            lines.append(
                f"  +{dt:8.2f}s  routes_seeded  offline   "
                + (", ".join(f"{c}:{m}"
                             for c, m in sorted(routes.items()))
                   or "(none)"))
    lines.append(
        f"  promotions: {promoted} / rollbacks: {rolled}"
        + ("  !! ROLLED BACK" if rolled else ""))
    return "\n".join(lines)


def fleet_section(report: Dict[str, Any]) -> str:
    """The fleet view of a ``scripts/fleet_loadgen.py`` run: the
    per-worker throughput/latency table, the reconciliation verdict,
    the worker-liveness verdict line, the bounded-rollup throughput
    sparkline, and the fleet SLO/alert summary. (Pair with
    ``--events`` on the fleet event log for the full chronological
    SLO/alert timeline — :func:`slo_section` renders it.)"""
    rows = report.get("rows") or []
    lines = [f"fleet workers ({len(rows)})"]
    lines.append(f"  {'worker':<8} {'status':<8} {'completed':>10} "
                 f"{'failed':>7} {'thr/s':>9} {'p50 ms':>8} "
                 f"{'p99 ms':>8} {'recomp':>7} {'rss MB':>8}")
    for r in rows:
        vit = r.get("vitals") or {}
        rss = vit.get("rss_bytes")
        lines.append(
            f"  {r.get('worker', '?'):<8} {r.get('status', '?'):<8} "
            f"{r.get('completed', 0):>10} {r.get('failed', 0):>7} "
            f"{r.get('throughput_solves_per_s', 0.0):>9.1f} "
            f"{r.get('latency_p50_ms', 0.0):>8.2f} "
            f"{r.get('latency_p99_ms', 0.0):>8.2f} "
            f"{r.get('recompiles_after_warmup', 0):>7} "
            f"{(rss / 1e6 if rss else 0.0):>8.1f}")
    fleet = report.get("fleet") or {}
    lines.append(
        f"  fleet: {fleet.get('completed', 0)} completed, "
        f"{fleet.get('failed', 0)} failed, "
        f"{fleet.get('throughput_solves_per_s', 0.0):.1f}/s merged, "
        f"harvest {fleet.get('harvest_records')}")
    recon = report.get("reconciliation") or {}
    lines.append(
        ("  reconciliation: OK — fleet completed == sum(worker "
         "completed) == merged harvest records")
        if report.get("reconciled") else
        f"  reconciliation: !! MISMATCH {recon}")
    lost = report.get("workers_lost") or []
    n_ok = sum(1 for r in rows if r.get("status") != "lost")
    lines.append(
        f"  worker liveness: {n_ok} ok, {len(lost)} lost"
        + (f" — LOST: {', '.join(lost)} "
           f"({report.get('worker_lost_bundles', 0)} worker_lost "
           f"incident bundle(s) dumped)" if lost else " — all alive"))
    roll = report.get("rollups_tail") or []
    if roll:
        spark = sparkline([float(r.get("completed", 0)) for r in roll],
                          width=min(len(roll) * 2, 32))
        lines.append(
            f"  rollups (last {len(roll)} x "
            f"{roll[-1].get('span_s', 0):g}s windows) completed/window: "
            f"{spark}  [{report.get('rollup_windows', len(roll))} "
            f"windows total, ring-bounded]")
    slo = report.get("slo")
    if slo:
        firing = slo.get("firing") or []
        compl = ", ".join(
            f"{name} {entry.get('compliance', 1.0):.4f}"
            for name, entry in sorted(slo.get("slos", {}).items()))
        lines.append(
            f"  fleet slo: {compl}; alerts fired "
            f"{slo.get('alerts_fired', 0)}"
            + (f"; !! FIRING: {', '.join(firing)}" if firing
               else "; none firing"))
    if report.get("vitals_anomalous"):
        lines.append("  vitals: !! trending "
                     + ", ".join(report["vitals_anomalous"]))
    return "\n".join(lines)


def tenant_section(report: Dict[str, Any]) -> str:
    """The tenant view of a multi-tenant loadgen run (the
    ``run_loadgen(tenants=...)`` report, or any dict carrying its
    ``tenants`` / ``tenant_fairness`` / ``tenant_slo`` keys): the
    per-tenant counter/latency table, each tenant's SLO alert totals,
    and the fairness/isolation verdict line the bench gate's fairness
    rules machine-check."""
    tenants = report.get("tenants") or {}
    if not tenants:
        return "tenants: (no per-tenant data)"
    slo = report.get("tenant_slo") or {}
    lines = [f"tenants ({len(tenants)})"]
    lines.append(f"  {'tenant':<12} {'submitted':>9} {'completed':>9} "
                 f"{'rejected':>8} {'expired':>7} {'failed':>7} "
                 f"{'p50 ms':>8} {'p99 ms':>8} {'alerts':>7}")
    for t, row in sorted(tenants.items()):
        fired = (slo.get(t, {}).get("alerts_fired", 0)
                 if isinstance(slo.get(t), dict) else 0)
        lines.append(
            f"  {t:<12} {row.get('submitted', 0):>9} "
            f"{row.get('completed', 0):>9} {row.get('rejected', 0):>8} "
            f"{row.get('expired', 0):>7} {row.get('failed', 0):>7} "
            f"{row.get('latency_p50_ms', 0.0):>8.2f} "
            f"{row.get('latency_p99_ms', 0.0):>8.2f} {fired:>7}")
    fair = report.get("tenant_fairness")
    if fair:
        offenders = fair.get("offenders") or []
        verdict_ok = (fair.get("victim_shed_share", 0.0) == 0.0
                      and fair.get("nonoffender_alerts", 0) == 0)
        lines.append(
            f"  fairness: quiet p99 ratio "
            f"{fair.get('quiet_p99_ratio', 1.0):.2f}, victim shed "
            f"share {fair.get('victim_shed_share', 0.0):.4f}, alerts "
            f"offender={fair.get('offender_alerts', 0)} / others="
            f"{fair.get('nonoffender_alerts', 0)}"
            + (f" (offenders: {', '.join(offenders)})" if offenders
               else ""))
        lines.append("  isolation: "
                     + ("OK — no victim sheds, no non-offender alerts"
                        if verdict_ok else "!! VIOLATED"))
        if fair.get("harvest_reconciled") is not None:
            lines.append(
                "  per-tenant reconciliation: "
                + ("exact — tenant completed == tenant harvest records"
                   if fair["harvest_reconciled"] else "!! MISMATCH"))
    return "\n".join(lines)


def events_section(events: Sequence[Dict[str, Any]],
                   max_shown: int = 12) -> str:
    """Severity rollup + the most recent warn/error lines."""
    by_kind: Dict[Tuple[str, str], int] = {}
    for e in events:
        key = (e.get("severity", "info"), e.get("kind", "?"))
        by_kind[key] = by_kind.get(key, 0) + 1
    lines = ["events"]
    for (sev, kind), n in sorted(by_kind.items()):
        lines.append(f"  {sev:<5} {kind:<24} x{n}")
    notable = [e for e in events
               if e.get("severity") in ("warn", "error")
               and e.get("kind") != "convergence_ring"]
    for e in notable[-max_shown:]:
        detail = {k: v for k, v in e.items()
                  if k not in ("t", "kind", "severity")}
        lines.append(f"  ! {e['severity']} {e['kind']} {detail}")
    return "\n".join(lines)


def render_report(trace: Any = None,
                  events: Optional[Sequence[Dict[str, Any]]] = None,
                  snapshot: Optional[Dict[str, Any]] = None,
                  harvest: Optional[Sequence[Dict[str, Any]]] = None,
                  costs: Optional[Sequence[Dict[str, Any]]] = None,
                  fleet: Optional[Dict[str, Any]] = None,
                  tenants: Optional[Dict[str, Any]] = None) -> str:
    """The full text report from whichever artifacts exist."""
    sections = []
    if fleet is not None:
        sections.append(fleet_section(fleet))
    if tenants is not None:
        sections.append(tenant_section(tenants))
    if snapshot is not None:
        sections.append(latency_section(snapshot))
    if trace is not None:
        sections.append(waterfall_section(trace))
    if events is not None:
        sections.append(convergence_section(events))
        sections.append(faults_section(events))
        sections.append(slo_section(events))
        sections.append(calibration_section(events))
        sections.append(events_section(events))
    if harvest is not None:
        sections.append(harvest_section(harvest))
    if costs is not None:
        sections.append(costs_section(costs, harvest=harvest))
    if not sections:
        return ("obs_report: no artifacts given (need --trace/--events"
                "/--metrics/--harvest/--costs/--fleet/--tenants)")
    rule = "-" * 64
    return f"\n{rule}\n".join(sections)
