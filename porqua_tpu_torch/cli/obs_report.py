"""Render a traced serving run: waterfall, latency table, sparklines.

Consumes the artifacts a traced run emits and prints one text report:

* ``--trace trace.json`` — the Chrome-trace span file
  (``serve_loadgen --trace-out`` / ``SpanRecorder.write``):
  aggregated stage waterfall + per-request span coverage.
* ``--events events.jsonl`` — the structured event log
  (``--events-out`` / ``EventBus.write_jsonl``): severity rollup,
  notable warn/error lines, and convergence sparklines from
  ``convergence_ring`` events (``--rings K`` on the load generator).
* ``--metrics serve.jsonl`` — metrics snapshots
  (``ServeMetrics.write_jsonl``; the last line is rendered).
* ``--harvest harvest.jsonl[.gz]`` — a telemetry-warehouse dataset
  (``serve_loadgen --harvest-out`` / ``HarvestSink``): convergence
  sparklines per status class + wasted-iteration attribution by
  (bucket, eps). The full policy table:
  ``python -m porqua_tpu_torch.cli.harvest_report``.
* ``--costs costs.jsonl[.gz]`` — a CostRecord dataset
  (``serve_loadgen --cost-out`` / ``CostLog``): per-bucket peak
  device memory, the counted bytes per entry, and — joined with
  ``--harvest`` — the measured-vs-model MFU table. The fusion-target
  ranking: ``python -m porqua_tpu_torch.cli.roofline_report``.
* ``--fleet fleet_report.json`` — a merged fleet report (the fleet
  load generator's ``--out``): per-worker throughput/latency table,
  reconciliation + worker-liveness verdict lines, bounded-rollup
  sparkline, and the fleet SLO/alert summary.
* ``--tenants report.json`` — a multi-tenant loadgen report
  (``serve_loadgen --tenants ... --out``): per-tenant table +
  fairness/isolation verdict.

``--selftest`` builds a synthetic run in-process (no service, no
device work) and checks the rendering pipeline end to end.

Examples::

    python -m porqua_tpu_torch.cli.serve_loadgen \\
        --trace-out /tmp/trace.json --events-out /tmp/events.jsonl --rings 16
    python -m porqua_tpu_torch.cli.obs_report --trace /tmp/trace.json \\
        --events /tmp/events.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _selftest() -> int:
    """Exercise record -> export -> load -> render on synthetic data."""
    from porqua_tpu_torch.obs import Observability, load_jsonl, render_report
    from porqua_tpu_torch.obs.report import coverage_stats, sparkline

    obs = Observability()
    # Eight fake requests with contiguous submit/queue_wait/assemble/
    # solve/resolve spans — coverage must come out exactly 1.0.
    for i in range(8):
        t0 = 10.0 + 0.01 * i
        tid = obs.spans.new_trace()
        edges = [t0, t0 + 0.0002, t0 + 0.004 + 0.001 * i,
                 t0 + 0.0045 + 0.001 * i, t0 + 0.007 + 0.001 * i,
                 t0 + 0.0072 + 0.001 * i]
        for name, a, b in zip(
                ("submit", "queue_wait", "assemble", "solve", "resolve"),
                edges[:-1], edges[1:]):
            obs.spans.record(name, a, b, trace_id=tid, bucket="32x8")
        obs.events.emit("convergence_ring", trace_id=tid,
                        iters_final=25 * (i + 2),
                        iters=[25 * (j + 1) for j in range(i + 2)],
                        prim_res=[10.0 ** -(j + 1) for j in range(i + 2)],
                        dual_res=[10.0 ** -(j + 2) for j in range(i + 2)],
                        rho=[0.1] * (i + 2))
    obs.events.emit("compile", bucket="32x8", slots=8, seconds=0.5)
    obs.events.emit("breaker_open", "error", primary="cuda:0",
                    fallback="cpu:0", failures=2)
    # A synthetic chaos round-trip: injected faults answered by the
    # recovery machinery (the faults/recovery section renders both
    # sides, and the breaker-state line must say it re-closed).
    for _ in range(2):
        obs.events.emit("fault_injected", "warn", seam="serve.dispatch",
                        fault_kind="device_lost", scenario="device_lost")
    obs.events.emit("retry_scheduled", "warn", request_id="r1",
                    attempt=2, delay_s=0.02,
                    error="SolveError: injected device loss")
    obs.events.emit("retry_giveup", "error", request_id="r2",
                    reason="deadline", attempts=2, hedges=0,
                    error="DeadlineExpired: budget spent")
    obs.events.emit("hedge_fired", "info", request_id="r3", attempt=1)
    # SLO/alert timeline: a burn-rate alert firing between the breaker
    # open and close, a convergence anomaly, then the resolution — the
    # slo_section must interleave all of it chronologically.
    obs.events.emit("slo_alert", "error", slo="availability",
                    rule="fast", state="firing", burn_short=21.3,
                    burn_long=15.0, threshold=14.4, short_s=300.0,
                    long_s=3600.0, rule_severity="page")
    obs.events.emit("convergence_anomaly", "warn", state="firing",
                    bucket="32x8", eps=1e-3, ewma_iters=912.0,
                    iters_band=300.0, ewma_waste=0.51, waste_band=0.35,
                    n=12)
    obs.events.emit("breaker_close", "info", primary="cuda:0")
    obs.events.emit("slo_alert", "info", slo="availability",
                    rule="fast", state="resolved", burn_short=0.2,
                    burn_long=3.1, threshold=14.4, short_s=300.0,
                    long_s=3600.0, rule_severity="page")
    # Calibration timeline: the closed loop's full lifecycle — a
    # candidate promoted through canary, then guard-breached and
    # rolled back — the calibration_section must render with versions
    # and changed cells (a three-way promotion: two cells flipping to
    # two different winners in one table swap).
    diff = {"32x8@1e-03": {"old": "admm", "new": "pdhg"},
            "8x1@1e-03": {"old": "admm", "new": "napg"}}
    obs.events.emit("route_reseed", "info", state="candidate",
                    table_version=0, n_cells=2, diff=diff)
    obs.events.emit("route_reseed", "info", state="promoted",
                    table_version=1, n_cells=2, diff=diff,
                    table={"32x8@1e-03": "pdhg", "8x1@1e-03": "napg"})
    obs.events.emit("route_rollback", "error",
                    reason="anomaly_fired +1 since promotion",
                    table_version=2, restored_table={}, diff=diff)

    trace = obs.spans.chrome_trace()
    cov = coverage_stats(trace)
    assert cov["n_traces"] == 8, cov
    assert abs(cov["cover_median"] - 1.0) < 1e-6, cov
    assert abs(cov["cover_min"] - 1.0) < 1e-6, cov
    assert sparkline([1e-1, 1e-3, 1e-6], log=True)  # renders non-empty

    # A synthetic harvest dataset: converging vs stalled ring
    # trajectories across two (bucket, eps) groups, round-tripped
    # through the real on-disk format (gz) like everything else.
    from porqua_tpu_torch.obs import HarvestSink, load_harvest, solve_record
    from porqua_tpu_torch.obs.harvest import aggregate as _aggregate

    # Round-trip through the on-disk formats the real artifacts use.
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        tpath = os.path.join(td, "trace.json")
        epath = os.path.join(td, "events.jsonl")
        obs.write(trace_path=tpath, events_path=epath)
        with open(tpath) as f:
            trace = json.load(f)
        events = load_jsonl(epath)
        hpath = os.path.join(td, "harvest.jsonl.gz")
        with HarvestSink(hpath) as sink:
            for i in range(6):
                k = i + 2
                sink.emit(solve_record(
                    "serve", 24, 1, 1, 25 * k, 10.0 ** -(k + 1),
                    10.0 ** -(k + 2), -1.0, bucket="32x4",
                    eps_abs=1e-3, check_interval=25, segments=k,
                    warm=i % 2 == 0, trace_id=f"h-{i}",
                    ring={"iters": [25 * (j + 1) for j in range(k)],
                          "prim_res": [10.0 ** -(j + 1) for j in range(k)],
                          "dual_res": [10.0 ** -(j + 2) for j in range(k)],
                          "rho": [0.1] * k}))
            sink.emit(solve_record(
                "batch", 500, 1, 2, 2000, 1e-2, 1e-2, 0.0,
                bucket="512x4", eps_abs=1e-5, check_interval=25,
                segments=80, lane=7,
                ring={"iters": [1925, 1950, 1975, 2000],
                      "prim_res": [1e-2] * 4, "dual_res": [1e-2] * 4,
                      "rho": [0.1] * 4}))
        harvest = load_harvest(hpath)
    assert len(harvest) == 7, len(harvest)
    agg = _aggregate(harvest)
    assert agg["records"] == 7 and agg["ring_records"] == 7, agg

    snapshot = {"completed": 8, "failed": 0, "expired": 0, "rejected": 0,
                "throughput_solves_per_s": 1100.0, "latency_p50_ms": 4.2,
                "latency_p90_ms": 8.0, "latency_p99_ms": 9.9,
                "occupancy_mean": 0.91, "queue_wait_seconds": 0.03,
                "solve_seconds": 0.02, "compiles": 0,
                "device": "cpu:0", "degraded": False}
    # A synthetic CostRecord set (round-tripped through the real
    # on-disk format) + one harvest record with a counted
    # (cost_source: torch) profile, so the measured-vs-model table
    # renders.
    from porqua_tpu_torch.obs.devprof import (
        load_cost_records, write_cost_records)

    costs = [
        {"v": 1, "t": 0.0, "kind": "solve", "entry": "solve",
         "bucket": "32x8", "slots": 8, "dtype": "<f4", "device": "cpu:0",
         "compile_s": 1.5, "flops": 4.2e8, "bytes_accessed": 6.5e8,
         "peak_bytes": 4.2e7, "hlo_hash": "deadbeefcafef00d"},
        {"v": 1, "t": 0.0, "kind": "continuous", "entry": "step",
         "bucket": "32x8", "slots": 8, "dtype": "<f4", "device": "cpu:0",
         "compile_s": 0.9, "flops": 1.0e8, "bytes_accessed": 9.0e8,
         "peak_bytes": 5.1e7, "hlo_hash": "0123456789abcdef"},
    ]
    with tempfile.TemporaryDirectory() as td:
        cpath = os.path.join(td, "costs.jsonl.gz")
        assert write_cost_records(cpath, costs) == 2
        costs = load_cost_records(cpath)
    harvest.append({
        "v": 1, "source": "serve", "n": 24, "m": 1, "status": 1,
        "iters": 50, "prim_res": 1e-6, "dual_res": 1e-7, "obj_val": 0.0,
        "bucket": "32x8",
        "profile": {"cost_source": "torch", "flops_est": 4.2e8,
                    "bytes_est": 6.5e8, "model_flops": 5.0e8,
                    "model_bytes": 5.2e8, "flops_model_ratio": 1.19,
                    "bytes_model_ratio": 0.8, "peak_bytes": 4.2e7}})
    # A synthetic merged fleet report (the fleet load generator's --out
    # shape): one lost worker with its worker_lost bundle, exact
    # reconciliation over the survivors, rollup tail, SLO summary.
    fleet = {
        "workers": 3,
        "workers_lost": ["w2"],
        "worker_lost_bundles": 1,
        "reconciled": True,
        "reconciliation": {"completed_sample_equals_rows": True,
                           "harvest_equals_completed": True},
        "rows": [
            {"worker": "w0", "status": "ok", "completed": 1200,
             "failed": 0, "throughput_solves_per_s": 240.0,
             "latency_p50_ms": 4.1, "latency_p99_ms": 9.8,
             "recompiles_after_warmup": 0,
             "vitals": {"rss_bytes": 512e6, "open_fds": 40,
                        "threads": 12, "queue_depth": 3}},
            {"worker": "w1", "status": "ok", "completed": 1180,
             "failed": 2, "throughput_solves_per_s": 236.0,
             "latency_p50_ms": 4.3, "latency_p99_ms": 11.2,
             "recompiles_after_warmup": 0,
             "vitals": {"rss_bytes": 530e6}},
            {"worker": "w2", "status": "lost", "completed": 400,
             "failed": 0},
        ],
        "fleet": {"completed": 2780, "failed": 2,
                  "harvest_records": 2380,
                  "throughput_solves_per_s": 556.0},
        "rollups_tail": [{"completed": 450 + 10 * i, "span_s": 30.0}
                         for i in range(6)],
        "rollup_windows": 20,
        "slo": {"slos": {"availability": {"compliance": 0.9993},
                         "latency": {"compliance": 0.991}},
                "firing": [], "alerts_fired": 1},
        "vitals_anomalous": ["w1/rss_bytes"],
    }
    # A synthetic multi-tenant loadgen report (the serve_loadgen
    # --tenants shape): one bursting offender shed at its quota with
    # its own alert fired, two compliant quiet tenants, exact
    # per-tenant harvest reconciliation.
    tenant_report = {
        "tenants": {
            "alpha": {"submitted": 600, "completed": 600, "rejected": 0,
                      "expired": 0, "failed": 0, "latency_p50_ms": 4.0,
                      "latency_p99_ms": 9.1},
            "beta": {"submitted": 300, "completed": 300, "rejected": 0,
                     "expired": 0, "failed": 0, "latency_p50_ms": 4.4,
                     "latency_p99_ms": 10.2},
            "gamma": {"submitted": 2000, "completed": 900,
                      "rejected": 1100, "expired": 0, "failed": 0,
                      "latency_p50_ms": 6.0, "latency_p99_ms": 30.0},
        },
        "tenant_slo": {"alpha": {"alerts_fired": 0},
                       "beta": {"alerts_fired": 0},
                       "gamma": {"alerts_fired": 1}},
        "tenant_fairness": {
            "offenders": ["gamma"], "tenants": 3,
            "quiet_p99_ratio": 1.12, "victim_shed_share": 0.0,
            "offender_alerts": 1, "nonoffender_alerts": 0,
            "harvest_reconciled": 1,
        },
    }
    text = render_report(trace=trace, events=events, snapshot=snapshot,
                         harvest=harvest, costs=costs, fleet=fleet,
                         tenants=tenant_report)
    for needle in ("tenants (3)",
                   "gamma",
                   "quiet p99 ratio 1.12",
                   "alerts offender=1 / others=0",
                   "isolation: OK",
                   "per-tenant reconciliation: exact",
                   "fleet workers (3)",
                   "worker liveness: 2 ok, 1 lost",
                   "LOST: w2",
                   "1 worker_lost incident bundle",
                   "reconciliation: OK",
                   "rollups (last 6 x 30s windows)",
                   "fleet slo: availability 0.9993",
                   "alerts fired 1",
                   "vitals: !! trending w1/rss_bytes",
                   "stage waterfall", "queue_wait", "span coverage",
                   "convergence rings", "breaker_open",
                   "latency / throughput", "faults / recovery",
                   "injected serve.dispatch", "retry_scheduled",
                   "1 open / 1 close -> re-closed",
                   "harvest convergence analytics", "solved: 6",
                   "max_iter: 1", "wasted-iteration attribution",
                   "lane 7",
                   # The SLO/alert timeline: transitions interleaved
                   # with the breaker cycle + anomaly activity.
                   "slo / alert timeline",
                   "availability/fast -> firing",
                   "availability/fast -> resolved",
                   "anomaly    32x8 -> firing",
                   "alerts: 1 fired / 1 resolved",
                   # The calibration timeline: candidate -> promoted
                   # -> rolled back, with versions and changed cells.
                   "calibration timeline",
                   "candidate",
                   "promoted  v1  32x8@1e-03:admm->pdhg, "
                   "8x1@1e-03:admm->napg",
                   "route_rollback v2  [anomaly_fired +1",
                   "promotions: 1 / rollbacks: 1  !! ROLLED BACK",
                   # The device cost / memory section: per-bucket peak
                   # memory + the measured-vs-model drift table.
                   "device cost / memory (2 CostRecords)",
                   "hlo deadbeef",
                   "measured-vs-model",
                   "flops model/xla 1.190"):
        assert needle in text, f"selftest: {needle!r} missing from report"
    print(text)
    print("\nobs_report selftest: ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="Chrome-trace span file (serve_loadgen --trace-out)")
    ap.add_argument("--events", default=None,
                    help="event JSONL (serve_loadgen --events-out)")
    ap.add_argument("--metrics", default=None,
                    help="metrics snapshot JSONL (last line is rendered)")
    ap.add_argument("--harvest", default=None,
                    help="telemetry-warehouse dataset (HarvestSink "
                         "JSONL/.gz): convergence-analytics section")
    ap.add_argument("--costs", default=None,
                    help="device-truth CostRecord dataset (CostLog "
                         "JSONL/.gz, serve_loadgen --cost-out): "
                         "device cost/memory section")
    ap.add_argument("--fleet", default=None,
                    help="merged fleet report JSON (fleet_loadgen "
                         "--out): per-worker table, reconciliation + "
                         "liveness verdicts, SLO summary")
    ap.add_argument("--tenants", default=None, metavar="REPORT",
                    help="multi-tenant loadgen report JSON "
                         "(serve_loadgen --tenants ... --out, e.g. "
                         "TENANT_r11.json): per-tenant table + "
                         "fairness/isolation verdict")
    ap.add_argument("--selftest", action="store_true",
                    help="render a synthetic run and verify the pipeline")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest()

    from porqua_tpu_torch.obs import (
        load_cost_records, load_harvest, load_jsonl, render_report)

    trace = events = snapshot = harvest = costs = fleet = None
    tenants = None
    if args.fleet:
        with open(args.fleet) as f:
            fleet = json.load(f)
    if args.tenants:
        with open(args.tenants) as f:
            tenants = json.load(f)
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
    if args.events:
        events = load_jsonl(args.events)
    if args.metrics:
        lines = load_jsonl(args.metrics)
        snapshot = lines[-1] if lines else None
    if args.harvest:
        harvest = load_harvest(args.harvest)
    if args.costs:
        costs = load_cost_records(args.costs)

    print(render_report(trace=trace, events=events, snapshot=snapshot,
                        harvest=harvest, costs=costs, fleet=fleet,
                        tenants=tenants))
    return 0


if __name__ == "__main__":
    sys.exit(main())
