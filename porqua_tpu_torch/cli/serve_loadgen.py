"""Load generator for the online solve service (porqua_tpu_torch.serve).

Replays a stream of per-date index-replication QPs as independent
requests through a :class:`SolveService` and reports sustained
throughput, p50/p99 latency, mean batch occupancy, and the recompile
count after warmup (steady-state bar: 0). Workloads:

* ``--workload grid`` (default): the config-5 MSCI-grid shape —
  n=24 assets, 252-day windows.
* ``--workload northstar``: the 252-date x 500-asset stream of the
  one-shot benchmark, re-played as 252 independent requests.
* ``--workload mixed`` (implied by ``--tenants``): a multi-tenant blend
  from :mod:`porqua_tpu_torch.serve.workloads`.

The service runs on ``--device`` (default: the card; it raises without
one unless given ``--device cpu``) with the serving solver defaults
(``loadgen.SERVE_PARAMS``, backend ``"auto"``).

Examples::

    python -m porqua_tpu_torch.cli.serve_loadgen
    python -m porqua_tpu_torch.cli.serve_loadgen --workload northstar --requests 252
    python -m porqua_tpu_torch.cli.serve_loadgen --mode open --rate 2000
    python -m porqua_tpu_torch.cli.serve_loadgen --warm-keys --jsonl serve_metrics.jsonl
    python -m porqua_tpu_torch.cli.serve_loadgen --trace-out trace.json \\
        --events-out events.jsonl --rings 16    # then: cli.obs_report
    python -m porqua_tpu_torch.cli.serve_loadgen --chaos device_lost \\
        --events-out chaos.jsonl     # one fault scenario under load
    python -m porqua_tpu_torch.cli.serve_loadgen --slo --flight-out /tmp/incidents \\
        --anomaly-baseline harvest.jsonl.gz   # live SLO engine + flight
                                     # recorder + convergence anomaly
                                     # detection (cli.incident_report
                                     # renders the bundles)
    python -m porqua_tpu_torch.cli.serve_loadgen --cost-out costs.jsonl \\
        --profile-window 5 --profile-dir /tmp/ptrace
                                     # CostRecords + a bounded
                                     # torch.profiler window; rank fusion
                                     # targets: cli.roofline_report
    python -m porqua_tpu_torch.cli.serve_loadgen --duration-s 60 --tenants \\
        "alpha:tracking:diurnal:rate=40;beta:lad:heavy_tailed:rate=15;\\
gamma:tracking:bursty:rate=8,burst_factor=10,offender=1,quota=64" \\
        --out tenant_report.json     # mixed-tenant blend: per-tenant
                                     # quotas/DRR/SLO engines, fairness
                                     # block; render: cli.obs_report --tenants

Prints one JSON report line on stdout (diagnostics on stderr).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: The checkout the port lives in (the ledger row's git revision).
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("grid", "northstar", "mixed"),
                    default="grid",
                    help="grid/northstar: the classic single-tenant "
                         "streams; mixed: a multi-tenant blend from "
                         "--tenants (porqua_tpu_torch.serve.workloads)")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="mixed-workload tenant spec, ';'-separated "
                         "name:problem:arrival[:key=value,...] — e.g. "
                         "'alpha:tracking:diurnal:rate=40;"
                         "beta:lad:heavy_tailed:rate=15;"
                         "gamma:tracking:bursty:rate=8,burst_factor=10,"
                         "offender=1,quota=64' (problems: tracking|lad|"
                         "turnover; arrivals: steady|diurnal|bursty|"
                         "heavy_tailed). Implies --workload mixed, "
                         "open-loop blend arrivals, per-tenant quotas/"
                         "weights from the spec, and per-tenant SLO "
                         "engines")
    ap.add_argument("--duration-s", type=float, default=60.0,
                    help="mixed-workload blend duration (the arrival "
                         "trace window)")
    ap.add_argument("--tenant-latency-target", type=float, default=0.25,
                    metavar="S",
                    help="per-tenant latency-SLO target seconds for "
                         "the --tenants run (continuous cohorts on the "
                         "CPU want a generous one)")
    ap.add_argument("--tenant-single-rule", action="store_true",
                    help="per-tenant SLO engines run ONE burn-rate "
                         "rule with a run-spanning resolve dwell — a "
                         "breaching tenant fires exactly one alert "
                         "(the tenant report's crisp invariant) "
                         "instead of the fast+slow default pair")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the report JSON here (render "
                         "with cli.obs_report --tenants)")
    ap.add_argument("--workloads-selftest", action="store_true",
                    help="run the workload library's selftest (seeded "
                         "determinism, blend-share reconciliation — "
                         "no device work) and exit")
    ap.add_argument("--requests", type=int, default=None,
                    help="request count (default: 2048 grid / 252 northstar)")
    ap.add_argument("--window", type=int, default=252)
    ap.add_argument("--mode", choices=("closed", "open"), default="closed")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop arrival rate, solves/s")
    ap.add_argument("--inflight", type=int, default=None,
                    help="closed-loop in-flight window (default 4*max-batch)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--warm-keys", action="store_true",
                    help="tag requests with stream-index warm keys")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--jsonl", default=None,
                    help="append the final metrics snapshot to this file")
    ap.add_argument("--trace-out", default=None,
                    help="write per-request spans as Chrome-trace JSON "
                         "(load in Perfetto / chrome://tracing, or "
                         "render with cli.obs_report)")
    ap.add_argument("--events-out", default=None,
                    help="write the structured event log (JSONL: "
                         "compiles, breaker transitions, expiries, "
                         "convergence-ring samples)")
    ap.add_argument("--harvest-out", default=None, metavar="PATH",
                    help="append one telemetry-warehouse SolveRecord "
                         "per resolved request to this JSONL dataset "
                         "(.gz gzips; aggregate with "
                         "cli.harvest_report; pair with --rings "
                         "to persist residual trajectories)")
    ap.add_argument("--slo", action="store_true",
                    help="run the live SLO engine (availability, "
                         "latency, zero-wrong-answers) with multi-"
                         "window burn-rate alerting over the measured "
                         "window; the report gains per-SLO compliance "
                         "+ alert states (see README 'SLOs, alerting "
                         "& incident response')")
    ap.add_argument("--slo-latency-target", type=float, default=0.25,
                    metavar="S",
                    help="latency-SLO target in seconds (align with a "
                         "histogram bucket edge; default 0.25)")
    ap.add_argument("--flight-out", default=None, metavar="DIR",
                    help="arm the incident flight recorder: any "
                         "trigger (breaker open, retry giveup, firing "
                         "SLO alert, ...) dumps one self-contained "
                         "incident-*.json.gz bundle into DIR (render "
                         "with cli.incident_report)")
    ap.add_argument("--anomaly-baseline", default=None, metavar="PATH",
                    help="harvest dataset (JSONL/.gz, e.g. a "
                         "--harvest-out artifact) to calibrate online "
                         "convergence anomaly detection against; "
                         "convergence_anomaly events feed the flight "
                         "recorder")
    ap.add_argument("--cost-out", default=None, metavar="PATH",
                    help="export the run's CostRecords (the counted "
                         "flops, bytes and peak memory of each built "
                         "entry) as JSONL (.gz gzips) — the "
                         "cli.roofline_report input; a cost_summary "
                         "joins the report either way")
    ap.add_argument("--profile-window", type=float, default=None,
                    metavar="S",
                    help="open a bounded programmatic torch.profiler "
                         "trace over the first S seconds of the "
                         "measured (post-warmup) phase; the report "
                         "links the trace dir as profile_trace_dir")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace directory for --profile-window "
                         "(default: porqua_profile_trace)")
    ap.add_argument("--rings", type=int, default=0, metavar="K",
                    help="compile with K-slot on-device convergence "
                         "rings and emit ring events for a sample of "
                         "requests (0 = off, the bit-identical default "
                         "program)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: cohorts step one ADMM "
                         "segment at a time, retire lanes the boundary "
                         "they converge, and refill freed slots from "
                         "the queue (see README 'Batch compaction & "
                         "continuous batching')")
    ap.add_argument("--segment-budget", type=int, default=None,
                    metavar="S",
                    help="continuous mode: retire any lane after S "
                         "segments as MAX_ITER + polish fallback "
                         "(default: the solver's max_iter expressed in "
                         "segments)")
    ap.add_argument("--chaos", default=None, metavar="NAME",
                    help="install a builtin fault scenario for the "
                         "measured phase (porqua_tpu_torch.resilience."
                         "builtin_scenarios: device_lost, "
                         "probe_blackhole, nan_lanes, compile_storm, "
                         "queue_stall, clock_skew, feed_corrupt); "
                         "enables the retry policy unless --no-retry")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="scenario seed (replays are deterministic "
                         "per seed)")
    ap.add_argument("--retry", action="store_true",
                    help="route requests through the recovery layer "
                         "(RetryPolicy defaults: 3 attempts, exp "
                         "backoff + jitter, result validation) even "
                         "without --chaos")
    ap.add_argument("--no-retry", action="store_true",
                    help="opt out of the retry policy --chaos would "
                         "otherwise imply: measure raw (unrecovered) "
                         "fault behavior — failed/corrupted requests "
                         "count as errors instead of retrying")
    ap.add_argument("--hedge-after-s", type=float, default=None,
                    metavar="S",
                    help="fire one hedged duplicate for any request "
                         "still unresolved S seconds after submission "
                         "(implies --retry)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="append one longitudinal run-ledger row "
                         "(git rev + key metrics) to this JSONL "
                         "(porqua_tpu_torch.obs.ledger reads the "
                         "series back)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--factor", action="store_true",
                    help="carry the low-rank objective factor (Pf = X) "
                         "on every request, as the one-shot benchmark's "
                         "QPs do (factored requests bucket separately)")
    ap.add_argument("--device", default=None,
                    help="device the service runs on (default: the "
                         "card)")
    args = ap.parse_args(argv)

    if args.workloads_selftest:
        from porqua_tpu_torch.serve import workloads

        workloads.selftest()
        print("workloads selftest: ok")
        return 0

    from porqua_tpu_torch.serve.loadgen import (build_tracking_requests,
                                                run_loadgen)

    tenancy_kwargs = {}
    if args.tenants:
        args.workload = "mixed"
    if args.workload == "mixed":
        if not args.tenants:
            ap.error("--workload mixed requires --tenants SPEC")
        from porqua_tpu_torch.serve.workloads import (
            build_blend, parse_tenant_specs)

        specs = parse_tenant_specs(args.tenants)
        blend = build_blend(specs, duration_s=args.duration_s,
                            seed=args.seed)
        print(f"building mixed blend: {len(blend)} arrivals over "
              f"{args.duration_s:g}s, shares {blend.shares()}",
              file=sys.stderr)
        requests = blend.requests
        args.mode = "open"
        from porqua_tpu_torch.obs import TenantSLOSet
        from porqua_tpu_torch.obs.slo import (
            DEFAULT_RULES, BurnRateRule, default_slos)

        rules = DEFAULT_RULES
        if args.tenant_single_rule:
            rules = (BurnRateRule(
                "fast", long_s=3600.0, short_s=300.0, burn_rate=14.4,
                resolve_s=3600.0),)
        tenancy_kwargs = dict(
            arrivals=blend.offsets, tenants=blend.tenants,
            tenant_quota=blend.quota_map(),
            tenant_weights=blend.weight_map(),
            tenant_slos=TenantSLOSet(
                slos=default_slos(
                    latency_target_s=args.tenant_latency_target),
                rules=rules),
            offenders=blend.offenders())
    else:
        n_assets = {"grid": 24, "northstar": 500}[args.workload]
        n_requests = args.requests or {"grid": 2048,
                                       "northstar": 252}[args.workload]
        print(f"building {n_requests} requests "
              f"(n={n_assets}, window={args.window})...", file=sys.stderr)
        requests = build_tracking_requests(
            n_requests, n_assets=n_assets, window=args.window,
            seed=args.seed, factor=args.factor)

    retry = None
    if args.retry or args.hedge_after_s is not None:
        if args.no_retry:
            ap.error("--no-retry contradicts --retry/--hedge-after-s")
        from porqua_tpu_torch.resilience.retry import RetryPolicy

        retry = RetryPolicy(hedge_after_s=args.hedge_after_s)

    report = run_loadgen(
        requests, mode=args.mode, rate=args.rate, inflight=args.inflight,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        warm_keys=args.warm_keys, deadline_s=args.deadline_s,
        jsonl_path=args.jsonl, trace_out=args.trace_out,
        events_out=args.events_out, ring_size=args.rings,
        harvest_out=args.harvest_out,
        continuous=args.continuous, segment_budget=args.segment_budget,
        retry=retry, chaos=args.chaos, chaos_seed=args.chaos_seed,
        no_retry=args.no_retry, slo=args.slo,
        slo_latency_target_s=args.slo_latency_target,
        flight_out=args.flight_out,
        anomaly_baseline=args.anomaly_baseline,
        cost_out=args.cost_out,
        profile_window_s=args.profile_window,
        profile_dir=args.profile_dir,
        device=args.device,
        **tenancy_kwargs)
    report["workload"] = args.workload
    if args.tenants:
        report["tenant_spec"] = args.tenants
        report["duration_s"] = args.duration_s
    if args.ledger:
        from porqua_tpu_torch.obs import ledger as _ledger

        row = _ledger.ledger_row(
            "serve_loadgen", _ledger.metrics_from_loadgen(report),
            rev=_ledger.git_rev(_REPO_ROOT),
            note=f"workload={args.workload} mode={args.mode}"
                 + (f" chaos={args.chaos}" if args.chaos else ""))
        _ledger.append_row(args.ledger, row)
        report["ledger_row"] = row["run_id"]
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"report -> {args.out}", file=sys.stderr)
    # Under --chaos, errors are the scenario doing its job (failed
    # requests are an allowed outcome; wrong answers are not, and the
    # validation gate converts those to errors) — the invariant
    # checking belongs to the chaos suite.
    return 0 if (report["errors"] == 0 or args.chaos) else 1


if __name__ == "__main__":
    sys.exit(main())
