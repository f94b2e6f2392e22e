"""Multi-tenant isolation cells: noisy neighbor + per-tenant corruption.

The machine-checked form of the tenancy promises (README "Multi-tenant
serving & workload library"): one tenant's failure mode stays that
tenant's. Two cells, each against a LIVE :class:`SolveService` with
per-tenant quotas, DRR fair-share dequeue, per-tenant SLO engines, and
an armed flight recorder:

``noisy_neighbor``     the offender floods 10x past its admission
                       quota while the victim runs steady deadline-
                       carrying traffic. Invariants: the victim sheds
                       NOTHING and misses NO deadline (quota + DRR
                       isolation), the victim's per-tenant SLO engines
                       stay clean, the offender's availability alert
                       fires (quota sheds burn ITS budget), and
                       exactly one incident bundle lands, triggered by
                       the offender's tenant-labeled ``slo_alert``.
``tenant_feed_corrupt``  the offender's request stream is poisoned at
                       the ``data.feed`` seam (the resilience plane's
                       ``feed_corrupt`` kind through the shared
                       ``corrupt_feed`` helper). Invariants: zero
                       wrong answers anywhere, every poisoned request
                       FAILS (validation gate), the failures are
                       attributed to the offender's per-tenant
                       counters, the victim completes 100% correct,
                       and the single incident bundle's trigger is a
                       ``validation_failed`` event carrying the
                       offender's tenant id.

:mod:`porqua_tpu_torch.cli.chaos_suite` runs both cells in its full
matrix (classic + continuous); this module is the 2-tenant
noisy-neighbor smoke (``--cell`` selects, ``--all`` runs both). Exit
nonzero on any invariant violation. The service runs on ``--device``
(default: the card; ``--device cpu`` runs on the host).

Usage::

    python -m porqua_tpu_torch.cli.tenant_smoke --device cpu        # smoke
    python -m porqua_tpu_torch.cli.tenant_smoke --all --continuous \\
        --report /tmp/t.json
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from porqua_tpu_torch.cli import Tally
from porqua_tpu_torch.cli.calibration_smoke import (_build_requests,
                                                    reference_params)

VICTIM = "quiet-fund"
OFFENDER = "bursty-fund"

RESULT_TIMEOUT_S = 120.0


def _service(params, continuous, quota, flight, retry=None, *,
             device=None):
    from porqua_tpu_torch.obs import HarvestSink, Observability, TenantSLOSet
    from porqua_tpu_torch.obs.slo import BurnRateRule, default_slos
    from porqua_tpu_torch.serve.bucketing import BucketLadder
    from porqua_tpu_torch.serve.service import SolveService

    # ONE burn-rate rule with a run-spanning resolve dwell: the
    # offender's breach fires exactly once and stays firing — "fires
    # exactly one tenant-labeled alert" is then a crisp invariant.
    # The latency target is generous on purpose (these cells assert
    # ISOLATION, not absolute speed — continuous cohorts on a host
    # run hundreds of ms per request and must not trip everyone's
    # latency SLO into the isolation verdict).
    tenant_slos = TenantSLOSet(
        slos=default_slos(latency_target_s=5.0),
        rules=(BurnRateRule("fast", long_s=3600.0, short_s=300.0,
                            burn_rate=14.4, resolve_s=3600.0),),
        min_eval_interval_s=0.05)
    sink = HarvestSink(None)
    svc = SolveService(
        params=params, ladder=BucketLadder(n_rungs=(8,), m_rungs=(4,)),
        max_batch=8, max_wait_ms=2.0, queue_capacity=256,
        obs=Observability(), continuous=continuous, flight=flight,
        tenant_quota=quota, tenant_slos=tenant_slos, harvest=sink,
        retry=retry, device=device)
    return svc, tenant_slos, sink


def _drain(service, tickets, refs_by_ticket=None, atol=5e-4, *,
           tally=None, phase=None):
    """Resolve tickets; returns (ok, failures, wrong). With ``tally``,
    each answer is recorded under ``phase``."""
    import numpy as np

    ok, failures, wrong = 0, [], []
    for i, t in enumerate(tickets):
        try:
            res = service.result(t, timeout=RESULT_TIMEOUT_S)
        except Exception as exc:  # noqa: BLE001 - a failure IS an outcome
            failures.append(f"req{i}: {type(exc).__name__}")
            continue
        if tally is not None:
            tally.answer(phase, res)
        x = np.asarray(res.x)
        if refs_by_ticket is not None:
            ref = refs_by_ticket[i]
            if not np.all(np.isfinite(x)) or \
                    float(np.max(np.abs(x - ref))) > atol:
                wrong.append(i)
                continue
        ok += 1
    return ok, failures, wrong


def _bundle_info(flight):
    from porqua_tpu_torch.obs.flight import load_bundle

    bundles = flight.bundles()
    if len(bundles) != 1:
        return len(bundles), None, None
    b = bundles[0]
    bundle = load_bundle(b) if isinstance(b, str) else b
    trig = bundle.get("trigger", {})
    return 1, trig.get("kind"), trig.get("tenant")


def run_tenant_cell(kind, mode="classic", seed=0, verbose=False, *,
                    params=None, device=None, tally=None):
    """One multi-tenant isolation cell; returns its verdict dict.
    ``params``: the solver configuration (default
    :func:`~porqua_tpu_torch.cli.calibration_smoke.reference_params`);
    ``device``: the service's (default: the card); ``tally``: a
    :class:`~porqua_tpu_torch.cli.Tally` that records the cell's
    answers (the warmup as ``warm``, the tenants' rounds as
    ``window``)."""
    import shutil

    from porqua_tpu_torch.obs.flight import FlightRecorder
    from porqua_tpu_torch.resilience import faults as _faults
    from porqua_tpu_torch.resilience.retry import RetryPolicy
    from porqua_tpu_torch.serve.service import QueueFull

    params = reference_params() if params is None else params
    tally = Tally() if tally is None else tally
    tally.open(kind, mode)
    qps, refs = _build_requests(8, params)
    continuous = mode == "continuous"
    flight_dir = tempfile.mkdtemp(prefix=f"tenant-{kind}-{mode}-")
    flight = FlightRecorder(out_dir=flight_dir, armed=False,
                            debounce_s=600.0)
    corrupting = kind == "tenant_feed_corrupt"
    service, tenant_slos, sink = _service(
        params, continuous, quota={OFFENDER: 8}, flight=flight,
        retry=(RetryPolicy(max_attempts=2, backoff_base_s=0.02,
                           seed=seed) if corrupting else None),
        device=device)
    installed = False
    try:
        service.start()
        service.prewarm(qps[0])
        # Warmup (untagged) + window reset: measured counters cover
        # only the cell's traffic; arm the recorder AFTER prewarm so
        # compiles spend no debounce budget.
        with tally.round("warm"):
            warm = [tally.ticket(service.submit(q)) for q in qps]
            _drain(service, warm, tally=tally, phase="warm")
        service.metrics.reset_window()
        flight.arm()

        victim_shed = 0
        offender_shed = 0
        poisoned = 0
        tickets_victim, refs_victim = [], []
        tickets_off = []
        if corrupting:
            scenario = _faults.Scenario(
                name="tenant-feed-corrupt",
                faults=(_faults.FaultSpec.make(
                    "data.feed", "feed_corrupt", count=1_000_000,
                    lanes=1),),
                seed=seed)
            _faults.install(_faults.FaultInjector(
                scenario, metrics=service.metrics,
                events=service.obs.events))
            installed = True
        # Establish both tenants' baselines (one clean interleaved
        # round), then the offender misbehaves while the victim keeps
        # steady deadline-carrying traffic flowing.
        rounds = 3 if corrupting else 2
        with tally.round("window"):
            for rnd in range(rounds):
                for i, qp in enumerate(qps):
                    try:
                        tickets_victim.append(tally.ticket(
                            service.submit(qp, deadline_s=30.0,
                                           tenant=VICTIM)))
                        refs_victim.append(refs[i])
                    except QueueFull:
                        victim_shed += 1
                    off_qp = qp
                    burst = 10 if (not corrupting and rnd > 0) else 1
                    for _ in range(burst):
                        was_poisoned = False
                        if corrupting and _faults.enabled():
                            act = _faults.fire("data.feed", i=i)
                            if act is not None \
                                    and act.kind == "feed_corrupt":
                                off_qp = _faults.corrupt_feed(qp, act)
                                was_poisoned = True
                        try:
                            tickets_off.append(tally.ticket(
                                service.submit(off_qp, tenant=OFFENDER,
                                               timeout=0.0)))
                        except QueueFull:
                            # Shed at the offender's own quota BEFORE
                            # a ticket existed — poison that never
                            # entered cannot be asked to fail.
                            offender_shed += 1
                            continue
                        if was_poisoned:
                            poisoned += 1
                # Let the round drain so the victim's steady cadence
                # is real (and the offender's sheds land between
                # rounds). Each drain re-reads the victim's tickets so
                # far; only the last one's answers are tallied.
                n_ok, vfail, vwrong = _drain(
                    service, tickets_victim, refs_victim,
                    tally=tally if rnd == rounds - 1 else None,
                    phase="window")
            off_ok, off_fail, _ = _drain(service, tickets_off,
                                         tally=tally, phase="window")
        if installed:
            _faults.uninstall()
            installed = False
        # The dispatch thread evaluates the tenants' SLOs too, and emits
        # an alert (the flight recorder then builds its bundle) after it
        # has counted it: stop the service first, so that every alert
        # counted below has landed its bundle.
        service.stop()
        tenant_slos.evaluate()

        snap = service.snapshot()
        tsnap = snap.get("tenants", {})
        victim_row = tsnap.get(VICTIM, {})
        off_row = tsnap.get(OFFENDER, {})
        fired = tenant_slos.alerts_fired()
        n_bundles, trig_kind, trig_tenant = _bundle_info(flight)
        # Per-tenant harvest reconciliation over the measured window
        # (warmup ran untagged, so the tenants' record counts are
        # exactly their measured completions).
        counts = {}
        for rec in sink.buffered():
            t = rec.get("tenant")
            counts[t] = counts.get(t, 0) + 1

        invariants = {
            "victim_zero_shed": {
                "ok": victim_shed == 0
                and int(victim_row.get("rejected", 0)) == 0,
                "detail": {"shed_at_submit": victim_shed,
                           "rejected_counter":
                               int(victim_row.get("rejected", 0))},
            },
            "victim_no_missed_deadline": {
                "ok": int(victim_row.get("expired", 0)) == 0
                and not vfail,
                "detail": {"expired": int(victim_row.get("expired", 0)),
                           "failures": vfail[:3]},
            },
            "victim_slo_clean": {
                "ok": fired.get(VICTIM, 0) == 0,
                "detail": {"alerts_fired": fired},
            },
            "offender_alert_fired": {
                # The noisy cell burns exactly ONE budget
                # (availability, via its quota sheds); the corruption
                # cell legitimately fires both availability (give-ups)
                # AND wrong_answers (withheld results) — both the
                # offender's. Nobody else's engine moves either way.
                "ok": (fired.get(OFFENDER, 0) >= 1 if corrupting
                       else fired.get(OFFENDER, 0) == 1)
                and all(v == 0 for t, v in fired.items()
                        if t != OFFENDER),
                "detail": {"alerts_fired": fired},
            },
            "incident_bundle_tenant": {
                "ok": (n_bundles == 1 and trig_tenant == OFFENDER
                       and trig_kind == ("validation_failed"
                                         if corrupting else "slo_alert")),
                "detail": {"bundles": n_bundles, "trigger": trig_kind,
                           "tenant": trig_tenant},
            },
            "tenant_reconciliation": {
                "ok": (counts.get(VICTIM, 0)
                       == int(victim_row.get("completed", 0))
                       and counts.get(OFFENDER, 0)
                       == int(off_row.get("completed", 0))),
                "detail": {"harvest": counts,
                           "completed": {
                               VICTIM: int(victim_row.get("completed", 0)),
                               OFFENDER: int(off_row.get("completed", 0))}},
            },
            "zero_wrong_answers": {
                "ok": not vwrong,
                "detail": vwrong[:4],
            },
        }
        if corrupting:
            invariants["poisoned_all_failed"] = {
                # Every poisoned request must FAIL (the validation
                # gate withholds garbage; retries of poisoned data
                # give up) and the give-ups/validation failures land
                # on the offender's ledger, not the victim's.
                "ok": (poisoned > 0 and len(off_fail) >= poisoned
                       and int(off_row.get("validation_failures", 0)
                               + off_row.get("retry_giveups", 0)) > 0
                       and int(victim_row.get("validation_failures", 0))
                       == 0),
                "detail": {"poisoned": poisoned,
                           "offender_failures": len(off_fail),
                           "offender_validation":
                               int(off_row.get("validation_failures", 0)),
                           "offender_giveups":
                               int(off_row.get("retry_giveups", 0))},
            }
        else:
            invariants["offender_shed_at_quota"] = {
                "ok": offender_shed > 0
                and int(off_row.get("rejected", 0)) == offender_shed,
                "detail": {"shed": offender_shed,
                           "rejected_counter":
                               int(off_row.get("rejected", 0))},
            }
        ok = all(v["ok"] for v in invariants.values())
        verdict = {
            "cell": kind, "mode": mode, "ok": ok,
            "invariants": invariants,
            "tenants": tsnap,
            "recompiles_after_warmup": snap["compiles"],
        }
        if verbose:
            state = "ok  " if ok else "FAIL"
            bad = [k for k, v in invariants.items() if not v["ok"]]
            print(f"  {state} {kind:<20} {mode:<10}"
                  + (f"  violated: {', '.join(bad)}" if bad else ""),
                  file=sys.stderr)
        return verdict
    finally:
        if installed:
            _faults.uninstall()
        service.stop()
        shutil.rmtree(flight_dir, ignore_errors=True)


TENANT_CELLS = ("noisy_neighbor", "tenant_feed_corrupt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=TENANT_CELLS, default=None,
                    help="run one cell (default: noisy_neighbor — the "
                         "CI smoke)")
    ap.add_argument("--all", action="store_true",
                    help="run both cells")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous serve mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=None,
                    help="write the JSON verdict here too")
    ap.add_argument("--device", default=None,
                    help="device the services run on (default: the "
                         "card)")
    args = ap.parse_args(argv)

    from porqua_tpu_torch.qp.solve import resolve_device

    device = resolve_device(args.device)
    cells = (list(TENANT_CELLS) if args.all
             else [args.cell or "noisy_neighbor"])
    mode = "continuous" if args.continuous else "classic"
    t0 = time.time()
    results = [run_tenant_cell(c, mode=mode, seed=args.seed,
                               verbose=True, device=device)
               for c in cells]
    report = {
        "suite": "tenant_smoke",
        "seed": args.seed,
        "elapsed_s": round(time.time() - t0, 1),
        "cells": results,
        "ok": all(r["ok"] for r in results),
    }
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    if not report["ok"]:
        bad = [r["cell"] for r in results if not r["ok"]]
        print(f"tenant_smoke: INVARIANT VIOLATIONS in {', '.join(bad)}",
              file=sys.stderr)
        return 1
    print(f"tenant_smoke: ok ({len(results)} cell(s), "
          f"{report['elapsed_s']}s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
