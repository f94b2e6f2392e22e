"""Closed-loop calibration cells: promotion, poison-refusal, rollback.

The machine-checked form of the calibration-plane promises (README
"Solver routing": the live loop). Three cells, each against a LIVE
:class:`SolveService` carrying a versioned
:class:`~porqua_tpu_torch.serve.routing.SolverRouter` and a
:class:`~porqua_tpu_torch.obs.calibrate.Calibrator` on a stepped
:class:`~porqua_tpu_torch.resilience.faults.FaultClock` — the state
machine advances only when the cell steps the clock, so every drill is
deterministic and contains zero wall-clock waits:

``calibration_promote``  cold start (EMPTY route table): shadow
                       evidence walks the cell through candidate →
                       canary dwell → promoted (version 1) → guard →
                       settled. Invariants: the promoted cell routes
                       PDHG live (oracle-checked answers), the table
                       swap costs ZERO recompiles (prewarmed-both-
                       ladders), and the warehouse audit chain replays
                       to exactly the active table/version.
``calibration_poison``   every request is corrupted at the ``data.feed``
                       seam (the resilience plane's ``feed_corrupt``
                       kind through the shared ``corrupt_feed``
                       helper), so every harvest/shadow record the
                       calibrator sees carries non-finite evidence.
                       Invariants: :meth:`Calibrator.observe` REJECTS
                       the corrupt records (counted), the loop never
                       forms a candidate and never promotes, and zero
                       poisoned requests resolve with an answer (the
                       retry validation gate fails them instead —
                       zero wrong answers).
``calibration_rollback`` a promoted table followed by convergence
                       drift: the EXISTING AnomalyDetector fires
                       inside the guard window and the calibrator
                       auto-reverts to the prior table. Invariants:
                       the rollback BUMPS the table version (never
                       reuses one), exactly one incident bundle lands
                       and its trigger is the ``route_rollback``
                       event, the audit chain still replays to the
                       live table, the discredited evidence is
                       dropped and the cooldown refuses an immediate
                       re-candidate, and post-rollback traffic serves
                       correct answers on the restored route.

:mod:`porqua_tpu_torch.cli.chaos_suite` runs the poison and rollback
cells in its full matrix (classic + continuous); ``--selftest`` here is
the CI smoke (all three cells, classic mode). Exit nonzero on any
invariant violation. The service runs on ``--device`` (default: the
card; ``--device cpu`` runs on the host).

Usage::

    python -m porqua_tpu_torch.cli.calibration_smoke --selftest --device cpu
    python -m porqua_tpu_torch.cli.calibration_smoke \\
        --cell calibration_rollback --continuous --report /tmp/cal.json
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from porqua_tpu_torch.cli import Tally

RESULT_TIMEOUT_S = 120.0
WRONG_ANSWER_ATOL = 5e-4

#: The cells chaos_suite registers (the promote drill is selftest-only:
#: it asserts the happy path the other two deviate from).
CALIBRATION_CELLS = ("calibration_poison", "calibration_rollback")

ALL_CELLS = ("calibration_promote",) + CALIBRATION_CELLS


def reference_params():
    """The drivers' solver configuration (backend ``"auto"``)."""
    from porqua_tpu_torch.qp.solve import SolverParams

    return SolverParams(max_iter=500, eps_abs=1e-5, eps_rel=1e-5,
                        polish=False, check_interval=25)


def _build_requests(n, params):
    """Small well-conditioned QPs (one 8x4 bucket) + reference
    solutions — the wrong-answer oracle, solved offline on the host by
    the plain path (``backend="xla"``), whatever backend ``params``
    names. The same recipe in all three drivers."""
    import dataclasses

    import numpy as np

    from porqua_tpu_torch.qp.canonical import CanonicalQP
    from porqua_tpu_torch.qp.solve import solve_qp

    plain = dataclasses.replace(params, backend="xla")
    qps, refs = [], []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        nv, m = 6, 2
        A = rng.standard_normal((2 * nv, nv))
        P = A.T @ A / (2 * nv) + np.eye(nv)
        q = rng.standard_normal(nv)
        C = np.concatenate([np.ones((1, nv)),
                            rng.standard_normal((m - 1, nv))])
        qp = CanonicalQP.build(P, q, C=C, l=np.full(m, -1.0),
                               u=np.ones(m), lb=np.zeros(nv),
                               ub=np.ones(nv), device="cpu")
        qps.append(qp)
        refs.append(solve_qp(qp, plain, device="cpu").x.numpy())
    return qps, refs


def _mk_service(params, continuous, clk, shadow_rate, min_samples,
                flight=None, anomaly=None, retry=None, *, device=None):
    """A live service wired for calibration: versioned router, harvest
    sink, calibrator on the stepped clock (``min_interval_s=0`` — the
    clock, not the tick cadence, gates the state machine)."""
    from porqua_tpu_torch.obs import HarvestSink
    from porqua_tpu_torch.obs.calibrate import Calibrator
    from porqua_tpu_torch.serve.bucketing import BucketLadder
    from porqua_tpu_torch.serve.routing import SolverRouter
    from porqua_tpu_torch.serve.service import SolveService

    sink = HarvestSink(None)
    # The router's caches run without the device-cost plane: the port's
    # plane counts every op of each entry's warm-up, which makes the
    # three backends' prewarm several times longer, and no invariant
    # here reads a CostRecord.
    router = SolverRouter(params, cost_log=False, shadow_rate=shadow_rate,
                          shadow_seed=0)
    cal = Calibrator(min_interval_s=0.0, min_samples=min_samples,
                     win_rate=0.6, canary_dwell_s=5.0,
                     guard_window_s=30.0, clock=clk)
    svc = SolveService(
        params=params, ladder=BucketLadder(n_rungs=(8,), m_rungs=(4,)),
        max_batch=8, max_wait_ms=2.0, queue_capacity=256,
        continuous=continuous, router=router, harvest=sink,
        calibrator=cal, flight=flight, anomaly=anomaly, retry=retry,
        device=device)
    return svc, router, cal, sink


def _drain(service, tickets, refs_by_ticket=None, *, tally, phase):
    """Resolve tickets; returns (ok, failures, wrong)."""
    import numpy as np

    ok, failures, wrong = 0, [], []
    for i, t in enumerate(tickets):
        try:
            res = service.result(t, timeout=RESULT_TIMEOUT_S)
        except Exception as exc:  # noqa: BLE001 - a failure IS an outcome
            failures.append(f"req{i}: {type(exc).__name__}")
            continue
        tally.answer(phase, res)
        x = np.asarray(res.x)
        if refs_by_ticket is not None:
            ref = refs_by_ticket[i]
            if not np.all(np.isfinite(x)) or \
                    float(np.max(np.abs(x - ref))) > WRONG_ANSWER_ATOL:
                wrong.append(i)
                continue
        ok += 1
    return ok, failures, wrong


def _round(service, qps, refs, *, tally, phase):
    """One oracle-checked round; returns (failures, wrong)."""
    with tally.round(phase):
        tickets = [tally.ticket(service.submit(q)) for q in qps]
        _, failures, wrong = _drain(service, tickets, refs, tally=tally,
                                    phase=phase)
    return failures, wrong


def _synthetic_evidence(cal, bucket, eps, n=6):
    """Schema-correct solve/shadow records for one cell, with ALL
    THREE backends matured as contenders: PDHG strictly better than
    the ADMM serve stream on dispatch latency, NAPG matured but
    strictly worse — so the promote drill pins a genuine best-of-three
    comparison (the winner must beat two losers, not one). The
    deterministic stand-in for the organic shadow stream (these drills
    pin the state machine's transitions)."""
    for _ in range(n):
        cal.observe({"source": "serve", "bucket": bucket,
                     "eps_abs": eps, "solver": "admm", "status": 1,
                     "iters": 40, "solve_s": 4e-3, "obj": 0.1})
        cal.observe({"source": "serve.shadow", "shadow_of": "admm",
                     "bucket": bucket, "eps_abs": eps, "solver": "pdhg",
                     "status": 1, "iters": 12, "solve_s": 1e-5,
                     "obj": 0.1, "delta_iters": -28,
                     "delta_solve_s": -4e-3, "agree": True})
        cal.observe({"source": "serve.shadow", "shadow_of": "admm",
                     "bucket": bucket, "eps_abs": eps, "solver": "napg",
                     "status": 1, "iters": 80, "solve_s": 8e-3,
                     "obj": 0.1, "delta_iters": 40,
                     "delta_solve_s": 4e-3, "agree": True})


def _cell_str(bucket, eps):
    return f"{bucket}@{eps:.0e}"


def _verdict(kind, mode, invariants, extra=None, verbose=False):
    ok = all(v["ok"] for v in invariants.values())
    verdict = {"cell": kind, "mode": mode, "ok": ok,
               "invariants": invariants}
    verdict.update(extra or {})
    if verbose:
        state = "ok  " if ok else "FAIL"
        bad = [k for k, v in invariants.items() if not v["ok"]]
        print(f"  {state} {kind:<22} {mode:<10}"
              + (f"  violated: {', '.join(bad)}" if bad else ""),
              file=sys.stderr)
    return verdict


def _cell_promote(mode, seed, verbose, *, params, device, shadow_rate,
                  tally):
    from porqua_tpu_torch.obs.calibrate import replay_audit
    from porqua_tpu_torch.resilience.faults import FaultClock

    qps, refs = _build_requests(8, params)
    clk = FaultClock()
    svc, router, cal, sink = _mk_service(
        params, mode == "continuous", clk, shadow_rate=0.0,
        min_samples=4, device=device)
    try:
        svc.start()
        svc.prewarm(qps[0])  # router path: EVERY backend's ladder
        warm_fail, warm_wrong = _round(svc, qps, refs, tally=tally,
                                       phase="warm")
        svc.metrics.reset_window()
        bucket = sink.buffered()[0]["bucket"]
        eps = params.eps_abs
        cell = _cell_str(bucket, eps)

        _synthetic_evidence(cal, bucket, eps)
        cal.tick()
        state_canary = cal.status()["state"]
        clk.advance(6.0)   # > canary_dwell_s
        cal.tick()         # promote: versioned table swap, live
        table = dict(router.snapshot()["table"])
        version = router.table_version
        routed_fail, routed_wrong = _round(svc, qps, refs, tally=tally,
                                           phase="routed")
        snap = svc.metrics.snapshot()
        clk.advance(31.0)  # > guard_window_s: clean guard settles
        cal.tick()
        counters = cal.counters()
        replayed, replay_v = replay_audit(sink.buffered())

        invariants = {
            "canary_then_promoted": {
                "ok": (state_canary == "canary"
                       and counters["calibration_promotions"] == 1
                       and table.get(cell) == "pdhg" and version == 1),
                "detail": {"state_after_evidence": state_canary,
                           "table": table, "version": version},
            },
            "promoted_route_served": {
                "ok": snap.get("routed_pdhg", 0) == len(qps),
                "detail": {"routed_admm": snap.get("routed_admm", 0),
                           "routed_pdhg": snap.get("routed_pdhg", 0)},
            },
            "zero_wrong_answers": {
                "ok": not warm_wrong and not routed_wrong,
                "detail": (warm_wrong + routed_wrong)[:4],
            },
            "zero_failures": {
                "ok": not warm_fail and not routed_fail,
                "detail": (warm_fail + routed_fail)[:4],
            },
            "zero_recompiles": {
                # The promotion swap must land entirely on prewarmed
                # executables.
                "ok": snap.get("compiles", 0) == 0,
                "detail": f"{snap.get('compiles', 0)} compile(s)",
            },
            "guard_settled": {
                "ok": counters["calibration_settled"] == 1
                and counters["calibration_rollbacks"] == 0,
                "detail": {k: counters[k] for k in (
                    "calibration_settled", "calibration_rollbacks")},
            },
            "audit_replays_to_active": {
                "ok": (replayed == router.snapshot()["table"]
                       and replay_v == router.table_version),
                "detail": {"replayed": replayed,
                           "replay_version": replay_v},
            },
        }
        return _verdict("calibration_promote", mode, invariants,
                        {"table": table, "version": version,
                         "counters": counters}, verbose)
    finally:
        svc.stop()


def _cell_poison(mode, seed, verbose, *, params, device, shadow_rate,
                 tally):
    from porqua_tpu_torch.resilience import faults as _faults
    from porqua_tpu_torch.resilience.faults import FaultClock
    from porqua_tpu_torch.resilience.retry import RetryPolicy

    qps, _refs = _build_requests(8, params)
    clk = FaultClock()
    svc, router, cal, sink = _mk_service(
        params, mode == "continuous", clk,
        shadow_rate=1.0 if shadow_rate is None else shadow_rate,
        min_samples=4,
        retry=RetryPolicy(max_attempts=2, backoff_base_s=0.02,
                          seed=seed), device=device)
    installed = False
    try:
        svc.start()
        svc.prewarm(qps[0])
        # NO clean round: every request this cell serves is poisoned
        # at the data.feed seam, so EVERY record that reaches the
        # calibrator — routed and shadow alike — is corrupt. With
        # min_samples this low, the only thing standing between the
        # poison and a promotion is the observe() rejection gate.
        scenario = _faults.Scenario(
            name="calibration-poison",
            faults=(_faults.FaultSpec.make(
                "data.feed", "feed_corrupt", count=1_000_000,
                lanes=1),),
            seed=seed)
        _faults.install(_faults.FaultInjector(
            scenario, metrics=svc.metrics, events=svc.obs.events))
        installed = True
        poisoned, resolved_poisoned, failures = 0, [], []
        for _rnd in range(2):
            with tally.round("window"):
                tickets = []
                for i, qp in enumerate(qps):
                    pq = qp
                    if _faults.enabled():
                        act = _faults.fire("data.feed", i=i)
                        if act is not None \
                                and act.kind == "feed_corrupt":
                            pq = _faults.corrupt_feed(qp, act)
                            poisoned += 1
                    tickets.append((i, tally.ticket(svc.submit(pq))))
                for i, t in tickets:
                    try:
                        tally.answer("window", svc.result(
                            t, timeout=RESULT_TIMEOUT_S))
                        resolved_poisoned.append(i)
                    except Exception:  # noqa: BLE001 - the EXPECTED outcome
                        failures.append(i)
            time.sleep(0.25)  # trailing shadow re-solves off dispatch
            clk.advance(10.0)
            cal.tick()
        _faults.uninstall()
        installed = False
        counters = cal.counters()
        status = cal.status()
        snap = svc.metrics.snapshot()

        invariants = {
            "poison_rejected": {
                # The refusal mechanism itself: corrupt records are
                # rejected at the evidence gate, counted, never folded.
                "ok": counters["calibration_rejected"] > 0,
                "detail": {k: counters[k] for k in (
                    "calibration_rejected", "calibration_observed")},
            },
            "no_promotion": {
                "ok": (counters["calibration_promotions"] == 0
                       and counters["calibration_candidates"] == 0
                       and status["state"] == "idle"
                       and router.table_version == 0
                       and not router.snapshot()["table"]),
                "detail": {"state": status["state"],
                           "table": router.snapshot()["table"],
                           "version": router.table_version},
            },
            "zero_wrong_answers": {
                # A poisoned request that RESOLVES got an answer built
                # from garbage — the validation gate must fail it.
                "ok": poisoned > 0 and not resolved_poisoned,
                "detail": {"poisoned": poisoned,
                           "resolved": resolved_poisoned[:4]},
            },
            "validation_gate_engaged": {
                "ok": (snap.get("validation_failures", 0)
                       + snap.get("retry_giveups", 0)) > 0
                and len(failures) == poisoned,
                "detail": {
                    "validation_failures":
                        snap.get("validation_failures", 0),
                    "retry_giveups": snap.get("retry_giveups", 0),
                    "failed": len(failures)},
            },
        }
        return _verdict("calibration_poison", mode, invariants,
                        {"counters": counters}, verbose)
    finally:
        if installed:
            _faults.uninstall()
        svc.stop()


def _cell_rollback(mode, seed, verbose, *, params, device, shadow_rate,
                   tally):
    import shutil

    from porqua_tpu_torch.obs.anomaly import AnomalyDetector
    from porqua_tpu_torch.obs.calibrate import replay_audit
    from porqua_tpu_torch.obs.flight import FlightRecorder, load_bundle
    from porqua_tpu_torch.resilience.faults import FaultClock

    qps, refs = _build_requests(8, params)
    clk = FaultClock()
    # The guard watches the EXISTING detector. Its baseline knows only
    # a synthetic "drift" group with a tight band — live traffic's
    # real bucket is an unknown group (never judged), so the breach
    # fires exactly when the cell drives it and never before.
    anomaly = AnomalyDetector(
        {("drift", params.eps_abs): {
            "iters_p50": 10.0, "iters_p95": 20.0, "iters_max": 30.0,
            "wasted": 0.0, "count": 100}})
    flight_dir = tempfile.mkdtemp(prefix="calibration-rollback-")
    flight = FlightRecorder(out_dir=flight_dir, armed=False,
                            debounce_s=600.0)
    svc, router, cal, sink = _mk_service(
        params, mode == "continuous", clk, shadow_rate=0.0,
        min_samples=4, flight=flight, anomaly=anomaly, device=device)
    try:
        svc.start()
        svc.prewarm(qps[0])
        warm_fail, warm_wrong = _round(svc, qps, refs, tally=tally,
                                       phase="warm")
        svc.metrics.reset_window()
        bucket = sink.buffered()[0]["bucket"]
        eps = params.eps_abs
        cell = _cell_str(bucket, eps)

        _synthetic_evidence(cal, bucket, eps)
        cal.tick()         # idle -> canary
        clk.advance(6.0)
        cal.tick()         # promote (version 1)
        promoted_version = router.table_version
        promoted_table = dict(router.snapshot()["table"])
        routed_fail, routed_wrong = _round(svc, qps, refs, tally=tally,
                                           phase="routed")
        snap_promoted = svc.metrics.snapshot()

        # Post-promotion drift through the real detector API (the
        # convergence_anomaly fires now, unarmed — the cell pins the
        # ROLLBACK bundle, not the anomaly one).
        for _ in range(8):
            anomaly.observe("drift", eps, 10_000,
                            check_interval=params.check_interval)
        fired = anomaly.counters()["anomalies_fired"]
        flight.arm()
        clk.advance(1.0)   # still inside the guard window
        cal.tick()         # guard breach -> auto-rollback (version 2)
        rolled_version = router.table_version
        rolled_table = dict(router.snapshot()["table"])
        counters = cal.counters()
        replayed, replay_v = replay_audit(sink.buffered())
        bundles = flight.bundles()
        trig_kind = None
        if len(bundles) == 1:
            b = bundles[0]
            bundle = load_bundle(b) if isinstance(b, str) else b
            trig_kind = bundle.get("trigger", {}).get("kind")

        # Re-offer the discredited evidence inside the cooldown: the
        # loop must refuse to re-candidate (evidence dropped + dwell).
        _synthetic_evidence(cal, bucket, eps)
        clk.advance(1.0)
        cal.tick()
        state_after = cal.status()["state"]
        post_fail, post_wrong = _round(svc, qps, refs, tally=tally,
                                       phase="restored")
        snap = svc.metrics.snapshot()

        invariants = {
            "promoted_then_rolled_back": {
                "ok": (promoted_table.get(cell) == "pdhg"
                       and counters["calibration_promotions"] == 1
                       and counters["calibration_rollbacks"] == 1
                       and rolled_table == {}),
                "detail": {"promoted": promoted_table,
                           "restored": rolled_table,
                           "anomalies_fired": fired},
            },
            "version_bumped_never_reused": {
                "ok": (promoted_version == 1
                       and rolled_version == 2),
                "detail": {"promoted_version": promoted_version,
                           "rolled_version": rolled_version},
            },
            "one_rollback_bundle": {
                "ok": len(bundles) == 1
                and trig_kind == "route_rollback",
                "detail": {"bundles": len(bundles),
                           "trigger": trig_kind},
            },
            "audit_replays_to_active": {
                "ok": (replayed == router.snapshot()["table"]
                       and replay_v == rolled_version),
                "detail": {"replayed": replayed,
                           "replay_version": replay_v},
            },
            "cooldown_refuses_recandidate": {
                "ok": state_after == "idle"
                and cal.counters()["calibration_candidates"] == 1,
                "detail": {"state": state_after,
                           "cooldown_remaining_s":
                               cal.status()["cooldown_remaining_s"]},
            },
            "zero_wrong_answers": {
                "ok": not (warm_wrong or routed_wrong or post_wrong),
                "detail": (warm_wrong + routed_wrong + post_wrong)[:4],
            },
            "zero_failures": {
                "ok": not (warm_fail or routed_fail or post_fail),
                "detail": (warm_fail + routed_fail + post_fail)[:4],
            },
            "zero_recompiles": {
                # Promotion AND rollback both swap between prewarmed
                # ladders — the whole drill compiles nothing.
                "ok": snap.get("compiles", 0) == 0,
                "detail": f"{snap.get('compiles', 0)} compile(s)",
            },
            "promoted_route_served": {
                "ok": snap_promoted.get("routed_pdhg", 0) >= len(qps),
                "detail": {
                    "routed_pdhg": snap_promoted.get("routed_pdhg", 0)},
            },
        }
        return _verdict("calibration_rollback", mode, invariants,
                        {"counters": counters,
                         "promoted_version": promoted_version,
                         "rolled_version": rolled_version}, verbose)
    finally:
        svc.stop()
        shutil.rmtree(flight_dir, ignore_errors=True)


def run_calibration_cell(kind, mode="classic", seed=0, verbose=False, *,
                         params=None, device=None, shadow_rate=None,
                         tally=None):
    """One calibration cell (chaos_suite entry); returns its verdict.
    ``params``: the solver configuration (default
    :func:`reference_params`); ``device``: the service's (default: the
    card); ``shadow_rate``: the poison drill's shadow probability
    (default 1, every dispatch shadowed); ``tally``: a
    :class:`~porqua_tpu_torch.cli.Tally` that records the cell's
    answers."""
    runner = {"calibration_promote": _cell_promote,
              "calibration_poison": _cell_poison,
              "calibration_rollback": _cell_rollback}[kind]
    tally = Tally() if tally is None else tally
    tally.open(kind, mode)
    return runner(mode, seed, verbose,
                  params=reference_params() if params is None else params,
                  device=device, shadow_rate=shadow_rate, tally=tally)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=ALL_CELLS, default=None,
                    help="run one cell")
    ap.add_argument("--all", action="store_true",
                    help="run all three cells")
    ap.add_argument("--selftest", action="store_true",
                    help="CI smoke: all three cells, classic mode")
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
    if args.selftest or args.all:
        cells = list(ALL_CELLS)
    else:
        cells = [args.cell or "calibration_promote"]
    mode = "continuous" if args.continuous else "classic"
    t0 = time.time()
    results = [run_calibration_cell(c, mode=mode, seed=args.seed,
                                    verbose=True, device=device)
               for c in cells]
    report = {
        "suite": "calibration_smoke",
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
        print(f"calibration_smoke: INVARIANT VIOLATIONS in "
              f"{', '.join(bad)}", file=sys.stderr)
        return 1
    print(f"calibration_smoke: ok ({len(results)} cell(s), "
          f"{report['elapsed_s']}s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
