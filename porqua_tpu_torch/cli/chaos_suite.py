"""Chaos suite: the degradation matrix for the online solve service.

Runs the builtin fault-scenario grid (:func:`porqua_tpu_torch.resilience.
builtin_scenarios`) against a LIVE :class:`SolveService` — classic and
continuous serve modes, with a real (primary, fallback) device pair for
the circuit breaker (:func:`breaker_pair`: the card and the host CPU;
under ``--device cpu`` the host as ``cpu:1`` and ``cpu``) — and asserts
the recovery invariants per scenario:

``zero_wrong_answers``  every result handed to a caller is finite and
                        matches the offline reference solve (a request
                        may FAIL under chaos; it may never mis-answer —
                        the retry layer's validation gate is what makes
                        ``nan_lanes``/``feed_corrupt`` survivable).
``fault_fired``         the scenario actually injected (a chaos run
                        whose faults never fired tests nothing).
``breaker_cycle``       device-fault scenarios only: the breaker opened
                        (``breaker_open`` event) AND re-closed
                        (``breaker_close``), and the service ends the
                        run un-degraded on its primary device.
``bounded_failures``    failed requests <= 25% of submissions and the
                        poisoned-by-design requests all failed.
``recovered``           after the fault window closes, a clean round of
                        requests completes with zero errors (after a
                        device fault, a round begun and ended with the
                        breaker closed: served on the primary).
``expected_events``     the scenario's signature events appeared
                        (``dispatch_failure``, ``validation_failed``,
                        ...) and every injected fault logged a
                        ``fault_injected`` event.
``incident_bundle``     the per-cell flight recorder
                        (:mod:`porqua_tpu_torch.obs.flight`) dumped
                        exactly ONE incident bundle, triggered by the
                        scenario's expected kind, and the bundle
                        parses back from disk self-contained (trigger
                        + counters + event history).

One JSON verdict report is printed to stdout and optionally written to
``--report``; exit status is nonzero on ANY invariant violation.

Usage::

    python -m porqua_tpu_torch.cli.chaos_suite --device cpu   # full matrix
    python -m porqua_tpu_torch.cli.chaos_suite \\
        --scenarios device_lost,nan_lanes --modes classic --report /tmp/c.json
    python -m porqua_tpu_torch.cli.chaos_suite --selftest     # 3-cell smoke

``serve_loadgen --chaos NAME`` replays one scenario under sustained
load (throughput/latency view, no invariant gating); this suite is the
correctness gate.

The full matrix additionally runs the multi-tenant isolation cells
(``noisy_neighbor``, ``tenant_feed_corrupt`` — implemented in
:mod:`porqua_tpu_torch.cli.tenant_smoke`): the victim tenant's SLOs
must stay compliant while the offender's tenant-labeled burn-rate alert
fires and the cell's single incident bundle carries the offending
tenant id; the route-flap cell; and the calibration cells
(:mod:`porqua_tpu_torch.cli.calibration_smoke`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from porqua_tpu_torch.cli import Tally
from porqua_tpu_torch.cli.calibration_smoke import (_build_requests,
                                                    reference_params,
                                                    run_calibration_cell)
from porqua_tpu_torch.cli.tenant_smoke import run_tenant_cell

#: Per-scenario driver configuration. ``install`` is when the injector
#: goes live: "traffic" = after prewarm+warmup (faults hit steady
#: state), "startup" = before service.start() (probe faults must be
#: live when the startup check probes the primary). ``device_fault``
#: scenarios must show the full breaker open -> recover cycle.
#: ``deadline_s`` arms per-request deadlines (the clock-skew target);
#: ``feed`` drives the data.feed seam from this suite's submit loop
#: (the same seam the load generator compiles in). ``expect_events`` /
#: ``expect_any_counters`` are the scenario's signature.
#: ``expect_trigger`` is the flight-recorder incident each scenario
#: must produce (the incident_bundle invariant: exactly ONE bundle per
#: cell, dumped by that trigger kind). Scenarios whose signature is an
#: error-class event use the default trigger inventory; stall-class
#: scenarios that degrade without an error event extend the cell's
#: recorder with ``extra_triggers`` (a post-warmup compile IS the
#: compile_storm incident; the injection marker is queue_stall's —
#: the scenario's only observable signature).
SCENARIOS = {
    "device_lost": dict(install="traffic", device_fault=True,
                        expect_events=("dispatch_failure",),
                        expect_trigger="breaker_open"),
    "probe_blackhole": dict(install="startup", device_fault=True,
                            expect_events=("probe_failure",),
                            expect_trigger="breaker_open"),
    "nan_lanes": dict(install="traffic",
                      expect_events=("validation_failed",),
                      expect_any_counters=("validation_failures",),
                      expect_trigger="validation_failed"),
    "compile_storm": dict(install="traffic",
                          expect_any_counters=("compiles",),
                          expect_trigger="compile",
                          extra_triggers=("compile",)),
    "queue_stall": dict(install="traffic",
                        expect_trigger="fault_injected",
                        extra_triggers=("fault_injected",)),
    "clock_skew": dict(install="traffic", deadline_s=5.0,
                       expect_any_counters=("expired", "retry_giveups"),
                       expect_trigger="retry_giveup"),
    "feed_corrupt": dict(install="traffic", feed=True,
                         expect_any_counters=("validation_failures",),
                         expect_trigger="validation_failed"),
}

MODES = ("classic", "continuous")

#: Multi-tenant isolation cells (cli.tenant_smoke implements them; the
#: full matrix runs them next to the fault scenarios): the
#: noisy-neighbor quota burst and the one-tenant feed_corrupt stream,
#: each asserting the victim tenant's SLOs stay compliant while the
#: offender's tenant-labeled alert fires and the single incident
#: bundle carries the offending tenant id.
TENANT_CELLS = ("noisy_neighbor", "tenant_feed_corrupt")

#: Solver-routing cell (run_route_flap_cell below; classic AND
#: continuous): a live SolverRouter force-flipped across the ADMM,
#: PDHG and NAPG backends mid-stream under load. Not a fault scenario
#: — no injector — but the same unforgivable-outcome bar: every
#: result must match the offline oracle whichever backend served it,
#: every backend must actually serve traffic, nothing may fail, and
#: the flapping must compile NOTHING after prewarm (every backend's
#: ladder is prewarmed up front — a flap that recompiles would be a
#: latency fault in production).
ROUTE_CELLS = ("solver_route_flap",)

#: Closed-loop calibration cells (cli.calibration_smoke implements
#: them; classic AND continuous): ``calibration_poison`` — every
#: request corrupted at the ``data.feed`` seam, so every record the
#: live calibrator sees is rejected at the evidence gate, the loop
#: never promotes, and zero poisoned requests resolve with an answer;
#: ``calibration_rollback`` — a promoted-then-drifting route table
#: must auto-revert (version bumped, never reused) with exactly one
#: ``route_rollback``-triggered incident bundle.
CALIBRATION_CELLS = ("calibration_poison", "calibration_rollback")

#: Every cell name of the full matrix, in its order.
ALL_NAMES = (tuple(SCENARIOS) + TENANT_CELLS + ROUTE_CELLS
             + CALIBRATION_CELLS)

#: The CI smoke (`--selftest`): one raising seam, one corruption seam
#: riding the validation gate, and one continuous-mode run.
SELFTEST = (("device_lost", "classic"), ("nan_lanes", "classic"),
            ("queue_stall", "continuous"))

#: Agreement bar for "the answer the caller got is THE answer": the
#: serve tests pin the batched path to the direct solve at 5e-4.
WRONG_ANSWER_ATOL = 5e-4

N_REQUESTS = 16        # per round
CHAOS_ROUNDS = 2       # rounds inside the fault window
RECOVERY_TIMEOUT_S = 30.0
RESULT_TIMEOUT_S = 120.0


def breaker_pair(device=None):
    """The breaker's (primary, fallback): on the card ``cuda:N`` and the
    host CPU; on the host ``cpu:1`` and ``cpu``, two labels for one
    host, so the breaker has a device to move to and back from.
    ``device`` defaults to the card (raising without one)."""
    import torch

    from porqua_tpu_torch.qp.solve import resolve_device
    from porqua_tpu_torch.serve.service import _pinned

    primary = resolve_device(device)
    if primary.type == "cpu":
        return torch.device("cpu", 1), torch.device("cpu")
    return _pinned(primary), torch.device("cpu")


def _drive_round(service, qps, deadline_s=None, feed=False, *, tally,
                 phase):
    """Submit one round; return (n_ok, wrong, failures, poisoned_ok).

    ``wrong`` collects requests that RESOLVED with an answer that is
    non-finite or disagrees with the reference — the one unforgivable
    outcome. ``poisoned_ok`` collects poisoned requests that resolved
    at all (they must fail instead).
    """
    import numpy as np

    from porqua_tpu_torch.resilience import faults as _faults

    with tally.round(phase):
        tickets, poisoned = [], set()
        for i, (qp, ref) in enumerate(qps):
            if feed and _faults.enabled():
                # data.feed seam (suite-side twin of the loadgen
                # seam): a feed_corrupt directive poisons this
                # request's objective before submission — through the
                # SAME shared helper the load generator uses.
                act = _faults.fire("data.feed", i=i)
                if act is not None and act.kind == "feed_corrupt":
                    qp = _faults.corrupt_feed(qp, act)
                    poisoned.add(i)
            tickets.append((i, ref, tally.ticket(
                service.submit(qp, deadline_s=deadline_s))))
        n_ok, wrong, failures, poisoned_ok = 0, [], [], []
        for i, ref, t in tickets:
            try:
                res = service.result(t, timeout=RESULT_TIMEOUT_S)
            except Exception as exc:  # noqa: BLE001 - a failure IS an outcome
                failures.append(f"req{i}: {type(exc).__name__}: {exc}")
                continue
            tally.answer(phase, res)
            x = np.asarray(res.x)
            if i in poisoned:
                poisoned_ok.append(i)
                continue
            if not np.all(np.isfinite(x)) or \
                    float(np.max(np.abs(x - ref))) > WRONG_ANSWER_ATOL:
                wrong.append(
                    f"req{i}: max|x-ref|="
                    f"{float(np.max(np.abs(x - ref))):.2e}" if
                    np.all(np.isfinite(x)) else f"req{i}: non-finite x")
                continue
            n_ok += 1
    return n_ok, wrong, failures, poisoned_ok


def run_scenario(name, mode, seed, qps, refs, params, ladder, cache,
                 verbose=False, *, device=None, tally=None):
    """One (scenario, mode) cell of the matrix; returns its verdict.
    ``device``: the breaker's primary (:func:`breaker_pair`; default
    the card); ``tally``: a :class:`~porqua_tpu_torch.cli.Tally` that
    records the cell's answers by phase (``warm``, ``window``,
    ``recovery``; a startup scenario's warmup is in its window)."""
    import shutil
    import tempfile

    from porqua_tpu_torch.obs import Observability
    from porqua_tpu_torch.obs.flight import (
        DEFAULT_TRIGGERS,
        FlightRecorder,
        load_bundle,
    )
    from porqua_tpu_torch.resilience import faults as _faults
    from porqua_tpu_torch.resilience.retry import RetryPolicy
    from porqua_tpu_torch.serve.batcher import device_label
    from porqua_tpu_torch.serve.metrics import ServeMetrics
    from porqua_tpu_torch.serve.service import DeviceHealth, SolveService

    tally = Tally() if tally is None else tally
    tally.open(name, mode)
    cfg = SCENARIOS[name]
    scenario = _faults.builtin_scenarios(seed=seed)[name]
    metrics = ServeMetrics()
    obs = Observability()
    # The incident flight recorder, per cell: starts DISARMED so
    # prewarm/warmup activity (cache compiles are a compile_storm
    # trigger) spends no debounce budget, armed exactly when the
    # injector installs. debounce_s spans the whole cell, so the
    # invariant below can demand EXACTLY one bundle; bundles land in a
    # scratch dir and are parsed back through the real gz round-trip.
    flight_dir = tempfile.mkdtemp(prefix=f"chaos-{name}-{mode}-")
    flight = FlightRecorder(
        out_dir=flight_dir, armed=False, debounce_s=600.0,
        triggers=DEFAULT_TRIGGERS + tuple(cfg.get("extra_triggers", ())))
    # Re-point the shared executable cache's sinks at THIS run (the
    # cache itself is shared across cells so each scenario does not
    # re-pay the ladder's builds; the service checks params identity).
    cache.metrics = metrics
    cache.events = obs.events

    primary, fallback = breaker_pair(device)
    health = DeviceHealth(primary=primary, fallback=fallback,
                          failure_threshold=2, probe_timeout_s=10.0,
                          recovery_interval_s=0.25, metrics=metrics,
                          events=obs.events)
    service = SolveService(
        params=params, ladder=ladder, max_batch=8, max_wait_ms=5.0,
        queue_capacity=256, metrics=metrics, health=health, obs=obs,
        continuous=(mode == "continuous"), cache=cache, flight=flight,
        retry=RetryPolicy(max_attempts=4, backoff_base_s=0.02,
                          seed=seed))

    injector = _faults.FaultInjector(scenario, metrics=metrics,
                                     events=obs.events)
    installed = False
    round_qps = list(zip(qps, refs))
    wrong, failures, poisoned_ok = [], [], []
    try:
        if cfg["install"] == "startup":
            flight.arm()  # startup faults must be recordable incidents
            _faults.install(injector)
            installed = True
        service.start()
        service.prewarm(qps[0])
        # One clean warmup round, then reset so counters describe the
        # chaos + recovery window only.
        _, w0, f0, _ = _drive_round(
            service, round_qps, tally=tally,
            phase="warm" if cfg["install"] == "traffic" else "window")
        wrong += w0
        if cfg["install"] == "startup":
            failures += f0  # startup faults may fail warmup requests
        metrics.reset_window()

        if cfg["install"] == "traffic":
            flight.arm()  # the chaos window IS the incident window
            _faults.install(injector)
            installed = True
        submitted = 0
        for _ in range(CHAOS_ROUNDS):
            _, w, f, p = _drive_round(
                service, round_qps, deadline_s=cfg.get("deadline_s"),
                feed=cfg.get("feed", False), tally=tally, phase="window")
            wrong += w
            failures += f
            poisoned_ok += p
            submitted += len(round_qps)
        _faults.uninstall()
        installed = False

        # Recovery: the fault window is closed; drive clean rounds
        # until the breaker re-closes (device-fault scenarios) and one
        # round completes error-free. In a device-fault scenario that
        # round must also have begun un-degraded, so that it ran on the
        # primary: a round begun on the fallback can close the breaker
        # (its first dispatch starts the half-open probe) and still be
        # served there whole (a continuous cohort keeps the device it
        # was created on).
        deadline = time.monotonic() + RECOVERY_TIMEOUT_S
        recovered = False
        last_failures = []
        while time.monotonic() < deadline:
            began_degraded = service.snapshot()["degraded"]
            _, w, f, _ = _drive_round(service, round_qps, tally=tally,
                                      phase="recovery")
            wrong += w
            last_failures = f
            submitted += len(round_qps)
            degraded = began_degraded or service.snapshot()["degraded"]
            if not f and (not cfg.get("device_fault") or not degraded):
                recovered = True
                break
            time.sleep(0.1)
        failures += last_failures

        snap = service.snapshot()
        events = obs.events.events()
        kinds = {}
        for e in events:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        fires = injector.fires()

        invariants = {
            "zero_wrong_answers": {
                "ok": not wrong and not poisoned_ok,
                "detail": (wrong + [f"poisoned req{i} resolved"
                                    for i in poisoned_ok])[:4],
            },
            "fault_fired": {
                "ok": fires >= 1,
                "detail": f"{fires} fault(s) fired",
            },
            "bounded_failures": {
                "ok": len(failures) <= 0.25 * max(submitted, 1),
                "detail": f"{len(failures)}/{submitted} failed "
                          f"(sample: {failures[:3]})",
            },
            "recovered": {
                "ok": recovered,
                "detail": ("clean round completed post-window"
                           if recovered else
                           f"still failing/degraded after "
                           f"{RECOVERY_TIMEOUT_S}s: {last_failures[:3]}"),
            },
            "expected_events": {
                "ok": (kinds.get("fault_injected", 0) == fires
                       and all(kinds.get(k, 0) >= 1
                               for k in cfg.get("expect_events", ()))
                       and (not cfg.get("expect_any_counters")
                            or any(snap.get(c, 0) >= 1 for c in
                                   cfg["expect_any_counters"]))),
                "detail": {
                    "fault_injected_events": kinds.get("fault_injected", 0),
                    "fires": fires,
                    "expect_events": {k: kinds.get(k, 0) for k in
                                      cfg.get("expect_events", ())},
                    "expect_any_counters": {
                        c: snap.get(c, 0) for c in
                        cfg.get("expect_any_counters", ())},
                },
            },
        }
        # Incident flight recorder: every scenario is an incident, and
        # each cell must have produced EXACTLY one bundle (the
        # debounce spans the cell), dumped by the scenario's expected
        # trigger kind, parseable back from disk, and self-contained
        # enough to carry the trigger + counters + event history.
        bundle_paths = flight.bundles()
        bundle_trigger = None
        bundle_ok = False
        if len(bundle_paths) == 1:
            try:
                bundle = load_bundle(bundle_paths[0])
                bundle_trigger = bundle["trigger"]["kind"]
                bundle_ok = (bundle_trigger == cfg["expect_trigger"]
                             and bundle.get("counters") is not None
                             and isinstance(bundle.get("events"), list))
            except Exception as exc:  # noqa: BLE001 - verdict detail
                bundle_trigger = f"unparseable: {exc!r}"
        invariants["incident_bundle"] = {
            "ok": bundle_ok,
            "detail": {"bundles": len(bundle_paths),
                       "trigger": bundle_trigger,
                       "expected": cfg["expect_trigger"],
                       "suppressed": flight.suppressed},
        }
        if cfg.get("device_fault"):
            invariants["breaker_cycle"] = {
                "ok": (kinds.get("breaker_open", 0) >= 1
                       and kinds.get("breaker_close", 0) >= 1
                       and not snap["degraded"]
                       and snap["device"] == device_label(primary)),
                "detail": {"breaker_open": kinds.get("breaker_open", 0),
                           "breaker_close": kinds.get("breaker_close", 0),
                           "degraded": snap["degraded"],
                           "device": snap["device"]},
            }

        ok = all(v["ok"] for v in invariants.values())
        verdict = {
            "scenario": name,
            "mode": mode,
            "ok": ok,
            "invariants": invariants,
            "faults_injected": fires,
            "fault_log": injector.log()[:16],
            "counters": {k: snap[k] for k in (
                "submitted", "completed", "failed", "expired", "rejected",
                "retries", "hedges_fired", "hedges_won",
                "resumed_requests", "retry_giveups",
                "validation_failures", "faults_injected", "compiles",
                "dispatch_failures", "probe_failures",
                "device_switches")},
            "event_kinds": kinds,
        }
        if verbose:
            state = "ok  " if ok else "FAIL"
            bad = [k for k, v in invariants.items() if not v["ok"]]
            print(f"  {state} {name:<16} {mode:<10} "
                  f"faults={fires} failed={len(failures)}"
                  + (f"  violated: {', '.join(bad)}" if bad else ""),
                  file=sys.stderr)
        return verdict
    finally:
        if installed:
            _faults.uninstall()
        service.stop()
        shutil.rmtree(flight_dir, ignore_errors=True)


def run_route_flap_cell(mode, seed, qps, refs, params, ladder,
                        verbose=False, *, device=None, tally=None):
    """The ``solver_route_flap`` cell: serve rounds of oracle-checked
    requests while force-flipping the router between backends — at
    round boundaries AND halfway through a round's submissions, so
    dispatches straddle the flip. The final rounds unpin (``force
    (None)``) to prove the service returns to table/default routing
    clean. ``device`` and ``tally`` as in :func:`run_scenario` (the
    warmup round is ``warm``, the flaps ``window``)."""
    import numpy as np

    from porqua_tpu_torch.obs import Observability
    from porqua_tpu_torch.serve.metrics import ServeMetrics
    from porqua_tpu_torch.serve.routing import SolverRouter
    from porqua_tpu_torch.serve.service import DeviceHealth, SolveService

    tally = Tally() if tally is None else tally
    tally.open("solver_route_flap", mode)
    metrics = ServeMetrics()
    obs = Observability()
    primary, fallback = breaker_pair(device)
    health = DeviceHealth(primary=primary, fallback=fallback,
                          failure_threshold=2, probe_timeout_s=10.0,
                          recovery_interval_s=0.25, metrics=metrics,
                          events=obs.events)
    # Without the device-cost plane, as in cli.calibration_smoke.
    router = SolverRouter(params, cost_log=False)
    service = SolveService(
        params=params, ladder=ladder, max_batch=8, max_wait_ms=5.0,
        queue_capacity=256, metrics=metrics, health=health, obs=obs,
        continuous=(mode == "continuous"), router=router)
    round_qps = list(zip(qps, refs))
    wrong, failures = [], []
    try:
        service.start()
        service.prewarm(qps[0])  # router path: EVERY backend's ladder
        _, w0, f0, _ = _drive_round(service, round_qps, tally=tally,
                                    phase="warm")
        wrong += w0
        failures += f0
        metrics.reset_window()

        submitted = 0
        half = len(round_qps) // 2
        # (start-of-round pin, mid-round pin); None = unpinned. The
        # schedule walks every backend pair boundary at least once —
        # including mid-round flips in and out of NAPG (its prox is
        # exact on this well-conditioned 8x4 family, so the oracle
        # holds it to the same wrong-answer bar as the others).
        flaps = [("pdhg", "admm"), ("admm", "napg"), ("napg", "pdhg"),
                 ("pdhg", None), ("napg", None), (None, None)]
        for start_pin, mid_pin in flaps:
            with tally.round("window"):
                router.force(start_pin)
                tickets = []
                for i, (qp, ref) in enumerate(round_qps):
                    if i == half:
                        router.force(mid_pin)
                    tickets.append((i, ref,
                                    tally.ticket(service.submit(qp))))
                for i, ref, t in tickets:
                    try:
                        res = service.result(t, timeout=RESULT_TIMEOUT_S)
                    except Exception as exc:  # noqa: BLE001 - an outcome
                        failures.append(
                            f"req{i}: {type(exc).__name__}: {exc}")
                        continue
                    tally.answer("window", res)
                    x = np.asarray(res.x)
                    if not np.all(np.isfinite(x)) or float(
                            np.max(np.abs(x - ref))) > WRONG_ANSWER_ATOL:
                        wrong.append(
                            f"req{i}: max|x-ref|="
                            f"{float(np.max(np.abs(x - ref))):.2e}"
                            if np.all(np.isfinite(x))
                            else f"req{i}: non-finite x")
                        continue
            submitted += len(round_qps)

        snap = service.snapshot()
        invariants = {
            "zero_wrong_answers": {
                "ok": not wrong,
                "detail": wrong[:4],
            },
            "all_backends_served": {
                "ok": all(snap.get(f"routed_{m}", 0) >= 1
                          for m in ("admm", "pdhg", "napg")),
                "detail": {f"routed_{m}": snap.get(f"routed_{m}", 0)
                           for m in ("admm", "pdhg", "napg")},
            },
            "zero_recompiles": {
                "ok": snap.get("compiles", 0) == 0,
                "detail": f"{snap.get('compiles', 0)} compile(s) "
                          f"during the flapping window",
            },
            "zero_failures": {
                "ok": not failures,
                "detail": failures[:4],
            },
        }
        ok = all(v["ok"] for v in invariants.values())
        verdict = {
            "scenario": "solver_route_flap",
            "mode": mode,
            "ok": ok,
            "invariants": invariants,
            "router": router.snapshot(),
            "counters": {k: snap[k] for k in (
                "submitted", "completed", "failed", "compiles",
                "routed_admm", "routed_pdhg", "routed_napg")},
        }
        if verbose:
            state = "ok  " if ok else "FAIL"
            bad = [k for k, v in invariants.items() if not v["ok"]]
            print(f"  {state} {'solver_route_flap':<16} {mode:<10} "
                  f"routed admm/pdhg/napg="
                  f"{snap.get('routed_admm', 0)}/"
                  f"{snap.get('routed_pdhg', 0)}/"
                  f"{snap.get('routed_napg', 0)} failed={len(failures)}"
                  + (f"  violated: {', '.join(bad)}" if bad else ""),
                  file=sys.stderr)
        return verdict
    finally:
        service.stop()


def run_cell(name, mode, seed, qps, refs, params, ladder, cache,
             verbose=False, *, device=None, shadow_rate=None, tally=None):
    """One cell of the matrix by name, whichever driver implements it;
    returns its verdict, keyed by ``scenario``. The tenant and
    calibration cells build their own service (their quotas, SLO
    engines, calibrator and recorder are construction-time wiring) at
    ``params``; ``shadow_rate`` goes to the calibration poison drill."""
    if name in TENANT_CELLS:
        verdict = run_tenant_cell(name, mode=mode, seed=seed,
                                  verbose=verbose, params=params,
                                  device=device, tally=tally)
    elif name in CALIBRATION_CELLS:
        verdict = run_calibration_cell(
            name, mode=mode, seed=seed, verbose=verbose, params=params,
            device=device, shadow_rate=shadow_rate, tally=tally)
    elif name in ROUTE_CELLS:
        return run_route_flap_cell(mode, seed, qps, refs, params, ladder,
                                   verbose=verbose, device=device,
                                   tally=tally)
    else:
        return run_scenario(name, mode, seed, qps, refs, params, ladder,
                            cache, verbose=verbose, device=device,
                            tally=tally)
    verdict["scenario"] = verdict.pop("cell")
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated subset (default: all of "
                         f"{', '.join(SCENARIOS)})")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated serve modes (classic,continuous)")
    ap.add_argument("--seed", type=int, default=0,
                    help="scenario seed (replays are deterministic)")
    ap.add_argument("--report", default=None,
                    help="write the JSON verdict report here too")
    ap.add_argument("--selftest", action="store_true",
                    help="3-scenario CI smoke (device_lost/classic, "
                         "nan_lanes/classic, queue_stall/continuous)")
    ap.add_argument("--device", default=None,
                    help="the breaker's primary device (default: the "
                         "card, with the host CPU as fallback)")
    args = ap.parse_args(argv)

    from porqua_tpu_torch.qp.solve import resolve_device
    from porqua_tpu_torch.serve.bucketing import BucketLadder, ExecutableCache

    device = resolve_device(args.device)
    primary, fallback = breaker_pair(device)
    params = reference_params()
    ladder = BucketLadder(n_rungs=(8,), m_rungs=(4,))

    if args.selftest:
        cells = list(SELFTEST)
    else:
        names = (list(ALL_NAMES) if args.scenarios is None
                 else [s.strip() for s in args.scenarios.split(",") if s])
        modes = [m.strip() for m in args.modes.split(",") if m]
        for s in names:
            if s not in ALL_NAMES:
                ap.error(f"unknown scenario {s!r} (known: "
                         f"{', '.join(ALL_NAMES)})")
        for m in modes:
            if m not in MODES:
                ap.error(f"unknown mode {m!r} (known: {', '.join(MODES)})")
        cells = [(s, m) for s in names for m in modes]

    print(f"chaos suite: {len(cells)} cell(s), seed {args.seed}",
          file=sys.stderr)
    qps, refs = _build_requests(N_REQUESTS, params)
    # One executable cache shared across every cell (and both serve
    # modes — classic and continuous entries key separately), so the
    # matrix pays the ladder's builds once, not per scenario.
    cache = ExecutableCache(params)

    t0 = time.time()
    results = [run_cell(name, mode, args.seed, qps, refs, params, ladder,
                        cache, verbose=True, device=device)
               for name, mode in cells]
    report = {
        "suite": "chaos",
        "selftest": bool(args.selftest),
        "seed": args.seed,
        "backend": primary.type,
        "n_devices": len({primary, fallback}),
        "wrong_answer_atol": WRONG_ANSWER_ATOL,
        "elapsed_s": round(time.time() - t0, 1),
        "cells": results,
        "ok": all(r["ok"] for r in results),
    }
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report -> {args.report}", file=sys.stderr)
    if not report["ok"]:
        bad = [f"{r['scenario']}/{r['mode']}" for r in results
               if not r["ok"]]
        print(f"chaos suite: INVARIANT VIOLATIONS in {', '.join(bad)}",
              file=sys.stderr)
        return 1
    print(f"chaos suite: ok ({len(cells)} cells, "
          f"{report['elapsed_s']}s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
