"""The port's live operational plane against the JAX package's, fed the
same counter, record and clock sequences: ``SLOEngine`` and
``TenantSLOSet`` (burn-rate alerts), ``AnomalyDetector``,
``FlightRecorder`` (bundles less their timestamps) and ``Calibrator``
(promotions, rollbacks, route tables and versions, the audit chain and
its replay). Host logic: held exact. Every clock is a stepped
``FaultClock``."""

import pytest

from porqua_tpu import obs as jobs
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.resilience.faults import FaultClock as JaxClock
from porqua_tpu.serve.metrics import ServeMetrics as JaxMetrics
from porqua_tpu.serve.routing import SolverRouter as JaxRouter

import porqua_tpu_torch as pt
from porqua_tpu_torch import obs as tobs
from porqua_tpu_torch.resilience.faults import FaultClock
from porqua_tpu_torch.serve.metrics import ServeMetrics
from porqua_tpu_torch.serve.routing import SolverRouter


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAMPS = ("t", "ts", "pid", "window_seconds", "uptime_s", "now")


def strip(obj):
    """``obj`` without wall-clock stamps, recursively."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in STAMPS}
    if isinstance(obj, (list, tuple)):
        return [strip(v) for v in obj]
    return obj


PACKAGES = {
    "jax": (jobs, JaxMetrics, JaxClock, JaxRouter, JaxParams),
    "port": (tobs, ServeMetrics, FaultClock, SolverRouter, pt.SolverParams),
}


def drive_slo(pkg):
    """A service-wide engine and a per-tenant set over one metrics
    object: clean traffic, then a burst of failures and slow requests
    from tenant "noisy", then recovery, evaluated every 30 s of a
    stepped clock."""
    o, Metrics, Clock, _, _ = PACKAGES[pkg]
    clk = Clock()
    metrics, bus = Metrics(), o.EventBus()
    engine = o.SLOEngine(o.default_slos(latency_target_s=0.05), clock=clk,
                         min_eval_interval_s=0.0).bind(metrics, events=bus)
    tenants = o.TenantSLOSet(clock=clk, min_eval_interval_s=0.0).bind(
        metrics, events=bus)
    for step in range(120):
        noisy = 40 <= step < 70
        for tenant in ("quiet", "noisy"):
            bad = noisy and tenant == "noisy"
            metrics.inc("submitted")
            metrics.inc_tenant(tenant, "submitted")
            if bad and step % 2:
                metrics.inc("failed")
                metrics.inc_tenant(tenant, "failed")
            else:
                metrics.inc("completed")
                metrics.inc_tenant(tenant, "completed")
                lat = 0.5 if bad else 0.01
                metrics.observe_latency(lat)
                metrics.observe_tenant_latency(tenant, lat)
        clk.advance(30.0)
        engine.evaluate()
        tenants.evaluate()
    return (strip(bus.events()), strip(engine.status()), engine.counters(),
            strip(tenants.status()), tenants.alerts_fired(),
            tenants.counters(), engine.gauges())


def test_slo_engines_match_jax():
    got, want = drive_slo("port"), drive_slo("jax")
    assert got == want
    events = got[0]
    assert any(e["kind"] == "slo_alert" and e.get("tenant") == "noisy"
               for e in events)
    assert not any(e.get("tenant") == "quiet" for e in events)


def drive_anomaly_and_flight(pkg):
    o, Metrics, Clock, _, _ = PACKAGES[pkg]
    clk = Clock()
    plane = o.Observability()
    bus = plane.events
    anomaly = o.AnomalyDetector({("32x8", 1e-3): {
        "iters_p50": 50.0, "iters_p95": 75.0, "iters_max": 100.0,
        "wasted": 0.1, "count": 100}}, events=bus)
    flight = o.FlightRecorder(debounce_s=60.0, clock=clk)
    flight.attach(obs=plane, anomaly=anomaly)
    bus.add_listener(flight.on_event)
    out = []
    for i in range(60):
        iters = 50 if i < 20 or i >= 45 else 1500
        out.append(anomaly.observe("32x8", 1e-3, iters, check_interval=25,
                                   tenant="fund-a" if i % 2 else None))
        anomaly.observe("64x8", 1e-3, 10)          # no baseline
        flight.record_solve({"source": "serve", "iters": iters, "i": i})
        if i == 50:
            bus.emit("breaker_open", "error", primary="cuda:0",
                     fallback="cuda:0", failures=2)
        clk.advance(5.0)
    flight.dump("manual", note="debounced")
    clk.advance(61.0)
    flight.dump("manual", note="end")
    return (strip(out), strip(anomaly.status()), anomaly.counters(),
            strip(flight.bundles()), flight.counters())


def test_anomaly_and_flight_match_jax():
    got, want = drive_anomaly_and_flight("port"), \
        drive_anomaly_and_flight("jax")
    assert got == want
    bundles = got[3]
    assert [b["trigger"]["kind"] for b in bundles] == [
        "convergence_anomaly", "breaker_open", "manual"]
    assert "cuda:0" in bundles[1]["breaker_history"]


def evidence(cal, bucket, eps, n=6):
    """The calibration smoke's synthetic evidence (PDHG faster than the
    ADMM stream, NAPG matured but slower)."""
    for _ in range(n):
        cal.observe({"source": "serve", "bucket": bucket, "eps_abs": eps,
                     "solver": "admm", "status": 1, "iters": 40,
                     "solve_s": 4e-3, "obj": 0.1})
        cal.observe({"source": "serve.shadow", "shadow_of": "admm",
                     "bucket": bucket, "eps_abs": eps, "solver": "pdhg",
                     "status": 1, "iters": 12, "solve_s": 1e-5, "obj": 0.1,
                     "delta_iters": -28, "delta_solve_s": -4e-3,
                     "agree": True})
        cal.observe({"source": "serve.shadow", "shadow_of": "admm",
                     "bucket": bucket, "eps_abs": eps, "solver": "napg",
                     "status": 1, "iters": 80, "solve_s": 8e-3, "obj": 0.1,
                     "delta_iters": 40, "delta_solve_s": 4e-3,
                     "agree": True})


def drive_calibrator(pkg):
    """Promote, guard, roll back on a drift, refuse poisoned evidence
    and the cooldown's re-candidate, then promote again after it."""
    o, Metrics, Clock, Router, Params = PACKAGES[pkg]
    clk = Clock()
    eps = 1e-5
    params = Params(eps_abs=eps, eps_rel=eps)
    router = Router(params)
    sink, bus = o.HarvestSink(None), o.EventBus()
    anomaly = o.AnomalyDetector({("drift", eps): {
        "iters_p50": 10.0, "iters_p95": 20.0, "iters_max": 30.0,
        "wasted": 0.0, "count": 100}}, events=bus)
    cal = o.Calibrator(min_interval_s=0.0, min_samples=4, win_rate=0.6,
                       canary_dwell_s=5.0, guard_window_s=30.0,
                       cooldown_s=20.0, clock=clk)
    cal.bind(router=router, harvest=sink, events=bus, anomaly=anomaly)
    trail = []

    def step(dt=0.0):
        clk.advance(dt)
        cal.tick()
        trail.append((cal.status()["state"], router.table_version,
                      dict(router.snapshot()["table"])))

    rejected = [cal.observe({"source": "serve", "bucket": "8x4",
                             "eps_abs": eps, "solver": "admm", "status": 1,
                             "iters": 40, "solve_s": float("nan")}),
                cal.observe({"source": "serve", "bucket": "8x4"})]
    evidence(cal, "8x4", eps)
    step()
    step(6.0)
    for _ in range(8):
        anomaly.observe("drift", eps, 10_000, check_interval=25)
    step(1.0)
    evidence(cal, "8x4", eps)
    step(1.0)
    step(25.0)
    evidence(cal, "8x4", eps)
    step()
    step(6.0)
    step(31.0)
    replayed = o.replay_audit(sink.buffered())
    return (rejected, trail, cal.counters(), strip(cal.status()),
            strip(cal.audit_records()), strip(sink.buffered()), replayed,
            router.snapshot()["table"],
            [e["kind"] for e in bus.events()], cal.gauges().keys())


def test_calibrator_matches_jax():
    got, want = drive_calibrator("port"), drive_calibrator("jax")
    assert got[:9] == want[:9]
    assert set(got[9]) == set(want[9])
    rejected, trail, counters = got[:3]
    assert rejected == [False, False]
    assert counters["calibration_promotions"] == 2
    assert counters["calibration_rollbacks"] == 1
    versions = [v for _, v, _ in trail]
    assert versions == sorted(versions) and versions[-1] == 3
    replayed, live = got[6], got[7]
    assert replayed == (live, 3)
