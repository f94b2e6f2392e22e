"""The port's online solve service against the JAX package's, on the same
numpy requests in the same process, and the committed JAX golden of
``chip_smoke.py``'s serving phase.

Both packages run f32 requests (``build_tracking_requests``: the
reference's config-5 grid shape, 24 assets under a 252-day window,
bucket 32 x 8) through a ``SolveService`` with ``max_batch`` 4 (slot
ladder 1, 2, 4), in both batching modes. Every ``result()`` has a
timeout and every service is stopped by a fixture finalizer, so a hang
fails one test instead of the suite's clock.

Regenerate the golden (XLA-CPU, the 512-request north-star stream at
full width, about two minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_serve.py --write-golden
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.qp.solve import solve_qp_batch as jax_solve_qp_batch
from porqua_tpu.serve import BucketLadder as JaxLadder
from porqua_tpu.serve import SolveService as JaxService
from porqua_tpu.serve.loadgen import (
    build_exposure_requests as jax_exposure_requests)
from porqua_tpu.serve.loadgen import (
    build_tracking_requests as jax_tracking_requests)

import porqua_tpu_torch as pt
from porqua_tpu_torch.analysis import sanitize, tsan
from porqua_tpu_torch.obs import qp_solve_profile
from porqua_tpu_torch.resilience import faults
from porqua_tpu_torch.serve import (DeadlineExpired, DeviceHealth,
                                    ServeMetrics, SolveError, SolveService)
from porqua_tpu_torch.serve.loadgen import (build_exposure_requests,
                                            build_tracking_requests,
                                            run_loadgen)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                      "serve_golden.npz")
# The same stream at the rehearsals' size (8 requests of 20 assets,
# bucket 32 x 8): chip_smoke.py's serving phases run on the CPU against
# it. The phase-10 rehearsal writes it afresh and holds it equal.
SMALL_GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                            "serve_golden_small.npz")
SMALL_SIZES = dict(n_requests=8, n_assets=20, batch=8)

TIMEOUT = 120.0
# The serving solver config (loadgen's SERVE_PARAMS) and the two
# request kinds chip_smoke.py's serving phase runs: dense requests
# (linsolve auto -> trinv for f32) and factored ones (Pf = X) under
# tracking_golden.npz's woodbury config.
SERVE_BASE = dict(max_iter=2000, eps_abs=1e-3, eps_rel=1e-3, polish=False,
                  scaling_iters=2)
KINDS = {
    "dense": (False, dict(linsolve="auto")),
    "factored": (True, dict(linsolve="woodbury", woodbury_refine=0,
                            check_interval=35, scaling_mode="factored")),
}
GOLDEN_CONFIGS = {"trinv": "dense", "woodbury": "factored"}
# The golden: the reference loadgen's "northstar" stream.
NORTHSTAR = dict(n_requests=512, n_assets=500, window=252, seed=5)
GOLDEN_BATCH = 256
# Port vs JAX, f32, per request. Dense requests: |dx| <= 1e-5 (seen
# 2.2e-6). Factored requests under refine-0 Woodbury: both packages are
# up to 9.5e-6 from the f64 answer in f32 (XLA-CPU 9.5e-6, the port
# 7.5e-6), so they differ by 1.3e-5; there the port's distance to the
# f64 answer may be at most TWIN_RATIO times XLA-CPU's.
X_ATOL = 1e-5
TWIN_RATIO = 4.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def serve():
    """``serve(cls, *args, **kw)`` builds and starts a service; every
    service started is stopped when the test ends, pass or fail."""
    services = []

    def make(cls, *args, **kw):
        svc = cls(*args, **kw)
        services.append(svc)
        return svc.start()

    yield make
    for svc in services:
        svc.stop(timeout=30)


def jax_params(kind, **over):
    return JaxParams(**{**SERVE_BASE, **KINDS[kind][1], "backend": "xla",
                        **over})


def port_params(kind, **over):
    """The JAX config with the port's fused-kernel path (the kernels'
    plain twins on the CPU)."""
    return pt.SolverParams(**{**dataclasses.asdict(jax_params(kind)),
                              "backend": "pallas", **over})


def grid_requests(kind, n=16):
    factor = KINDS[kind][0]
    jreq = jax_tracking_requests(n, n_assets=24, seed=5, factor=factor)
    treq = build_tracking_requests(n, n_assets=24, seed=5, factor=factor)
    np.testing.assert_array_equal(np.asarray(jreq[-1].P), treq[-1].P.numpy())
    return jreq, treq


def solve_all(svc, reqs):
    tickets = [svc.submit(q) for q in reqs]
    return [svc.result(t, timeout=TIMEOUT) for t in tickets]


def jax_f64_x(reqs, params):
    """The f64 answer of the padded requests (JAX, XLA-CPU)."""
    padded = [JaxLadder().pad(q)[1] for q in reqs]
    stack = jax_stack_qps(padded, stack_fn=np.stack)
    qp = JaxQP(*(None if a is None else jnp.asarray(np.asarray(a, np.float64))
                 for a in stack))
    return np.asarray(jax_solve_qp_batch(qp, params).x)


@pytest.mark.parametrize("families", [
    (jax_tracking_requests, build_tracking_requests, dict(factor=True)),
    (jax_exposure_requests, build_exposure_requests, {}),
], ids=["tracking", "exposure"])
def test_request_families_match_jax(families):
    """The loadgen's request families: the same arrays from the same
    seed in both packages."""
    jax_build, build, kw = families
    for jq, tq in zip(jax_build(3, **kw), build(3, **kw)):
        for name, a, b in zip(pt.CanonicalQP._fields, jq, tq):
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=name)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["micro", "continuous"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_service_matches_jax(serve, kind, continuous):
    """16 grid requests through both packages' services, one bucket:
    equal status and iterations per request, x by the limits above,
    and the same counters."""
    jreq, treq = grid_requests(kind)
    kw = dict(max_batch=4, max_wait_ms=2000.0, continuous=continuous,
              warm_start=False)
    jsvc = serve(JaxService, jax_params(kind), **kw)
    tsvc = serve(SolveService, port_params(kind), device="cpu", **kw)
    n_jax, n_port = jsvc.prewarm(jreq[0]), tsvc.prewarm(treq[0])
    assert n_jax == n_port == 3
    want, got = solve_all(jsvc, jreq), solve_all(tsvc, treq)
    assert [r.status for r in got] == [r.status for r in want]
    assert [r.iters for r in got] == [r.iters for r in want]
    assert all(r.device == "cpu:0" and r.x.shape == (24,) for r in got)
    x_jax = np.stack([r.x for r in want])
    x_port = np.stack([r.x for r in got])
    if kind == "dense":
        np.testing.assert_allclose(x_port, x_jax, atol=X_ATOL, rtol=0)
    else:
        x64 = jax_f64_x(jreq, jax_params(kind))[:, :24]
        e_port = np.abs(x_port - x64).max()
        e_jax = np.abs(x_jax - x64).max()
        assert e_port <= TWIN_RATIO * e_jax, (e_port, e_jax)
    js, ts = jsvc.snapshot(), tsvc.snapshot()
    for key in ("submitted", "completed", "status_solved",
                "status_max_iter"):
        assert ts[key] == js[key]
    assert ts["completed"] == 16
    assert ts["compiles"] == n_port and js["compiles"] == n_jax
    assert ts["failed"] == ts["dispatch_failures"] == 0
    if continuous:
        # Cohort creations (cache hits) depend on thread timing.
        assert ts["lanes_admitted"] == js["lanes_admitted"] == 16
    else:
        # max_wait 2 s: four full batches of 4 on both sides.
        assert ts["cache_hits"] == js["cache_hits"] == 4


def test_service_needs_a_card_without_device(monkeypatch):
    """No silent CPU fallback: with no card and no device= the service
    (its health manager) raises at construction."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveService(port_params("dense"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceHealth()


def test_fallback_defaults_to_primary():
    health = DeviceHealth(primary="cpu")
    assert health.fallback == health.primary == torch.device("cpu")
    svc = SolveService(port_params("dense"), device="cpu")
    assert svc.health.fallback == svc.health.primary


def test_breaker_moves_to_a_named_cpu_fallback(serve):
    """An injected serve.dispatch fault (twice: the failure threshold)
    trips the breaker; the requests then complete on the fallback the
    caller named, labelled as such, with one device switch."""
    _, treq = grid_requests("dense", n=4)
    metrics = ServeMetrics()
    health = DeviceHealth(primary=torch.device("cpu", 1), fallback="cpu",
                          probe_fn=lambda dev: True, failure_threshold=2,
                          recovery_interval_s=3600.0, metrics=metrics)
    svc = serve(SolveService, port_params("dense"), max_batch=1,
                max_wait_ms=1.0, metrics=metrics, health=health)
    assert svc.prewarm(treq[0]) == 2   # slot ladder (1,) on both devices
    assert svc.solve(treq[0], timeout=TIMEOUT).device == "cpu:1"
    lost = faults.Scenario("dl", (faults.FaultSpec.make(
        "serve.dispatch", "device_lost", count=2),))
    with faults.active(lost, metrics=metrics):
        results = [svc.solve(q, timeout=TIMEOUT) for q in treq[1:]]
    assert all(r.found for r in results)
    assert all(r.device == "cpu:0" for r in results)
    snap = svc.snapshot()
    assert snap["degraded"] is True and snap["device"] == "cpu:0"
    assert snap["device_switches"] == 1
    assert snap["dispatch_failures"] == 2
    assert snap["failed"] == 0 and snap["faults_injected"] == 2


@pytest.mark.parametrize("sanitized", [False, True],
                         ids=["counted", "refused"])
def test_compile_storm_is_one_post_warmup_compile(serve, monkeypatch,
                                                  sanitized):
    """cache.get's compile_storm evicts a warm entry: the next dispatch
    pays one post-warmup compile, which PORQUA_SANITIZE=1 refuses
    (the batch fails loudly, the breaker stays closed)."""
    _, treq = grid_requests("dense", n=2)
    sanitize.reset()
    svc = serve(SolveService, port_params("dense"), max_batch=1,
                max_wait_ms=1.0, device="cpu", warm_start=False)
    assert svc.prewarm(treq[0]) == 1
    svc.metrics.reset_window()
    if sanitized:
        monkeypatch.setenv("PORQUA_SANITIZE", "1")
    storm = faults.Scenario("storm", (faults.FaultSpec.make(
        "cache.get", "compile_storm"),))
    with faults.active(storm):
        ticket = svc.submit(treq[1])
        if sanitized:
            with pytest.raises(SolveError, match="compile after warmup"):
                svc.result(ticket, timeout=TIMEOUT)
        else:
            assert svc.result(ticket, timeout=TIMEOUT).found
    assert sanitize.post_warmup_compiles() == 1
    snap = svc.snapshot()
    assert snap["compiles"] == (0 if sanitized else 1)
    assert snap["failed"] == int(sanitized)
    assert snap["dispatch_failures"] == 0 and not snap["degraded"]


def test_sanitized_dispatch_raises_for_the_transfer_guard(serve,
                                                          monkeypatch):
    """Under PORQUA_SANITIZE=1 each dispatch runs inside the transfer
    guard, as the JAX package's does: a clean dispatch answers the
    unguarded bits; one that makes a hidden host read raises, the batch
    fails as a sanitizer violation, and the breaker stays closed."""
    import porqua_tpu_torch.qp.solve as solve_mod

    _, treq = grid_requests("dense", n=1)
    svc = serve(SolveService, port_params("dense"), max_batch=1,
                max_wait_ms=1.0, device="cpu")
    svc.prewarm(treq[0])
    plain = svc.solve(treq[0], timeout=TIMEOUT)
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    guarded = svc.solve(treq[0], timeout=TIMEOUT)
    assert np.array_equal(guarded.x, plain.x)
    real = solve_mod._finalize_impl

    def hidden_read(*a, **k):
        sol = real(*a, **k)
        sol.x.sum().item()
        return sol

    monkeypatch.setattr(solve_mod, "_finalize_impl", hidden_read)
    with pytest.raises(SolveError, match="sanitizer: implicit transfer"):
        svc.solve(treq[0], timeout=TIMEOUT)
    assert not svc.snapshot()["degraded"]


def _service(**kw):
    return SolveService(port_params("dense"), device="cpu", **kw)


# ROADMAP item 19's options, which raised until the device-cost plane
# was ported: each now runs on the CPU (tests/test_torch_devprof.py
# holds their results against the JAX package's).
UNPORTED = {
    "cost_log": lambda tmp: _prewarmed(cost_log=pt.obs.CostLog(
        str(tmp / "c.jsonl"))).cache.cost_log.records == 1,
    "bridge_tracer": lambda tmp: _bridged(),
    "cost_records": lambda tmp: len(
        _prewarmed().cache.cost_records()) == 1,
    "qp_solve_profile": lambda tmp: qp_solve_profile(
        32, 8, 25.0, 0.1)["cost_source"] == "model",
}
LOADGEN_UNPORTED = {
    "cost_out": ("c.jsonl", "cost_records"),
    "profile_window_s": (30.0, "profile_trace_dir"),
    "profile_dir": ("p", "profile_trace_dir"),
}


def _prewarmed(**kw):
    _, treq = grid_requests("dense", n=1)
    svc = _service(max_batch=1, **kw)
    svc.prewarm(treq[0])
    return svc


def _bridged():
    from porqua_tpu_torch.profiling import Tracer

    tracer = Tracer()
    ServeMetrics().bridge_tracer(tracer)
    return [t.name for t in tracer.timings] == [
        "serve/queue_wait", "serve/solve", "serve/compile"]


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_raise(name, tmp_path):
    """The service options of ROADMAP item 19 no longer raise: each
    runs and does its job."""
    assert UNPORTED[name](tmp_path)


@pytest.mark.parametrize("name", sorted(LOADGEN_UNPORTED))
def test_unported_loadgen_options_raise(name, tmp_path, monkeypatch):
    """``run_loadgen``'s device-cost options (ROADMAP item 19) no longer
    raise: each runs on the CPU and fills its report field (the window's
    default directory is relative to the working directory)."""
    monkeypatch.chdir(tmp_path)
    value, field = LOADGEN_UNPORTED[name]
    if isinstance(value, str):
        value = str(tmp_path / value)
    _, treq = grid_requests("dense", n=2)
    report = run_loadgen(treq, port_params("dense"), max_batch=2,
                         device="cpu", **{name: value})
    assert report[field] and report["solved"] == 2
    assert report["cost_summary"]["executables"] == 2
    if name == "cost_out":
        assert len(pt.obs.load_cost_records(value)) == 2
    else:
        assert "profile_trace_error" not in report


def _routed(**kw):
    from porqua_tpu_torch.serve import SolverRouter

    return _service(router=SolverRouter(port_params("dense")), **kw)


PORTED = {
    "obs": lambda: _service(obs=pt.obs.Observability()).obs,
    "harvest": lambda: _service(harvest=pt.obs.HarvestSink(None)).harvest,
    "slo": lambda: _service(slo=pt.obs.SLOEngine()).slo.metrics,
    "flight": lambda: _service(flight=pt.obs.FlightRecorder()).obs,
    "anomaly": lambda: _service(anomaly=pt.obs.AnomalyDetector({})).obs,
    "tenant_slos": lambda: _service(
        tenant_slos=pt.obs.TenantSLOSet()).tenant_slos.metrics,
    "router": lambda: _routed().router.caches["pdhg"].metrics,
    "calibrator": lambda: _routed(calibrator=pt.obs.Calibrator()).calibrator,
    "retry": lambda: _service(retry=pt.resilience.RetryPolicy())._retry,
    "start_http": lambda: _start_http(),
    "vitals": lambda: _service().vitals()["threads"],
    "retry_policy": lambda: pt.resilience.RetryPolicy().max_attempts,
}


def _start_http():
    svc = _service()
    try:
        return svc.start_http()
    finally:
        svc.stop()


@pytest.mark.parametrize("name", sorted(PORTED))
def test_production_options_are_accepted(name):
    """The options the JAX package's service takes and the port now
    has: each builds (and wires what it needs) without raising."""
    assert PORTED[name]()


LOADGEN_PORTED = {
    "trace_out": ("t.json", "trace_events"),
    "events_out": ("e.jsonl", "events_out"),
    "ring_size": (8, "trace_events"),
    "harvest_out": ("h.jsonl", "harvest_records_measured"),
    "slo": (True, "slo"),
    "flight_out": ("f", "incident_bundles"),
    "anomaly_baseline": ("b.jsonl", "convergence_anomalies"),
    "tenant_slos": (True, "tenant_slo"),
    "retry": (None, "retries"),
    "chaos": ("nan_lanes", "validation_failures"),
}


@pytest.mark.parametrize("name", sorted(LOADGEN_PORTED))
def test_loadgen_options_are_accepted(name, tmp_path):
    """``run_loadgen``'s observability, retry and chaos options run on
    the CPU and fill their report fields; every request solves."""
    from porqua_tpu_torch.obs import HarvestSink, solve_record

    value, field = LOADGEN_PORTED[name]
    if isinstance(value, str) and name != "chaos":
        value = str(tmp_path / value)
    if name == "anomaly_baseline":
        with HarvestSink(value) as sink:
            sink.emit(solve_record("serve", 24, 1, 1, 25, 0, 0, 0,
                                   params=port_params("dense"),
                                   bucket="32x8"))
    if name == "retry":
        value = pt.resilience.RetryPolicy()
    _, treq = grid_requests("dense", n=4)
    kw = {name: value}
    if name == "tenant_slos":
        kw["tenants"] = ["a", "b"] * 2
    report = run_loadgen(treq, port_params("dense"), max_batch=2,
                         device="cpu", **kw)
    assert field in report
    assert report["solved"] == 4 and report["errors"] == 0
    assert report["recompiles_after_warmup"] == 0


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["micro", "continuous"])
def test_run_loadgen_closed_loop(continuous):
    """The closed loop at 4 in flight over 12 grid requests, two
    tenants: everything solves, no recompile after warmup, the tenant
    axis reconciles."""
    _, treq = grid_requests("dense", n=12)
    report = run_loadgen(treq, params=port_params("dense"), max_batch=4,
                         inflight=4, continuous=continuous,
                         tenants=["a", "b"] * 6, device="cpu")
    assert report["errors"] == 0 and report["solved"] == 12
    assert report["recompiles_after_warmup"] == 0
    assert report["prewarm_compiles"] == 3
    assert report["device"] == "cpu:0" and report["degraded"] is False
    assert sum(r["completed"] for r in report["tenants"].values()) == 12
    assert report["tenant_fairness"]["victim_shed_share"] == 0.0
    if continuous:
        assert report["lane_segments"] >= 12


def test_warm_start_and_deadline(serve):
    """A repeat solve under one warm key starts from the last answer;
    a request whose deadline passes before dispatch expires without
    poisoning the next one."""
    _, treq = grid_requests("dense", n=2)
    svc = serve(SolveService, port_params("dense"), max_batch=4,
                max_wait_ms=150.0, device="cpu")
    first = svc.solve(treq[0], timeout=TIMEOUT, warm_key="fund-a")
    second = svc.solve(treq[0], timeout=TIMEOUT, warm_key="fund-a")
    assert not first.warm_started and second.warm_started
    np.testing.assert_allclose(second.x, first.x, atol=5e-4)
    doomed = svc.submit(treq[1], deadline_s=0.001)
    with pytest.raises(DeadlineExpired):
        svc.result(doomed, timeout=TIMEOUT)
    snap = svc.snapshot()
    assert snap["warm_hits"] == 1 and snap["expired"] == 1


def test_tsan_lock_order_inversion(monkeypatch):
    """The lock-order sanitizer (a host copy of the JAX package's):
    acquiring two lock classes in both orders raises."""
    monkeypatch.setenv("PORQUA_TSAN", "1")
    tsan.reset()
    a, b = tsan.lock("A"), tsan.lock("B")
    with a:
        with b:
            pass
    with pytest.raises(tsan.LockOrderError):
        with b:
            with a:
                pass
    assert tsan.violations()
    tsan.reset()


@pytest.mark.parametrize("config", sorted(GOLDEN_CONFIGS))
def test_golden_first_requests(config):
    """The committed golden's first 2 requests against a fresh JAX run
    (the same XLA path) and the port on the CPU (status, iterations,
    x within the tracking limit of chip_smoke.py), at full width."""
    golden = np.load(GOLDEN)
    meta = json.loads(str(golden["meta"]))
    factor = KINDS[GOLDEN_CONFIGS[config]][0]
    jreq = jax_tracking_requests(meta["n_requests"], meta["n_assets"],
                                 meta["window"], meta["seed"], factor)[:2]
    params = JaxParams(**json.loads(str(golden[f"{config}/params"])))
    padded = [JaxLadder().pad(q)[1] for q in jreq]
    stack = jax_stack_qps(padded, stack_fn=np.stack)
    ref = jax_solve_qp_batch(JaxQP(*(None if a is None else jnp.asarray(a)
                                     for a in stack)), params)
    want = {k: golden[f"{config}/{k}"][:2] for k in ("status", "iters", "x")}
    n = meta["n_assets"]
    np.testing.assert_array_equal(np.asarray(ref.status), want["status"])
    np.testing.assert_array_equal(np.asarray(ref.iters), want["iters"])
    np.testing.assert_allclose(np.asarray(ref.x)[:, :n], want["x"],
                               atol=1e-6, rtol=0)
    qp = pt.CanonicalQP(*(None if a is None else torch.as_tensor(a)
                          for a in stack))
    got = pt.solve_qp_batch(qp, pt.SolverParams(**{
        **dataclasses.asdict(params), "backend": "pallas"}), device="cpu")
    np.testing.assert_array_equal(got.status.numpy(), want["status"])
    np.testing.assert_array_equal(got.iters.numpy(), want["iters"])
    np.testing.assert_allclose(got.x.numpy()[:, :n], want["x"], atol=1e-4,
                               rtol=0)


def write_golden(path=GOLDEN, n_requests=NORTHSTAR["n_requests"],
                 n_assets=NORTHSTAR["n_assets"], batch=GOLDEN_BATCH):
    """The JAX package's ``solve_qp_batch`` (backend "xla", XLA-CPU) over
    the bucket-padded north-star stream, in batches of ``batch`` as the
    service's full slot count runs them (per-lane results do not depend
    on the batch), for each config: status, iterations and the first
    ``n_assets`` entries of x per request, in f32; and, per request,
    the distance of that f32 x to the f64 answer. The requests are
    rebuilt from the seed, not stored."""
    out = {"meta": json.dumps(dict(
        NORTHSTAR, n_requests=n_requests, n_assets=n_assets, batch=batch,
        bucket=[512, 8], platform=jax.default_backend()))}
    for config, kind in GOLDEN_CONFIGS.items():
        params = jax_params(kind)
        reqs = jax_tracking_requests(n_requests, n_assets,
                                     NORTHSTAR["window"], NORTHSTAR["seed"],
                                     KINDS[kind][0])
        padded = [JaxLadder().pad(q)[1] for q in reqs]
        res = {"status": [], "iters": [], "x": [], "x_f64_gap": []}
        for lo in range(0, n_requests, batch):
            def solve(reqs, dt):
                stack = jax_stack_qps(reqs, stack_fn=np.stack)
                return jax_solve_qp_batch(JaxQP(*(
                    None if a is None else jnp.asarray(np.asarray(a, dt))
                    for a in stack)), params)

            sol = solve(padded[lo:lo + batch], np.float32)
            x32 = np.asarray(sol.x)[:, :n_assets]
            res["status"].append(np.asarray(sol.status))
            res["iters"].append(np.asarray(sol.iters))
            res["x"].append(x32)
            # The f64 answer in halves (memory; no lane depends on it).
            half = max(batch // 2, 1)
            x64 = np.concatenate([
                np.asarray(solve(padded[a:min(a + half, lo + batch)],
                                 np.float64).x)[:, :n_assets]
                for a in range(lo, min(lo + batch, n_requests), half)])
            res["x_f64_gap"].append(np.abs(x32 - x64).max(axis=1))
        out[f"{config}/params"] = json.dumps(dataclasses.asdict(params))
        for k, v in res.items():
            out[f"{config}/{k}"] = np.concatenate(v)
        x = out[f"{config}/x"]
        print(config, "solved", int((out[f"{config}/status"] == 1).sum()),
              "iters", sorted(set(out[f"{config}/iters"].tolist())),
              "max |x32 - x64|", float(out[f"{config}/x_f64_gap"].max()),
              "max |sum x - 1|", float(np.abs(x.sum(axis=1) - 1).max()),
              "min x", float(x.min()), "max x", float(x.max()), flush=True)
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: python tests/test_torch_serve.py --write-golden "
                 "[--small]")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if "--small" in sys.argv:
        write_golden(SMALL_GOLDEN, **SMALL_SIZES)
    else:
        write_golden()
