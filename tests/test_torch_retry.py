"""The port's retry layer (``porqua_tpu_torch/resilience/retry.py``)
against the JAX package's: the same scripted attempt outcomes on the
same stepped ``FaultClock`` and jitter seed give the same retries,
hedges, give-ups and validation failures, and each request resolves
exactly once; the same fault scenario and seed through both packages'
services give the same counts. And the port's own rule: a retry goes
back to the primary device unless the caller named a fallback (here a
second CPU device, ``cpu:1``, stands in for the card)."""

import math
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.resilience import faults as jfaults
from porqua_tpu.resilience.retry import RetryManager as JaxRetryManager
from porqua_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from porqua_tpu.resilience.retry import validate_result as jax_validate
from porqua_tpu.serve import BucketLadder as JaxLadder
from porqua_tpu.serve import SolveService as JaxService
from porqua_tpu.serve.batcher import SolveError as JaxSolveError
from porqua_tpu.serve.metrics import ServeMetrics as JaxMetrics
from porqua_tpu.serve.service import Ticket as JaxTicket

import porqua_tpu_torch as pt
from porqua_tpu_torch.resilience import (RetryManager, RetryPolicy, faults,
                                         validate_result)
from porqua_tpu_torch.serve import (BucketLadder, DeviceHealth,
                                    ServeMetrics, SolveService)
from porqua_tpu_torch.serve.batcher import SolveError
from porqua_tpu_torch.serve.service import Ticket

WAIT_S = 10.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Result:
    def __init__(self, x):
        self.x = np.asarray(x, float)
        self.prim_res = self.dual_res = self.obj_val = 0.0
        self.trace_id = None


class ScriptedService:
    """``_submit_raw`` resolves each attempt at once from a script:
    ``script[request][attempt]`` is "ok", "nan" (a non-finite answer),
    "fail" (a SolveError) or "hang" (never resolved)."""

    def __init__(self, script, ticket_cls, error_cls):
        self.script = script
        self.ticket_cls, self.error_cls = ticket_cls, error_cls
        self.attempts = {}
        self.hanging = []

    def _submit_raw(self, qp, deadline_s=None, warm_key=None, timeout=None,
                    tenant=None):
        k = self.attempts.get(qp, 0)
        self.attempts[qp] = k + 1
        plan = self.script[qp]
        what = plan[min(k, len(plan) - 1)]
        fut = Future()
        if what == "ok":
            fut.set_result(_Result([0.5, 0.5]))
        elif what == "nan":
            fut.set_result(_Result([math.nan, 0.5]))
        elif what == "fail":
            fut.set_exception(self.error_cls("injected"))
        else:
            self.hanging.append(fut)
        return self.ticket_cls(future=fut, submitted=time.monotonic())


SCRIPT = {"a": ["ok"], "b": ["fail", "ok"], "c": ["nan", "nan", "ok"],
          "d": ["fail", "fail", "fail", "fail"], "e": ["hang", "ok"],
          "f": ["nan"] * 5}


def drive_manager(manager_cls, policy_cls, metrics_cls, ticket_cls,
                  error_cls, clk):
    svc = ScriptedService(SCRIPT, ticket_cls, error_cls)
    metrics = metrics_cls()
    mgr = manager_cls(svc, policy_cls(max_attempts=3, backoff_base_s=0.1,
                                      hedge_after_s=0.5, seed=4),
                      metrics, clock=clk)
    mgr.start()
    calls = {}
    tickets = {}
    try:
        for rid in SCRIPT:
            t = mgr.submit(rid, request_id=rid, deadline_s=100.0)
            calls[rid] = [0]
            t.future.add_done_callback(
                lambda _f, c=calls[rid]: c.__setitem__(0, c[0] + 1))
            tickets[rid] = t
        # Idempotent resubmission: the same id, the same future.
        assert mgr.submit("a", request_id="a").future is tickets["a"].future
        deadline = time.monotonic() + WAIT_S
        while mgr.pending() and time.monotonic() < deadline:
            clk.advance(0.25)
            time.sleep(0.06)
        for fut in svc.hanging:       # the hung primary answers late
            fut.set_result(_Result([0.5, 0.5]))
    finally:
        mgr.stop()
    outcome = {rid: ("ok" if t.future.exception() is None else "failed")
               for rid, t in tickets.items()}
    snap = metrics.snapshot()
    counts = {k: snap[k] for k in ("retries", "hedges_fired", "hedges_won",
                                   "resumed_requests", "retry_giveups",
                                   "validation_failures")}
    return outcome, counts, {k: v[0] for k, v in calls.items()}, \
        dict(svc.attempts)


def test_scripted_attempts_match_jax():
    got = drive_manager(RetryManager, RetryPolicy, ServeMetrics, Ticket,
                        SolveError, faults.FaultClock())
    want = drive_manager(JaxRetryManager, JaxRetryPolicy, JaxMetrics,
                         JaxTicket, JaxSolveError, jfaults.FaultClock())
    assert got == want
    outcome, counts, calls, attempts = got
    assert outcome == {"a": "ok", "b": "ok", "c": "ok", "d": "failed",
                       "e": "ok", "f": "failed"}
    assert set(calls.values()) == {1}            # resolved once each
    assert counts["hedges_won"] >= 1 and counts["retry_giveups"] == 2
    assert attempts["d"] == 4                    # three primaries, one hedge


def test_backoff_jitter_and_validation_match_jax():
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    tp = RetryPolicy(backoff_base_s=0.02, jitter=0.5)
    jp = JaxRetryPolicy(backoff_base_s=0.02, jitter=0.5)
    assert [tp.backoff_s(a, rng_t) for a in range(1, 6)] == [
        jp.backoff_s(a, rng_j) for a in range(1, 6)]
    for x in ([0.5, 0.5], [math.nan, 1.0], [math.inf, 0.0]):
        assert validate_result(_Result(x)) == jax_validate(_Result(x))
    with pytest.raises(AttributeError):
        pt.resilience.NoSuchName


def _tiny(n):
    qps = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((12, 6))
        P = A.T @ A / 12 + np.eye(6)
        qps.append((P, rng.standard_normal(6)))
    return qps


PARAMS = dict(max_iter=500, eps_abs=1e-5, eps_rel=1e-5, polish=False,
              check_interval=25)


def serve_scenario(jax, name, n=6):
    """One scenario through one package's service, one request at a
    time (so the seams fire in the same order): its counters."""
    ladder = (JaxLadder if jax else BucketLadder)(n_rungs=(8,),
                                                  m_rungs=(4,))
    mod = jfaults if jax else faults
    if jax:
        svc = JaxService(JaxParams(**PARAMS), ladder=ladder, max_batch=1,
                         max_wait_ms=1.0,
                         retry=JaxRetryPolicy(backoff_base_s=0.001, seed=3))
        build = lambda P, q: JaxQP.build(P, q, C=np.ones((1, 6)),
                                         l=np.ones(1), u=np.ones(1),
                                         lb=np.zeros(6), ub=np.ones(6))
    else:
        svc = SolveService(pt.SolverParams(**PARAMS, backend="pallas"),
                           ladder=ladder, max_batch=1, max_wait_ms=1.0,
                           retry=RetryPolicy(backoff_base_s=0.001, seed=3),
                           device="cpu")
        build = lambda P, q: pt.CanonicalQP.build(
            P, q, C=np.ones((1, 6)), l=np.ones(1), u=np.ones(1),
            lb=np.zeros(6), ub=np.ones(6), device="cpu")
    qps = [build(P, q) for P, q in _tiny(n)]
    outcomes = []
    with svc:
        svc.prewarm(qps[0])
        svc.metrics.reset_window()
        with mod.active(mod.builtin_scenarios(seed=0)[name],
                        metrics=svc.metrics):
            for qp in qps:
                try:
                    outcomes.append(int(svc.solve(qp, timeout=60).status))
                except Exception as exc:  # noqa: BLE001 - an outcome
                    outcomes.append(type(exc).__name__)
        snap = svc.snapshot()
    return outcomes, {k: snap[k] for k in (
        "retries", "retry_giveups", "validation_failures",
        "resumed_requests", "faults_injected", "failed", "completed")}


@pytest.mark.parametrize("name", ["nan_lanes", "device_lost"])
def test_scenario_counts_match_jax(name):
    """The same builtin scenario and seed through both services (no
    fallback on either side: the JAX service's health manager points its
    fallback at its only CPU device)."""
    assert serve_scenario(False, name) == serve_scenario(True, name)


@pytest.mark.parametrize("fallback", [None, "cpu"],
                         ids=["no_fallback", "named_cpu"])
def test_retry_reaches_a_cpu_only_when_named(fallback):
    """A device loss under the retry layer: with no fallback named the
    retried requests go back to the primary (``cpu:1``, standing in for
    the card) and never reach ``cpu:0``; with ``fallback="cpu"`` named,
    the breaker moves them there."""
    qps = [pt.CanonicalQP.build(P, q, C=np.ones((1, 6)), l=np.ones(1),
                                u=np.ones(1), lb=np.zeros(6),
                                ub=np.ones(6), device="cpu")
           for P, q in _tiny(4)]
    metrics = ServeMetrics()
    health = DeviceHealth(primary=torch.device("cpu", 1), fallback=fallback,
                          probe_fn=lambda d: True, failure_threshold=2,
                          recovery_interval_s=3600.0, metrics=metrics)
    svc = SolveService(pt.SolverParams(**PARAMS, backend="pallas"),
                       ladder=BucketLadder(n_rungs=(8,), m_rungs=(4,)),
                       max_batch=1, max_wait_ms=1.0, metrics=metrics,
                       health=health,
                       retry=RetryPolicy(backoff_base_s=0.001, seed=0))
    lost = faults.Scenario("dl", (faults.FaultSpec.make(
        "serve.dispatch", "device_lost", count=2),))
    with svc:
        svc.prewarm(qps[0])
        with faults.active(lost, metrics=metrics):
            results = [svc.solve(q, timeout=60) for q in qps]
    devices = {r.device for r in results}
    assert all(r.found for r in results)
    assert devices == ({"cpu:1"} if fallback is None else {"cpu:0"})
    snap = svc.snapshot()
    assert snap["dispatch_failures"] == 2
    # Without a fallback the tripped breaker has nowhere to go: that
    # attempt fails, and the retry layer resubmits it to the primary.
    assert snap["failed"] == snap["retries"] == (fallback is None)


@pytest.mark.parametrize("linsolve", ["trinv", "chol", "inverse",
                                      "woodbury"])
def test_a_nan_request_fails_alone_as_in_jax(linsolve):
    """A request with a NaN in q, batched with healthy ones: its lane
    comes back non-finite and the others solve, in both packages (the
    port's factorizations mark the failed lane NaN instead of raising
    for the batch)."""
    from porqua_tpu.qp.canonical import stack_qps as jax_stack
    from porqua_tpu.qp.solve import solve_qp_batch as jax_solve

    from porqua_tpu_torch.qp.canonical import stack_qps

    parts = []
    for P, q in _tiny(4):
        parts.append(dict(P=P, q=q, C=np.ones((1, 6)), l=np.ones(1),
                          u=np.ones(1), lb=np.zeros(6), ub=np.ones(6)))
    parts[2]["q"] = parts[2]["q"].copy()
    parts[2]["q"][0] = np.nan
    factor = linsolve == "woodbury"
    extra = lambda p: (dict(Pf=np.linalg.cholesky(p["P"]).T / np.sqrt(2),
                            Pdiag=np.zeros(6)) if factor else {})
    kw = dict(PARAMS, linsolve=linsolve)
    jsol = jax_solve(jax_stack([JaxQP.build(**p, **extra(p))
                                for p in parts]), JaxParams(**kw))
    tsol = pt.solve_qp_batch(
        stack_qps([pt.CanonicalQP.build(**p, **extra(p), device="cpu")
                   for p in parts]),
        pt.SolverParams(**kw, backend="pallas"), device="cpu")
    assert tsol.status.tolist() == np.asarray(jsol.status).tolist()
    x, jx = tsol.x.numpy(), np.asarray(jsol.x)
    assert not np.isfinite(x[2]).all() and not np.isfinite(jx[2]).all()
    healthy = [0, 1, 3]
    assert np.isfinite(x[healthy]).all()
    np.testing.assert_allclose(x[healthy], jx[healthy], atol=1e-4)
