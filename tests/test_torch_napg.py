"""The port's NAPG backend (``porqua_tpu_torch/qp/napg.py``) against the
JAX package on the same numpy inputs: the reference's box-and-budget
family (tests/test_napg.py), one dtype pinned on both sides per case.

Per lane, status and iterations are equal and x agrees within X_TOL:
float64 to rounding (measured 1.5e-15), float32 within 5e-6 (measured
1.6e-7; the bisection prox and the momentum steps carry f32 rounding
through a few dozen iterations).
"""

import dataclasses

import numpy as np
import pytest
import torch

from porqua_tpu.obs.rings import ring_history as jax_ring_history
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.qp.solve import solve_qp_batch as jax_solve_qp_batch

import porqua_tpu_torch as pt
from porqua_tpu_torch.compaction import CompactingDriver
from porqua_tpu_torch.obs.rings import ring_history, solution_ring_history
from porqua_tpu_torch.qp.admm import Status
from porqua_tpu_torch.qp.canonical import CanonicalQP, stack_qps
from porqua_tpu_torch.qp.napg import (napg_init, napg_segment_step,
                                      napg_solve)
from porqua_tpu_torch.qp.ruiz import equilibrate

PARAMS = pt.SolverParams(method="napg", max_iter=2000, eps_abs=1e-6,
                         eps_rel=1e-6, polish=False, check_interval=10)
N, B = 32, 6
X_TOL = {np.float32: 5e-6, np.float64: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def box_parts(seed=7, n=N, box=0.1, rows=1):
    """Dense factor-model P, the budget row (and ``rows - 1`` signed
    exposure bands), box [0, box]: the tracking serve bucket at test
    size, as numpy parts."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(B):
        F = rng.standard_normal((max(2, n // 4), n))
        P = F.T @ F / n + 0.05 * np.eye(n)
        q = rng.standard_normal(n) * 0.1
        C = np.concatenate([np.ones((1, n)),
                            0.1 * rng.standard_normal((rows - 1, n))])
        l = np.concatenate([[1.0], np.full(rows - 1, -0.05)])
        u = np.concatenate([[1.0], np.full(rows - 1, 0.05)])
        parts.append(dict(P=P, q=q, C=C, l=l, u=u, lb=np.zeros(n),
                          ub=np.full(n, box)))
    return parts


def port_batch(dtype=np.float32, rows=1):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    return stack_qps([CanonicalQP.build(**p, dtype=tdt, device="cpu")
                      for p in box_parts(rows=rows)])


def jax_batch_of(dtype=np.float32, rows=1):
    return jax_stack_qps([JaxQP.build(**p, dtype=dtype)
                          for p in box_parts(rows=rows)])


@pytest.fixture(scope="module")
def batch():
    return port_batch()


def jax_params(params):
    return JaxParams(**dataclasses.asdict(params))


def lane(qp, i):
    return type(qp)(*(None if f is None else f[i:i + 1] for f in qp))


# ---------------------------------------------------------------------------
# the stepped API
# ---------------------------------------------------------------------------

def test_segment_step_matches_napg_solve(batch):
    """A host loop over napg_segment_step reproduces napg_solve bit for
    bit on a lane."""
    pt.qp.canonical.HP.apply()
    scaled, scaling = equilibrate(lane(batch, 0), iters=PARAMS.scaling_iters)
    carry = napg_init(scaled, PARAMS)
    segments = 0
    while (int(carry.state.status[0]) == Status.RUNNING
           and int(carry.state.iters[0]) < PARAMS.max_iter):
        carry = napg_segment_step(carry, scaled, scaling, PARAMS)[0]
        segments += 1
    assert segments >= 2, "the family must take several segments"
    ref = napg_solve(scaled, scaling, PARAMS)
    for name in ("x", "z", "w", "y", "mu", "rho_bar", "iters", "status",
                 "prim_res", "dual_res"):
        assert torch.equal(getattr(carry.state, name), getattr(ref, name)), name


def test_segment_step_never_retires_max_iter(batch):
    pt.qp.canonical.HP.apply()
    short = dataclasses.replace(PARAMS, max_iter=10, eps_abs=1e-12,
                                eps_rel=1e-12)
    scaled, scaling = equilibrate(batch, iters=short.scaling_iters)
    carry = napg_init(scaled, short)
    for _ in range(3):
        carry = napg_segment_step(carry, scaled, scaling, short)[0]
    assert carry.state.iters.tolist() == [30] * B
    assert carry.state.status.tolist() == [Status.RUNNING] * B


# ---------------------------------------------------------------------------
# against the JAX package, and against the ADMM backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, rows, over", [
    (np.float64, 1, {}),
    (np.float32, 1, {}),
    (np.float32, 1, dict(eps_abs=1e-5, eps_rel=1e-5, polish=True)),
    (np.float32, 1, dict(max_iter=20)),
    (np.float64, 3, dict(napg_project_cycles=2, max_iter=300)),
    (np.float32, 3, dict(napg_project_cycles=2, max_iter=300)),
], ids=["f64", "f32", "f32-polish", "f32-max-iter", "f64-rows3",
        "f32-rows3"])
def test_napg_matches_jax(dtype, rows, over):
    """Per lane: status and iterations equal the JAX package's, x within
    X_TOL (NAPG ignores ``backend``: the plain path either way). Three
    rows run the coordinate-ascent sweeps of the prox."""
    params = dataclasses.replace(PARAMS, **over)
    ref = jax_solve_qp_batch(jax_batch_of(dtype, rows), jax_params(params))
    sol = pt.solve_qp_batch(port_batch(dtype, rows),
                            dataclasses.replace(params, backend="pallas"),
                            device="cpu")
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x),
                               atol=X_TOL[dtype], rtol=0)


def test_napg_agrees_with_admm(batch):
    sol_n = pt.solve_qp_batch(batch, PARAMS, device="cpu")
    sol_a = pt.solve_qp_batch(batch, dataclasses.replace(PARAMS,
                                                         method="admm"),
                              device="cpu")
    assert (sol_n.status == Status.SOLVED).all()
    assert (sol_a.status == Status.SOLVED).all()
    np.testing.assert_allclose(sol_n.x.numpy(), sol_a.x.numpy(), atol=2e-3)
    np.testing.assert_allclose(sol_n.obj_val.numpy(), sol_a.obj_val.numpy(),
                               rtol=1e-3, atol=1e-5)
    assert float(sol_n.prim_res.max()) < 1e-4
    assert float(sol_n.dual_res.max()) < 1e-4


def test_napg_feasible_on_budget_row(batch):
    """The prox is exact: budget row and box hold to tight tolerance."""
    x = pt.solve_qp_batch(batch, PARAMS, device="cpu").x.numpy()
    np.testing.assert_allclose(x.sum(axis=1), 1.0, atol=1e-5)
    assert float(x.min()) >= -1e-7
    assert float(x.max()) <= 0.1 + 1e-7


# ---------------------------------------------------------------------------
# restarts and rings, the polish fallback, compaction
# ---------------------------------------------------------------------------

def test_restarts_fire_and_rings_match_jax():
    """The gradient restart fires, the rings' third slot carries the
    cumulative restart count (non-decreasing, the same as the JAX
    package's), and the decoded residuals equal the JAX package's
    (f64, within 1e-9 relative and 1e-12 absolute)."""
    params = dataclasses.replace(PARAMS, ring_size=64)
    sol = pt.solve_qp_batch(port_batch(np.float64), params, device="cpu")
    ref = jax_solve_qp_batch(jax_batch_of(np.float64), jax_params(params))
    fired = 0
    for i in range(B):
        got = solution_ring_history(sol, params.check_interval, index=i)
        want = jax_ring_history(
            np.asarray(ref.ring_prim)[i], np.asarray(ref.ring_dual)[i],
            np.asarray(ref.ring_rho)[i], int(np.asarray(ref.iters)[i]),
            params.check_interval)
        assert got["iters"] == want["iters"]
        assert got["rho"] == want["rho"] == sorted(got["rho"])
        for key in ("prim_res", "dual_res"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                       atol=1e-12)
        assert got["prim_res"][-1] == float(sol.prim_res[i])
        fired += got["rho"][-1] >= 1
    assert fired, "the restart machinery never fired"


def test_f32_rings_end_at_the_carry(batch):
    params = dataclasses.replace(PARAMS, ring_size=4)
    pt.qp.canonical.HP.apply()
    scaled, scaling = equilibrate(batch, iters=params.scaling_iters)
    carry = napg_init(scaled, params)
    for _ in range(3):
        carry = napg_segment_step(carry, scaled, scaling, params)[0]
    for i in range(B):
        hist = ring_history(carry.state.ring_prim[i],
                            carry.state.ring_dual[i],
                            carry.state.ring_rho[i],
                            int(carry.state.iters[i]), 10)
        assert hist["iters"] == [10, 20, 30]
        assert hist["rho"][-1] == int(carry.restart_count[i])
        assert hist["dual_res"][-1] == float(carry.state.dual_res[i])


def test_max_iter_polish_fallback(batch):
    starved = dataclasses.replace(PARAMS, max_iter=20)
    one = lane(batch, 0)
    raw = pt.solve_qp_batch(one, starved, device="cpu")
    assert int(raw.status[0]) == Status.MAX_ITER
    polished = pt.solve_qp_batch(one, dataclasses.replace(starved,
                                                          polish=True),
                                 device="cpu")
    assert int(polished.iters[0]) == 20
    assert float(polished.prim_res[0]) <= float(raw.prim_res[0])
    assert float(polished.dual_res[0]) <= float(raw.dual_res[0])
    assert int(polished.status[0]) == Status.SOLVED


def test_compaction_parity_with_napg(batch):
    """With method="napg" the compacting driver equals the fused solve
    bit for bit on every lane, in lane order, with no compile after
    prewarm, while its width walks down the ladder."""
    fused = pt.solve_qp_batch(batch, PARAMS, device="cpu")
    driver = CompactingDriver(PARAMS, device="cpu")
    assert driver.prewarm(B, N, 1) > 0
    sol, rep = driver.solve(batch)
    assert rep.compiles == 0
    assert (fused.status == Status.SOLVED).all()
    assert len(set(rep.dispatch_sizes)) >= 2
    for name in ("x", "z", "y", "mu", "status", "iters", "prim_res",
                 "dual_res"):
        assert torch.equal(getattr(sol, name), getattr(fused, name)), name
