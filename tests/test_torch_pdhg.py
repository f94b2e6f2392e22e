"""The port's restarted PDHG backend (``porqua_tpu_torch/qp/pdhg.py``)
and the convergence rings (``qp/admm.py``, ``obs/rings.py``) against
the JAX package on the same numpy inputs.

Each case pins one dtype on both sides (tests/conftest.py turns x64
on). In float64 the two packages agree to rounding: status and
iterations equal, x within 1e-12 (measured 3.3e-16), rings within
1e-9 relative. In float32 status and iterations are equal per lane and
x within X_TOL (measured 1.5e-7; the iterations carry f32 rounding,
about 6e-8 per operation, through a few hundred restarted steps),
except at eps 1e-5, where one lane of the reference family sits at the
f32 floor and stops one check apart in the two packages (the port at
the f64 check): that case is held by the twin rule against the f64
run (ROADMAP section C).
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
from porqua_tpu_torch.qp.pdhg import (pdhg_init, pdhg_segment_step,
                                      pdhg_solve)
from porqua_tpu_torch.qp.ruiz import equilibrate

PARAMS = pt.SolverParams(method="pdhg", max_iter=2000, eps_abs=1e-5,
                         eps_rel=1e-5, polish=False, check_interval=25)
N, M, B = 16, 5, 6
X_TOL = {np.float32: 5e-6, np.float64: 1e-12}
# The twin rule of chip_smoke.py: per lane, the port's f32 distance to
# the f64 answer at most TWIN times XLA-CPU's f32 distance (+ 2 f32 ulps
# of the largest entry per iteration).
TWIN = 4.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exposure_parts(seed=7, n=N, m=M, box=0.4):
    """The reference's family (tests/test_pdhg.py): dense factor-model
    P, a budget row and signed exposure bands, as numpy parts."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(B):
        F = rng.standard_normal((max(2, n // 4), n))
        P = F.T @ F / n + 0.1 * np.eye(n)
        C = np.concatenate([np.ones((1, n)),
                            rng.standard_normal((m - 1, n))])
        l = np.concatenate([[1.0], np.full(m - 1, -1.0)])
        parts.append(dict(P=P, q=rng.standard_normal(n) * 0.1, C=C, l=l,
                          u=np.ones(m), lb=np.zeros(n),
                          ub=np.full(n, box)))
    return parts


def port_batch(dtype=np.float32):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    return stack_qps([CanonicalQP.build(**p, dtype=tdt, device="cpu")
                      for p in exposure_parts()])


def jax_batch_of(dtype=np.float32):
    return jax_stack_qps([JaxQP.build(**p, dtype=dtype)
                          for p in exposure_parts()])


@pytest.fixture(scope="module")
def batch():
    return port_batch()


@pytest.fixture(scope="module")
def jax_batch():
    return jax_batch_of()


def lane(qp, i):
    return type(qp)(*(None if f is None else f[i:i + 1] for f in qp))


def jax_params(params):
    return JaxParams(**dataclasses.asdict(params))


# ---------------------------------------------------------------------------
# the stepped API
# ---------------------------------------------------------------------------

def test_segment_step_matches_pdhg_solve(batch):
    """A host loop over pdhg_segment_step reproduces pdhg_solve bit for
    bit on a lane (the same segment program)."""
    pt.qp.canonical.HP.apply()
    scaled, scaling = equilibrate(lane(batch, 0), iters=PARAMS.scaling_iters)
    carry = pdhg_init(scaled, PARAMS)
    segments = 0
    while (int(carry.state.status[0]) == Status.RUNNING
           and int(carry.state.iters[0]) < PARAMS.max_iter):
        carry = pdhg_segment_step(carry, scaled, scaling, PARAMS)[0]
        segments += 1
    assert segments >= 2, "the family must take several segments"
    ref = pdhg_solve(scaled, scaling, PARAMS)
    for name in ("x", "z", "w", "y", "mu", "rho_bar", "iters", "status",
                 "prim_res", "dual_res"):
        assert torch.equal(getattr(carry.state, name), getattr(ref, name)), name


def test_segment_step_never_retires_max_iter(batch):
    """The stepper leaves the budget to the caller: past max_iter a lane
    stays RUNNING."""
    pt.qp.canonical.HP.apply()
    short = dataclasses.replace(PARAMS, max_iter=25)
    scaled, scaling = equilibrate(batch, iters=short.scaling_iters)
    carry = pdhg_init(scaled, short)
    for _ in range(3):
        carry = pdhg_segment_step(carry, scaled, scaling, short)[0]
    assert carry.state.iters.tolist() == [75] * B
    assert carry.state.status.tolist() == [Status.RUNNING] * B


# ---------------------------------------------------------------------------
# against the JAX package, and against the ADMM backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, params", [
    (np.float64, PARAMS),
    (np.float32, dataclasses.replace(PARAMS, eps_abs=3e-5, eps_rel=3e-5)),
    (np.float32, dataclasses.replace(PARAMS, eps_abs=1e-4, eps_rel=1e-4,
                                     polish=True)),
    (np.float32, dataclasses.replace(PARAMS, adaptive_rho=False,
                                     max_iter=200)),
], ids=["f64-eps1e-5", "f32-eps3e-5", "f32-polish", "f32-fixed-omega"])
def test_pdhg_matches_jax(dtype, params):
    """Per lane: status and iterations equal the JAX package's, x within
    X_TOL (PDHG ignores ``backend``: the plain path either way)."""
    ref = jax_solve_qp_batch(jax_batch_of(dtype), jax_params(params))
    sol = pt.solve_qp_batch(port_batch(dtype),
                            dataclasses.replace(params, backend="pallas"),
                            device="cpu")
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x),
                               atol=X_TOL[dtype], rtol=0)


def test_f32_lane_at_the_floor_held_by_the_twin_rule(batch, jax_batch):
    """At eps 1e-5 lane 5 of this family stops one check apart in f32
    (XLA-CPU 300, the port 275; both packages' f64 runs 275). Every
    lane: status equal, each iteration count equal to XLA-CPU's or to
    the f64 run's, and x by the twin rule against the f64 answer."""
    ref = jax_solve_qp_batch(jax_batch, jax_params(PARAMS))
    sol = pt.solve_qp_batch(batch, PARAMS, device="cpu")
    f64 = pt.solve_qp_batch(port_batch(np.float64), PARAMS, device="cpu")
    it, it_ref, it64 = (sol.iters.numpy(), np.asarray(ref.iters),
                        f64.iters.numpy())
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    assert np.all((it == it_ref) | (it == it64))
    assert (it != it_ref).sum() == 1     # the measured lane, no more
    x64 = f64.x.numpy()
    d_port = np.abs(sol.x.numpy() - x64).max(axis=1)
    d_ref = np.abs(np.asarray(ref.x) - x64).max(axis=1)
    floor = 2 * it.max() * np.finfo(np.float32).eps * np.abs(x64).max()
    assert np.all(d_port <= TWIN * d_ref + floor), (d_port, d_ref)
    # A control the rule must fail: lanes in the wrong order.
    d_bad = np.abs(np.roll(sol.x.numpy(), 1, axis=0) - x64).max(axis=1)
    assert not np.all(d_bad <= TWIN * d_ref + floor)


def test_pdhg_agrees_with_admm(batch):
    """Both backends certify SOLVED on every lane and land on the same
    optimum (the shared residual measure)."""
    sol_p = pt.solve_qp_batch(batch, PARAMS, device="cpu")
    sol_a = pt.solve_qp_batch(batch, dataclasses.replace(PARAMS,
                                                         method="admm"),
                              device="cpu")
    assert (sol_p.status == Status.SOLVED).all()
    assert (sol_a.status == Status.SOLVED).all()
    np.testing.assert_allclose(sol_p.x.numpy(), sol_a.x.numpy(), atol=2e-3)
    np.testing.assert_allclose(sol_p.obj_val.numpy(), sol_a.obj_val.numpy(),
                               rtol=1e-3, atol=1e-5)
    assert float(sol_p.prim_res.max()) < 1e-3
    assert float(sol_p.dual_res.max()) < 1e-3


@pytest.mark.parametrize("method", ["qpth", "PDHG"])
def test_unknown_method_fails_loudly(method, batch):
    with pytest.raises(ValueError, match="unknown method"):
        pt.solve_qp_batch(batch, dataclasses.replace(PARAMS, method=method),
                          device="cpu")


# ---------------------------------------------------------------------------
# restarts and rings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method, ring_size", [
    ("pdhg", 64), ("pdhg", 4), ("admm", 64), ("admm", 2)])
def test_rings_match_jax_and_record_restarts(method, ring_size):
    """The rings ride the solution (f64): decoded per lane with the
    port's ring_history they equal the JAX package's decoded rings (the
    same checks, samples within 1e-9 relative, the third ring exactly
    for PDHG's restart counts), a short ring keeps the trailing window,
    and the last sample is the final residual (polish off). PDHG's
    restarts fire and its restart count never decreases."""
    params = dataclasses.replace(PARAMS, method=method, ring_size=ring_size)
    sol = pt.solve_qp_batch(port_batch(np.float64), params, device="cpu")
    ref = jax_solve_qp_batch(jax_batch_of(np.float64), jax_params(params))
    assert sol.ring_prim.shape == (B, ring_size)
    for i in range(B):
        got = solution_ring_history(sol, params.check_interval, index=i)
        want = jax_ring_history(
            np.asarray(ref.ring_prim)[i], np.asarray(ref.ring_dual)[i],
            np.asarray(ref.ring_rho)[i], int(np.asarray(ref.iters)[i]),
            params.check_interval)
        assert got["iters"] == want["iters"]
        assert len(got["iters"]) == min(ring_size,
                                        int(sol.iters[i]) // 25)
        for key in ("prim_res", "dual_res", "rho"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                       err_msg=key)
        assert got["prim_res"][-1] == float(sol.prim_res[i])
        assert got["dual_res"][-1] == float(sol.dual_res[i])
        if method == "pdhg":
            assert got["rho"] == want["rho"]
            assert got["rho"] == sorted(got["rho"])
    if method == "pdhg" and ring_size == 64:
        last = [solution_ring_history(sol, 25, index=i)["rho"][-1]
                for i in range(B)]
        assert max(last) >= 1, "the restart machinery never fired"


def test_ring_history_decodes_a_wrapped_ring():
    """ring_history on a hand-made wrapped ring, against the JAX
    package's decoder on the same arrays."""
    prim, dual = np.arange(5.0), np.arange(5.0) * 10
    rho = torch.arange(5.0) * 100
    for iters in (50, 125, 200):
        got = ring_history(torch.as_tensor(prim), torch.as_tensor(dual),
                           rho, iters, 25)
        assert got == jax_ring_history(prim, dual, rho.numpy(), iters, 25)


def test_f32_rings_record_the_run(batch):
    """In f32 the rings hold the run's own checks: the last sample is
    the final residual, restart counts never decrease and end at the
    carry's total; without ring_size the fields stay None."""
    params = dataclasses.replace(PARAMS, ring_size=64)
    pt.qp.canonical.HP.apply()
    scaled, scaling = equilibrate(batch, iters=params.scaling_iters)
    carry = pdhg_init(scaled, params)
    for _ in range(6):
        carry = pdhg_segment_step(carry, scaled, scaling, params)[0]
    for i in range(B):
        hist = ring_history(carry.state.ring_prim[i],
                            carry.state.ring_dual[i],
                            carry.state.ring_rho[i],
                            int(carry.state.iters[i]), 25)
        assert hist["prim_res"][-1] == float(carry.state.prim_res[i])
        assert hist["rho"] == sorted(hist["rho"])
        assert hist["rho"][-1] == int(carry.restart_count[i])
    sol = pt.solve_qp_batch(batch, PARAMS, device="cpu")
    assert sol.ring_prim is None and sol.ring_rho is None
    assert solution_ring_history(sol, 25, index=0) is None


# ---------------------------------------------------------------------------
# MAX_ITER retirement and the polish fallback; compaction
# ---------------------------------------------------------------------------

def test_max_iter_polish_fallback(batch):
    """A lane retired out of budget still gets the active-set polish and
    is re-graded SOLVED when the polished point meets tolerance."""
    starved = dataclasses.replace(PARAMS, max_iter=50)
    one = lane(batch, 0)
    raw = pt.solve_qp_batch(one, starved, device="cpu")
    assert int(raw.status[0]) == Status.MAX_ITER
    polished = pt.solve_qp_batch(one, dataclasses.replace(starved,
                                                          polish=True),
                                 device="cpu")
    assert int(polished.iters[0]) == 50
    assert float(polished.prim_res[0]) <= float(raw.prim_res[0])
    assert float(polished.dual_res[0]) <= float(raw.dual_res[0])
    assert int(polished.status[0]) == Status.SOLVED


def test_compaction_parity_with_pdhg(batch):
    """The compacting driver is backend-agnostic: with method="pdhg"
    every lane equals the fused solve bit for bit, in lane order, with
    no compile after prewarm."""
    fused = pt.solve_qp_batch(batch, PARAMS, device="cpu")
    driver = CompactingDriver(PARAMS, device="cpu")
    assert driver.prewarm(B, N, M) > 0
    sol, rep = driver.solve(batch)
    assert rep.compiles == 0
    assert (fused.status == Status.SOLVED).all()
    assert len(set(rep.dispatch_sizes)) >= 2
    for name in ("x", "z", "y", "mu", "status", "iters", "prim_res",
                 "dual_res"):
        assert torch.equal(getattr(sol, name), getattr(fused, name)), name
