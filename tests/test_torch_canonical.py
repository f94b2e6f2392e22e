"""Parity of the port's canonical form and equilibration with the JAX
package, on the same numpy inputs.

Tolerances: float64 runs the same arithmetic in another summation
order, so results agree to rounding (atol 1e-10); float32 agrees to a
few ulps of each value's own scale (1e-5 relative, atol 1e-6 for
entries near zero).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.qp import canonical as jcan
from porqua_tpu.qp import admm as jadmm
from porqua_tpu.qp import ruiz as jruiz
from porqua_tpu.qp.admm import SolverParams as JaxParams
from porqua_tpu.tracking import build_tracking_qp as jax_build_tracking_qp

from porqua_tpu_torch import convert
from porqua_tpu_torch.qp import admm as tadmm
from porqua_tpu_torch.qp import canonical as tcan
from porqua_tpu_torch.qp import ruiz as truiz
from porqua_tpu_torch.tracking import build_tracking_qp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {np.float64: (torch.float64, dict(atol=1e-10, rtol=0)),
          np.float32: (torch.float32, dict(atol=1e-6, rtol=1e-5))}


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def random_problem(rng, n=9, m=3, r=5):
    Pf = rng.standard_normal((r, n))
    Pdiag = np.abs(rng.standard_normal(n))
    P = 2.0 * Pf.T @ Pf + np.diag(Pdiag)
    C = rng.standard_normal((m, n))
    l = np.concatenate([[1.0], -np.abs(rng.standard_normal(m - 1)) - 0.5])
    u = np.concatenate([[1.0], np.abs(rng.standard_normal(m - 1)) + 0.5])
    return dict(P=P, q=rng.standard_normal(n), C=C, l=l, u=u,
                lb=np.full(n, -1.0), ub=np.full(n, 2.0), Pf=Pf, Pdiag=Pdiag)


def both(prob, dtype, factored, **kw):
    """The same problem built by each package."""
    if not factored:
        prob = {k: v for k, v in prob.items() if k not in ("Pf", "Pdiag")}
    ref = jcan.CanonicalQP.build(**prob, dtype=dtype, **kw)
    port = tcan.CanonicalQP.build(**prob, dtype=DTYPES[dtype][0],
                                  device="cpu", **kw)
    return ref, port


def assert_qp_close(port, ref, tol):
    for name, a, b in zip(ref._fields, port, ref):
        assert (a is None) == (b is None), name
        if a is not None:
            close(a, b, tol)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_build_and_pad(rng, dtype, factored):
    prob = random_problem(rng)
    tol = DTYPES[dtype][1]
    ref, port = both(prob, dtype, factored, n_max=12, m_max=5)
    assert_qp_close(port, ref, tol)
    assert (port.n, port.m) == (ref.n, ref.m) == (12, 5)
    # pad_qp from the natural shape reaches the same padded problem.
    ref0, port0 = both(prob, dtype, factored)
    assert_qp_close(tcan.pad_qp(port0, 12, 5), jcan.pad_qp(ref0, 12, 5), tol)


def test_build_rejects_wrong_factor(rng):
    prob = random_problem(rng)
    prob["Pf"] = prob["Pf"] * 2.0
    with pytest.raises(ValueError, match="do not reproduce P"):
        tcan.CanonicalQP.build(**prob, device="cpu")


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_apply_P_and_objective(rng, dtype, factored):
    ref, port = both(random_problem(rng), dtype, factored)
    x = rng.standard_normal(ref.n).astype(dtype)
    tol = DTYPES[dtype][1]
    close(port.apply_P(torch.as_tensor(x)), ref.apply_P(jnp.asarray(x)), tol)
    close(port.objective_value(torch.as_tensor(x)),
          ref.objective_value(jnp.asarray(x)), tol)


def test_stack_qps(rng):
    probs = [random_problem(rng) for _ in range(3)]
    ref = jcan.stack_qps([jcan.CanonicalQP.build(**p, dtype=np.float64)
                          for p in probs])
    port = tcan.stack_qps([tcan.CanonicalQP.build(**p, dtype=torch.float64,
                                                  device="cpu")
                           for p in probs])
    assert port.batch_shape == (3,)
    assert_qp_close(port, ref, DTYPES[np.float64][1])
    with pytest.raises(ValueError, match="one padded shape"):
        tcan.stack_qps([
            tcan.CanonicalQP.build(**probs[0], device="cpu"),
            tcan.CanonicalQP.build(**probs[0], n_max=12, device="cpu")])


def tracking_pair(rng, dtype, B=3, T=20, N=10):
    X = (rng.standard_normal((B, T, N)) * 0.01).astype(dtype)
    y = X @ np.full(N, 1.0 / N, dtype) + 1e-3 * rng.standard_normal(
        (B, T)).astype(dtype)
    ref = jax.vmap(jax_build_tracking_qp)(jnp.asarray(X), jnp.asarray(y))
    port = build_tracking_qp(torch.as_tensor(X), torch.as_tensor(y))
    return ref, port


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_build_tracking_qp(rng, dtype):
    ref, port = tracking_pair(rng, dtype)
    # The Gram P is a sum over the window: f32 products of daily-return
    # scale carry rounding relative to the largest entry.
    tol = dict(DTYPES[dtype][1], atol=1e-10 if dtype == np.float64 else 1e-8)
    assert_qp_close(port, ref, tol)


@pytest.mark.parametrize("iters", [1, 2, 10])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_equilibrate(rng, dtype, iters):
    ref, port = tracking_pair(rng, dtype)
    r_qp, r_sc = jax.vmap(lambda q: jruiz.equilibrate(q, iters=iters))(ref)
    p_qp, p_sc = truiz.equilibrate(port, iters=iters)
    tol = DTYPES[dtype][1]
    assert_qp_close(p_qp, r_qp, tol)
    for a, b in zip(p_sc, r_sc):
        close(a, b, tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_equilibrate_factored(rng, dtype):
    ref, port = tracking_pair(rng, dtype)
    r_qp, r_sc = jax.vmap(jruiz.equilibrate_factored)(ref)
    p_qp, p_sc = truiz.equilibrate_factored(port)
    tol = DTYPES[dtype][1]
    assert_qp_close(p_qp, r_qp, tol)
    for a, b in zip(p_sc, r_sc):
        close(a, b, tol)


def test_equilibrate_factored_needs_factor(rng):
    _, port = tracking_pair(rng, np.float64)
    with pytest.raises(ValueError, match="requires the factored"):
        truiz.equilibrate_factored(port._replace(Pf=None))


def test_convert_round_trip(rng):
    ref, _ = tracking_pair(rng, np.float32)
    fields = {k: np.asarray(v) for k, v in ref._asdict().items()
              if v is not None}
    port = convert.qp_from_numpy(fields, device="cpu")
    assert port.P.dtype == torch.float32
    assert_qp_close(port, ref, dict(atol=0, rtol=0))
    params = JaxParams(linsolve="woodbury", check_interval=35)
    assert dataclasses.asdict(convert.params_from_dict(
        dataclasses.asdict(params))) == dataclasses.asdict(params)
    with pytest.raises(TypeError):
        convert.params_from_dict({"not_a_field": 1})
    with pytest.raises(ValueError, match="unknown CanonicalQP fields"):
        convert.qp_from_numpy({"Q": np.zeros(2)}, device="cpu")
    # A JAX ADMM state carries across as the port's initial state.
    jstate = jax.vmap(lambda q: jadmm.admm_init(q, params).state)(ref)
    state = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()
         if v is not None}, device="cpu")
    want = tadmm.admm_init(port, convert.params_from_dict(
        dataclasses.asdict(params))).state
    for name, a, b in zip(state._fields, state, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            close(a, b, dict(atol=0, rtol=0))


def test_precision_policy():
    tcan.HP.apply()
    tcan.HP.check()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            tcan.HP.check()
    finally:
        tcan.HP.apply()
