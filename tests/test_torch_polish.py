"""The port's active-set polish against the JAX package's, on the same
ADMM iterate.

The JAX package runs the scaled problem's ADMM to loose tolerance
(polish off); both packages then polish that same point (x, z, w, y,
mu): the JAX one lane by lane under ``vmap``, the port as one batch
with per-lane masks. Outputs agree to 1e-10 (f64) and 5e-5 (f32, the
scaled frame's values are of order 1: about 400 ulps, as for the
tracking solve), and each lane's accept decision (did the polished
point replace the iterate?) is the same in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porqua_tpu.qp.admm import SolverParams as JaxParams
from porqua_tpu.qp.admm import admm_solve as jax_admm_solve
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.polish import polish_iterate as jax_polish_iterate
from porqua_tpu.qp.solve import _prepare_impl as jax_prepare
from porqua_tpu.qp.solve import solve_qp as jax_solve_qp
from porqua_tpu.qp.solve import solve_qp_batch as jax_solve_qp_batch

import porqua_tpu_torch as pt
from porqua_tpu_torch.convert import qp_from_numpy
from porqua_tpu_torch.qp.polish import (
    _kkt_solve_factored,
    classify_l1,
    polish_capacitance_dim,
    polish_iterate,
)
from porqua_tpu_torch.qp.ruiz import Scaling

TOL = {np.float32: 5e-5, np.float64: 1e-10}
B, T, N = 5, 8, 16
RIDGE = 1e-3
ADMM = dict(eps_abs=1e-3, eps_rel=1e-3, polish=False, max_iter=400)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def problems(dtype, case):
    """B ridge tracking problems (N assets, a T-day window, box
    [0, 0.3]) as numpy ``CanonicalQP`` fields, plus the L1 pair
    (original frame) or None. The ridge makes each optimum unique (with
    T < N the plain Gram is singular, its optimum a face on which two
    roundings may land apart). ``factored`` keeps the factor
    (k = T + m < N, the factored polish); ``dense`` drops it. ``dead_row`` adds the equality row
    x_0 + x_1 = 0 over two variables pinned by lb = ub = 0: every
    variable of that row is pinned, so its Schur diagonal is exactly 0
    and the factored polish must drop it."""
    Xs, ys = pt.synthetic_universe_np(3, B, T, N)
    Xs, ys = Xs.astype(np.float64), ys.astype(np.float64)
    m = 2 if case.startswith("dead_row") else 1
    C = np.zeros((B, m, N))
    C[:, 0] = 1.0
    l = np.ones((B, m))
    lb = np.zeros((B, N))
    ub = np.full((B, N), 0.3)
    if m == 2:
        C[:, 1, :2] = 1.0
        l[:, 1] = 0.0
        ub[:, :2] = 0.0
    f = dict(
        P=2 * np.einsum("btn,btk->bnk", Xs, Xs) + 2 * RIDGE * np.eye(N),
        q=-2 * np.einsum("bt,btn->bn", ys, Xs),
        C=C, l=l, u=l.copy(), lb=lb, ub=ub,
        var_mask=np.ones((B, N)), row_mask=np.ones((B, m)),
        constant=np.einsum("bt,bt->b", ys, ys))
    if not case.startswith("dense"):
        f["Pf"], f["Pdiag"] = Xs, np.full((B, N), 2 * RIDGE)
    f = {k: v.astype(dtype) for k, v in f.items()}
    l1 = None
    if case.endswith("l1"):
        rng = np.random.default_rng(9)
        l1 = (np.full((B, N), 2e-4, dtype),
              rng.dirichlet(np.ones(N), B).astype(dtype))
    return f, l1


def jax_iterate(fields, l1, params):
    """The JAX package's scaled problem, scaling and ADMM iterate (and
    the L1 pair in the scaled frame), per lane under vmap."""
    qp = JaxQP(**{k: jnp.asarray(v) for k, v in fields.items()})

    def one(q, lw, lc):
        scaled, scaling, _, _, lws, lcs = jax_prepare(q, params, None, None,
                                                      lw, lc)
        st = jax_admm_solve(scaled, scaling, params, l1_weight=lws,
                            l1_center=lcs)
        return scaled, scaling, st, lws, lcs

    if l1 is None:
        return jax.vmap(lambda q: one(q, None, None))(qp)
    return jax.vmap(one)(qp, jnp.asarray(l1[0]), jnp.asarray(l1[1]))


def to_np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()
            if v is not None}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["factored", "dense", "factored_l1",
                                  "dense_l1", "dead_row", "dead_row_l1"])
def test_polish_iterate_matches_jax(case, dtype):
    fields, l1 = problems(dtype, case)
    params = JaxParams(**ADMM)
    scaled, scaling, st, lws, lcs = jax_iterate(fields, l1, params)
    point = tuple(np.asarray(getattr(st, k)) for k in "xzwy") + (
        np.asarray(st.mu),)

    def jax_one(s, sc, x, z, w, y, mu, lw, lc):
        return jax_polish_iterate(s, sc, params, x, z, w, y, mu, lw, lc)

    axes = (0,) * 7 + ((None, None) if l1 is None else (0, 0))
    want = jax.vmap(jax_one, in_axes=axes)(
        scaled, scaling, *map(jnp.asarray, point), lws, lcs)
    want = [np.asarray(a) for a in want]

    t = lambda a: None if a is None else torch.as_tensor(np.asarray(a))
    tqp = qp_from_numpy(to_np(scaled), "cpu")
    assert (polish_capacitance_dim(tqp) is None) == case.startswith("dense")
    got = polish_iterate(tqp, Scaling(*map(t, scaling)),
                         pt.SolverParams(**dataclasses.asdict(params)),
                         *map(t, point), l1_weight=t(lws), l1_center=t(lcs))
    got = [g.numpy() for g in got]

    accept_want = np.any(want[0] != point[0], axis=-1)
    accept_got = np.any(got[0] != point[0], axis=-1)
    np.testing.assert_array_equal(accept_got, accept_want)
    assert accept_want.any(), "no lane took its polished point"
    for name, g, w in zip(("x", "z", "w", "y", "mu"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL[dtype], rtol=0,
                                   err_msg=name)


def test_dead_row_is_dropped_from_the_schur_system():
    """The pinned row's Schur diagonal is exactly 0 in every lane: the
    factored KKT solve returns a zero dual for it and finite x."""
    fields, _ = problems(np.float64, "dead_row")
    qp = qp_from_numpy(fields, "cpu")
    aB = torch.zeros_like(qp.q)
    aB[:, :2] = 1.0
    aC = torch.ones_like(qp.l)
    x, nu, tau = _kkt_solve_factored(
        qp, pt.SolverParams(), aB, aC, torch.zeros_like(qp.q), qp.l,
        qp.q, torch.tensor(1e-7, dtype=torch.float64))
    assert torch.isfinite(x).all() and torch.isfinite(tau).all()
    assert torch.all(nu[:, 1] == 0) and torch.all(nu[:, 0] != 0)
    np.testing.assert_allclose(x.sum(-1).numpy(), 1.0, atol=1e-10)


@pytest.mark.parametrize("mode", ["iterate", "solution"])
def test_classify_l1_matches_jax(mode):
    from porqua_tpu.qp.polish import classify_l1 as jax_classify_l1

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 20)) * 1e-3
    mu = rng.standard_normal((3, 20)) * 2e-3
    w = np.where(rng.random((3, 20)) < 0.8, 2e-3, 0.0)
    c = np.where(rng.random((3, 20)) < 0.5, x, 0.0)
    err = np.array([1e-6, 1e-4, 0.0])
    want = jax.vmap(lambda *a: jax_classify_l1(*a, dual_mode=mode))(
        *map(jnp.asarray, (x, mu, w, c, err)))
    got = classify_l1(*map(torch.as_tensor, (x, mu, w, c, err)),
                      dual_mode=mode)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


SOLVE_PARAMS = dict(eps_abs=1e-4, eps_rel=1e-4, max_iter=2000)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["factored", "dense", "factored_l1",
                                  "dead_row"])
def test_solve_qp_batch_with_polish_matches_jax(case, dtype):
    """``solve_qp_batch`` with the library-default polish: status and
    iterations equal, x, y, mu and the objective within the tolerance."""
    fields, l1 = problems(dtype, case)
    params = JaxParams(**SOLVE_PARAMS)
    assert params.polish
    jqp = JaxQP(**{k: jnp.asarray(v) for k, v in fields.items()})
    kw = {} if l1 is None else dict(l1_weight=jnp.asarray(l1[0]),
                                    l1_center=jnp.asarray(l1[1]))
    ref = jax_solve_qp_batch(jqp, params, **kw)
    tkw = {} if l1 is None else dict(l1_weight=torch.as_tensor(l1[0]),
                                     l1_center=torch.as_tensor(l1[1]))
    sol = pt.solve_qp_batch(qp_from_numpy(fields, "cpu"),
                            pt.SolverParams(**dataclasses.asdict(params)),
                            device="cpu", **tkw)
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    for k in ("x", "z", "obj_val"):
        np.testing.assert_allclose(getattr(sol, k).numpy(),
                                   np.asarray(getattr(ref, k)),
                                   atol=TOL[dtype], rtol=0, err_msg=k)


def test_solve_qp_default_params_polish():
    """``pt.solve_qp`` with default ``SolverParams()`` (polish on, f64)
    on one problem equals the JAX ``solve_qp``."""
    fields, _ = problems(np.float64, "dense")
    one = {k: v[0] for k, v in fields.items()}
    ref = jax_solve_qp(JaxQP(**{k: jnp.asarray(v) for k, v in one.items()}))
    sol = pt.solve_qp(qp_from_numpy(one, "cpu"), device="cpu")
    assert int(sol.status) == int(ref.status) == pt.Status.SOLVED
    assert int(sol.iters) == int(ref.iters)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), atol=1e-10)
