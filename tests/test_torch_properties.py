"""The twin of the JAX package's property suite (``tests/test_properties.py``).

Each of its eight properties runs here on seeded numpy draws, the same
arrays handed to ``porqua_tpu`` and to ``porqua_tpu_torch`` in f64, as
the reference suite runs them:

1. a SOLVED point satisfies KKT (box, rows, stationarity);
2. the unconstrained solve equals the linear solve;
3. padding is neutral and the padded tail is exactly zero;
4. a poisoned (NaN) lane fails while its neighbours solve to the clean
   batch's answer within 1e-9;
5. an infeasible lane is flagged PRIMAL_INFEASIBLE or MAX_ITER;
6. factored scaling reaches the same optimum as Ruiz;
7. ``solve_scan_l1`` runs under the headline config (woodbury, refine
   1, factored scaling) and lands on the default config's chain;
8. restarted Halpern (``backend="auto"``, the plain path) lands on the
   plain optimum, with a native L1 term.

The property is checked on the port's result at the reference's
tolerances, and the port is held against the JAX package on the same
arrays: status and iterations equal, and |dx| <= ``X_PARITY`` in f64.
The reference draws with hypothesis, unseeded; here every draw comes
from ``np.random.default_rng`` with a fixed seed (``draws``), and where
the reference draws with ``jax.random`` (property 7) both sides get the
numpy twin's arrays (``synthetic_universe_np``). Tier 1 runs two draws
per property, as one case, at small shapes that share compiled JAX
programs where they can (KKT's draws share the padding case's);
the cases marked ``slow`` draw the reference's full shape ranges, one
case a draw (the JAX side compiles a program per shape).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porqua_tpu.batch import FIXED_UNIVERSE as JAX_FIXED_UNIVERSE
from porqua_tpu.batch import solve_scan_l1 as jax_solve_scan_l1
from porqua_tpu.qp.admm import SolverParams as JaxParams
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps
from porqua_tpu.qp.solve import solve_qp as jax_solve_qp
from porqua_tpu.qp.solve import solve_qp_batch as jax_solve_qp_batch
from porqua_tpu.tracking import build_tracking_qp as jax_build_tracking_qp

import porqua_tpu_torch as pt
from porqua_tpu_torch.qp.canonical import stack_qps

#: Clears JAX's caches after any test of a process near the kernel's map
#: limit, in every run that collects this module and only there (see
#: the plugin's docstring).
pytest_plugins = ("tests.jax_release",)

#: The reference suite's solver settings.
PARAMS = JaxParams(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000)
#: Port against JAX on the same f64 arrays: |dx| bound (both run the
#: same f64 arithmetic in other summation orders; the draws measured
#: up to 5e-15).
X_PARITY = 1e-9
SOLVED = int(pt.Status.SOLVED)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # Small f64 problems gain nothing from intra-op threads beside the
    # suite's other workers.
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def port_params(params):
    return pt.SolverParams(**dataclasses.asdict(params))


def random_qp_arrays(seed, n, m, box_lo, box_hi):
    """The reference suite's ``_random_qp`` draw, as numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    P = A @ A.T + 0.2 * np.eye(n)
    q = rng.standard_normal(n)
    C = np.vstack([np.ones(n), rng.standard_normal((m - 1, n))]) if m else None
    l = u = None
    if m:
        l = np.concatenate([[1.0], np.full(m - 1, -3.0)])
        u = np.concatenate([[1.0], np.full(m - 1, 3.0)])
    return P, q, C, l, u, np.full(n, box_lo), np.full(n, box_hi)


def both(*args, **kw):
    """The same arrays as a JAX and a port ``CanonicalQP`` (f64)."""
    return (JaxQP.build(*args, dtype=np.float64, **kw),
            pt.CanonicalQP.build(*args, dtype=torch.float64, device="cpu",
                                 **kw))


def assert_parity(ref, sol):
    """Port against JAX: status and iterations equal, |dx| <= X_PARITY
    on every lane that has finite x in both."""
    np.testing.assert_array_equal(np.asarray(ref.status),
                                  sol.status.numpy())
    np.testing.assert_array_equal(np.asarray(ref.iters), sol.iters.numpy())
    rx, px = np.asarray(ref.x), sol.x.numpy()
    finite = np.isfinite(rx) & np.isfinite(px)
    np.testing.assert_array_equal(finite, np.isfinite(rx))
    assert float(np.abs(rx[finite] - px[finite]).max(initial=0.0)) \
        <= X_PARITY


def draws(seed, count, **ranges):
    """``count`` seeded draws: per draw a problem seed and one value per
    range (ints from ``(lo, hi)`` inclusive, floats from a float pair)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        d = {"seed": int(rng.integers(0, 2**31 - 1))}
        for name, (lo, hi) in ranges.items():
            d[name] = (float(rng.uniform(lo, hi)) if isinstance(lo, float)
                       else int(rng.integers(lo, hi + 1)))
        out.append(d)
    return out


def cases(tier1, slow):
    """The tier-1 draws as one case (they share the JAX package's
    compiled programs, which a worker of its own would build again),
    then each ``slow`` draw as a case of its own."""
    return ([pytest.param(tier1, id="t1")]
            + [pytest.param([d], id=f"slow-{i}", marks=pytest.mark.slow)
               for i, d in enumerate(slow)])


# ---------------------------------------------------------------------------
# 1. KKT at SOLVED
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ds", cases(
    [dict(d, n=8, m=3) for d in draws(1, 2, width=(0.5, 5.0))],
    draws(11, 10, n=(2, 24), m=(0, 6), width=(0.5, 5.0))))
def test_solved_points_satisfy_kkt(ds):
    for d in ds:
        args = random_qp_arrays(d["seed"], d["n"], d["m"], -d["width"],
                                d["width"])
        jqp, qp = both(*args)
        sol = pt.solve_qp(qp, port_params(PARAMS), device="cpu")
        assert_parity(jax_solve_qp(jqp, PARAMS), sol)
        if int(sol.status) != SOLVED:
            continue  # non-SOLVED statuses are allowed; mislabeling is not
        P, q, C, l, u, lb, ub = args
        x = sol.x.numpy()
        assert np.all(x >= lb - 1e-6) and np.all(x <= ub + 1e-6)
        if d["m"]:
            Cx = C @ x
            assert np.all(Cx >= l - 1e-5) and np.all(Cx <= u + 1e-5)
        grad = P @ x + q + qp.C.numpy().T @ sol.y.numpy() + sol.mu.numpy()
        assert float(np.abs(grad).max()) <= 1e-4 * max(1.0, float(
            np.abs(q).max()))


# ---------------------------------------------------------------------------
# 2. the unconstrained solve is the linear solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ds", cases(
    [dict(d, n=10) for d in draws(2, 2)], draws(12, 6, n=(2, 16))))
def test_unconstrained_matches_linear_solve(ds):
    for d in ds:
        rng = np.random.default_rng(d["seed"])
        A = rng.standard_normal((d["n"], d["n"]))
        P = A @ A.T + 0.5 * np.eye(d["n"])
        q = rng.standard_normal(d["n"])
        jqp, qp = both(P, q)   # unbounded box, no rows
        sol = pt.solve_qp(qp, port_params(PARAMS), device="cpu")
        assert_parity(jax_solve_qp(jqp, PARAMS), sol)
        assert int(sol.status) == SOLVED
        np.testing.assert_allclose(sol.x.numpy(), np.linalg.solve(P, -q),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# 3. padding is neutral
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ds", cases(
    [dict(d, pad=3) for d in draws(3, 2)], draws(13, 6, pad=(1, 9))))
def test_padding_neutrality(ds):
    for d in ds:
        args = random_qp_arrays(d["seed"], 8, 3, 0.0, 1.0)
        jqp, qp = both(*args)
        jpad, pad = both(*args, n_max=8 + d["pad"], m_max=3 + 2 * d["pad"])
        prm = port_params(PARAMS)
        a = pt.solve_qp(qp, prm, device="cpu")
        b = pt.solve_qp(pad, prm, device="cpu")
        assert_parity(jax_solve_qp(jqp, PARAMS), a)
        assert_parity(jax_solve_qp(jpad, PARAMS), b)
        assert int(a.status) == int(b.status)
        np.testing.assert_allclose(b.x.numpy()[:8], a.x.numpy(), atol=1e-6)
        assert float(np.abs(b.x.numpy()[8:]).max(initial=0.0)) == 0.0


# ---------------------------------------------------------------------------
# 4-5. failure isolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeds", [
    (1, 2, 3), pytest.param((4, 5, 6), marks=pytest.mark.slow)])
def test_poisoned_problem_does_not_contaminate_batch(seeds):
    """NaN data in one problem: that problem fails, neighbours solve."""
    pairs = [both(*random_qp_arrays(s, 10, 3, -2.0, 2.0)) for s in seeds]
    jqps, qps = [p[0] for p in pairs], [p[1] for p in pairs]
    jpoisoned = jqps[1]._replace(q=jnp.full(10, jnp.nan, jnp.float64))
    poisoned = qps[1]._replace(q=torch.full((10,), float("nan"),
                                            dtype=torch.float64))
    prm = port_params(PARAMS)
    sols = pt.solve_qp_batch(stack_qps([qps[0], poisoned, qps[2]]), prm,
                             device="cpu")
    assert_parity(jax_solve_qp_batch(
        jax_stack_qps([jqps[0], jpoisoned, jqps[2]]), PARAMS), sols)
    status = sols.status.numpy()
    assert status[0] == SOLVED and status[2] == SOLVED
    assert status[1] != SOLVED
    clean = pt.solve_qp_batch(stack_qps([qps[0], qps[2]]), prm,
                              device="cpu")
    np.testing.assert_allclose(sols.x[0].numpy(), clean.x[0].numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(sols.x[2].numpy(), clean.x[1].numpy(),
                               atol=1e-9)


@pytest.mark.parametrize("seed", [11, pytest.param(12,
                                                   marks=pytest.mark.slow)])
def test_infeasible_problem_in_batch_is_flagged(seed):
    """A genuinely infeasible date reports a certificate, not garbage."""
    n = 8
    good = both(*random_qp_arrays(seed, n, 3, 0.0, 1.0))
    bad = both(np.eye(n), np.zeros(n), np.vstack([np.ones(n), np.ones(n)]),
               np.array([1.0, -np.inf]), np.array([1.0, -1.0]),
               np.zeros(n), np.ones(n), m_max=3)
    sols = pt.solve_qp_batch(stack_qps([good[1], bad[1]]),
                             port_params(PARAMS), device="cpu")
    assert_parity(jax_solve_qp_batch(jax_stack_qps([good[0], bad[0]]),
                                     PARAMS), sols)
    status = sols.status.numpy()
    assert status[0] == SOLVED
    assert status[1] in (int(pt.Status.PRIMAL_INFEASIBLE),
                         int(pt.Status.MAX_ITER))


# ---------------------------------------------------------------------------
# 6. factored scaling lands on Ruiz's optimum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ds", cases(
    [dict(d, n=8, extra=8) for d in draws(6, 2)],
    draws(16, 5, n=(6, 28), extra=(4, 24))))
def test_factored_scaling_solution_parity_property(ds):
    """An overdetermined factored tracking problem (T > n: a unique
    optimum): factor-derived Jacobi scaling lands where Ruiz does."""
    for d in ds:
        T = d["n"] + d["extra"]
        rng = np.random.default_rng(d["seed"])
        X = rng.standard_normal((T, d["n"])) * 0.01
        y = X @ rng.dirichlet(np.ones(d["n"])) + 0.001 * rng.standard_normal(T)
        jqp = jax_build_tracking_qp(jnp.asarray(X), jnp.asarray(y))
        qp = pt.build_tracking_qp(torch.as_tensor(X), torch.as_tensor(y))
        base = dataclasses.replace(PARAMS, max_iter=8000, eps_abs=1e-9,
                                   eps_rel=1e-9, linsolve="woodbury",
                                   woodbury_refine=1)
        fact = dataclasses.replace(base, scaling_mode="factored")
        ref = pt.solve_qp(qp, port_params(base), device="cpu")
        got = pt.solve_qp(qp, port_params(fact), device="cpu")
        assert_parity(jax_solve_qp(jqp, base), ref)
        assert_parity(jax_solve_qp(jqp, fact), got)
        assert bool(ref.found) and bool(got.found)
        np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), atol=5e-7)


# ---------------------------------------------------------------------------
# 7. the L1 scan under the headline config
# ---------------------------------------------------------------------------

def test_scan_l1_accepts_headline_config():
    """The turnover-coupled scan runs under the headline config
    (woodbury, refine 1, factored scaling) and agrees with the
    default-config chain; both packages get the numpy twin's draw of
    the reference's universe (seed 3, 5 dates, window 40, 16 assets)."""
    Xs, ys = (a.astype(np.float64)
              for a in pt.synthetic_universe_np(3, 5, 40, 16))
    jqps = jax.vmap(jax_build_tracking_qp)(jnp.asarray(Xs), jnp.asarray(ys))
    qps = pt.build_tracking_qp(torch.as_tensor(Xs), torch.as_tensor(ys))
    w0 = np.full(16, 1.0 / 16)
    base = JaxParams(max_iter=8000, eps_abs=1e-9, eps_rel=1e-9)
    head = dataclasses.replace(base, linsolve="woodbury", woodbury_refine=1,
                               scaling_mode="factored")
    out = {}
    for name, prm in (("base", base), ("head", head)):
        sol = pt.solve_scan_l1(qps, 16, torch.as_tensor(w0), 0.002,
                               port_params(prm),
                               universes=pt.FIXED_UNIVERSE, device="cpu")
        assert_parity(jax_solve_scan_l1(
            jqps, 16, jnp.asarray(w0), 0.002, prm,
            universes=JAX_FIXED_UNIVERSE), sol)
        assert np.all(sol.status.numpy() == SOLVED), name
        out[name] = sol.x.numpy()
    np.testing.assert_allclose(out["head"], out["base"], atol=5e-7)


# ---------------------------------------------------------------------------
# 8. Halpern lands on the plain optimum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ds", cases(
    [dict(d, n=8, m=3) for d in draws(8, 2)],
    draws(18, 6, n=(6, 24), m=(1, 5))))
def test_halpern_matches_plain_admm_optimum(ds):
    """Restarted Halpern anchoring accelerates the same fixed-point
    iteration: on a strongly convex problem with a native L1 term it
    lands where the plain averaged iteration lands."""
    for d in ds:
        seed = d["seed"] % 10_001
        args = random_qp_arrays(seed, d["n"], d["m"], -2.0, 2.0)
        jqp, qp = both(*args)
        rng = np.random.default_rng(seed + 1)
        l1w = np.where(rng.random(qp.n) < 0.5, 0.3, 0.0)
        l1c = rng.standard_normal(qp.n) * 0.1
        hal_prm = dataclasses.replace(PARAMS, halpern=True, check_interval=100)
        out = {}
        for name, prm in (("plain", PARAMS), ("halpern", hal_prm)):
            sol = pt.solve_qp(qp, port_params(prm),
                              l1_weight=torch.as_tensor(l1w),
                              l1_center=torch.as_tensor(l1c), device="cpu")
            assert_parity(jax_solve_qp(jqp, prm, l1_weight=jnp.asarray(l1w),
                                       l1_center=jnp.asarray(l1c)), sol)
            assert int(sol.status) == SOLVED, name
            out[name] = sol.x.numpy()
        np.testing.assert_allclose(out["halpern"], out["plain"], atol=5e-6)
