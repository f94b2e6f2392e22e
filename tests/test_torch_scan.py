"""The port's date-chained scans against the JAX package's, on the same
numpy inputs in the same process, and the committed JAX golden of
``chip_smoke.py``'s scan phases.

Both packages are pinned to one dtype per case (tests/conftest.py
turns x64 on). Tolerances, as in tests/test_torch_tracking.py: f64
agrees to rounding carried through the chain (1e-9); f32 rounds at
~6e-8 per operation and the ADMM iterations carry it, so weights agree
within 5e-5 absolute (about 400 ulps of the largest weight).

Regenerate the golden (XLA-CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_scan.py --write-golden
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu import batch as jbatch
from porqua_tpu import builders as jb
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps
from porqua_tpu.qp.lift import _as_parts as jax_as_parts
from porqua_tpu.qp.lift import lift_turnover_constraint as jax_lift
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.tracking import build_tracking_qp as jax_build_tracking_qp

import chip_smoke
import porqua_tpu_torch as pt
from porqua_tpu_torch.qp.solve import QPSolution
from porqua_tpu_torch import batch as tbatch
from porqua_tpu_torch import builders as tb
from porqua_tpu_torch.ops import admm_kernel as tk
from porqua_tpu_torch.qp.lift import _as_parts, lift_turnover_constraint
from porqua_tpu_torch.synthetic import (synthetic_usa_np, usa_benchmark_np,
                                        usa_rebdates)
from porqua_tpu_torch.tracking import benchmark_grid_np, synthetic_universe_np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                      "scan_golden.npz")

W_TOL = {np.float32: 5e-5, np.float64: 1e-9}
TC = 0.002
# chip_smoke.py's scan phases: bench.py's chained-cost configuration
# (the 500-asset universe over 64 dates, tc 0.002, the headline
# woodbury params) and a grid of 8 benchmark columns over the same
# universe (the f32 default linsolve, auto -> trinv).
FULL = dict(seed=42, n_dates=64, window=252, n_assets=500, n_columns=8,
            usa_dates=None)
HEADLINE = dict(max_iter=2000, eps_abs=1e-3, eps_rel=1e-3, polish=False,
                scaling_iters=2)
SCAN_PARAMS = dict(HEADLINE, linsolve="woodbury", woodbury_refine=0,
                   check_interval=35, scaling_mode="factored")
GRID_PARAMS = dict(HEADLINE, linsolve="auto")
# examples/backtest_usa.py configuration 2: min-volume filter, budget +
# box <= 0.05, turnover budget 0.25, LeastSquares f64 with a ridge,
# eps 1e-8.
USA_WIDTH, USA_UPPER, USA_BUDGET = 252, 0.05, 0.25
USA_PARAMS = dict(eps_abs=1e-8, eps_rel=1e-8)
SOL_KEYS = ("x", "y", "status", "iters", "prim_res", "dual_res", "obj_val")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small problems gain nothing from intra-op threads, and the
    suite runs several workers on one machine: one thread per op avoids
    the contention that slowed these loops of small ops by about 10x
    (a LAD run: 2.3 s alone, 192 s beside busy workers, 21 s there on
    one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_of(sol):
    return {k: np.asarray(getattr(sol, k)) for k in SOL_KEYS}


def port_params(opts, **over):
    return pt.SolverParams(**{**opts, **over})


def assert_same_chain(port, ref, dtype, n=None):
    """Status and iterations equal on every date (and lane), weights
    (the first ``n`` variables) by the dtype's tolerance."""
    port, ref = np_of(port), np_of(ref)
    np.testing.assert_array_equal(port["status"], ref["status"])
    np.testing.assert_array_equal(port["iters"], ref["iters"])
    sl = (Ellipsis, slice(None, n))
    np.testing.assert_allclose(port["x"][sl], ref["x"][sl],
                               atol=W_TOL[dtype], rtol=0)


# ---------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------

def tracking_inputs(dtype, n_dates=6, window=40, n_assets=16, seed=7):
    Xs, ys = synthetic_universe_np(seed, n_dates, window, n_assets)
    return Xs.astype(dtype), ys.astype(dtype)


def jax_qps(Xs, ys):
    return jax.vmap(jax_build_tracking_qp)(jnp.asarray(Xs), jnp.asarray(ys))


def port_qps(Xs, ys):
    return pt.build_tracking_qp(torch.as_tensor(Xs), torch.as_tensor(ys))


def jax_scan_l1(Xs, ys, w_init, params, tc=TC):
    qps = jax_qps(Xs, ys)
    return jax.jit(lambda q: jbatch.solve_scan_l1(
        q, Xs.shape[-1], jnp.asarray(w_init, Xs.dtype), tc, params,
        universes=jbatch.FIXED_UNIVERSE))(qps)


def port_scan_l1(Xs, ys, w_init, params, tc=TC):
    return tbatch.solve_scan_l1(port_qps(Xs, ys), Xs.shape[-1], w_init, tc,
                                params, universes=tbatch.FIXED_UNIVERSE,
                                device="cpu")


def grid_inputs(Xs, ys, n_columns):
    """``(B, T, ...)`` problems: the universe ``Xs`` against each
    benchmark column of :func:`benchmark_grid_np`."""
    return Xs, benchmark_grid_np(Xs, ys, n_columns).astype(Xs.dtype)


def jax_grid(Xs, Ys, w_init, params, tc=TC):
    grid = jax.vmap(lambda y: jax_qps(Xs, y))(jnp.asarray(Ys))
    return jbatch.solve_scan_l1_grid(
        grid, Xs.shape[-1], jnp.asarray(w_init, Xs.dtype), tc, params,
        mesh=None, universes=jbatch.FIXED_UNIVERSE)


def port_grid_qps(Xs, Ys):
    cols = [port_qps(Xs, y) for y in Ys]
    return pt.CanonicalQP(*(None if f[0] is None else torch.stack(f)
                            for f in zip(*cols)))


def lifted(P, q, n, x0, budget, lift, as_parts):
    parts = as_parts(P, q, None, None, None, np.zeros(n), np.ones(n))
    parts["C"], parts["l"], parts["u"] = (np.ones((1, n)), np.ones(1),
                                          np.ones(1))
    return lift(parts, x0, budget)


def jax_turnover_qp(P, q, n, x0, budget, dtype):
    p = lifted(P, q, n, x0, budget, jax_lift, jax_as_parts)
    return JaxQP.build(p["P"], p["q"], C=p["C"], l=p["l"], u=p["u"],
                       lb=p["lb"], ub=p["ub"], dtype=dtype)


def port_turnover_qp(P, q, n, x0, budget, dtype):
    p = lifted(P, q, n, x0, budget, lift_turnover_constraint, _as_parts)
    return pt.CanonicalQP.build(p["P"], p["q"], C=p["C"], l=p["l"],
                                u=p["u"], lb=p["lb"], ub=p["ub"],
                                dtype=dtype, device="cpu")


# ---------------------------------------------------------------------
# solve_scan_l1
# ---------------------------------------------------------------------

# The scan tests' tolerance: the headline eps in f32 (tighter f32 solves
# sit on the residual floor, where one last-bit difference moves a date
# by a segment), 1e-5 in f64.
EPS = {np.float32: 1e-3, np.float64: 1e-5}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("config", ["woodbury", "trinv"])
def test_scan_l1_matches_jax(config, dtype):
    """Six chained dates at 40 x 16, each backend against its JAX
    counterpart: the port's kernel path (the plain twins on the CPU)
    against the Pallas kernels in interpret mode and against JAX's XLA
    path with the same linsolve (the golden's pairing, chip_smoke.py),
    and the port's plain path against JAX's XLA path."""
    Xs, ys = tracking_inputs(dtype)
    opts = SCAN_PARAMS if config == "woodbury" else GRID_PARAMS
    opts = dict(opts, eps_abs=EPS[dtype], eps_rel=EPS[dtype])
    w_init = np.full(Xs.shape[-1], 1.0 / Xs.shape[-1])
    ref = jax_scan_l1(Xs, ys, w_init, JaxParams(**opts))
    ref_kernel = jax_scan_l1(Xs, ys, w_init,
                             JaxParams(**opts, backend="pallas"))
    port = port_scan_l1(Xs, ys, w_init, port_params(opts, backend="pallas"))
    assert port.x.shape == (6, 16) and port.status.shape == (6,)
    assert_same_chain(port, ref_kernel, dtype)
    assert_same_chain(port, ref, dtype)
    plain = port_scan_l1(Xs, ys, w_init, port_params(opts, backend="xla"))
    assert_same_chain(plain, ref, dtype)


def test_scan_l1_carries_the_cost():
    """The chain is live: a large transaction cost keeps every date's
    weights nearer the previous date's than a cost-free chain does."""
    Xs, ys = tracking_inputs(np.float64)
    w_init = np.full(16, 1.0 / 16)
    prm = port_params(SCAN_PARAMS, eps_abs=1e-6, eps_rel=1e-6)
    turnover = {}
    for tc in (0.0, 0.05):
        x = port_scan_l1(Xs, ys, w_init, prm, tc=tc).x.numpy()
        prev = np.vstack([w_init, x[:-1]])
        turnover[tc] = np.abs(x - prev).sum()
    assert turnover[0.05] < 0.5 * turnover[0.0]


def test_failed_date_keeps_holdings():
    """Date 2 is infeasible (box 0.01 under a budget of 1): it does not
    solve, the carried holdings stay date 1's weights in both packages,
    and date 3 is charged against them."""
    pt.qp.canonical.HP.apply()
    Xs, ys = tracking_inputs(np.float64, n_dates=4, n_assets=12)
    opts = dict(SCAN_PARAMS, max_iter=200, eps_abs=1e-6, eps_rel=1e-6)
    jq, tq = jax_qps(Xs, ys), port_qps(Xs, ys)
    jq = jq._replace(ub=jq.ub.at[2].set(0.01))
    tq = tq._replace(ub=tq.ub.clone())
    tq.ub[2] = 0.01
    w0 = np.full(12, 1.0 / 12)
    ref, ref_carry = jbatch._scan_l1_core(
        jq, jnp.asarray(w0), jnp.full(12, TC), JaxParams(**opts),
        return_carry=True)
    port, carry = tbatch._scan_l1_core(
        tbatch._lanes(tq), torch.as_tensor(w0)[None], torch.full((12,), TC, dtype=torch.float64),
        port_params(opts, backend="pallas"), return_carry=True)
    port = tbatch._one_lane(port)
    assert int(port.status[2]) != pt.Status.SOLVED
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(port.iters.numpy(), np.asarray(ref.iters))
    # Weights on the solved dates (an infeasible date's last iterate
    # carries its growing duals' rounding, not an answer).
    solved = [0, 1, 3]
    np.testing.assert_allclose(port.x.numpy()[solved],
                               np.asarray(ref.x)[solved],
                               atol=W_TOL[np.float64], rtol=0)
    # Date 3 solved: the carry is its weights; its cost was charged
    # against date 1's (a chain through date 2's x would differ).
    np.testing.assert_array_equal(carry[0][0].numpy(), port.x[3].numpy())
    _, short = tbatch._scan_l1_core(
        tbatch._lanes(pt.CanonicalQP(*(None if f is None else f[:3]
                                       for f in tq))),
        torch.as_tensor(w0)[None], torch.full((12,), TC, dtype=torch.float64),
        port_params(opts, backend="pallas"), return_carry=True)
    assert torch.equal(short[0][0], port.x[1])


def test_all_dates_failing_keep_the_initial_holdings():
    """max_iter=25 at a tiny eps: no date solves, so the holdings stay
    w_init through the whole chain in both packages."""
    pt.qp.canonical.HP.apply()
    Xs, ys = tracking_inputs(np.float64, n_dates=3)
    opts = dict(SCAN_PARAMS, max_iter=25, check_interval=5, eps_abs=1e-12,
                eps_rel=1e-12)
    w0 = np.linspace(0.5, 1.5, 16) / 16
    _, (wj, _, _) = jbatch._scan_l1_core(
        jax_qps(Xs, ys), jnp.asarray(w0), jnp.full(16, TC),
        JaxParams(**opts), return_carry=True)
    sols, (wt, _, _) = tbatch._scan_l1_core(
        tbatch._lanes(port_qps(Xs, ys)), torch.as_tensor(w0)[None],
        torch.full((16,), TC, dtype=torch.float64), port_params(opts, backend="pallas"),
        return_carry=True)
    assert (sols.status == pt.Status.MAX_ITER).all()
    np.testing.assert_array_equal(wt[0].numpy(), w0)
    np.testing.assert_array_equal(np.asarray(wj), w0)


def test_f32_chain_drift_and_the_per_date_check():
    """The f32 L1 chain of a face-valued problem (a 40-day window under
    80 assets, as chip_smoke.py's 252 days under 500) drifts date by
    date: over these 8 dates the port's f32 chain ends 2.3e-4 from
    XLA-CPU's, past the f32 weight tolerance, with the same status and
    iterations on every date (at 64 dates and 500 assets, 5.9e-2,
    ROADMAP section C). So chip_smoke.py holds the chain by the chain
    twin rule (test_f32_chain_twin_ratio_between_healthy_chains) and the
    weights per date: each date solved alone from the reference's carry,
    where the status and iterations agree (here) and the weights agree
    within 1e-4 at chip_smoke.py's size (2.2e-5 on the H100; each
    date's optimum is a face too, and at this small size solved alone
    the weights land 1.5e-4 apart)."""
    Xs, ys = synthetic_universe_np(42, 8, 40, 80)
    w_init = np.full(80, 1.0 / 80, np.float32)
    ref = np_of(jax_scan_l1(Xs, ys, w_init, JaxParams(**SCAN_PARAMS)))
    prm = port_params(SCAN_PARAMS, backend="pallas")
    port = np_of(port_scan_l1(Xs, ys, w_init, prm))
    for k in ("status", "iters"):
        np.testing.assert_array_equal(port[k], ref[k])
    assert np.abs(port["x"] - ref["x"]).max() > W_TOL[np.float32]
    pt.qp.canonical.HP.apply()
    per_date = tbatch._one_lane(chip_smoke.per_date(
        tbatch._lanes(port_qps(Xs, ys)), torch.as_tensor(w_init)[None], prm,
        tbatch._l1_cost(tbatch._l1_weight(80, 80, TC, torch.float32, "cpu")),
        torch.tensor(ref["x"])[None], torch.tensor(ref["y"])[None]))
    np.testing.assert_array_equal(per_date.status.numpy(), ref["status"])
    np.testing.assert_array_equal(per_date.iters.numpy(), ref["iters"])


@pytest.mark.parametrize("seed", [0, 7])
def test_f32_chain_twin_ratio_between_healthy_chains(seed):
    """Why chip_smoke.py's chain twin rule takes CHAIN_VS_TWIN (16) and
    not the kernels' KERNEL_VS_PLAIN (4): two healthy f32 chains of the
    same algorithm, XLA-CPU's and the port's, with equal status and
    iterations on every date, sit at distances to the f64 chain that
    differ by more than 4x (measured at 8 dates, 40 x 80: XLA-CPU's
    11.2x the port's at seed 0, the port's 7.6x XLA-CPU's at seed 7;
    on the H100 at chip_smoke.py's size the card's plain path reached
    10.9x the largest of the kernel's and the CPU's on the grid's first
    lane at seed 7, scripts/torch_scan_drift.py), and within 16x."""
    Xs, ys = synthetic_universe_np(seed, 8, 40, 80)
    w_init = np.full(80, 1.0 / 80, np.float32)
    ref = np_of(jax_scan_l1(Xs, ys, w_init, JaxParams(**SCAN_PARAMS)))
    x64 = np.asarray(jax_scan_l1(Xs.astype(np.float64), ys.astype(np.float64),
                                 w_init.astype(np.float64),
                                 JaxParams(**SCAN_PARAMS)).x)
    prm = port_params(SCAN_PARAMS, backend="pallas")
    port = np_of(port_scan_l1(Xs, ys, w_init, prm))
    for k in ("status", "iters"):
        np.testing.assert_array_equal(port[k], ref[k])
    d_ref, d_port = (np.abs(x - x64).max() for x in (ref["x"], port["x"]))
    ratio = max(d_ref, d_port) / min(d_ref, d_port)
    assert chip_smoke.KERNEL_VS_PLAIN < ratio <= chip_smoke.CHAIN_VS_TWIN


# ---------------------------------------------------------------------
# solve_scan_l1_grid
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scan_l1_grid_matches_jax_and_per_column(dtype):
    """Three benchmark columns over one universe, four dates: the port's
    grid (one batch of 3 lanes per date) against JAX's
    ``solve_scan_l1_grid(mesh=None)``, and each lane against the port's
    own single-column scan of that column. Lane and column agree to
    rounding, not bit for bit: the batched matvecs of the residual
    check (``apply_P``'s einsum, ``C' y``) sum in another order for 3
    lanes than for 1, so rho adapts from residuals that differ in the
    last bits (ROADMAP section C)."""
    Xs, ys = tracking_inputs(dtype, n_dates=4, n_assets=12)
    Xs, Ys = grid_inputs(Xs, ys, 3)
    opts = dict(GRID_PARAMS, eps_abs=EPS[dtype], eps_rel=EPS[dtype])
    w_init = np.stack([np.full(12, 1.0 / 12), np.linspace(0, 2, 12) / 12,
                       np.eye(12)[0]])
    ref = jax_grid(Xs, Ys, w_init, JaxParams(**opts))
    prm = port_params(opts, backend="pallas")
    grid = tbatch.solve_scan_l1_grid(port_grid_qps(Xs, Ys), 12, w_init, TC,
                                     prm, universes=tbatch.FIXED_UNIVERSE,
                                     device="cpu")
    assert grid.x.shape == (3, 4, 12) and grid.status.shape == (3, 4)
    assert_same_chain(grid, ref, dtype)
    for b in range(3):
        col = port_scan_l1(Xs, Ys[b], w_init[b], prm)
        assert_same_chain(QPSolution(*(None if f is None else f[b]
                                       for f in grid)), col, dtype)


def test_scan_l1_grid_rejects_mesh_and_flat_batches():
    Xs, ys = tracking_inputs(np.float64, n_dates=2, n_assets=8)
    flat = port_qps(Xs, ys)
    with pytest.raises(ValueError, match="leading"):
        tbatch.solve_scan_l1_grid(flat, 8, np.zeros((1, 8)), TC,
                                  universes=tbatch.FIXED_UNIVERSE,
                                  device="cpu")
    grid = port_grid_qps(Xs, ys[None])
    # One column cannot split over two slots (the mesh itself is ported:
    # tests/test_torch_parallel.py).
    from porqua_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="divide evenly"):
        tbatch.solve_scan_l1_grid(grid, 8, np.zeros((1, 8)), TC,
                                  mesh=make_mesh(2, device="cpu"),
                                  universes=tbatch.FIXED_UNIVERSE)


# ---------------------------------------------------------------------
# solve_scan_turnover
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scan_turnover_matches_jax_and_serial_chain(dtype):
    """tests/test_batch_backtest.py::test_scan_turnover_matches_serial_chain
    in both packages: the port's scan against JAX's on the same lifted
    problems, and against the port's serial chain (each date re-lifted
    around the previous solution and solved alone)."""
    rng = np.random.default_rng(42)
    n, n_dates, budget = 6, 4, 0.3
    Ps, qs = [], []
    for _ in range(n_dates):
        X = rng.standard_normal((60, n)) * 0.01
        Ps.append(2 * X.T @ X + 1e-6 * np.eye(n))
        qs.append(-0.02 * rng.random(n))
    w_start = np.full(n, 1.0 / n)
    eps = 1e-5 if dtype == np.float32 else 1e-9
    opts = dict(eps_abs=eps, eps_rel=eps, max_iter=20000)
    tdt = torch.float32 if dtype == np.float32 else torch.float64

    x_prev, serial = w_start, []
    for d in range(n_dates):
        sol = pt.solve_qp(port_turnover_qp(Ps[d], qs[d], n, x_prev, budget,
                                           tdt), pt.SolverParams(**opts),
                          device="cpu")
        assert int(sol.status) == pt.Status.SOLVED
        x_prev = sol.x[:n].numpy()
        serial.append(x_prev)

    zeros = np.zeros(n)
    ref = jbatch.solve_scan_turnover(
        jax_stack_qps([jax_turnover_qp(Ps[d], qs[d], n, zeros, budget, dtype)
                       for d in range(n_dates)]),
        n_assets=n, row_start=1, w_init=jnp.asarray(w_start, dtype),
        params=JaxParams(**opts), universes=jbatch.FIXED_UNIVERSE)
    port = tbatch.solve_scan_turnover(
        pt.qp.canonical.stack_qps([port_turnover_qp(Ps[d], qs[d], n, zeros,
                                                    budget, tdt)
                                   for d in range(n_dates)]),
        n_assets=n, row_start=1, w_init=w_start, params=pt.SolverParams(**opts),
        universes=tbatch.FIXED_UNIVERSE, device="cpu")
    assert_same_chain(port, ref, dtype, n=n)
    atol = 1e-5 if dtype == np.float64 else 1e-4
    prev = w_start
    for d in range(n_dates):
        assert int(port.status[d]) == pt.Status.SOLVED
        w = port.x[d, :n].numpy()
        np.testing.assert_allclose(w, serial[d], atol=atol)
        assert np.abs(w - prev).sum() <= budget + 10 * eps
        prev = w


def test_usa_turnover_weights_fixed_only_to_the_conditioning():
    """examples/backtest_usa.py configuration 2 at full width (489
    admitted assets, 978 variables, f64, eps 1e-8), its first two
    dates, against the committed XLA-CPU golden: status equal, weights
    within 5e-4, the bound its own serial and scan engines are held to
    (tests/test_backtest_usa.py), and the turnover budget holds. Not
    within 1e-6: the ridge's modulus (2e-4) fixes the weights only to
    about the residual over it, and the port on the CPU, f64 as
    XLA-CPU, lands 4.0e-6 from it on date 0 after the same 600
    iterations, 2.1e-5 on date 1 after 500 against 550 (measured;
    ROADMAP section C)."""
    g = np.load(GOLDEN)
    X, V, bm, rebdates = usa_inputs(n_dates=2)
    w0 = usa_w_init(pt, tb, X, V, bm, rebdates, torch.float64)
    problems = tbatch.build_problems(
        usa_turnover_service(pt, tb, X, V, bm, rebdates, torch.float64, w0),
        dtype=torch.float64)
    n = len(problems.universes[0])
    w_init = np.array([w0[a] for a in problems.universes[0]])
    sol = tbatch.solve_scan_turnover(
        problems.qp, n_assets=n, row_start=1, w_init=w_init,
        params=pt.SolverParams(**USA_PARAMS), universes=problems.universes,
        device="cpu")
    assert n == int(g["usa_turnover/n_assets"])
    np.testing.assert_array_equal(sol.status.numpy(),
                                  g["usa_turnover/status"][:2])
    w = sol.x[:, :n].numpy()
    np.testing.assert_allclose(w, g["usa_turnover/x"][:2, :n], atol=5e-4,
                               rtol=0)
    spent = np.abs(w - np.vstack([w_init, w[:-1]])).sum(axis=1)
    assert np.all(spent <= USA_BUDGET + 1e-6)


# ---------------------------------------------------------------------
# The positional-carry precondition
# ---------------------------------------------------------------------

@pytest.mark.parametrize("universes", [None, "some-universe",
                                       [["a", "b"], ["b", "a"]]])
@pytest.mark.parametrize("entry", ["turnover", "l1", "grid"])
def test_require_fixed_universe_parity(entry, universes):
    """None, an unknown attestation and a varying universe raise in
    both packages, before any work."""
    for mod in (jbatch, tbatch):
        if entry == "turnover":
            call = lambda: mod.solve_scan_turnover(
                None, 2, 1, np.zeros(2), universes=universes)
        elif entry == "l1":
            call = lambda: mod.solve_scan_l1(None, 2, np.zeros(2), TC,
                                             universes=universes)
        else:
            call = lambda: mod.solve_scan_l1_grid(None, 2, np.zeros((1, 2)),
                                                  TC, universes=universes)
        with pytest.raises(ValueError, match="universe"):
            call()


# ---------------------------------------------------------------------
# The kernels' plain twins on the chain's own inputs
# ---------------------------------------------------------------------

def pallas_interpret(fn, args, kw):
    from porqua_tpu.ops import admm_kernel as jk
    import functools

    jfn = functools.partial(
        jk.admm_segment_factored if fn is tk.admm_segment_factored
        else jk.admm_segment, interpret=True, **kw)
    return jax.vmap(jfn)(*(jnp.asarray(a.numpy()) for a in args))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("config", ["woodbury", "trinv"])
def test_kernel_twin_with_l1_and_warm_carry(config, dtype):
    """The call date 2 of the chain makes (a nonzero scaled L1 weight
    and center, the warm x and y of date 1), and one segment on (so z,
    w and mu are nonzero too): the plain twin against the Pallas kernel
    in interpret mode, by the rule of tests/test_torch_admm_kernel.py."""
    from tests.test_torch_admm_kernel import assert_segment_close

    pt.qp.canonical.HP.apply()
    Xs, ys = tracking_inputs(dtype, n_dates=3)
    opts = SCAN_PARAMS if config == "woodbury" else GRID_PARAMS
    prm = port_params(opts, backend="pallas", eps_abs=1e-12, eps_rel=1e-12,
                      max_iter=opts.get("check_interval", 25))
    lanes = tbatch._lanes(port_qps(Xs, ys))
    w0 = torch.full((1, 16), 1.0 / 16, dtype=lanes.q.dtype)
    l1w = tbatch._l1_weight(16, 16, 0.01, lanes.q.dtype, "cpu")
    fn, args, kw = chip_smoke.scan_kernel_call(lanes, w0, l1w, prm, 2)
    l1w_s, l1c_s, x, z, w, y, mu = args[-7:]
    for v in (l1w_s, l1c_s, x, z, w, y):
        assert v.abs().max() > 0
    out = fn(*args, **kw)
    nxt = list(args)
    nxt[-5:] = out[:5]
    assert out[4].abs().max() > 0
    for call in (args, tuple(nxt)):
        port = tk.admm_segment_ref(*call, **kw) if fn is tk.admm_segment \
            else tk.admm_segment_factored_ref(*call, **kw)
        exact = None
        if dtype == np.float32:
            exact = pallas_interpret(fn, tuple(a.double() for a in call), kw)
        assert_segment_close(port, pallas_interpret(fn, call, kw), kw, exact)


# ---------------------------------------------------------------------
# The golden of chip_smoke.py's scan phases
# ---------------------------------------------------------------------

def usa_turnover_service(pkg, bld, X, V, bm, rebdates, dtype, w0=None):
    """examples/backtest_usa.py's configuration 2 in either package;
    ``w0`` (name -> weight) the pre-backtest holdings, which the
    turnover rows are built around (the scan then rewrites them)."""
    O = pkg.OptimizationItemBuilder
    return pkg.BacktestService(
        data={"return_series": X, "bm_series": bm, "volume_series": V},
        selection_item_builders={
            "volume": pkg.SelectionItemBuilder(
                bibfn=bld.bibfn_selection_min_volume, width=90,
                min_volume=1e6)},
        optimization_item_builders={
            "returns": O(bibfn=bld.bibfn_return_series, width=USA_WIDTH),
            "bm": O(bibfn=bld.bibfn_bm_series, width=USA_WIDTH, align=True),
            "budget": O(bibfn=bld.bibfn_budget_constraint),
            "box": O(bibfn=bld.bibfn_box_constraints, upper=USA_UPPER),
            "turnover": O(bibfn=bld.bibfn_turnover_constraint,
                          turnover_budget=USA_BUDGET)},
        optimization=pkg.LeastSquares(dtype=dtype, l2_penalty=1e-4),
        settings={"rebdates": rebdates, "quiet": True,
                  "prev_weights": dict(w0 or {})})


def usa_inputs(n_days=1500, n_assets=520, n_dates=None):
    X, V = synthetic_usa_np(n_days=n_days, n_assets=n_assets)
    rebdates = usa_rebdates(X.index)
    return X, V, usa_benchmark_np(X), rebdates[:n_dates]


def usa_w_init(pkg, bld, X, V, bm, rebdates, dtype):
    """Equal weight over the set the filter admits on the first date
    (name -> weight)."""
    probe = usa_turnover_service(pkg, bld, X, V, bm, rebdates, dtype)
    probe.prepare_rebalancing(rebalancing_date=rebdates[0])
    universe = list(probe.optimization.constraints.selection)
    return {a: 1.0 / len(universe) for a in universe}


def write_golden(path=GOLDEN, sizes=FULL, usa=dict(n_days=1500,
                                                    n_assets=520)):
    """Run the JAX package on XLA-CPU for chip_smoke.py's scan phases
    (backend "auto" with the phase's linsolve: the algorithm the kernel
    computes) and save what the checks read."""
    s = sizes
    out = {"meta": json.dumps(dict(s, tc=TC, usa=usa,
                                   platform=jax.default_backend()))}
    Xs, ys = synthetic_universe_np(s["seed"], s["n_dates"], s["window"],
                                   s["n_assets"])
    n = s["n_assets"]
    w_init = np.full(n, 1.0 / n, np.float32)

    t0 = time.perf_counter()
    sol = jax_scan_l1(Xs, ys, w_init, JaxParams(**SCAN_PARAMS))
    out["scan_l1/params"] = json.dumps(dataclasses.asdict(
        JaxParams(**SCAN_PARAMS)))
    for k, v in np_of(sol).items():
        out[f"scan_l1/{k}"] = v
    # The chain's f64 twin (the same inputs in f64): the f32 chain drifts
    # from it along the dates, and the card's chain is held by how far
    # XLA-CPU's f32 chain drifts (stored in f32: rounding 1e-9 of it).
    f64 = np.float64
    sol = jax_scan_l1(Xs.astype(f64), ys.astype(f64), w_init.astype(f64),
                      JaxParams(**SCAN_PARAMS))
    out["scan_l1/x_f64"] = np.asarray(sol.x, np.float32)
    print(f"scan_l1: {time.perf_counter() - t0:.1f} s, solved "
          f"{int((out['scan_l1/status'] == 1).sum())}, iters "
          f"{sorted(set(out['scan_l1/iters'].tolist()))}", flush=True)

    t0 = time.perf_counter()
    _, Ys = grid_inputs(Xs, ys, s["n_columns"])
    sol = jax_grid(Xs, Ys, np.tile(w_init, (s["n_columns"], 1)),
                   JaxParams(**GRID_PARAMS))
    out["scan_l1_grid/params"] = json.dumps(dataclasses.asdict(
        JaxParams(**GRID_PARAMS)))
    for k, v in np_of(sol).items():
        out[f"scan_l1_grid/{k}"] = v
    # The grid's f64 twin, with the linsolve that "auto" picks in f32
    # (f64 "auto" picks chol on the CPU).
    sol = jax_grid(Xs.astype(f64), Ys.astype(f64),
                   np.tile(w_init, (s["n_columns"], 1)).astype(f64),
                   JaxParams(**dict(GRID_PARAMS, linsolve="trinv")))
    out["scan_l1_grid/x_f64"] = np.asarray(sol.x, np.float32)
    print(f"scan_l1_grid: {time.perf_counter() - t0:.1f} s, solved "
          f"{int((out['scan_l1_grid/status'] == 1).sum())}, iters "
          f"{sorted(set(out['scan_l1_grid/iters'].ravel().tolist()))}",
          flush=True)

    t0 = time.perf_counter()
    X, V, bm, rebdates = usa_inputs(usa["n_days"], usa["n_assets"],
                                    s["usa_dates"])
    import porqua_tpu as rj

    w0 = usa_w_init(rj, jb, X, V, bm, rebdates, jnp.float64)
    problems = jbatch.build_problems(
        usa_turnover_service(rj, jb, X, V, bm, rebdates, jnp.float64, w0),
        dtype=jnp.float64)
    w_init = np.array([w0[a] for a in problems.universes[0]])
    sol = jbatch.solve_scan_turnover(
        problems.qp, n_assets=len(problems.universes[0]), row_start=1,
        w_init=jnp.asarray(w_init), params=JaxParams(**USA_PARAMS),
        universes=problems.universes)
    out["usa_turnover/params"] = json.dumps(dataclasses.asdict(
        JaxParams(**USA_PARAMS)))
    for k, v in np_of(sol).items():
        out[f"usa_turnover/{k}"] = v
    out["usa_turnover/n_assets"] = np.asarray(len(problems.universes[0]))
    print(f"usa_turnover: {time.perf_counter() - t0:.1f} s, "
          f"{len(rebdates)} dates, n {problems.qp.q.shape[-1]}, m "
          f"{problems.qp.l.shape[-1]}, solved "
          f"{int((out['usa_turnover/status'] == 1).sum())}, iters "
          f"{sorted(set(out['usa_turnover/iters'].tolist()))}", flush=True)
    np.savez_compressed(path, **out)


def test_write_golden_mode_at_a_small_size(tmp_path):
    """The --write-golden mode end to end at a tiny size: every phase's
    arrays, with the shapes and dtypes chip_smoke.py reads."""
    path = str(tmp_path / "g.npz")
    write_golden(path, dict(seed=1, n_dates=3, window=30, n_assets=10,
                            n_columns=2, usa_dates=2),
                 usa=dict(n_days=400, n_assets=24))
    g = np.load(path)
    meta = json.loads(str(g["meta"]))
    assert meta["n_columns"] == 2 and meta["tc"] == TC
    assert g["scan_l1/x"].shape == (3, 10)
    assert g["scan_l1/x"].dtype == np.float32
    assert g["scan_l1_grid/x"].shape == (2, 3, 10)
    assert g["scan_l1/x_f64"].shape == (3, 10)
    assert g["scan_l1_grid/x_f64"].shape == (2, 3, 10)
    assert g["scan_l1/y"].shape == (3, 1)
    assert g["usa_turnover/x"].dtype == np.float64
    assert g["usa_turnover/status"].shape == (2,)
    for phase in ("scan_l1", "scan_l1_grid", "usa_turnover"):
        assert set(json.loads(str(g[f"{phase}/params"]))) == set(
            dataclasses.asdict(pt.SolverParams()))


def test_committed_golden_shapes():
    g = np.load(GOLDEN)
    meta = json.loads(str(g["meta"]))
    T, n, B = meta["n_dates"], meta["n_assets"], meta["n_columns"]
    assert g["scan_l1/x"].shape == (T, n)
    assert g["scan_l1_grid/x"].shape == (B, T, n)
    assert (g["scan_l1/status"] == 1).all()
    assert (g["scan_l1_grid/status"] == 1).all()
    assert (g["usa_turnover/status"] == 1).all()


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: python tests/test_torch_scan.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    write_golden()
    print(f"wrote {GOLDEN} in {time.perf_counter() - t0:.1f} s")
