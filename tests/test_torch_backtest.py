"""The port's backtest engines against the JAX package's, on the same
pandas frames, and the committed JAX golden of the USA example that
``chip_smoke.py`` holds the card against.

Regenerate the golden (XLA-CPU, f32, about a minute):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_backtest.py --write-golden
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch

import porqua_tpu as rj
from porqua_tpu import builders as jb
from porqua_tpu.accounting import performance_summary as jax_perf
from porqua_tpu.accounting import simulate_strategy as jax_simulate
from porqua_tpu.batch import build_problems as jax_build_problems
from porqua_tpu.batch import run_batch as jax_run_batch
from porqua_tpu.batch import solve_batch as jax_solve_batch
from porqua_tpu.qp import SolverParams as JaxParams

import porqua_tpu_torch as pt
from porqua_tpu_torch import batch as tbatch
from porqua_tpu_torch import builders as tb
from porqua_tpu_torch.accounting import performance_summary, simulate_strategy
from porqua_tpu_torch.convert import batch_from_numpy
from porqua_tpu_torch.synthetic import (
    synthetic_usa_np,
    usa_benchmark_np,
    usa_rebdates,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                      "backtest_usa_golden.npz")

# examples/backtest_usa.py, configuration 1: the library-default polish,
# loose in-loop tolerance, f32. usa_trinv reaches the triangular-inverse
# kernel (linsolve auto -> trinv in f32), usa_woodbury the factored one
# at refine 1.
USA_BASE = dict(eps_abs=1e-3, eps_rel=1e-3)
USA_CONFIGS = {
    "usa_trinv": dict(linsolve="auto"),
    "usa_woodbury": dict(linsolve="woodbury"),
}
USA_WIDTH, USA_UPPER = 252, 0.05
# Weights and TE against the JAX package on the CPU: f64 to rounding,
# f32 within the port's f32 weight tolerance (tests/test_torch_tracking.py).
W_TOL = {np.float32: 5e-5, np.float64: 1e-9}


def usa_params(name, **over):
    return dict(USA_BASE, **USA_CONFIGS[name], **over)


def service(pkg, bld, data, rebdates, optimization, width, upper=1.0):
    """The example's BacktestService in either package."""
    return pkg.BacktestService(
        data=data,
        selection_item_builders={
            "data": pkg.SelectionItemBuilder(bibfn=bld.bibfn_selection_data),
        },
        optimization_item_builders={
            "returns": pkg.OptimizationItemBuilder(
                bibfn=bld.bibfn_return_series, width=width),
            "bm": pkg.OptimizationItemBuilder(
                bibfn=bld.bibfn_bm_series, width=width, align=True),
            "budget": pkg.OptimizationItemBuilder(
                bibfn=bld.bibfn_budget_constraint),
            "box": pkg.OptimizationItemBuilder(
                bibfn=bld.bibfn_box_constraints, upper=upper),
        },
        optimization=optimization,
        settings={"rebdates": rebdates, "quiet": True},
    )


def usa_inputs(n_dates=None):
    X, _ = synthetic_usa_np()
    bm = usa_benchmark_np(X)
    rebdates = usa_rebdates(X.index)
    return X, bm, rebdates if n_dates is None else rebdates[:n_dates]


def weights_of(bt, columns):
    return bt.strategy.get_weights_df().reindex(columns=columns).to_numpy(float)


def jax_usa_run(X, bm, rebdates, params, dtype=jnp.float32):
    """status, iters, weights, polish-accepted mask and the simulated
    tracking error of the JAX package's run_batch, and the weights of
    the same run with polish off. A date's polish was accepted where
    its weights differ from the run with polish off (a rejected polish
    returns the ADMM iterate unchanged)."""
    data = {"return_series": X, "bm_series": bm}
    runs = {}
    for polish in (True, False):
        bs = service(rj, jb, data, rebdates, rj.LeastSquares(), USA_WIDTH,
                     USA_UPPER)
        runs[polish] = jax_run_batch(
            bs, JaxParams(**{**params, "polish": polish}), dtype=dtype)
    bt = runs[True]
    te = jax_perf(jax_simulate(bt.strategy, X, fc=0.0, vc=0.001),
                  benchmark=bm.iloc[:, 0])["tracking_error"]
    w = weights_of(bt, X.columns)
    w_iterate = weights_of(runs[False], X.columns)
    return {"status": bt.output["batch"]["status"],
            "iters": bt.output["batch"]["iters"],
            "weights": w,
            "weights_nopolish": w_iterate,
            "polish_accepted": np.any(w != w_iterate, axis=1),
            "tracking_error": np.float64(te)}


def test_synthetic_usa_equals_the_example():
    """The port's copy of the example's market draws the same frames,
    value for value."""
    spec = importlib.util.spec_from_file_location(
        "backtest_usa_example", os.path.join(_ROOT, "examples",
                                             "backtest_usa.py"))
    sys.path.insert(0, os.path.join(_ROOT, "examples"))
    try:
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
    finally:
        sys.path.remove(os.path.join(_ROOT, "examples"))
    Xe, Ve = example.synthetic_usa()
    X, V = synthetic_usa_np()
    pd.testing.assert_frame_equal(X, Xe, check_exact=True)
    pd.testing.assert_frame_equal(V, Ve, check_exact=True)
    w = np.random.default_rng(0).dirichlet(np.ones(X.shape[1]) * 5.0)
    np.testing.assert_array_equal(usa_benchmark_np(X)["SPTR"].to_numpy(),
                                  X.to_numpy() @ w)
    me = pd.Series(index=X.index, data=1).resample("ME").last().index
    assert usa_rebdates(X.index) == [
        str(X.index[X.index <= d][-1].date()) for d in me][13:-1]
    assert len(usa_rebdates(X.index)) == 55


def port_usa_run(X, bm, rebdates, params, dtype=torch.float32):
    """The port's run_batch on the CPU (backend "pallas": the kernels'
    plain twins): status, iters, weights and the polish-accepted mask,
    derived as in :func:`jax_usa_run`."""
    data = {"return_series": X, "bm_series": bm}
    w = {}
    for polish in (True, False):
        bs = service(pt, tb, data, rebdates, pt.LeastSquares(), USA_WIDTH,
                     USA_UPPER)
        prm = pt.SolverParams(**{**params, "polish": polish,
                                 "backend": "pallas"})
        bt = pt.run_batch(bs, prm, dtype=dtype, device="cpu")
        w[polish] = weights_of(bt, X.columns)
        if polish:
            out = dict(bt.output["batch"])
    out.update(weights=w[True], weights_nopolish=w[False],
               polish_accepted=np.any(w[True] != w[False], axis=1))
    return out


def twin_rule(got, golden, ref64, iters):
    """chip_smoke.py's rule for the backtest's f32 weights: per date,
    at most 4x as far from the f64 answer as the golden's f32 weights,
    plus two f32 ulps of the box bound per iteration."""
    floor = 2 * iters * 2.0 ** -23 * USA_UPPER
    d_got = np.abs(got - ref64).max(axis=1)
    d_gold = np.abs(golden - ref64).max(axis=1)
    assert np.all(d_got <= 4 * d_gold + floor), (d_got, d_gold)


@pytest.mark.parametrize("name", sorted(USA_CONFIGS))
def test_golden_first_dates(name):
    """The committed golden's first 4 dates against a fresh JAX run on
    those dates (the same XLA path, f32 and f64) and against the port on
    the CPU with the kernels' plain twins: status, iterations and the
    polish-accepted mask equal; the port's f32 weights by the twin rule
    against the f64 iterate (the optimum is a face, see
    test_usa_polish_lands_in_f64_only)."""
    golden = np.load(GOLDEN)
    X, bm, rebdates = usa_inputs(4)
    params = json.loads(str(golden[f"{name}/params"]))
    for suffix, dtype in (("", jnp.float32), ("_f64", jnp.float64)):
        fresh = jax_usa_run(X, bm, rebdates, params, dtype)
        for k in ("status", "iters", "polish_accepted"):
            np.testing.assert_array_equal(
                fresh[k], golden[f"{name}/{k}{suffix}"][:4], err_msg=k)
        np.testing.assert_allclose(
            fresh["weights"], golden[f"{name}/weights{suffix}"][:4],
            atol=1e-6 if suffix == "" else 1e-12, rtol=0)
    mine = port_usa_run(X, bm, rebdates, params)
    for k in ("status", "iters", "polish_accepted"):
        np.testing.assert_array_equal(mine[k], golden[f"{name}/{k}"][:4],
                                      err_msg=k)
    twin_rule(mine["weights_nopolish"], golden[f"{name}/weights_nopolish"][:4],
              golden[f"{name}/weights_nopolish_f64"][:4],
              int(golden[f"{name}/iters"].max()))


def test_usa_polish_lands_in_f64_only():
    """ROADMAP section C: at the USA example's shape the benchmark is a
    portfolio of the universe and the window (252) is shorter than the
    universe (520), so each date's optimum is a face of exact
    replication. The f32 polish there is at the edge of its accuracy:
    the JAX package (XLA-CPU) and the port on the CPU reject it on every
    date, the H100 accepts it on about half (PERF.md), and the f64 twin
    accepts it on every date. Here on 4 dates: the port's f32 polish is
    rejected where the golden's is, and its f64 polish lands where the
    JAX package's f64 polish does."""
    golden = np.load(GOLDEN)
    X, bm, rebdates = usa_inputs(4)
    params = json.loads(str(golden["usa_trinv/params"]))
    f32 = port_usa_run(X, bm, rebdates, params)
    assert not f32["polish_accepted"].any()
    assert not golden["usa_trinv/polish_accepted"].any()
    f64 = port_usa_run(X, bm, rebdates, params, dtype=torch.float64)
    assert f64["polish_accepted"].all()
    assert golden["usa_trinv/polish_accepted_f64"].all()
    np.testing.assert_allclose(f64["weights"],
                               golden["usa_trinv/weights_f64"][:4],
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------
# Engines on a small market (tests/test_batch_backtest.py's make_market)
# ---------------------------------------------------------------------

def make_market(rng, n_assets=8, n_days=400):
    dates = pd.bdate_range("2020-01-01", periods=n_days)
    X = pd.DataFrame(rng.standard_normal((n_days, n_assets)) * 0.01,
                     index=dates, columns=[f"A{i}" for i in range(n_assets)])
    w_true = rng.dirichlet(np.ones(n_assets))
    y = pd.DataFrame(
        {"bm": X.to_numpy() @ w_true + rng.standard_normal(n_days) * 0.001},
        index=dates)
    return {"return_series": X, "bm_series": y}


def rebdates_of(data, k=4, every=30):
    idx = data["return_series"].index
    return [str(d.date()) for d in idx[150::every][:k]]


STRATEGIES = {
    "LeastSquares": lambda pkg, **kw: pkg.LeastSquares(**kw),
    "MeanVariance": lambda pkg, **kw: pkg.MeanVariance(**kw),
    "WeightedLeastSquares": lambda pkg, **kw: pkg.WeightedLeastSquares(
        tau=60, **kw),
    "QEQW": lambda pkg, **kw: pkg.QEQW(**kw),
}
TIGHT = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_run_batch_matches_jax(name, dtype, rng):
    """run_batch through both packages on the same frames, with the
    default (polish on) params at a tolerance the dtype can reach:
    status and iterations equal, weights within W_TOL."""
    data = make_market(rng)
    rebdates = rebdates_of(data)
    eps = 1e-8 if dtype == np.float64 else 1e-4
    params = dict(eps_abs=eps, eps_rel=eps, max_iter=20000)
    jbs = service(rj, jb, data, rebdates, STRATEGIES[name](rj), 120)
    ref = jax_run_batch(jbs, JaxParams(**params), dtype=dtype)
    tbs = service(pt, tb, data, rebdates, STRATEGIES[name](pt), 120)
    got = pt.run_batch(tbs, pt.SolverParams(**params), dtype=dtype,
                       device="cpu")
    for k in ("status", "iters"):
        np.testing.assert_array_equal(got.output["batch"][k],
                                      ref.output["batch"][k], err_msg=k)
    cols = data["return_series"].columns
    np.testing.assert_allclose(weights_of(got, cols), weights_of(ref, cols),
                               atol=W_TOL[dtype], rtol=0)


@pytest.mark.parametrize("name", ["LeastSquares", "MeanVariance"])
def test_serial_backtest_matches_own_run_batch(name, rng):
    """The port's serial Backtest.run against its own run_batch, as the
    JAX package's test_batch_backtest does for the reference (f64,
    tight eps: the two engines agree to solver tolerance)."""
    data = make_market(rng)
    rebdates = rebdates_of(data)
    kw = dict(dtype=np.float64, **TIGHT)
    serial_bs = service(pt, tb, data, rebdates, STRATEGIES[name](pt, **kw), 120)
    serial = pt.Backtest()
    serial.run(serial_bs, device="cpu")
    batch_bs = service(pt, tb, data, rebdates, STRATEGIES[name](pt, **kw), 120)
    batched = pt.run_batch(batch_bs, pt.SolverParams(**TIGHT),
                           dtype=torch.float64, device="cpu")
    assert np.all(batched.output["batch"]["status"] == pt.Status.SOLVED)
    for date in rebdates:
        ws = pd.Series(serial.strategy.get_weights(date))
        wb = pd.Series(batched.strategy.get_weights(date))
        np.testing.assert_allclose(wb[ws.index], ws, atol=5e-6)


def test_batch_problems_carry_over_from_jax(rng):
    """convert.batch_from_numpy hands both solvers the JAX package's
    stacked problem; the port's solve_batch then matches its
    solve_batch (f64)."""
    data = make_market(rng)
    rebdates = rebdates_of(data)
    bs = service(rj, jb, data, rebdates, rj.LeastSquares(), 120)
    problems = jax_build_problems(bs, dtype=jnp.float64)
    params = JaxParams(**TIGHT)
    ref = jax_solve_batch(problems, params)
    mine = batch_from_numpy(
        {k: np.asarray(v) for k, v in problems.qp._asdict().items()
         if v is not None},
        rebdates=problems.rebdates, universes=problems.universes,
        n_assets_max=problems.n_assets_max, constants=problems.constants)
    assert mine.n_dates == len(rebdates) and mine.qp.Pf is not None
    sol = tbatch.solve_batch(mine, pt.SolverParams(**TIGHT), device="cpu")
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), atol=1e-9)
    with pytest.raises(TypeError, match="rebdate"):
        batch_from_numpy(
            {k: np.asarray(v) for k, v in problems.qp._asdict().items()
             if v is not None}, rebdate=[], universes=[], n_assets_max=0)


# ---------------------------------------------------------------------
# Lowering: canonical_parts of every strategy, exactly the reference's
# ---------------------------------------------------------------------

def _lowering_cases():
    tc = dict(transaction_cost=0.002, x0={"A0": 0.5, "A3": 0.5})
    return {
        "LeastSquares": ("LeastSquares", {}, None),
        "LeastSquares_l2": ("LeastSquares", dict(l2_penalty=1e-3), None),
        "LeastSquares_tc_lift": ("LeastSquares", tc, None),
        "LeastSquares_tc_native": ("LeastSquares", dict(tc, l1_native=True), None),
        "LeastSquares_turnover": ("LeastSquares", {}, "turnover"),
        "LeastSquares_leverage": ("LeastSquares", {}, "leverage"),
        "MeanVariance": ("MeanVariance", {}, None),
        "WeightedLeastSquares": ("WeightedLeastSquares", {}, None),
        "QEQW": ("QEQW", {}, None),
        "LAD_prox": ("LAD", {}, None),
        "LAD_epigraph": ("LAD", dict(prox_form=False), None),
        "LAD_leverage": ("LAD", {}, "leverage"),
    }


def _lowered(pkg, strategy, kwargs, extra, data):
    opt = {"LeastSquares": pkg.LeastSquares, "MeanVariance": pkg.MeanVariance,
           "WeightedLeastSquares": lambda **k: pkg.WeightedLeastSquares(
               tau=30, **k),
           "QEQW": pkg.QEQW, "LAD": pkg.LAD}[strategy](**kwargs)
    cols = list(data["return_series"].columns)
    opt.constraints = pkg.Constraints(selection=cols)
    opt.constraints.add_budget()
    opt.constraints.add_box("LongOnly", upper=0.4)
    if extra == "turnover":
        opt.constraints.add_l1("turnover", rhs=0.3,
                               x0={a: 1.0 / len(cols) for a in cols})
    if extra == "leverage":
        opt.constraints.add_l1("leverage", rhs=1.5)
    od = pkg.OptimizationData(
        align=False, return_series=data["return_series"].iloc[-60:],
        bm_series=data["bm_series"].iloc[-60:, 0])
    opt.set_objective(od)
    return opt.canonical_parts(), opt.solver_params()


@pytest.mark.parametrize("case", sorted(_lowering_cases()))
def test_canonical_parts_equal_the_reference(case, rng):
    """Every part bit for bit (MeanVariance's q to one f64 ulp), and the
    resolved solver params equal."""
    strategy, kwargs, extra = _lowering_cases()[case]
    data = make_market(rng, n_assets=6)
    ref, ref_params = _lowered(rj, strategy, kwargs, extra, data)
    got, got_params = _lowered(pt, strategy, kwargs, extra, data)
    assert sorted(got) == sorted(ref)
    for k in ref:
        if strategy == "MeanVariance" and k == "q":
            # The expected returns go through log1p and exp, which XLA
            # and torch round differently in the last bit.
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-15)
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    assert dataclasses.asdict(got_params) == dataclasses.asdict(ref_params)


# ---------------------------------------------------------------------
# Options that raised until their slice was ported now run; what needs
# the card raises without one
# ---------------------------------------------------------------------

def _small_problems(rng):
    data = make_market(rng)
    return tbatch.build_problems(
        service(pt, tb, data, rebdates_of(data, k=2), pt.LeastSquares(), 120))


@pytest.mark.parametrize("call", [
    "scan_grid_mesh", "scan_checkpoint_harvest", "retry_policy",
    "solve_batch_compacted", "harvest", "sanitize", "named_backend",
    "ltr_builder",
])
def test_unported_options_raise(call, rng, monkeypatch, tmp_path):
    if call == "scan_grid_mesh":
        # Ported since the device mesh (parallel/mesh.py): the grid
        # through a one-slot mesh is the unsharded grid, bit for bit
        # (tests/test_torch_parallel.py holds wider meshes to JAX's).
        from porqua_tpu_torch.parallel import make_mesh

        grid = tbatch._lanes(_small_problems(rng).qp)
        n = grid.q.shape[-1]
        args = (grid, n, np.zeros((1, n)), 0.01)
        meshed = tbatch.solve_scan_l1_grid(
            *args, mesh=make_mesh(1, device="cpu"),
            universes=tbatch.FIXED_UNIVERSE)
        plain = tbatch.solve_scan_l1_grid(
            *args, universes=tbatch.FIXED_UNIVERSE, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(meshed, plain)
                   if a is not None)
        return
    elif call in ("scan_checkpoint_harvest", "solve_batch_compacted",
                  "harvest"):
        # Ported since the telemetry warehouse (obs/harvest.py): the
        # sink gets one record per date, labelled with the device
        # (tests/test_torch_harvest.py holds them to the JAX package's).
        from porqua_tpu_torch.checkpoint import solve_scan_l1_checkpointed
        from porqua_tpu_torch.obs import HarvestSink

        sink, problems = HarvestSink(None), _small_problems(rng)
        if call == "scan_checkpoint_harvest":
            qp = problems.qp
            solve_scan_l1_checkpointed(
                qp, qp.n, np.full(qp.n, 1.0 / qp.n), 0.01,
                str(tmp_path / "ck"), harvest=sink,
                universes=tbatch.FIXED_UNIVERSE, device="cpu")
        elif call == "solve_batch_compacted":
            tbatch.solve_batch_compacted(problems, harvest=sink,
                                         device="cpu")
        else:
            tbatch.solve_batch(problems, harvest=sink, device="cpu")
        records = sink.buffered()
        assert len(records) == len(problems.rebdates)
        assert {r["device"] for r in records} == {"cpu:0"}
        return
    elif call == "retry_policy":
        # Ported since the retry layer (resilience/retry.py).
        import porqua_tpu_torch.resilience as res

        assert res.RetryPolicy().max_attempts == 3
        return
    elif call == "sanitize":
        # Ported since the transfer guard (analysis/sanitize.py): the
        # guarded solve answers the unguarded solve's bits
        # (tests/test_torch_analysis.py seeds the violations it catches).
        problems = _small_problems(rng)
        plain = tbatch.solve_batch(problems, device="cpu")
        monkeypatch.setenv("PORQUA_SANITIZE", "1")
        guarded = tbatch.solve_batch(problems, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(guarded, plain)
                   if a is not None)
        return
    elif call == "named_backend":
        # Ported since the cross-solver harness (compare.py): a named
        # solver no longer raises; the serial backtest solves each date
        # through the f64 IPM and publishes budget-feasible weights.
        data = make_market(rng)
        bs = service(pt, tb, data, rebdates_of(data, k=1),
                     pt.LeastSquares(solver_name="ipm"), 120)
        bt = pt.Backtest()
        bt.run(bs, device="cpu")
        assert bs.optimization.results["status"] is True
        w = np.array(list(bt.strategy.portfolios[-1].weights.values()),
                     float)
        assert np.isfinite(w).all() and abs(w.sum() - 1.0) < 1e-9
        return
    elif call == "ltr_builder":
        # Ported since the ML selection models (models/ltr.py): an LTR
        # selection item on this market, with chip_smoke.usa_features'
        # panel, scores every asset and selects top_k of them.
        import chip_smoke

        data = make_market(rng)
        data["features"] = chip_smoke.usa_features(data["return_series"])
        bs = service(pt, tb, data, rebdates_of(data, k=5)[-1:],
                     pt.LeastSquares(), 120)
        bs.selection_item_builders["ltr"] = pt.SelectionItemBuilder(
            bibfn=tb.bibfn_selection_ltr, top_k=3, epochs=5, device="cpu")
        bs.build_selection(bs.settings["rebdates"][0])
        out = bs.selection.filtered["ltr"]
        assert list(out.columns) == ["values", "binary"]
        assert int(out["binary"].sum()) == 3
        assert np.isfinite(out["values"]).all()
        assert len(bs.selection.selected) == 3
        return
    raise AssertionError(f"unknown call {call!r}")


def test_entry_points_need_a_device_without_cuda(rng, monkeypatch):
    """No silent CPU fallback for the backtest entry points."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_market(rng)
    rebdates = rebdates_of(data, k=1)
    bs = service(pt, tb, data, rebdates, pt.LeastSquares(), 120)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.run_batch(bs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Backtest().run(bs)
    bs.prepare_rebalancing(rebdates[0])
    bs.optimization.set_objective(bs.optimization_data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bs.optimization.solve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_strategy(pt.Strategy([]), data["return_series"])


def test_as_requests_and_fixed_universe(rng):
    problems = _small_problems(rng)
    reqs = tbatch.as_requests(problems)
    assert len(reqs) == 2 and reqs[1].q.shape == problems.qp.q.shape[1:]
    torch.testing.assert_close(reqs[1].P, problems.qp.P[1])
    tbatch._require_fixed_universe(tbatch.FIXED_UNIVERSE)
    with pytest.raises(ValueError):
        tbatch._require_fixed_universe(None)
    with pytest.raises(ValueError):
        tbatch._require_fixed_universe([["a", "b"], ["b", "a"]])


def write_golden(path=GOLDEN):
    """Run the JAX package's run_batch (backend "xla", XLA-CPU) on the
    example's configuration 1 for every config, in f32 (what the card is
    held to) and in f64 (its twin: which side of an f32 difference is
    nearer the answer), and save both."""
    X, bm, rebdates = usa_inputs()
    out = {"meta": json.dumps(dict(
        n_days=X.shape[0], n_assets=X.shape[1], n_dates=len(rebdates),
        width=USA_WIDTH, upper=USA_UPPER, platform=jax.default_backend()))}
    for name in USA_CONFIGS:
        params = usa_params(name, backend="xla")
        out[f"{name}/params"] = json.dumps(
            dataclasses.asdict(JaxParams(**params)))
        for suffix, dtype in (("", jnp.float32), ("_f64", jnp.float64)):
            res = jax_usa_run(X, bm, rebdates, params, dtype)
            for k, v in res.items():
                out[f"{name}/{k}{suffix}"] = v
            print(name + suffix, "solved", int((res["status"] == 1).sum()),
                  "iters", sorted(set(res["iters"].tolist())),
                  "polish accepted", int(res["polish_accepted"].sum()),
                  "TE", float(res["tracking_error"]))
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: python tests/test_torch_backtest.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_golden()
