"""The port's examples (``porqua_tpu_torch/examples/``) against the JAX
package's ``examples/*.py`` on the CPU.

Whole examples run here only at a small cut (fewer rebalance dates,
fewer optimizer steps, a shorter tail), against the numbers of the JAX
example at the same cut or at full size where the cut is a prefix of
the full run (a tuning loop's first steps, a date chain's first
dates), read from ``porqua_tpu_torch/testdata/examples_golden.npz``
(``scripts/torch_examples_golden.py``, XLA-CPU). The examples' own
building blocks are imported from ``examples/`` by path and compared
with the port's on the same numpy inputs. Every example runs f64 where
the JAX example asks for ``jnp.float64`` (the JAX side runs under the
suite's ``jax_enable_x64``) and f32 where it does not.

Tolerances: F64_ATOL for quantities both packages compute in f64 with
the same algorithm (the runs agree to 1e-13 or closer on the CPU);
f32 weights by the backtests' twin rule; fits within chip_smoke's
ML_OPT_ATOL; gradients of f64 solves at eps 1e-9 or 1e-10 within
GRAD_RTOL.
"""

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from porqua_tpu_torch.examples import EXAMPLES
from porqua_tpu_torch.examples import (backtest_usa, compare_solver,
                                       cost_aware_backtest,
                                       cost_penalty_tuning,
                                       differentiable_tuning,
                                       index_replication, lstm_selection,
                                       ml_prediction, net_sharpe_tuning,
                                       ordinal_regression, quickstart)
from porqua_tpu_torch.examples._common import unpack_golden
from porqua_tpu_torch.synthetic import (synthetic_usa_np, usa_benchmark_np,
                                        usa_rebdates)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                      "examples_golden.npz")
USA_GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                          "backtest_usa_golden.npz")
F64_ATOL = 1e-9
GRAD_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def golden(name, cut):
    return unpack_golden(np.load(GOLDEN), f"{name}/{cut}")


def jax_example(name):
    """The JAX package's example module, imported by path (its
    ``init_platform`` pins the CPU and x64, as tests/conftest.py does)."""
    examples = os.path.join(_ROOT, "examples")
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(examples, f"{name}.py"))
    sys.path.insert(0, examples)
    try:
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(examples)
    return module


def same_builders(mine, theirs):
    """Item builders of the two packages: the same keys, functions of
    the same name, the same keyword arguments."""
    assert list(mine) == list(theirs)
    for key in mine:
        a, b = dict(mine[key].arguments), dict(theirs[key].arguments)
        assert a.pop("bibfn").__name__ == b.pop("bibfn").__name__, key
        assert a == b, key


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def assert_close(got, want, keys, atol=F64_ATOL, rtol=0.0):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float), atol=atol,
                                   rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# every example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_unless_a_device_is_named(name, monkeypatch):
    """Without a card and without ``device`` an example's ``main``
    raises before it does any work (no silent CPU fallback)."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"porqua_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()


def test_runner_reports_each_example_and_fails_on_unknown(capsys):
    """``python -m porqua_tpu_torch.examples``: one status line per
    example, exit 0 when all pass, a usage error for an unknown name."""
    from porqua_tpu_torch.examples.__main__ import main

    assert main(["--device", "cpu", "ordinal_regression"]) == 0
    out = capsys.readouterr().out
    assert "ok   ordinal_regression" in out and "1/1 examples passed" in out
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "no_such_example"])


# ---------------------------------------------------------------------------
# the backtest examples
# ---------------------------------------------------------------------------

def test_quickstart_small_cut_matches_jax():
    """Three quarterly dates: the four strategies' weights per date,
    cumulative returns, the batched engine and the quintile portfolios
    equal the JAX example's at the same cut (f64); per-date turnover by
    chip_smoke.turnover_held (dates whose previous weights hold no
    negative entry in either run: a weight that is zero to rounding may
    come out -1e-24 in one run, which sends the reference's drift
    through its long/short rescaling, kept for parity)."""
    out = quiet(quickstart.main, "cpu", n_rebdates=3)
    ref = golden("quickstart", "small")
    assert out["rebdates"] == ref["rebdates"]
    keys = [k for k in ref if k != "rebdates" and "turnover" not in k]
    assert_close(out, ref, keys)
    ok, held, _ = chip_smoke.turnover_held(out, ref, F64_ATOL)
    assert ok and held >= 4  # every strategy's first date at least


def test_quickstart_service_is_the_examples():
    """The port's service has the JAX example's builders and settings."""
    ex = jax_example("quickstart")
    data = quiet(quickstart.load_msci_or_synthetic)
    mine = quickstart.make_service(data, ["2018-03-30"], None)
    theirs = ex.make_service(ex.load_msci_or_synthetic(), ["2018-03-30"],
                             None)
    for kind in ("selection_item_builders", "optimization_item_builders"):
        same_builders(getattr(mine, kind), getattr(theirs, kind))
    assert mine.settings == theirs.settings
    np.testing.assert_array_equal(mine.data["return_series"].to_numpy(),
                                  theirs.data["return_series"].to_numpy())


def test_index_replication_small_cut_matches_jax():
    """Four monthly dates in log space (f64): status, iterations,
    weights, tracking error and cumulative returns equal the JAX
    example's at the same cut."""
    out = quiet(index_replication.main, "cpu", n_rebdates=4)
    ref = golden("index_replication", "small")
    assert out["rebdates"] == ref["rebdates"]
    for k in ("status", "iters", "solved"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert_close(out, ref, ("weights", "max_prim_res", "tracking_error",
                            "cum", "cum_bm"))


def usa_market(n_dates):
    X, V = synthetic_usa_np()
    return X, V, usa_benchmark_np(X), usa_rebdates(X.index)[:n_dates]


def test_backtest_usa_notebook_config_first_dates():
    """Configuration 1 (f32, polish on) on the first two dates at full
    width (520 assets): status and iterations equal
    backtest_usa_golden.npz's (the JAX example's own run), the weights
    by the backtests' twin rule against its f64 iterate (the optimum is
    a face, ROADMAP section C; on the CPU the f32 polish is rejected, as
    in the golden)."""
    X, _, bm, rebdates = usa_market(2)
    out = quiet(backtest_usa.notebook_config, X, bm, rebdates,
                torch.device("cpu"))
    usa = np.load(USA_GOLDEN)
    assert rebdates == golden("backtest_usa", "full")["rebdates"][:2]
    for k in ("status", "iters"):
        np.testing.assert_array_equal(out[f"config1/{k}"],
                                      usa[f"usa_trinv/{k}"][:2])
    g32 = usa["usa_trinv/weights_nopolish"][:2]
    g64 = usa["usa_trinv/weights_nopolish_f64"][:2]
    floor = (chip_smoke.ULPS_PER_ITER * int(usa["usa_trinv/iters"].max())
             * chip_smoke.F32_EPS * 0.05)
    d_port = np.abs(out["config1/weights"] - g64).max(axis=1)
    d_jax = np.abs(g32 - g64).max(axis=1)
    assert np.all(d_port <= chip_smoke.KERNEL_VS_PLAIN * d_jax + floor), (
        d_port, d_jax)


def test_backtest_usa_turnover_config_serial_engine_first_date():
    """Configuration 2 (f64 turnover budget, 489 of 520 assets admitted)
    through the serial engine on its first date: the JAX example's
    universe and weights within chip_smoke.USA_W_ATOL."""
    X, V, bm, rebdates = usa_market(1)
    ref = golden("backtest_usa", "full")
    w0 = backtest_usa.initial_holdings(X, V, bm, rebdates)
    assert len(w0) == ref["config2/universe"] == 489
    bt, _ = backtest_usa.serial_engine(X, V, bm, rebdates, w0,
                                       torch.device("cpu"))
    w = backtest_usa._weights(bt.strategy, rebdates, X.columns)
    d = np.abs(w - ref["config2/serial_weights"][:1]).max()
    assert d <= chip_smoke.USA_W_ATOL, d


def test_backtest_usa_turnover_config_scan_first_date():
    """Configuration 2 through the date scan on its first date (the
    chain is causal, so it is the full run's): solved, its weights
    within chip_smoke.USA_W_ATOL of the JAX example's scan."""
    X, V, bm, rebdates = usa_market(1)
    ref = golden("backtest_usa", "full")
    w0 = backtest_usa.initial_holdings(X, V, bm, rebdates)
    bt, sols, _ = backtest_usa.scan_engine(X, V, bm, rebdates, w0,
                                           torch.device("cpu"))
    assert sols.status.tolist() == [1]
    w = backtest_usa._weights(bt.strategy, rebdates, X.columns)
    d = np.abs(w - ref["config2/scan_weights"][:1]).max()
    assert d <= chip_smoke.USA_W_ATOL, d


def test_backtest_usa_builders_are_the_examples():
    """``common_opt_builders`` equals the JAX example's, item by item."""
    ex = jax_example("backtest_usa")
    same_builders(backtest_usa.common_opt_builders(),
                  ex.common_opt_builders())


def test_compare_solver_matches_jax():
    """The whole example (one problem, 24 assets): the same rows, every
    row found; each row's objective within chip_smoke.COMPARE_OBJ of the
    f64 IPM's and the host rows' (ipm, native, SLSQP) objective and
    residuals within chip_smoke.COMPARE_HOST of the JAX example's, both
    relative to max(1, |value|) (phase 9's rule)."""
    out = quiet(compare_solver.main, "cpu")
    ref = golden("compare_solver", "full")
    df = out["table"]
    assert list(df.index) == ref["rows"]
    assert df["solution_found"].astype(bool).all()
    ipm = float(df.loc["ipm-f64", "objective_value"])
    for row in df.index:
        assert abs(float(df.loc[row, "objective_value"]) - ipm) <= (
            chip_smoke.COMPARE_OBJ * max(1.0, abs(ipm))), row
    host = ["ipm-f64", "native-cpp-admm", "scipy-slsqp"]
    for col in ("objective_value", "primal_residual", "dual_residual",
                "duality_gap"):
        for row in host:
            got = float(df.loc[row, col])
            want = float(ref[f"table/{col}"][ref["rows"].index(row)])
            if np.isnan(want):
                assert np.isnan(got), (row, col)
                continue
            assert abs(got - want) <= chip_smoke.COMPARE_HOST * max(
                1.0, abs(want)), (row, col, got, want)


def test_cost_aware_backtest_small_cut_matches_jax():
    """Three quarterly dates (f64, eps 1e-8): the lifted and native-prox
    weights, the chain, the grid through a one-slot mesh and the
    checkpoint/resume round trip equal the JAX example's at the same
    cut; iterations and status equal."""
    out = quiet(cost_aware_backtest.main, "cpu", n_rebdates=3)
    ref = golden("cost_aware_backtest", "small")
    assert out["rebdates"] == ref["rebdates"]
    for k in ("status_native", "iters_native", "status_chain",
              "iters_chain", "n_dev"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert_close(out, ref, ("w_lift", "w_native", "dw_lift", "x_chain",
                            "chain_turnover", "static_turnover", "dgrid",
                            "dw_checkpoint"))
    strip = lambda d: {k: v for k, v in d.items() if k != "directory"}
    assert strip(out["checkpoint"]) == ref["checkpoint"]
    assert strip(out["resume"]) == ref["resume"]


# ---------------------------------------------------------------------------
# the tuning examples
# ---------------------------------------------------------------------------

def test_differentiable_tuning_pieces_are_the_examples():
    """The panel draws the JAX example's numbers and ``build_qp`` the
    same QPs (f64)."""
    ex = jax_example("differentiable_tuning")
    mine = differentiable_tuning.make_panel(np.random.default_rng(7))
    theirs = ex.make_panel(np.random.default_rng(7))
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    X, y = torch.as_tensor(mine[0][:2]), torch.as_tensor(mine[1][:2])
    qp = differentiable_tuning.build_qp(X, y, 1e-3)
    for b in range(2):
        ref = ex.build_qp(jnp.asarray(mine[0][b]), jnp.asarray(mine[1][b]),
                          1e-3)
        for f in ("P", "q", "C", "l", "u", "lb", "ub", "constant"):
            np.testing.assert_allclose(getattr(qp, f)[b].numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-14, atol=1e-16, err_msg=f)
    assert differentiable_tuning.solver_params() == type(
        differentiable_tuning.solver_params())(**ex.PARAMS.__dict__)


def test_differentiable_tuning_first_steps_match_jax():
    """The first three gradient steps of the full run (a prefix of the
    JAX example's path): the start's TE within F64_ATOL, each gradient
    within GRAD_RTOL, the path within F64_ATOL; the grid cut to its
    start point."""
    out = quiet(differentiable_tuning.main, "cpu", steps=3, grid=(-5.0,))
    ref = golden("differentiable_tuning", "full")
    np.testing.assert_allclose(out["te_start"], ref["te_start"],
                               atol=F64_ATOL, rtol=0)
    np.testing.assert_allclose(out["grads"], ref["grads"][:3],
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(out["path"], ref["path"][:4], atol=F64_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out["grid_te"][0], ref["grid_te"][2],
                               atol=F64_ATOL, rtol=0)


def test_cost_penalty_tuning_pieces_are_the_examples():
    """The data draw the JAX example's numbers and the lifted QP is the
    JAX example's ``lifted_tracking_qp`` per lane (f64)."""
    ex = jax_example("cost_penalty_tuning")
    w_prev, X_fit, y_fit, _, _ = cost_penalty_tuning.make_data()
    rng = np.random.default_rng(11)
    np.testing.assert_array_equal(w_prev, rng.dirichlet(np.ones(ex.N)))
    qp = cost_penalty_tuning.lifted_tracking_qp(
        torch.as_tensor(X_fit[:2]), torch.as_tensor(y_fit[:2]),
        torch.as_tensor(w_prev), 10.0 ** -3.2)
    for b in range(2):
        ref = ex.lifted_tracking_qp(jnp.asarray(X_fit[b]),
                                    jnp.asarray(y_fit[b]),
                                    jnp.asarray(w_prev), 10.0 ** -3.2)
        for f in ("P", "q", "C", "l", "u", "lb", "ub", "var_mask",
                  "row_mask", "constant"):
            np.testing.assert_allclose(getattr(qp, f)[b].numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-14, atol=1e-16, err_msg=f)
    assert (cost_penalty_tuning.N, cost_penalty_tuning.T,
            cost_penalty_tuning.B, cost_penalty_tuning.REAL_TC) == (
        ex.N, ex.T, ex.B, ex.REAL_TC)


def test_cost_penalty_tuning_first_steps_match_jax():
    """The first three steps of the full run: values and path within
    F64_ATOL, gradients within GRAD_RTOL; the lifted and native-prox
    gradients at 1e-3.2 within GRAD_RTOL of the JAX example's."""
    out = quiet(cost_penalty_tuning.main, "cpu", steps=3, grid=(-5.0,))
    ref = golden("cost_penalty_tuning", "full")
    np.testing.assert_allclose(out["start"], ref["start"], atol=F64_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out["values"], ref["values"][:3],
                               atol=F64_ATOL, rtol=0)
    np.testing.assert_allclose(out["grads"], ref["grads"][:3],
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(out["path"], ref["path"][:4], atol=F64_ATOL,
                               rtol=0)
    for k in ("g_lift", "g_native"):
        np.testing.assert_allclose(out[k], ref[k], rtol=GRAD_RTOL,
                                   err_msg=k)


def test_net_sharpe_market_is_the_examples():
    """The market, its windows and the rebalance days equal the JAX
    example's module-level arrays, value for value."""
    ex = jax_example("net_sharpe_tuning")
    R, y, reb = net_sharpe_tuning.make_market()
    np.testing.assert_array_equal(R, np.asarray(ex.R))
    np.testing.assert_array_equal(y, np.asarray(ex.y_bm))
    np.testing.assert_array_equal(reb, np.asarray(ex.reb_idx))
    Xs, ys = net_sharpe_tuning.market_windows(R, y, reb)
    np.testing.assert_array_equal(Xs, np.asarray(ex.Xs))
    np.testing.assert_array_equal(ys, np.asarray(ex.ys))


def test_net_sharpe_tuning_first_iterations_match_jax():
    """Two iterations of the full run's ascent (one backward pass each
    through ten chained native-L1 solves and the accounting engine):
    lambda, net Sharpe and turnover within F64_ATOL, dS/dtheta within
    GRAD_RTOL; at the end point the gradient agrees with central
    differences (the example's own FD check) to 1e-4 relative."""
    out = quiet(net_sharpe_tuning.main, "cpu", iterations=2)
    ref = golden("net_sharpe_tuning", "full")
    for k in ("lambda", "sharpe", "turnover"):
        np.testing.assert_allclose(out[k], ref[k][:2], atol=F64_ATOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(out["grad"], ref["grad"][:2], rtol=GRAD_RTOL)
    np.testing.assert_allclose(out["grad_final"], out["fd_final"],
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the ML examples
# ---------------------------------------------------------------------------

def test_ordinal_regression_matches_jax():
    """The whole example (5,280 training rows, 5 classes; both packages
    fit in f32): cutpoints within chip_smoke.ML_OPT_ATOL of the JAX
    example's and the NLL at the fit within chip_smoke.ML_NLL_ATOL
    (phase 12's rule), accuracies within 1% (a row whose two top
    classes tie to rounding may take either). The coefficient is held
    through the NLL: the example's one feature (a monthly return, scale
    0.05) leaves the NLL flat in it, 2.5e-6 over beta in [-0.063,
    -0.002], and f32 fits stop anywhere on that stretch (the JAX
    package's own probit fit at -0.062, its logit fit at -0.0015; the
    f64 optimum about -0.06 for both), as chip_smoke's EXAMPLES_PATH
    rules say."""
    out = quiet(ordinal_regression.main, "cpu")
    ref = golden("ordinal_regression", "full")
    for distr in ("probit", "logit"):
        assert_close(out, ref, (f"{distr}/cutpoints",),
                     atol=chip_smoke.ML_OPT_ATOL)
        assert_close(out, ref, (f"{distr}/nll",), atol=chip_smoke.ML_NLL_ATOL)
        assert_close(out, ref, (f"{distr}/acc_train", f"{distr}/acc_test"),
                     atol=0.01)


def test_lstm_selection_small_cut_from_the_jax_draws():
    """A 300-day tail, one epoch, from the JAX run's draws (initial
    parameters, minibatch indices, dropout masks): losses and held-out
    predictions by the twin rule against the same training in f64 (4x
    XLA-CPU's f32 distance plus two ulps of the scale per Adam step, phase
    14's rule)."""
    ref = golden("lstm_selection", "small")
    out = quiet(lstm_selection.main, "cpu", draws=lstm_draws(ref),
                n_rows=300, epochs=1)
    steps = ref["draws/batch_indices"].shape[0]
    for key in ("loss", "pred"):
        ok, d, band = chip_smoke.twin_rule(
            np.asarray(out[key])[None], ref[key][None],
            ref[f"{key}_f64"][None], floor=chip_smoke.ULPS_PER_ITER * steps
            * chip_smoke.F32_EPS * float(np.abs(ref[f"{key}_f64"]).max()))
        assert ok.all(), (key, d, band)
    assert out["top10"] == ref["top10"]


def lstm_draws(ref):
    """The JAX run's draws from a golden entry, as ``main`` takes them."""
    tree = {}
    for key, v in ref.items():
        if key.startswith("draws/init_params/"):
            *path, leaf = key[len("draws/init_params/"):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return {"init_params": tree,
            "batch_indices": ref["draws/batch_indices"].astype(np.int64),
            "dropout_masks": ref["draws/dropout_masks"]}


def test_ml_prediction_matches_jax():
    """The whole example with the boosting step (sklearn, on the host):
    PCA's explained variance and OLS's coefficients within
    chip_smoke.ML_OPT_ATOL, the holdout predictions of OLS and PCA+OLS
    within it too, the boosting grid's choice, CV RMSE and predictions
    equal (the same estimator on the same numbers), the rank labels
    and the top asset equal."""
    out = quiet(ml_prediction.main, "cpu")
    ref = golden("ml_prediction", "full")
    assert_close(out, ref, ("evr", "OLS/coef", "OLS/pred", "PCA+OLS/pred",
                            "OLS/rmse", "PCA+OLS/rmse"),
                 atol=chip_smoke.ML_OPT_ATOL)
    assert out["boosted/best"] == ref["boosted/best"]
    assert_close(out, ref, ("boosted/cv_rmse", "boosted/pred",
                            "boosted/rmse"), atol=1e-12)
    np.testing.assert_array_equal(out["labels"], ref["labels"])
    assert out["top"] == ref["top"]


# ---------------------------------------------------------------------------
# Optimization.model_canonical on the card by default
# ---------------------------------------------------------------------------

def _lad_and_ls():
    import porqua_tpu_torch as pt

    data = quiet(quickstart.load_msci_or_synthetic)
    X = data["return_series"].tail(300)
    y = data["bm_series"].reindex(X.index).iloc[:, 0]
    out = []
    for opt in (pt.LeastSquares(dtype=torch.float64, transaction_cost=0.01,
                                x0={a: 1 / 24 for a in X.columns}),
                pt.LAD(dtype=torch.float64)):
        c = pt.Constraints(selection=list(X.columns))
        c.add_budget()
        c.add_box("LongOnly", upper=0.2)
        opt.constraints = c
        opt.set_objective(pt.OptimizationData(align=False, return_series=X,
                                              bm_series=y))
        out.append(opt)
    return out


@pytest.mark.parametrize("which", [0, 1])
def test_model_canonical_defaults_to_the_card(which, monkeypatch):
    """``Optimization.model_canonical`` (and LAD's override) resolve
    their device as every entry point does: with no card and no
    ``device`` they raise; with ``device="cpu"`` they build the
    CanonicalQP that ``CanonicalQP.build`` makes of the same parts on
    the CPU, field for field."""
    import porqua_tpu_torch as pt

    opt = _lad_and_ls()[which]
    parts = opt.canonical_parts()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.model_canonical()
    qp = opt.model_canonical(device="cpu")
    ref = pt.CanonicalQP.build(
        parts["P"], parts["q"], C=parts["C"], l=parts["l"], u=parts["u"],
        lb=parts["lb"], ub=parts["ub"], constant=parts.get("constant", 0.0),
        dtype=torch.float64, Pf=parts.get("Pf"), Pdiag=parts.get("Pdiag"),
        device="cpu")
    for f in qp._fields:
        a, b = getattr(qp, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.device.type == "cpu"
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
