#!/usr/bin/env python3
"""Write the JAX goldens of the port's examples on XLA-CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/torch_examples_golden.py \
        [--only NAME ...] [--out PATH]

Runs the JAX package's ``examples/*.py`` (each imported by path, its own
``main`` run with the calls it makes recorded) and writes, per example,
the numbers the port's ``porqua_tpu_torch/examples/<name>.py`` returns
from ``main`` under ``<name>/full/...`` (the example's own sizes) and,
for the examples the CPU tests run whole, ``<name>/small/...`` (the
same example at the cut the test runs: fewer rebalance dates, a
shorter tail, one epoch). The tuning examples keep their loop inside
``main``: their runs are the example's own functions in a loop that
copies ``main`` and prints the same lines, which must equal the lines
``main`` prints. ``lstm_selection`` also records the JAX run's draws
(initial parameters, minibatch indices, dropout masks) and the same
training in float64 (the twin of the f32 run). ``backtest_usa``'s
configuration 1 is ``testdata/backtest_usa_golden.npz``'s
``usa_trinv`` run: here only its summary numbers, after checking that
this run's weights equal that golden's.

Output: ``porqua_tpu_torch/testdata/examples_golden.npz`` (with
``--only`` the other examples' entries are kept), its ``meta`` the
commit, the command and each example's seconds. About 10 minutes on
8 cores.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
EXAMPLES_DIR = os.path.join(ROOT, "examples")
GOLDEN = os.path.join(ROOT, "porqua_tpu_torch", "testdata",
                      "examples_golden.npz")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import pandas as pd  # noqa: E402

from porqua_tpu.accounting import (performance_summary,  # noqa: E402
                                   simulate_strategy)
from porqua_tpu_torch.examples._common import (pack_golden,  # noqa: E402
                                               unpack_golden)

# The cuts of the examples that the CPU tests run whole.
SMALL = {"quickstart": dict(n_rebdates=3),
         "index_replication": dict(n_rebdates=4),
         "cost_aware_backtest": dict(n_rebdates=3),
         "lstm_selection": dict(n_rows=300, epochs=1)}


def load_example(name):
    """The JAX example module (its import runs ``init_platform``)."""
    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recorded(fn, into):
    """``fn`` that appends each call's result to ``into``."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        into.append(out)
        return out
    return wrapper


def recording_class(cls, method, into):
    """A subclass of ``cls`` whose ``method`` appends the instance to
    ``into`` after it runs."""
    def run(self, *args, **kwargs):
        out = getattr(cls, method)(self, *args, **kwargs)
        into.append(self)
        return out
    return type(cls.__name__, (cls,), {method: run})


@contextlib.contextmanager
def patched(obj, **attrs):
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def run_main(ex):
    """The example's ``main`` with its output captured; returns the
    printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex.main()
    text = buf.getvalue()
    print(text, end="")
    return text.splitlines()


def weights_of(strategy, rebdates, columns):
    return (strategy.get_weights_df().reindex(index=rebdates,
                                              columns=columns)
            .to_numpy(float))


def prefix_dates(fn, k):
    return lambda index, *a, **kw: fn(index, *a, **{**kw, "k": k})


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def quickstart(n_rebdates=12):
    ex = load_example("quickstart")
    runs, batched = [], []
    with patched(ex, quarterly_rebdates=prefix_dates(ex.quarterly_rebdates,
                                                     n_rebdates),
                 Backtest=recording_class(ex.Backtest, "run", runs),
                 run_batch=recorded(ex.run_batch, batched)):
        run_main(ex)
    data = ex.load_msci_or_synthetic()
    returns = data["return_series"]
    rebdates = ex.quarterly_rebdates(returns.index, start="2018-01-01",
                                     k=n_rebdates)
    out = {"rebdates": rebdates}
    sims = {}
    for bt, name in zip(runs[:4], ("qeqw", "ls", "wls", "lad")):
        sims[name] = simulate_strategy(bt.strategy, returns, fc=0.0,
                                       vc=0.002)
        out[f"{name}/cum"] = float(np.log1p(sims[name]).sum())
        per_date = bt.strategy.turnover(return_series=returns)
        out[f"{name}/turnover"] = float(per_date.mean())
        out[f"{name}/turnover_series"] = per_date.to_numpy(float)
        out[f"{name}/weights"] = weights_of(bt.strategy, rebdates,
                                            returns.columns)
    sim_b = simulate_strategy(batched[0].strategy, returns, fc=0.0, vc=0.002)
    out["batched/drift"] = float(np.abs(np.log1p(sims["ls"]).sum()
                                        - np.log1p(sim_b).sum()))
    out["batched/weights"] = weights_of(batched[0].strategy, rebdates,
                                        returns.columns)
    from porqua_tpu.utils.helpers import output_to_strategies

    cums = {name: float(np.log1p(simulate_strategy(
        strat, returns, fc=0.0, vc=0.0)).sum())
        for name, strat in output_to_strategies(runs[4].output).items()}
    out.update({f"percentile/{k}": v for k, v in cums.items()})
    out["percentile/spread"] = cums["q1"] - cums["q5"]
    return out


def index_replication(n_rebdates=36):
    ex = load_example("index_replication")
    batched = []
    with patched(ex, monthly_rebdates=prefix_dates(ex.monthly_rebdates,
                                                   n_rebdates),
                 run_batch=recorded(ex.run_batch, batched)):
        run_main(ex)
    data = ex.load_msci_or_synthetic()
    returns, bm = data["return_series"], data["bm_series"]
    rebdates = ex.monthly_rebdates(returns.index, k=n_rebdates)
    bt = batched[0]
    stats = bt.output["batch"]
    sim = simulate_strategy(bt.strategy, returns, fc=0.0, vc=0.0)
    bm_ret = bm.iloc[:, 0].reindex(sim.index)
    return {"rebdates": rebdates,
            "status": np.asarray(stats["status"]),
            "iters": np.asarray(stats["iters"]),
            "weights": weights_of(bt.strategy, rebdates, returns.columns),
            "solved": int((stats["status"] == 1).sum()),
            "max_prim_res": float(np.max(stats["prim_res"])),
            "tracking_error": float((sim - bm_ret).std() * np.sqrt(252)),
            "cum": float(np.log1p(sim).sum()),
            "cum_bm": float(np.log1p(bm_ret).sum())}


def backtest_usa():
    ex = load_example("backtest_usa")
    batched, serial, scans, assembled, sizes = [], [], [], [], []

    def scan(*args, **kwargs):
        sizes.append(kwargs["n_assets"])
        return ex_scan(*args, **kwargs)

    ex_scan = ex.solve_scan_turnover
    with patched(ex, run_batch=recorded(ex.run_batch, batched),
                 Backtest=recording_class(ex.Backtest, "run", serial),
                 solve_scan_turnover=recorded(scan, scans),
                 assemble_backtest=recorded(ex.assemble_backtest,
                                            assembled)):
        run_main(ex)
    X, V = ex.synthetic_usa()
    w = np.random.default_rng(0).dirichlet(np.ones(X.shape[1]) * 5.0)
    bm = pd.DataFrame({"SPTR": X.to_numpy() @ w}, index=X.index)
    me = pd.Series(index=X.index, data=1).resample("ME").last().index
    rebdates = [str(X.index[X.index <= d][-1].date()) for d in me][13:-1]
    cols = X.columns

    def summary(strategy):
        sim = simulate_strategy(strategy, X, fc=0.0, vc=0.001)
        perf = performance_summary(sim, benchmark=bm.iloc[:, 0])
        return {k: float(perf[k]) for k in
                ("sharpe", "max_drawdown", "var_95", "tracking_error")}

    # Configuration 1 is backtest_usa_golden.npz's usa_trinv run.
    usa = np.load(os.path.join(ROOT, "porqua_tpu_torch", "testdata",
                               "backtest_usa_golden.npz"))
    w1 = weights_of(batched[0].strategy, rebdates, cols)
    d1 = float(np.abs(np.nan_to_num(w1) - usa["usa_trinv/weights"]).max())
    assert d1 <= 1e-6, d1
    assert np.array_equal(batched[0].output["batch"]["iters"],
                          usa["usa_trinv/iters"])
    out = {"rebdates": rebdates}
    out.update({f"config1/{k}": v
                for k, v in summary(batched[0].strategy).items()})
    out["config1/solved"] = int((batched[0].output["batch"]["status"]
                                 == 1).sum())

    bt_serial, bt_scan = serial[0], assembled[0]
    n_check = len(bt_serial.strategy.get_weights_df())
    max_dw = 0.0
    for date in rebdates[:n_check]:
        ws = pd.Series(bt_serial.strategy.get_weights(date))
        wb = pd.Series(bt_scan.strategy.get_weights(date))
        d = (wb.reindex(ws.index) - ws).abs().max(skipna=False)
        max_dw = float(np.maximum(max_dw, d))
    wdf = bt_scan.strategy.get_weights_df().fillna(0.0)
    realized = wdf.diff().abs().sum(axis=1).iloc[1:]
    fill = lambda s, d: np.nan_to_num(weights_of(s, d, cols))
    out.update({"config2/universe": int(sizes[0]),
        "config2/serial_weights": fill(bt_serial.strategy,
                                       rebdates[:n_check]),
        "config2/scan_weights": fill(bt_scan.strategy, rebdates),
        "config2/status": np.asarray(scans[0].status),
        "config2/max_dw": max_dw,
        "config2/realized_median": float(realized.median())})
    out.update({f"config2/{k}": v for k, v in summary(bt_scan.strategy)
                .items()})
    return out


def compare_solver():
    ex = load_example("compare_solver")
    tables = []
    with patched(ex, compare_solvers=recorded(ex.compare_solvers, tables)):
        run_main(ex)
    df = tables[0]
    found = df["solution_found"].astype(bool)
    objs = df.loc[found, "objective_value"]
    out = {"rows": list(df.index), "spread": float(objs.max() - objs.min())}
    for col in ("solution_found", "objective_value", "primal_residual",
                "dual_residual", "duality_gap"):
        out[f"table/{col}"] = df[col].to_numpy(float)
    return out


def cost_aware_backtest(n_rebdates=12):
    import porqua_tpu.batch as jbatch

    ex = load_example("cost_aware_backtest")
    batched, chains, grids, cks = [], [], [], []
    with patched(ex, quarterly_rebdates=prefix_dates(ex.quarterly_rebdates,
                                                     n_rebdates),
                 run_batch=recorded(ex.run_batch, batched),
                 solve_scan_l1=recorded(ex.solve_scan_l1, chains),
                 run_batch_checkpointed=recorded(ex.run_batch_checkpointed,
                                                 cks)), \
            patched(jbatch, solve_scan_l1_grid=recorded(
                jbatch.solve_scan_l1_grid, grids)):
        run_main(ex)
    data = ex.load_msci_or_synthetic()
    rebdates = ex.quarterly_rebdates(data["return_series"].index,
                                     k=n_rebdates)
    w_lift = batched[0].strategy.get_weights_df().reindex(index=rebdates)
    w_nat = batched[1].strategy.get_weights_df().reindex(index=rebdates)
    n = w_nat.shape[1]
    x_chain = np.asarray(chains[0].x)[:, :n]
    t_demo = min(4, len(rebdates))
    strip = lambda d: {k: v for k, v in d.items() if k != "directory"}
    return {"rebdates": rebdates,
            "w_lift": w_lift.to_numpy(float), "w_native": w_nat.to_numpy(float),
            "status_native": np.asarray(batched[1].output["batch"]["status"]),
            "iters_native": np.asarray(batched[1].output["batch"]["iters"]),
            "dw_lift": float(np.abs(w_lift.values - w_nat.values).max()),
            "x_chain": x_chain,
            "status_chain": np.asarray(chains[0].status),
            "iters_chain": np.asarray(chains[0].iters),
            "chain_turnover": float(np.abs(np.diff(x_chain, axis=0)).sum()),
            "static_turnover": float(np.abs(np.diff(w_nat.values,
                                                    axis=0)).sum()),
            "dgrid": float(np.abs(np.asarray(grids[0].x)
                                  - np.asarray(chains[0].x)[None, :t_demo])
                           .max()),
            "n_dev": int(np.asarray(grids[0].x).shape[0]),
            "checkpoint": strip(cks[0].output["checkpoint"]),
            "resume": strip(cks[1].output["checkpoint"]),
            "dw_checkpoint": float(np.abs(
                cks[0].strategy.get_weights_df().values
                - cks[1].strategy.get_weights_df().values).max())}


def same_lines(mine, theirs, name):
    """The copy of ``main``'s loop printed what ``main`` printed."""
    assert mine == theirs, (name, mine, theirs)


def differentiable_tuning():
    ex = load_example("differentiable_tuning")
    printed = run_main(ex)
    lines = []
    say = lines.append
    rng = np.random.default_rng(7)
    X_fit, y_fit, X_oos, y_oos = ex.make_panel(rng)

    @jax.jit
    def oos_te(log_ridge):
        ridge = 10.0 ** log_ridge

        def one(Xf, yf, Xo, yo):
            w = ex.solve_qp_diff(ex.build_qp(Xf, yf, ridge), ex.PARAMS)
            r = Xo @ w - yo
            return jnp.sqrt(jnp.mean(r * r))

        return jnp.mean(jax.vmap(one)(X_fit, y_fit, X_oos, y_oos))

    grad = jax.jit(jax.grad(oos_te))
    log_r = jnp.asarray(-5.0, jnp.float64)
    te_start = float(oos_te(log_r))
    say(f"start: ridge=1e{float(log_r):.2f} oos_te={te_start:.6e}")
    lr, cap = 2e4, 0.5
    path, grads = [float(log_r)], []
    for _ in range(40):
        g = grad(log_r)
        grads.append(float(g))
        log_r = log_r - jnp.clip(lr * g, -cap, cap)
        path.append(float(log_r))
    te_tuned = float(oos_te(log_r))
    say(f"tuned: ridge=1e{float(log_r):.2f} oos_te={te_tuned:.6e}")
    grid = [-7.0, -6.0, -5.0, -4.0, -3.0, -2.0, -1.0]
    tes = [float(oos_te(jnp.asarray(g, jnp.float64))) for g in grid]
    best = int(np.argmin(tes))
    say("grid  : " + ", ".join(f"1e{g:.0f}->{t:.3e}"
                               for g, t in zip(grid, tes)))
    say(f"grid best: ridge=1e{grid[best]:.0f} oos_te={tes[best]:.6e}")
    same_lines(lines, printed[:len(lines)], "differentiable_tuning")
    return {"te_start": te_start, "path": np.asarray(path),
            "grads": np.asarray(grads), "log_ridge": float(log_r),
            "te_tuned": te_tuned, "grid_te": np.asarray(tes)}


def cost_penalty_tuning():
    ex = load_example("cost_penalty_tuning")
    printed = run_main(ex)
    lines = []
    say = lines.append
    N, T = ex.N, ex.T
    rng = np.random.default_rng(11)
    w_prev = jnp.asarray(rng.dirichlet(np.ones(N)))
    w_true = rng.dirichlet(np.ones(N))
    Xs = rng.standard_normal((ex.B, 2 * T, N)) * 0.01
    ys = Xs @ w_true + rng.standard_normal((ex.B, 2 * T)) * 0.002
    X_fit, y_fit = jnp.asarray(Xs[:, :T]), jnp.asarray(ys[:, :T])
    X_oos, y_oos = jnp.asarray(Xs[:, T:]), jnp.asarray(ys[:, T:])

    @jax.jit
    def net_loss(log_lam):
        lam = 10.0 ** log_lam

        def one(Xf, yf, Xo, yo):
            wt = ex.solve_qp_diff(ex.lifted_tracking_qp(Xf, yf, w_prev, lam),
                                  ex.PARAMS)
            w = wt[:N]
            te = jnp.sqrt(jnp.mean((Xo @ w - yo) ** 2))
            return te + ex.REAL_TC * jnp.sum(jnp.abs(w - w_prev))

        return jnp.mean(jax.vmap(one)(X_fit, y_fit, X_oos, y_oos))

    loss_and_grad = jax.jit(jax.value_and_grad(net_loss))
    log_l = jnp.asarray(-5.0, jnp.float64)
    start = float(net_loss(log_l))
    say(f"start: lambda=1e{float(log_l):.2f} net={start:.6e}")
    lr, cap = 2e3, 0.2
    best_log, best_net = float(log_l), start
    path, values, grads = [float(log_l)], [], []
    for _ in range(60):
        v, g = loss_and_grad(log_l)
        values.append(float(v))
        grads.append(float(g))
        if float(v) < best_net:
            best_net, best_log = float(v), float(log_l)
        log_l = log_l - jnp.clip(lr * g, -cap, cap)
        path.append(float(log_l))
    v_last = float(net_loss(log_l))
    if v_last < best_net:
        best_net, best_log = v_last, float(log_l)
    say(f"tuned: lambda=1e{best_log:.2f} net={best_net:.6e}")
    grid = [-5.0, -4.0, -3.0, -2.5, -2.0, -1.5, -1.0]
    nets = [float(net_loss(jnp.asarray(g, jnp.float64))) for g in grid]
    best = int(np.argmin(nets))
    say("grid  : " + ", ".join(f"1e{g:.1f}->{v:.4e}"
                               for g, v in zip(grid, nets)))
    say(f"grid best: lambda=1e{grid[best]:.1f} net={nets[best]:.6e}")
    say("OK: gradient-tuned turnover penalty matches/beats the grid")
    from porqua_tpu.qp.diff import solve_qp_l1_diff

    def plain_qp(X, y):
        n = X.shape[1]
        dtype = X.dtype
        return ex.CanonicalQP(
            P=2.0 * X.T @ X, q=-2.0 * X.T @ y,
            C=jnp.ones((1, n), dtype), l=jnp.ones(1, dtype),
            u=jnp.ones(1, dtype), lb=jnp.zeros(n, dtype),
            ub=jnp.ones(n, dtype), var_mask=jnp.ones(n, dtype),
            row_mask=jnp.ones(1, dtype), constant=jnp.dot(y, y))

    @jax.jit
    def net_loss_native(log_lam):
        lam = 10.0 ** log_lam

        def one(Xf, yf, Xo, yo):
            wv = solve_qp_l1_diff(plain_qp(Xf, yf),
                                  jnp.full(N, lam, jnp.float64), w_prev,
                                  ex.PARAMS)
            te = jnp.sqrt(jnp.mean((Xo @ wv - yo) ** 2))
            return te + ex.REAL_TC * jnp.sum(jnp.abs(wv - w_prev))

        return jnp.mean(jax.vmap(one)(X_fit, y_fit, X_oos, y_oos))

    probe = jnp.asarray(-3.2, jnp.float64)
    g_lift = float(jax.grad(net_loss)(probe))
    g_native = float(jax.grad(net_loss_native)(probe))
    say(f"d(net)/d(log lambda) at 1e-3.2: lifted {g_lift:+.6e}, "
        f"native prox {g_native:+.6e}")
    same_lines(lines, printed[:len(lines)], "cost_penalty_tuning")
    return {"start": start, "path": np.asarray(path),
            "values": np.asarray(values), "grads": np.asarray(grads),
            "best_log": best_log, "net_tuned": best_net,
            "grid_net": np.asarray(nets), "g_lift": g_lift,
            "g_native": g_native}


def net_sharpe_tuning():
    ex = load_example("net_sharpe_tuning")
    printed = run_main(ex)
    lines = []
    say = lines.append
    val_and_grad = jax.jit(jax.value_and_grad(
        lambda th: ex.net_sharpe(jnp.exp(th))))
    theta = jnp.log(jnp.asarray(8e-4, jnp.float64))
    lr = 0.4
    say(f"actual cost vc={ex.VC}; tuning the solver's lambda on NET Sharpe")
    trace = {"lambda": [], "sharpe": [], "grad": [], "turnover": []}
    for it in range(14):
        s, g = val_and_grad(theta)
        lam = float(jnp.exp(theta))
        to = float(jnp.sum(ex.simulate(ex.weights_chain(jnp.exp(theta)),
                                       ex.R, ex.reb_idx, vc=ex.VC).turnover))
        say(f"  it {it:2d}: lambda {lam:.5f}  net Sharpe "
            f"{float(s):+.3f}  dS/dtheta {float(g):+8.3f}  "
            f"total turnover {to:.2f}")
        for k, v in zip(trace, (lam, float(s), float(g), to)):
            trace[k].append(v)
        theta = theta + lr * jnp.clip(g, -2.0, 2.0)
    lam = jnp.exp(theta)
    h = 1e-6
    fd = (float(ex.net_sharpe(lam + h)) - float(ex.net_sharpe(lam - h))) / (
        2 * h)
    g = float(jax.grad(ex.net_sharpe)(lam))
    say(f"FD check at lambda={float(lam):.5f}: grad {g:+.4f} vs FD {fd:+.4f}")
    s_final = float(ex.net_sharpe(lam))
    s_zero = float(ex.net_sharpe(jnp.asarray(1e-6)))
    s_frozen = float(ex.net_sharpe(jnp.asarray(0.1)))
    say(f"net Sharpe: chase-everything (lambda~0) {s_zero:+.3f}, "
        f"frozen (lambda=0.1) {s_frozen:+.3f}, tuned {s_final:+.3f}")
    same_lines(lines, printed, "net_sharpe_tuning")
    return {**{k: np.asarray(v) for k, v in trace.items()},
            "lambda_final": float(lam), "grad_final": g, "fd_final": fd,
            "sharpe_final": s_final, "sharpe_zero": s_zero,
            "sharpe_frozen": s_frozen}


def ordinal_regression():
    ex = load_example("ordinal_regression")
    fits = []
    with patched(ex, OrdinalRegression=recording_class(
            ex.OrdinalRegression, "fit", fits)):
        run_main(ex)
    from porqua_tpu_torch.examples.ordinal_regression import ordinal_data

    X_train, y_train, X_test, y_test = ordinal_data(5)
    out = {}
    for model in fits:
        d = model.distr
        out.update({f"{d}/cutpoints": np.asarray(model.cutpoints_),
                    f"{d}/beta": np.asarray(model.beta_),
                    f"{d}/nll": float(model.nll_),
                    f"{d}/acc_train": float((model.predict(X_train)
                                             == y_train).mean()),
                    f"{d}/acc_test": float((model.predict(X_test)
                                            == y_test).mean())})
    return out


def flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def lstm_selection(n_rows=2000, epochs=30):
    tests = os.path.join(ROOT, "tests")
    sys.path.insert(0, tests)
    import test_torch_models as tm

    ex = load_example("lstm_selection")
    models, scores = [], []
    load = ex.load_msci_or_synthetic

    def tail_data():
        data = load()
        return {**data, "return_series": data["return_series"].tail(n_rows)}

    fit = ex.train_lstm

    def train(X, y, **kw):
        return fit(X, y, **{**kw, "epochs": epochs})

    with patched(ex, load_msci_or_synthetic=tail_data,
                 train_lstm=recorded(train, models),
                 ndcg=recorded(ex.ndcg, scores)):
        run_main(ex)
    from porqua_tpu_torch.examples.lstm_selection import lstm_data

    returns, X_train, y_train, X_test, y_test = lstm_data(n_rows, 100, 50)
    model = models[0]
    pred = np.asarray(model.predict(X_test))
    params, idx, masks, drop_keys = tm.jax_lstm_draws(
        X_train, 32, 0.2, epochs, 128, 0)
    module64, p64, loss64 = tm.jax_train_f64(
        X_train, y_train, params, idx, drop_keys, 32, 0.2, epochs, 128, 1e-3)
    pred64 = np.asarray(module64.apply(
        {"params": p64}, jnp.asarray(X_test, jnp.float64)))
    top = np.argsort(-pred[-1])[:10]
    out = {"loss": np.asarray(model.loss_history), "pred": pred,
           "rmse": float(np.sqrt(np.mean((pred - y_test) ** 2))),
           "ndcg": float(np.asarray(scores[0]).mean()),
           "top10": list(returns.columns[top]),
           "loss_f64": np.asarray(loss64), "pred_f64": pred64,
           "draws/batch_indices": np.asarray(idx, np.int16),
           "draws/dropout_masks": np.asarray(masks, bool)}
    out.update(flat(params, "draws/init_params"))
    return out


def ml_prediction():
    ex = load_example("ml_prediction")
    olss, pcas, boosted, rmses, labels = [], [], [], [], []
    rmse = ex.calculate_rmse

    def recorded_rmse(t, p):
        rmses.append((t, p))
        return rmse(t, p)

    with patched(ex, OLS=recording_class(ex.OLS, "fit", olss),
                 PCA=recording_class(ex.PCA, "fit", pcas),
                 boosted_regression=recorded(ex.boosted_regression, boosted),
                 calculate_rmse=recorded_rmse,
                 decile_rank_labels=recorded(ex.decile_rank_labels, labels)):
        run_main(ex)
    est, best, cv_rmse = boosted[0]
    out = {"evr": np.asarray(pcas[0].explained_variance_ratio_),
           "OLS/coef": np.asarray(olss[0].coef_),
           "boosted/best": dict(best), "boosted/cv_rmse": float(cv_rmse),
           "labels": labels[0].to_numpy(float),
           "top": str(labels[0].iloc[-1].idxmin())}
    for name, (t, p) in zip(("OLS", "PCA+OLS", "boosted"), rmses):
        out.update({f"{name}/pred": np.asarray(p, float),
                    f"{name}/rmse": float(ex.calculate_rmse(t, p)),
                    f"{name}/mape": float(ex.calculate_mape(t, p))})
    return out


RUNS = {
    "quickstart": quickstart,
    "index_replication": index_replication,
    "backtest_usa": backtest_usa,
    "compare_solver": compare_solver,
    "cost_aware_backtest": cost_aware_backtest,
    "differentiable_tuning": differentiable_tuning,
    "cost_penalty_tuning": cost_penalty_tuning,
    "net_sharpe_tuning": net_sharpe_tuning,
    "ordinal_regression": ordinal_regression,
    "lstm_selection": lstm_selection,
    "ml_prediction": ml_prediction,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(RUNS))
    ap.add_argument("--out", default=GOLDEN)
    opts = ap.parse_args()
    names = opts.only or list(RUNS)
    arrays, meta = {}, {"examples": {}}
    if opts.only and os.path.exists(opts.out):
        old = np.load(opts.out)
        meta = json.loads(str(old["meta"]))
        arrays = {k: old[k] for k in old.files if k != "meta"
                  and k.split("/")[0] not in names}
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    meta.update(commit=commit, jax=jax.__version__, platform="cpu",
                command="JAX_PLATFORMS=cpu PYTHONPATH=. python "
                        "scripts/torch_examples_golden.py"
                        + "".join(f" {a}" for a in sys.argv[1:]))
    for name in names:
        t0 = time.perf_counter()
        print(f"=== {name}", flush=True)
        cuts = {"full": {}}
        if name in SMALL:
            cuts["small"] = SMALL[name]
        for cut, kw in cuts.items():
            arrays.update(pack_golden(f"{name}/{cut}", RUNS[name](**kw)))
        meta["examples"][name] = {"seconds": time.perf_counter() - t0,
                                  "small": SMALL.get(name)}
        # Written after each example, so that a later failure keeps it.
        np.savez_compressed(opts.out, meta=np.asarray(json.dumps(meta)),
                            **arrays)
        assert unpack_golden(np.load(opts.out), f"{name}/full")
    print(f"wrote {opts.out}: {os.path.getsize(opts.out) / 1e6:.2f} MB",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
