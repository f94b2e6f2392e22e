"""The port's tensor accounting against the JAX package's, on the same
numpy inputs (float64 on both sides: the conftest turns on JAX x64), and
against the port's own pandas engine. Tolerance 1e-12: the same
arithmetic in another summation order on returns of order 1e-2."""

import numpy as np
import pandas as pd
import pytest

import jax.numpy as jnp
import torch

from porqua_tpu import accounting as jacc
from porqua_tpu.portfolio import Portfolio as JaxPortfolio
from porqua_tpu.portfolio import Strategy as JaxStrategy

from porqua_tpu_torch import accounting as tacc
from porqua_tpu_torch.portfolio import Portfolio, Strategy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-12


def make_returns(rng, n_assets=5, n_days=200):
    dates = pd.bdate_range("2021-01-04", periods=n_days)
    return pd.DataFrame(rng.standard_normal((n_days, n_assets)) * 0.01,
                        index=dates,
                        columns=[f"A{i}" for i in range(n_assets)])


def weight_rows(rng, kind, n_assets=5, n_rows=4):
    if kind == "long_only":
        return np.stack([rng.dirichlet(np.ones(n_assets))
                         for _ in range(n_rows)])
    return rng.standard_normal((n_rows, n_assets)) * 0.4


def reb_idx_of(returns, n_rows, every=40, start=10):
    return np.arange(start, len(returns), every)[:n_rows]


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("costs", [(0.0, 0.0), (0.002, 0.0), (0.0, 0.01),
                                   (0.003, 0.02)])
@pytest.mark.parametrize("kind", ["long_only", "long_short"])
def test_simulate_matches_jax(kind, costs, rescale, rng):
    vc, fc = costs
    returns = make_returns(rng)
    W = weight_rows(rng, kind)
    reb = reb_idx_of(returns, len(W))
    gaps = np.zeros(len(returns))
    gaps[1:] = np.diff(returns.index.to_numpy()).astype(
        "timedelta64[D]").astype(float)
    R = returns.to_numpy()
    ref = jacc.simulate(jnp.asarray(W), jnp.asarray(R), jnp.asarray(reb),
                        vc=vc, fc=fc, day_gaps=jnp.asarray(gaps),
                        rescale_turnover=rescale)
    got = tacc.simulate(torch.as_tensor(W), torch.as_tensor(R),
                        torch.as_tensor(reb), vc=vc, fc=fc,
                        day_gaps=torch.as_tensor(gaps),
                        rescale_turnover=rescale)
    for k in ("returns", "turnover", "levels"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)),
                                   atol=TOL, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


@pytest.mark.parametrize("rescale", [False, True])
def test_drift_weights_matches_jax(rescale, rng):
    returns = make_returns(rng)
    W = weight_rows(rng, "long_short")
    reb = reb_idx_of(returns, len(W))
    R = returns.to_numpy()
    ref = jacc.drift_weights(jnp.asarray(W), jnp.asarray(R),
                             jnp.asarray(reb), rescale=rescale)
    got = tacc.drift_weights(torch.as_tensor(W), torch.as_tensor(R), reb,
                             rescale=rescale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def _strategies(returns, W, every=40, start=10):
    dates = returns.index[start::every][:len(W)]
    out = []
    for S, P in ((Strategy, Portfolio), (JaxStrategy, JaxPortfolio)):
        s = S([])
        for d, w in zip(dates, W):
            s.portfolios.append(P(str(d.date()), dict(zip(returns.columns, w))))
        out.append(s)
    return out


@pytest.mark.parametrize("kind", ["long_only", "long_short"])
def test_simulate_strategy_and_summary_match_jax(kind, rng):
    """simulate_strategy + performance_summary: the port on the CPU, the
    reference, and the port's pandas engine (Strategy.simulate)."""
    returns = make_returns(rng)
    mine, theirs = _strategies(returns, weight_rows(rng, kind))
    bm = returns.mean(axis=1)
    got = tacc.simulate_strategy(mine, returns, fc=0.01, vc=0.002,
                                 device="cpu")
    ref = jacc.simulate_strategy(theirs, returns, fc=0.01, vc=0.002)
    pd.testing.assert_index_equal(got.index, ref.index)
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), atol=TOL)
    pandas = mine.simulate(return_series=returns, fc=0.01, vc=0.002)
    common = got.index.intersection(pandas.index)
    assert len(common) > 100
    np.testing.assert_allclose(got[common].to_numpy(),
                               pandas[common].to_numpy(), atol=1e-10)
    s_got = tacc.performance_summary(got, benchmark=bm)
    s_ref = jacc.performance_summary(ref, benchmark=bm)
    assert sorted(s_got) == sorted(s_ref)
    for k in s_ref:
        np.testing.assert_allclose(s_got[k], s_ref[k], rtol=1e-10,
                                   atol=TOL, err_msg=k)


def test_simulate_strategy_rejects_dates_outside_the_series(rng):
    returns = make_returns(rng)
    s = Strategy([Portfolio("2019-01-01", {"A0": 1.0})])
    with pytest.raises(ValueError, match="inside the return series"):
        tacc.simulate_strategy(s, returns, device="cpu")


def test_performance_summary_empty_series():
    out = tacc.performance_summary(pd.Series([], dtype=float),
                                   benchmark=pd.Series([], dtype=float))
    assert out["n_days"] == 0 and np.isnan(out["sharpe"])
    assert np.isnan(out["tracking_error"])
