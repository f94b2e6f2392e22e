"""The synthetic USA market of ``examples/backtest_usa.py`` (numpy and
pandas only): the large-universe backtest's inputs at the scale of a
~500-stock US universe with monthly rebalances, made here so that
callers of this package need nothing from ``examples/``. A test holds
the frames equal to the example's, value for value.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

N_RAW = 520      # raw synthetic universe
N_ASSETS = 489   # names with liquid volumes (the USA universe size)
MIN_VOLUME = 1e6


def synthetic_usa_np(n_days=1500, n_assets=N_RAW, seed=7):
    """Synthetic factor market + volumes: ``(X, V)`` business-day
    frames of returns and volumes. The first ``N_ASSETS`` names carry
    volumes well above ``MIN_VOLUME``, the rest well below it."""
    rng = np.random.default_rng(seed)
    dates = pd.bdate_range("2018-01-01", periods=n_days)
    k = 10  # common factors
    B = 0.5 + 0.5 * rng.random((n_assets, k))
    F = 0.008 * rng.standard_normal((n_days, k))
    eps = 0.01 * rng.standard_normal((n_days, n_assets))
    X = pd.DataFrame(F @ B.T + eps, index=dates,
                     columns=[f"S{i:04d}" for i in range(n_assets)])
    base = np.where(np.arange(n_assets) < N_ASSETS, 10.0, 0.2) * MIN_VOLUME
    noise = rng.lognormal(sigma=0.3, size=(n_days, n_assets))
    V = pd.DataFrame(base * noise, index=dates, columns=X.columns)
    return X, V


def usa_benchmark_np(X: pd.DataFrame, seed: int = 0) -> pd.DataFrame:
    """The example's cap-weight-style composite of the universe itself:
    ``X @ dirichlet(ones * 5)``, one column ``SPTR``."""
    w = np.random.default_rng(seed).dirichlet(np.ones(X.shape[1]) * 5.0)
    return pd.DataFrame({"SPTR": X.to_numpy() @ w}, index=X.index)


def usa_rebdates(index: pd.DatetimeIndex):
    """The example's rebalance calendar: the last trading day of each
    month, from the 14th month to the second-to-last."""
    me = pd.Series(index=index, data=1).resample("ME").last().index
    return [str(index[index <= d][-1].date()) for d in me][13:-1]


def large_universe_np(seed: int = 7, window: int = 504,
                      n_assets: int = 5000):
    """One large-universe tracking window, float32 ``(X (1, T, N),
    y (1, T))``: 8 factor returns plus idiosyncratic noise, the index an
    equal-weight slice of the first ``max(N // 40, 8)`` names plus an
    irreducible tracking floor, so the tracking error is a real number.
    ``bench.py``'s recipe for the sketch A/B (2,048 assets) and the
    5,000-asset north star."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((window, 8))
    L = rng.standard_normal((8, n_assets))
    X = ((F @ L + 0.5 * rng.standard_normal((window, n_assets)))
         * 0.01).astype(np.float32)
    y = (X[:, : max(n_assets // 40, 8)].mean(axis=1)
         + 0.001 * rng.standard_normal(window)).astype(np.float32)
    return X[None], y[None]
