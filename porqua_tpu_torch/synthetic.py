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
