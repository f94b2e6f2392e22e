"""Portfolio & strategy accounting (host-side pandas engine; a copy of
``porqua_tpu/portfolio.py``).

Weights are held as aligned numpy/Series data, drift is one vectorized
cumulative product per holding period, and the sleeve (margin/cash/loan)
arithmetic happens on the summed level. Turnover compares the drifted
old portfolio against the new weights, and the first rebalance books
the full initial acquisition as trading volume.

The vectorized tensor simulation lives in
:mod:`porqua_tpu_torch.accounting`; this module is the independent
behavioral model it is tested against.
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np
import pandas as pd


def floating_weights(X: pd.DataFrame, w, start_date, end_date,
                     rescale: bool = True) -> pd.DataFrame:
    """Drift weights ``w`` by cumulative asset returns.

    Row 0 (at ``start_date``) holds ``w`` itself; each later row is the
    previous row compounded by that day's returns. With ``rescale``,
    every row is renormalized so the long and short sides each sum to
    +/-1 of their own gross (the reference's long/short renormalization,
    ``portfolio.py:283-286``).
    """
    start = pd.to_datetime(start_date)
    end = pd.to_datetime(end_date)
    if start < X.index[0] or end > X.index[-1]:
        raise ValueError(
            f"the window [{start_date}, {end_date}] must lie inside the "
            f"return series range [{X.index[0]}, {X.index[-1]}]")

    w = pd.Series(w, dtype=float)
    if w.isna().any():
        raise ValueError("weights contain NaN")
    unknown = w.index.difference(X.columns)
    if len(unknown):
        raise ValueError(f"assets missing from the return series: "
                         f"{list(unknown[:5])}")

    window = X.loc[start:end, w.index]
    growth = 1.0 + np.nan_to_num(window.to_numpy(dtype=float))
    growth[0] = w.to_numpy()
    drift = np.cumprod(growth, axis=0)

    if rescale:
        longs = np.where(drift >= 0, drift, 0.0)
        shorts = drift - longs
        long_gross = longs.sum(axis=1, keepdims=True)
        short_gross = np.abs(shorts).sum(axis=1, keepdims=True)
        drift = (np.divide(longs, long_gross,
                           out=np.zeros_like(longs),
                           where=long_gross != 0)
                 + np.divide(shorts, short_gross,
                             out=np.zeros_like(shorts),
                             where=short_gross != 0))

    return pd.DataFrame(drift, index=window.index, columns=w.index)


class Portfolio:
    """One dated weight snapshot."""

    def __init__(self,
                 rebalancing_date: Optional[str] = None,
                 weights: Optional[dict] = None,
                 name: Optional[str] = None,
                 init_weights: Optional[dict] = None):
        if rebalancing_date is not None and not isinstance(
                rebalancing_date, str):
            raise TypeError("rebalancing_date must be a string (or None)")
        if name is not None and not isinstance(name, str):
            raise TypeError("name must be a string (or None)")
        self.rebalancing_date = rebalancing_date
        self._w = self._coerce(weights)
        self.name = name
        self.init_weights = dict(init_weights) if init_weights else {}
        self._initial_cache: dict = {}

    @staticmethod
    def _coerce(weights) -> pd.Series:
        if weights is None:
            return pd.Series(dtype=float)
        if isinstance(weights, pd.Series):
            return weights.astype(float)
        if isinstance(weights, dict):
            return pd.Series(weights, dtype=float)
        if hasattr(weights, "to_dict"):
            return pd.Series(weights.to_dict(), dtype=float)
        raise TypeError("weights must be dict-like")

    @staticmethod
    def empty() -> "Portfolio":
        return Portfolio()

    @property
    def weights(self) -> dict:
        return self._w.to_dict()

    @weights.setter
    def weights(self, value) -> None:
        self._w = self._coerce(value)
        self._initial_cache = {}

    def get_weights_series(self) -> pd.Series:
        return self._w.copy()

    def __repr__(self):
        return (f"Portfolio({self.rebalancing_date!r}, "
                f"{len(self._w)} assets)")

    def float_weights(self, return_series: pd.DataFrame, end_date: str,
                      rescale: bool = False):
        if self._w.empty:
            return None
        return floating_weights(
            return_series, self._w, self.rebalancing_date, end_date,
            rescale=rescale)

    def initial_weights(self,
                        selection,
                        return_series: pd.DataFrame,
                        end_date: str,
                        rescale: bool = True) -> Optional[dict]:
        """This portfolio's weights drifted to ``end_date``, expressed
        over ``selection`` (zeros for ids we never held). Memoized per
        (selection, end_date, rescale) argument combination."""
        if self.rebalancing_date is None or self._w.empty:
            return None
        key = (tuple(selection), end_date, rescale)
        if key not in self._initial_cache:
            drifted = self.float_weights(
                return_series, end_date, rescale=rescale).iloc[-1]
            out = pd.Series(0.0, index=list(selection))
            held = out.index.intersection(drifted.index)
            out[held] = drifted[held]
            self._initial_cache[key] = out.to_dict()
        return self._initial_cache[key]

    def turnover(self, portfolio: "Portfolio", return_series: pd.DataFrame,
                 rescale: bool = True) -> float:
        """L1 distance between the older portfolio drifted to the newer
        rebalance date and the newer portfolio's fresh weights."""
        mine = self.rebalancing_date
        theirs = portfolio.rebalancing_date
        older, newer = ((portfolio, self)
                        if theirs is not None and theirs < mine
                        else (self, portfolio))
        drifted = older.initial_weights(
            selection=list(newer._w.index),
            return_series=return_series,
            end_date=newer.rebalancing_date,
            rescale=rescale)
        diff = pd.Series(drifted).sub(newer._w, fill_value=0.0)
        return float(diff.abs().sum())


class Strategy:
    """An ordered collection of dated portfolios."""

    def __init__(self, portfolios: list):
        if not isinstance(portfolios, list) or any(
                not isinstance(p, Portfolio) for p in portfolios):
            raise TypeError("Strategy takes a list of Portfolio objects")
        self.portfolios = portfolios

    def __repr__(self):
        return f"Strategy({len(self.portfolios)} portfolios)"

    def clear(self) -> None:
        self.portfolios.clear()

    def get_rebalancing_dates(self) -> list:
        return [p.rebalancing_date for p in self.portfolios]

    def get_portfolio(self, rebalancing_date: str) -> Portfolio:
        for p in self.portfolios:
            if p.rebalancing_date == rebalancing_date:
                return p
        raise ValueError(
            f"no portfolio is dated {rebalancing_date!r}")

    def get_weights(self, rebalancing_date: str) -> Optional[dict]:
        for p in self.portfolios:
            if p.rebalancing_date == rebalancing_date:
                return p.weights
        return None

    def get_weights_df(self) -> pd.DataFrame:
        """(dates x assets) weight matrix, NaN where an asset was not
        in that date's universe."""
        return pd.DataFrame.from_dict(
            {p.rebalancing_date: p.weights for p in self.portfolios},
            orient="index")

    def has_previous_portfolio(self, rebalancing_date: str) -> bool:
        dates = self.get_rebalancing_dates()
        return bool(dates) and dates[0] < rebalancing_date

    def get_previous_portfolio(self, rebalancing_date: str) -> Portfolio:
        dates = self.get_rebalancing_dates()
        pos = bisect.bisect_left(dates, rebalancing_date)
        return self.portfolios[pos - 1] if pos else Portfolio.empty()

    def get_initial_portfolio(self, rebalancing_date: str) -> Portfolio:
        if self.has_previous_portfolio(rebalancing_date):
            return self.get_previous_portfolio(rebalancing_date)
        return Portfolio(rebalancing_date=None, weights={})

    def number_of_assets(self, th: float = 0.0001) -> pd.Series:
        return (self.get_weights_df().abs() > th).sum(axis=1)

    def turnover(self, return_series, rescale: bool = True) -> pd.Series:
        """Per-date traded volume. The first rebalance books the full
        initial acquisition (the reference's empty-previous branch
        degenerates to zero through a None end date)."""
        out = {}
        for p in self.portfolios:
            prev = self.get_previous_portfolio(p.rebalancing_date)
            if prev.rebalancing_date is None:
                out[p.rebalancing_date] = float(p._w.abs().sum())
            else:
                out[p.rebalancing_date] = p.turnover(
                    portfolio=prev, return_series=return_series,
                    rescale=rescale)
        return pd.Series(out)

    def simulate(self,
                 return_series: Optional[pd.DataFrame] = None,
                 fc: float = 0,
                 vc: float = 0,
                 n_days_per_year: int = 252) -> pd.Series:
        """Daily strategy returns net of costs.

        Per holding period: drift the weights (un-rescaled), add the
        constant margin/cash/loan sleeves implied by the period's
        long/short gross, and difference the summed level. Variable
        costs subtract turnover * ``vc`` at each rebalance; fixed costs
        compound ``fc`` over calendar-day gaps.

        The device-vectorized equivalent is
        :func:`porqua_tpu_torch.accounting.simulate`.
        """
        dates = self.get_rebalancing_dates()
        period_ends = dates[1:] + [return_series.index[-1]]

        pieces = []
        for date, period_end in zip(dates, period_ends):
            p = self.get_portfolio(date)
            drift = p.float_weights(return_series, period_end,
                                    rescale=False)
            w = p._w
            long_total = float(w[w >= 0].sum())
            short_total = float(w[w < 0].sum())
            margin = abs(short_total)
            cash = min(max(1.0 - long_total, 0.0), 1.0)
            loan = (1.0 - (long_total + cash)
                    - (short_total + margin))
            level = drift.sum(axis=1) + (margin + cash + loan)
            pieces.append(level.pct_change())
        returns = pd.concat(pieces).dropna()

        if vc != 0:
            traded = self.turnover(return_series=return_series,
                                   rescale=False) * vc
            missing = [d for d in traded.index[1:] if d not in returns.index]
            if missing:
                # Same convention as the reference (costs are charged on
                # the rebalance date's own return row), surfaced as a
                # diagnosis instead of a pandas KeyError deep in .loc.
                raise ValueError(
                    "variable costs are charged on rebalance dates, but "
                    f"{[str(d)[:10] for d in missing[:3]]}"
                    f"{'...' if len(missing) > 3 else ''} are not in the "
                    "return series — pick rebalance dates from the data's "
                    "index (trading days)")
            # The first rebalance date has no return row; its cost hits
            # the first available return instead.
            returns.iloc[0] -= traded.iloc[0]
            returns[traded.index[1:]] -= traded.iloc[1:].values
        if fc != 0:
            gaps = np.diff(returns.index.to_numpy()).astype(
                "timedelta64[D]").astype(int)
            returns.iloc[1:] -= (1 + fc) ** (gaps / n_days_per_year) - 1

        return returns
