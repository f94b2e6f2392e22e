"""Backtest item builders — the per-rebalance-date plug-in API (a copy
of ``porqua_tpu/builders.py``).

A builder is a stored callable plus its keyword arguments; the callable
convention is ``bibfn(bs, rebdate, **kwargs)``. Selection builders
return a named filter, optimization builders mutate the service.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import pandas as pd


class BacktestItemBuilder:
    """A per-date hook: ``bibfn`` plus the kwargs it is called with.

    ``arguments`` is a plain mutable dict; the backtest loop injects
    ``item_name`` into it before each call.
    """

    def __init__(self, bibfn: Optional[Callable] = None, **kwargs):
        self._arguments = dict(kwargs, bibfn=bibfn)

    @property
    def arguments(self) -> dict:
        return self._arguments

    @arguments.setter
    def arguments(self, value: dict) -> None:
        self._arguments = value

    def _fn(self) -> Callable:
        fn = self._arguments.get("bibfn")
        if not callable(fn):
            raise ValueError(
                f"{type(self).__name__} needs a callable 'bibfn'")
        return fn

    def __call__(self, bs, rebdate: str) -> None:
        raise NotImplementedError


class SelectionItemBuilder(BacktestItemBuilder):
    """Runs its bibfn and registers the returned Series/DataFrame as a
    named selection filter."""

    def __call__(self, bs, rebdate: str) -> None:
        item = self._fn()(bs=bs, rebdate=rebdate, **self.arguments)
        bs.selection.add_filtered(
            filter_name=self.arguments.get("item_name"), value=item)


class OptimizationItemBuilder(BacktestItemBuilder):
    """Runs its bibfn for side effects on the service (optimization
    data windows, constraint rows)."""

    def __call__(self, bs, rebdate: str) -> None:
        self._fn()(bs=bs, rebdate=rebdate, **self.arguments)


# --------------------------------------------------------------------------
# Selection bibfns
# --------------------------------------------------------------------------

def bibfn_selection_data(bs, rebdate: str, **kwargs) -> pd.Series:
    """Admit every asset the return series covers."""
    returns = bs.data.get("return_series")
    if returns is None:
        raise ValueError("the service data lacks 'return_series'")
    return pd.Series(1, index=returns.columns, name="binary")


def bibfn_selection_min_volume(bs, rebdate: str, **kwargs) -> pd.Series:
    """Admit assets whose aggregate trailing volume clears a floor."""
    width = kwargs.get("width", 365)
    agg_fn = kwargs.get("agg_fn", np.median)
    floor = kwargs.get("min_volume", 500_000)

    volume = bs.data.get("volume_series")
    if volume is None:
        raise ValueError("the service data lacks 'volume_series'")
    trailing = volume.loc[volume.index <= rebdate].tail(width).fillna(0)
    admitted = trailing.apply(agg_fn, axis=0) >= floor
    return admitted.astype(int).rename("binary")


def bibfn_selection_ltr(bs, rebdate: str, **kwargs) -> pd.DataFrame:
    """Learning-to-rank scoring filter. It needs the ranking models
    (``porqua_tpu/models/``), which are not ported yet."""
    raise NotImplementedError(
        "bibfn_selection_ltr needs the learning-to-rank models, which are "
        "not ported to PyTorch yet (ROADMAP queue A, item 20)")


# --------------------------------------------------------------------------
# Optimization-data bibfns
# --------------------------------------------------------------------------

def _trailing_weekdays(frame: pd.DataFrame, rebdate: str,
                       width: Optional[int]) -> pd.DataFrame:
    """Last ``width`` rows at or before ``rebdate``, weekends dropped."""
    window = frame.loc[frame.index <= rebdate].tail(width)
    return window.loc[window.index.dayofweek < 5]


def bibfn_return_series(bs, rebdate: str, **kwargs) -> None:
    """Trailing return window over the selected universe."""
    returns = bs.data.get("return_series")
    if returns is None:
        raise ValueError("the service data lacks 'return_series'")
    window = _trailing_weekdays(returns, rebdate, kwargs.get("width"))
    bs.optimization_data["return_series"] = window[bs.selection.selected]


def bibfn_bm_series(bs, rebdate: str, **kwargs) -> None:
    """Trailing benchmark window, optionally date-aligned with the
    return window."""
    bm = bs.data.get("bm_series")
    if bm is None:
        raise ValueError("the service data lacks 'bm_series'")
    bs.optimization_data["bm_series"] = _trailing_weekdays(
        bm, rebdate, kwargs.get("width"))
    if kwargs.get("align"):
        bs.optimization_data.align_dates(
            variable_names=["bm_series", "return_series"], dropna=True)


def bibfn_scores(bs, rebdate: str, **kwargs) -> None:
    """Expose the latest row of a scores frame over the universe."""
    scores = bs.data.get("scores")
    if scores is None:
        raise ValueError("the service data lacks 'scores'")
    if isinstance(scores, pd.DataFrame):
        latest = scores.loc[scores.index <= rebdate].iloc[[-1]]
        scores = latest[bs.selection.selected].T.squeeze(
            axis=1).to_frame("score")
    bs.optimization_data["scores"] = scores


# --------------------------------------------------------------------------
# Constraint bibfns
# --------------------------------------------------------------------------

def bibfn_budget_constraint(bs, rebdate: str, **kwargs) -> None:
    bs.optimization.constraints.add_budget(
        rhs=kwargs.get("budget", 1), sense="=")


def bibfn_box_constraints(bs, rebdate: str, **kwargs) -> None:
    bs.optimization.constraints.add_box(
        box_type=kwargs.get("box_type", "LongOnly"),
        lower=kwargs.get("lower", 0),
        upper=kwargs.get("upper", 1))


def bibfn_turnover_constraint(bs, rebdate: str, **kwargs) -> None:
    """Turnover budget vs the previous portfolio (read from
    ``bs.settings['prev_weights']``, maintained by the backtest loop)."""
    bs.optimization.constraints.add_l1(
        "turnover",
        rhs=kwargs.get("turnover_budget", 1.0),
        x0=dict(bs.settings.get("prev_weights") or {}))


def bibfn_leverage_constraint(bs, rebdate: str, **kwargs) -> None:
    bs.optimization.constraints.add_l1(
        "leverage", rhs=kwargs.get("leverage_budget", 2.0))
