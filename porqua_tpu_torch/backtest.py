"""Rolling-rebalance backtest engine (host-side orchestration; a copy of
``porqua_tpu/backtest.py`` with the solve device made explicit).

The service holds data, per-date builder hooks, the optimizer and
settings, validated once at construction; rebalance failures propagate
with their original traceback. Two execution modes:

* :meth:`Backtest.run` — the serial loop, one solve per date;
* the batched path in :mod:`porqua_tpu_torch.batch` — pass 1 runs all
  builders host-side into padded (dates x ...) tensors, pass 2 solves
  every date in one batched solve.

Both solve on the card unless the caller passes ``device``.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Optional

import pandas as pd

from porqua_tpu_torch.builders import OptimizationItemBuilder, SelectionItemBuilder
from porqua_tpu_torch.constraints import Constraints
from porqua_tpu_torch.optimization import EmptyOptimization, Optimization
from porqua_tpu_torch.optimization_data import OptimizationData
from porqua_tpu_torch.portfolio import Portfolio, Strategy
from porqua_tpu_torch.selection import Selection


class BacktestData(dict):
    """Loose data bag (return_series, bm_series, volume_series, ...).

    The reference ships an empty marker class and its notebooks pass
    plain dicts; a dict subclass accepts both styles."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def _expect(value, kind, what: str):
    if not isinstance(value, kind):
        raise TypeError(f"{what} must be a {kind.__name__}, "
                        f"got {type(value).__name__}")
    return value


class BacktestService:
    """Everything one backtest needs: data, per-date builder hooks, the
    optimizer, and settings. Builders run per rebalance date in two
    stages — selection filters first, then optimization items against
    the fresh constraint set. Validation happens once, here, instead of
    through per-attribute property setters."""

    def __init__(self, data, selection_item_builders,
                 optimization_item_builders, optimization=None,
                 settings=None, **kwargs):
        self.data = data
        self.optimization = (EmptyOptimization() if optimization is None
                             else _expect(optimization, Optimization,
                                          "'optimization'"))
        _expect(selection_item_builders, dict, "'selection_item_builders'")
        for v in selection_item_builders.values():
            _expect(v, SelectionItemBuilder,
                    "each selection item builder")
        _expect(optimization_item_builders, dict,
                "'optimization_item_builders'")
        for v in optimization_item_builders.values():
            _expect(v, OptimizationItemBuilder,
                    "each optimization item builder")
        self.selection_item_builders = selection_item_builders
        self.optimization_item_builders = optimization_item_builders
        self.settings = dict(settings) if settings else {}
        self.settings.update(kwargs)
        self.selection = Selection()
        self.optimization_data = OptimizationData([])

    def build_selection(self, rebdate: str) -> None:
        for name, builder in self.selection_item_builders.items():
            builder.arguments["item_name"] = name
            builder(self, rebdate)

    def build_optimization(self, rebdate: str) -> None:
        # Fresh constraint set over the universe selection just decided.
        self.optimization.constraints = Constraints(
            selection=self.selection.selected)
        for builder in self.optimization_item_builders.values():
            builder(self, rebdate)

    def prepare_rebalancing(self, rebalancing_date: str) -> None:
        self.build_selection(rebdate=rebalancing_date)
        self.build_optimization(rebdate=rebalancing_date)


class Backtest:
    """Serial rebalance driver + output store."""

    def __init__(self) -> None:
        self._strategy = Strategy([])
        self._output: dict = {}

    @property
    def strategy(self) -> Strategy:
        return self._strategy

    @property
    def output(self) -> dict:
        return self._output

    def append_output(self, date_key=None, output_key=None, value=None):
        if value is None:
            return True
        slot = self._output.setdefault(date_key, {})
        if output_key in slot:
            warnings.warn(
                f"overwriting output {output_key!r} for {date_key!r}")
        slot[output_key] = value
        return True

    def rebalance(self, bs: BacktestService, rebalancing_date: str,
                  device=None) -> None:
        """One date: selection -> constraints -> objective -> solve on
        ``device`` (default: the card). Exceptions propagate
        unwrapped."""
        bs.prepare_rebalancing(rebalancing_date=rebalancing_date)
        bs.optimization.set_objective(optimization_data=bs.optimization_data)
        bs.optimization.solve(device=device)

    def run(self, bs: BacktestService, device=None) -> None:
        """Serial loop over the rebalance dates, each solved on
        ``device`` (default: the card; with no card and no ``device``
        it raises). The previous successful weights are kept in
        ``bs.settings['prev_weights']`` for turnover builders."""
        for date in bs.settings["rebdates"]:
            if not bs.settings.get("quiet"):
                print(f"Rebalancing date: {date}")

            self.rebalance(bs=bs, rebalancing_date=date, device=device)

            weights = bs.optimization.results["weights"]
            self.strategy.portfolios.append(
                Portfolio(rebalancing_date=date, weights=weights))

            if bs.optimization.results.get("status"):
                bs.settings["prev_weights"] = weights

            hook = bs.settings.get("append_fun")
            if hook is not None:
                hook(backtest=self, bs=bs, rebalancing_date=date,
                     what=bs.settings.get("append_fun_args"))

    def save(self, filename: str, path: Optional[str] = None) -> None:
        target = os.path.join(path, filename) if path else filename
        with open(target, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(filename: str, path: Optional[str] = None) -> "Backtest":
        """(The reference's pickle loader passes the path string to
        ``pickle.load`` — ``qp_problems.py:229-230`` — fixed here.)"""
        target = os.path.join(path, filename) if path else filename
        with open(target, "rb") as f:
            return pickle.load(f)


def append_custom(backtest: Backtest,
                  bs: BacktestService,
                  rebalancing_date: Optional[str] = None,
                  what: Optional[list] = None) -> None:
    """Per-date output recorder for percentile backtests: stores each
    bucket's weight Series (key ``weights_<bucket>``) and any other
    requested result fields."""
    for key in (what if what is not None else ["w_dict", "objective"]):
        if key == "w_dict":
            for bucket, bucket_weights in \
                    bs.optimization.results["w_dict"].items():
                backtest.append_output(
                    date_key=rebalancing_date,
                    output_key=f"weights_{bucket}",
                    value=pd.Series(dict(bucket_weights)))
        elif key in bs.optimization.results:
            backtest.append_output(
                date_key=rebalancing_date,
                output_key=key,
                value=bs.optimization.results[key])
