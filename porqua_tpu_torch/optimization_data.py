"""Named time-series container for one optimization problem (host-side
pandas; a copy of ``porqua_tpu/optimization_data.py``).

Alignment is one inner-join over the collected indexes, and a
chronological ``train_test_split`` is provided. The batched backtest
consumes the aligned windows as padded arrays.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional

import pandas as pd


class OptimizationData(dict):
    """Dict of named pandas series/frames sharing one date index.

    Keys double as attributes for reads (``od.return_series`` ==
    ``od['return_series']``), matching the reference container's
    notebook-facing ergonomics."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __init__(self, align=True, lags={}, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for key, lag in lags.items():
            self[key] = self[key].shift(lag)
        if align and self:
            self.align_dates()

    def align_dates(self, variable_names: Optional[list] = None,
                    dropna: bool = True) -> None:
        """Restrict the named series (default: all) to their common
        dates, optionally dropping NaN rows first."""
        names = list(self.keys()) if variable_names is None \
            else list(variable_names)
        common = self.intersecting_dates(names, dropna=dropna)
        self.update({k: self[k].loc[common] for k in names})

    def intersecting_dates(self,
                           variable_names: Optional[list] = None,
                           dropna: bool = True) -> pd.Index:
        names = list(self.keys()) if variable_names is None \
            else list(variable_names)
        if dropna:
            for k in names:
                self[k] = self[k].dropna()
        return reduce(lambda idx, k: idx.intersection(self[k].index),
                      names[1:], self[names[0]].index)

    def train_test_split(self, test_size: float = 0.2,
                         keys: Optional[list] = None):
        """Chronological train/test split of every (or selected) series."""
        keys = list(self.keys()) if keys is None else keys
        cut = int(round(len(self[keys[0]].index) * (1.0 - test_size)))
        return (
            OptimizationData(
                align=False, **{k: self[k].iloc[:cut] for k in keys}),
            OptimizationData(
                align=False, **{k: self[k].iloc[cut:] for k in keys}),
        )
