"""Named-filter asset selection (host-side pandas; a copy of
``porqua_tpu/selection.py``).

Filters live in a flat registry of normalized frames, and the selected
universe is the intersection of the id sets each binary filter admits.
"""

from __future__ import annotations

from typing import Optional, Union

import pandas as pd


def _check_binary(values: pd.Series) -> pd.Series:
    bad = ~values.isin([0, 1])
    if bad.any():
        raise ValueError(
            f"binary filter values must be 0 or 1; offending ids: "
            f"{list(values.index[bad][:5])}")
    return values.astype(int)


class Selection:
    """Universe chooser: the ids admitted by every binary filter.

    Filters are pandas Series/DataFrames keyed by name. A Series named
    ``binary`` — or a frame column called ``binary`` — constrains the
    universe; other columns (scores, ranks) ride along for downstream
    consumers. Ids missing from any filter are excluded.
    """

    def __init__(self, ids: pd.Index = pd.Index([])):
        self._filters: dict = {}
        self.selected = ids

    @property
    def selected(self) -> pd.Index:
        return self._selected

    @selected.setter
    def selected(self, value):
        if not isinstance(value, pd.Index):
            raise ValueError("'selected' must be set to a pd.Index")
        self._selected = value

    @property
    def filtered(self) -> dict:
        return self._filters

    def clear(self) -> None:
        self._filters = {}
        self.selected = pd.Index([])

    def add_filtered(self,
                     filter_name: str,
                     value: Union[pd.Series, pd.DataFrame]) -> None:
        if not isinstance(filter_name, str) or not filter_name.strip():
            raise ValueError("'filter_name' must be a nonempty string")
        if isinstance(value, pd.Series):
            if value.name == "binary":
                value = _check_binary(value)
        elif isinstance(value, pd.DataFrame):
            if "binary" in value.columns:
                value = value.assign(binary=_check_binary(value["binary"]))
        else:
            raise ValueError(
                "a filter must be a pd.Series or a pd.DataFrame")
        self._filters[filter_name] = value
        self.selected = self.get_selected()

    def _binary_part(self, name: str) -> Optional[pd.Series]:
        """The 0/1 series a filter contributes, if any."""
        value = self._filters[name]
        if isinstance(value, pd.Series):
            return value if value.name == "binary" else None
        return value["binary"] if "binary" in value.columns else None

    def get_selected(self, filter_names: Optional[list] = None) -> pd.Index:
        """Ids present in every named filter and admitted (== 1) by
        every binary one, in sorted order."""
        names = list(self._filters) if filter_names is None else filter_names
        universe = None
        for name in names:
            idx = self._filters[name].index
            universe = idx if universe is None else universe.union(idx)
        if universe is None:
            return pd.Index([])
        admitted = universe.sort_values()
        for name in names:
            binary = self._binary_part(name)
            if binary is not None:
                admitted = admitted.intersection(
                    binary.index[binary == 1])
        return admitted

    def df(self, filter_names: Optional[list] = None) -> pd.DataFrame:
        """All filters side by side under a (filter, column) MultiIndex."""
        names = list(self._filters) if filter_names is None else filter_names
        blocks = {}
        for name in names:
            value = self._filters[name]
            blocks[name] = value.to_frame() if isinstance(
                value, pd.Series) else value
        return pd.concat(blocks, axis=1)

    def df_binary(self, filter_names: Optional[list] = None) -> pd.DataFrame:
        """One column per binary filter, restricted to ids every binary
        filter covers."""
        names = list(self._filters) if filter_names is None else filter_names
        cols = {name: binary for name in names
                if (binary := self._binary_part(name)) is not None}
        if not cols:
            return pd.DataFrame(index=self.get_selected(names))
        return pd.DataFrame(cols).dropna().astype(int)
