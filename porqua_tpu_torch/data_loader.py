"""Data loading (a host copy of ``porqua_tpu/data_loader.py``, pandas and
pickle only; the mirror of reference ``src/data_loader.py``).

The reference loader is out of sync with its own data files (reads with
``sep=';'`` at ``data_loader.py:40,50`` while the shipped CSVs are
comma-separated — SURVEY.md section 2); this version sniffs the
delimiter so both layouts load.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional, Union

import numpy as np
import pandas as pd


def load_pickle(filename: str, path: Optional[str] = None) -> Union[Any, None]:
    if path is not None:
        filename = os.path.join(path, filename)
    try:
        with open(filename, "rb") as f:
            return pickle.load(f)
    except EOFError:
        print("Error: Ran out of input. The file may be empty or corrupted.")
        return None
    except Exception as ex:
        print("Error during unpickling object:", ex)
    return None


def _read_indexed_csv(path: str) -> pd.DataFrame:
    df = pd.read_csv(path, sep=None, engine="python", index_col=0, header=0)
    # Shipped CSVs use dd-mm-yyyy (MSCI/NDDLWI) or dd/mm/yyyy (SPTR).
    parsed = pd.to_datetime(df.index, format="%d-%m-%Y", errors="coerce")
    alt = pd.to_datetime(df.index, format="%d/%m/%Y", errors="coerce")
    df.index = pd.DatetimeIndex(np.where(parsed.notna(), parsed, alt))
    df = df[df.index.notna()]
    return df.astype(float)


def load_data_msci(path: Optional[str] = None, n: int = 24) -> dict:
    """MSCI country daily returns (1999-01-01 -> 2023-04-18) + NDDLWI
    world-index benchmark (reference ``data_loader.py:33-57``)."""
    path = os.path.join(os.getcwd(), f"data{os.sep}") if path is None else path
    df = _read_indexed_csv(os.path.join(path, "msci_country_indices.csv"))
    X = df[df.columns[0:n]]
    y = _read_indexed_csv(os.path.join(path, "NDDLWI.csv"))
    return {"return_series": X, "bm_series": y}


def load_data_sptr(path: Optional[str] = None) -> pd.DataFrame:
    """S&P 500 TR daily returns 1996-> (reference ``data/SPTR.csv``)."""
    path = os.path.join(os.getcwd(), f"data{os.sep}") if path is None else path
    return _read_indexed_csv(os.path.join(path, "SPTR.csv"))
