"""Shared plumbing for the examples: the MSCI universe or its synthetic
stand-in, the reference's quarterly rebalance dates, and the command
line every example takes (``--device``).

The JAX package's examples pick a platform through ``init_platform``;
here each ``main`` takes a ``device`` instead (the card by default).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd

# The MSCI data directory (the reference's data/ folder), where one is
# named.
REFERENCE_DATA = os.environ.get("PORQUA_DATA", "")


def load_msci_or_synthetic():
    """The 24-country MSCI universe if the data mount exists, else a
    synthetic factor market of the same shape (the JAX examples' own
    draws from ``np.random.default_rng(0)``)."""
    from porqua_tpu_torch.data_loader import load_data_msci

    if REFERENCE_DATA and os.path.isdir(REFERENCE_DATA):
        return load_data_msci(path=REFERENCE_DATA)
    rng = np.random.default_rng(0)
    dates = pd.bdate_range("1999-01-01", periods=6000)
    n = 24
    X = pd.DataFrame(0.01 * rng.standard_normal((len(dates), n)),
                     index=dates, columns=[f"A{i}" for i in range(n)])
    w = rng.dirichlet(np.ones(n))
    y = pd.DataFrame({"bm": X.to_numpy() @ w
                      + 0.001 * rng.standard_normal(len(dates))},
                     index=dates)
    return {"return_series": X, "bm_series": y}


def quarterly_rebdates(index: pd.Index, start: str = "2015-01-01", k: int = 24):
    """Quarter-end rebalance dates inside the index (the reference's
    canonical cadence, ``_quick_and_dirty_interactive_testing.py:75-79``)."""
    qe = pd.Series(index=index, data=1).resample("QE").last().index
    dates = [str(index[index <= d][-1].date()) for d in qe
             if str(start) <= str(d.date()) and (index <= d).any()]
    return dates[:k]


def parse_device(description: str, argv=None):
    """``--device`` (default: the card) from the command line."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    return ap.parse_args(argv).device


# The JAX goldens of the examples (``testdata/examples_golden.npz``,
# written by ``scripts/torch_examples_golden.py``) hold each example's
# returned numbers under ``<example>/<cut>/<key>``: numbers and arrays
# as arrays, anything else (names, dicts) as JSON under ``<key>#json``.

def pack_golden(prefix: str, values: dict) -> dict:
    """``values`` as npz entries under ``prefix``."""
    import json

    out = {}
    for key, v in values.items():
        if isinstance(v, (dict, list, tuple, str)) and not (
                isinstance(v, (list, tuple)) and v
                and all(isinstance(e, (int, float)) for e in v)):
            out[f"{prefix}/{key}#json"] = np.asarray(json.dumps(v))
        else:
            out[f"{prefix}/{key}"] = np.asarray(v)
    return out


def unpack_golden(arrays, prefix: str) -> dict:
    """The ``values`` that :func:`pack_golden` stored under ``prefix``:
    0-d numbers as Python floats, arrays as arrays."""
    import json

    out = {}
    for name in arrays.files:
        if not name.startswith(prefix + "/"):
            continue
        key = name[len(prefix) + 1:]
        v = arrays[name]
        if key.endswith("#json"):
            out[key[:-5]] = json.loads(str(v))
        elif v.ndim == 0 and v.dtype.kind in "fiub":
            out[key] = v.item()
        else:
            out[key] = v
    return out
