"""Cross-sectional rank-label construction shared by the ranking models
(a copy of ``porqua_tpu/models/labels.py``).

The reference builds decile labels from winsorized monthly returns with
``(-ret).rank()`` (reference ``example/ordinal_regression.ipynb`` cell 2,
``example/ml.ipynb`` cell 14). This helper is the single implementation
used by both the LTR scorer and the ordinal-regression workflow.

numpy/pandas only, so the host side of the LTR selection path needs no
torch to build its labels.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def rank_labels(returns, n_bins: int = 10, ascending: bool = True):
    """Even cross-sectional rank bins in ``0..n_bins-1``.

    ``ascending=True`` gives bin 0 to the lowest return;
    ``ascending=False`` matches the reference's ``(-ret).rank()``
    convention (bin 0 = highest return). Bins are even: the label is
    ``ceil(pct_rank * n_bins) - 1`` (a plain ``floor`` puts
    exact-boundary ranks in the wrong bin and makes the edge bins
    systematically half/oversized).

    Series input: NaNs are dropped from the result. DataFrame input:
    rows are ranked independently; if NaNs are present the result uses
    the nullable ``Int64`` dtype, otherwise plain ``int``.
    """
    pct = returns.rank(pct=True, ascending=ascending, method="first",
                       **({"axis": 1} if isinstance(returns, pd.DataFrame) else {}))
    raw = np.ceil(pct * n_bins) - 1
    clipped = raw.clip(0, n_bins - 1)
    if isinstance(returns, pd.Series):
        return clipped.dropna().astype(int)
    if clipped.isna().any().any():
        return clipped.astype("Int64")
    return clipped.astype(int)
