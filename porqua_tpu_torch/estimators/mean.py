"""Expected-return estimation on tensors (the estimators of
``porqua_tpu/estimators/mean.py``).

Geometric mean of returns with momentum/reversal windowing: keep the
last ``n_mom`` observations, drop the most recent ``n_rev``. The
windows are static, so the tensor path batches over leading axes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch


def geometric_mean(X: torch.Tensor,
                   n_mom: Optional[int] = None,
                   n_rev: int = 0,
                   scalefactor: float = 1.0) -> torch.Tensor:
    """mu = exp(mean(log(1 + X_window)) * scalefactor) - 1 over axis -2."""
    T = X.shape[-2]
    n_mom = T if n_mom is None else int(n_mom)
    start = max(T - n_mom, 0)
    stop = start + max(n_mom - n_rev, 0)
    window = X[..., start:stop, :]
    return torch.exp(torch.log1p(window).mean(dim=-2) * scalefactor) - 1.0


def _as_tensor(X):
    if isinstance(X, torch.Tensor):
        return X
    return torch.tensor(np.asarray(X, dtype=np.float64))


class MeanEstimator:
    """Spec-dict dispatch estimator."""

    def __init__(self, **kwargs) -> None:
        self.spec = {
            "method": "geometric",
            "scalefactor": 1,
            "n_mom": None,
            "n_rev": None,
        }
        self.spec.update(kwargs)

    def estimate_array(self, X: torch.Tensor) -> torch.Tensor:
        fun = getattr(self, f'estimate_{self.spec["method"]}', None)
        if fun is None:
            raise NotImplementedError(
                f'mean estimation method {self.spec["method"]!r} is not implemented'
            )
        return fun(X)

    def estimate(self, X):
        """DataFrame in -> Series out (float64 on the CPU); anything
        else -> a tensor."""
        if isinstance(X, pd.DataFrame):
            out = self.estimate_array(_as_tensor(X.to_numpy(dtype=np.float64)))
            return pd.Series(out.numpy(), index=X.columns)
        return self.estimate_array(_as_tensor(X))

    def estimate_geometric(self, X: torch.Tensor) -> torch.Tensor:
        n_mom = self.spec.get("n_mom")
        n_rev = self.spec.get("n_rev") or 0
        scalefactor = self.spec.get("scalefactor") or 1
        return geometric_mean(X, n_mom=n_mom, n_rev=n_rev, scalefactor=scalefactor)

    def estimate_arithmetic(self, X: torch.Tensor) -> torch.Tensor:
        """Simple mean over the same momentum/reversal window."""
        T = X.shape[-2]
        n_mom = self.spec.get("n_mom") or T
        n_rev = self.spec.get("n_rev") or 0
        scalefactor = self.spec.get("scalefactor") or 1
        start = max(T - n_mom, 0)
        stop = start + max(n_mom - n_rev, 0)
        return X[..., start:stop, :].mean(dim=-2) * scalefactor
