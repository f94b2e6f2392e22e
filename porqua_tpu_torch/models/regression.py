"""Return-prediction regression workflows: OLS, PCA, PCA+OLS, boosting
(a port of ``porqua_tpu/models/regression.py``).

The reference's per-stock return-prediction notebook (reference
``example/ml.ipynb`` cells 5-13): OLS on the firm characteristic panel,
a PCA scree + PCA(n)+OLS pipeline, and a gradient-boosted regressor
chosen by grid search. The linear models run their SVDs on the device
the caller names (the card by default); the boosted model stays on the
host on sklearn, imported where it is used, off the hot path.

Prediction quality is scored with the RMSE/MAPE helpers the reference
defines in ``example/ml.ipynb`` cell 1 and ``src/helper_functions.py:105``
— re-exported here from :mod:`porqua_tpu_torch.utils.helpers`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from porqua_tpu_torch.qp.canonical import HP
from porqua_tpu_torch.qp.solve import resolve_device
from porqua_tpu_torch.utils.helpers import calculate_mape, calculate_rmse

__all__ = [
    "OLS",
    "PCA",
    "PCAOLS",
    "boosted_regression",
    "calculate_rmse",
    "calculate_mape",
]


def _lstsq_fit(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution through an SVD, with
    singular values below ``eps * max(M, N) * s_max`` cut, as
    ``jnp.linalg.lstsq`` computes it. (On the card ``torch.linalg.lstsq``
    has only the ``gels`` driver, which assumes full rank.)"""
    HP.check()
    u, s, vt = torch.linalg.svd(X, full_matrices=False)
    rcond = torch.finfo(X.dtype).eps * max(X.shape)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    b = y[:, None] if y.ndim == 1 else y
    coef = vt.T @ (s_inv[:, None] * (u.T @ b))
    return coef[:, 0] if y.ndim == 1 else coef


@dataclasses.dataclass
class OLS:
    """Least-squares regression (``sm.OLS`` in the notebook, cell 5).

    ``add_constant=True`` prepends an intercept column — the notebook's
    (commented) ``sm.add_constant``. The fit is an SVD-based ``lstsq``,
    so a minimum-norm solution exists even for rank-deficient panels.
    """

    add_constant: bool = False
    device: Optional[object] = dataclasses.field(default=None, kw_only=True)
    coef_: Optional[np.ndarray] = None

    def _design(self, X):
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32,
                            device=resolve_device(self.device))
        if self.add_constant:
            X = torch.cat([torch.ones((X.shape[0], 1), dtype=X.dtype,
                                      device=X.device), X], dim=1)
        return X

    def fit(self, X, y) -> "OLS":
        HP.apply()
        Xd = self._design(X)
        yd = torch.as_tensor(np.asarray(y), dtype=torch.float32,
                             device=Xd.device)
        self.coef_ = _lstsq_fit(Xd, yd).cpu().numpy()
        return self

    def predict(self, X) -> np.ndarray:
        if self.coef_ is None:
            raise RuntimeError("call fit() first")
        Xd = self._design(X)
        return (Xd @ torch.as_tensor(self.coef_, device=Xd.device)).cpu().numpy()


@dataclasses.dataclass
class PCA:
    """Principal components with standardization (notebook cell 8).

    Mirrors ``StandardScaler().fit_transform`` + ``sklearn PCA``: the
    fit centers/scales each feature, takes the SVD on the device, and
    keeps ``n_components`` right-singular directions (each fixed up to
    its sign, as in the JAX package); ``explained_variance_ratio_``
    reproduces the notebook's scree plot data.
    """

    n_components: int = 15
    standardize: bool = True
    device: Optional[object] = dataclasses.field(default=None, kw_only=True)

    mean_: Optional[np.ndarray] = None
    scale_: Optional[np.ndarray] = None
    components_: Optional[np.ndarray] = None
    explained_variance_ratio_: Optional[np.ndarray] = None

    def fit(self, X) -> "PCA":
        HP.apply()
        X = np.asarray(X, np.float32)
        self.mean_ = X.mean(axis=0)
        self.scale_ = (X.std(axis=0, ddof=0) if self.standardize
                       else np.ones(X.shape[1], np.float32))
        self.scale_ = np.where(self.scale_ == 0, 1.0, self.scale_)
        Z = torch.as_tensor((X - self.mean_) / self.scale_,
                            device=resolve_device(self.device))
        _, s, vt = torch.linalg.svd(Z, full_matrices=False)
        var = s.cpu().numpy() ** 2 / max(X.shape[0] - 1, 1)
        self.explained_variance_ratio_ = var / var.sum()
        self.components_ = vt[: self.n_components].cpu().numpy()
        return self

    def transform(self, X) -> np.ndarray:
        if self.components_ is None:
            raise RuntimeError("call fit() first")
        Z = (np.asarray(X, np.float32) - self.mean_) / self.scale_
        return Z @ self.components_.T

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)


@dataclasses.dataclass
class PCAOLS:
    """PCA(n) + OLS pipeline (notebook cell 9)."""

    n_components: int = 15
    standardize: bool = True
    add_constant: bool = False
    device: Optional[object] = dataclasses.field(default=None, kw_only=True)

    pca_: Optional[PCA] = None
    ols_: Optional[OLS] = None

    def fit(self, X, y) -> "PCAOLS":
        self.pca_ = PCA(self.n_components, standardize=self.standardize,
                        device=self.device).fit(X)
        self.ols_ = OLS(add_constant=self.add_constant,
                        device=self.device).fit(self.pca_.transform(X), y)
        return self

    def predict(self, X) -> np.ndarray:
        if self.ols_ is None:
            raise RuntimeError("call fit() first")
        return self.ols_.predict(self.pca_.transform(X))


def boosted_regression(X_train, y_train,
                       param_grid: Optional[dict] = None,
                       cv: int = 3,
                       seed: int = 20):
    """Grid-searched gradient-boosted regressor (notebook cells 10-11).

    Host-side sklearn surrogate for the reference's
    ``GridSearchCV(XGBRegressor)``; returns the refit best estimator
    (exposing ``.predict``) plus the chosen parameters and CV RMSE.
    """
    from sklearn.ensemble import HistGradientBoostingRegressor
    from sklearn.model_selection import GridSearchCV

    if param_grid is None:
        param_grid = {
            "max_depth": [3, 6],
            "learning_rate": [0.05],
            "max_iter": [200, 400],
        }
    search = GridSearchCV(
        HistGradientBoostingRegressor(random_state=seed),
        param_grid=param_grid,
        scoring="neg_mean_squared_error",
        cv=cv,
    )
    search.fit(np.asarray(X_train), np.asarray(y_train))
    best_rmse = float(np.sqrt(-search.best_score_))
    return search.best_estimator_, search.best_params_, best_rmse
