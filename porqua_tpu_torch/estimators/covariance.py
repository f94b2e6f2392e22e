"""Covariance estimation on tensors, batchable over leading axes.

The estimators of ``porqua_tpu/estimators/covariance.py`` (``pearson``
sample covariance, ``duv`` identity, ``linear_shrinkage`` ridge,
``ledoit_wolf``) as functions of a (..., T, N) return tensor, with the
PSD repair as the closed-form eigenvalue clip
(:func:`porqua_tpu_torch.utils.psd.project_psd`). The
:class:`Covariance` class keeps the host-side, pandas-friendly
interface (DataFrame in, DataFrame out), computing in float64 on the
CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from porqua_tpu_torch.utils.psd import is_psd, project_psd


def _eye_like(X, n):
    return torch.eye(n, dtype=X.dtype, device=X.device)


def cov_pearson(X: torch.Tensor) -> torch.Tensor:
    """Sample covariance with T-1 normalization (pandas ``X.cov()``)."""
    T = X.shape[-2]
    Xc = X - X.mean(dim=-2, keepdim=True)
    return torch.matmul(Xc.transpose(-1, -2), Xc) / (T - 1)


def cov_duv(X: torch.Tensor) -> torch.Tensor:
    """Identity ("don't use variance")."""
    n = X.shape[-1]
    return _eye_like(X, n).expand(X.shape[:-2] + (n, n))


def _sanitize_lambda(lambda_reg: Optional[float]) -> float:
    """Ridge intensity: None/NaN/negative -> 0 (shared by the dense
    estimator and the factor form)."""
    if lambda_reg is None or np.isnan(lambda_reg) or lambda_reg < 0:
        return 0.0
    return float(lambda_reg)


def cov_linear_shrinkage(X: torch.Tensor,
                         lambda_reg: Optional[float] = None) -> torch.Tensor:
    """Sample covariance + lambda * mean(sigma^2) * I ridge."""
    sigmat = cov_pearson(X)
    lambda_reg = _sanitize_lambda(lambda_reg)
    if lambda_reg > 0:
        d = sigmat.shape[-1]
        sig2 = torch.diagonal(sigmat, dim1=-2, dim2=-1)
        sigmat = sigmat + (lambda_reg * sig2.mean(dim=-1))[..., None, None] \
            * _eye_like(X, d)
    return sigmat


def ledoit_wolf_params(X: torch.Tensor):
    """(shrink, mu, S): the Ledoit-Wolf intensity, the identity target's
    scale and the MLE sample covariance."""
    T, n = X.shape[-2], X.shape[-1]
    S = cov_pearson(X) * (T - 1) / T
    Xc = X - X.mean(dim=-2, keepdim=True)

    mu = torch.diagonal(S, dim1=-2, dim2=-1).sum(dim=-1)[..., None, None] / n
    d2 = ((S - mu * _eye_like(X, n)) ** 2).sum(dim=(-2, -1))
    # b2 = (1/T^2) sum_t || x_t x_t' - S ||_F^2, whose first term is
    # ||x_t||^4. The reference computes it as (sum_i x_ti)^4 (an einsum
    # "ti,tj->t" sums i and j independently); the port keeps that
    # arithmetic so the two agree (ROADMAP section C).
    xxT_norms = (Xc.sum(dim=-1) ** 2) ** 2
    cross = (torch.matmul(Xc, S) * Xc).sum(dim=-1)
    b2_raw = (xxT_norms.sum(dim=-1) - 2 * cross.sum(dim=-1)
              + T * (S * S).sum(dim=(-2, -1))) / T**2
    b2 = torch.minimum(b2_raw, d2)
    shrink = torch.where(d2 > 0, b2 / torch.clamp_min(d2, 1e-30),
                         torch.zeros_like(d2))
    return shrink, mu, S


def cov_ledoit_wolf(X: torch.Tensor) -> torch.Tensor:
    """Ledoit-Wolf (2004) shrinkage toward the scaled identity."""
    n = X.shape[-1]
    shrink, mu, S = ledoit_wolf_params(X)
    return (shrink[..., None, None] * mu * _eye_like(X, n)
            + (1.0 - shrink)[..., None, None] * S)


_METHODS = {
    "pearson": lambda X, spec: cov_pearson(X),
    "duv": lambda X, spec: cov_duv(X),
    "linear_shrinkage": lambda X, spec: cov_linear_shrinkage(
        X, spec.get("lambda_covmat_regularization")
    ),
    "ledoit_wolf": lambda X, spec: cov_ledoit_wolf(X),
}


class CovarianceSpecification(dict):
    """Config dict with attribute access."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self
        if self.get("method") is None:
            self["method"] = "pearson"
        if self.get("check_positive_definite") is None:
            self["check_positive_definite"] = True


def _as_tensor(X):
    if isinstance(X, torch.Tensor):
        return X
    return torch.tensor(np.asarray(X, dtype=np.float64))


class Covariance:
    """Host-friendly estimator wrapper."""

    def __init__(self, spec: Optional[CovarianceSpecification] = None, *args, **kwargs):
        self.spec = CovarianceSpecification(*args, **kwargs) if spec is None else spec

    def set_ctrl(self, *args, **kwargs) -> None:
        self.spec = CovarianceSpecification(*args, **kwargs)

    def estimate_array(self, X: torch.Tensor) -> torch.Tensor:
        """Tensor path (any device, batchable)."""
        method = self.spec["method"]
        if method not in _METHODS:
            raise NotImplementedError(f"covariance method {method!r} is not implemented")
        covmat = _METHODS[method](X, self.spec)
        if self.spec.get("check_positive_definite"):
            ok = is_psd(covmat)[..., None, None]
            covmat = torch.where(ok, covmat, project_psd(covmat, jitter=1e-12))
        return covmat

    def estimate(self, X):
        """Pandas-friendly path: DataFrame in -> DataFrame out (float64
        on the CPU); anything else -> a tensor."""
        if isinstance(X, pd.DataFrame):
            cols = X.columns
            out = self.estimate_array(_as_tensor(X.to_numpy(dtype=np.float64)))
            return pd.DataFrame(out.numpy(), index=cols, columns=cols)
        return self.estimate_array(_as_tensor(X))

    def factor(self, X):
        """Low-rank form ``Sigma == F' F + diag(d)`` of the estimate as
        numpy ``(F, d)`` with F of shape (r, n), or ``None`` when the
        method has no such structure. Every shipped estimator is
        (shifted) Gram-structured, so the factor exists with r = T rows
        (0 for ``duv``)."""
        if isinstance(X, pd.DataFrame):
            X = X.to_numpy(dtype=np.float64)
        X = np.asarray(X, dtype=np.float64)
        T, n = X.shape
        method = self.spec["method"]
        Xc = X - X.mean(axis=0, keepdims=True)
        if method == "pearson":
            return Xc / np.sqrt(T - 1), np.zeros(n)
        if method == "duv":
            return np.zeros((0, n)), np.ones(n)
        if method == "linear_shrinkage":
            lam = _sanitize_lambda(
                self.spec.get("lambda_covmat_regularization"))
            sig2 = np.sum(Xc * Xc, axis=0) / (T - 1)
            return (Xc / np.sqrt(T - 1),
                    np.full(n, lam * float(np.mean(sig2))))
        if method == "ledoit_wolf":
            shrink, mu, _ = ledoit_wolf_params(torch.tensor(X))
            shrink = float(shrink)
            mu = float(mu.reshape(()))
            # MLE normalization: S = Xc'Xc / T.
            return (np.sqrt((1.0 - shrink) / T) * Xc,
                    np.full(n, shrink * mu))
        return None
