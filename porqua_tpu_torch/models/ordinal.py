"""Ordered probit/logit regression on rank labels, fit by maximum
likelihood (a port of ``porqua_tpu/models/ordinal.py``).

The reference's ordinal-regression workflow (reference
``example/ordinal_regression.ipynb`` cells 4-15) fits ``statsmodels``
``OrderedModel(distr='probit'|'logit')`` by BFGS on decile rank labels.

Model (notebook cell 4): a latent linear variable ``y* = x'beta + eps``
is observed only through its discretization by ordered cutpoints
``c_1 < ... < c_{K-1}``::

    P(y = k | x) = F(c_{k+1} - x'beta) - F(c_k - x'beta)

with ``F`` the standard normal (probit) or logistic (logit) CDF.
Cutpoint monotonicity uses the same transform statsmodels applies:
``c = [a_0, a_0 + cumsum(exp(a_{1:}))]``. The negative log-likelihood
is minimized with ``torch.optim.LBFGS`` (history 10, strong-Wolfe line
search, at most ``max_iter`` iterations, stopping once the loss moves
by less than ``tol``) on the device the caller names, the card by
default. The JAX package runs ``optax.lbfgs`` under the same stop rule;
the two paths of iterates differ, their optimum does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from porqua_tpu_torch.qp.canonical import HP
from porqua_tpu_torch.qp.solve import resolve_device


def _cdf(z: torch.Tensor, distr: str) -> torch.Tensor:
    if distr == "probit":
        return torch.special.ndtr(z)
    if distr == "logit":
        return torch.sigmoid(z)
    raise ValueError(f"distr must be 'probit' or 'logit', got {distr!r}")


def _cutpoints(raw: torch.Tensor) -> torch.Tensor:
    """Monotone cutpoints from unconstrained params (statsmodels transform)."""
    return torch.cat([raw[:1], raw[0] + torch.cumsum(torch.exp(raw[1:]), 0)])


def _class_probs(beta, raw_cuts, X, distr):
    eta = X @ beta  # (B,)
    cuts = _cutpoints(raw_cuts)  # (K-1,)
    cdf = _cdf(cuts[None, :] - eta[:, None], distr)  # (B, K-1)
    upper = torch.cat([cdf, torch.ones_like(eta)[:, None]], dim=1)
    lower = torch.cat([torch.zeros_like(eta)[:, None], cdf], dim=1)
    return upper - lower  # (B, K)


@dataclasses.dataclass
class OrdinalRegression:
    """Ordered probit/logit classifier on 0..K-1 rank labels.

    Parameters mirror the statsmodels surface the reference uses:
    ``distr`` selects the latent error distribution; ``fit`` runs the
    MLE; ``predict_proba``/``predict`` give class probabilities and the
    argmax choice (notebook cells 6-13); ``expected_rank`` is the
    probability-weighted rank, the natural scalar score for selection.
    ``device`` is where it fits and predicts (the card by default).
    """

    distr: str = "probit"
    max_iter: int = 500
    tol: float = 1e-8
    device: Optional[object] = dataclasses.field(default=None, kw_only=True)

    n_classes: Optional[int] = None
    beta_: Optional[np.ndarray] = None
    cutpoints_: Optional[np.ndarray] = None
    nll_: Optional[float] = None

    def _nll_fn(self, X, y):
        distr = self.distr

        def nll(beta, cuts):
            probs = _class_probs(beta, cuts, X, distr)
            p = torch.take_along_dim(probs, y[:, None], dim=1)[:, 0]
            return -torch.mean(torch.log(torch.clamp(p, min=1e-12)))

        return nll

    def fit(self, X, y, n_classes: Optional[int] = None) -> "OrdinalRegression":
        HP.apply()
        device = resolve_device(self.device)
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=device)
        y_np = np.asarray(y)
        y = torch.as_tensor(y_np, dtype=torch.long, device=device)
        if n_classes is None:
            n_classes = int(y_np.max()) + 1
        if n_classes < 2:
            raise ValueError("need at least 2 ordered classes")
        self.n_classes = n_classes

        beta = torch.zeros(X.shape[1], device=device, requires_grad=True)
        # evenly spaced initial cutpoints around 0
        cuts = torch.cat([torch.full((1,), -1.0, device=device),
                          torch.zeros(n_classes - 2, device=device)])
        cuts.requires_grad_(True)
        value = _lbfgs(self._nll_fn(X, y), (beta, cuts), self.max_iter,
                       self.tol)
        self.beta_ = beta.detach().cpu().numpy()
        self.cutpoints_ = _cutpoints(cuts.detach()).cpu().numpy()
        self.nll_ = value
        return self

    def _check_fit(self):
        if self.beta_ is None:
            raise RuntimeError("call fit() first")

    def predict_proba(self, X) -> np.ndarray:
        """Class probabilities, shape (B, K) (notebook cell 7)."""
        self._check_fit()
        raw = np.concatenate([
            self.cutpoints_[:1],
            np.log(np.clip(np.diff(self.cutpoints_), 1e-12, None)),
        ])
        device = resolve_device(self.device)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                         device=device)
        probs = _class_probs(as_t(self.beta_), as_t(raw), as_t(X), self.distr)
        return probs.cpu().numpy()

    def predict(self, X) -> np.ndarray:
        """Most likely class per row (``predicted.argmax(1)``, cell 7)."""
        return self.predict_proba(X).argmax(axis=1)

    def expected_rank(self, X) -> np.ndarray:
        """Probability-weighted rank — a scalar selection score."""
        probs = self.predict_proba(X)
        return probs @ np.arange(self.n_classes)


def _lbfgs(nll, params, max_iter: int, tol: float) -> float:
    """Minimize ``nll(*params)`` in place; returns the final value."""
    HP.check()
    opt = torch.optim.LBFGS(params, lr=1.0, max_iter=max_iter,
                            tolerance_change=tol, history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = nll(*params)
        loss.backward()
        return loss

    opt.step(closure)
    with torch.no_grad():
        return float(nll(*params))


def decile_rank_labels(returns, n_bins: int = 10, ascending: bool = False):
    """Cross-sectional rank labels from a return cross-section.

    Mirrors the notebook's label construction (cell 2): rank each row's
    winsorized returns; ``ascending=False`` gives rank 0 to the highest
    return, matching the reference's ``(-ret).rank()`` convention.
    Delegates to the shared :func:`porqua_tpu_torch.models.labels.rank_labels`.
    """
    from porqua_tpu_torch.models.labels import rank_labels

    return rank_labels(returns, n_bins=n_bins, ascending=ascending)
