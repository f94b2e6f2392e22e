"""Learning-to-rank asset selection scoring, pairwise (a port of
``porqua_tpu/models/ltr.py``).

Working replacement for the reference's stale XGBoost LTR bibfn
(reference ``src/builders.py:138-180``) and its pairwise
``xgb.XGBRanker`` workflow (reference ``example/ml.ipynb`` cell 18,
objective ``rank:pairwise``): a small MLP scorer trained with the
RankNet loss (logistic loss on the score differences of discordant
pairs within each date's cross-section), full-batch Adam over all
groups at once. Training runs once per rebalance date off the solve
path, on the device the caller names (the card by default), from
initial parameters handed in or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F
from torch import nn

from porqua_tpu_torch.convert import mlp_params_from_jax
from porqua_tpu_torch.qp.canonical import HP
from porqua_tpu_torch.qp.solve import resolve_device


def _rank_labels(returns: pd.Series, n_bins: int = 10) -> pd.Series:
    """Cross-sectional decile rank labels (0 = worst, n_bins-1 = best)."""
    from porqua_tpu_torch.models.labels import rank_labels

    return rank_labels(returns, n_bins=n_bins, ascending=True)


def pairwise_logistic_loss(scores: torch.Tensor,
                           labels: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """RankNet loss per group: mean softplus(-(s_i - s_j)) over pairs
    with label_i > label_j (both valid under ``mask``). The last axis
    is the group's slots; leading axes are groups (the JAX package's
    ``vmap``), so (G, N) inputs give (G,) losses."""
    s_diff = scores[..., :, None] - scores[..., None, :]
    l_diff = labels[..., :, None] - labels[..., None, :]
    valid = (mask[..., :, None] > 0) & (mask[..., None, :] > 0)
    pair = valid & (l_diff > 0)
    losses = torch.where(pair, F.softplus(-s_diff),
                         torch.zeros((), dtype=scores.dtype,
                                     device=scores.device))
    n_pairs = torch.clamp(pair.sum(dim=(-2, -1)), min=1)
    return losses.sum(dim=(-2, -1)) / n_pairs


def _init_mlp(generator: torch.Generator, sizes: Sequence[int]):
    """He-normal weights and zero biases, the JAX package's layout
    (a list of ``{"w": (d_in, d_out), "b": (d_out,)}``), drawn on the
    host from ``generator``."""
    return [{"w": torch.randn((d_in, d_out), generator=generator)
             * math.sqrt(2.0 / d_in), "b": torch.zeros(d_out)}
            for d_in, d_out in zip(sizes[:-1], sizes[1:])]


class MLPScorer(nn.Module):
    """relu MLP with a scalar output: ``(..., d_in) -> (...)``."""

    def __init__(self, params):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(p["w"]) for p in params])
        self.b = nn.ParameterList([nn.Parameter(p["b"]) for p in params])

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        h = X
        for w, b in zip(self.w[:-1], self.b[:-1]):
            h = torch.relu(h @ w + b)
        return (h @ self.w[-1] + self.b[-1])[..., 0]

    def params(self):
        """The weights in the JAX package's layout (detached tensors)."""
        return [{"w": w.detach(), "b": b.detach()}
                for w, b in zip(self.w, self.b)]


@dataclasses.dataclass
class PairwiseRanker:
    """MLP scorer trained with the RankNet pairwise loss.

    ``fit`` takes per-date groups (feature matrix, label vector); groups
    are padded to a common size and stacked, and every epoch is one
    full-batch Adam step over all of them (optax's defaults: b1 0.9, b2
    0.999, eps 1e-8 outside the square root). ``device`` is where it
    trains and predicts (the card by default).
    """

    hidden: Tuple[int, ...] = (32,)
    epochs: int = 300
    learning_rate: float = 0.01
    seed: int = 0
    device: Optional[object] = dataclasses.field(default=None, kw_only=True)

    params: Optional[list] = dataclasses.field(default=None, repr=False)
    _norm: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False)

    def sizes(self, n_feat: int) -> Tuple[int, ...]:
        """The MLP's layer widths for ``n_feat`` features."""
        return (n_feat, *self.hidden, 1)

    def fit(self, groups: List[Tuple[np.ndarray, np.ndarray]],
            init_params=None,
            generator: Optional[torch.Generator] = None):
        """Train from ``init_params`` (the JAX package's layout, arrays
        or tensors) or, without them, from weights drawn from
        ``generator`` (default: one seeded with ``seed``)."""
        HP.apply()
        device = resolve_device(self.device)
        n_feat = groups[0][0].shape[1]
        max_n = max(x.shape[0] for x, _ in groups)
        Xs = np.zeros((len(groups), max_n, n_feat), np.float32)
        ys = np.zeros((len(groups), max_n), np.float32)
        masks = np.zeros((len(groups), max_n), np.float32)
        for g, (x, y) in enumerate(groups):
            k = x.shape[0]
            Xs[g, :k] = x
            ys[g, :k] = y
            masks[g, :k] = 1.0

        # Feature standardization from the training pool (guarded
        # against constant columns).
        flat = Xs[masks > 0]
        mean = flat.mean(axis=0)
        std = np.where(flat.std(axis=0) > 1e-12, flat.std(axis=0), 1.0)
        self._norm = (mean, std)
        Xs = (Xs - mean) / std

        if init_params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(self.seed)
            init_params = _init_mlp(generator, self.sizes(n_feat))
        init = mlp_params_from_jax(init_params, device=device)
        got = tuple(p["w"].shape[0] for p in init) + (init[-1]["w"].shape[1],)
        if got != self.sizes(n_feat):
            raise ValueError(f"initial parameters of widths {got}, the "
                             f"ranker needs {self.sizes(n_feat)}")
        net = MLPScorer(init)
        as_t = lambda a: torch.as_tensor(a, device=device)
        self._losses = _adam_epochs(net, as_t(Xs), as_t(ys), as_t(masks),
                                    self.epochs, self.learning_rate)
        self.params = net.params()
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("fit() the ranker first")
        mean, std = self._norm
        w = self.params[0]["w"]
        Xn = torch.as_tensor(((np.asarray(X) - mean) / std).astype(np.float32),
                             device=w.device)
        with torch.no_grad():
            return MLPScorer(self.params)(Xn).cpu().numpy()


def _adam_epochs(net, Xs, ys, masks, epochs, learning_rate) -> torch.Tensor:
    """``epochs`` full-batch Adam steps on the mean of the groups'
    pairwise losses; returns each epoch's loss (before its update)."""
    HP.check()
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(epochs):
        loss = torch.mean(pairwise_logistic_loss(net(Xs), ys, masks))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses) if losses else torch.zeros(0)


def ltr_selection_scores(bs,
                         rebdate: str,
                         feature_key: str = "features",
                         return_key: str = "return_series",
                         train_dates: int = 12,
                         horizon: int = 21,
                         top_k: Optional[int] = None,
                         epochs: int = 300,
                         init_params: Optional[Callable] = None,
                         device=None,
                         **kwargs) -> pd.DataFrame:
    """Score the current universe with the pairwise ranking model.

    ``bs.data[feature_key]``: DataFrame indexed by (date, asset) or a
    dict date -> DataFrame(asset x features). Labels are forward
    ``horizon``-day returns ranked cross-sectionally, from the
    ``train_dates`` most recent feature cross-sections before
    ``rebdate``. Mirrors the group structure the reference's
    ``XGBRanker`` fit uses (one group per date cross-section,
    ``example/ml.ipynb`` cell 18).

    The ranker trains on ``device`` (the card by default) from
    ``init_params(rebdate, sizes)`` (the JAX package's MLP layout) when
    that callable is given, else from weights seeded as the ranker's.
    """
    features = bs.data.get(feature_key)
    returns = bs.data.get(return_key)
    if features is None or returns is None:
        raise ValueError(
            f"'{feature_key}' and '{return_key}' data are required "
            f"for LTR selection.")

    if isinstance(features, pd.DataFrame) and isinstance(features.index, pd.MultiIndex):
        by_date = {d: features.xs(d, level=0)
                   for d in features.index.get_level_values(0).unique()}
    else:
        by_date = dict(features)

    reb_ts = pd.to_datetime(rebdate)
    past_dates = sorted(
        d for d in by_date if pd.to_datetime(d) < reb_ts)[-train_dates:]
    if not past_dates:
        raise ValueError(f"no feature cross-sections before {rebdate}")

    groups: List[Tuple[np.ndarray, np.ndarray]] = []
    for d in past_dates:
        xsec = by_date[d].dropna()
        d_ts = pd.to_datetime(d)
        future = returns[returns.index > d_ts].head(horizon)
        if future.empty:
            continue
        fwd = (1.0 + future).prod() - 1.0
        common = xsec.index.intersection(fwd.index)
        if len(common) < 2:
            continue
        groups.append((
            xsec.loc[common].to_numpy(np.float32),
            _rank_labels(fwd[common]).to_numpy(np.float32),
        ))
    if not groups:
        raise ValueError("no usable (features, forward return) training pairs")

    model = PairwiseRanker(epochs=epochs, device=device)
    start = (None if init_params is None else
             init_params(rebdate, model.sizes(groups[0][0].shape[1])))
    model.fit(groups, init_params=start)

    current_dates = sorted(d for d in by_date if pd.to_datetime(d) <= reb_ts)
    xsec_now = by_date[current_dates[-1]].dropna()
    scores = pd.Series(
        model.predict(xsec_now.to_numpy(np.float32)), index=xsec_now.index)

    k = top_k if top_k is not None else max(1, len(scores) // 2)
    top = scores.rank(ascending=False, method="first") <= k
    return pd.DataFrame({"values": scores, "binary": top.astype(int)})
