"""LSTM next-day-return ranker for asset selection (a port of
``porqua_tpu/models/lstm.py``).

Sliding trailing windows of the return series are fed to LSTM(hidden)
-> Dropout -> Dense(n_assets) predicting the next-day return vector;
predictions rank assets and ranking quality is scored with NDCG
(reference ``example/lstm.ipynb`` cells 0-12, ``model/lstm_msci.keras``).

The cell is written out in torch ops, one fused ``x W + h U + b`` per
step split into the gates ``[i, f, g, o]``: ``torch.nn.LSTM`` (cuDNN)
has no relu cell activation (:class:`ReferenceLSTM` needs one) and
keeps two biases in another gate layout. The recurrence is a host loop
over the window, the JAX package's ``lax.scan`` made explicit.

Randomness is an input: ``train_lstm`` takes the initial parameters,
each step's minibatch indices and each step's dropout mask, or draws
them from a ``torch.Generator``. Parameters carry across from Flax's
tree and to and from Flax's ``.msgpack`` files
(:mod:`porqua_tpu_torch.convert`), so each package reads the other's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from porqua_tpu_torch.convert import (flax_msgpack_restore,
                                      flax_msgpack_serialize,
                                      lstm_params_from_flax,
                                      lstm_params_to_flax)
from porqua_tpu_torch.qp.canonical import HP
from porqua_tpu_torch.qp.solve import resolve_device


def make_windows(returns: np.ndarray, window: int,
                 step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding (window, N) slices and next-day targets.

    Mirrors the while-loop dataset construction of the reference
    notebook (``lstm.ipynb`` cell 1) vectorized: returns ``X`` of shape
    ``(num_windows, window, n_assets)`` and ``y`` of shape
    ``(num_windows, n_assets)`` where ``y[i]`` is the return on the day
    immediately after ``X[i]``'s window.
    """
    returns = np.asarray(returns)
    T, n = returns.shape
    if T <= window:
        raise ValueError(f"need more than window={window} rows, got {T}")
    starts = np.arange(0, T - window, step)
    X = np.stack([returns[s:s + window] for s in starts])
    y = returns[starts + window]
    return X, y


# Flax's default initializers: lecun_normal (a normal truncated at two
# standard deviations, rescaled to variance 1 / fan_in) for the input
# and dense kernels, orthogonal for the recurrent kernels, zero biases.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, generator):
    t = torch.empty(shape)
    std = math.sqrt(1.0 / shape[0]) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class LSTMRanker(nn.Module):
    """LSTM(hidden) -> Dropout -> Dense(n_assets), last-step readout.

    ``x`` is (B, T, n_features) and is scanned over T; ``n_features``
    defaults to ``n_assets`` (assets as features, the JAX package's
    layout). Parameters: ``kernel_i`` (n_features, 4H), ``kernel_h``
    (H, 4H), ``bias`` (4H,) with the gates stacked ``[i, f, g, o]``,
    ``dense_kernel`` (H, n_assets), ``dense_bias`` (n_assets,).
    """

    activation = staticmethod(torch.tanh)

    def __init__(self, n_assets: int, hidden: int = 32, dropout: float = 0.2,
                 n_features: Optional[int] = None):
        super().__init__()
        self.n_assets, self.hidden, self.dropout = n_assets, hidden, dropout
        self.n_features = n_assets if n_features is None else n_features
        H = hidden
        self.kernel_i = nn.Parameter(torch.zeros(self.n_features, 4 * H))
        self.kernel_h = nn.Parameter(torch.zeros(H, 4 * H))
        self.bias = nn.Parameter(torch.zeros(4 * H))
        self.dense_kernel = nn.Parameter(torch.zeros(H, n_assets))
        self.dense_bias = nn.Parameter(torch.zeros(n_assets))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initialization, drawn on the host from ``generator``
        (each gate's kernels drawn on their own, as Flax does)."""
        H, F = self.hidden, self.n_features
        draws = {
            "kernel_i": torch.cat([_lecun_normal((F, H), generator)
                                   for _ in range(4)], dim=1),
            "kernel_h": torch.cat([nn.init.orthogonal_(
                torch.empty(H, H), generator=generator) for _ in range(4)],
                dim=1),
            "bias": torch.zeros(4 * H),
            "dense_kernel": _lecun_normal((H, self.n_assets), generator),
            "dense_bias": torch.zeros(self.n_assets),
        }
        for name, value in draws.items():
            getattr(self, name).copy_(value)

    def last_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The hidden state after the last step, (B, H), from a zero
        carry."""
        B, T, _ = x.shape
        H = self.hidden
        act = self.activation
        xw = x @ self.kernel_i                   # (B, T, 4H)
        h = x.new_zeros(B, H)
        c = x.new_zeros(B, H)
        for t in range(T):
            z = torch.addmm(xw[:, t] + self.bias, h, self.kernel_h)
            i, f, g, o = z.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * act(g)
            h = torch.sigmoid(o) * act(c)
        return h

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Predictions (B, n_assets). With ``deterministic=False`` and a
        nonzero rate, ``dropout_mask`` (B, H), True where a unit is
        kept, scales the kept units by ``1 / (1 - dropout)`` as Flax's
        Dropout does; the mask is an input, never drawn here."""
        h = self.last_hidden(x)
        if not deterministic and self.dropout > 0.0:
            if dropout_mask is None:
                raise ValueError("pass dropout_mask: the draws are inputs")
            h = torch.where(dropout_mask, h / (1.0 - self.dropout),
                            torch.zeros((), dtype=h.dtype, device=h.device))
        return h @ self.dense_kernel + self.dense_bias


@dataclasses.dataclass
class TrainedLSTM:
    """A fit ranker: the module (which holds the weights) plus
    apply/predict/ranking helpers. ``params``, when given, is a Flax
    parameter tree loaded into the module; afterwards it is the
    module's weights in Flax's layout (numpy), as :meth:`save` writes
    them."""

    module: LSTMRanker
    params: Optional[dict] = None
    loss_history: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    def __post_init__(self):
        if self.params is not None:
            self._load_tree(self.params)
        self.params = lstm_params_to_flax(self.module.state_dict())

    def _load_tree(self, tree) -> None:
        w = self.module.kernel_h
        self.module.load_state_dict(
            lstm_params_from_flax(tree, device=w.device))

    def predict(self, X) -> np.ndarray:
        """Next-day return predictions, shape (B, n_assets)."""
        w = self.module.kernel_h
        x = (X.to(dtype=w.dtype, device=w.device) if torch.is_tensor(X)
             else torch.tensor(np.asarray(X), dtype=w.dtype, device=w.device))
        with torch.no_grad():
            return self.module(x).cpu().numpy()

    def scores(self, X_window) -> np.ndarray:
        """Scores for a single trailing window, shape (n_assets,)."""
        X_window = np.asarray(X_window)
        return self.predict(X_window[None])[0]

    def save(self, path: str) -> None:
        """Write the weights as Flax's ``serialization.to_bytes`` does
        (needs ``msgpack``)."""
        with open(path, "wb") as fh:
            fh.write(flax_msgpack_serialize(
                lstm_params_to_flax(self.module.state_dict())))

    def load_params(self, path: str) -> None:
        """Read a Flax ``.msgpack`` parameter file into the module (needs
        ``msgpack``); a shape that does not match raises."""
        with open(path, "rb") as fh:
            self._load_tree(flax_msgpack_restore(fh.read()))
        self.params = lstm_params_to_flax(self.module.state_dict())


def _lstm_draws(n_samples: int, batch_size: int, hidden: int, n_steps: int,
               dropout: float, generator: torch.Generator):
    """``train_lstm``'s minibatch indices (n_steps, batch_size), each
    row drawn without replacement, and dropout masks (n_steps,
    batch_size, hidden), True where a unit is kept, from ``generator``
    on the host."""
    idx = torch.stack([torch.randperm(n_samples, generator=generator)
                       [:batch_size] for _ in range(n_steps)])
    masks = torch.rand((n_steps, batch_size, hidden),
                       generator=generator) < 1.0 - dropout
    return idx, masks


def train_lstm(X: np.ndarray,
               y: np.ndarray,
               hidden: int = 32,
               dropout: float = 0.2,
               epochs: int = 100,
               batch_size: int = 64,
               learning_rate: float = 1e-3,
               seed: int = 0,
               generator: Optional[torch.Generator] = None,
               init_params: Optional[dict] = None,
               batch_indices=None,
               dropout_masks=None,
               device=None) -> TrainedLSTM:
    """Fit the ranker with Adam on MSE loss (notebook cells 4-5).

    One Adam step (optax's defaults: b1 0.9, b2 0.999, eps 1e-8 outside
    the square root) per minibatch, ``epochs * (n_samples //
    batch_size)`` steps. The draws are inputs: ``init_params`` (a Flax
    tree), ``batch_indices`` (n_steps, batch) and ``dropout_masks``
    (n_steps, batch, hidden; True keeps); whatever is not given is
    drawn from ``generator`` (default: one seeded with ``seed``), on the
    host, so the CPU and the card draw the same. The loss history is
    per epoch (the mean of its steps), as the JAX package reports it.
    """
    HP.apply()
    device = resolve_device(device)
    X = torch.tensor(np.asarray(X), dtype=torch.float32, device=device)
    Y = torch.tensor(np.asarray(y), dtype=torch.float32, device=device)
    n_samples, _, n_assets = X.shape
    if generator is None:
        generator = torch.Generator().manual_seed(seed)

    module = LSTMRanker(n_assets=n_assets, hidden=hidden, dropout=dropout)
    if init_params is None:
        module.reset_parameters(generator)
    module = module.to(device=device)
    if init_params is not None:
        module.load_state_dict(lstm_params_from_flax(init_params,
                                                     device=device))

    batch_size = min(batch_size, n_samples)
    n_batches = n_samples // batch_size
    n_steps = max(1, epochs * n_batches)
    if batch_indices is None or dropout_masks is None:
        idx, masks = _lstm_draws(n_samples, batch_size, hidden, n_steps,
                                dropout, generator)
        batch_indices = idx if batch_indices is None else batch_indices
        dropout_masks = masks if dropout_masks is None else dropout_masks
    idx = torch.as_tensor(np.asarray(batch_indices), dtype=torch.long,
                          device=device)
    masks = torch.as_tensor(np.asarray(dropout_masks), dtype=torch.bool,
                            device=device)
    if idx.shape != (n_steps, batch_size) or masks.shape != (
            n_steps, batch_size, hidden):
        raise ValueError(f"need {n_steps} steps of {batch_size} indices and "
                         f"({batch_size}, {hidden}) masks, got "
                         f"{tuple(idx.shape)} and {tuple(masks.shape)}")

    losses = _adam_steps(module, X, Y, idx, masks, learning_rate)
    per_epoch = losses.reshape(epochs, -1).mean(axis=1) \
        if n_steps == epochs * n_batches and n_batches > 0 else losses
    return TrainedLSTM(module=module, loss_history=per_epoch)


def _adam_steps(module, X, Y, idx, masks, learning_rate) -> np.ndarray:
    """The minibatch loop; returns each step's loss (before its
    update), copied to the host once at the end."""
    HP.check()
    opt = torch.optim.Adam(module.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for s in range(idx.shape[0]):
        pred = module(X[idx[s]], deterministic=False, dropout_mask=masks[s])
        loss = torch.mean((pred - Y[idx[s]]) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).cpu().numpy()


class ReferenceLSTM(LSTMRanker):
    """The reference's saved architecture, exactly: LSTM(units,
    activation=relu) scanning the *asset* axis with the trailing window
    as the feature vector (the notebook's ``(num_stocks, width)``
    layout, reference ``example/lstm.ipynb`` cell 4 /
    ``model/lstm_msci.keras`` config.json), then Dense(n_assets).
    Dropout is inference-inactive so it is omitted."""

    activation = staticmethod(torch.relu)

    def __init__(self, n_assets: int, hidden: int = 50,
                 n_features: Optional[int] = None):
        super().__init__(n_assets, hidden=hidden, dropout=0.0,
                         n_features=n_features)


def load_reference_lstm(path: str, device=None) -> TrainedLSTM:
    """Load the reference's trained Keras LSTM into :class:`ReferenceLSTM`.

    Reads ``model.weights.h5`` out of the ``.keras`` zip archive
    (reference ``model/lstm_msci.keras``) with h5py (imported here) and
    maps the fused Keras kernels onto the port's: Keras stacks the four
    gates as ``[i, f, c, o]`` blocks along the last axis of the input
    kernel (in_dim, 4H), recurrent kernel (H, 4H) and bias (4H,), which
    is the port's ``[i, f, g, o]`` layout as it stands.
    """
    import io
    import zipfile

    import h5py

    with zipfile.ZipFile(path) as z:
        with h5py.File(io.BytesIO(z.read("model.weights.h5")), "r") as f:
            arrays = {
                "kernel_i": np.asarray(f["layers/lstm/cell/vars/0"]),
                "kernel_h": np.asarray(f["layers/lstm/cell/vars/1"]),
                "bias": np.asarray(f["layers/lstm/cell/vars/2"]),
                "dense_kernel": np.asarray(f["layers/dense/vars/0"]),
                "dense_bias": np.asarray(f["layers/dense/vars/1"]),
            }
    device = resolve_device(device)
    module = ReferenceLSTM(n_assets=arrays["dense_kernel"].shape[1],
                           hidden=arrays["kernel_h"].shape[0],
                           n_features=arrays["kernel_i"].shape[0])
    # load_state_dict raises on a shape that does not match the module.
    module.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                            for k, v in arrays.items()})
    return TrainedLSTM(module=module.to(device))


def reference_lstm_windows(returns: np.ndarray,
                           window: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """Window construction in the reference's layout: each sample is
    ``(n_assets, window)`` — assets as the scan axis, the trailing
    window as features (``lstm.ipynb`` cell 1) — with next-day return
    targets."""
    X, y = make_windows(returns, window)
    return np.swapaxes(X, 1, 2), y


def ndcg(scores, relevance, k: Optional[int] = None,
         device=None) -> torch.Tensor:
    """Normalized discounted cumulative gain of ``scores`` against graded
    ``relevance`` (notebook cell 10's quality metric, computed on the
    device: a tensor's own, else ``device``, the card by default).

    Supports leading batch dimensions; ``k`` truncates the ranking.
    Tied scores keep their input order (a stable sort, as ``jnp.argsort``).
    """
    if not torch.is_tensor(scores):
        scores = torch.as_tensor(np.asarray(scores),
                                 device=resolve_device(device))
    relevance = torch.as_tensor(
        np.asarray(relevance) if not torch.is_tensor(relevance) else relevance,
        dtype=torch.float32, device=scores.device)
    n = scores.shape[-1]
    if k is None:
        k = n
    order = torch.argsort(-scores, dim=-1, stable=True)
    gains = torch.take_along_dim(relevance, order, dim=-1)
    ideal = -torch.sort(-relevance, dim=-1).values
    ar = torch.arange(n, device=scores.device)
    discounts = 1.0 / torch.log2((ar + 2).to(torch.float32))
    mask = (ar < k).to(torch.float32)
    dcg = torch.sum(gains * discounts * mask, dim=-1)
    idcg = torch.sum(ideal * discounts * mask, dim=-1)
    return torch.where(idcg > 0, dcg / idcg, torch.zeros_like(dcg))


def lstm_selection_scores(bs, rebdate: str,
                          return_key: str = "return_series",
                          window: int = 100,
                          train_windows: int = 500,
                          epochs: int = 20,
                          hidden: int = 32,
                          top_k: Optional[int] = None,
                          **train_kwargs):
    """Selection ``bibfn`` payload: LSTM scores for the current universe.

    Trains on trailing data strictly before ``rebdate`` (no look-ahead)
    and returns a DataFrame with ``values`` and a ``binary`` top-k
    column — the same contract as the LTR scorer
    (:func:`porqua_tpu_torch.models.ltr.ltr_selection_scores`).
    ``train_kwargs`` go to :func:`train_lstm` (``device=``, the draws).
    """
    import pandas as pd

    returns = bs.data[return_key]
    hist = returns.loc[returns.index < rebdate].dropna(how="any")
    need = window + 2
    if len(hist) < need:
        raise ValueError(f"need >= {need} rows before {rebdate}, got {len(hist)}")
    hist = hist.tail(train_windows + window + 1)
    X, y = make_windows(hist.values, window)
    model = train_lstm(X, y, hidden=hidden, epochs=epochs, **train_kwargs)
    scores = model.scores(hist.values[-window:])

    universe = list(returns.columns)
    # same default as the LTR scorer: keep the top half of the universe
    k = top_k if top_k is not None else max(1, len(universe) // 2)
    ranks = np.argsort(np.argsort(-scores))
    return pd.DataFrame(
        {"values": scores, "binary": (ranks < k).astype(int)},
        index=universe,
    )
