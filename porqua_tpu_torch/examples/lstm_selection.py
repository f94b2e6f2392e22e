"""LSTM next-day-return ranking for asset selection.

The port's twin of the JAX package's ``examples/lstm_selection.py`` (the
reference's ``example/lstm.ipynb``): sliding 100-day windows of the
MSCI country returns -> LSTM(32) -> Dropout -> Dense(24) next-day
predictions trained with Adam/MSE, then rank assets and score ranking
quality with NDCG on a held-out tail.

The training draws are inputs: ``draws`` (a dict of the initial Flax
parameter tree ``init_params``, the minibatch ``batch_indices`` and the
``dropout_masks``, as ``models.lstm.train_lstm`` takes them) replays a
run of the JAX package's example step for step; without it they come
from a ``torch.Generator`` seeded with 0.

    python -m porqua_tpu_torch.examples.lstm_selection [--device cpu]
"""

import os

import numpy as np

from porqua_tpu_torch.examples._common import (load_msci_or_synthetic,
                                               parse_device)

# The reference's shipped Keras model (model/lstm_msci.keras), where
# one is named.
REFERENCE_MODEL = os.environ.get("PORQUA_LSTM_MODEL", "")


def lstm_data(n_rows=2000, window=100, test_size=50):
    """The tail of the returns and its windows, split into train and a
    held-out tail: (returns, X_train, y_train, X_test, y_test)."""
    from porqua_tpu_torch.models import make_windows

    returns = load_msci_or_synthetic()["return_series"].tail(n_rows)
    X, y = make_windows(returns.values, window)
    return (returns, X[:-test_size], y[:-test_size], X[-test_size:],
            y[-test_size:])


def main(device=None, draws=None, n_rows=2000, epochs=30):
    from porqua_tpu_torch.models import ndcg, train_lstm
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    window, test_size = 100, 50
    returns, X_train, y_train, X_test, y_test = lstm_data(n_rows, window,
                                                          test_size)
    print(f"dataset: {X_train.shape[0]} train windows of "
          f"({window} days x {returns.shape[1]} assets)")

    model = train_lstm(X_train, y_train, hidden=32, dropout=0.2,
                       epochs=epochs, batch_size=128, seed=0,
                       device=dev, **(draws or {}))
    loss = np.asarray(model.loss_history)
    print(f"train MSE: {loss[0]:.3e} -> {loss[-1]:.3e}")

    pred = model.predict(X_test)
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    # rank quality: realized-return ranks as graded relevance (cell 10)
    rel = np.argsort(np.argsort(y_test, axis=1), axis=1).astype(float)
    scores = ndcg(pred, rel, k=returns.shape[1], device=dev).cpu().numpy()
    print(f"held-out ({test_size} days): RMSE {rmse:.3e}, "
          f"mean NDCG@{returns.shape[1]} {scores.mean():.3f}")

    top = np.argsort(-pred[-1])[:10]
    print("top-10 assets on the last day:", list(returns.columns[top]))
    out = {"loss": loss, "pred": pred, "rmse": rmse,
           "ndcg": float(scores.mean()), "top10": list(returns.columns[top])}

    # Quality comparison against the reference's shipped trained model
    # (model/lstm_msci.keras through the same NDCG harness, the
    # lstm.ipynb cell-10 workflow; reading it needs h5py).
    if REFERENCE_MODEL and os.path.exists(REFERENCE_MODEL):
        from porqua_tpu_torch.models.lstm import (load_reference_lstm,
                                                  reference_lstm_windows)

        ref_model = load_reference_lstm(REFERENCE_MODEL, device=dev)
        X_ref, y_ref = reference_lstm_windows(
            returns.values.astype(np.float32), window)
        X_ref, y_ref = X_ref[-test_size:], y_ref[-test_size:]
        ref_pred = ref_model.predict(X_ref)
        rel_ref = np.argsort(np.argsort(y_ref, axis=1), axis=1).astype(float)
        for k in (5, 10):
            ours = float(np.mean(ndcg(pred, rel, k=k, device=dev)
                                 .cpu().numpy()))
            theirs = float(np.mean(ndcg(ref_pred, rel_ref, k=k, device=dev)
                                   .cpu().numpy()))
            print(f"NDCG@{k}: this model {ours:.3f} vs "
                  f"reference saved model {theirs:.3f}")
            out[f"ndcg@{k}"] = (ours, theirs)
    return out


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
