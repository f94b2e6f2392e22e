"""ML-driven asset selection and return-prediction models (a port of
``porqua_tpu/models/``, the same public names).

Covers the reference's ML capability surface (``example/lstm.ipynb``,
``example/ml.ipynb``, ``example/ordinal_regression.ipynb`` and the
XGBoost LTR bibfn at reference ``src/builders.py:138-180``). The
sequence, ranking and regression models train and predict with torch
on the device the caller names (the card by default); the
gradient-boosting surrogate stays on the host. sklearn, msgpack and
h5py are imported only inside the functions that need them.
"""

from porqua_tpu_torch.models.ltr import ltr_selection_scores
from porqua_tpu_torch.models.lstm import (
    LSTMRanker,
    TrainedLSTM,
    lstm_selection_scores,
    make_windows,
    ndcg,
    train_lstm,
)
from porqua_tpu_torch.models.ordinal import (OrdinalRegression,
                                             decile_rank_labels)
from porqua_tpu_torch.models.regression import (OLS, PCA, PCAOLS,
                                                boosted_regression)

__all__ = [
    "ltr_selection_scores",
    "LSTMRanker",
    "TrainedLSTM",
    "train_lstm",
    "make_windows",
    "ndcg",
    "lstm_selection_scores",
    "OrdinalRegression",
    "decile_rank_labels",
    "OLS",
    "PCA",
    "PCAOLS",
    "boosted_regression",
]
