"""Ordinal regression on cross-sectional return-rank labels.

The port's twin of the JAX package's ``examples/ordinal_regression.py``
(the reference's ``example/ordinal_regression.ipynb``): build quintile
rank labels from winsorized monthly returns (rank 0 = highest, the
reference's ``(-ret).rank()`` convention), fit ordered probit and logit
models on trailing cross-sections, and report the fraction of correct
choice predictions on a holdout (notebook cells 6-13).

    python -m porqua_tpu_torch.examples.ordinal_regression [--device cpu]
"""

import numpy as np

from porqua_tpu_torch.examples._common import (load_msci_or_synthetic,
                                               parse_device)


def ordinal_data(n_bins=5):
    """(X_train, y_train, X_test, y_test): this month's return of each
    asset as the feature, next month's rank class as the target."""
    from porqua_tpu_torch.models import decile_rank_labels

    data = load_msci_or_synthetic()
    rets = data["return_series"]
    monthly = np.exp(np.log1p(rets).resample("ME").sum()) - 1
    monthly = monthly.clip(-0.5, 0.5)  # winsorize, notebook cell 2
    labels = decile_rank_labels(monthly, n_bins=n_bins)

    # features: this month's return cross-section; target: next month's rank
    X = monthly.iloc[:-1].to_numpy().reshape(-1, 1)
    y = labels.iloc[1:].to_numpy().reshape(-1)
    keep = np.isfinite(X[:, 0])
    X, y = X[keep], y[keep].astype(int)
    cut = int(0.8 * len(y))
    return X[:cut], y[:cut], X[cut:], y[cut:]


def main(device=None):
    from porqua_tpu_torch.models import OrdinalRegression
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    n_bins = 5
    X_train, y_train, X_test, y_test = ordinal_data(n_bins)
    print(f"{len(y_train)} train / {len(y_test)} test observations, "
          f"{n_bins} ordered classes")

    out = {}
    for distr in ("probit", "logit"):
        model = OrdinalRegression(distr=distr, device=dev).fit(
            X_train, y_train, n_classes=n_bins)
        acc_train = float((model.predict(X_train) == y_train).mean())
        acc_test = float((model.predict(X_test) == y_test).mean())
        print(f"{distr:6s}: cutpoints {np.round(model.cutpoints_, 3)}, "
              f"fraction of correct choice predictions "
              f"train {acc_train:.3f} / test {acc_test:.3f} "
              f"(chance {1 / n_bins:.2f})")
        out.update({f"{distr}/cutpoints": np.asarray(model.cutpoints_),
                    f"{distr}/beta": np.asarray(model.beta_),
                    f"{distr}/nll": float(model.nll_),
                    f"{distr}/acc_train": acc_train,
                    f"{distr}/acc_test": acc_test})
    return out


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
