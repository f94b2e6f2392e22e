"""Per-asset return prediction: OLS, PCA+OLS, gradient boosting, LTR.

The port's twin of the JAX package's ``examples/ml_prediction.py`` (the
reference's ``example/ml.ipynb``): predict one asset's monthly return
from the cross-section of the others, compare OLS / PCA+OLS /
grid-searched boosting by RMSE and MAPE on a chronological holdout,
then show rank-label construction for learning to rank.

The boosting step is a host sklearn estimator
(``models.regression.boosted_regression``); ``boosting=False`` leaves
it out where sklearn is not installed.

    python -m porqua_tpu_torch.examples.ml_prediction [--device cpu]
        [--no-boosting]
"""

import argparse

import numpy as np

from porqua_tpu_torch.examples._common import load_msci_or_synthetic


def monthly_panel():
    """(monthly returns, target name, y, X): the first asset's monthly
    return against the others'."""
    data = load_msci_or_synthetic()
    rets = data["return_series"]
    monthly = np.exp(np.log1p(rets).resample("ME").sum()) - 1
    target = monthly.columns[0]
    return monthly, target, monthly[target], monthly.drop(columns=target)


def main(device=None, boosting=True):
    from porqua_tpu_torch.models import (OLS, PCA, PCAOLS,
                                         boosted_regression,
                                         decile_rank_labels)
    from porqua_tpu_torch.optimization_data import OptimizationData
    from porqua_tpu_torch.qp.solve import resolve_device
    from porqua_tpu_torch.utils.helpers import (calculate_mape,
                                                calculate_rmse)

    dev = resolve_device(device)
    monthly, target, y, X = monthly_panel()
    print(f"predicting {target} monthly returns from {X.shape[1]} series, "
          f"{len(y)} months")

    od = OptimizationData(align=True, X=X, y=y)
    train, test = od.train_test_split(test_size=0.2)

    pca = PCA(n_components=10, device=dev).fit(train["X"])
    evr = np.asarray(pca.explained_variance_ratio_)
    print(f"PCA scree: first 5 components explain {evr[:5].sum():.1%}")

    models = {
        "OLS": OLS(add_constant=True, device=dev).fit(train["X"], train["y"]),
        "PCA+OLS": PCAOLS(n_components=10, add_constant=True,
                          device=dev).fit(train["X"], train["y"]),
    }
    out = {"evr": evr, "OLS/coef": np.asarray(models["OLS"].coef_)}
    preds = {name: m.predict(test["X"]) for name, m in models.items()}
    if boosting:
        est, best, cv_rmse = boosted_regression(
            train["X"], train["y"],
            param_grid={"max_depth": [3, 6], "max_iter": [100, 200]})
        print(f"boosting grid search: best {best}, CV RMSE {cv_rmse:.4f}")
        preds["boosted"] = est.predict(np.asarray(test["X"]))
        out.update({"boosted/best": dict(best), "boosted/cv_rmse": cv_rmse})
    for name, p in preds.items():
        rmse = calculate_rmse(test["y"].values, p)
        mape = calculate_mape(test["y"].values, p)
        print(f"{name:8s}: holdout RMSE {rmse:.4f}, MAPE {mape:.1f}%")
        out.update({f"{name}/pred": np.asarray(p, dtype=float),
                    f"{name}/rmse": float(rmse), f"{name}/mape": float(mape)})

    labels = decile_rank_labels(monthly, n_bins=10)
    top = labels.iloc[-1].idxmin()
    print(f"LTR labels: decile ranks per month, e.g. last month's top asset "
          f"is {top} (rank 0 = best)")
    out.update({"labels": labels.to_numpy(float), "top": top})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("--no-boosting", action="store_true",
                    help="leave out the sklearn boosting step")
    opts = ap.parse_args()
    main(opts.device, boosting=not opts.no_boosting)
