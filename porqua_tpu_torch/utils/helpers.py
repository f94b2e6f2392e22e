"""Small host-side helpers (a copy of ``porqua_tpu/utils/helpers.py``;
``to_numpy`` also takes tensors). The numerical PSD helpers live in
:mod:`porqua_tpu_torch.utils.psd`.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np
import torch


def to_numpy(data):
    """``None``-safe conversion to numpy; a tensor is copied to the host."""
    if data is None:
        return None
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    if hasattr(data, "to_numpy"):
        return data.to_numpy()
    return np.asarray(data)


def serialize_solution(name_suffix: str, solution: Any, runtime: float) -> None:
    """Pickle a solver solution + quality metrics.

    Mirror of reference ``helper_functions.py:69-80`` adapted to our
    :class:`~porqua_tpu_torch.qp.solve.QPSolution` (which carries residuals as
    fields rather than methods).
    """
    result = {
        "solution": to_numpy(solution.x),
        "objective": float(solution.obj_val),
        "primal_residual": float(solution.prim_res),
        "dual_residual": float(solution.dual_res),
        "duality_gap": float(solution.duality_gap),
        "runtime": runtime,
    }
    with open(f"{name_suffix}.pickle", "wb") as handle:
        pickle.dump(result, handle, protocol=pickle.HIGHEST_PROTOCOL)


def output_to_strategies(output: dict):
    """Convert percentile-backtest output into per-quantile strategies.

    Mirror of reference ``helper_functions.py:86-99``: ``output`` maps
    rebalance date -> {'weights_1': Series, ..., 'weights_K': Series}.
    """
    from porqua_tpu_torch.portfolio import Portfolio, Strategy

    first = output[list(output.keys())[0]]
    n_quantiles = len([k for k in first.keys() if k.startswith("weights_")])
    strategy_dict = {}
    for i in range(n_quantiles):
        strategy = Strategy([])
        for rebdate in output.keys():
            weights = output[rebdate][f"weights_{i + 1}"]
            if hasattr(weights, "to_dict"):
                weights = weights.to_dict()
            strategy.portfolios.append(Portfolio(rebdate, weights))
        strategy_dict[f"q{i + 1}"] = strategy
    return strategy_dict


def calculate_rmse(y_true, y_pred) -> float:
    """Root mean squared error (reference ``helper_functions.py:105-110``)."""
    y_true = np.asarray(y_true, dtype=float)
    y_pred = to_numpy(y_pred).astype(float)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def calculate_mape(y_true, y_pred) -> float:
    """Mean absolute percentage error (reference ``helper_functions.py:113-119``)."""
    y_true = np.asarray(y_true, dtype=float)
    y_pred = to_numpy(y_pred).astype(float)
    return float(np.mean(np.abs((y_true - y_pred) / y_true)) * 100)


def show_result(predictions, y_test, y_actual, method=None):
    """Print RMSE/MAPE and plot predictions vs actuals (reference
    ``helper_functions.py:119-129``). The plot is skipped — with a
    warning rather than an import crash — when matplotlib is absent
    or headless plotting is unavailable."""
    print(f"RMSE of {method or 'regression'}: "
          f"{calculate_rmse(y_test, predictions)}")
    print(f"MAPE of {method or 'regression'}: "
          f"{calculate_mape(y_test, predictions)}")
    try:
        # Build the Figure directly — no pyplot: nothing is registered
        # in the global figure manager (no leak warnings in loops), no
        # backend is selected or switched (an interactive session keeps
        # its GUI backend; headless CI needs none at all).
        from matplotlib.figure import Figure
    except Exception as e:  # pragma: no cover - environment-dependent
        print(f"(plot skipped: matplotlib unavailable: {e})")
        return None
    fig = Figure()
    ax = fig.subplots()
    ax.plot(np.asarray(y_actual, dtype=float), color="cyan",
            label="True values")
    ax.plot(to_numpy(predictions).astype(float), color="green",
            label="Prediction")
    ax.legend()
    if method:
        ax.set_title(method)
    return fig
