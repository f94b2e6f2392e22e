from porqua_tpu_torch.utils.psd import is_psd, nearest_psd, project_psd
from porqua_tpu_torch.utils.helpers import (
    calculate_mape,
    calculate_rmse,
    output_to_strategies,
    serialize_solution,
    show_result,
    to_numpy,
)

__all__ = [
    "is_psd",
    "nearest_psd",
    "project_psd",
    "to_numpy",
    "serialize_solution",
    "output_to_strategies",
    "calculate_rmse",
    "calculate_mape",
    "show_result",
]
