from porqua_tpu_torch.estimators.covariance import (
    Covariance,
    CovarianceSpecification,
    cov_pearson,
    cov_duv,
    cov_linear_shrinkage,
    cov_ledoit_wolf,
)
from porqua_tpu_torch.estimators.mean import MeanEstimator, geometric_mean

__all__ = [
    "Covariance",
    "CovarianceSpecification",
    "cov_pearson",
    "cov_duv",
    "cov_linear_shrinkage",
    "cov_ledoit_wolf",
    "MeanEstimator",
    "geometric_mean",
]
