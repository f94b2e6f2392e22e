"""porqua_tpu_torch: the PyTorch/CUDA port of porqua_tpu.

It mirrors the JAX package's module tree and public names, imports
neither JAX nor the JAX package, and runs on the card unless a caller
passes ``device="cpu"``. Its kernels (``ops/``) are compiled on first
use, never at import.
"""

from porqua_tpu_torch.constraints import Constraints
from porqua_tpu_torch.qp import (
    CanonicalQP,
    QPSolution,
    SolverParams,
    Status,
    solve_qp,
    solve_qp_batch,
    solve_qp_diff,
    solve_qp_l1_diff,
)
from porqua_tpu_torch.estimators.covariance import Covariance, CovarianceSpecification
from porqua_tpu_torch.estimators.mean import MeanEstimator
from porqua_tpu_torch.optimization_data import OptimizationData
from porqua_tpu_torch.optimization import (
    Optimization,
    OptimizationParameter,
    Objective,
    EmptyOptimization,
    MeanVariance,
    QEQW,
    LeastSquares,
    WeightedLeastSquares,
    LAD,
    PercentilePortfolios,
)
from porqua_tpu_torch.selection import Selection
from porqua_tpu_torch.builders import SelectionItemBuilder, OptimizationItemBuilder
from porqua_tpu_torch.portfolio import Portfolio, Strategy, floating_weights
from porqua_tpu_torch.backtest import Backtest, BacktestData, BacktestService
from porqua_tpu_torch.batch import (
    FIXED_UNIVERSE,
    as_requests,
    build_problems,
    run_batch,
    solve_scan_l1,
    solve_scan_l1_grid,
    solve_batch_compacted,
    solve_scan_turnover,
)
from porqua_tpu_torch.compaction import CompactingDriver, CompactionReport
from porqua_tpu_torch.compare import available_backends, compare_solvers
from porqua_tpu_torch.checkpoint import (
    run_batch_checkpointed,
    solve_scan_l1_checkpointed,
)
from porqua_tpu_torch.synthetic import synthetic_usa_np
from porqua_tpu_torch.tracking import (
    TrackingResult,
    build_tracking_qp,
    synthetic_universe_np,
    tracking_step,
)

__all__ = [
    "Constraints", "CanonicalQP", "QPSolution", "SolverParams", "Status",
    "solve_qp", "solve_qp_batch", "solve_qp_diff", "solve_qp_l1_diff",
    "Covariance", "CovarianceSpecification", "MeanEstimator",
    "OptimizationData", "Optimization", "OptimizationParameter",
    "Objective", "EmptyOptimization", "MeanVariance", "QEQW",
    "LeastSquares", "WeightedLeastSquares", "LAD", "PercentilePortfolios",
    "Selection", "SelectionItemBuilder", "OptimizationItemBuilder",
    "Portfolio", "Strategy", "floating_weights",
    "Backtest", "BacktestData", "BacktestService",
    "FIXED_UNIVERSE", "as_requests", "build_problems", "run_batch",
    "solve_scan_l1", "solve_scan_l1_grid", "solve_scan_turnover",
    "solve_batch_compacted", "CompactingDriver", "CompactionReport",
    "run_batch_checkpointed", "solve_scan_l1_checkpointed",
    "compare_solvers", "available_backends",
    "synthetic_usa_np",
    "TrackingResult", "build_tracking_qp", "synthetic_universe_np",
    "tracking_step",
]
