"""Canonical QP form, equilibration, the batched first-order solvers
(ADMM, PDHG, NAPG), the active-set polish, the solve API, the
differentiable solve and the count-sketch embedding (PyTorch)."""

from porqua_tpu_torch.qp.admm import ADMMCarry, ADMMState, SolverParams, Status
from porqua_tpu_torch.qp.canonical import (HP, CanonicalQP, SketchDraws,
                                           pad_qp, sketch_draws, sketch_rows,
                                           stack_qps)
from porqua_tpu_torch.qp.diff import solve_qp_diff, solve_qp_l1_diff
from porqua_tpu_torch.qp.napg import NAPGCarry
from porqua_tpu_torch.qp.pdhg import PDHGCarry
from porqua_tpu_torch.qp.ruiz import Scaling, equilibrate, equilibrate_factored
from porqua_tpu_torch.qp.solve import QPSolution, solve_qp, solve_qp_batch
from porqua_tpu_torch.qp.sketch import (SketchInfo, SketchParams,
                                        gram_rel_err, sketched_tracking_qp,
                                        tracking_step_sketched)

__all__ = [
    "ADMMCarry", "ADMMState", "CanonicalQP", "HP", "NAPGCarry", "PDHGCarry",
    "QPSolution", "Scaling", "SketchDraws", "SketchInfo", "SketchParams",
    "SolverParams", "Status", "equilibrate", "equilibrate_factored",
    "gram_rel_err", "pad_qp", "sketch_draws", "sketch_rows",
    "sketched_tracking_qp", "solve_qp", "solve_qp_batch", "solve_qp_diff",
    "solve_qp_l1_diff", "stack_qps",
    "tracking_step_sketched",
]
