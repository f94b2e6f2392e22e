"""Canonical QP form, equilibration, the batched ADMM solver, the
active-set polish and the solve API (PyTorch)."""

from porqua_tpu_torch.qp.admm import ADMMCarry, ADMMState, SolverParams, Status
from porqua_tpu_torch.qp.canonical import HP, CanonicalQP, pad_qp, stack_qps
from porqua_tpu_torch.qp.ruiz import Scaling, equilibrate, equilibrate_factored
from porqua_tpu_torch.qp.solve import QPSolution, solve_qp, solve_qp_batch

__all__ = [
    "ADMMCarry", "ADMMState", "CanonicalQP", "HP", "QPSolution", "Scaling",
    "SolverParams", "Status", "equilibrate", "equilibrate_factored",
    "pad_qp", "solve_qp", "solve_qp_batch", "stack_qps",
]
