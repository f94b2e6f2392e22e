"""Public QP solve API: batched and single.

equilibrate -> ADMM -> polish -> unscale, on the device the problem's
tensors live on. ``solve_qp_batch`` solves a batch (leading axis);
``solve_qp`` is the one-problem case.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from porqua_tpu_torch.qp.admm import (
    ADMMState,
    SolverParams,
    Status,
    admm_init,
    admm_segment_step,
    admm_solve,
    _residuals,
    _support,
)
from porqua_tpu_torch.qp.canonical import HP, CanonicalQP
from porqua_tpu_torch.qp.polish import polish_iterate as _polish_iterate
from porqua_tpu_torch.qp.ruiz import Scaling, equilibrate, equilibrate_factored


def _backend(params: SolverParams):
    """Resolve ``params.method`` to the ``(init, segment_step, solve)``
    triple of the selected first-order backend. Only ADMM is ported; a
    typo'd or not-yet-ported method fails loudly instead of silently
    running another solver."""
    if params.method == "admm":
        return admm_init, admm_segment_step, admm_solve
    if params.method in ("pdhg", "napg"):
        raise NotImplementedError(
            f"method {params.method!r} is not ported to PyTorch yet; "
            "use method='admm'")
    raise ValueError(
        f"unknown method {params.method!r}; expected 'admm', 'pdhg' "
        "or 'napg'")


class QPSolution(NamedTuple):
    """Solution + certificates, per lane."""

    x: torch.Tensor          # (B, n) primal solution (unscaled)
    z: torch.Tensor          # (B, m) constraint activity Cx (unscaled)
    y: torch.Tensor          # (B, m) duals for C rows (unscaled)
    mu: torch.Tensor         # (B, n) duals for box (unscaled)
    status: torch.Tensor     # (B,) int32, see Status
    iters: torch.Tensor      # (B,) int32
    prim_res: torch.Tensor   # (B,) unscaled primal residual (inf-norm)
    dual_res: torch.Tensor   # (B,) unscaled dual residual (inf-norm)
    obj_val: torch.Tensor    # (B,) 0.5 x'Px + q'x + constant
    duality_gap: torch.Tensor  # (B,) |primal - dual objective|
    ring_prim: Optional[torch.Tensor] = None
    ring_dual: Optional[torch.Tensor] = None
    ring_rho: Optional[torch.Tensor] = None

    @property
    def found(self):
        return self.status == Status.SOLVED


def _prepare_impl(qp: CanonicalQP,
                  params: SolverParams,
                  x0=None,
                  y0=None,
                  l1_weight=None,
                  l1_center=None):
    """Equilibrate and map warm starts / the native L1 term into the
    scaled frame. Returns ``(scaled, scaling, x0_s, y0_s, l1w_s, l1c_s)``."""
    if params.scaling_mode == "factored":
        scaled, scaling = equilibrate_factored(qp)
    elif params.scaling_mode == "ruiz":
        scaled, scaling = equilibrate(qp, iters=params.scaling_iters)
    else:
        raise ValueError(
            f"unknown scaling_mode {params.scaling_mode!r}; "
            "expected 'ruiz' or 'factored'")

    c = scaling.c[..., None]
    x0_s = None if x0 is None else x0 / scaling.D
    y0_s = None if y0 is None else c * y0 / torch.where(
        scaling.E > 0, scaling.E, torch.ones_like(scaling.E))
    # sum_i w_i |x_i - c_i| in the original frame becomes
    # sum_i (c w_i D_i) |xhat_i - c_i / D_i| in the scaled frame.
    l1w_s = None if l1_weight is None else c * l1_weight * scaling.D
    l1c_s = None if l1_center is None else l1_center / scaling.D
    return scaled, scaling, x0_s, y0_s, l1w_s, l1c_s


def _finalize_impl(qp: CanonicalQP,
                   scaled: CanonicalQP,
                   scaling: Scaling,
                   state: ADMMState,
                   params: SolverParams,
                   l1_weight=None,
                   l1_center=None,
                   l1w_s=None,
                   l1c_s=None) -> QPSolution:
    """Retire a still-RUNNING lane to MAX_ITER, polish, re-grade a
    MAX_ITER lane SOLVED if its (polished) point meets tolerance,
    unscale, and assemble the :class:`QPSolution`. This is the
    "MAX_ITER + polish fallback": a lane retired out of budget still
    gets the active-set polish."""
    status = torch.where(state.status == Status.RUNNING, Status.MAX_ITER,
                         state.status).to(torch.int32)
    x, z, w, y, mu = state.x, state.z, state.w, state.y, state.mu

    # Active-set polish, prox-aware with a live L1 term (qp/polish.py).
    if params.polish:
        x, z, w, y, mu = _polish_iterate(
            scaled, scaling, params, x, z, w, y, mu,
            l1_weight=l1w_s, l1_center=l1c_s)

    r_prim, r_dual, eps_p, eps_d, _, _ = _residuals(
        scaled, scaling, x, z, w, y, mu, params
    )
    solved_now = (r_prim <= eps_p) & (r_dual <= eps_d)
    status = torch.where((status == Status.MAX_ITER) & solved_now,
                         Status.SOLVED, status).to(torch.int32)

    cinv = (1.0 / scaling.c)[..., None]
    x_u = scaling.D * x * qp.var_mask
    z_u = z / torch.where(scaling.E > 0, scaling.E, torch.ones_like(scaling.E))
    y_u = cinv * scaling.E * y * qp.row_mask
    mu_u = cinv * (1.0 / scaling.D) * mu * qp.var_mask

    dot = lambda a, b: torch.sum(a * b, dim=-1)
    obj = qp.objective_value(x_u)
    c_vec = torch.zeros_like(x_u) if l1_center is None else l1_center
    if l1_weight is not None:
        obj = obj + torch.sum(l1_weight * (x_u - c_vec).abs(), dim=-1)
    # Duality gap against the original bounds.
    if l1_weight is None:
        gap = torch.abs(
            dot(x_u, qp.apply_P(x_u)) + dot(qp.q, x_u)
            + _support(qp.u, qp.l, y_u) + _support(qp.ub, qp.lb, mu_u)
        )
    else:
        # With a native L1 term the box dual carries the L1 subgradient
        # g = clip(mu, -w, w); the conjugate of the L1 term adds c'g.
        g = torch.clamp(mu_u, -l1_weight, l1_weight)
        gap = torch.abs(
            dot(x_u, qp.apply_P(x_u)) + dot(qp.q, x_u)
            + torch.sum(l1_weight * (x_u - c_vec).abs(), dim=-1)
            + dot(c_vec, g)
            + _support(qp.u, qp.l, y_u) + _support(qp.ub, qp.lb, mu_u - g)
        )

    return QPSolution(
        x=x_u, z=z_u, y=y_u, mu=mu_u,
        status=status,
        iters=state.iters,
        prim_res=r_prim,
        dual_res=r_dual,
        obj_val=obj,
        duality_gap=gap,
    )


def _solve_impl(qp: CanonicalQP,
                params: SolverParams,
                x0=None,
                y0=None,
                l1_weight=None,
                l1_center=None) -> QPSolution:
    HP.check()
    _, _, solver = _backend(params)
    scaled, scaling, x0_s, y0_s, l1w_s, l1c_s = _prepare_impl(
        qp, params, x0, y0, l1_weight, l1_center)
    state = solver(scaled, scaling, params, x0=x0_s, y0=y0_s,
                   l1_weight=l1w_s, l1_center=l1c_s)
    return _finalize_impl(qp, scaled, scaling, state, params,
                          l1_weight, l1_center, l1w_s, l1c_s)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. With no card and no ``device``, raise: there is no
    silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda")


def default_segment_budget(params: SolverParams) -> int:
    """The per-lane segment budget that reproduces plain ``max_iter``
    semantics: ``ceil(max_iter / check_interval)``."""
    return max(1, math.ceil(params.max_iter / params.check_interval))


def select_lanes(mask, new, old):
    """Per-lane select over nested tuples of tensors: ``mask`` is (B,),
    leaves are (B, ...); ``None`` leaves stay ``None``. The freeze the
    batched while_loop applies to lanes whose condition went false."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)
    parts = [select_lanes(mask, a, b) for a, b in zip(new, old)]
    return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)


def solve_qp_batch(qp: CanonicalQP,
                   params: SolverParams = SolverParams(),
                   x0=None,
                   y0=None,
                   l1_weight=None,
                   l1_center=None,
                   device=None) -> QPSolution:
    """Solve a batch of canonical QPs (leading axis) on ``device``
    (default: the card). Applies the precision policy (no TF32)."""
    dev = resolve_device(device)
    HP.apply()
    move = lambda t: None if t is None else t.to(dev)
    return _solve_impl(qp.to(dev), params, move(x0), move(y0),
                       move(l1_weight), move(l1_center))


def solve_qp(qp: CanonicalQP,
             params: SolverParams = SolverParams(),
             x0=None,
             y0=None,
             l1_weight=None,
             l1_center=None,
             device=None) -> QPSolution:
    """Solve one canonical QP (no batch axis): a batch of one."""
    add = lambda t: None if t is None else t.unsqueeze(0)
    sol = solve_qp_batch(CanonicalQP(*(add(f) for f in qp)), params,
                         add(x0), add(y0), add(l1_weight), add(l1_center),
                         device=device)
    return QPSolution(*(None if f is None else f[0] for f in sol))
