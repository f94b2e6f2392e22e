"""Differentiable QP solve: gradients through the optimizer (PyTorch).

The reference's solver boundary is a black box — ``qpsolvers`` hands
back a float array and the chain rule stops there (reference
``src/qp_problems.py:211``). Here the solve is an implicit function of
its inputs, so hyperparameters that shape the problem — ridge
strength, covariance shrinkage, transaction-cost weights, constraint
bounds — can be tuned by gradient descent through objective assembly,
the batched solve and the P&L.

Method (Amos & Kolter's OptNet sensitivity / standard NLP sensitivity):
at a solution with active set A fixed and strict complementarity, x*
solves the equality-constrained KKT system

    [P     C_A'  E_A'] [x ]   [-q ]
    [C_A   0     0   ] [nu] = [bC ]   (active general rows)
    [E_A   0     0   ] [tau]  [bB ]   (active box coordinates)

and the solution map's vjp needs one solve with the same (symmetric)
KKT operator: K [u, wC, wB] = [g, 0, 0] for the incoming cotangent g.
The solve reuses the polish's active-set KKT solvers (``qp/polish.py``:
the factored capacitance solve where the objective factor pays, the
dense penalty-Schur solve with refinement otherwise), so the adjoint
is as accurate as the polish. Cotangents follow from
F(x, nu, tau; theta) = 0:

    q_bar  = -u
    P_bar  = -(u x' + x u') / 2            (P symmetric)
    C_bar  = -(nu u' + wC x')              (zero on inactive rows)
    bound_bar = +wC / +wB, routed to l/u (lb/ub) by the active side.

Each vjp is a ``torch.autograd.Function`` over a batch with a leading
lane axis B (the port's explicit form of ``jax.vmap``): ``forward``
takes the :class:`CanonicalQP` fields flat (``Pf``/``Pdiag`` may be
``None``) and runs the solver's own ``_solve_impl``, so with
``backend="pallas"`` on the card the forward launches the fused
segment kernels; ``backward`` classifies every lane's active set and
solves every lane's adjoint at once, with no host read per lane.

Caveats, stated rather than hidden:

* The map x*(theta) is piecewise-smooth; at an active-set change the
  gradient is a subgradient of the piece the classifier picks. Strict
  complementarity is the differentiability condition.
* Gradients are meaningful only where ``status == SOLVED``; the
  backward zeroes the cotangents of any other lane, and of a lane whose
  adjoint factorization failed (NaN), instead of propagating garbage.
* No second derivative is defined (``once_differentiable``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from porqua_tpu_torch.qp.canonical import HP, CanonicalQP
from porqua_tpu_torch.qp.polish import (
    _kkt_solve_dense,
    _kkt_solve_factored,
    _lane,
    classify_active,
    classify_l1,
    polish_capacitance_dim,
)
from porqua_tpu_torch.qp.solve import (
    QPSolution,
    SolverParams,
    Status,
    _solve_impl,
    resolve_device,
)

__all__ = ["solve_qp_diff", "solve_qp_l1_diff", "solve_qp_batch_diff",
           "solve_qp_batch_l1_diff", "active_sets", "l1_active_sets"]


def _classification_tols(sol: QPSolution, dtype):
    """Per-lane (prox_tol, dual_tol), (B,), for active-set
    classification at a solved point, both floored at 1e3 machine eps
    and scaled with the lane's own residuals: the gradient is taken on
    the piece the achieved accuracy can distinguish."""
    tiny = 1e3 * torch.finfo(dtype).eps
    tol = torch.clamp(10.0 * torch.maximum(sol.prim_res, sol.dual_res),
                      min=tiny)
    return tol, tol


def active_sets(qp: CanonicalQP, sol: QPSolution):
    """Classify active rows and box coordinates at a batch of solutions.

    Same criterion family as the polish (dual sign with an on-bound
    proximity fallback, ``qp/polish.py``); both thresholds scale with
    each lane's residuals, so at a loose eps a dual of the order of the
    solver tolerance is not read as decisively signed. Returns a
    6-tuple ``(aC, bound_C, aB, bound_B, up_side_C, up_side_B)``: float
    {0, 1} active masks, the active-side bound values (0 where inactive
    or infinite), and the boolean which-side indicators the bound
    cotangent routing uses; each (B, m) or (B, n).
    """
    dtype = qp.q.dtype
    prox, dual_tol = (t.unsqueeze(-1) for t in
                      _classification_tols(sol, dtype))
    (act_low_C, act_up_C, eq_C, act_low_B, act_up_B, eq_B
     ) = classify_active(qp, sol.z, sol.x, sol.y, sol.mu, prox, dual_tol)
    zero = torch.zeros((), dtype=dtype, device=qp.q.device)
    aC = ((act_low_C | act_up_C | eq_C) & (qp.row_mask > 0)).to(dtype)
    up_side_C = act_up_C & ~act_low_C
    bound_C = torch.where(up_side_C, qp.u, qp.l)
    bound_C = torch.where(torch.isfinite(bound_C), bound_C, zero) * aC

    aB = ((act_low_B | act_up_B | eq_B) & (qp.var_mask > 0)).to(dtype)
    up_side_B = act_up_B & ~act_low_B
    bound_B = torch.where(up_side_B, qp.ub, qp.lb)
    bound_B = torch.where(torch.isfinite(bound_B), bound_B, zero) * aB
    return aC, bound_C, aB, bound_B, up_side_C, up_side_B


def l1_active_sets(qp: CanonicalQP, sol: QPSolution, l1_weight, l1_center):
    """The native-L1 vjp's classification at a batch of solutions:
    ``(at_kink, sign_s, aC, box_act, up_side_C, up_side_B)``, booleans
    except the smooth-side signs ``sign_s`` in {-1, 0, 1}. The polish's
    own kink-vs-smooth split (``classify_l1`` at the solution's residual
    scale) with the one-sided sign at a zero weight, then the active
    rows and box coordinates against the box dual with the L1
    subgradient shrunk away; a coordinate both box-active and on its
    kink (the center on a box bound) counts as box-active only."""
    dtype = qp.q.dtype
    x = sol.x
    zero = torch.zeros((), dtype=dtype, device=x.device)
    err = torch.maximum(sol.prim_res, sol.dual_res)
    prox, dual_tol = (t.unsqueeze(-1) for t in
                      _classification_tols(sol, dtype))
    at_kink, sign_s, mu_box, window = classify_l1(
        x, sol.mu, l1_weight, l1_center, err, dual_mode="solution")
    # classify_l1 zeroes the sign of a coordinate whose weight is zero,
    # but the tuning derivative at w_i = 0 is the one-sided limit
    # -u_i sign(x_i - c_i) (switching on an infinitesimal penalty pulls
    # x_i toward c_i). Only a coordinate on the would-be kink has a
    # two-sided limit, where zero is the defensible subgradient.
    dead_side = torch.where((x - l1_center).abs() > window.unsqueeze(-1),
                            torch.sign(x - l1_center), zero)
    sign_s = torch.where(l1_weight > 0, sign_s, dead_side)
    (act_low_C, act_up_C, eq_C, act_low_B, act_up_B, eq_B
     ) = classify_active(qp, sol.z, x, sol.y, mu_box, prox, dual_tol)
    aC = (act_low_C | act_up_C | eq_C) & (qp.row_mask > 0)
    box_act = (act_low_B | act_up_B | eq_B) & (qp.var_mask > 0)
    return (at_kink & ~box_act, sign_s, aC, box_act, act_up_C & ~act_low_C,
            act_up_B & ~act_low_B)


def _adjoint_kkt_solve(qp: CanonicalQP, params: SolverParams, aC, aB, g):
    """Solve the symmetric active-set KKT adjoint system per lane

        P u + C'(aC*wC) + aB*wB = g,   aC*(C u) = 0,   aB*u = 0

    — the polish's equality-KKT system with the rhs ``-q_eff`` replaced
    by the cotangent ``g`` and every active bound at zero, so it runs
    the polish's own solvers (``qp/polish.py``): the exact-pinning
    capacitance solve when the objective factor pays
    (``polish_capacitance_dim``), the dense penalty-Schur solve with
    refinement otherwise. Returns ``(u, wC, wB)``; a lane whose
    factorization failed carries NaN."""
    dtype, device = qp.q.dtype, qp.q.device
    delta = torch.maximum(
        torch.tensor(params.polish_delta, dtype=dtype, device=device),
        torch.sqrt(torch.tensor(torch.finfo(dtype).eps, dtype=dtype,
                                device=device)))
    solver = (_kkt_solve_factored
              if polish_capacitance_dim(qp) is not None
              else _kkt_solve_dense)
    return solver(qp, params, aB, aC, torch.zeros_like(qp.q),
                  torch.zeros_like(qp.l), -g, delta)


def _outer(a, b):
    """Batched outer product: (B, r) x (B, c) -> (B, r, c)."""
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def _qp_cotangents(qp, sol, u, wC, aC, up_side_C, lb_bar, ub_bar):
    """The differentiable fields' cotangents shared by the smooth and
    native-L1 vjps, ``(P, q, C, l, u, lb, ub)``; callers supply their
    own box-bound routing.

    Bound cotangents: +w on the active side (F2 = aC*(Cx - bound) has
    d/dbound = -aC, so bound_bar = +wC; likewise box). Equality rows
    (l == u) classify as lower-side by convention — their cotangent
    lands on l; callers moving an equality bound move both l and u
    together, so the total differential is identical.
    """
    x = sol.x
    nu = aC * sol.y
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (-0.5 * (_outer(u, x) + _outer(x, u)),
            -u,
            -(_outer(nu, u) + _outer(wC, x)),
            torch.where(up_side_C, zero, wC),
            torch.where(up_side_C, wC, zero),
            lb_bar,
            ub_bar)


def _live_lanes(sol: QPSolution, *adjoint):
    """(B,) lanes whose cotangents are kept: SOLVED, with a finite
    adjoint solve (a failed factorization leaves NaN in its lane)."""
    ok = sol.status == Status.SOLVED
    for t in adjoint:
        ok = ok & torch.isfinite(t).all(dim=-1)
    return ok


def _mask_lanes(ok, grads):
    """Zero every cotangent of the lanes outside ``ok`` (a select, not a
    product: a NaN lane must end as zeros)."""
    return tuple(torch.where(_lane(ok, t), t,
                             torch.zeros((), dtype=t.dtype, device=t.device))
                 for t in grads)


def _zero_cotangents(ctx, fields, first):
    """Zeros for the inputs at positions ``first..`` that need a
    gradient (the masks, ``constant`` and the factor aliases: ``P``
    alone determines the solution), ``None`` for the rest."""
    return tuple(
        torch.zeros_like(f) if f is not None and ctx.needs_input_grad[i]
        else None
        for i, f in enumerate(fields, start=first))


_N_DIFF = 7          # P, q, C, l, u, lb, ub: the differentiable fields


class _SolveQPDiff(torch.autograd.Function):
    """``_solve_impl(qp, params).x`` over a batch, with the implicit-
    function vjp. Inputs: ``params`` then the 12 CanonicalQP fields."""

    @staticmethod
    def forward(ctx, params, *fields):
        qp = CanonicalQP(*fields)
        sol = _solve_impl(qp, params)
        ctx.params = params
        ctx.save_for_backward(*fields, sol.x, sol.z, sol.y, sol.mu,
                              sol.status, sol.prim_res, sol.dual_res)
        return sol.x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        HP.apply()
        saved = ctx.saved_tensors
        fields, (x, z, y, mu, status, prim_res, dual_res) = (
            saved[:12], saved[12:])
        qp = CanonicalQP(*fields)
        sol = _partial_solution(x, z, y, mu, status, prim_res, dual_res)
        params = ctx.params
        ok = (sol.status == Status.SOLVED).to(g.dtype)
        g = g * ok.unsqueeze(-1)

        aC, _, aB, _, up_side_C, up_side_B = active_sets(qp, sol)
        u, wC, wB = _adjoint_kkt_solve(qp, params, aC, aB, g)

        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        lb_bar = torch.where(up_side_B, zero, wB)
        ub_bar = torch.where(up_side_B, wB, zero)
        grads = _qp_cotangents(qp, sol, u, wC, aC, up_side_C, lb_bar,
                               ub_bar)
        grads = _mask_lanes(_live_lanes(sol, u, wC, wB), grads)
        return (None, *grads,
                *_zero_cotangents(ctx, fields[_N_DIFF:], 1 + _N_DIFF))


class _SolveQPL1Diff(torch.autograd.Function):
    """``_solve_impl(qp, params, l1_weight, l1_center).x`` over a batch,
    with the native-L1 vjp. Inputs: ``params``, the 12 CanonicalQP
    fields, ``l1_weight``, ``l1_center`` (may be ``None``)."""

    @staticmethod
    def forward(ctx, params, *inputs):
        fields, l1_weight, l1_center = inputs[:12], inputs[12], inputs[13]
        qp = CanonicalQP(*fields)
        sol = _solve_impl(qp, params, l1_weight=l1_weight,
                          l1_center=l1_center)
        ctx.params = params
        ctx.save_for_backward(*fields, l1_weight, l1_center, sol.x, sol.z,
                              sol.y, sol.mu, sol.status, sol.prim_res,
                              sol.dual_res)
        return sol.x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        HP.apply()
        saved = ctx.saved_tensors
        fields, w, c_in = saved[:12], saved[12], saved[13]
        sol = _partial_solution(*saved[14:])
        qp = CanonicalQP(*fields)
        params = ctx.params
        dtype = g.dtype
        zero = torch.zeros((), dtype=dtype, device=g.device)
        # The forward solve treats a missing center as zeros (the
        # polish's convention); the backward does too, and hands back
        # no cotangent for a None input.
        c = torch.zeros_like(qp.q) if c_in is None else c_in
        ok = (sol.status == Status.SOLVED).to(dtype)
        g = g * ok.unsqueeze(-1)

        at_kink, sign_s, aC, box_act, up_side_C, up_side_B = l1_active_sets(
            qp, sol, w, c)
        sign_s = sign_s.to(dtype)
        aC = aC.to(dtype)

        aB_all = (box_act | at_kink).to(dtype)
        u, wC, wB = _adjoint_kkt_solve(qp, params, aC, aB_all, g)

        lb_bar = torch.where(box_act & ~up_side_B, wB, zero)
        ub_bar = torch.where(box_act & up_side_B, wB, zero)
        c_bar = torch.where(at_kink, wB, zero)
        w_bar = -u * sign_s
        grads = _qp_cotangents(qp, sol, u, wC, aC, up_side_C, lb_bar,
                               ub_bar) + (w_bar, c_bar)
        grads = _mask_lanes(_live_lanes(sol, u, wC, wB), grads)
        w_bar, c_bar = grads[-2:]
        return (None, *grads[:-2],
                *_zero_cotangents(ctx, fields[_N_DIFF:], 1 + _N_DIFF),
                w_bar, None if c_in is None else c_bar)


def _partial_solution(x, z, y, mu, status, prim_res, dual_res):
    """A :class:`QPSolution` holding the fields the backward reads."""
    none = None
    return QPSolution(x=x, z=z, y=y, mu=mu, status=status, iters=none,
                      prim_res=prim_res, dual_res=dual_res, obj_val=none,
                      duality_gap=none)


def solve_qp_batch_diff(qp: CanonicalQP,
                        params: SolverParams = SolverParams(),
                        device=None) -> torch.Tensor:
    """``solve_qp_batch(qp, params).x`` (a batch with a leading axis)
    with an implicit-function vjp, on ``device`` (default: the card).

    Differentiable in ``P, q, C, l, u, lb, ub``; the ``Pf``/``Pdiag``
    factor fields, the masks and ``constant`` get zero cotangents (``P``
    alone determines the solution, the factor is a computational alias:
    gradients w.r.t. data that built both flow through ``P``). Applies
    the precision policy (no TF32), in the backward too."""
    dev = resolve_device(device)
    HP.apply()
    return _SolveQPDiff.apply(params, *qp.to(dev))


def solve_qp_batch_l1_diff(qp: CanonicalQP,
                           l1_weight,
                           l1_center,
                           params: SolverParams = SolverParams(),
                           device=None) -> torch.Tensor:
    """Differentiable batched solve of the native nonsmooth problem

        min 1/2 x'Px + q'x + sum_i w_i |x_i - c_i|   s.t. rows, box

    (the n-variable prox path, not the reference's 2n lift), on
    ``device`` (default: the card). Locally the L1 term splits the
    coordinates: kink-resters (x_i = c_i, dual strictly inside
    [-w_i, w_i]) behave as pinned equalities at c_i, and smooth-side
    coordinates see a constant gradient w_i sign(x_i - c_i) — the
    classification the prox-aware polish uses. The vjp adds two
    cotangents to :func:`solve_qp_batch_diff`'s:

        w_bar_i = -u_i sign_i   (smooth coordinates; also the one-sided
                                 limit at w_i = 0)
        c_bar_i = +wB_i         (kink-resters, via their pin row)

    At a classification change the gradient is one-sided, as for the
    active sets. A center on a box bound makes the pin and the bound
    coincide: the box cotangent wins. ``l1_center=None`` is a zero
    center and gets no cotangent."""
    dev = resolve_device(device)
    HP.apply()
    move = lambda t: None if t is None else torch.as_tensor(t).to(dev)
    return _SolveQPL1Diff.apply(params, *qp.to(dev), move(l1_weight),
                                move(l1_center))


def _one(qp: CanonicalQP) -> CanonicalQP:
    return CanonicalQP(*(None if f is None else f.unsqueeze(0) for f in qp))


def solve_qp_diff(qp: CanonicalQP,
                  params: SolverParams = SolverParams(),
                  device=None) -> torch.Tensor:
    """One problem (no batch axis) through :func:`solve_qp_batch_diff`,
    as a batch of one; returns its x with the vjp attached."""
    return solve_qp_batch_diff(_one(qp), params, device=device)[0]


def solve_qp_l1_diff(qp: CanonicalQP,
                     l1_weight,
                     l1_center,
                     params: SolverParams = SolverParams(),
                     device=None) -> torch.Tensor:
    """One problem (no batch axis) through
    :func:`solve_qp_batch_l1_diff`, as a batch of one."""
    add = lambda t: None if t is None else torch.as_tensor(t).unsqueeze(0)
    return solve_qp_batch_l1_diff(_one(qp), add(l1_weight), add(l1_center),
                                  params, device=device)[0]
