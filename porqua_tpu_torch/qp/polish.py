"""Active-set solution polish for the ADMM solver (PyTorch, batched).

A first-order iterate lands near the optimum; the polish lands on it.
It guesses the active constraint set from the iterate's duals and
slacks, then solves the equality-constrained KKT system of that set

    [[P + dI,  C_act',  I_act],      [x ]     [-q        ]
     [C_act,   -dI,     0    ],   @  [nu]  =  [bound_act ]
     [I_act,   0,       -dI  ]]      [tau]    [boundb_act]

with inactive dual rows pinned to zero so every lane keeps one shape.
Where the objective factor pays (``polish_capacitance_dim``) the
actives are pinned exactly and the projected Hessian is solved through
the Woodbury capacitance operator; otherwise the dual rows are
eliminated into the SPD Schur complement ``P + dI + (1/d)(C_a' C_a +
I_a)`` and solved by Cholesky with refinement against the unperturbed
KKT residuals. A lane takes the polished point only where it lowers the
larger of its residuals, so polish never hurts.

Every function works on a batch with a leading lane axis B: where the
JAX package vmapped one problem, each accept/thread select here is a
per-lane mask, the m active-row solves of the factored path are one
multi-right-hand-side solve, and a factorization that fails on one
lane leaves NaN in that lane only (which rejects its candidate), never
an exception for the batch.
"""

from __future__ import annotations

import math

import torch

from porqua_tpu_torch.qp.admm import (
    SolverParams,
    _mv,
    _residuals,
    _vm,
    cholesky_lanes,
    factored_solve_from_pieces,
    factored_solve_pieces,
    solve_lanes,
)
from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.qp.ruiz import Scaling


def polish_capacitance_dim(qp: CanonicalQP):
    """Capacitance dimension (r + m) the factored polish uses for this
    problem, or ``None`` when the dense penalty polish runs."""
    if qp.Pf is None:
        return None
    k = qp.Pf.shape[-2] + qp.m
    return k if k < qp.n else None


def _lane(mask, t):
    """Broadcast a (B,) lane mask against ``t`` (B, ...)."""
    return mask.reshape(mask.shape + (1,) * (t.dim() - 1))


def _kkt_solve_factored(qp: CanonicalQP, params: SolverParams,
                        aB, aC, bound_B, bound_C, q_eff, delta):
    """Active-set KKT solve in the factored (Woodbury) regime, actives
    pinned exactly:

        x = aB * bound_B + Z x_f,   Z = 1 - aB,
        (Z P Z + diag(aB) + sigma I) x_f = Z (-q_eff - P x_a - C'aC nu),
        aC C x = aC bound_C           (Schur complement on the m duals)

    The projected Hessian keeps the factor form (Z P Z = 2 (Pf Z)'(Pf Z)
    + diag(Pdiag Z)), so every solve is an (r+m)-dimensional
    capacitance solve, and the refinement iterates the true KKT
    residuals with no 1/d amplification."""
    dtype = qp.q.dtype
    m = qp.m
    sigma = delta
    pd = torch.zeros_like(qp.q) if qp.Pdiag is None else qp.Pdiag
    Z = 1.0 - aB
    x_a = aB * bound_B

    Dt = aB + sigma + pd * Z
    V = math.sqrt(2.0) * qp.Pf * Z.unsqueeze(-2)
    inv_d, W = factored_solve_pieces(Dt, V)
    refine = params.woodbury_refine
    psolve = factored_solve_from_pieces(Dt, V, inv_d, W, refine)
    # The m right-hand sides at once: an extra axis after the lane axis.
    psolve_rows = factored_solve_from_pieces(
        Dt.unsqueeze(1), V.unsqueeze(1), inv_d.unsqueeze(1),
        W.unsqueeze(1), refine)

    CaT = qp.C * aC.unsqueeze(-1)                      # (B, m, n) masked rows
    Y = psolve_rows(Z.unsqueeze(1) * CaT).transpose(-1, -2)   # (B, n, m)
    G_raw = aC.unsqueeze(-1) * torch.matmul(qp.C, Y)          # (B, m, m)
    # A row whose every variable is pinned (C_i Z == 0) has a Schur
    # diagonal of exactly 0 and makes G singular: drop it from the
    # Schur system (the pinned coordinates already carry its content).
    # The cutoff only absorbs roundoff, relative to the lane's largest
    # diagonal with no absolute floor.
    gdiag = torch.diagonal(G_raw, dim1=-2, dim2=-1).abs()
    gmax = (gdiag.amax(dim=-1, keepdim=True) if m
            else gdiag.new_zeros(gdiag.shape[:-1] + (1,)))
    dead = (aC > 0) & (gdiag <= 1e3 * torch.finfo(dtype).eps * gmax)
    aC_eff = aC * (1.0 - dead.to(dtype))
    Y = Y * aC_eff.unsqueeze(-2)
    G = (aC_eff.unsqueeze(-1) * G_raw * aC_eff.unsqueeze(-2)
         + torch.diag_embed(1.0 - aC_eff))

    def schur_step(rhs_z, r2):
        b0 = psolve(rhs_z)
        g = aC_eff * _mv(qp.C, b0) - r2
        dnu = solve_lanes(G, g.unsqueeze(-1)).squeeze(-1)
        return b0 - _mv(Y, dnu), dnu

    x, nu = x_a, torch.zeros_like(qp.l)
    for _ in range(1 + params.polish_refine_steps):
        s = qp.apply_P(x) + q_eff + _vm(aC_eff * nu, qp.C)
        r2 = aC_eff * (bound_C - _mv(qp.C, x))
        dx, dnu = schur_step(-Z * s, r2)
        x = x + dx
        nu = nu + dnu

    tau = -aB * (qp.apply_P(x) + q_eff + _vm(aC_eff * nu, qp.C))
    return x, aC_eff * nu, tau


def classify_l1(x, mu, l1_weight, l1_center, err, dual_mode="iterate"):
    """Kink-vs-smooth classification of a native-L1 point, per entry.

    Candidates within a window that tracks ``err`` of the kink are
    classified by the dual: at (near-)optimality the combined box dual
    carries the L1 subgradient, strictly inside [-w, w] for variables
    resting on the kink and at +/-w for smooth-side ones. Returns
    ``(at_kink, sub_sign, mu_box_est, window)``: ``mu_box_est`` is the
    dual with the L1 subgradient shrunk away, ``sub_sign`` the fixed
    local gradient sign of smooth live variables. ``err`` is per lane
    (B,). ``dual_mode="iterate"`` counts |mu| <= 0.75 w as interior (a
    wrong guess costs a rejected pass); ``"solution"`` uses the exact
    margin ``w - max(10 err, sqrt(eps) w)``."""
    dtype = x.dtype
    kink_tol = math.sqrt(torch.finfo(dtype).eps)
    live = l1_weight > 0
    window = 10.0 * (err + kink_tol)                      # (B,)
    near = live & ((x - l1_center).abs() <= window.unsqueeze(-1))
    if dual_mode == "iterate":
        dual_interior = mu.abs() <= 0.75 * l1_weight
    else:
        slack = torch.maximum(10.0 * err.unsqueeze(-1), kink_tol * l1_weight)
        dual_interior = mu.abs() <= l1_weight - slack
    at_kink = near & dual_interior
    sub_sign = torch.where(
        live & ~at_kink,
        torch.where(near, torch.sign(mu), torch.sign(x - l1_center)),
        torch.zeros_like(x))
    mu_box_est = mu - torch.maximum(torch.minimum(mu, l1_weight), -l1_weight)
    return at_kink, sub_sign, mu_box_est, window


def classify_active(qp: CanonicalQP, zC, xB, y, mu, prox_tol, dual_tol):
    """Active-set classification: dual sign (OSQP's criterion) with an
    on-(finite-)bound proximity fallback, equality rows/boxes always
    active. ``zC``/``xB`` are the row activities and box variables of
    the point being classified. Returns ``(act_low_C, act_up_C, eq_C,
    act_low_B, act_up_B, eq_B)``."""
    fin = torch.isfinite
    act_low_C = (y < -dual_tol) | (fin(qp.l) & (zC - qp.l <= prox_tol))
    act_up_C = (y > dual_tol) | (fin(qp.u) & (qp.u - zC <= prox_tol))
    eq_C = fin(qp.l) & fin(qp.u) & ((qp.u - qp.l) <= 1e-10)
    act_low_B = (mu < -dual_tol) | (fin(qp.lb) & (xB - qp.lb <= prox_tol))
    act_up_B = (mu > dual_tol) | (fin(qp.ub) & (qp.ub - xB <= prox_tol))
    eq_B = fin(qp.lb) & fin(qp.ub) & ((qp.ub - qp.lb) <= 1e-10)
    return act_low_C, act_up_C, eq_C, act_low_B, act_up_B, eq_B


def _kkt_solve_dense(qp: CanonicalQP, params: SolverParams,
                     aB, aC, bound_B, bound_C, q_eff, delta):
    """Active-set KKT solve, dense penalty-Schur form:

        M = P + delta I + (1/delta)(C' diag(aC) C + diag(aB))

    by Cholesky, refined against the unperturbed KKT residuals so the
    fixed point is the true active-set solution (OSQP's scheme,
    reduced)."""
    inv_d = 1.0 / delta
    bC = aC * bound_C
    bB = aB * bound_B
    eye = torch.eye(qp.n, dtype=qp.q.dtype, device=qp.q.device)
    M = (qp.P + delta * eye
         + inv_d * (torch.matmul(qp.C.transpose(-1, -2) * aC.unsqueeze(-2),
                                 qp.C) + torch.diag_embed(aB)))
    chol = cholesky_lanes(M)

    def msolve(v):
        return torch.cholesky_solve(v.unsqueeze(-1), chol).squeeze(-1)

    x_i = msolve(-q_eff + inv_d * (_vm(bC, qp.C) + bB))
    nu = aC * (_mv(qp.C, x_i) - bound_C) * inv_d
    tau = aB * (x_i - bound_B) * inv_d
    for _ in range(params.polish_refine_steps):
        r1 = -q_eff - (_mv(qp.P, x_i) + _vm(nu, qp.C) + tau)
        r2 = aC * (bound_C - _mv(qp.C, x_i))
        r3 = aB * (bound_B - x_i)
        dx = msolve(r1 + inv_d * (_vm(r2, qp.C) + r3))
        nu = nu + aC * (_mv(qp.C, dx) - r2) * inv_d
        tau = tau + aB * (dx - r3) * inv_d
        x_i = x_i + dx
    return x_i, nu, tau


def polish(qp: CanonicalQP,
           scaling: Scaling,
           params: SolverParams,
           x, z, w, y, mu,
           l1_weight=None,
           l1_center=None):
    """One polish pass; returns possibly-improved (x, z, w, y, mu).
    With a native L1 term (scaled frame) the polish is prox-aware:
    variables on the kink are pinned there, the rest see a fixed
    subgradient that shifts q."""
    return polish_iterate(qp, scaling, params, x, z, w, y, mu,
                          l1_weight, l1_center, passes=1)


def polish_iterate(qp: CanonicalQP,
                   scaling: Scaling,
                   params: SolverParams,
                   x, z, w, y, mu,
                   l1_weight=None,
                   l1_center=None,
                   passes: int = None):
    """Active-set iteration: each pass classifies from the previous
    pass's candidate (clipped into the box), so coordinates that dipped
    out of bounds get pinned; each lane keeps the best point seen by
    the max-residual metric."""
    passes = params.polish_passes if passes is None else passes
    rp0, rd0, *_ = _residuals(qp, scaling, x, z, w, y, mu, params)
    best = (x, z, w, y, mu)
    best_err = torch.maximum(rp0, rd0)
    guess = best
    for _ in range(passes):
        cand, cand_err, finite, gates_ok = _polish_pass(
            qp, scaling, params, *guess, l1_weight, l1_center)
        accept = finite & gates_ok & (cand_err < best_err)
        best = tuple(torch.where(_lane(accept, c), c, b)
                     for c, b in zip(cand, best))
        best_err = torch.where(accept, cand_err, best_err)
        # Thread the candidate as the next classification point even
        # when not (yet) better, but only when it passes the sanity
        # gates: an L1 candidate that failed them is misclassified.
        thread = finite & gates_ok
        guess = tuple(torch.where(_lane(thread, c), c, g)
                      for c, g in zip(cand, guess))
    return best


def _polish_pass(qp: CanonicalQP,
                 scaling: Scaling,
                 params: SolverParams,
                 x, z, w, y, mu,
                 l1_weight=None,
                 l1_center=None):
    """One polish candidate per lane from the given point's active-set
    classification: ``(candidate_5tuple, cand_err, finite, gates_ok)``,
    the last three (B,)."""
    dtype = qp.q.dtype
    eps = torch.finfo(dtype).eps
    # The row and box gaps of the point; the dual and proximity
    # thresholds are a few ulps (a wrong guess only costs a rejected
    # pass).
    row_gap = (_mv(qp.C, x) - z).abs()
    prox_err = torch.maximum(
        row_gap.amax(dim=-1) if qp.m else torch.zeros_like(x[..., 0]),
        (x - w).abs().amax(dim=-1))
    tiny = torch.tensor(1e3 * eps, dtype=dtype, device=x.device)
    dual_tol = prox_tol = tiny

    has_l1 = l1_weight is not None
    if has_l1:
        l1c = torch.zeros_like(x) if l1_center is None else l1_center
        at_kink, sub_sign, mu_box_est, window = classify_l1(
            x, mu, l1_weight, l1c, prox_err)
        kink_tol = math.sqrt(eps)
        live = l1_weight > 0
    else:
        at_kink = torch.zeros_like(x, dtype=torch.bool)
        sub_sign = torch.zeros_like(x)
        l1c = torch.zeros_like(x)
        mu_box_est = mu
    (act_low_C, act_up_C, eq_C, act_low_B, act_up_B, eq_B
     ) = classify_active(qp, z, w, y, mu_box_est, prox_tol, dual_tol)
    act_C = (act_low_C | act_up_C | eq_C) & (qp.row_mask > 0)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    bound_C = torch.where(act_up_C & ~act_low_C, qp.u, qp.l)
    bound_C = torch.where(torch.isfinite(bound_C), bound_C, zero)
    bound_B = torch.where(act_up_B & ~act_low_B, qp.ub, qp.lb)
    bound_B = torch.where(torch.isfinite(bound_B), bound_B, zero)

    use_woodbury = polish_capacitance_dim(qp) is not None
    # sqrt(machine eps) floors the regularizer: the (1/delta)-weighted
    # Schur complement must stay within what Cholesky + refinement can
    # represent in f32 (f64 keeps the caller's tighter delta).
    delta = torch.maximum(
        torch.tensor(params.polish_delta, dtype=dtype, device=x.device),
        torch.sqrt(torch.tensor(eps, dtype=dtype, device=x.device)))

    def kkt_solve(at_kink_i, sub_sign_i):
        aB_i = (act_low_B | act_up_B | eq_B | at_kink_i).to(dtype)
        aC_i = act_C.to(dtype)
        bound_B_i = torch.where(
            at_kink_i, torch.clamp(l1c, qp.lb, qp.ub), bound_B)
        q_eff_i = qp.q + l1_weight * sub_sign_i if has_l1 else qp.q
        solve = _kkt_solve_factored if use_woodbury else _kkt_solve_dense
        return solve(qp, params, aB_i, aC_i, bound_B_i, bound_C, q_eff_i,
                     delta)

    x_p, y_p, tau_p = kkt_solve(at_kink, sub_sign)

    if has_l1:
        # A smooth-classified variable whose solution crossed its kink
        # had a mis-guessed subgradient sign; the optimum rests on the
        # kink for it. Pin those and re-solve, per lane.
        crossed = live & ~at_kink & ((x_p - l1c) * sub_sign < -kink_tol)
        any_crossed = crossed.any(dim=-1)
        at_kink2 = at_kink | crossed
        sub_sign2 = torch.where(crossed, torch.zeros_like(sub_sign), sub_sign)
        x_p2, y_p2, tau_p2 = kkt_solve(at_kink2, sub_sign2)

        def pick2(b2, b1):
            return torch.where(_lane(any_crossed, b2), b2, b1)

        x_p, y_p, tau_p = pick2(x_p2, x_p), pick2(y_p2, y_p), pick2(tau_p2, tau_p)
        at_kink = pick2(at_kink2, at_kink)
        sub_sign = pick2(sub_sign2, sub_sign)

    # Fold the fixed L1 subgradient back into the box dual so the
    # stationarity vector is evaluated against the original q.
    mu_p = tau_p + l1_weight * sub_sign if has_l1 else tau_p
    z_p = torch.clamp(_mv(qp.C, x_p), qp.l, qp.u)
    w_p = torch.clamp(x_p, qp.lb, qp.ub)

    rp1, rd1, *_ = _residuals(qp, scaling, x_p, z_p, w_p, y_p, mu_p, params)
    cand_err = torch.maximum(rp1, rd1)
    finite = (torch.isfinite(x_p).all(dim=-1)
              & torch.isfinite(y_p).all(dim=-1))

    gates_ok = torch.ones_like(finite)
    if has_l1:
        # A mis-guessed kink/sign pattern must still be rejected: a
        # variable pinned at its kink inside the box needs its implied
        # multiplier within [-w, w], and a smooth-side variable must
        # sit on its assumed side after the re-solve.
        win = window.unsqueeze(-1)
        inside = (x_p > qp.lb + win) & (x_p < qp.ub - win)
        kink_dual_ok = ~(at_kink & inside) | (tau_p.abs() <= l1_weight + win)
        side_ok = ~(live & ~at_kink) | ((x_p - l1c) * sub_sign >= -kink_tol)
        gates_ok = kink_dual_ok.all(dim=-1) & side_ok.all(dim=-1)

    return (x_p, z_p, w_p, y_p, mu_p), cand_err, finite, gates_ok
