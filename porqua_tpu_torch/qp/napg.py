"""Nesterov-accelerated projected-gradient (NAPG) backend.

The third first-order solver behind ``SolverParams(method="napg")``,
the port of ``porqua_tpu/qp/napg.py``: accelerated projected gradient
for the box-dominated regime (the tracking family's polytope is a box
plus one budget row). One iteration:

    y_k   = x_k + beta_k (x_k - x_{k-1})          # Nesterov momentum
    v     = y_k - tau (P y_k + q)                 # gradient step
    x_+   = prox_Omega(v)                         # box (+L1) and rows
    y_+   = lam / tau                             # row duals from prox
    mu_+  = (v - x_+) / tau - C' y_+              # box(+L1) subgradient

with tau = 1/L_P from a power iteration at :func:`napg_init` and
beta_k = k/(k+3) on the iterations since the last restart. The prox is
exact for the box(+L1) block by dual coordinate ascent over the C rows:
per row the multiplier solves a monotone scalar equation by a bisection
of a fixed ``napg_bisect_iters`` steps, on the device for every lane at
once (no data-dependent host control). One sweep is exact for a single
row (the tracking budget); ``napg_project_cycles`` sweeps tighten a
multi-row intersection.

The iterate rides the shared ``ADMMState`` (``w = x``, ``z = clip(Cx,
l, u)``, ``y``/``mu`` the prox multipliers, ``rho_bar`` the step tau),
so residuals, finalize, lane selection and compaction work unchanged.
Momentum restarts on the O'Donoghue-Candes gradient test every
iteration; the rings' third slot holds the cumulative restart count.
No infeasibility certificates: a lane that cannot converge retires
MAX_ITER through the shared finalize.

Like PDHG this backend has no fused kernel in the JAX package (it never
reaches ``pl.pallas_call``): it runs plain PyTorch ops whatever
``params.backend`` says, in full float32 (TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from porqua_tpu_torch.qp.admm import (
    ADMMState,
    SolverParams,
    Status,
    _l1_terms,
    _mv,
    _residuals,
    _vm,
    init_rings,
    l1_box_prox,
    run_segments,
    write_rings,
)
from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.qp.pdhg import _power_norm
from porqua_tpu_torch.qp.ruiz import Scaling

__all__ = ["NAPGCarry", "napg_init", "napg_segment_step", "napg_solve"]


class NAPGCarry(NamedTuple):
    """The NAPG segment-loop carry: ``.state`` is an ``ADMMState``, the
    rest per-lane tensors with the leading lane axis."""

    state: ADMMState
    x_prev: torch.Tensor         # (B, n) previous iterate
    k_mom: torch.Tensor          # (B,) iterations since the last restart
    restart_count: torch.Tensor  # (B,) int32 cumulative restarts
    norm_P: torch.Tensor         # (B,) ||P||_2 upper estimate (tau = 1/L)


def _row_prox(v, lam, qp: CanonicalQP, tau_l1w, l1c, params: SolverParams):
    """Exact prox of ``I_[lb,ub] + l1 + I_{l <= Cx <= u}`` at ``v`` by
    dual coordinate ascent over the rows, warm-started at ``lam``
    (B, m). Per sweep each row's multiplier is re-solved by bisection of
    ``h(lam_i) = c_i' prox1(v - C'lam)`` (nonincreasing in lam_i)
    against its clipped target. Returns ``(x, lam)`` with
    ``x = prox1(v - C'lam)``."""
    dtype = v.dtype
    big = torch.finfo(dtype).max

    def prox1(t):
        return l1_box_prox(t, qp.lb, qp.ub, tau_l1w, l1c)

    def row_update(i, lam):
        c = qp.C[..., i, :]
        # The other rows' contribution held fixed (coordinate ascent).
        w = v - _vm(lam, qp.C) + lam[..., i:i + 1] * c
        s0 = torch.sum(c * prox1(w), dim=-1)
        target = torch.clamp(s0, qp.l[..., i], qp.u[..., i])
        active = s0 != target
        cc = torch.clamp_min(torch.sum(c * c, dim=-1), 1e-12)
        lam_lin = (s0 - target) / cc
        # Bracket from the per-coordinate kinks of lam -> prox1(w - lam c).
        up = qp.ub + tau_l1w
        lo_b = qp.lb - tau_l1w
        with_c = c != 0.0
        c_safe = torch.where(with_c, c, torch.ones_like(c))
        nan = torch.full_like(c, float("nan"))
        cand_a = torch.where(with_c, (w - up) / c_safe, nan)
        cand_b = torch.where(with_c, (w - lo_b) / c_safe, nan)
        k_lo = torch.minimum(cand_a, cand_b)
        k_hi = torch.maximum(cand_a, cand_b)
        lo = torch.amin(torch.where(torch.isfinite(k_lo), k_lo,
                                    torch.full_like(k_lo, big)), dim=-1)
        hi = torch.amax(torch.where(torch.isfinite(k_hi), k_hi,
                                    torch.full_like(k_hi, -big)), dim=-1)
        a = torch.clamp_max(torch.minimum(lo, lam_lin), 0.0) - 1.0
        b = torch.clamp_min(torch.maximum(hi, lam_lin), 0.0) + 1.0
        for _ in range(params.napg_bisect_iters):
            mid = 0.5 * (a + b)
            hmid = torch.sum(c * prox1(w - mid[..., None] * c), dim=-1)
            go_right = hmid > target
            a, b = (torch.where(go_right, mid, a),
                    torch.where(go_right, b, mid))
        lam_i = torch.where(active, 0.5 * (a + b), torch.zeros_like(a))
        lam = lam.clone()
        lam[..., i] = lam_i.to(dtype)
        return lam

    for _ in range(params.napg_project_cycles if qp.m else 0):
        for i in range(qp.m):
            lam = row_update(i, lam)
    x = prox1(v - _vm(lam, qp.C))
    return x, lam


def napg_init(qp: CanonicalQP,
              params: SolverParams,
              x0=None,
              y0=None) -> NAPGCarry:
    """Build the segment-loop carry for a batch of *scaled* problems.
    ``y0`` is accepted for signature parity, but the row duals are
    recovered from the projection every iteration, so only ``x0``
    seeds."""
    del y0
    dtype, device = qp.q.dtype, qp.q.device
    lead = qp.q.shape[:-1]
    x_init = torch.zeros_like(qp.q) if x0 is None else x0
    x_init = torch.clamp(x_init, qp.lb, qp.ub)
    z_init = _mv(qp.C, x_init)
    norm_P = torch.clamp_min(
        _power_norm(qp.apply_P, lead, qp.n, dtype, device,
                    params.napg_power_iters), 1e-6).to(dtype)

    lane = torch.zeros(lead, dtype=dtype, device=device)
    ring_prim, ring_dual, ring_rho = init_rings(lane, params.ring_size)
    state = ADMMState(
        x=x_init, z=z_init, w=x_init, y=torch.zeros_like(qp.l),
        mu=torch.zeros_like(qp.q),
        rho_bar=1.0 / norm_P,
        iters=torch.zeros(lead, dtype=torch.int32, device=device),
        status=torch.full(lead, Status.RUNNING, dtype=torch.int32,
                          device=device),
        prim_res=torch.full_like(lane, float("inf")),
        dual_res=torch.full_like(lane, float("inf")),
        ring_prim=ring_prim, ring_dual=ring_dual, ring_rho=ring_rho,
    )
    return NAPGCarry(
        state=state,
        x_prev=x_init,
        k_mom=torch.zeros_like(lane),
        restart_count=torch.zeros(lead, dtype=torch.int32, device=device),
        norm_P=norm_P,
    )


def _make_napg_segment(qp: CanonicalQP,
                       scaling: Scaling,
                       params: SolverParams,
                       l1w,
                       l1c):
    """Build the one-segment transition ``NAPGCarry -> NAPGCarry``:
    ``check_interval`` iterations, one residual check, the status /
    ring updates. Shared by :func:`napg_solve` and
    :func:`napg_segment_step`."""
    ci = params.check_interval

    def segment(carry: NAPGCarry) -> NAPGCarry:
        state = carry.state
        tau = (1.0 / carry.norm_P)[..., None]
        tau_l1w = tau * l1w

        def one_iteration(x, x_prev, k_mom, lam):
            beta = (k_mom / (k_mom + 3.0))[..., None]
            yk = x + beta * (x - x_prev)
            v = yk - tau * (qp.apply_P(yk) + qp.q)
            x_new, lam_new = _row_prox(v, lam, qp, tau_l1w, l1c, params)
            # Gradient restart: momentum opposes descent, discard it.
            restart = torch.sum((yk - x_new) * (x_new - x), dim=-1) > 0.0
            k_next = torch.where(restart, torch.zeros_like(k_mom),
                                 k_mom + 1.0)
            return x_new, x, k_next, restart, lam_new, v

        x, x_prev, k_mom = state.x, carry.x_prev, carry.k_mom
        rcount, lam = carry.restart_count, tau * state.y
        for _ in range(ci - 1):
            x, x_prev, k_mom, restart, lam, _ = one_iteration(
                x, x_prev, k_mom, lam)
            rcount = rcount + restart.to(torch.int32)
        # The last iteration keeps the by-products the check reads.
        x, x_prev, k_mom, restart, lam, v = one_iteration(
            x, x_prev, k_mom, lam)
        rcount = rcount + restart.to(torch.int32)
        y = lam / tau
        mu = (v - _vm(lam, qp.C) - x) / tau
        z = torch.clamp(_mv(qp.C, x), qp.l, qp.u)

        r_prim, r_dual, eps_p, eps_d, _, _ = _residuals(
            qp, scaling, x, z, x, y, mu, params)
        solved = (r_prim <= eps_p) & (r_dual <= eps_d)
        status = torch.where(solved, Status.SOLVED,
                             Status.RUNNING).to(torch.int32)

        ring_prim, ring_dual, ring_rho = write_rings(
            state, ci, r_prim, r_dual, rcount)
        new_state = ADMMState(
            x=x, z=z, w=x, y=y, mu=mu,
            rho_bar=tau[..., 0],
            iters=state.iters + ci,
            status=status,
            prim_res=r_prim,
            dual_res=r_dual,
            ring_prim=ring_prim,
            ring_dual=ring_dual,
            ring_rho=ring_rho,
        )
        return NAPGCarry(state=new_state, x_prev=x_prev, k_mom=k_mom,
                         restart_count=rcount, norm_P=carry.norm_P)

    return segment


def napg_segment_step(carry: NAPGCarry,
                      qp: CanonicalQP,
                      scaling: Scaling,
                      params: SolverParams,
                      l1_weight=None,
                      l1_center=None):
    """Advance every lane one residual-check segment; returns ``(carry,
    per_lane_status)``, the contract of ``admm_segment_step``."""
    l1w, l1c = _l1_terms(qp, l1_weight, l1_center)
    new = _make_napg_segment(qp, scaling, params, l1w, l1c)(carry)
    return new, new.state.status


def napg_solve(qp: CanonicalQP,
               scaling: Scaling,
               params: SolverParams,
               x0=None,
               y0=None,
               l1_weight=None,
               l1_center=None) -> ADMMState:
    """Run the accelerated projected-gradient loop on a batch of
    *scaled* problems; returns the final ``ADMMState`` (RUNNING retired
    to MAX_ITER)."""
    l1w, l1c = _l1_terms(qp, l1_weight, l1_center)
    segment = _make_napg_segment(qp, scaling, params, l1w, l1c)
    return run_segments(napg_init(qp, params, x0, y0), segment, params)
