"""Restarted primal-dual hybrid gradient (PDHG) backend.

The second first-order solver behind ``SolverParams(method="pdhg")``,
the port of ``porqua_tpu/qp/pdhg.py``: a restarted PDHG (the PDLP
restart recipe) for the interval-form QP the ADMM core solves,

    minimize 0.5 x'Px + q'x   s.t.  l <= Cx <= u,  lb <= x <= ub

One iteration (Condat-Vu form):

    v     = x_k - tau (P x_k + q + C' y_k)
    x_+   = prox_{tau(I_[lb,ub] + l1)}(v)        # l1_box_prox
    ytil  = y_k + sigma C (2 x_+ - x_k)
    z_+   = clip(ytil / sigma, l, u)
    y_+   = ytil - sigma z_+
    mu_+  = (v - x_+) / tau

with tau = 1/(L_P + omega ||C||) and sigma = omega / ||C||, the
spectral estimates from a power iteration at :func:`pdhg_init`.

The iterate rides the :class:`~porqua_tpu_torch.qp.admm.ADMMState` of
the ADMM backend (``w = x``, ``mu`` the prox residual,
``rho_bar`` the primal weight omega), so the shared residuals,
finalize, lane selection and compaction's repack work unchanged. At
every residual check the current iterate and one step from the
restart-window average are both graded; a restart (on sufficient decay
or after ``pdhg_restart_max_windows`` checks) adopts the better one,
resets the window and rebalances omega. Every such decision is a
per-lane ``torch.where`` on the device; the only host read is the
segment loop's one scalar per segment. The rings' third slot holds
the cumulative restart count where ADMM records rho.

This backend has no fused kernel in the JAX package either (it never
reaches ``pl.pallas_call``): it runs plain PyTorch ops whatever
``params.backend`` says. Its products (``P x``, ``C x``) are batched
``torch.matmul``/``einsum`` calls in full float32 (the precision
policy, ``qp/canonical.HP``, keeps TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from porqua_tpu_torch.qp.admm import (
    ADMMState,
    SolverParams,
    Status,
    _infeasibility,
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
from porqua_tpu_torch.qp.ruiz import Scaling

__all__ = ["PDHGCarry", "pdhg_init", "pdhg_segment_step", "pdhg_solve"]

#: Primal-weight clamp (keeps the step-size ratio inside what f32
#: arithmetic supports).
_OMEGA_LO = 1e-3
_OMEGA_HI = 1e3

#: Norm-estimate floor: a neutral or padded lane can carry an all-zero
#: C block, and sigma = omega/||C|| must stay finite on it.
_NORM_FLOOR = 1e-6


class PDHGCarry(NamedTuple):
    """The PDHG segment-loop carry: ``.state`` is an ``ADMMState``, the
    rest per-lane tensors with the leading lane axis."""

    state: ADMMState
    avg_x: torch.Tensor          # (B, n) restart-window sum of x
    avg_y: torch.Tensor          # (B, m) restart-window sum of y
    n_avg: torch.Tensor          # (B,) iterates summed since the restart
    k_restart: torch.Tensor      # (B,) int32 iterations since the restart
    res_restart: torch.Tensor    # (B,) normalized residual at the restart
    restart_count: torch.Tensor  # (B,) int32 cumulative restarts
    norm_P: torch.Tensor         # (B,) ||P||_2 upper estimate
    norm_C: torch.Tensor         # (B,) ||C||_2 upper estimate


def _norm2(v):
    """Per-lane Euclidean norm over the last axis (0 on an empty axis)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _power_norm(matvec, lead, n: int, dtype, device, iters: int):
    """Per-lane largest-eigenvalue estimate of a symmetric PSD operator
    by power iteration from a fixed start for a fixed count, inflated
    by 10%: power iteration converges from below, and the step
    condition needs an upper bound."""
    v = torch.full(tuple(lead) + (n,), 1.0, dtype=dtype, device=device) \
        / torch.sqrt(torch.tensor(float(n), dtype=dtype, device=device))
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.clamp_min(_norm2(w), _NORM_FLOOR)[..., None]
    return 1.1 * _norm2(matvec(v))


def pdhg_init(qp: CanonicalQP,
              params: SolverParams,
              x0=None,
              y0=None) -> PDHGCarry:
    """Build the segment-loop carry for a batch of *scaled* problems
    (warm starts in the scaled frame, rings iff ``params.ring_size``)."""
    dtype, device = qp.q.dtype, qp.q.device
    lead = qp.q.shape[:-1]
    x_init = torch.zeros_like(qp.q) if x0 is None else x0
    y_init = torch.zeros_like(qp.l) if y0 is None else y0
    x_init = torch.clamp(x_init, qp.lb, qp.ub)
    z_init = _mv(qp.C, x_init)

    norm_P = _power_norm(qp.apply_P, lead, qp.n, dtype, device,
                         params.pdhg_power_iters)
    norm_C = torch.sqrt(_power_norm(
        lambda v: _vm(_mv(qp.C, v), qp.C), lead, qp.n, dtype, device,
        params.pdhg_power_iters))
    norm_C = torch.clamp_min(norm_C, _NORM_FLOOR)

    lane = torch.zeros(lead, dtype=dtype, device=device)
    ring_prim, ring_dual, ring_rho = init_rings(lane, params.ring_size)
    state = ADMMState(
        x=x_init, z=z_init, w=x_init, y=y_init, mu=torch.zeros_like(qp.q),
        rho_bar=torch.full_like(lane, params.pdhg_omega0),
        iters=torch.zeros(lead, dtype=torch.int32, device=device),
        status=torch.full(lead, Status.RUNNING, dtype=torch.int32,
                          device=device),
        prim_res=torch.full_like(lane, float("inf")),
        dual_res=torch.full_like(lane, float("inf")),
        ring_prim=ring_prim, ring_dual=ring_dual, ring_rho=ring_rho,
    )
    return PDHGCarry(
        state=state,
        avg_x=torch.zeros_like(qp.q),
        avg_y=torch.zeros_like(qp.l),
        n_avg=torch.zeros_like(lane),
        k_restart=torch.zeros(lead, dtype=torch.int32, device=device),
        res_restart=torch.full_like(lane, float("inf")),
        restart_count=torch.zeros(lead, dtype=torch.int32, device=device),
        norm_P=norm_P.to(dtype),
        norm_C=norm_C.to(dtype),
    )


def _make_pdhg_segment(qp: CanonicalQP,
                       scaling: Scaling,
                       params: SolverParams,
                       l1w,
                       l1c,
                       track_l1: bool):
    """Build the one-segment transition ``PDHGCarry -> PDHGCarry``:
    ``check_interval`` iterations, one residual check, the status /
    restart / omega / ring updates. Shared by :func:`pdhg_solve` and
    :func:`pdhg_segment_step`."""
    ci = params.check_interval

    def one_iteration(x, y, tau, sigma):
        grad = qp.apply_P(x) + qp.q + _vm(y, qp.C)
        v = x - tau * grad
        x_new = l1_box_prox(v, qp.lb, qp.ub, tau * l1w, l1c)
        ytil = y + sigma * _mv(qp.C, 2.0 * x_new - x)
        z_new = torch.clamp(ytil / sigma, qp.l, qp.u)
        y_new = ytil - sigma * z_new
        mu_new = (v - x_new) / tau
        return x_new, y_new, z_new, mu_new

    def normalized(r_prim, r_dual, denom_p, denom_d):
        return torch.maximum(r_prim / torch.clamp_min(denom_p, 1e-12),
                             r_dual / torch.clamp_min(denom_d, 1e-12))

    def segment(carry: PDHGCarry) -> PDHGCarry:
        state = carry.state
        omega = state.rho_bar
        tau = (1.0 / (carry.norm_P + omega * carry.norm_C))[..., None]
        sigma = (omega / carry.norm_C)[..., None]

        x, y = state.x, state.y
        sx, sy = torch.zeros_like(x), torch.zeros_like(y)
        for _ in range(ci - 1):
            x, y, _, _ = one_iteration(x, y, tau, sigma)
            sx, sy = sx + x, sy + y
        x_prev, y_prev = x, y
        x, y, z, mu = one_iteration(x_prev, y_prev, tau, sigma)
        sx, sy = sx + x, sy + y
        dx, dy, dmu = x - x_prev, y - y_prev, mu - state.mu

        # The current iterate (w = x: box-feasible by the prox).
        r_prim, r_dual, eps_p, eps_d, denom_p, denom_d = _residuals(
            qp, scaling, x, z, x, y, mu, params)
        res_cur = normalized(r_prim, r_dual, denom_p, denom_d)

        # The averaged candidate: one iteration from the window average.
        n_avg = carry.n_avg + float(ci)
        x_bar = (carry.avg_x + sx) / n_avg[..., None]
        y_bar = (carry.avg_y + sy) / n_avg[..., None]
        xa, ya, za, mua = one_iteration(x_bar, y_bar, tau, sigma)
        ra_prim, ra_dual, ea_p, ea_d, da_p, da_d = _residuals(
            qp, scaling, xa, za, xa, ya, mua, params)
        res_avg = normalized(ra_prim, ra_dual, da_p, da_d)

        # Restart on normalized-residual decay, or forced.
        k_new = carry.k_restart + ci
        res_best = torch.minimum(res_cur, res_avg)
        restart = ((res_best <= params.pdhg_restart_decrease
                    * carry.res_restart)
                   | (k_new >= params.pdhg_restart_max_windows * ci))
        use_avg = restart & (res_avg < res_cur)

        def pick(a, b):
            m = use_avg.reshape(use_avg.shape + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)

        x_f, z_f, y_f, mu_f = (pick(xa, x), pick(za, z), pick(ya, y),
                               pick(mua, mu))
        prim_f, dual_f = pick(ra_prim, r_prim), pick(ra_dual, r_dual)
        eps_pf, eps_df = pick(ea_p, eps_p), pick(ea_d, eps_d)
        denom_pf, denom_df = pick(da_p, denom_p), pick(da_d, denom_d)
        res_f = pick(res_avg, res_cur)

        solved = (prim_f <= eps_pf) & (dual_f <= eps_df)
        p_inf, d_inf, _ = _infeasibility(
            qp, scaling, dx, dy, dmu, params,
            l1w=l1w if track_l1 else None)
        status = torch.where(
            solved, Status.SOLVED,
            torch.where(p_inf, Status.PRIMAL_INFEASIBLE,
                        torch.where(d_inf, Status.DUAL_INFEASIBLE,
                                    Status.RUNNING)),
        ).to(torch.int32)

        # Primal-weight rebalance at restarts only (the PDLP cadence).
        if params.adaptive_rho:
            ratio = torch.sqrt(
                (prim_f / torch.clamp_min(denom_pf, 1e-12))
                / torch.clamp_min(dual_f / torch.clamp_min(denom_df, 1e-12),
                                  1e-12))
            omega_new = torch.where(
                restart, torch.clamp(omega * ratio, _OMEGA_LO, _OMEGA_HI),
                omega)
        else:
            omega_new = omega

        restart_count = carry.restart_count + restart.to(torch.int32)
        ring_prim, ring_dual, ring_rho = write_rings(
            state, ci, prim_f, dual_f, restart_count)
        new_state = ADMMState(
            x=x_f, z=z_f, w=x_f, y=y_f, mu=mu_f,
            rho_bar=omega_new,
            iters=state.iters + ci,
            status=status,
            prim_res=prim_f,
            dual_res=dual_f,
            ring_prim=ring_prim,
            ring_dual=ring_dual,
            ring_rho=ring_rho,
        )
        r = restart[..., None]
        return PDHGCarry(
            state=new_state,
            avg_x=torch.where(r, torch.zeros_like(x_f), carry.avg_x + sx),
            avg_y=torch.where(r, torch.zeros_like(y_f), carry.avg_y + sy),
            n_avg=torch.where(restart, torch.zeros_like(n_avg), n_avg),
            k_restart=torch.where(restart, 0, k_new).to(torch.int32),
            res_restart=torch.where(restart, res_f, carry.res_restart),
            restart_count=restart_count,
            norm_P=carry.norm_P,
            norm_C=carry.norm_C,
        )

    return segment


def pdhg_segment_step(carry: PDHGCarry,
                      qp: CanonicalQP,
                      scaling: Scaling,
                      params: SolverParams,
                      l1_weight=None,
                      l1_center=None):
    """Advance every lane one residual-check segment; returns ``(carry,
    per_lane_status)``, the contract of ``admm_segment_step`` (the step
    never flips RUNNING to MAX_ITER)."""
    l1w, l1c = _l1_terms(qp, l1_weight, l1_center)
    segment = _make_pdhg_segment(qp, scaling, params, l1w, l1c,
                                 track_l1=l1_weight is not None)
    new = segment(carry)
    return new, new.state.status


def pdhg_solve(qp: CanonicalQP,
               scaling: Scaling,
               params: SolverParams,
               x0=None,
               y0=None,
               l1_weight=None,
               l1_center=None) -> ADMMState:
    """Run the restarted-PDHG loop on a batch of *scaled* problems;
    returns the final ``ADMMState`` (RUNNING retired to MAX_ITER), the
    host segment loop of ``admm_solve`` over this backend's segment."""
    l1w, l1c = _l1_terms(qp, l1_weight, l1_center)
    segment = _make_pdhg_segment(qp, scaling, params, l1w, l1c,
                                 track_l1=l1_weight is not None)
    return run_segments(pdhg_init(qp, params, x0, y0), segment, params)
