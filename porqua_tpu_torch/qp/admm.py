"""Batched OSQP-style ADMM core in PyTorch.

    minimize 0.5 x'Px + q'x   s.t.  l <= Cx <= u,  lb <= x <= ub

ADMM splitting with slack z for the C-block and w for the box block,
duals y and mu, per-row step sizes rho and sigma:

    (P + sigma I + C' diag(rho) C + diag(rho_b)) xt = sigma x - q
          + C'(rho z - y) + (rho_b w - mu)
    x+  = alpha xt + (1-alpha) x
    z+  = clip(alpha C xt + (1-alpha) z + y/rho, l, u);   y += rho (.. - z+)
    w+  = clip(alpha xt + (1-alpha) w + mu/rho_b, lb, ub); mu += rho_b (.. - w+)

Every function works on a batch: each tensor carries a leading lane
axis B (where the JAX package vmapped one problem). The solve is a host
loop over *segments* of ``check_interval`` iterations; the linear-solve
operator is built once per segment, and each segment ends with one
residual check. A lane whose status left RUNNING (or whose iteration
budget ran out) is frozen by a per-lane select, exactly as the batched
``lax.while_loop`` of the reference freezes it.

With ``backend="pallas"`` a segment's iterations run as one fused
kernel launch (:mod:`porqua_tpu_torch.ops.admm_kernel`): the CUDA kernel
for CUDA tensors, its plain PyTorch twin for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional

import torch

from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.qp.ruiz import Scaling


class Status:
    """Per-problem termination codes carried as int32 tensors."""

    RUNNING = 0
    SOLVED = 1
    MAX_ITER = 2
    PRIMAL_INFEASIBLE = 3
    DUAL_INFEASIBLE = 4

    NAMES = {
        RUNNING: "running",
        SOLVED: "solved",
        MAX_ITER: "max_iter",
        PRIMAL_INFEASIBLE: "primal_infeasible",
        DUAL_INFEASIBLE: "dual_infeasible",
    }


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Static solver configuration, field for field the JAX package's
    ``SolverParams`` with the same defaults, so a config moves between
    the two packages as ``SolverParams(**dataclasses.asdict(p))``.
    Fields of backends and features that are not ported yet keep their
    place; selecting those features raises."""

    max_iter: int = 4000
    check_interval: int = 25
    method: str = "admm"
    # "auto" | "xla": the plain per-iteration torch segment.
    # "pallas": the hand-written fused segment kernel.
    backend: str = "auto"
    # "chol" | "trinv" | "inverse" | "woodbury" | "auto" (see
    # resolve_linsolve).
    linsolve: str = "auto"
    woodbury_refine: int = 1
    # TPU VMEM budget in the reference. The fused CUDA segment checks
    # its own shared-memory fit instead (ops/admm_kernel.py); kept so
    # configs carry over unchanged.
    vmem_limit_mb: float = 12.0
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    eps_pinf: float = 1e-5
    eps_dinf: float = 1e-5
    rho0: float = 0.1
    rho_eq_scale: float = 1.0
    rho_min: float = 1e-6
    rho_max: float = 1e6
    sigma: float = 1e-6
    alpha: float = 1.6
    adaptive_rho: bool = True
    # Restarted Halpern anchoring on the plain path (see _make_segment).
    halpern: bool = False
    halpern_decrease: float = 0.25
    halpern_max_windows: int = 8
    rho_l1_scale: float = 1.0
    pdhg_restart_decrease: float = 0.25
    pdhg_restart_max_windows: int = 8
    pdhg_omega0: float = 1.0
    pdhg_power_iters: int = 20
    napg_power_iters: int = 20
    napg_project_cycles: int = 1
    napg_bisect_iters: int = 32
    sketch_dim: int = 0
    sketch_seed: int = 0
    scaling_iters: int = 10
    # "ruiz" (sweeps over the dense P) or "factored" (Jacobi scaling
    # from the objective factor; requires qp.Pf).
    scaling_mode: str = "ruiz"
    ring_size: int = 0
    polish: bool = True
    polish_delta: float = 1e-7
    polish_refine_steps: int = 3
    polish_passes: int = 3


class ADMMState(NamedTuple):
    x: torch.Tensor         # (B, n) scaled primal
    z: torch.Tensor         # (B, m) scaled C-block slack
    w: torch.Tensor         # (B, n) scaled box-block slack
    y: torch.Tensor         # (B, m) scaled C-block dual
    mu: torch.Tensor        # (B, n) scaled box dual
    rho_bar: torch.Tensor   # (B,) adaptive step-size scalar
    iters: torch.Tensor     # (B,) int32 total iterations run
    status: torch.Tensor    # (B,) int32 Status code
    prim_res: torch.Tensor  # (B,)
    dual_res: torch.Tensor  # (B,)
    # Convergence rings (params.ring_size = K > 0 only, else None):
    # (B, K) circular buffers written at every residual check on the
    # device; slot j % K holds segment j. Decode with
    # porqua_tpu_torch.obs.rings.ring_history.
    ring_prim: Optional[torch.Tensor] = None
    ring_dual: Optional[torch.Tensor] = None
    ring_rho: Optional[torch.Tensor] = None


class ADMMCarry(NamedTuple):
    """The segment-loop carry: solver state plus the Halpern anchor
    (five vectors, carried unconditionally), the per-lane iteration
    count since the last restart and the residual at that restart."""

    state: ADMMState
    anchor: tuple
    k_anchor: torch.Tensor   # (B,) int32
    res_anchor: torch.Tensor  # (B,)


def _mv(M, v):
    """Batched ``M @ v``: (B, r, c) x (B, c) -> (B, r)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _vm(v, M):
    """Batched ``v @ M``: (B, r) x (B, r, c) -> (B, c)."""
    return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)


def _inf_norm(v):
    """Per-lane infinity norm over the last axis (0 on an empty axis)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.amax(v.abs(), dim=-1)


def l1_box_prox(v, lb, ub, l1w_over_rho, l1c):
    """Exact prox of ``I_[lb,ub] + l1w |. - l1c|`` (elementwise): the
    clipped shifted soft-threshold."""
    s = v - l1c
    soft = torch.sign(s) * torch.clamp_min(s.abs() - l1w_over_rho, 0.0)
    return torch.clamp(l1c + soft, lb, ub)


def _make_iteration(solve_fn, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c,
                    sigma, alpha):
    """One OSQP iteration (rhs build -> ``solve_fn`` -> prox/dual
    updates). The plain segment and both fused-kernel twins build on
    it, so the linear-solve operator is the only thing that differs
    between them."""
    dtype, device = q.dtype, q.device
    inv_rho = 1.0 / rho
    inv_rhob = 1.0 / rho_b
    sig = torch.tensor(sigma, dtype=dtype, device=device)
    al = torch.tensor(alpha, dtype=dtype, device=device)
    one_m_al = torch.tensor(1.0 - alpha, dtype=dtype, device=device)

    def one_iteration(carry):
        x, z, w, y, mu = carry
        rhs = sig * x - q + _vm(rho * z - y, C) + (rho_b * w - mu)
        xt = solve_fn(rhs)
        zt = _mv(C, xt)

        x_new = al * xt + one_m_al * x
        z_pre = al * zt + one_m_al * z
        z_new = torch.clamp(z_pre + y * inv_rho, l, u)
        y_new = y + rho * (z_pre - z_new)
        w_pre = al * xt + one_m_al * w
        w_new = l1_box_prox(w_pre + mu * inv_rhob, lb, ub, l1w * inv_rhob, l1c)
        mu_new = mu + rho_b * (w_pre - w_new)
        return (x_new, z_new, w_new, y_new, mu_new)

    return one_iteration


def _support(bound_u, bound_l, dual):
    """Support function of [l, u] at the dual direction, inf-safe."""
    zero = torch.zeros_like(dual)
    pos = torch.clamp_min(dual, 0.0)
    neg = torch.clamp_max(dual, 0.0)
    up = torch.where(pos > 0, bound_u * pos, zero)
    lo = torch.where(neg < 0, bound_l * neg, zero)
    return torch.sum(up + lo, dim=-1)


def _rho_vectors(qp: CanonicalQP, rho_bar, params: SolverParams):
    """Per-row step sizes: equality rows (l == u) get rho_eq_scale * rho."""
    rb = rho_bar[..., None]
    eq_rows = torch.isfinite(qp.l) & torch.isfinite(qp.u) & ((qp.u - qp.l) <= 1e-10)
    rho = torch.where(eq_rows, rb * params.rho_eq_scale, rb.expand_as(qp.l))
    eq_box = torch.isfinite(qp.lb) & torch.isfinite(qp.ub) & ((qp.ub - qp.lb) <= 1e-10)
    rho_b = torch.where(eq_box, rb * params.rho_eq_scale, rb.expand_as(qp.lb))
    return rho, rho_b


def _residuals(qp: CanonicalQP, scaling: Scaling, x, z, w, y, mu, params: SolverParams):
    """Unscaled residual norms and OSQP-style tolerance thresholds, per lane."""
    Cx = _mv(qp.C, x)
    Einv = 1.0 / scaling.E
    Dinv = 1.0 / scaling.D
    cinv = 1.0 / scaling.c

    r_prim = torch.maximum(
        _inf_norm(Einv * (Cx - z)), _inf_norm(scaling.D * (x - w))
    )
    Px = qp.apply_P(x)
    CTy = _vm(y, qp.C)
    dual_vec = Px + qp.q + CTy + mu
    r_dual = cinv * _inf_norm(Dinv * dual_vec)

    denom_p = torch.stack([
        _inf_norm(Einv * Cx), _inf_norm(Einv * z),
        _inf_norm(scaling.D * x), _inf_norm(scaling.D * w),
    ]).amax(dim=0)
    denom_d = cinv * torch.stack([
        _inf_norm(Dinv * Px), _inf_norm(Dinv * CTy),
        _inf_norm(Dinv * qp.q), _inf_norm(Dinv * mu),
    ]).amax(dim=0)

    eps_prim = params.eps_abs + params.eps_rel * denom_p
    eps_dual = params.eps_abs + params.eps_rel * denom_d
    return r_prim, r_dual, eps_prim, eps_dual, denom_p, denom_d


def _infeasibility(qp: CanonicalQP, scaling: Scaling, dx, dy, dmu,
                   params: SolverParams, l1w=None):
    """OSQP certificates from one-iteration increments (unscaled), per
    lane. ``l1w`` (scaled frame) adds the native L1 term's slope to the
    dual-infeasibility test."""
    cinv = (1.0 / scaling.c)[..., None]
    dy_u = cinv * scaling.E * dy
    dmu_u = cinv * (1.0 / scaling.D) * dmu
    dx_u = scaling.D * dx

    norm_dy = torch.maximum(_inf_norm(dy_u), _inf_norm(dmu_u))
    l_un = qp.l / scaling.E
    u_un = qp.u / scaling.E
    lb_un = qp.lb * scaling.D
    ub_un = qp.ub * scaling.D
    CTdy = (1.0 / scaling.D) * _vm(dy, qp.C) * cinv
    pinf_resid = _inf_norm(CTdy + dmu_u)
    support = (
        _support(u_un, l_un, dy_u) + _support(ub_un, lb_un, dmu_u)
    )
    prim_infeas = (
        (norm_dy > params.eps_pinf)
        & (pinf_resid <= params.eps_pinf * norm_dy)
        & (support <= -params.eps_pinf * norm_dy)
    )

    norm_dx = _inf_norm(dx_u)
    Pdx = cinv * (1.0 / scaling.D) * qp.apply_P(dx)
    qdx = cinv[..., 0] * torch.sum(qp.q * dx, dim=-1)
    if l1w is not None:
        qdx = qdx + cinv[..., 0] * torch.sum(l1w * dx.abs(), dim=-1)
    Cdx = (1.0 / scaling.E) * _mv(qp.C, dx)
    tol = (params.eps_dinf * norm_dx)[..., None]
    true = torch.ones_like(Cdx, dtype=torch.bool)
    true_n = torch.ones_like(dx_u, dtype=torch.bool)
    cone_ok = torch.all(
        torch.where(torch.isfinite(u_un), Cdx <= tol, true)
        & torch.where(torch.isfinite(l_un), Cdx >= -tol, true), dim=-1
    ) & torch.all(
        torch.where(torch.isfinite(ub_un), dx_u <= tol, true_n)
        & torch.where(torch.isfinite(lb_un), dx_u >= -tol, true_n), dim=-1
    )
    dual_infeas = (
        (norm_dx > params.eps_dinf)
        & (_inf_norm(Pdx) <= tol[..., 0])
        & (qdx <= -tol[..., 0])
        & cone_ok
    )
    return prim_infeas, dual_infeas, torch.zeros((), dtype=dx.dtype)


def resolve_linsolve(params: SolverParams, qp: CanonicalQP) -> str:
    """Resolve ``params.linsolve`` against this problem's structure:
    "woodbury" needs ``qp.Pf``; "auto" is "trinv" for float32 (the f32
    per-iteration Cholesky substitution stalls at production scale) and
    "chol" for float64."""
    ls = params.linsolve
    if ls == "woodbury":
        if qp.Pf is None:
            raise ValueError(
                "linsolve='woodbury' requires the factored objective "
                "(qp.Pf with P = 2 Pf'Pf + diag(Pdiag))")
        return "woodbury"
    if ls == "auto":
        return "trinv" if qp.P.dtype == torch.float32 else "chol"
    return ls


def factored_solve_pieces(Dv, V):
    """(inv_d, W) such that ``K^-1 r = inv_d r - W'(W r)`` for
    ``K = diag(Dv) + V'V`` (Woodbury with the capacitance matrix
    ``S = I + V D^-1 V'``, factored at k x k)."""
    k = V.shape[-2]
    inv_d = 1.0 / Dv
    Vd = V * inv_d[..., None, :]
    S = torch.eye(k, dtype=V.dtype, device=V.device) + torch.matmul(
        Vd, V.transpose(-1, -2))
    Linv = blocked_triangular_inverse(cholesky_lanes(S))
    W = torch.matmul(Linv, Vd)
    return inv_d, W


def factored_spd_solve_operator(Dv, V, refine_steps: int = 1):
    """Solve operator for the SPD matrix ``K = diag(Dv) + V' V`` by
    Woodbury with the capacitance matrix ``S = I + (V D^-1) V'``
    (k x k, k = V's rows): ``K^-1 r = D^-1 r - W'(W r)`` with
    ``W = L_S^-1 (V D^-1)``, plus ``refine_steps`` rounds of iterative
    refinement against the factor form (each multiplies the raw apply's
    cond(K) * eps error by the same factor). Batched over leading axes."""
    inv_d, W = factored_solve_pieces(Dv, V)
    return factored_solve_from_pieces(Dv, V, inv_d, W, refine_steps)


def factored_solve_from_pieces(Dv, V, inv_d, W, refine_steps: int = 1):
    """The Woodbury solve closure from already-built pieces, with
    ``refine_steps`` rounds of iterative refinement against
    ``K x = Dv x + V'(V x)``."""

    def base(rhs):
        return rhs * inv_d - _vm(_mv(W, rhs), W)

    def apply_K(x):
        return Dv * x + _vm(_mv(V, x), V)

    def solve(rhs):
        x = base(rhs)
        for _ in range(refine_steps):
            x = x + base(rhs - apply_K(x))
        return x

    return solve


def _nan_where_failed(info, t):
    """``t`` with the lanes whose factorization failed (``info != 0``)
    set to NaN: a failed lane carries NaN, as XLA's factorizations hand
    back, instead of raising for the whole batch."""
    mask = (info != 0).reshape(info.shape + (1,) * (t.dim() - info.dim()))
    return torch.where(mask, math.nan, t)


def cholesky_lanes(M):
    """Batched Cholesky factor; a lane whose matrix is not positive
    definite (a request with NaN data, say) comes back NaN while the
    other lanes of the batch solve."""
    L, info = torch.linalg.cholesky_ex(M)
    return _nan_where_failed(info, L)


def inverse_lanes(G):
    """Batched explicit inverse, NaN on a singular lane."""
    inv, info = torch.linalg.inv_ex(G)
    return _nan_where_failed(info, inv)


def solve_lanes(G, b):
    """Batched ``G^-1 b`` (``b`` with a trailing column axis), NaN on a
    singular lane."""
    out, info = torch.linalg.solve_ex(G, b)
    return _nan_where_failed(info, out)


def blocked_triangular_inverse(L, threshold: int = 192):
    """Explicit inverse of a batch of lower-triangular ``L`` by block
    recursion:

        [[L11, 0], [L21, L22]]^-1
            = [[L11^-1, 0], [-L22^-1 L21 L11^-1, L22^-1]]

    The two diagonal-block inverses are stacked into one batched
    recursion (the second block zero-padded with a unit diagonal, which
    inverts exactly); below ``threshold`` a triangular solve against
    the identity ends the recursion."""
    n = L.shape[-1]
    dtype, device = L.dtype, L.device
    if n <= threshold:
        eye = torch.eye(n, dtype=dtype, device=device).expand(L.shape)
        return torch.linalg.solve_triangular(L, eye, upper=False)

    n1 = (n + 1) // 2     # >= n - n1, so both blocks fit in (n1, n1)
    n2 = n - n1
    L11 = L[..., :n1, :n1]
    L21 = L[..., n1:, :n1]
    L22 = L[..., n1:, n1:]

    pad = n1 - n2
    L22p = torch.zeros(L.shape[:-2] + (n1, n1), dtype=dtype, device=device)
    L22p[..., :n2, :n2] = L22
    if pad:
        L22p[..., n2:, n2:] = torch.eye(pad, dtype=dtype, device=device)

    invs = blocked_triangular_inverse(torch.stack([L11, L22p], dim=-3),
                                      threshold)
    inv11 = invs[..., 0, :, :]
    inv22 = invs[..., 1, :n2, :n2]
    inv21 = -torch.matmul(torch.matmul(inv22, L21), inv11)

    out = torch.zeros_like(L)
    out[..., :n1, :n1] = inv11
    out[..., n1:, :n1] = inv21
    out[..., n1:, n1:] = inv22
    return out


def init_rings(lane, ring_size: int):
    """Empty rings for lanes shaped like ``lane`` (B,): residuals at
    inf, the third ring at 0; ``(None, None, None)`` without rings."""
    if not ring_size:
        return None, None, None
    shape = lane.shape + (ring_size,)
    inf = torch.full(shape, math.inf, dtype=lane.dtype, device=lane.device)
    return inf, inf.clone(), torch.zeros_like(inf)


def write_rings(state, check_interval: int, prim, dual, third):
    """The rings of ``state`` with this check's samples written at slot
    ``(iters // check_interval) % K`` of every lane: a per-lane select
    on the device, no host read."""
    if state.ring_prim is None:
        return None, None, None
    K = state.ring_prim.shape[-1]
    slot = torch.remainder(
        torch.div(state.iters, check_interval, rounding_mode="floor"), K)
    hit = torch.arange(K, device=slot.device) == slot[..., None]
    return tuple(
        torch.where(hit, v[..., None].to(r.dtype), r)
        for r, v in ((state.ring_prim, prim), (state.ring_dual, dual),
                     (state.ring_rho, third)))


def admm_init(qp: CanonicalQP,
              params: SolverParams,
              x0=None,
              y0=None) -> ADMMCarry:
    """Build the segment-loop carry for a batch of *scaled* problems;
    ``x0``/``y0`` warm starts are in the scaled frame; rings are set up
    iff ``params.ring_size``."""
    x_init = torch.zeros_like(qp.q) if x0 is None else x0
    y_init = torch.zeros_like(qp.l) if y0 is None else y0
    lane = torch.zeros_like(qp.q[..., 0])
    init = ADMMState(
        x=x_init, z=_mv(qp.C, x_init),
        w=torch.clamp(x_init, qp.lb, qp.ub), y=y_init,
        mu=torch.zeros_like(qp.q),
        rho_bar=torch.full_like(lane, params.rho0),
        iters=torch.zeros(lane.shape, dtype=torch.int32, device=lane.device),
        status=torch.full(lane.shape, Status.RUNNING, dtype=torch.int32,
                          device=lane.device),
        prim_res=torch.full_like(lane, math.inf),
        dual_res=torch.full_like(lane, math.inf),
    )
    init = init._replace(**dict(zip(
        ("ring_prim", "ring_dual", "ring_rho"),
        init_rings(lane, params.ring_size))))
    return ADMMCarry(
        state=init,
        anchor=(init.x, init.z, init.w, init.y, init.mu),
        k_anchor=torch.zeros_like(init.iters),
        res_anchor=torch.full_like(lane, math.inf),
    )


class _SegmentPlan(NamedTuple):
    """Static decisions for one segment program: the resolved linear
    solve, the fused-kernel opt-in and the f32 adaptive-rho clamp."""

    linsolve: str
    use_pallas: bool
    rho_lo: float
    rho_hi: float


def _segment_plan(qp: CanonicalQP, params: SolverParams,
                  warn: bool = False) -> _SegmentPlan:
    """Resolve the backend/linsolve/clamp decisions. The reference's
    VMEM estimate has no counterpart here: the fused CUDA segment's
    wrapper checks the shared-memory fit of its own layout and raises
    (ops/admm_kernel.py)."""
    if params.backend not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"unknown backend {params.backend!r}; expected 'auto', 'xla' "
            "or 'pallas'")
    if params.backend == "pallas" and params.halpern:
        # An intended divergence from the JAX package: there this config
        # warns and runs the XLA Halpern segment; here the kernel path
        # launches its kernel or raises, it never runs the plain segment.
        raise NotImplementedError(
            "backend='pallas' does not implement Halpern anchoring. The "
            "JAX package warns and runs its XLA Halpern segment for this "
            "config; the port's fused-kernel path never runs the plain "
            "segment. Pass backend='xla', halpern=True for the Halpern "
            "segment the JAX package runs, or halpern=False for the fused "
            "kernel")
    linsolve = resolve_linsolve(params, qp)
    use_pallas = params.backend == "pallas"
    use_inverse = use_pallas or linsolve in ("inverse", "trinv", "woodbury")

    # An explicit-inverse linear solve loses accuracy with conditioning;
    # in f32 the adaptive-rho clamp stays inside what the inverted
    # factor can represent.
    if use_inverse and qp.P.dtype == torch.float32:
        rho_lo = max(params.rho_min, 1e-3)
        rho_hi = min(params.rho_max, 1e2)
        defaults = SolverParams()
        caller_tuned = (params.rho_min != defaults.rho_min
                        or params.rho_max != defaults.rho_max)
        if warn and caller_tuned and (rho_lo != params.rho_min
                                      or rho_hi != params.rho_max):
            warnings.warn(
                f"f32 inverse-based linear solve narrows the adaptive-rho "
                f"clamp from [{params.rho_min:g}, {params.rho_max:g}] to "
                f"[{rho_lo:g}, {rho_hi:g}]; set linsolve='chol' and "
                f"backend='xla' to keep the requested bounds.",
                stacklevel=3,
            )
    else:
        rho_lo, rho_hi = params.rho_min, params.rho_max
    return _SegmentPlan(linsolve=linsolve, use_pallas=use_pallas,
                        rho_lo=rho_lo, rho_hi=rho_hi)


def _step_sizes(qp: CanonicalQP, rho_bar, l1w, params: SolverParams):
    rho, rho_b = _rho_vectors(qp, rho_bar, params)
    if params.rho_l1_scale != 1.0:
        # Extra step-size weight on the variables carrying a native L1 term.
        rho_b = torch.where(l1w > 0, rho_b * params.rho_l1_scale, rho_b)
    return rho, rho_b


def _kkt_matrix(qp: CanonicalQP, rho, rho_b, sigma):
    """K = P + sigma I + C' diag(rho) C + diag(rho_b)."""
    eye = torch.eye(qp.n, dtype=qp.P.dtype, device=qp.P.device)
    return (qp.P + sigma * eye
            + torch.matmul(qp.C.transpose(-1, -2) * rho[..., None, :], qp.C)
            + torch.diag_embed(rho_b))


def _refined_inverse(K):
    """Explicit K^-1 with one Newton step: Kinv <- Kinv (2I - K Kinv)."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    Kinv = torch.cholesky_solve(eye.expand(K.shape),
                                cholesky_lanes(K))
    return torch.matmul(Kinv, 2.0 * eye - torch.matmul(K, Kinv))


def _triangular_inverse(K):
    """L^-1 for K = L L^T: K^-1 = L^-T L^-1 as two dense matvecs."""
    return blocked_triangular_inverse(cholesky_lanes(K))


def _woodbury_operator(qp: CanonicalQP, rho, rho_b, sigma, refine: int):
    """The capacitance pieces of K = diag(sigma + Pdiag + rho_b)
    + 2 Pf'Pf + C' diag(rho) C: the factor block goes through the
    Woodbury solve, the m constraint rows through their own Schur
    complement G = diag(1/rho) + C K0^-1 C'. Returns
    ``(Dv, V, inv_d, W, psolve0, Y0, G)``."""
    pd = 0.0 if qp.Pdiag is None else qp.Pdiag
    Dv = sigma + pd + rho_b
    V = math.sqrt(2.0) * qp.Pf
    inv_d, W = factored_solve_pieces(Dv, V)
    psolve0 = factored_solve_from_pieces(Dv, V, inv_d, W, refine_steps=refine)
    Y0 = torch.stack([psolve0(qp.C[..., i, :]) for i in range(qp.m)],
                     dim=-1)                                  # (B, n, m)
    G = torch.diag_embed(1.0 / rho) + torch.matmul(qp.C, Y0)
    return Dv, V, inv_d, W, psolve0, Y0, G


def _l1_terms(qp: CanonicalQP, l1_weight, l1_center):
    l1w = torch.zeros_like(qp.q) if l1_weight is None else l1_weight
    l1c = torch.zeros_like(qp.q) if l1_center is None else l1_center
    return l1w, l1c


def segment_kernel_call(carry: ADMMCarry,
                        qp: CanonicalQP,
                        params: SolverParams,
                        l1_weight=None,
                        l1_center=None):
    """The fused-segment kernel call that the next segment of ``carry``
    makes on the kernel path: ``(wrapper, args, kwargs)``. The segment
    itself goes through here, so a caller that holds a kernel against
    its plain twin gets exactly the main path's operator and shapes.

    With linsolve="woodbury" the operator is the capacitance pieces
    with an explicit ``Ginv = inv(G)`` (the plain path solves with G
    per iteration instead); "trinv" hands over L^-1 applied twice;
    every other mode the Newton-refined explicit K^-1."""
    from porqua_tpu_torch.ops import admm_kernel

    state = carry.state
    l1w, l1c = _l1_terms(qp, l1_weight, l1_center)
    linsolve = resolve_linsolve(params, qp)
    sigma = torch.tensor(params.sigma, dtype=qp.q.dtype, device=qp.q.device)
    rho, rho_b = _step_sizes(qp, state.rho_bar, l1w, params)
    vecs = (qp.C, qp.q, qp.l, qp.u, qp.lb, qp.ub, rho, rho_b, l1w, l1c,
            state.x, state.z, state.w, state.y, state.mu)
    kw = dict(sigma=params.sigma, alpha=params.alpha,
              n_iters=params.check_interval)
    if linsolve == "woodbury":
        Dv, V, inv_d, W, _, Y0, G = _woodbury_operator(
            qp, rho, rho_b, sigma, params.woodbury_refine)
        fn, op = admm_kernel.admm_segment_factored, (
            W, inv_d, Y0, inverse_lanes(G), V, Dv)
        kw["refine_steps"] = params.woodbury_refine
    else:
        K = _kkt_matrix(qp, rho, rho_b, sigma)
        fn = admm_kernel.admm_segment
        kw["triangular"] = linsolve == "trinv"
        op = (_triangular_inverse(K) if kw["triangular"]
              else _refined_inverse(K),)
    # The kernels read row-major storage (the triangular solves hand
    # back column-major results).
    return fn, tuple(a.contiguous() for a in op + vecs), kw


def _make_segment(qp: CanonicalQP,
                  scaling: Scaling,
                  params: SolverParams,
                  l1w,
                  l1c,
                  plan: _SegmentPlan,
                  track_l1: bool):
    """Build the one-segment transition ``ADMMCarry -> ADMMCarry``:
    ``check_interval`` iterations with the linear-solve operator built
    once, one residual check, the status/adaptive-rho/Halpern updates.
    Shared by :func:`admm_solve` and :func:`admm_segment_step`."""
    dtype, device = qp.q.dtype, qp.q.device
    sigma = torch.tensor(params.sigma, dtype=dtype, device=device)
    linsolve, use_pallas = plan.linsolve, plan.use_pallas
    ci = params.check_interval

    def plain_solve(rho, rho_b):
        if linsolve == "woodbury":
            _, _, _, _, psolve0, Y0, G = _woodbury_operator(
                qp, rho, rho_b, sigma, params.woodbury_refine)

            def solve(rhs):
                x0 = psolve0(rhs)
                t = solve_lanes(G, _mv(qp.C, x0).unsqueeze(-1))
                return x0 - _mv(Y0, t.squeeze(-1))
            return solve
        K = _kkt_matrix(qp, rho, rho_b, sigma)
        if linsolve == "trinv":
            Linv = _triangular_inverse(K)
            return lambda rhs: _vm(_mv(Linv, rhs), Linv)
        if linsolve == "inverse":
            Kinv = _refined_inverse(K)
            # Applied as rhs @ Kinv (the transpose side), as the kernel
            # does: the one-sided Newton refinement leaves that side
            # the more accurate one in f32.
            return lambda rhs: _vm(rhs, Kinv)
        chol = cholesky_lanes(K)
        return lambda rhs: torch.cholesky_solve(
            rhs.unsqueeze(-1), chol).squeeze(-1)

    def segment(loop_carry: ADMMCarry) -> ADMMCarry:
        state, anchor, k_anchor, res_anchor = loop_carry
        if use_pallas:
            fn, args, kw = segment_kernel_call(
                loop_carry, qp, params, l1w, l1c)
            x, z, w, y, mu, dx, dy, dmu = fn(*args, **kw)
        else:
            rho, rho_b = _step_sizes(qp, state.rho_bar, l1w, params)
            one_iteration = _make_iteration(
                plain_solve(rho, rho_b), qp.C, qp.q, qp.l, qp.u, qp.lb,
                qp.ub, rho, rho_b, l1w, l1c, params.sigma, params.alpha)
            if params.halpern:
                # Restarted Halpern: pull toward the carried anchor with
                # weight 1/(k+2), k counting iterations since the last
                # restart (the restart decision lives at the boundary).
                def body(j, carry):
                    t = one_iteration(carry)
                    lam = (1.0 / ((k_anchor + j).to(dtype) + 2.0))[..., None]
                    return tuple(lam * a + (1.0 - lam) * tn
                                 for a, tn in zip(anchor, t))
            else:
                def body(_, carry):
                    return one_iteration(carry)

            # check_interval - 1 iterations, then one more recording deltas
            carry = (state.x, state.z, state.w, state.y, state.mu)
            for j in range(ci - 1):
                carry = body(j, carry)
            x, z, w, y, mu = body(ci - 1, carry)
            dx = x - carry[0]
            dy = y - carry[3]
            dmu = mu - carry[4]

        r_prim, r_dual, eps_p, eps_d, denom_p, denom_d = _residuals(
            qp, scaling, x, z, w, y, mu, params
        )
        solved = (r_prim <= eps_p) & (r_dual <= eps_d)
        p_inf, d_inf, _ = _infeasibility(
            qp, scaling, dx, dy, dmu, params,
            l1w=l1w if track_l1 else None,
        )
        status = torch.where(
            solved, Status.SOLVED,
            torch.where(p_inf, Status.PRIMAL_INFEASIBLE,
                        torch.where(d_inf, Status.DUAL_INFEASIBLE,
                                    Status.RUNNING)),
        ).to(torch.int32)

        # Adaptive rho: balance scaled primal/dual residual ratios
        if params.adaptive_rho:
            ratio = torch.sqrt(
                (r_prim / denom_p.clamp_min(1e-12))
                / (r_dual / denom_d.clamp_min(1e-12)).clamp_min(1e-12)
            )
            rho_new = torch.clamp(state.rho_bar * ratio, plan.rho_lo,
                                  plan.rho_hi)
        else:
            rho_new = state.rho_bar

        ring_prim, ring_dual, ring_rho = write_rings(
            state, ci, r_prim, r_dual, state.rho_bar)
        new_state = ADMMState(
            x=x, z=z, w=w, y=y, mu=mu,
            rho_bar=rho_new,
            iters=state.iters + ci,
            status=status,
            prim_res=r_prim,
            dual_res=r_dual,
            ring_prim=ring_prim,
            ring_dual=ring_dual,
            ring_rho=ring_rho,
        )
        if params.halpern:
            # Re-anchor on sufficient decrease of the scaled residual,
            # or after a long window without one.
            res_now = torch.maximum(r_prim / denom_p.clamp_min(1e-12),
                                    r_dual / denom_d.clamp_min(1e-12))
            k_new = k_anchor + ci
            restart = ((res_now <= params.halpern_decrease * res_anchor)
                       | (k_new >= params.halpern_max_windows * ci))
            anchor = tuple(torch.where(restart[..., None], c, a)
                           for c, a in zip((x, z, w, y, mu), anchor))
            k_anchor = torch.where(restart, 0, k_new).to(torch.int32)
            res_anchor = torch.where(restart, res_now, res_anchor)
        return ADMMCarry(state=new_state, anchor=anchor,
                         k_anchor=k_anchor, res_anchor=res_anchor)

    return segment


def admm_segment_step(carry: ADMMCarry,
                      qp: CanonicalQP,
                      scaling: Scaling,
                      params: SolverParams,
                      l1_weight=None,
                      l1_center=None):
    """Advance every lane one residual-check segment; returns ``(carry,
    per_lane_status)``. The step never flips RUNNING to MAX_ITER: the
    iteration budget is the caller's policy."""
    l1w, l1c = _l1_terms(qp, l1_weight, l1_center)
    plan = _segment_plan(qp, params, warn=False)
    segment = _make_segment(qp, scaling, params, l1w, l1c, plan,
                            track_l1=l1_weight is not None)
    new = segment(carry)
    return new, new.state.status


def run_segments(carry, segment, params: SolverParams) -> ADMMState:
    """The host segment loop every backend's solve runs: each boundary
    reads one scalar (is any lane still active?); a lane is active
    while its status is RUNNING and its iterations are under
    ``max_iter``. Every leaf of the carry is selected per lane
    (``select_lanes``), so a finished lane is frozen exactly where the
    reference's vmapped while_loop leaves it. Returns the final state
    with RUNNING retired to MAX_ITER."""
    # Local imports: qp/solve.py and the obs package import this module.
    from porqua_tpu_torch.analysis import sanitize
    from porqua_tpu_torch.obs import devprof
    from porqua_tpu_torch.qp.solve import select_lanes

    while True:
        state = carry.state
        active = (state.status == Status.RUNNING) & (state.iters < params.max_iter)
        # The one declared host read per segment.
        with sanitize.explicit_transfer():
            running = bool(active.any())
        if not running:
            break
        carry = select_lanes(active, segment(carry), carry)
        devprof.note_segment()
    final = carry.state
    return final._replace(
        status=torch.where(final.status == Status.RUNNING, Status.MAX_ITER,
                           final.status).to(torch.int32))


def admm_solve(qp: CanonicalQP,
               scaling: Scaling,
               params: SolverParams,
               x0=None,
               y0=None,
               l1_weight=None,
               l1_center=None) -> ADMMState:
    """Run the ADMM loop on a batch of *scaled* problems; returns the
    final state (:func:`run_segments` over this backend's segment)."""
    l1w, l1c = _l1_terms(qp, l1_weight, l1_center)
    plan = _segment_plan(qp, params, warn=True)
    segment = _make_segment(qp, scaling, params, l1w, l1c, plan,
                            track_l1=l1_weight is not None)
    return run_segments(admm_init(qp, params, x0, y0), segment, params)
