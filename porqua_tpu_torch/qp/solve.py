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
from porqua_tpu_torch.qp.napg import napg_init, napg_segment_step, napg_solve
from porqua_tpu_torch.qp.pdhg import pdhg_init, pdhg_segment_step, pdhg_solve
from porqua_tpu_torch.qp.polish import polish_iterate as _polish_iterate
from porqua_tpu_torch.qp.ruiz import Scaling, equilibrate, equilibrate_factored


def _backend(params: SolverParams):
    """Resolve ``params.method`` to the ``(init, segment_step, solve)``
    triple of the selected first-order backend. Every backend carries
    its iterate as an ``ADMMState`` and shares :func:`_prepare_impl` /
    :func:`_finalize_impl`, so this is the one dispatch point of every
    driver above it (fused solve, compaction, continuous serving). A
    typo'd method fails loudly instead of silently running another
    solver."""
    if params.method == "admm":
        return admm_init, admm_segment_step, admm_solve
    if params.method == "pdhg":
        return pdhg_init, pdhg_segment_step, pdhg_solve
    if params.method == "napg":
        return napg_init, napg_segment_step, napg_solve
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
    # Convergence rings (params.ring_size = K > 0 only, else None):
    # (B, K), slot j % K holds segment j's residual check of the
    # iterate (before the polish); decode with
    # porqua_tpu_torch.obs.rings.ring_history.
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
        ring_prim=state.ring_prim,
        ring_dual=state.ring_dual,
        ring_rho=state.ring_rho,
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
    semantics: ``ceil(max_iter / check_interval)``. One definition,
    shared by every segment-stepped loop (the continuous batcher)."""
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


def map_tensors(fn, tree):
    """``fn`` applied to every tensor of nested (named) tuples; ``None``
    leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    parts = [map_tensors(fn, a) for a in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


# ---------------------------------------------------------------------------
# Segment-stepped batch API (the continuous-batching core)
# ---------------------------------------------------------------------------
#
# The three phases of ``solve_qp_batch`` exposed separately, so batch
# orchestration (run a segment, retire and refill lanes, go on) lives
# above the solver instead of inside its host loop. Per-lane arithmetic
# is the code the fused path runs (``_prepare_impl``,
# ``admm_segment_step``, ``_finalize_impl``): with ``backend="pallas"``
# on the card each ``segment_step_batch`` is one fused kernel launch.

def prepare_batch(qp: CanonicalQP,
                  params: SolverParams,
                  x0=None,
                  y0=None,
                  l1_weight=None,
                  l1_center=None):
    """Equilibrate every lane and build its segment-loop carry.
    Returns ``(scaled, scaling, carry, l1w_s, l1c_s)``, all with the
    leading lane axis (the l1 entries ``None`` without an L1 term)."""
    HP.check()
    init, _, _ = _backend(params)
    scaled, scaling, x0_s, y0_s, l1w_s, l1c_s = _prepare_impl(
        qp, params, x0, y0, l1_weight, l1_center)
    return scaled, scaling, init(scaled, params, x0_s, y0_s), l1w_s, l1c_s


def segment_step_batch(scaled: CanonicalQP,
                       scaling: Scaling,
                       carry,
                       params: SolverParams,
                       l1w_s=None,
                       l1c_s=None):
    """Advance every lane one residual-check segment; returns the new
    carry (per-lane status in ``carry.state.status``). The step never
    retires a lane on its iteration count: that is the caller's
    policy."""
    from porqua_tpu_torch.obs import devprof  # local: obs imports this module

    HP.check()
    _, seg_step, _ = _backend(params)
    devprof.note_segment()
    return seg_step(carry, scaled, scaling, params, l1w_s, l1c_s)[0]


def finalize_batch(qp: CanonicalQP,
                   scaled: CanonicalQP,
                   scaling: Scaling,
                   state: ADMMState,
                   params: SolverParams,
                   l1_weight=None,
                   l1_center=None,
                   l1w_s=None,
                   l1c_s=None) -> QPSolution:
    """Polish + unscale + grade every lane. Still-RUNNING lanes
    (retired out of segment budget) are graded MAX_ITER and get the
    polish fallback, as the fused path's out-of-iterations exit."""
    return _finalize_impl(qp, scaled, scaling, state, params,
                          l1_weight, l1_center, l1w_s, l1c_s)


def batch_shape_struct(batch: int, n: int, m: int,
                       dtype=torch.float32,
                       factor_rows: Optional[int] = None) -> CanonicalQP:
    """The shape and dtype of a ``CanonicalQP`` batch without data
    (``meta`` tensors): the static shape an entry is compiled for.
    ``factor_rows`` adds the objective factor ``Pf (batch, r, n)`` and
    ``Pdiag (batch, n)``, so factored and dense problems are distinct
    entries."""
    s = lambda *shape: torch.empty((batch,) + shape, dtype=dtype,
                                   device="meta")
    return CanonicalQP(
        P=s(n, n), q=s(n), C=s(m, n), l=s(m), u=s(m), lb=s(n), ub=s(n),
        var_mask=s(n), row_mask=s(m), constant=s(),
        Pf=None if factor_rows is None else s(factor_rows, n),
        Pdiag=None if factor_rows is None else s(n),
    )


def neutral_batch(struct: CanonicalQP, device) -> CanonicalQP:
    """The problem an empty slot holds, at ``struct``'s shape on
    ``device``: identity objective, free rows, variables pinned to
    zero (with a factor: ``Pf = 0`` and a unit ``Pdiag``, which gives
    the identity exactly). Well conditioned, so the operator builds
    and kernel launches computed for such slots stay tame."""
    B, n = struct.q.shape
    m = struct.l.shape[-1]
    dtype = struct.q.dtype
    zeros = lambda *shape: torch.zeros((B,) + shape, dtype=dtype,
                                       device=device)
    full = lambda v: torch.full((B, m), v, dtype=dtype, device=device)
    eye = torch.eye(n, dtype=dtype, device=device)
    return CanonicalQP(
        P=eye.expand(B, n, n).clone(), q=zeros(n), C=zeros(m, n),
        l=full(-math.inf), u=full(math.inf), lb=zeros(n), ub=zeros(n),
        var_mask=zeros(n), row_mask=zeros(m), constant=zeros(),
        Pf=None if struct.Pf is None else zeros(struct.Pf.shape[-2], n),
        Pdiag=None if struct.Pdiag is None else zeros(n) + 1.0,
    )


def _check_struct(qp: CanonicalQP, struct: CanonicalQP) -> None:
    """An entry runs only the shape and dtype it was compiled for."""
    for name, got, want in zip(CanonicalQP._fields, qp, struct):
        if (got is None) != (want is None) or (got is not None and (
                got.shape != want.shape or got.dtype != want.dtype)):
            raise ValueError(
                f"field {name}: {None if got is None else tuple(got.shape)}"
                f" {None if got is None else got.dtype} does not match the "
                f"compiled {None if want is None else tuple(want.shape)} "
                f"{None if want is None else want.dtype}")


def kernel_form(struct: CanonicalQP, params: SolverParams, device):
    """The fused-segment kernel form (``"cluster"``, ``"tail"``,
    ``"stream"`` or ``"global"``) that ``struct``'s shape launches on
    ``device`` under ``params``, or ``None`` where no kernel runs (the
    plain path, or the CPU). Raises
    ValueError where no form fits the card."""
    if params.backend != "pallas" or torch.device(device).type != "cuda":
        return None
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.qp.admm import resolve_linsolve

    n, m = struct.q.shape[-1], struct.l.shape[-1]
    linsolve = resolve_linsolve(params, struct)
    with torch.cuda.device(device):
        if linsolve == "woodbury":
            return admm_kernel.factored_form(
                n, m, struct.Pf.shape[-2], params.woodbury_refine)
        return admm_kernel.dense_form(n, m, linsolve == "trinv")


def continuous_entries(params: SolverParams = SolverParams()):
    """The continuous-batching entry closures ``(admit, step,
    finalize)``; :func:`aot_compile_continuous` binds exactly these to
    a device and a shape."""

    def admit(qp, x0, y0, mask, scaled_old, scaling_old, carry_old):
        scaled, scaling, carry, _, _ = prepare_batch(qp, params, x0, y0)
        return (qp,
                select_lanes(mask, scaled, scaled_old),
                select_lanes(mask, scaling, scaling_old),
                select_lanes(mask, carry, carry_old))

    def step(scaled, scaling, carry, active):
        new = segment_step_batch(scaled, scaling, carry, params)
        new = select_lanes(active, new, carry)
        return new, new.state.status, new.state.iters

    def fin(qp, scaled, scaling, state):
        return finalize_batch(qp, scaled, scaling, state, params)

    return admit, step, fin


def aot_compile_continuous(qp_struct: CanonicalQP,
                           params: SolverParams = SolverParams(),
                           device=None):
    """Compile the continuous-batching triple for one static cohort
    shape; returns ``(admit, step, finalize, structs)``, the JAX
    package's argument lists:

    * ``admit(qp, x0, y0, mask, scaled_old, scaling_old, carry_old)
      -> (qp, scaled, scaling, carry)``: equilibrate + carry-init every
      slot, then per-lane select (admitted slots take the fresh state);
      ``qp`` comes back on the device for ``finalize``.
    * ``step(scaled, scaling, carry, active) -> (carry, status,
      iters)``: one residual-check segment, inactive lanes frozen.
    * ``finalize(qp, scaled, scaling, state) -> QPSolution``.

    Host inputs (``qp``, ``x0``, ``y0``, the masks) are moved to the
    device by the entries. "Compile" here binds the closures to
    ``(params, device, shape)``, resolves the kernel form the shape
    launches (:func:`kernel_form` raises where none fits) and runs the
    triple once on a neutral cohort, which loads the kernel library and
    creates the solver handles before any request arrives. Inside
    :func:`porqua_tpu_torch.obs.devprof.harvest_warmups` each entry's
    warm-up is counted (the CostRecords of the executable cache).
    ``structs`` is ``(scaled, scaling, carry)`` as ``meta`` tensors."""
    from porqua_tpu_torch.obs import devprof  # local: obs imports this module

    dev = resolve_device(device)
    HP.apply()
    kernel_form(qp_struct, params, dev)
    admit, step, fin = continuous_entries(params)
    B, n = qp_struct.q.shape
    m = qp_struct.l.shape[-1]
    on = lambda t: t.to(dev)

    def admit_entry(qp, x0, y0, mask, scaled_old, scaling_old, carry_old):
        _check_struct(qp, qp_struct)
        return admit(qp.to(dev), on(x0), on(y0), on(mask), scaled_old,
                     scaling_old, carry_old)

    def step_entry(scaled, scaling, carry, active):
        return step(scaled, scaling, carry, on(active))

    neutral = neutral_batch(qp_struct, dev)
    x0 = torch.zeros((B, n), dtype=qp_struct.q.dtype, device=dev)
    y0 = torch.zeros((B, m), dtype=qp_struct.q.dtype, device=dev)
    every = torch.ones(B, dtype=torch.bool, device=dev)
    state = prepare_batch(neutral, params, x0, y0)[:3]
    qp_dev, scaled, scaling, carry = devprof.warmup_call(
        "admit", admit_entry, neutral, x0, y0, every, *state, device=dev)
    carry = devprof.warmup_call("step", step_entry, scaled, scaling, carry,
                                every, device=dev)[0]
    devprof.warmup_call("finalize", fin, qp_dev, scaled, scaling,
                        carry.state, device=dev)
    structs = map_tensors(lambda t: t.to("meta"), state)
    return admit_entry, step_entry, fin, structs


def aot_compile_batch(qp_struct: CanonicalQP,
                      params: SolverParams = SolverParams(),
                      device=None):
    """Compile the batch solve for one static shape: the serving entry.

    The returned ``entry(qp, x0, y0)`` takes host or device tensors of
    ``qp_struct``'s shape plus warm starts ``x0 (batch, n)`` / ``y0
    (batch, m)`` and returns a batched :class:`QPSolution` on
    ``device`` (default: the card). Warm starts are always part of the
    signature: zeros run the identical arithmetic as a cold start. What
    "compile" means here: :func:`aot_compile_continuous`."""
    from porqua_tpu_torch.obs import devprof  # local: obs imports this module

    dev = resolve_device(device)
    HP.apply()
    kernel_form(qp_struct, params, dev)
    B, n = qp_struct.q.shape
    m = qp_struct.l.shape[-1]

    def entry(qp, x0, y0):
        _check_struct(qp, qp_struct)
        return _solve_impl(qp.to(dev), params, x0.to(dev), y0.to(dev))

    dtype = qp_struct.q.dtype
    devprof.warmup_call("solve", entry, neutral_batch(qp_struct, dev),
                        torch.zeros((B, n), dtype=dtype, device=dev),
                        torch.zeros((B, m), dtype=dtype, device=dev),
                        device=dev)
    return entry


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
