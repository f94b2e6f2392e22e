"""Seeded subspace embedding for the tracking-QP Gram build (the port
of ``porqua_tpu/qp/sketch.py``).

For a universe of N assets and a (T, N) return window X, the dense
``P = 2 X'X`` costs O(T N^2). A count-sketch ``S`` of the row (date)
space, each date hashed to one of ``sketch_dim`` buckets with a random
sign, compresses the window to ``Xs = S X`` of shape (sketch_dim, N),
after which the Gram build, the ``Pf`` factor rows of the Woodbury
solve and every first-order ``apply_P`` are cheaper by T/sketch_dim.
The sketch is applied to the stacked ``[X | y]`` window, so the
sketched problem is ``||S(Xw - y)||^2`` over the same polytope.

The error is measured, not assumed: :func:`gram_rel_err` probes
``||X'Xv - Xs'Xs v|| / ||X'Xv||`` with Gaussian probe vectors, and the
bound rides the result (``SketchInfo.gram_rel_err``). Disabled
(``sketch_dim == 0``, or a sketch_dim that would not compress) the
path is the untouched ``build_tracking_qp`` call.

The draws (buckets, signs, probes) are inputs: the port's own come
from :func:`~porqua_tpu_torch.qp.canonical.sketch_draws` of
``SketchParams.seed`` (one ``torch.Generator``, so one seed gives the
same embedding on the CPU and on the card), or a caller hands over the
JAX package's ``jax.random`` arrays as a ``SketchDraws``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from porqua_tpu_torch.qp.canonical import (HP, SketchDraws, sketch_draws,
                                           sketch_rows)
from porqua_tpu_torch.tracking import (TrackingResult, _sketch_window,
                                       build_tracking_qp)

__all__ = [
    "SketchParams",
    "SketchInfo",
    "count_sketch",
    "gram_rel_err",
    "sketched_tracking_qp",
    "tracking_step_sketched",
]


@dataclasses.dataclass(frozen=True)
class SketchParams:
    """Static sketch configuration.

    sketch_dim: embedding rows; 0 (or a value >= the window length T)
        passes the window through untouched.
    seed: the seed of the port's own draws (buckets, signs, probes).
    probes: probe vectors of the measured Gram error bound.
    """

    sketch_dim: int = 0
    seed: int = 0
    probes: int = 8


class SketchInfo(NamedTuple):
    """What the sketch did, per lane: ``sketch_dim`` the effective dim
    (0 on the passthrough), ``rows_in`` the window length T,
    ``gram_rel_err`` the measured probe bound (0 on the passthrough)."""

    sketch_dim: torch.Tensor    # (B,) int32
    rows_in: torch.Tensor       # (B,) int32
    gram_rel_err: torch.Tensor  # (B,)


def count_sketch(M: torch.Tensor, sketch_dim: int, bucket: torch.Tensor,
                 sign: torch.Tensor) -> torch.Tensor:
    """Count-sketch of the row axis, ``(..., T, k) -> (..., sketch_dim,
    k)``: :func:`porqua_tpu_torch.qp.canonical.sketch_rows`, the one
    primitive the solve path and this certificate path share."""
    return sketch_rows(M, sketch_dim, bucket, sign)


def gram_rel_err(X: torch.Tensor, Xs: torch.Tensor,
                 probes: torch.Tensor) -> torch.Tensor:
    """Measured Gram-error bound per lane: ``max_k ||X'(X v_k) -
    Xs'(Xs v_k)|| / ||X'(X v_k)||`` over the probe vectors ``probes``
    (p, N): four tall-skinny products per probe, never the N x N
    Grams."""
    V = probes.to(device=X.device, dtype=X.dtype).transpose(-1, -2)
    gv = torch.matmul(X.transpose(-1, -2), torch.matmul(X, V))
    gsv = torch.matmul(Xs.transpose(-1, -2), torch.matmul(Xs, V))
    num = torch.linalg.vector_norm(gv - gsv, dim=-2)
    den = torch.clamp_min(torch.linalg.vector_norm(gv, dim=-2), 1e-12)
    return torch.amax(num / den, dim=-1)


def _effective_dim(sketch: SketchParams, T: int) -> int:
    d = sketch.sketch_dim
    return d if 0 < d < T else 0


def sketched_tracking_qp(X: torch.Tensor,
                         y: torch.Tensor,
                         sketch: SketchParams = SketchParams(),
                         ridge: float = 0.0,
                         lb: float = 0.0,
                         ub: float = 1.0,
                         draws: Optional[SketchDraws] = None):
    """Lower (B, T, N) windows to the tracking QPs through the
    (optional) embedding; returns ``(CanonicalQP, SketchInfo)``. The
    sketched QPs are those ``build_tracking_qp(..., sketch_dim=d)``
    assembles from the same draws, bit for bit; the passthrough is the
    identical call on the untouched windows. ``draws`` defaults to
    ``sketch_draws`` of ``sketch.seed`` with ``sketch.probes`` probes."""
    T, n = X.shape[-2], X.shape[-1]
    lead = X.shape[:-2]
    d = _effective_dim(sketch, T)
    as_int = lambda v: torch.full(lead, v, dtype=torch.int32,
                                  device=X.device)
    if d == 0:
        qp = build_tracking_qp(X, y, ridge=ridge, lb=lb, ub=ub)
        return qp, SketchInfo(as_int(0), as_int(T),
                              torch.zeros(lead, dtype=X.dtype,
                                          device=X.device))
    if draws is None:
        draws = sketch_draws(T, d, sketch.seed, n=n, probes=sketch.probes)
    draws = draws.to(X.device, X.dtype)
    Xs, ys = _sketch_window(X, y, d, draws)
    qp = build_tracking_qp(Xs, ys, ridge=ridge, lb=lb, ub=ub)
    return qp, SketchInfo(as_int(d), as_int(T),
                          gram_rel_err(X, Xs, draws.probes))


def tracking_step_sketched(Xs,
                           ys,
                           params=None,
                           sketch: SketchParams = SketchParams(),
                           ridge: float = 0.0,
                           device=None,
                           draws: Optional[SketchDraws] = None
                           ) -> Tuple[TrackingResult, SketchInfo]:
    """The sketched twin of :func:`porqua_tpu_torch.tracking.tracking_step`:
    build through the embedding, solve, and evaluate the tracking error
    against the true (unsketched) window, on ``device`` (default: the
    card)."""
    from porqua_tpu_torch.qp.solve import (SolverParams, _solve_impl,
                                           resolve_device)

    if params is None:
        params = SolverParams()
    dev = resolve_device(device)
    HP.apply()
    Xs = torch.as_tensor(Xs, device=dev)
    ys = torch.as_tensor(ys, device=dev)
    qp, info = sketched_tracking_qp(Xs, ys, sketch, ridge=ridge,
                                    draws=draws)
    sol = _solve_impl(qp, params)
    resid = torch.matmul(Xs, sol.x.unsqueeze(-1)).squeeze(-1) - ys
    te = torch.sqrt(torch.mean(resid * resid, dim=-1))
    return TrackingResult(
        weights=sol.x,
        tracking_error=te,
        status=sol.status,
        iters=sol.iters,
        prim_res=sol.prim_res,
        dual_res=sol.dual_res,
    ), info
