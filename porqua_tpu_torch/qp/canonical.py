"""Static-shape canonical QP representation (PyTorch).

The canonical problem is

    minimize    0.5 x' P x + q' x + constant
    subject to  l  <= C x <= u          (m general rows; eq rows have l == u)
                lb <=   x <= ub         (box, kept separate from C)

the OSQP interval form with the box handled implicitly by the solver.
Problems are padded to one static shape: padded variables get
``lb = ub = 0``, ``q = 0`` and a unit diagonal in ``P``; padded rows are
all-zero with ``l = -inf, u = +inf``. Padding is neutral by
construction, so the solver needs no special-casing; ``var_mask`` /
``row_mask`` mark the real entries for consumers.

A :class:`CanonicalQP` is a NamedTuple of tensors. The solver works on
batches: every field carries a leading batch axis ``B`` (written out,
where the JAX package used ``vmap``). Shapes below are per problem.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from porqua_tpu_torch.utils.helpers import to_numpy


class _PrecisionPolicy:
    """The one precision policy for every residual-bearing product in
    the QP stack. A float32 product on the card may run in TF32, which
    keeps about three decimal digits: that floors the ADMM residuals
    the way the TPU's default bf16 passes did, so the solver runs every
    product in full float32. :meth:`apply` sets the policy;
    :meth:`check` (at solve entry) raises if a caller turned TF32 back
    on."""

    def apply(self) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def check(self) -> None:
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError(
                "TF32 is enabled: the ADMM residuals need full float32 "
                "products. Call porqua_tpu_torch.qp.canonical.HP.apply() "
                "or leave torch's TF32 switches off.")


HP = _PrecisionPolicy()


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from ``None`` (float32), a torch dtype, or anything
    numpy reads as a dtype (``np.float64``, ``"float32"``, a JAX dtype
    object), so a strategy's ``dtype`` setting carries over unchanged."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


class CanonicalQP(NamedTuple):
    """One batch of canonical QPs; all fields are tensors with a
    leading batch axis (shapes given per problem)."""

    P: torch.Tensor          # (n, n) objective quadratic (symmetric PSD)
    q: torch.Tensor          # (n,)   objective linear
    C: torch.Tensor          # (m, n) general constraint rows
    l: torch.Tensor          # (m,)   row lower bounds (-inf for pure <=)
    u: torch.Tensor          # (m,)   row upper bounds (+inf for pure >=)
    lb: torch.Tensor         # (n,)   variable lower bounds
    ub: torch.Tensor         # (n,)   variable upper bounds
    var_mask: torch.Tensor   # (n,)   1.0 for real variables, 0.0 for padding
    row_mask: torch.Tensor   # (m,)   1.0 for real rows, 0.0 for padding
    constant: torch.Tensor   # ()     objective constant
    # Optional low-rank structure: P == 2 Pf' Pf + diag(Pdiag) exactly.
    # With it the solver's linear solves can run in the r-dim dual
    # space (linsolve="woodbury"); None means "no known structure".
    Pf: Optional[torch.Tensor] = None     # (r, n) objective factor
    Pdiag: Optional[torch.Tensor] = None  # (n,)   diagonal completion

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.C.shape[-2]

    @property
    def batch_shape(self):
        return self.P.shape[:-2]

    def to(self, device) -> "CanonicalQP":
        return CanonicalQP(*(None if a is None else a.to(device)
                             for a in self))

    def apply_P(self, v):
        """``P @ v`` through the factor when one is present:
        ``2 Pf'(Pf v) + Pdiag * v``, two skinny matvecs, leaving the
        dense ``P`` unread."""
        if self.Pf is None:
            return torch.einsum("...ij,...j->...i", self.P, v)
        t = torch.einsum("...rj,...j->...r", self.Pf, v)
        out = 2.0 * torch.einsum("...rj,...r->...j", self.Pf, t)
        if self.Pdiag is not None:
            out = out + self.Pdiag * v
        return out

    def objective_value(self, x, with_const: bool = True):
        """0.5 x'Px + q'x (+ constant), P applied through the factor
        when present."""
        val = 0.5 * torch.einsum("...i,...i->...", x, self.apply_P(x)) \
            + torch.einsum("...i,...i->...", self.q, x)
        return val + self.constant if with_const else val

    @staticmethod
    def build(P: np.ndarray,
              q: np.ndarray,
              C: Optional[np.ndarray] = None,
              l: Optional[np.ndarray] = None,
              u: Optional[np.ndarray] = None,
              lb: Optional[np.ndarray] = None,
              ub: Optional[np.ndarray] = None,
              constant: float = 0.0,
              n_max: Optional[int] = None,
              m_max: Optional[int] = None,
              dtype=None,
              Pf: Optional[np.ndarray] = None,
              Pdiag: Optional[np.ndarray] = None,
              *,
              device=None) -> "CanonicalQP":
        """Assemble + pad a single problem (no batch axis) from numpy
        arrays into tensors on ``device`` (default: the card, through
        ``qp/solve.py::resolve_device``); ``dtype`` goes through
        :func:`as_torch_dtype` (``None`` means float32).
        ``Pf``/``Pdiag`` expose ``P == 2 Pf' Pf + diag(Pdiag)``, checked
        here by one matvec: a gross mismatch raises, rounding-grade
        drift warns and drops the factor."""
        dtype = as_torch_dtype(dtype)
        P = np.asarray(P, dtype=np.float64)
        q = np.asarray(q, dtype=np.float64).reshape(-1)
        n = q.shape[0]
        if C is None or C.size == 0:
            C = np.zeros((0, n))
            l = np.zeros((0,))
            u = np.zeros((0,))
        C = np.asarray(C, dtype=np.float64).reshape(-1, n)
        l = np.asarray(l, dtype=np.float64).reshape(-1)
        u = np.asarray(u, dtype=np.float64).reshape(-1)
        m = C.shape[0]
        lb = np.full(n, -np.inf) if lb is None else np.asarray(lb, dtype=np.float64)
        ub = np.full(n, np.inf) if ub is None else np.asarray(ub, dtype=np.float64)

        n_max = n if n_max is None else int(n_max)
        m_max = m if m_max is None else int(m_max)
        if n_max < n or m_max < m:
            raise ValueError(f"padding target ({n_max},{m_max}) smaller than problem ({n},{m})")

        dn, dm = n_max - n, m_max - m
        P_pad = np.zeros((n_max, n_max))
        P_pad[:n, :n] = P
        if dn:
            P_pad[n:, n:] = np.eye(dn)
        q_pad = np.concatenate([q, np.zeros(dn)])
        C_pad = np.zeros((m_max, n_max))
        C_pad[:m, :n] = C
        l_pad = np.concatenate([l, np.full(dm, -np.inf)])
        u_pad = np.concatenate([u, np.full(dm, np.inf)])
        lb_pad = np.concatenate([lb, np.zeros(dn)])
        ub_pad = np.concatenate([ub, np.zeros(dn)])
        var_mask = np.concatenate([np.ones(n), np.zeros(dn)])
        row_mask = np.concatenate([np.ones(m), np.zeros(dm)])

        Pf_pad = Pd_pad = None
        if Pf is not None:
            Pf = np.asarray(Pf, dtype=np.float64).reshape(-1, n)
            Pd = (np.zeros(n) if Pdiag is None
                  else np.asarray(Pdiag, dtype=np.float64).reshape(-1))
            v = np.cos(np.arange(n, dtype=np.float64))
            pv = P @ v
            fv = 2.0 * (Pf.T @ (Pf @ v)) + Pd * v
            dev = float(np.max(np.abs(pv - fv)))
            scale = max(float(np.max(np.abs(pv))), 1e-30)
            if dev > 1e-3 * scale:
                raise ValueError(
                    "Pf/Pdiag do not reproduce P (convention: "
                    "P == 2 Pf' Pf + diag(Pdiag)); matvec deviation "
                    f"{dev:.3e} vs scale {scale:.3e}")
            if dev > 1e-7 * scale:
                warnings.warn(
                    f"objective factor reproduces P only to {dev/scale:.1e} "
                    "relative (float32-source rounding?); using the dense "
                    "path", stacklevel=2)
            else:
                Pf_pad = np.concatenate(
                    [Pf, np.zeros((Pf.shape[0], dn))], axis=1)
                # Padded variables carry P = I on the diagonal block: it
                # lives in the diagonal completion so the factor stays exact.
                Pd_pad = np.concatenate([Pd, np.ones(dn)])
        elif Pdiag is not None:
            raise ValueError("Pdiag without Pf has no meaning")

        # Local import: qp/solve.py imports this module.
        from porqua_tpu_torch.qp.solve import resolve_device

        device = resolve_device(device)
        as_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                           device=device)
        return CanonicalQP(
            P=as_dev(P_pad), q=as_dev(q_pad), C=as_dev(C_pad),
            l=as_dev(l_pad), u=as_dev(u_pad), lb=as_dev(lb_pad), ub=as_dev(ub_pad),
            var_mask=as_dev(var_mask), row_mask=as_dev(row_mask),
            constant=as_dev(constant),
            Pf=None if Pf_pad is None else as_dev(Pf_pad),
            Pdiag=None if Pd_pad is None else as_dev(Pd_pad),
        )


def stack_qps(qps: Sequence[CanonicalQP], stack_fn=None) -> CanonicalQP:
    """Stack same-shape single problems into one batch along a new
    leading axis: ``torch.stack`` by default, or ``stack_fn`` called as
    the JAX package calls it, once per present field with the tuple of
    that field's arrays as numpy (e.g. ``np.stack``: the batch stays on
    the host); the fields are whatever it returns."""
    if not qps:
        raise ValueError("cannot stack an empty sequence of QPs")
    shapes = {(qp.n, qp.m) for qp in qps}
    if len(shapes) != 1:
        raise ValueError(
            f"all problems must share one padded shape; got {sorted(shapes)}. "
            "Pass n_max/m_max to CanonicalQP.build."
        )
    if stack_fn is None:
        return CanonicalQP(*(None if fields[0] is None
                             else torch.stack(fields)
                             for fields in zip(*qps)))
    return CanonicalQP(*(None if fields[0] is None
                         else stack_fn(tuple(to_numpy(a) for a in fields))
                         for fields in zip(*qps)))


def pad_qp(qp: CanonicalQP, n_max: int, m_max: int) -> CanonicalQP:
    """Re-pad an already-built single problem to a larger static shape
    with the same neutrality scheme as :meth:`CanonicalQP.build`.
    Returns tensors on the problem's device; a factored problem always
    carries a ``Pdiag`` after padding, so padded problems stack."""
    n, m = qp.n, qp.m
    if n_max < n or m_max < m:
        raise ValueError(
            f"padding target ({n_max},{m_max}) smaller than problem "
            f"({n},{m})")
    dn, dm = n_max - n, m_max - m
    dtype, device = qp.q.dtype, qp.q.device
    full = lambda size, fill: torch.full((size,), fill, dtype=dtype,
                                         device=device)
    if dn == 0 and dm == 0:
        if qp.Pf is not None and qp.Pdiag is None:
            return qp._replace(Pdiag=full(n, 0.0))
        return qp

    P_pad = torch.zeros((n_max, n_max), dtype=dtype, device=device)
    P_pad[:n, :n] = qp.P
    if dn:
        P_pad[n:, n:] = torch.eye(dn, dtype=dtype, device=device)
    C_pad = torch.zeros((m_max, n_max), dtype=dtype, device=device)
    C_pad[:m, :n] = qp.C
    pad_n = lambda v, fill: torch.cat([v, full(dn, fill)])
    pad_m = lambda v, fill: torch.cat([v, full(dm, fill)])
    Pf_pad = Pd_pad = None
    if qp.Pf is not None:
        # Factor rows are a capacitance dimension, never padded; the
        # padding block's unit diagonal lives in the diagonal completion.
        Pf_pad = torch.cat(
            [qp.Pf, torch.zeros((qp.Pf.shape[0], dn), dtype=dtype,
                                device=device)], dim=1)
        Pd = qp.Pdiag if qp.Pdiag is not None else full(n, 0.0)
        Pd_pad = pad_n(Pd, 1.0)
    return CanonicalQP(
        P=P_pad, q=pad_n(qp.q, 0.0), C=C_pad,
        l=pad_m(qp.l, -np.inf), u=pad_m(qp.u, np.inf),
        lb=pad_n(qp.lb, 0.0), ub=pad_n(qp.ub, 0.0),
        var_mask=pad_n(qp.var_mask, 0.0), row_mask=pad_m(qp.row_mask, 0.0),
        constant=qp.constant,
        Pf=Pf_pad, Pdiag=Pd_pad,
    )


class SketchDraws(NamedTuple):
    """The random draws of one count-sketch: each of the T rows goes to
    bucket ``bucket[t]`` with sign ``sign[t]``; ``probes`` (p, N) are
    the Gaussian vectors of the measured Gram error (``None`` where
    unused). The JAX package draws them with ``jax.random``, whose
    streams torch cannot reproduce, so the port takes them as inputs:
    :func:`sketch_draws` makes its own from a seed, and a caller can
    hand over the JAX package's arrays instead."""

    bucket: torch.Tensor                   # (T,) int64 in [0, sketch_dim)
    sign: torch.Tensor                     # (T,) +-1
    probes: Optional[torch.Tensor] = None  # (p, N)

    def to(self, device, dtype) -> "SketchDraws":
        return SketchDraws(
            torch.as_tensor(self.bucket, device=device).long(),
            torch.as_tensor(self.sign, device=device, dtype=dtype),
            None if self.probes is None else torch.as_tensor(
                self.probes, device=device, dtype=dtype))


def sketch_draws(rows: int, sketch_dim: int, seed: int,
                 n: int = 0, probes: int = 0,
                 dtype=torch.float32) -> SketchDraws:
    """The port's own seeded draws: buckets, signs, then ``probes``
    Gaussian vectors of length ``n``, all from one ``torch.Generator``
    seeded with ``seed`` on the CPU (move them with
    :meth:`SketchDraws.to`), so one seed gives the same draws on the
    CPU and on the card."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    bucket = torch.randint(0, int(sketch_dim), (int(rows),), generator=gen)
    sign = (2 * torch.randint(0, 2, (int(rows),), generator=gen) - 1).to(dtype)
    V = (torch.randn((int(probes), int(n)), generator=gen, dtype=dtype)
         if probes else None)
    return SketchDraws(bucket, sign, V)


def sketch_rows(M: torch.Tensor, sketch_dim: int, bucket: torch.Tensor,
                sign: torch.Tensor) -> torch.Tensor:
    """Clarkson-Woodruff count-sketch of the row axis: ``(..., T, k) ->
    (..., sketch_dim, k)``, row t added with sign ``sign[t]`` into
    bucket ``bucket[t]`` (the JAX package's signed ``segment_sum``).

    Computed as the signed selection matrix ``S`` (sketch_dim, T) times
    ``M`` in full float32 (TF32 off): a dense product sums in a fixed
    order, so the same draws give the same bits on every run, where an
    atomic scatter-add on the card would not. Each bucket's sum agrees
    with the segment sum to float32 summation order."""
    T = M.shape[-2]
    S = torch.zeros((int(sketch_dim), T), dtype=M.dtype, device=M.device)
    S[bucket.to(M.device), torch.arange(T, device=M.device)] = \
        sign.to(device=M.device, dtype=M.dtype)
    return torch.matmul(S, M)
