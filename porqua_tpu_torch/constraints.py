"""Declarative portfolio-constraint container and canonicalization
(host-side numpy/pandas; a copy of ``porqua_tpu/constraints.py``, which
this package may not import because importing it runs the JAX package).

Every linear constraint is stored as one *interval row*
``lower <= a . x <= upper`` from the moment it is added. Equalities are
rows with ``lower == upper``; one-sided inequalities have an infinite
bound. This is the row form the batched solver consumes
(:class:`~porqua_tpu_torch.qp.canonical.CanonicalQP` interval form), so
:meth:`Constraints.to_canonical` is a direct stack of the stored rows.
The standard form ``G x <= h`` / ``A x = b`` is kept as a view
(:meth:`Constraints.to_GhAb`), derived from the interval rows on demand.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

_INF = float("inf")


def match_arg(x, lst):
    """First element of ``lst`` containing ``x`` as a substring (the
    R-style partial matching the reference DSL exposes)."""
    for candidate in lst:
        if x in candidate:
            return candidate
    raise ValueError(f"{x!r} does not match any of {lst}")


def box_constraint(box_type: str = "LongOnly", lower=None, upper=None) -> dict:
    """Resolve box-type defaults into concrete lower/upper values.

    Same semantics as the reference helper (``constraints.py:178-204``):
    Unbounded -> (-inf, inf), LongShort -> (-1, 1), LongOnly -> (0, 1),
    with caller-supplied values taking precedence and LongOnly rejecting
    negative lower bounds.
    """
    kind = match_arg(box_type, ["LongOnly", "LongShort", "Unbounded"])
    defaults = {"Unbounded": (-_INF, _INF), "LongShort": (-1, 1),
                "LongOnly": (0, 1)}
    dlo, dhi = defaults[kind]

    if kind == "LongOnly":
        if lower is not None:
            bad = (lower < 0) if np.isscalar(lower) else any(
                v < 0 for v in lower)
            if bad:
                raise ValueError(
                    "LongOnly boxes need nonnegative lower bounds; use "
                    "box_type='LongShort' to allow short positions.")
            if upper is None:
                upper = lower * 0 + 1 if not np.isscalar(lower) else 1
        elif upper is not None:
            lower = upper * 0 if not np.isscalar(upper) else 0

    lower = dlo if lower is None else lower
    upper = dhi if upper is None else upper
    return {"box_type": kind, "lower": lower, "upper": upper}


def linear_constraint(Amat=None, sense: str = "=", rhs=_INF,
                      index_or_name=None, a_values=None) -> dict:
    """Plain-dict linear-constraint record (reference API parity,
    ``constraints.py:206-218``)."""
    out = {"Amat": Amat, "sense": sense, "rhs": rhs}
    if index_or_name is not None:
        out["index_or_name"] = index_or_name
    if a_values is not None:
        out["a_values"] = a_values
    return out


def _interval_from_sense(sense: str, rhs: float):
    """Map a (sense, rhs) pair onto the interval [lower, upper]."""
    if sense == "=":
        return float(rhs), float(rhs)
    if sense == "<=":
        return -_INF, float(rhs)
    if sense == ">=":
        return float(rhs), _INF
    raise ValueError(f"unknown constraint sense {sense!r}")


@dataclass
class IntervalRow:
    """One stored constraint row: ``lower <= coeffs . x <= upper``."""

    coeffs: pd.Series           # aligned to the selection, zeros filled
    lower: float
    upper: float
    name: str = ""

    @property
    def is_equality(self) -> bool:
        return self.lower == self.upper


@dataclass
class _Box:
    """Per-variable bounds; ``kind == 'NA'`` means not configured."""

    kind: str = "NA"
    lower: Optional[pd.Series] = None
    upper: Optional[pd.Series] = None


class Constraints:
    """Constraint set for one asset universe.

    Same builder surface as the reference DSL (``add_budget``,
    ``add_box``, ``add_linear``, ``add_l1``, ``to_GhAb``) plus the
    canonical lowerings (``interval_rows``, ``bounds``,
    ``to_canonical``). Internally everything is interval rows — see the
    module docstring.
    """

    def __init__(self, selection="NA") -> None:
        for item in selection:
            if not isinstance(item, str):
                raise ValueError(
                    "'selection' must be an iterable of asset-name strings")
        self.selection = selection
        self._budget: Optional[IntervalRow] = None
        self._rows: List[IntervalRow] = []
        self._box = _Box()
        self.l1: Dict[str, dict] = {}

    def __str__(self) -> str:
        parts = [f"selection: {list(self.selection)}",
                 f"budget: {self.budget}", f"box: {self.box}"]
        parts += [f"row[{r.name}]: {r.lower} <= {dict(r.coeffs)} <= "
                  f"{r.upper}" for r in self._rows]
        parts += [f"l1[{k}]: {v}" for k, v in self.l1.items()]
        return "\n".join(parts)

    # ------------------------------------------------------------------
    # Reference-compatible dict views
    # ------------------------------------------------------------------

    @property
    def budget(self) -> dict:
        if self._budget is None:
            return {"Amat": None, "sense": None, "rhs": None}
        row = self._budget
        if row.is_equality:
            sense, rhs = "=", row.upper
        elif math.isfinite(row.upper):
            sense, rhs = "<=", row.upper
        else:
            sense, rhs = ">=", row.lower
        return {"Amat": row.coeffs, "sense": sense, "rhs": rhs}

    @property
    def box(self) -> dict:
        return {"box_type": self._box.kind, "lower": self._box.lower,
                "upper": self._box.upper}

    @property
    def linear(self) -> dict:
        if not self._rows:
            return {"Amat": None, "sense": None, "rhs": None}
        senses, rhs = [], []
        for r in self._rows:
            if r.is_equality:
                senses.append("=")
                rhs.append(r.upper)
            elif math.isfinite(r.upper):
                senses.append("<=")
                rhs.append(r.upper)
            else:
                senses.append(">=")
                rhs.append(r.lower)
        Amat = pd.DataFrame([r.coeffs for r in self._rows])
        Amat.index = [r.name for r in self._rows]
        return {"Amat": Amat, "sense": pd.Series(senses, index=Amat.index),
                "rhs": pd.Series(rhs, index=Amat.index)}

    # ------------------------------------------------------------------
    # Builders
    # ------------------------------------------------------------------

    def _aligned(self, values) -> pd.Series:
        """Coerce coefficients to a float Series over the selection."""
        s = pd.Series(values, dtype=float) if not isinstance(
            values, pd.Series) else values.astype(float)
        return s.reindex(list(self.selection)).fillna(0.0)

    def add_budget(self, rhs=1, sense: str = "=") -> None:
        if self._budget is not None:
            warnings.warn("replacing the existing budget constraint")
        ones = pd.Series(1.0, index=list(self.selection))
        lo, hi = _interval_from_sense(sense, rhs)
        self._budget = IntervalRow(ones, lo, hi, name="budget")

    def add_box(self, box_type: str = "LongOnly", lower=None,
                upper=None) -> None:
        spec = box_constraint(box_type, lower, upper)
        idx = list(self.selection)
        lb = spec["lower"]
        ub = spec["upper"]
        lb = pd.Series(float(lb), index=idx) if np.isscalar(lb) \
            else pd.Series(lb, index=idx, dtype=float)
        ub = pd.Series(float(ub), index=idx) if np.isscalar(ub) \
            else pd.Series(ub, index=idx, dtype=float)
        if (ub < lb).any():
            raise ValueError(
                "box upper bounds must not be below the lower bounds")
        self._box = _Box(spec["box_type"], lb, ub)

    def add_linear(self,
                   Amat: Optional[pd.DataFrame] = None,
                   a_values: Optional[pd.Series] = None,
                   sense="=",
                   rhs=None,
                   name: Optional[str] = None) -> None:
        """Append one or more rows. ``Amat`` is a (rows x assets) frame;
        alternatively a single row via ``a_values``. ``sense``/``rhs``
        may be scalars (broadcast) or Series aligned to the rows."""
        if Amat is None:
            if a_values is None:
                raise ValueError("provide 'Amat' or 'a_values'")
            Amat = pd.DataFrame(
                [self._aligned(a_values)],
                index=[name if name is not None else len(self._rows)])

        n_rows = Amat.shape[0]
        senses = list(sense) if not isinstance(sense, str) else [sense] * n_rows
        rhss = [rhs] * n_rows if np.isscalar(rhs) or rhs is None else list(rhs)
        for i in range(n_rows):
            lo, hi = _interval_from_sense(senses[i], rhss[i])
            self._rows.append(IntervalRow(
                self._aligned(Amat.iloc[i]), lo, hi, name=str(Amat.index[i])))

    def add_l1(self, name: str, rhs=None, x0=None, *args, **kwargs) -> None:
        """Record an L1 term symbolically (turnover / leverage).

        The solve path consumes these either via static-shape
        linearization (:mod:`porqua_tpu_torch.qp.lift`) or as prox terms in
        the ADMM solver — never as expanded rows here, so shapes stay
        static across a backtest.
        """
        if rhs is None:
            raise TypeError("add_l1 needs an 'rhs' budget value")
        record = dict(kwargs)
        record["rhs"] = rhs
        if x0:
            record["x0"] = x0
        for i, extra in enumerate(args):
            record[f"arg{i}"] = extra
        self.l1[name] = record

    # ------------------------------------------------------------------
    # Lowerings
    # ------------------------------------------------------------------

    def _ordered_rows(self) -> List[IntervalRow]:
        """Budget first, then user rows in insertion order."""
        rows = [self._budget] if self._budget is not None else []
        return rows + self._rows

    def interval_rows(self):
        """Stack all rows as ``(C, l, u)`` numpy arrays, equalities
        first (then inequalities), preserving insertion order within
        each group. This is the direct input to the device solver."""
        n = len(self.selection)
        rows = self._ordered_rows()
        eq = [r for r in rows if r.is_equality]
        ineq = [r for r in rows if not r.is_equality]
        ordered = eq + ineq
        if not ordered:
            return (np.zeros((0, n)), np.zeros((0,)), np.zeros((0,)))
        C = np.stack([r.coeffs.to_numpy() for r in ordered])
        l = np.array([r.lower for r in ordered])
        u = np.array([r.upper for r in ordered])
        return C, l, u

    def bounds(self):
        """Per-variable ``(lb, ub)`` numpy arrays (±inf when no box)."""
        n = len(self.selection)
        if self._box.kind == "NA":
            return np.full(n, -_INF), np.full(n, _INF)
        return (self._box.lower.to_numpy(dtype=float),
                self._box.upper.to_numpy(dtype=float))

    def to_GhAb(self, lbub_to_G: bool = False) -> Dict[str, Optional[np.ndarray]]:
        """Standard-form view ``{'G','h','A','b'}``: equality rows in
        ``A x = b``, everything else as ``G x <= h`` (lower-bounded rows
        negated). Row order matches the reference contract: budget, then
        (optionally) box rows as ``[-I; I]``, then user rows."""
        n = len(self.selection)
        A_rows, b_vals, G_rows, h_vals = [], [], [], []

        def lower_one(row: IntervalRow):
            a = row.coeffs.to_numpy()
            if row.is_equality:
                A_rows.append(a)
                b_vals.append(row.upper)
            elif math.isfinite(row.upper):
                G_rows.append(a)
                h_vals.append(row.upper)
            else:
                G_rows.append(-a)
                h_vals.append(-row.lower)

        if self._budget is not None:
            lower_one(self._budget)
        if lbub_to_G:
            lb, ub = self.bounds()
            eye = np.eye(n)
            G_rows.extend(-eye)
            h_vals.extend(-lb)
            G_rows.extend(eye)
            h_vals.extend(ub)
        for row in self._rows:
            lower_one(row)

        out: Dict[str, Optional[np.ndarray]] = {
            "G": None, "h": None, "A": None, "b": None}
        if A_rows:
            out["A"] = np.stack(A_rows).reshape(-1, n)
            out["b"] = np.asarray(b_vals, dtype=float)
        if G_rows:
            out["G"] = np.stack(G_rows).reshape(-1, n)
            out["h"] = np.asarray(h_vals, dtype=float)
        return out

    def to_canonical(self,
                     P: Optional[np.ndarray] = None,
                     q: Optional[np.ndarray] = None,
                     constant: float = 0.0,
                     n_max: Optional[int] = None,
                     m_max: Optional[int] = None,
                     device="cpu"):
        """Lower constraints (+ optional objective) to a padded
        :class:`~porqua_tpu_torch.qp.canonical.CanonicalQP`.

        A direct stack of the stored interval rows: no sense handling
        happens here because none was stored. Rows are padded to
        ``m_max`` and variables to ``n_max`` so per-date problems of
        differing universe size batch into one device array.
        """
        from porqua_tpu_torch.qp.canonical import CanonicalQP

        n = len(self.selection)
        C, l, u = self.interval_rows()
        lb, ub = self.bounds()
        return CanonicalQP.build(
            P=np.zeros((n, n)) if P is None else np.asarray(P, dtype=float),
            q=np.zeros(n) if q is None else np.asarray(q, dtype=float),
            C=C, l=l, u=u, lb=lb, ub=ub,
            constant=float(constant),
            n_max=n_max, m_max=m_max, device=device,
        )
