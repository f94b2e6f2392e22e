"""Optimization strategy classes (objective formulation + solve), the
port of ``porqua_tpu/optimization.py``.

``MeanVariance``, ``QEQW``, ``LeastSquares``, ``WeightedLeastSquares``,
``LAD`` and ``PercentilePortfolios`` lower their problem to unpadded
canonical parts (numpy) and, for a serial solve, to a padded
:class:`~porqua_tpu_torch.qp.canonical.CanonicalQP` solved by the
batched ADMM solver on ``device`` (default: the card). The lowering is
the reference's to the byte; the parity tests hold ``canonical_parts``
of each strategy equal to it.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import pandas as pd
import torch

from porqua_tpu_torch.constraints import Constraints
from porqua_tpu_torch.estimators.covariance import Covariance
from porqua_tpu_torch.estimators.mean import MeanEstimator
from porqua_tpu_torch.optimization_data import OptimizationData
from porqua_tpu_torch.qp import lift
from porqua_tpu_torch.qp.canonical import CanonicalQP, as_torch_dtype
from porqua_tpu_torch.qp.solve import (
    QPSolution,
    SolverParams,
    Status,
    resolve_device,
    solve_qp,
)
from porqua_tpu_torch.utils.helpers import to_numpy

# Solver-parameter keys that OptimizationParameter forwards to SolverParams.
_SOLVER_KEYS = tuple(SolverParams.__dataclass_fields__.keys())
# The batched ADMM solver of this package. "jax_admm", the JAX
# package's name for its own, is accepted too, so configs carry over.
DEFAULT_SOLVER = "torch_admm"
_DEFAULT_NAMES = (None, "", DEFAULT_SOLVER, "jax_admm", "default")


class OptimizationParameter(dict):
    """Free-form parameter dict (reference ``optimization.py:40-47``) that
    can project itself onto the typed, hashable :class:`SolverParams`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self
        # Key-presence checks: an explicit falsy value (solver_name="",
        # allow_suboptimal=False, verbose=False) must survive — the
        # reference's truthiness-based defaulting silently re-defaults
        # them, which is exactly the dict-config looseness the typed
        # SolverParams retires. ``allow_suboptimal`` is deliberately
        # NOT materialized here: absent reads as falsy (strict success
        # semantics) via ``.get()``, and key presence then faithfully
        # records that the caller set it — which lets strategy classes
        # with a different default (LAD) distinguish "caller said
        # False" from "caller said nothing".
        if "solver_name" not in self:
            self["solver_name"] = DEFAULT_SOLVER
        if "verbose" not in self:
            self["verbose"] = True

    def to_solver_params(self) -> SolverParams:
        fields = {k: self[k] for k in _SOLVER_KEYS if k in self}
        return SolverParams(**fields)


class Objective(dict):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)


class Optimization(ABC):
    """Template-method base (reference ``optimization.py:56-143``):
    ``set_objective(data)`` then ``solve()``."""

    def __init__(self,
                 params: OptimizationParameter = None,
                 constraints: Constraints = None,
                 **kwargs):
        self.params = OptimizationParameter(**kwargs) if params is None else params
        self.objective = Objective()
        self.constraints = Constraints() if constraints is None else constraints
        self.model = None          # CanonicalQP after model_canonical()
        self.solution: Optional[QPSolution] = None
        self.results = None

    @abstractmethod
    def set_objective(self, optimization_data: OptimizationData) -> None:
        raise NotImplementedError("Method 'set_objective' must be implemented in derived class.")

    def solve(self, device=None) -> bool:
        """Solve on ``device`` (default: the card; with no card and no
        ``device`` it raises); returns the success flag."""
        self.solve_torch(device)
        return self.results["status"]

    # ------------------------------------------------------------------
    # Canonical lowering + solve
    # ------------------------------------------------------------------

    def solver_params(self, solve_dtype=None) -> SolverParams:
        """Resolved solver configuration for this strategy's active
        lowering. Pure: consults but never mutates ``self.params``, so
        callers may derive it before or after ``canonical_parts`` and
        see the same answer. Subclasses with lowering-dependent solver
        defaults (LAD's prox-form LP settings) merge them here.

        ``solve_dtype``: the dtype the consumer will actually solve in,
        when it differs from the strategy's own declaration — the batch
        engine casts problems to ITS dtype argument (f32 default), so
        dtype-sensitive defaults must key on the solve dtype, not the
        declaration."""
        return self.params.to_solver_params()

    def solve_torch(self, device=None) -> None:
        name = self.params.get("solver_name", DEFAULT_SOLVER)
        if name not in _DEFAULT_NAMES:
            self._solve_via_backend(name, device)
            return
        dev = resolve_device(device)
        qp = self.model_canonical(device=dev)
        solver_params = self.solver_params()

        x0 = self._x_init_array()
        if x0 is not None and x0.shape[0] != qp.n:
            x0 = np.concatenate([x0, np.zeros(qp.n - x0.shape[0])])

        as_dev = lambda a: None if a is None else torch.as_tensor(
            np.asarray(a), dtype=qp.q.dtype, device=dev)
        l1 = getattr(self, "_l1_pair", None)
        sol = solve_qp(
            qp, solver_params, x0=as_dev(x0),
            l1_weight=None if l1 is None else as_dev(l1[0]),
            l1_center=None if l1 is None else as_dev(l1[1]),
            device=dev,
        )
        self.solution = sol
        self._publish_results(to_numpy(sol.x), int(sol.status))

    def _publish_results(self, x: np.ndarray, status_code: int,
                         suboptimal_acceptable: bool = True) -> None:
        """One copy of the results contract for every solve path:
        status from the code (with the ``allow_suboptimal`` MAX_ITER
        acceptance where the backend can vouch for MAX_ITER-ness),
        weights = x's universe slice on success, Nones on failure."""
        status = bool(status_code == Status.SOLVED)
        if (not status and suboptimal_acceptable
                and self.params.get("allow_suboptimal")):
            status = bool(status_code == Status.MAX_ITER)
        universe = self.constraints.selection
        weights = pd.Series(
            x[: len(universe)] if status else [None] * len(universe),
            index=universe,
        )
        self.results = {"weights": weights.to_dict(), "status": status}

    # Reference solver-name spellings -> compare-harness backend keys.
    # The reference's set (cvxopt/osqp/quadprog/daqp/highs/qpalm,
    # ``qp_problems.py:19-30``) maps onto qpsolvers-* rows, which exist
    # only where the qpsolvers package is installed.
    _SOLVER_ALIASES = {
        "ipm": "ipm-f64",
        "interior-point": "ipm-f64",
        "native": "native-cpp-admm",
        "cpp": "native-cpp-admm",
        "scipy": "scipy-slsqp",
        "slsqp": "scipy-slsqp",
        "admm-f32": "device-admm-f32",
        "admm-f64": "device-admm-f64",
        **{s: f"qpsolvers-{s}" for s in
           ("cvxopt", "osqp", "quadprog", "daqp", "highs", "qpalm",
            "clarabel", "ecos", "scs", "piqp", "proxqp")},
    }

    def _solve_via_backend(self, name: str, device=None) -> None:
        """Solve through a named compare-harness backend (f64 IPM, the
        native C++ ADMM core, scipy, the device rows on ``device``,
        qpsolvers-* when installed).

        These backends consume the *unpadded* canonical parts and return
        (x, y, mu, found); they do not implement the native L1 prox or
        warm starts — cost terms must use the lifted formulation (the
        reference's own, ``qp_problems.py:120-157``), which
        ``canonical_parts`` emits whenever ``l1_native`` is unset.
        """
        from types import SimpleNamespace

        from porqua_tpu_torch.compare import available_backends

        parts = self.canonical_parts()
        if "l1_weight" in parts:
            raise ValueError(
                f"solver_name={name!r} cannot solve the native-L1 prox "
                "form; drop l1_native (the lifted formulation is "
                "backend-agnostic) or use the default torch_admm solver")
        key = self._SOLVER_ALIASES.get(name, name)
        backends = available_backends(device)
        if key not in backends:
            raise ValueError(
                f"solver {name!r} (backend key {key!r}) is not available "
                f"in this environment; have {sorted(backends)}")
        x, y, mu, found = backends[key](parts, self.solver_params())

        if not found and self.params.get("allow_suboptimal"):
            # The backend contract reports only found/not-found; unlike
            # the device solver's status codes it cannot distinguish
            # "hit max_iter near the optimum" from "infeasible", so the
            # MAX_ITER acceptance cannot be applied safely here.
            warnings.warn(
                f"solver {name!r} reported failure; allow_suboptimal "
                "cannot be honored through named backends (no MAX_ITER/"
                "infeasible distinction) — use the default torch_admm "
                "solver for suboptimal acceptance", stacklevel=3)
        self.solution = SimpleNamespace(
            x=x, y=y, mu=mu, found=bool(found),
            status=Status.SOLVED if found else Status.MAX_ITER,
            iters=-1, prim_res=np.nan, dual_res=np.nan,
        )
        self._publish_results(
            np.asarray(x),
            Status.SOLVED if found else Status.MAX_ITER,
            suboptimal_acceptable=False,
        )

    def canonical_parts(self) -> dict:
        """Assemble objective + constraints into *unpadded* canonical parts
        ``{P, q, C, l, u, lb, ub, constant}`` (numpy).

        The batched backtest (:mod:`porqua_tpu_torch.batch`) collects these for
        every rebalance date first, finds the maximum dimensions, and only
        then pads — so all dates share one static shape.
        """
        if "P" in self.objective:
            P = to_numpy(self.objective["P"])
        else:
            raise ValueError("Missing matrix 'P' in objective.")
        q = (
            to_numpy(self.objective["q"]).reshape(-1)
            if "q" in self.objective
            else np.zeros(len(self.constraints.selection))
        )
        constant = self.objective.get("constant") or 0.0

        constraints = self.constraints
        n = len(constraints.selection)
        C, l, u = constraints.interval_rows()
        lb, ub = constraints.bounds()

        parts = lift._as_parts(np.asarray(P, float), np.asarray(q, float), C, l, u, lb, ub)
        # Low-rank objective structure (P == 2 Pf' Pf + diag(Pdiag)),
        # when the objective exposes it. The dimension-expanding lifts
        # below rebuild `parts` from scratch, so a lifted problem
        # naturally sheds the factor (it would no longer reproduce the
        # expanded P); the native-L1 path keeps the problem — and the
        # factor — intact.
        if "Pf" in self.objective:
            parts["Pf"] = to_numpy(self.objective["Pf"])
            pd_ = self.objective.get("Pdiag")
            if pd_ is not None:
                parts["Pdiag"] = to_numpy(pd_)

        # L1 terms (reference optimization.py:125-142). The two turnover
        # rewrites are mutually exclusive: a zero/absent transaction cost
        # means "no cost term", in which case a turnover *constraint* (if
        # declared) applies — never both, since each expands the variable
        # space and the second lift would see a stale x_init length.
        x_init = self._x_init_array()
        transaction_cost = self.params.get("transaction_cost")
        tocon = self.constraints.l1.get("turnover")
        if transaction_cost and x_init is not None:
            if self.params.get("l1_native"):
                # Native prox path: keep the problem at n variables and
                # hand the turnover-cost term to the solver's w-block
                # soft-threshold (admm_solve l1_weight/l1_center) — the
                # static-shape alternative to the reference's 2x
                # variable expansion (qp_problems.py:120-157).
                parts["l1_weight"] = np.full(n, float(transaction_cost))
                parts["l1_center"] = np.asarray(x_init, dtype=float)
            else:
                parts = lift.lift_turnover_objective(parts, x_init, transaction_cost)
        elif tocon and x_init is not None:
            parts = lift.lift_turnover_constraint(parts, x_init, tocon["rhs"])
        levcon = self.constraints.l1.get("leverage")
        if levcon is not None:
            # The lift rebuilds the parts dict; carry the native-L1 keys
            # across it (they address the first n variables, which the
            # leverage lift leaves in place before its aux block).
            l1_keys = {k: parts[k] for k in ("l1_weight", "l1_center")
                       if k in parts}
            parts = lift.lift_leverage_constraint(parts, levcon["rhs"])
            parts.update(l1_keys)

        parts["constant"] = float(constant)
        return parts

    def model_canonical(self, device=None) -> CanonicalQP:
        """Lower to a padded :class:`CanonicalQP` on ``device`` (default:
        the card; raises without one, as every entry point does)."""
        device = resolve_device(device)
        parts = self.canonical_parts()
        self.model = CanonicalQP.build(
            parts["P"], parts["q"], C=parts["C"], l=parts["l"], u=parts["u"],
            lb=parts["lb"], ub=parts["ub"], constant=parts["constant"],
            n_max=self.params.get("n_max"), m_max=self.params.get("m_max"),
            dtype=self.params.get("dtype"),
            Pf=parts.get("Pf"), Pdiag=parts.get("Pdiag"), device=device,
        )
        if "l1_weight" in parts:
            n_pad = self.model.n
            dt = to_numpy(self.model.q).dtype
            self._l1_pair = (
                np.pad(parts["l1_weight"], (0, n_pad - len(parts["l1_weight"]))).astype(dt),
                np.pad(parts["l1_center"], (0, n_pad - len(parts["l1_center"]))).astype(dt),
            )
        else:
            self._l1_pair = None
        return self.model

    def _x_init_array(self) -> Optional[np.ndarray]:
        """Reference-position x0 from the turnover constraint or params
        (reference ``optimization.py:126-128``)."""
        tocon = self.constraints.l1.get("turnover")
        x0 = (
            tocon["x0"]
            if tocon is not None and tocon.get("x0") is not None
            else self.params.get("x0")
        )
        if x0 is None:
            return None
        universe = self.constraints.selection
        return np.array([x0.get(asset, 0) for asset in universe], dtype=float)

    def is_feasible(self, device=None) -> bool:
        """Zero-objective probe solve on ``device`` (default: the card)."""
        dev = resolve_device(device)
        qp = self.model_canonical(device=dev)
        # Drop any objective factor with the objective: the factored
        # polish/linsolve paths would otherwise solve against the real
        # Hessian the stale Pf still describes, not the probe's.
        probe = qp._replace(
            P=torch.eye(qp.n, dtype=qp.P.dtype, device=dev) * 1e-6,
            q=torch.zeros_like(qp.q), Pf=None, Pdiag=None)
        sol = solve_qp(probe, self.params.to_solver_params(), device=dev)
        return bool(sol.status == Status.SOLVED)


class EmptyOptimization(Optimization):

    def set_objective(self, optimization_data: OptimizationData = None) -> None:
        pass


class MeanVariance(Optimization):

    def __init__(self,
                 covariance: Optional[Covariance] = None,
                 mean_estimator: Optional[MeanEstimator] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.covariance = Covariance() if covariance is None else covariance
        # Reference bug fixed: optimization.py:165 assigns the class.
        self.mean_estimator = MeanEstimator() if mean_estimator is None else mean_estimator
        self.params.setdefault("risk_aversion", 1)

    def set_objective(self, optimization_data: OptimizationData) -> None:
        X = optimization_data["return_series"]
        ra = self.params["risk_aversion"]
        mu = self.mean_estimator.estimate(X=X) * (-1)
        fac = self.covariance.factor(X)
        if fac is not None:
            # Assemble P FROM the factor form Sigma == F'F + diag(d):
            # P = 2 ra Sigma = 2 (sqrt(ra) F)'(sqrt(ra) F) + diag(2 ra d)
            # — PSD by construction (no repair can desynchronize the
            # dense and factored views), and the solver's capacitance
            # paths get the structure.
            F, dvec = fac
            Pf = np.sqrt(float(ra)) * F
            Pdiag = 2.0 * float(ra) * dvec
            P = 2.0 * Pf.T @ Pf + np.diag(Pdiag)
            self.objective = Objective(q=to_numpy(mu), P=P,
                                       Pf=Pf, Pdiag=Pdiag)
        else:
            covmat = self.covariance.estimate(X=X) * ra * 2
            self.objective = Objective(q=to_numpy(mu), P=to_numpy(covmat))


class QEQW(Optimization):
    """Quasi-equal-weight: identity covariance (reference
    ``optimization.py:180-194``)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.covariance = Covariance(method="duv")

    def set_objective(self, optimization_data: OptimizationData) -> None:
        X = optimization_data["return_series"]
        covmat = self.covariance.estimate(X=X) * 2
        mu = np.zeros(X.shape[1])
        self.objective = Objective(P=to_numpy(covmat), q=mu)


class LeastSquares(Optimization):
    """Index tracking: min ||Xw - y||^2 (reference ``optimization.py:198-229``)."""

    def __init__(self, covariance: Optional[Covariance] = None, **kwargs):
        super().__init__(**kwargs)
        self.covariance = covariance

    def set_objective(self, optimization_data: OptimizationData) -> None:
        X = optimization_data["return_series"]
        y = optimization_data["bm_series"]
        if self.params.get("log_transform"):
            X = np.log(1 + X)
            y = np.log(1 + y)

        P = 2 * (X.T @ X)
        q = to_numpy(-2 * X.T @ y).reshape((-1,))
        constant = float(np.asarray(to_numpy(y.T @ y)).item())

        l2_penalty = self.params.get("l2_penalty")
        Pdiag = np.zeros(X.shape[1])
        if l2_penalty is not None and l2_penalty != 0:
            P = to_numpy(P) + 2 * l2_penalty * np.eye(X.shape[1])
            Pdiag = np.full(X.shape[1], 2.0 * l2_penalty)

        # Expose the Gram structure (P == 2 X'X + diag(2 l2)): the
        # polish factors the (T+m)-dim capacitance instead of n x n,
        # and the capacitance linear-solve mode needs it.
        self.objective = Objective(P=to_numpy(P), q=q, constant=constant,
                                   Pf=to_numpy(X), Pdiag=Pdiag)


class WeightedLeastSquares(Optimization):
    """Exponentially-weighted tracking with half-life ``tau`` (reference
    ``optimization.py:232-259``)."""

    def set_objective(self, optimization_data: OptimizationData) -> None:
        X = optimization_data["return_series"]
        y = optimization_data["bm_series"]
        if self.params.get("log_transform"):
            X = np.log(1 + X)
            y = np.log(1 + y)

        tau = self.params["tau"]
        lambda_val = np.exp(-np.log(2) / tau)
        i = np.arange(X.shape[0])
        wt_tmp = lambda_val ** i
        wt = np.flip(wt_tmp / np.sum(wt_tmp) * len(wt_tmp))

        Xv = to_numpy(X)
        yv = to_numpy(y).reshape(-1)
        Xw = Xv * wt[:, None]
        P = 2 * (Xv.T @ Xw)
        q = -2 * (Xw.T @ yv)
        constant = float(yv @ (wt * yv))
        # P == 2 (sqrt(wt) X)'(sqrt(wt) X): same factor form as plain
        # least squares, with the observation weights inside the factor.
        self.objective = Objective(P=P, q=q, constant=constant,
                                   Pf=np.sqrt(wt)[:, None] * Xv,
                                   Pdiag=np.zeros(Xv.shape[1]))


class LAD(Optimization):
    """Least absolute deviation tracking (reference
    ``optimization.py:263-352``).

    Two lowerings:

    * ``prox_form=True`` (default): variables ``[w, s]`` with equality
      rows ``s = X w`` and the objective ``sum_t |s_t - y_t|`` applied
      by the solver's native L1 prox — N+T variables, no nonnegative
      residual splitting. The eps target is dtype-aware
      (solver_params): f32 targets 1e-4, f64 keeps 1e-5.
    * ``prox_form=False``: the reference's epigraph LP — variables
      [w, e+, e-], ``X w + e+ - e- = y``, cost ``sum(e+ + e-)``. This
      remains what ``canonical_parts`` emits (it is the only form the
      external backends — IPM, C++, scipy, qpsolvers — can consume).
    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.params["use_level"] = self.params.get("use_level", True)
        self.params["use_log"] = self.params.get("use_log", True)
        # An LP in epigraph form run through first-order ADMM reaches
        # LP-grade accuracy via the polish but rarely meets a tight QP
        # eps in-loop, so MAX_ITER-with-good-polish is the expected
        # terminal state: accept it by default (the reference defines
        # allow_suboptimal but never consults it — optimization.py:47;
        # here it gates exactly this acceptance). Pass
        # allow_suboptimal=False for strict residual-based success;
        # only a value the caller never supplied is upgraded.
        # OptimizationParameter materializes the key iff the caller set
        # it, so key presence IS the explicitness record.
        if "allow_suboptimal" not in self.params:
            self.params["allow_suboptimal"] = True
        if "prox_form" not in self.params:
            self.params["prox_form"] = True

    def set_objective(self, optimization_data: OptimizationData) -> None:
        X = optimization_data["return_series"]
        y = optimization_data["bm_series"]
        if self.params.get("use_level"):
            X = (1 + X).cumprod()
            y = (1 + y).cumprod()
            if self.params.get("use_log"):
                X = np.log(X)
                y = np.log(y)
        self.objective = Objective(X=X, y=y)

    # solve() is inherited: the base solve_torch already runs
    # model_canonical (this class's lowering), applies the
    # allow_suboptimal MAX_ITER acceptance (defaulted True above), and
    # Nones the weights on failure — one copy of the acceptance logic.

    def _wants_prox(self) -> bool:
        """Prox lowering applies when requested AND the consumer can
        run it: the default device solver, no leverage lifting (lowered
        on the epigraph parts only), no external backend (they cannot
        consume the native L1 term)."""
        name = self.params.get("solver_name", DEFAULT_SOLVER)
        return bool(
            self.params.get("prox_form")
            and name in _DEFAULT_NAMES
            and "leverage" not in self.constraints.l1)

    # LP-appropriate solver defaults for the prox lowering, applied in
    # solver_params() only where the caller did not say otherwise, the
    # JAX package's settings carried over unchanged: first-order ADMM on
    # a pure LP needs a fixed, larger step size (residual-balancing
    # adaptive rho wanders), with restarted Halpern anchoring. They were
    # tuned on the prox form only, so they live in an overlay consulted
    # iff the prox form is the active lowering, never written into
    # self.params.
    _LP_PROX_DEFAULTS = {"adaptive_rho": False, "rho0": 60.0,
                         "halpern": True, "alpha": 1.8,
                         "check_interval": 200, "rho_l1_scale": 10.0,
                         "max_iter": 40000, "eps_abs": 1e-5,
                         "eps_rel": 1e-5}

    def solver_params(self, solve_dtype=None) -> SolverParams:
        if not self._wants_prox():
            return self.params.to_solver_params()
        fields = {k: v for k, v in self._LP_PROX_DEFAULTS.items()
                  if k not in self.params}
        # The overlay eps is dtype-aware: 1e-5 sits below the f32
        # residual floor, where an f32 solve would stall to max_iter.
        # The SOLVE dtype decides: the batch engine casts problems to
        # its own dtype argument and passes it here; the serial path
        # solves in the declared params dtype.
        # An explicit eps on EITHER key is a complete statement of the
        # caller's accuracy intent — the relaxation then applies to
        # neither (loosening the other key 10x behind an explicit
        # tightening would undermine the request: the stop test is
        # eps_abs + eps_rel * denom, so the looser key dominates).
        dt = solve_dtype if solve_dtype is not None else self.params.get("dtype")
        if (as_torch_dtype(dt) != torch.float64
                and "eps_abs" not in self.params
                and "eps_rel" not in self.params):
            fields["eps_abs"] = fields["eps_rel"] = 1e-4
        fields.update({k: self.params[k] for k in _SOLVER_KEYS
                       if k in self.params})
        return SolverParams(**fields)

    def canonical_parts(self) -> dict:
        return self._prox_parts() if self._wants_prox() else self._epigraph_parts()

    def _prox_parts(self) -> dict:
        """Native residual-prox lowering: variables [w, s], rows
        [constraint rows on w; s - X w = 0], and the objective
        sum_t |s_t - y_t| emitted as (l1_weight, l1_center) for the
        solver's native prox. P = 0 (pure LP); s is unboxed. Consumed
        by both the serial path (model_canonical -> _l1_pair) and the
        batched engine (batch.build_problems stacks the l1 arrays)."""
        X = to_numpy(self.objective["X"])
        y = to_numpy(self.objective["y"]).reshape(-1)
        N, T = X.shape[1], X.shape[0]
        dim = N + T

        Cw, lw, uw = self.constraints.interval_rows()
        resid = np.concatenate([X, -np.eye(T)], axis=1)
        C = np.concatenate([np.pad(Cw, [(0, 0), (0, T)]), resid], axis=0)
        l = np.concatenate([lw, np.zeros(T)])
        u = np.concatenate([uw, np.zeros(T)])
        lb_w, ub_w = self.constraints.bounds()
        lb = np.concatenate([lb_w, np.full(T, -np.inf)])
        ub = np.concatenate([ub_w, np.full(T, np.inf)])

        parts = lift._as_parts(np.zeros((dim, dim)), np.zeros(dim),
                               C, l, u, lb, ub)
        parts["constant"] = 0.0
        parts["l1_weight"] = np.concatenate([np.zeros(N), np.ones(T)])
        parts["l1_center"] = np.concatenate([np.zeros(N), y])
        return parts

    def _epigraph_parts(self) -> dict:
        X = to_numpy(self.objective["X"])
        y = to_numpy(self.objective["y"]).reshape(-1)
        N = X.shape[1]
        T = X.shape[0]
        dim = N + 2 * T

        # Constraint rows on w, widened with zero columns for the
        # residual-splitting aux block, then the T equality rows
        # X w + e+ - e- = y.
        Cw, lw, uw = self.constraints.interval_rows()
        resid = np.concatenate([X, np.eye(T), -np.eye(T)], axis=1)
        C = np.concatenate(
            [np.pad(Cw, [(0, 0), (0, 2 * T)]), resid], axis=0)
        l = np.concatenate([lw, y])
        u = np.concatenate([uw, y])

        lb_w, ub_w = self.constraints.bounds()
        lb = np.concatenate([lb_w, np.zeros(2 * T)])
        ub = np.concatenate([ub_w, np.full(2 * T, np.inf)])

        q = np.concatenate([np.zeros(N), np.ones(2 * T)])
        P = np.zeros((dim, dim))
        parts = lift._as_parts(P, q, C, l, u, lb, ub)

        # Corrected leverage branch (reference optimization.py:327-341 is buggy)
        if "leverage" in self.constraints.l1:
            parts = lift.lift_leverage_constraint(
                parts, self.constraints.l1["leverage"]["rhs"]
            )

        parts["constant"] = 0.0
        return parts

    def model_canonical(self, device=None) -> CanonicalQP:
        """Lower to a padded :class:`CanonicalQP` on ``device`` (default:
        the card)."""
        device = resolve_device(device)
        parts = self.canonical_parts()
        self.model = CanonicalQP.build(
            parts["P"], parts["q"], C=parts["C"], l=parts["l"], u=parts["u"],
            lb=parts["lb"], ub=parts["ub"],
            n_max=self.params.get("n_max"), m_max=self.params.get("m_max"),
            dtype=self.params.get("dtype"), device=device,
        )
        if "l1_weight" in parts:
            # l1 arrays must match the (possibly padded) model
            # dimension; padded variables carry zero weight and center.
            n_pad = self.model.n
            dt = to_numpy(self.model.q).dtype
            l1w = np.zeros(n_pad, dt)
            l1w[:len(parts["l1_weight"])] = parts["l1_weight"]
            l1c = np.zeros(n_pad, dt)
            l1c[:len(parts["l1_center"])] = parts["l1_center"]
            self._l1_pair = (l1w, l1c)
        else:
            self._l1_pair = None
        return self.model


class PercentilePortfolios(Optimization):
    """Score-ranked bucket portfolios, no QP (reference
    ``optimization.py:356-417``): long top bucket, short bottom bucket,
    equal weight within bucket."""

    def __init__(self,
                 field: Optional[str] = None,
                 estimator: Optional[MeanEstimator] = None,
                 n_percentiles: int = 5,
                 **kwargs):
        super().__init__(**kwargs)
        self.estimator = estimator
        self.params.update(solver_name="percentile",
                           n_percentiles=n_percentiles, field=field)

    def _score_series(self, optimization_data: OptimizationData) -> pd.Series:
        """Resolve the ranking signal: an estimator over returns, a
        named column of the scores frame, a weighted column blend, or
        the plain cross-column mean — in that precedence order."""
        field = self.params.get("field")
        if self.estimator is not None:
            if field is not None:
                raise ValueError(
                    "'field' and 'estimator' are mutually exclusive")
            return self.estimator.estimate(
                X=optimization_data["return_series"])
        frame = optimization_data["scores"]
        if isinstance(frame, pd.Series):
            # A plain per-asset score vector needs no cross-column
            # reduction; 'field' / 'score_weights' address columns of
            # a frame, so silently honoring a Series instead would
            # drop the caller's selection or blend.
            if field is not None or self.params.get("score_weights"):
                raise ValueError(
                    "'field'/'score_weights' were given but the scores "
                    "entry is a Series (one score per asset), not a "
                    "frame")
            return frame
        if field is not None:
            return frame[field]
        blend = self.params.get("score_weights")
        if blend is not None:
            cols = frame[list(blend.keys())]
            return (cols * pd.Series(blend)).sum(axis=1)
        return frame.mean(axis=1).squeeze()

    def set_objective(self, optimization_data: OptimizationData) -> None:
        scores = self._score_series(optimization_data)
        # Zero scores would create duplicate percentile thresholds; add
        # deterministic sub-numerical jitter (the reference draws from
        # the global np.random state at optimization.py:393 — a seeded
        # generator keeps runs reproducible).
        zeros = scores == 0
        if zeros.any():
            rng = np.random.default_rng(int(self.params.get("seed", 0)))
            scores = scores.copy()
            scores[zeros] = rng.normal(0.0, 1e-10, int(zeros.sum()))
        self.objective = Objective(scores=-scores)

    def solve(self, device=None) -> bool:
        """Bucket assignment on the host (no QP; ``device`` is
        accepted for the common signature)."""
        scores = self.objective["scores"]
        N = self.params["n_percentiles"]
        th = np.percentile(scores, np.linspace(0, 100, N + 1))

        # Vectorized bucket assignment: bucket b covers
        # th[b-1] < s <= th[b], with the lowest bucket closed below.
        vals = scores.to_numpy()
        buckets = np.minimum(
            np.searchsorted(th[1:], vals, side="left") + 1, N)

        w_dict = {}
        for b in range(1, N + 1):
            members = scores.index[buckets == b]
            w_dict[b] = pd.Series(1.0 / max(len(members), 1), index=members)

        # Negated scores: bucket 1 holds the highest raw scores (long),
        # bucket N the lowest (short); everything between stays flat.
        weights = pd.Series(0.0, index=scores.index)
        weights[w_dict[1].index] = 1.0 / max(len(w_dict[1]), 1)
        weights[w_dict[N].index] = -1.0 / max(len(w_dict[N]), 1)
        # Parity with the reference's results contract: the dict always
        # carries "status" (reference ``optimization.py:86-87``) so
        # Backtest.run's prev-weights bookkeeping fires, and an
        # "objective" value (the long-short raw-score spread between the
        # top and bottom buckets) so ``append_custom``'s default
        # "objective" key records something meaningful (reference
        # ``backtest.py:245-270``). ``scores`` here are negated, so the
        # raw-score spread is mean(-s | bucket 1) - mean(-s | bucket N).
        raw = -vals
        top, bot = raw[buckets == 1], raw[buckets == N]
        # Degenerate score distributions can leave a bucket empty (the
        # weights code above guards the same case); spread is 0 then,
        # not NaN.
        spread = (float(top.mean() - bot.mean())
                  if top.size and bot.size else 0.0)
        self.results = {"weights": weights.to_dict(), "w_dict": w_dict,
                        "status": True, "objective": spread}
        return True
