"""The port's cross-solver harness (``porqua_tpu_torch/compare.py``),
its f64 interior-point oracle (``qp/ipm.py``), its native C++ core
(``native/``) and ``Optimization``'s named solvers, against the JAX
package's on the same seeded problems (tests/conftest.py turns JAX's
x64 on, so the JAX harness has its f64 device row).

Tolerances: the IPM is the same numpy code, so bit for bit; the native
core is the same C++ built by the same compiler, so its solution within
1e-12; the harness's objective and residual columns within 1e-9 of the
JAX package's on the ipm-f64, native-cpp-admm and scipy-slsqp rows
(relative to max(1, |value|), the convention of the JAX package's own
MSCI comparison), the device rows within DEVICE_TOL.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from porqua_tpu.compare import available_backends as jax_available_backends
from porqua_tpu.compare import compare_solvers as jax_compare_solvers
from porqua_tpu.constraints import Constraints as JaxConstraints
from porqua_tpu.native import solve_qp_native as jax_solve_qp_native
from porqua_tpu.optimization import LeastSquares as JaxLeastSquares
from porqua_tpu.optimization_data import OptimizationData as JaxData
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.ipm import dual_for_canonical as jax_dual_for_canonical
from porqua_tpu.qp.ipm import solve_ipm as jax_solve_ipm

import porqua_tpu_torch as pt
from porqua_tpu_torch import native
from porqua_tpu_torch.compare import _numpy_parts, solution_metrics
from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.qp.ipm import dual_for_canonical, solve_ipm

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("objective_value", "primal_residual", "dual_residual",
           "duality_gap", "max_residual_Ab", "max_residual_Gh")
HOST_ROWS = ("ipm-f64", "native-cpp-admm", "scipy-slsqp")
HOST_TOL = 1e-9
# The device rows are each package's own ADMM in float32 (eps floored at
# 3e-6) and float64 (eps 1e-8): the objective within DEVICE_TOL of the
# JAX package's row, the residuals below the row's tolerance.
DEVICE_TOL = {"device-admm-f32": 1e-6, "device-admm-f64": 1e-9}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tracking_parts(seed=17, T=200, n=8, upper=0.25):
    """The JAX harness test's problem: an index-tracking QP with the
    budget and a LongOnly box capped at ``upper``."""
    rng = np.random.default_rng(seed)
    X = 0.01 * rng.standard_normal((T, n))
    y = X @ rng.dirichlet(np.ones(n)) + 0.001 * rng.standard_normal(T)
    return dict(P=2.0 * X.T @ X, q=-2.0 * X.T @ y, C=np.ones((1, n)),
                l=np.ones(1), u=np.ones(1), lb=np.zeros(n),
                ub=np.full(n, upper), constant=float(y @ y)), X, y


def rows_parts():
    """Interval rows (both sides finite, one-sided, an equality) and a
    box with an infinite side: every branch of the IPM's standard form."""
    rng = np.random.default_rng(4)
    n = 6
    A = rng.standard_normal((12, n))
    C = np.vstack([np.ones(n), rng.standard_normal((3, n))])
    return dict(P=A.T @ A / 12 + 0.1 * np.eye(n), q=rng.standard_normal(n),
                C=C, l=np.array([1.0, -0.5, -np.inf, -0.2]),
                u=np.array([1.0, 0.5, 0.3, np.inf]),
                lb=np.r_[np.zeros(n - 1), -np.inf], ub=np.full(n, 0.6),
                constant=0.0)


def port_qp(parts, dtype=torch.float64):
    return CanonicalQP.build(parts["P"], parts["q"], parts["C"], parts["l"],
                             parts["u"], parts["lb"], parts["ub"],
                             constant=parts["constant"], dtype=dtype,
                             device="cpu")


def jax_qp(parts):
    return JaxQP.build(parts["P"], parts["q"], parts["C"], parts["l"],
                       parts["u"], parts["lb"], parts["ub"],
                       constant=parts["constant"], dtype=jnp.float64)


def close(a, b, tol):
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


@pytest.mark.parametrize("make", [lambda: tracking_parts()[0], rows_parts],
                         ids=["tracking", "rows"])
def test_ipm_equals_jax_bit_for_bit(make):
    parts = make()
    got, want = solve_ipm(parts), jax_solve_ipm(parts)
    assert got.found and want.found and got.iters == want.iters
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(dual_for_canonical(parts, got),
                    jax_dual_for_canonical(parts, want)):
        np.testing.assert_array_equal(a, b)


def test_native_builds_into_the_ports_build_dir():
    """Built from the port's own source into build/porqua_tpu_torch/,
    named by a hash: never the JAX package's source or library."""
    path = native.build_library()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(_ROOT, "build",
                                                 "porqua_tpu_torch")
    assert os.path.basename(path).startswith("libporqua_qp-")
    assert str(native.SOURCE) == os.path.join(
        _ROOT, "porqua_tpu_torch", "native", "qp_solver.cpp")


@pytest.mark.parametrize("case", ["tracking", "rows", "box_only",
                                  "max_iter"])
def test_native_matches_jax_native(case):
    """The port's library against ``porqua_tpu.native.solve_qp_native``:
    status and iterations equal, x, y, mu and the objective within
    1e-12, on a tracking QP, interval rows, a box-only problem and an
    infeasible one that runs to max_iter."""
    n = 4
    if case == "tracking":
        p = tracking_parts()[0]
        args = (p["P"], p["q"], p["C"], p["l"], p["u"], p["lb"], p["ub"])
        kw = {}
    elif case == "rows":
        p = rows_parts()
        args = (p["P"], p["q"], p["C"], p["l"], p["u"], p["lb"], p["ub"])
        kw = {}
    elif case == "box_only":
        args = (np.eye(8), -2.0 * np.ones(8))
        kw = dict(lb=np.zeros(8), ub=np.full(8, 0.5))
    else:
        C = np.vstack([np.eye(n), np.eye(n)])
        args = (np.eye(n), np.zeros(n), C,
                np.concatenate([np.ones(n), np.full(n, -np.inf)]),
                np.concatenate([np.full(n, np.inf), np.zeros(n)]))
        kw = dict(max_iter=500)
    got = native.solve_qp_native(*args, **kw)
    want = jax_solve_qp_native(*args, **kw)
    assert got.status == want.status and got.iters == want.iters
    assert got.status == (2 if case == "max_iter" else 1)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert close(got.obj_val, want.obj_val, 1e-12)


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    """Two processes build the library into one empty directory at the
    same time: each compiles to its own temporary name and renames it
    into place, so both load a whole library and solve, and no
    temporary file is left."""
    code = (
        "import sys, pathlib\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from porqua_tpu_torch import native\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "s = native.solve_qp_native(np.eye(3), -np.ones(3), lb=np.zeros(3), "
        "ub=np.full(3, 0.5))\n"
        "print(s.status, *s.x)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        status, *x = out.split()
        assert status == "1" and np.allclose(np.array(x, float), 0.5,
                                             atol=1e-6), out
    assert outs[0][0] == outs[1][0]
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 1 and files[0].endswith(".so"), files


@pytest.fixture(scope="module")
def tables():
    parts, _, _ = tracking_parts()
    port = pt.compare_solvers(port_qp(parts), device="cpu")
    jax_df = jax_compare_solvers(jax_qp(parts))
    return parts, port, jax_df


def test_compare_solvers_rows_and_columns_match_jax(tables):
    """The same rows as the JAX harness (no qpsolvers here), every one
    found with no error; the host rows' objective and residual columns
    within HOST_TOL of the JAX package's, the device rows' objective
    within DEVICE_TOL; the f64 row always present."""
    parts, port, jax_df = tables
    assert list(port.index) == list(jax_df.index)
    assert "device-admm-f64" in pt.available_backends(device="cpu")
    assert set(jax_available_backends()) == set(
        pt.available_backends(device="cpu"))
    assert "error" not in port.columns
    assert port["solution_found"].all(), port
    for row in HOST_ROWS:
        for col in METRICS:
            a, b = port.loc[row, col], jax_df.loc[row, col]
            assert (np.isnan(a) and np.isnan(b)) or close(a, b, HOST_TOL), (
                row, col, a, b)
    for row, tol in DEVICE_TOL.items():
        assert close(port.loc[row, "objective_value"],
                     jax_df.loc[row, "objective_value"], tol), row
        assert port.loc[row, "primal_residual"] < 1e-5
    objs = port["objective_value"]
    assert objs.max() - objs.min() < 1e-5


def test_compare_solvers_subset_unknown_and_metrics(tables):
    """A subset keeps its rows; an unknown name raises KeyError;
    solution_metrics flags an infeasible point as the JAX package's
    does."""
    parts, _, _ = tables
    qp = port_qp(parts)
    df = pt.compare_solvers(qp, solvers=["ipm-f64"], device="cpu")
    assert list(df.index) == ["ipm-f64"]
    with pytest.raises(KeyError):
        pt.compare_solvers(qp, solvers=["osqp-gpu"], device="cpu")
    assert _numpy_parts(qp).keys() == parts.keys()
    n = len(parts["q"])
    bad = solution_metrics(parts, np.full(n, 2.0 / n))
    assert bad["primal_residual"] > 0.5 and bad["max_residual_Ab"] > 0.5
    assert solution_metrics(parts, np.full(n, 1.0 / n))[
        "primal_residual"] < 1e-12


def least_squares(pkg, X, y, **kw):
    cols = [f"A{i}" for i in range(X.shape[1])]
    Xd = __import__("pandas").DataFrame(X, columns=cols)
    yd = __import__("pandas").Series(y)
    if pkg is pt:
        opt = pt.LeastSquares(**kw)
        opt.constraints = pt.Constraints(selection=cols)
        data = pt.OptimizationData(align=False, return_series=Xd,
                                   bm_series=yd)
    else:
        opt = JaxLeastSquares(**kw)
        opt.constraints = JaxConstraints(selection=cols)
        data = JaxData(align=False, return_series=Xd, bm_series=yd)
    opt.constraints.add_budget()
    opt.constraints.add_box("LongOnly", upper=0.25)
    opt.set_objective(data)
    return opt


@pytest.mark.parametrize("name, tol", [("ipm", 1e-12), ("native", 1e-12),
                                       ("scipy", 1e-9), ("admm-f64", 1e-7)])
def test_optimization_named_solver_matches_jax(name, tol):
    """Optimization with a named solver goes through the harness and
    publishes the JAX package's weights (within ``tol``)."""
    _, X, y = tracking_parts()
    port = least_squares(pt, X, y, solver_name=name)
    ref = least_squares(sys.modules["porqua_tpu.optimization"], X, y,
                        solver_name=name)
    assert port.solve(device="cpu") is True
    assert ref.solve() is True
    got = np.array(list(port.results["weights"].values()), float)
    want = np.array(list(ref.results["weights"].values()), float)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert port.solution.found and port.solution.iters == -1


def test_optimization_refusals_as_jax():
    """A native-L1 lowering is refused by a named backend, and a
    backend absent here (qpsolvers' cvxopt) raises ValueError, in both
    packages."""
    _, X, y = tracking_parts()
    for pkg in (pt, sys.modules["porqua_tpu.optimization"]):
        opt = least_squares(pkg, X, y, solver_name="cvxopt")
        with pytest.raises(ValueError, match="not available"):
            opt.solve(**({"device": "cpu"} if pkg is pt else {}))
        opt = least_squares(pkg, X, y, solver_name="ipm", l1_native=True,
                            transaction_cost=0.01)
        opt.params["x0"] = {f"A{i}": 1 / 8 for i in range(8)}
        with pytest.raises(ValueError, match="native-L1"):
            opt.solve(**({"device": "cpu"} if pkg is pt else {}))
