"""Whole-slice parity: the port's ``tracking_step`` against the JAX
reference on the same numpy inputs, and the committed JAX golden that
``chip_smoke.py`` holds the card against.

Regenerate the golden (XLA-CPU, about a minute):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_tracking.py --write-golden
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.qp.admm import SolverParams as JaxParams
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.solve import solve_qp as jax_solve_qp
from porqua_tpu.qp.solve import solve_qp_batch as jax_solve_qp_batch
from porqua_tpu.tracking import build_tracking_qp as jax_build_tracking_qp
from porqua_tpu.tracking import synthetic_universe_np as jax_universe
from porqua_tpu.tracking import tracking_step as jax_tracking_step

import porqua_tpu_torch as pt
from porqua_tpu_torch.qp.solve import solve_qp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                      "tracking_golden.npz")

# The headline batch: bench.py's synthetic universe, f32.
SEED, N_DATES, WINDOW, N_ASSETS = 42, 252, 252, 500
BASE = dict(max_iter=2000, eps_abs=1e-3, eps_rel=1e-3, polish=False,
            scaling_iters=2)
# Every form of the fused segment is on the main path: the headline
# config (factored kernel, refine 0), its refine-1 accuracy mode, the
# f32 default (auto -> trinv, the triangular kernel) and the
# explicit-inverse kernel.
CONFIGS = {
    "woodbury": dict(linsolve="woodbury", woodbury_refine=0,
                     check_interval=35, scaling_mode="factored"),
    "woodbury_refine1": dict(linsolve="woodbury", woodbury_refine=1,
                             check_interval=35, scaling_mode="factored"),
    "trinv": dict(linsolve="auto"),
    "inverse": dict(linsolve="inverse"),
}


def jax_params(name, **over):
    return JaxParams(**{**BASE, **CONFIGS[name], **over})


def run_jax(Xs, ys, params):
    out = jax.jit(lambda X, y: jax_tracking_step(X, y, params))(
        jnp.asarray(Xs), jnp.asarray(ys))
    return {k: np.asarray(getattr(out, k))
            for k in ("status", "iters", "tracking_error", "weights")}


def run_port(Xs, ys, params):
    out = pt.tracking_step(Xs, ys, pt.SolverParams(**dataclasses.asdict(params)),
                           device="cpu")
    return {k: getattr(out, k).numpy()
            for k in ("status", "iters", "tracking_error", "weights")}


def assert_same_lanes(a, b, w_atol, te_rtol):
    np.testing.assert_array_equal(a["status"], b["status"])
    np.testing.assert_array_equal(a["iters"], b["iters"])
    np.testing.assert_allclose(a["weights"], b["weights"], atol=w_atol, rtol=0)
    np.testing.assert_allclose(a["tracking_error"], b["tracking_error"],
                               rtol=te_rtol)


# Tolerances. f64: the two packages run the same arithmetic in another
# summation order, so they agree to rounding (seen: |dw| ~ 1e-14).
# f32: each product rounds at ~6e-8 relative and the ADMM iterations
# carry it; weights are <= 1, so 5e-5 absolute is about 400 ulps at the
# largest weight (seen: |dw| <= 2.3e-5) and TE, a mean over the window,
# is steadier (1e-4 relative).
TOL = {np.float32: (5e-5, 1e-4), np.float64: (1e-10, 1e-10)}


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
@pytest.mark.parametrize("name", ["woodbury", "trinv", "inverse"])
def test_tracking_step_matches_jax(name, eps):
    """Both packages with backend="pallas" (JAX in interpret mode, the
    port through the kernels' plain twins) at B=4, T=40, N=16 f32."""
    Xs, ys = jax_universe(seed=7, n_dates=4, window=40, n_assets=16)
    params = jax_params(name, backend="pallas", eps_abs=eps, eps_rel=eps)
    assert_same_lanes(run_jax(Xs, ys, params), run_port(Xs, ys, params),
                      *TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["woodbury", "trinv", "inverse"])
def test_lane_freeze_and_adaptive_rho(name, dtype):
    """Short segments (check_interval 3) at eps 1e-5: lanes finish
    after different numbers of segments and rho adapts between them, so
    per-lane iteration counts test the host loop's lane freeze."""
    Xs, ys = jax_universe(seed=42, n_dates=4, window=40, n_assets=16)
    Xs, ys = Xs.astype(dtype), ys.astype(dtype)
    params = jax_params(name, backend="pallas", check_interval=3,
                        eps_abs=1e-5, eps_rel=1e-5)
    ref = run_jax(Xs, ys, params)
    assert len(set(ref["iters"].tolist())) > 1, "lanes should differ"
    assert_same_lanes(ref, run_port(Xs, ys, params), *TOL[dtype])


@pytest.mark.parametrize("halpern", [False, True])
def test_plain_path_matches_jax_xla(halpern):
    """backend="xla" on both sides: the per-iteration plain segment
    (Cholesky solve at f64 auto), with and without restarted Halpern
    anchoring, against the XLA path."""
    Xs, ys = jax_universe(seed=3, n_dates=3, window=30, n_assets=12)
    params = JaxParams(**{**BASE, "eps_abs": 1e-7, "eps_rel": 1e-7},
                       backend="xla", check_interval=4, halpern=halpern)
    Xs, ys = Xs.astype(np.float64), ys.astype(np.float64)
    assert_same_lanes(run_jax(Xs, ys, params), run_port(Xs, ys, params),
                      *TOL[np.float64])


def test_infeasible_problem_same_status():
    """Contradictory rows (sum(x) == 1 and sum(x) <= -1) give the same
    infeasibility status in both packages."""
    n = 6
    args = (np.eye(n), np.zeros(n), np.vstack([np.ones(n), np.ones(n)]),
            np.array([1.0, -np.inf]), np.array([1.0, -1.0]),
            np.full(n, -5.0), np.full(n, 5.0))
    params = JaxParams(backend="pallas", max_iter=2000, polish=False)
    ref = jax_solve_qp(JaxQP.build(*args, dtype=np.float64), params)
    sol = solve_qp(pt.CanonicalQP.build(*args, dtype=torch.float64,
                                        device="cpu"),
                   pt.SolverParams(**dataclasses.asdict(params)),
                   device="cpu")
    assert int(ref.status) == int(sol.status) == pt.Status.PRIMAL_INFEASIBLE
    assert int(ref.iters) == int(sol.iters)


@pytest.mark.parametrize("name", ["woodbury", "trinv"])
def test_l1_term_matches_jax(name):
    """A native L1 (turnover-cost) term through the fused segment's
    prox, in f64: same status, iterations and solution."""
    Xs, ys = jax_universe(seed=5, n_dates=3, window=30, n_assets=10)
    Xs, ys = Xs.astype(np.float64), ys.astype(np.float64)
    params = jax_params(name, backend="pallas", eps_abs=1e-7, eps_rel=1e-7)
    l1w = np.full((3, 10), 2e-4)
    l1c = np.full((3, 10), 0.1)
    jqp = jax.vmap(jax_build_tracking_qp)(jnp.asarray(Xs), jnp.asarray(ys))
    ref = jax_solve_qp_batch(jqp, params, l1_weight=jnp.asarray(l1w),
                             l1_center=jnp.asarray(l1c))
    qp = pt.build_tracking_qp(torch.as_tensor(Xs), torch.as_tensor(ys))
    sol = pt.solve_qp_batch(qp, pt.SolverParams(**dataclasses.asdict(params)),
                            l1_weight=torch.as_tensor(l1w),
                            l1_center=torch.as_tensor(l1c), device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.status), sol.status.numpy())
    np.testing.assert_array_equal(np.asarray(ref.iters), sol.iters.numpy())
    for k in ("x", "obj_val", "duality_gap"):
        np.testing.assert_allclose(getattr(sol, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=1e-10)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_first_dates(name):
    """The committed golden's first 4 dates against a fresh JAX run
    (same XLA path) and a port CPU run (kernel twins) on dates 0..3 of
    the full 252-date draw (the draw depends on its shape, so slice)."""
    golden = np.load(GOLDEN)
    Xs, ys = jax_universe(SEED, N_DATES, WINDOW, N_ASSETS)
    Xs, ys = Xs[:4], ys[:4]
    params = JaxParams(**json.loads(str(golden[f"{name}/params"])))
    want = {k: golden[f"{name}/{k}"][:4]
            for k in ("status", "iters", "tracking_error", "weights")}
    assert_same_lanes(want, run_jax(Xs, ys, params), 1e-6, 1e-6)
    port = run_port(Xs, ys, dataclasses.replace(params, backend="pallas"))
    assert_same_lanes(want, port, *TOL[np.float32])


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """No silent CPU fallback: with no card and no device, raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Xs, ys = jax_universe(seed=1, n_dates=2, window=10, n_assets=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.tracking_step(Xs, ys, pt.SolverParams(polish=False))
    qp = pt.build_tracking_qp(torch.as_tensor(Xs), torch.as_tensor(ys))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.solve_qp_batch(qp, pt.SolverParams(polish=False))


@pytest.mark.parametrize("over, exc", [
    (dict(backend="pallas", halpern=True), NotImplementedError),
    (dict(scaling_mode="jacobi"), ValueError),
    (dict(method="lbfgs"), ValueError),
    (dict(method="PDHG"), ValueError),
    (dict(backend="tpu"), ValueError),
])
def test_unported_options_raise(over, exc):
    Xs, ys = jax_universe(seed=1, n_dates=2, window=10, n_assets=4)
    params = pt.SolverParams(**{"polish": False, **over})
    with pytest.raises(exc):
        pt.tracking_step(Xs, ys, params, device="cpu")


def test_ridge_and_window_gradients_through_the_build_match_jax():
    """``build_tracking_qp`` takes a 0-dim tensor ridge that carries a
    gradient. The out-of-sample tracking error's gradient w.r.t. the
    ridge, the benchmark y and the window X, through the port's build
    and ``solve_qp_diff`` (f64, eps 1e-10; 16 days under 24 assets, so
    the factored adjoint runs), equals ``jax.grad`` through the JAX
    package's build to 1e-6 relative. ``Pf = X`` and ``Pdiag`` are
    aliases of P with zero cotangent in both packages: the gradient
    reaches ridge, y and X through P and q only."""
    from porqua_tpu.qp.diff import solve_qp_diff as jax_solve_qp_diff

    Xs, ys = jax_universe(5, 1, 21, 24)
    X, y = Xs[0, :16].astype(np.float64), ys[0, :16].astype(np.float64)
    Xo, yo = Xs[0, 16:].astype(np.float64), ys[0, 16:].astype(np.float64)
    opts = dict(max_iter=20000, eps_abs=1e-10, eps_rel=1e-10)

    def te(w, lib):
        r = lib.matmul(lib.asarray(Xo) if lib is jnp else torch.as_tensor(Xo),
                       w) - (jnp.asarray(yo) if lib is jnp
                             else torch.as_tensor(yo))
        return lib.sqrt(lib.mean(r * r))

    g_jax = jax.grad(lambda r, yv, Xv: te(jax_solve_qp_diff(
        jax_build_tracking_qp(Xv, yv, ridge=r), JaxParams(**opts)), jnp),
        argnums=(0, 1, 2))(jnp.asarray(1e-3), jnp.asarray(y), jnp.asarray(X))
    ridge = torch.tensor(1e-3, dtype=torch.float64, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    Xt = torch.tensor(X, requires_grad=True)
    qp = pt.build_tracking_qp(Xt, yt, ridge=ridge)
    assert qp.Pdiag.shape == (24,)
    w = pt.qp.diff.solve_qp_diff(qp, pt.SolverParams(**opts), device="cpu")
    te(w, torch).backward()
    for got, want in zip((ridge.grad, yt.grad, Xt.grad), g_jax):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_port_imports_no_jax():
    """The port imports every module, solves, runs a batched backtest,
    a chained scan, a crashed and resumed checkpointed scan, a solve
    service round trip in both batching modes, a routed, retried and
    observed service (every production option, ``/metrics`` up) and
    the workload library's selftest, one CostRecord harvested from a
    compiled entry with its roofline profile and report, a compacted
    solve, PDHG and NAPG solves with rings, a sketch-fed tracking_step,
    a backward
    through solve_qp_diff and solve_qp_l1_diff, compare_solvers' ipm-f64
    and native-cpp-admm rows, an Optimization with solver_name="ipm",
    one LTR selection, one LSTM training step and forward and one
    ordinal fit (ML models) with JAX, flax, optax, sklearn, msgpack
    and h5py made unimportable, and pulls in no
    module of the JAX package; the native core's build and load (every
    file opened, library loaded and process started after the solves
    begin) never touch a path under porqua_tpu/."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for blocked in ('jax', 'flax', 'optax', 'sklearn', 'msgpack', "
        "'h5py'):\n"
        "    sys.modules[blocked] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import porqua_tpu_torch as pt\n"
        "for m in pkgutil.walk_packages(pt.__path__, 'porqua_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "Xs, ys = pt.synthetic_universe_np(1, 2, 20, 8)\n"
        "r = pt.tracking_step(Xs, ys, pt.SolverParams(polish=False, "
        "backend='pallas'), device='cpu')\n"
        "assert r.status.tolist() == [1, 1], r.status\n"
        "from porqua_tpu_torch import builders as tb\n"
        "X, _ = pt.synthetic_usa_np(n_days=300, n_assets=12)\n"
        "bm = X.mean(axis=1).to_frame('bm')\n"
        "O = pt.OptimizationItemBuilder\n"
        "bs = pt.BacktestService(data={'return_series': X, 'bm_series': bm},"
        " selection_item_builders={'d': pt.SelectionItemBuilder("
        "bibfn=tb.bibfn_selection_data)}, optimization_item_builders={"
        "'r': O(bibfn=tb.bibfn_return_series, width=60), 'b': O("
        "bibfn=tb.bibfn_bm_series, width=60, align=True), 'u': O("
        "bibfn=tb.bibfn_budget_constraint), 'x': O("
        "bibfn=tb.bibfn_box_constraints)}, optimization=pt.LeastSquares(),"
        " settings={'rebdates': ['2018-06-01', '2018-09-03'], 'quiet': True})\n"
        "bt = pt.run_batch(bs, device='cpu')\n"
        "assert bt.output['batch']['status'].tolist() == [1, 1]\n"
        "import tempfile\n"
        "from porqua_tpu_torch.resilience import faults\n"
        "import torch\n"
        "qp = pt.build_tracking_qp(*(torch.as_tensor(a) for a in "
        "pt.synthetic_universe_np(2, 3, 20, 8)))\n"
        "prm = pt.SolverParams(polish=False, backend='pallas')\n"
        "s = pt.solve_scan_l1(qp, 8, [1 / 8] * 8, 0.01, prm, "
        "universes=pt.FIXED_UNIVERSE, device='cpu')\n"
        "crash = faults.Scenario('c', (faults.FaultSpec.make("
        "'backtest.chunk', 'crash'),))\n"
        "d = tempfile.mkdtemp()\n"
        "with faults.active(crash):\n"
        "    try:\n"
        "        pt.solve_scan_l1_checkpointed(qp, 8, [1 / 8] * 8, 0.01, d, "
        "prm, segment_size=2, universes=pt.FIXED_UNIVERSE, device='cpu')\n"
        "    except faults.InjectedCrash:\n"
        "        pass\n"
        "c, info = pt.solve_scan_l1_checkpointed(qp, 8, [1 / 8] * 8, 0.01, "
        "d, prm, segment_size=2, universes=pt.FIXED_UNIVERSE, device='cpu')\n"
        "assert info['resumed_segments'] == 1 and bool((c.x == s.x).all())\n"
        "from porqua_tpu_torch.serve import SolveService\n"
        "from porqua_tpu_torch.serve.loadgen import (SERVE_PARAMS, "
        "build_tracking_requests)\n"
        "reqs = build_tracking_requests(4, n_assets=8, window=20)\n"
        "for cont in (False, True):\n"
        "    with SolveService(SERVE_PARAMS, max_batch=4, device='cpu', "
        "continuous=cont) as svc:\n"
        "        assert svc.prewarm(reqs[0]) == 3\n"
        "        rs = [svc.result(t, timeout=60) for t in "
        "[svc.submit(q) for q in reqs]]\n"
        "    assert [r.status for r in rs] == [1] * 4, rs\n"
        "    assert svc.snapshot()['completed'] == 4\n"
        "from porqua_tpu_torch import obs\n"
        "from porqua_tpu_torch.resilience import RetryPolicy\n"
        "from porqua_tpu_torch.serve import SolverRouter, workloads\n"
        "router = SolverRouter(SERVE_PARAMS, shadow_rate=1.0)\n"
        "router.set_table({('32x8', SERVE_PARAMS.eps_abs): 'pdhg'})\n"
        "sink = obs.HarvestSink(None)\n"
        "with SolveService(SERVE_PARAMS, max_batch=4, device='cpu', "
        "router=router, retry=RetryPolicy(), obs=obs.Observability(), "
        "harvest=sink, slo=obs.SLOEngine(), flight=obs.FlightRecorder(), "
        "anomaly=obs.AnomalyDetector({}), calibrator=obs.Calibrator(), "
        "tenant_slos=obs.TenantSLOSet()) as svc:\n"
        "    svc.prewarm(reqs[0])\n"
        "    rs = [svc.solve(q, timeout=60, tenant='a') for q in reqs]\n"
        "    assert svc.start_http() > 0 and svc.vitals()['threads'] > 0\n"
        "assert all(r.found for r in rs) and svc.snapshot()['routed_pdhg'] "
        "== 4\n"
        "assert {r['source'] for r in sink.buffered()} == {'serve', "
        "'serve.shadow'}\n"
        "workloads.selftest()\n"
        "from porqua_tpu_torch.obs import profile, report\n"
        "cache = pt.serve.ExecutableCache(SERVE_PARAMS)\n"
        "b = pt.serve.BucketLadder().select(reqs[0])\n"
        "cache.get(b, 2, torch.float32, 'cpu')\n"
        "rec = cache.cost_record_for(b, 2, torch.float32)\n"
        "assert rec['flops'] > 0 and rec['cost_source'] == 'torch', rec\n"
        "prof = profile.qp_solve_profile(b.n, b.m, 25.0, 0.01, "
        "params=SERVE_PARAMS, batch=2, cost=rec)\n"
        "assert prof['cost_source'] == 'torch' and prof['flops_xla'] == "
        "rec['flops'], prof\n"
        "text = report.render_report(costs=[rec], harvest=[{'bucket': "
        "'32x8', 'profile': prof}])\n"
        "assert 'measured-vs-model (per bucket' in text, text\n"
        "from porqua_tpu_torch.compaction import CompactingDriver\n"
        "p5 = pt.SolverParams(polish=False, eps_abs=1e-5, eps_rel=1e-5, "
        "backend='pallas')\n"
        "fused = pt.solve_qp_batch(qp, p5, device='cpu')\n"
        "sol, rep = CompactingDriver(p5, device='cpu').solve(qp)\n"
        "assert rep.compiles > 0 and bool((sol.x == fused.x).all())\n"
        "for meth in ('pdhg', 'napg'):\n"
        "    r = pt.solve_qp_batch(qp, pt.SolverParams(method=meth, "
        "polish=False, ring_size=4), device='cpu')\n"
        "    assert r.status.tolist() == [1] * 3 and r.ring_prim.shape == "
        "(3, 4), r.status\n"
        "r = pt.tracking_step(Xs, ys, pt.SolverParams(polish=False, "
        "sketch_dim=8, sketch_seed=3), device='cpu')\n"
        "assert r.status.tolist() == [1, 1], r.status\n"
        "import numpy as np, pandas as pd, types\n"
        "from porqua_tpu_torch import models\n"
        "import chip_smoke\n"
        "mk = pd.bdate_range('2019-01-01', periods=420)\n"
        "Rm = pd.DataFrame(np.random.default_rng(0).standard_normal((420, 6))"
        " * 0.01, index=mk, columns=[f'a{i}' for i in range(6)])\n"
        "sel = models.ltr_selection_scores(types.SimpleNamespace(data={"
        "'return_series': Rm, 'features': chip_smoke.usa_features(Rm)}), "
        "'2020-08-03', top_k=2, epochs=3, device='cpu')\n"
        "assert int(sel['binary'].sum()) == 2, sel\n"
        "Xw, yw = models.make_windows(Rm.to_numpy(np.float32), 10)\n"
        "lm = models.train_lstm(Xw[:40], yw[:40], hidden=4, epochs=1, "
        "batch_size=40, device='cpu')\n"
        "assert lm.loss_history.shape == (1,) and lm.predict(Xw[:2]).shape "
        "== (2, 6)\n"
        "fit = models.OrdinalRegression(device='cpu').fit(Xw[:60, -1], "
        "models.decile_rank_labels(pd.DataFrame(yw[:60]), n_bins=3).to_numpy()"
        "[:, 0])\n"
        "assert np.isfinite(fit.nll_), fit\n"
        "import os\n"
        "jax_pkg = os.path.join(os.getcwd(), 'porqua_tpu') + os.sep\n"
        "touched = []\n"
        "def audit(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen', 'subprocess.Popen'):\n"
        "        touched.append(repr(args))\n"
        "sys.addaudithook(audit)\n"
        "X1, y1 = (torch.as_tensor(a[0], dtype=torch.float64) for a in "
        "pt.synthetic_universe_np(4, 1, 20, 8))\n"
        "tilt = torch.arange(8.0, dtype=torch.float64)\n"
        "r = torch.tensor(1e-3, dtype=torch.float64, requires_grad=True)\n"
        "x = pt.solve_qp_diff(pt.build_tracking_qp(X1, y1, ridge=r), "
        "pt.SolverParams(), device='cpu')\n"
        "(x * tilt).sum().backward()\n"
        "assert bool(torch.isfinite(r.grad)), r.grad\n"
        "lam = torch.full((8,), 1e-3, dtype=torch.float64, "
        "requires_grad=True)\n"
        "x = pt.solve_qp_l1_diff(pt.build_tracking_qp(X1, y1), lam, "
        "torch.full((8,), 1 / 8, dtype=torch.float64), pt.SolverParams(), "
        "device='cpu')\n"
        "(x * tilt).sum().backward()\n"
        "assert bool(torch.isfinite(lam.grad).all()), lam.grad\n"
        "df = pt.compare_solvers(pt.build_tracking_qp(X1, y1), solvers=["
        "'ipm-f64', 'native-cpp-admm'], device='cpu')\n"
        "assert df['solution_found'].all() and 'error' not in df, df\n"
        "import pandas as pd\n"
        "cols = [f'a{i}' for i in range(8)]\n"
        "opt = pt.LeastSquares(solver_name='ipm')\n"
        "opt.constraints = pt.Constraints(selection=cols)\n"
        "opt.constraints.add_budget()\n"
        "opt.constraints.add_box('LongOnly')\n"
        "opt.set_objective(pt.OptimizationData(align=False, return_series="
        "pd.DataFrame(X1.numpy(), columns=cols), bm_series=pd.Series("
        "y1.numpy())))\n"
        "assert opt.solve() is True\n"
        "assert any('libporqua_qp' in t for t in touched), touched\n"
        "assert not [t for t in touched if jax_pkg in t], touched\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m.split('.')[0] in ('jax', 'jaxlib', 'porqua_tpu', 'flax', "
        "'optax', 'sklearn', 'msgpack', 'h5py'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_top_level_and_obs_names_match_jax():
    """Every name of the JAX package's ``__all__`` and of its
    ``obs.__all__`` imports from the port's (ROADMAP section C: the top
    level lacked ``SolveService`` and ``Observability``)."""
    import porqua_tpu
    import porqua_tpu.obs

    import porqua_tpu_torch.obs

    for ref, port in ((porqua_tpu, pt), (porqua_tpu.obs, porqua_tpu_torch.obs)):
        missing = [n for n in ref.__all__ if not hasattr(port, n)]
        assert not missing, (port.__name__, missing)
        assert set(ref.__all__) <= set(port.__all__)
    from porqua_tpu_torch import Observability, SolveService  # noqa: F401


@pytest.mark.parametrize("refine", [0, 1])
def test_factored_spd_solve_operator_matches_jax(refine):
    """``K^-1 r`` for ``K = diag(Dv) + V'V`` through Woodbury, both sides
    in f32 on the same inputs (V 12 x 40, a batch of 3 right-hand
    sides): within 1e-5 of each other relative to the solution's scale
    (the capacitance Cholesky and triangular inverse round differently
    in each package) and within the same of the f64 solve; refine 1
    lands nearer the f64 solve than refine 0."""
    from porqua_tpu.qp.admm import factored_spd_solve_operator as jax_op

    from porqua_tpu_torch.qp.admm import factored_spd_solve_operator

    rng = np.random.default_rng(11)
    V = rng.standard_normal((12, 40)).astype(np.float32)
    Dv = (0.05 + rng.random(40)).astype(np.float32)
    R = rng.standard_normal((3, 40)).astype(np.float32)
    K = np.diag(Dv.astype(np.float64)) + V.T.astype(np.float64) @ V
    exact = np.linalg.solve(K, R.T.astype(np.float64)).T
    scale = np.abs(exact).max()
    jop = jax_op(jnp.asarray(Dv), jnp.asarray(V), refine_steps=refine)
    ref = np.stack([np.asarray(jop(jnp.asarray(r))) for r in R])
    op = factored_spd_solve_operator(torch.from_numpy(Dv),
                                     torch.from_numpy(V), refine_steps=refine)
    mine = op(torch.from_numpy(R)).numpy()
    assert mine.dtype == ref.dtype == np.float32
    assert np.abs(mine - ref).max() <= 1e-5 * scale
    assert np.abs(mine - exact).max() <= 1e-5 * scale
    if refine:
        base = factored_spd_solve_operator(
            torch.from_numpy(Dv), torch.from_numpy(V), refine_steps=0)(
            torch.from_numpy(R)).numpy()
        assert np.abs(mine - exact).max() <= np.abs(base - exact).max()
    # Batched over a leading axis as the port's kernels use it.
    opb = factored_spd_solve_operator(torch.from_numpy(Dv)[None].repeat(2, 1),
                                      torch.from_numpy(V)[None].repeat(2, 1, 1),
                                      refine_steps=refine)
    got = opb(torch.from_numpy(R[:2])).numpy()
    assert np.abs(got - mine[:2]).max() <= 1e-6 * scale


def write_golden(path=GOLDEN):
    """Run the JAX reference (backend="xla", XLA-CPU) on the full
    headline batch for every config and save what the card is held to."""
    Xs, ys = jax_universe(SEED, N_DATES, WINDOW, N_ASSETS)
    out = {"meta": json.dumps(dict(seed=SEED, n_dates=N_DATES,
                                   window=WINDOW, n_assets=N_ASSETS,
                                   platform=jax.default_backend()))}
    for name in CONFIGS:
        params = jax_params(name, backend="xla")
        res = run_jax(Xs, ys, params)
        out[f"{name}/params"] = json.dumps(dataclasses.asdict(params))
        for k, v in res.items():
            out[f"{name}/{k}"] = v
        print(name, "solved", int((res["status"] == 1).sum()),
              "iters", sorted(set(res["iters"].tolist())),
              "median TE", float(np.median(res["tracking_error"])))
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: python tests/test_torch_tracking.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_golden()
