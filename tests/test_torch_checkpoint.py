"""The port's checkpoint/resume against the JAX package's
(tests/test_checkpoint.py and the crash-resume cases of
tests/test_resilience.py, mirrored), on the same inputs in the same
process.

Tolerances: f64 runs agree with the JAX package to rounding (1e-9 on
weights); f32 within the port's f32 weight tolerance (5e-5,
tests/test_torch_tracking.py). Within the port, a resumed run is held
bit-identical (``torch.equal``) to an uninterrupted one.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from porqua_tpu import checkpoint as jck
from porqua_tpu.batch import FIXED_UNIVERSE as JAX_FIXED
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.qp.solve import solve_qp_batch as jax_solve_qp_batch
from porqua_tpu.resilience import faults as jfaults

import porqua_tpu_torch as pt
from porqua_tpu_torch import builders as tb
from porqua_tpu_torch import checkpoint as tck
from porqua_tpu_torch.batch import FIXED_UNIVERSE, run_batch, solve_scan_l1
from porqua_tpu_torch.qp.canonical import stack_qps
from porqua_tpu_torch.resilience import faults

W_TOL = {np.float32: 5e-5, np.float64: 1e-9}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small problems gain nothing from intra-op threads, and the
    suite runs several workers on one machine: one thread per op avoids
    the contention that slowed these loops of small ops by about 10x
    (a LAD run: 2.3 s alone, 192 s beside busy workers, 21 s there on
    one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params_pair(**kw):
    return JaxParams(**kw), pt.SolverParams(**kw)


def random_parts(rng, n_problems=6, n=10, m=3):
    out = []
    for _ in range(n_problems):
        A = rng.standard_normal((n, n))
        P = A @ A.T + 0.5 * np.eye(n)
        q = rng.standard_normal(n)
        C = np.vstack([np.ones(n), rng.standard_normal((m - 1, n))])
        l = np.concatenate([[1.0], np.full(m - 1, -2.0)])
        u = np.concatenate([[1.0], np.full(m - 1, 2.0)])
        out.append((P, q, C, l, u, np.full(n, -3.0), np.full(n, 3.0)))
    return out


def batch_pair(rng, n_problems=6):
    """tests/test_checkpoint.py's random batch in both packages."""
    parts = random_parts(rng, n_problems)
    jq = jax_stack_qps([JaxQP.build(*p, dtype=np.float64) for p in parts])
    tq = stack_qps([pt.CanonicalQP.build(*p, dtype=torch.float64,
                                         device="cpu") for p in parts])
    return jq, tq


def assert_solutions_close(port, ref, dtype=np.float64):
    np.testing.assert_array_equal(np.asarray(port.status),
                                  np.asarray(ref.status))
    np.testing.assert_array_equal(np.asarray(port.iters),
                                  np.asarray(ref.iters))
    np.testing.assert_allclose(np.asarray(port.x), np.asarray(ref.x),
                               atol=W_TOL[dtype], rtol=0)


def assert_bit_identical(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


# ---------------------------------------------------------------------
# Serialization and the manager
# ---------------------------------------------------------------------

def test_roundtrip(rng, tmp_path):
    """Save and load give the same tensors; a file the JAX package
    wrote loads into the port, and the two solves agree."""
    jq, tq = batch_pair(rng)
    jp, tp = params_pair()
    sol = pt.solve_qp_batch(tq, tp, device="cpu")
    path = str(tmp_path / "sol.npz")
    tck.save_solution(path, sol)
    assert_bit_identical(sol, tck.load_solution(path, device="cpu"))
    jpath = str(tmp_path / "jax.npz")
    jck.save_solution(jpath, jax_solve_qp_batch(jq, jp))
    from_jax = tck.load_solution(jpath, device="cpu")
    assert sorted(np.load(jpath).files) == sorted(np.load(path).files)
    assert_solutions_close(sol, from_jax)


def test_chunk_accounting(rng, tmp_path):
    jq, tq = batch_pair(rng, n_problems=5)
    _, params = params_pair()
    sol = pt.solve_qp_batch(tq, params, device="cpu")
    mgr = tck.CheckpointManager.create(
        str(tmp_path / "run"), [f"d{i}" for i in range(5)], 2, params)
    jmgr = jck.CheckpointManager.create(
        str(tmp_path / "jrun"), [f"d{i}" for i in range(5)], 2,
        JaxParams())
    assert mgr.params_key == jmgr.params_key
    assert mgr.n_chunks == jmgr.n_chunks == 3
    assert mgr.completed_chunks() == 0
    one = pt.QPSolution(*(None if f is None else f[:2] for f in sol))
    mgr.save_chunk(0, one)
    assert mgr.completed_chunks() == 1
    # A gap stops the resume scan.
    mgr.save_chunk(2, pt.QPSolution(*(None if f is None else f[4:5]
                                      for f in sol)))
    assert mgr.completed_chunks() == 1
    assert_bit_identical(mgr.load_all(device="cpu"), one)


@pytest.mark.parametrize("change", ["params", "dtype", "l1"])
def test_mismatch_rejected(tmp_path, change):
    """A resume with other solver params, dtype or l1 configuration is
    a different run, in both packages (whose manifests are identical)."""
    first = dict(params=pt.SolverParams(), dtype=torch.float32, has_l1=False)
    second = dict(first)
    if change == "params":
        second["params"] = pt.SolverParams(eps_abs=1e-3)
    elif change == "dtype":
        second["dtype"] = torch.float64
    else:
        second["has_l1"] = True
    to_jax = lambda kw: dict(
        kw, params=JaxParams(**dataclasses.asdict(kw["params"])),
        dtype={torch.float32: jnp.float32,
               torch.float64: jnp.float64}[kw["dtype"]])
    d, jd = str(tmp_path / "run"), str(tmp_path / "jrun")
    tck.CheckpointManager.create(d, ["a", "b"], 1, **first)
    jck.CheckpointManager.create(jd, ["a", "b"], 1, **to_jax(first))
    with open(os.path.join(d, "manifest.json")) as f, \
            open(os.path.join(jd, "manifest.json")) as g:
        assert json.load(f) == json.load(g)
    with pytest.raises(ValueError, match="different run"):
        tck.CheckpointManager.create(d, ["a", "b"], 1, **second)
    with pytest.raises(ValueError, match="different run"):
        jck.CheckpointManager.create(jd, ["a", "b"], 1, **to_jax(second))


def test_timestamp_rebdates_serializable(tmp_path):
    dates = list(pd.bdate_range("2020-01-01", periods=3))
    mgr = tck.CheckpointManager.create(str(tmp_path / "run"), dates, 2,
                                       pt.SolverParams())
    jmgr = jck.CheckpointManager.create(str(tmp_path / "jrun"), dates, 2,
                                        JaxParams())
    assert all(isinstance(d, str) for d in mgr.rebdates)
    assert mgr.rebdates == jmgr.rebdates


# ---------------------------------------------------------------------
# run_batch_checkpointed
# ---------------------------------------------------------------------

def market_service(pkg, bld, optimization, *, with_bm=False, seed=7,
                   n_assets=6, n_days=400, every=50, k_dates=5,
                   box_upper=0.5):
    """tests/test_checkpoint.py's BacktestService wiring, in either
    package."""
    rng = np.random.default_rng(seed)
    dates = pd.bdate_range("2020-01-01", periods=n_days)
    X = pd.DataFrame(rng.standard_normal((n_days, n_assets)) * 0.01,
                     index=dates,
                     columns=[f"A{i}" for i in range(n_assets)])
    data = {"return_series": X}
    O = pkg.OptimizationItemBuilder
    opt_builders = {
        "returns": O(bibfn=bld.bibfn_return_series, width=100),
        "budget": O(bibfn=bld.bibfn_budget_constraint, budget=1),
        "box": O(bibfn=bld.bibfn_box_constraints, upper=box_upper),
    }
    if with_bm:
        data["bm_series"] = pd.DataFrame(
            {"bm": X.to_numpy() @ rng.dirichlet(np.ones(n_assets))},
            index=dates)
        opt_builders["bm"] = O(bibfn=bld.bibfn_bm_series, width=100,
                               align=True)
    rebdates = [str(d.date()) for d in dates[150::every][:k_dates]]
    return pkg.BacktestService(
        data=data,
        selection_item_builders={
            "data": pkg.SelectionItemBuilder(bibfn=bld.bibfn_selection_data)},
        optimization_item_builders=opt_builders,
        optimization=optimization,
        settings={"rebdates": rebdates, "quiet": True})


def weights(bt):
    return bt.strategy.get_weights_df().to_numpy(float)


def jax_service(opt):
    import porqua_tpu as rj
    from porqua_tpu import builders as jb

    return market_service(rj, jb, opt)


def test_resume_matches_fresh(tmp_path):
    """A run interrupted after chunk 0 finishes to the same weights as
    an uninterrupted one (bit for bit here: the resumed chunk is
    warm-started from the saved chunk's exact last point), and both
    match the JAX package's checkpointed run."""
    import porqua_tpu as rj

    jp, params = params_pair(max_iter=2000)
    fresh = tck.run_batch_checkpointed(
        market_service(pt, tb, pt.QEQW()), str(tmp_path / "fresh"),
        chunk_size=2, params=params, device="cpu")
    assert fresh.output["checkpoint"]["resumed_chunks"] == 0

    resume_dir = str(tmp_path / "resume")
    os.makedirs(resume_dir)
    for name in ("manifest.json", "chunk_0000.npz"):
        shutil.copy(os.path.join(str(tmp_path / "fresh"), name),
                    os.path.join(resume_dir, name))
    resumed = tck.run_batch_checkpointed(
        market_service(pt, tb, pt.QEQW()), resume_dir, chunk_size=2,
        params=params, device="cpu")
    assert resumed.output["checkpoint"]["resumed_chunks"] == 1
    np.testing.assert_array_equal(weights(fresh), weights(resumed))

    ref = jck.run_batch_checkpointed(jax_service(rj.QEQW()),
                                     str(tmp_path / "jax"), chunk_size=2,
                                     params=jp)
    for k in ("status", "iters"):
        np.testing.assert_array_equal(fresh.output["batch"][k],
                                      ref.output["batch"][k])
    np.testing.assert_allclose(weights(fresh), weights(ref),
                               atol=W_TOL[np.float32])


def test_checkpointed_default_params_match_run_batch(tmp_path):
    """With params=None the checkpointed runner derives the strategy's
    own solver configuration, as run_batch does (for LAD the LP-prox
    overlay: fixed rho, Halpern, the dtype's eps), and the JAX package
    derives the same. Against the JAX package in f64: in f32 this
    near-degenerate LP's warm-started chunks land on different
    iteration counts from a last-bit difference."""
    import porqua_tpu as rj
    from porqua_tpu import builders as jb

    def service(pkg, bld):
        return market_service(pkg, bld, pkg.LAD(), with_bm=True, seed=9,
                              every=60, k_dates=4, box_upper=1.0)

    rebdates = service(pt, tb).settings["rebdates"]
    ck = tck.run_batch_checkpointed(service(pt, tb), str(tmp_path / "ck"),
                                    chunk_size=2, device="cpu")
    ref = run_batch(service(pt, tb), device="cpu")
    assert int(np.max(ck.output["batch"]["iters"])) < 20000
    for date in rebdates:
        wc = pd.Series(ck.strategy.get_weights(date))
        wr = pd.Series(ref.strategy.get_weights(date))
        # Checkpointed chunks are warm-started, run_batch's dates cold:
        # two eps=1e-4 f32 LP solves from different starts land ~1e-4
        # apart (tests/test_checkpoint.py).
        np.testing.assert_allclose(wc[wr.index], wr, atol=1e-3, err_msg=date)

    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, jnp.float64)):
        assert dataclasses.asdict(
            service(pt, tb).optimization.solver_params(solve_dtype=dtype)
        ) == dataclasses.asdict(
            service(rj, jb).optimization.solver_params(solve_dtype=jdtype))
    ck64 = tck.run_batch_checkpointed(service(pt, tb), str(tmp_path / "c64"),
                                      chunk_size=2, dtype=torch.float64,
                                      device="cpu")
    jax64 = jck.run_batch_checkpointed(service(rj, jb),
                                       str(tmp_path / "j64"), chunk_size=2,
                                       dtype=jnp.float64)
    for k in ("status", "iters"):
        np.testing.assert_array_equal(ck64.output["batch"][k],
                                      jax64.output["batch"][k])
    np.testing.assert_allclose(weights(ck64), weights(jax64),
                               atol=W_TOL[np.float64])


def test_run_batch_checkpointed_crash_and_resume(tmp_path):
    """The backtest.chunk seam: a crash injected after chunk 1 leaves
    chunks 0 and 1 on disk; the rerun resumes there and ends
    bit-identical to an uninterrupted run."""
    _, params = params_pair(max_iter=2000)
    full = tck.run_batch_checkpointed(
        market_service(pt, tb, pt.QEQW()), str(tmp_path / "full"),
        chunk_size=2, params=params, device="cpu")
    crash = faults.Scenario("crash", (faults.FaultSpec.make(
        "backtest.chunk", "crash", start=1, count=1),))
    d = str(tmp_path / "crashed")
    with faults.active(crash) as inj:
        with pytest.raises(faults.InjectedCrash):
            tck.run_batch_checkpointed(
                market_service(pt, tb, pt.QEQW()), d, chunk_size=2,
                params=params, device="cpu")
        assert inj.log()[0]["idx"] == 1
    assert sorted(f for f in os.listdir(d) if f.startswith("chunk")) == [
        "chunk_0000.npz", "chunk_0001.npz"]
    resumed = tck.run_batch_checkpointed(
        market_service(pt, tb, pt.QEQW()), d, chunk_size=2, params=params,
        device="cpu")
    assert resumed.output["checkpoint"]["resumed_chunks"] == 2
    np.testing.assert_array_equal(weights(full), weights(resumed))
    for k, v in full.output["batch"].items():
        np.testing.assert_array_equal(v, resumed.output["batch"][k])


# ---------------------------------------------------------------------
# solve_scan_l1_checkpointed
# ---------------------------------------------------------------------

def scan_problem(n=6, n_dates=6, seed=11):
    """tests/test_resilience.py's scan problem in both packages."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_dates):
        X = rng.standard_normal((60, n)) * 0.01
        P = 2 * X.T @ X + 1e-6 * np.eye(n)
        q = -0.02 * rng.random(n)
        parts.append(dict(P=P, q=q, C=np.ones((1, n)), l=np.ones(1),
                          u=np.ones(1), lb=np.zeros(n), ub=np.ones(n)))
    jq = jax_stack_qps([JaxQP.build(dtype=jnp.float64, **p) for p in parts])
    tq = stack_qps([pt.CanonicalQP.build(dtype=torch.float64, device="cpu",
                                         **p) for p in parts])
    return jq, tq, np.full(n, 1.0 / n)


SCAN_PARAMS = dict(max_iter=2000, eps_abs=1e-7, eps_rel=1e-7)
CRASH_AT_1 = dict(seam="backtest.chunk", kind="crash", start=1, count=1)


@pytest.fixture(scope="module")
def jax_scan(tmp_path_factory):
    """The JAX package's checkpointed scan on :func:`scan_problem`
    (segments of 2), crashed after segment 1 and resumed: its fault log,
    manifest and resumed solution (one compile for the module)."""
    jq, _, w_init = scan_problem()
    d = str(tmp_path_factory.mktemp("jax_scan"))
    kw = dict(params=JaxParams(**SCAN_PARAMS), segment_size=2,
              universes=JAX_FIXED)
    with jfaults.active(jfaults.Scenario(
            "c", (jfaults.FaultSpec.make(**CRASH_AT_1),))) as inj:
        with pytest.raises(jfaults.InjectedCrash):
            jck.solve_scan_l1_checkpointed(jq, 6, w_init, 0.01, d, **kw)
        log = inj.log()
    sol, info = jck.solve_scan_l1_checkpointed(jq, 6, w_init, 0.01, d, **kw)
    assert info["resumed_segments"] == 2
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return {"log": log, "manifest": manifest, "sol": sol}


def test_scan_checkpoint_crash_resume_bit_parity(tmp_path, jax_scan):
    """A scan killed at a seeded boundary and resumed is bit-identical
    to an uninterrupted checkpointed run and to the uncut scan; all
    three match the JAX package's checkpointed scan."""
    _, params = params_pair(**SCAN_PARAMS)
    _, tq, w_init = scan_problem()
    tc, seg = 0.01, 2

    golden, info = tck.solve_scan_l1_checkpointed(
        tq, 6, w_init, tc, str(tmp_path / "golden"), params=params,
        segment_size=seg, universes=FIXED_UNIVERSE, device="cpu")
    assert info == {"directory": str(tmp_path / "golden"),
                    "resumed_segments": 0, "total_segments": 3}

    k = int(np.random.default_rng(0).integers(0, 2))
    crash = faults.Scenario("crash", (faults.FaultSpec.make(
        "backtest.chunk", "crash", start=k, count=1),))
    with faults.active(crash):
        with pytest.raises(faults.InjectedCrash):
            tck.solve_scan_l1_checkpointed(
                tq, 6, w_init, tc, str(tmp_path / "crashed"), params=params,
                segment_size=seg, universes=FIXED_UNIVERSE, device="cpu")
    resumed, info2 = tck.solve_scan_l1_checkpointed(
        tq, 6, w_init, tc, str(tmp_path / "crashed"), params=params,
        segment_size=seg, universes=FIXED_UNIVERSE, device="cpu")
    assert info2["resumed_segments"] == k + 1
    assert_bit_identical(golden, resumed)
    uncut = solve_scan_l1(tq, 6, w_init, tc, params,
                          universes=FIXED_UNIVERSE, device="cpu")
    assert_bit_identical(golden, uncut)
    assert_solutions_close(golden, jax_scan["sol"])


def test_scan_checkpoint_requires_carry_for_resume(tmp_path, jax_scan):
    """A crash between the chunk write and the carry write rolls that
    segment back; the run identity (and so the manifest) is the JAX
    package's."""
    _, params = params_pair(**SCAN_PARAMS)
    _, tq, w_init = scan_problem()
    d = str(tmp_path / "run")
    golden, _ = tck.solve_scan_l1_checkpointed(
        tq, 6, w_init, 0.01, d, params=params, segment_size=2,
        universes=FIXED_UNIVERSE, device="cpu")
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f) == jax_scan["manifest"]

    mgr = tck.CheckpointManager(d, [str(i) for i in range(6)], 2, "")
    assert mgr.completed_chunks(require_carry=True) == 3
    os.remove(mgr.carry_path(1))
    assert mgr.completed_chunks(require_carry=True) == 1
    assert mgr.completed_chunks() == 3

    resumed, info = tck.solve_scan_l1_checkpointed(
        tq, 6, w_init, 0.01, d, params=params, segment_size=2,
        universes=FIXED_UNIVERSE, device="cpu")
    assert info["resumed_segments"] == 1
    assert_bit_identical(golden, resumed)


def test_scan_checkpoint_rejects_other_holdings(tmp_path):
    """The initial holdings are part of the run identity."""
    _, params = params_pair(**SCAN_PARAMS)
    _, tq, w_init = scan_problem()
    d = str(tmp_path / "run")
    tck.solve_scan_l1_checkpointed(
        tq, 6, w_init, 0.01, d, params=params, segment_size=3,
        universes=FIXED_UNIVERSE, device="cpu")
    with pytest.raises(ValueError, match="different run"):
        tck.solve_scan_l1_checkpointed(
            tq, 6, np.eye(6)[0], 0.01, d, params=params, segment_size=3,
            universes=FIXED_UNIVERSE, device="cpu")


def test_jax_crash_seam_matches(tmp_path, jax_scan):
    """The same crash scenario fires at the same segment in both
    packages' checkpointed scans."""
    _, params = params_pair(**SCAN_PARAMS)
    _, tq, w_init = scan_problem()
    with faults.active(faults.Scenario(
            "c", (faults.FaultSpec.make(**CRASH_AT_1),))) as inj:
        with pytest.raises(faults.InjectedCrash):
            tck.solve_scan_l1_checkpointed(
                tq, 6, w_init, 0.01, str(tmp_path / "t"), params=params,
                segment_size=2, universes=FIXED_UNIVERSE, device="cpu")
        port_log = inj.log()
    assert port_log == jax_scan["log"] == [
        {"seam": "backtest.chunk", "kind": "crash", "hit": 1, "idx": 1}]
