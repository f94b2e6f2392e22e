"""The port's segment compaction (``porqua_tpu_torch/compaction.py``)
against its own fused solve and against the JAX package's driver, and
the committed JAX golden of ``chip_smoke.py``'s phase 8.

Inputs come from numpy seeds; both packages run float32 (tests/
conftest.py turns x64 on, so every JAX array here is built f32). The
port's compacted solve is held bit for bit to the port's fused solve
(on the CPU the segment's batched products give each lane the same
bits at every width from 2 up); against the JAX package status and
iterations are equal per lane and x within X_TOL.

Regenerate the golden (XLA-CPU; the 8,000-iteration PDHG arm alone
takes minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_compaction.py --write-golden
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.compaction import CompactingDriver as JaxDriver
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.qp.solve import solve_qp_batch as jax_solve_qp_batch
from porqua_tpu.tracking import build_tracking_qp as jax_build_tracking_qp
from porqua_tpu.tracking import synthetic_universe_np as jax_universe
from porqua_tpu.tracking import tracking_step as jax_tracking_step

import porqua_tpu_torch as pt
from porqua_tpu_torch import batch as tbatch
from porqua_tpu_torch.analysis import sanitize
from porqua_tpu_torch.compaction import CompactingDriver
from porqua_tpu_torch.qp.admm import Status, admm_init, admm_segment_step
from porqua_tpu_torch.qp.admm import admm_solve
from porqua_tpu_torch.qp.canonical import CanonicalQP, stack_qps
from porqua_tpu_torch.qp.ruiz import equilibrate
from porqua_tpu_torch.serve.bucketing import slot_ladder
from porqua_tpu_torch.synthetic import large_universe_np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                      "secondary_golden.npz")

# The reference's straggler family (tests/test_compaction.py): seven
# problems, lane 3 ill-conditioned (condition ~1e6) so it runs to
# max_iter at tight eps while the others converge.
N, M, B = 12, 3, 7
STRAGGLER = 3
PARAMS = pt.SolverParams(max_iter=1000, eps_abs=1e-7, eps_rel=1e-7,
                         polish=False, check_interval=25)
# Against the JAX package: eps 1e-7 sits at the float32 floor of this
# family, where the two packages' last-bit differences move lanes'
# stopping checks by hundreds of iterations (both solve every lane but
# the straggler). At eps 1e-5 every lane stops at the same check in
# both; x then agrees within X_TOL (measured 4.8e-7; 1.6 f32 ulps of
# the largest entry per iteration would be 1e-4 over 1000 iterations).
JAX_EPS = 1e-5
X_TOL = 5e-6

# chip_smoke.py's phase 8: bench.py's secondary configurations on the
# headline batch (seed 42, 252 dates x 500 assets, f32) at the A/B eps
# 1e-5, and the 5,000-asset north star.
FULL = dict(seed=42, n_dates=252, window=252, n_assets=500,
            sk_seed=7, sk_window=504, sk_assets=5000, sk_dim=256,
            sketch_seed=3, probes=8, f64=True)
HEADLINE = dict(max_iter=2000, eps_abs=1e-5, eps_rel=1e-5, polish=False,
                scaling_iters=2)
SECONDARY = {
    "compact_woodbury": dict(HEADLINE, linsolve="woodbury",
                             woodbury_refine=0, check_interval=35,
                             scaling_mode="factored"),
    "compact_trinv": dict(HEADLINE, linsolve="trinv"),
    "compact_napg": dict(HEADLINE, method="napg", max_iter=4000),
    "pdhg": dict(HEADLINE, method="pdhg", max_iter=8000),
}
COMPACTED = ("compact_woodbury", "compact_trinv", "compact_napg")
NORTHSTAR = dict(max_iter=2000, eps_abs=1e-3, eps_rel=1e-3, polish=False,
                 linsolve="woodbury", woodbury_refine=0, check_interval=35,
                 scaling_mode="factored")
NORTHSTAR_BUDGETS = {"admm": 2000, "pdhg": 8000, "napg": 4000}
REPORT_KEYS = ("segments", "lane_segments", "dense_lane_segments",
               "useful_lane_segments", "max_iter_lanes")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems, several test workers on one machine: one
    intra-op thread avoids the contention that slows loops of small
    ops by about 10x (tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ill_P(rng, n):
    d = np.logspace(-4, 2, n)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    P = Q @ np.diag(d) @ Q.T
    return (P + P.T) / 2 + 1e-6 * np.eye(n)


def straggler_parts():
    """The reference's seven problems as numpy parts."""
    rng = np.random.default_rng(0)
    parts = []
    for i in range(B):
        A = rng.standard_normal((2 * N, N))
        P = A.T @ A / (2 * N) + np.eye(N)
        if i == STRAGGLER:
            P = _ill_P(rng, N)
        parts.append(dict(
            P=P, q=rng.standard_normal(N),
            C=np.concatenate([np.ones((1, N)),
                              rng.standard_normal((M - 1, N))]),
            l=np.full(M, -1.0), u=np.ones(M), lb=np.zeros(N),
            ub=np.ones(N)))
    return parts


def port_batch(parts, dtype=torch.float32):
    return stack_qps([CanonicalQP.build(**p, dtype=dtype, device="cpu")
                      for p in parts])


def jax_batch(parts, dtype=np.float32):
    return jax_stack_qps([JaxQP.build(**p, dtype=dtype) for p in parts])


def to_jax(params):
    return JaxParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def batch():
    return port_batch(straggler_parts())


@pytest.fixture(scope="module")
def fused(batch):
    return pt.solve_qp_batch(batch, PARAMS, device="cpu")


@pytest.fixture(scope="module")
def driver():
    d = CompactingDriver(PARAMS, device="cpu")
    assert d.prewarm(B, N, M) == len(slot_ladder(B)) + 2
    return d


# ---------------------------------------------------------------------------
# the stepped API
# ---------------------------------------------------------------------------

def test_segment_step_matches_admm_solve(batch):
    """A host loop over admm_segment_step reproduces admm_solve bit for
    bit, lane by lane (the same segment program)."""
    pt.qp.canonical.HP.apply()
    scaled, scaling = equilibrate(batch, iters=PARAMS.scaling_iters)
    ref = admm_solve(scaled, scaling, PARAMS)
    for lane in (0, STRAGGLER):
        one = lambda t: t[lane:lane + 1]
        s1 = CanonicalQP(*(None if f is None else one(f) for f in scaled))
        sc1 = type(scaling)(*(one(f) for f in scaling))
        carry = admm_init(s1, PARAMS)
        segments = 0
        while (int(carry.state.status[0]) == Status.RUNNING
               and int(carry.state.iters[0]) < PARAMS.max_iter):
            carry = admm_segment_step(carry, s1, sc1, PARAMS)[0]
            segments += 1
        assert segments >= 2
        got = carry.state
        status = torch.where(got.status == Status.RUNNING, Status.MAX_ITER,
                             got.status)
        assert int(status[0]) == int(ref.status[lane])
        assert int(got.iters[0]) == int(ref.iters[lane])
        for name in ("x", "z", "w", "y", "mu", "rho_bar", "prim_res",
                     "dual_res"):
            a, b = getattr(got, name)[0], getattr(ref, name)[lane]
            # The B = 1 batch may sum in another order than B = 7.
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5,
                                       msg=name)


# ---------------------------------------------------------------------------
# the compacting driver
# ---------------------------------------------------------------------------

def test_compaction_bit_parity_and_lane_order(batch, fused, driver):
    """Converged lanes bit-identical to the fused solve, in the original
    lane order, with real savings and ladder-only dispatch widths."""
    sol, rep = driver.solve(batch)
    assert rep.compiles == 0, "a prewarmed solve must not compile"
    status = fused.status.numpy()
    assert status[STRAGGLER] == Status.MAX_ITER   # the tail exists
    np.testing.assert_array_equal(sol.status.numpy(), status)
    np.testing.assert_array_equal(sol.iters.numpy(), fused.iters.numpy())
    for name in ("x", "z", "y", "mu", "prim_res", "dual_res", "obj_val"):
        assert torch.equal(getattr(sol, name), getattr(fused, name)), name
    assert rep.lane_segments < rep.dense_lane_segments
    assert rep.savings_vs_dense >= 0.2
    assert set(rep.dispatch_sizes) <= set(slot_ladder(B))
    assert min(rep.dispatch_sizes) >= 2        # min_dispatch
    assert list(rep.dispatch_sizes) == sorted(rep.dispatch_sizes,
                                              reverse=True)
    assert rep.max_iter_lanes == int(np.sum(status == Status.MAX_ITER))
    # The report's accounting follows from the iteration counts.
    segs = np.maximum(-(-fused.iters.numpy() // PARAMS.check_interval), 1)
    assert rep.useful_lane_segments == int(segs.sum())
    assert rep.dense_lane_segments == B * int(segs.max())


def test_compaction_off_matches_dense_accounting(batch, fused, driver):
    """compact=False steps full width every boundary: executed equals
    batch x max segments, and every field equals the fused solve's."""
    sol, rep = driver.solve(batch, compact=False)
    assert rep.lane_segments == rep.dense_lane_segments
    assert set(rep.dispatch_sizes) == {B}
    for name in ("x", "status", "iters", "prim_res", "dual_res"):
        assert torch.equal(getattr(sol, name), getattr(fused, name)), name


def test_straggler_retires_at_segment_budget(batch, driver):
    """The documented semantics (the reference's own test of this
    fails, ROADMAP section C): with a per-lane budget the straggler
    retires MAX_ITER at exactly budget segments, equal to the fused
    solve run with max_iter = budget x check_interval, clean lanes
    untouched."""
    budget = 16
    sol, rep = driver.solve(batch, segment_budget=budget)
    assert rep.compiles == 0            # the budget is a runtime input
    status, iters = sol.status.numpy(), sol.iters.numpy()
    assert status[STRAGGLER] == Status.MAX_ITER
    assert iters[STRAGGLER] == budget * PARAMS.check_interval
    capped = dataclasses.replace(PARAMS,
                                 max_iter=budget * PARAMS.check_interval)
    ref = pt.solve_qp_batch(batch, capped, device="cpu")
    np.testing.assert_array_equal(ref.status.numpy(), status)
    np.testing.assert_array_equal(ref.iters.numpy(), iters)
    assert torch.equal(ref.x, sol.x)
    assert rep.max_iter_lanes == int(np.sum(status == Status.MAX_ITER))


def test_budget_retirement_gets_polish_fallback(batch):
    """A lane retired out of budget still gets the active-set polish and
    is re-graded SOLVED when the polished point meets tolerance."""
    loose = dataclasses.replace(PARAMS, eps_abs=1e-5, eps_rel=1e-5,
                                polish=True)
    d = CompactingDriver(loose, segment_budget=2, device="cpu")
    sol, rep = d.solve(batch)
    status = sol.status.numpy()
    assert torch.isfinite(sol.x).all()
    assert np.all((status == Status.SOLVED) | (status == Status.MAX_ITER))
    assert int(np.sum(status == Status.SOLVED)) >= B - 1
    assert np.all(sol.iters.numpy() <= 2 * PARAMS.check_interval)
    # The same budget on the fused path (max_iter = 50): same grades.
    ref = pt.solve_qp_batch(batch, dataclasses.replace(loose, max_iter=50),
                            device="cpu")
    np.testing.assert_array_equal(ref.status.numpy(), status)
    assert torch.equal(ref.x, sol.x)


def test_solve_batch_compacted_wrapper(batch, driver):
    problems = tbatch.BatchProblems(
        qp=batch, rebdates=[str(i) for i in range(B)],
        universes=[[f"a{j}" for j in range(N)]] * B, n_assets_max=N)
    sol, rep = tbatch.solve_batch_compacted(problems, PARAMS, driver=driver)
    assert rep.batch == B and rep.compiles == 0
    assert int(np.sum(sol.status.numpy() == Status.SOLVED)) == B - 1
    sol2, rep2 = pt.solve_batch_compacted(problems, PARAMS, device="cpu")
    assert torch.equal(sol2.x, sol.x) and rep2.compiles > 0


def test_driver_params_mismatch_raises(batch, driver):
    problems = tbatch.BatchProblems(
        qp=batch, rebdates=[str(i) for i in range(B)],
        universes=[[f"a{j}" for j in range(N)]] * B, n_assets_max=N)
    other = dataclasses.replace(PARAMS, eps_abs=1e-5)
    with pytest.raises(ValueError, match="different SolverParams"):
        tbatch.solve_batch_compacted(problems, other, driver=driver)


def test_prewarm_leaves_no_compile_and_sanitize_counts(batch, monkeypatch):
    """After prewarm a solve demands no compile; a new shape after the
    seal is a post-warmup compile demand, which raises under
    PORQUA_SANITIZE=1 (the transfer guard of a solve raises there too,
    naming item 23)."""
    sanitize.reset()
    d = CompactingDriver(PARAMS, device="cpu")
    n_warm = d.prewarm(B, N, M)
    assert sanitize.compile_count() == n_warm
    assert d.solve(batch)[1].compiles == 0
    assert sanitize.post_warmup_compiles() == 0
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    with pytest.raises(sanitize.SanitizerError, match="compile after warmup"):
        d._entry_step(d._shape_key(B, N, M, None, torch.float32, True,
                                   False), 4)
    with pytest.raises(NotImplementedError, match="item 23"):
        d.solve(batch)
    problems = tbatch.BatchProblems(
        qp=batch, rebdates=[str(i) for i in range(B)],
        universes=[[f"a{j}" for j in range(N)]] * B, n_assets_max=N)
    with pytest.raises(NotImplementedError, match="item 23"):
        tbatch.solve_batch_compacted(problems, PARAMS, driver=d)
    sanitize.reset()


def test_harvest_raises_naming_item_18(batch):
    with pytest.raises(NotImplementedError, match="item 18"):
        pt.compaction.solve_batch_compacted(batch, PARAMS, harvest=[],
                                            device="cpu")


def test_warm_start_and_l1_lanes_match_fused(batch, fused):
    """Warm starts and a native L1 term ride the group like every other
    lane field: the compacted solve equals the fused one."""
    rng = np.random.default_rng(5)
    x0 = fused.x * 0.5
    y0 = fused.y * 0.5
    l1w = torch.as_tensor(rng.uniform(0, 0.05, (B, N)), dtype=torch.float32)
    l1c = torch.as_tensor(rng.uniform(0, 0.2, (B, N)), dtype=torch.float32)
    prm = dataclasses.replace(PARAMS, eps_abs=1e-6, eps_rel=1e-6)
    ref = pt.solve_qp_batch(batch, prm, x0=x0, y0=y0, l1_weight=l1w,
                            l1_center=l1c, device="cpu")
    sol, rep = CompactingDriver(prm, device="cpu").solve(
        batch, x0=x0, y0=y0, l1_weight=l1w, l1_center=l1c)
    assert len(set(rep.dispatch_sizes)) >= 2
    for name in ("x", "status", "iters", "obj_val", "duality_gap"):
        assert torch.equal(getattr(sol, name), getattr(ref, name)), name


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """The JAX driver and fused solve on the same seven problems, per
    backend, at JAX_EPS (one prewarmed JAX driver per method)."""
    qp = jax_batch(straggler_parts())
    out = {}
    for method in ("admm", "pdhg", "napg"):
        prm = dataclasses.replace(PARAMS, eps_abs=JAX_EPS, eps_rel=JAX_EPS,
                                  method=method)
        d = JaxDriver(to_jax(prm))
        d.prewarm(B, N, M)
        sol, rep = d.solve(qp)
        out[method] = (prm, {k: np.asarray(getattr(sol, k))
                             for k in ("x", "status", "iters")}, rep)
    return out


@pytest.mark.parametrize("method", ["admm", "pdhg", "napg"])
def test_compacted_matches_jax_driver(method, batch, jax_runs):
    """Per lane: status and iterations equal the JAX driver's, x within
    X_TOL; the report's accounting and dispatch widths equal the JAX
    report's."""
    prm, ref, jrep = jax_runs[method]
    sol, rep = CompactingDriver(prm, device="cpu").solve(batch)
    np.testing.assert_array_equal(sol.status.numpy(), ref["status"])
    np.testing.assert_array_equal(sol.iters.numpy(), ref["iters"])
    np.testing.assert_allclose(sol.x.numpy(), ref["x"], atol=X_TOL, rtol=0)
    for key in REPORT_KEYS + ("dispatch_sizes",):
        assert getattr(rep, key) == getattr(jrep, key), key


# ---------------------------------------------------------------------------
# the golden of chip_smoke.py's phase 8
# ---------------------------------------------------------------------------

def jax_sketch_draws(rows, sketch_dim, seed, n, probes, dtype=jnp.float32):
    """The JAX package's draws for one seed, as its tracking path makes
    them (tracking._sketch_window, canonical.sketch_rows,
    sketch.gram_rel_err): (bucket, sign, probes) numpy arrays."""
    k_embed, k_probe = jax.random.split(jax.random.key(seed))
    kb, ks = jax.random.split(k_embed)
    return (np.asarray(jax.random.randint(kb, (rows,), 0, sketch_dim)),
            np.asarray(jax.random.rademacher(ks, (rows,), dtype)),
            np.asarray(jax.random.normal(k_probe, (probes, n), dtype)))


def in_sample_te(Xs, ys, w):
    resid = np.einsum("btn,bn->bt", Xs.astype(np.float64),
                      w.astype(np.float64)) - ys
    return np.sqrt(np.mean(resid ** 2, axis=1))


def write_golden(path=GOLDEN, sizes=FULL):
    """Run the JAX package (XLA-CPU, backend="xla") on phase 8's inputs
    and save what the card is held to: per config x, status, iters and
    per-date TE, the JAX driver's compaction accounting, an f64 run of
    each compacted config (its x stored as float32), and the 5k north
    star's arms (f32 and f64, the f64 weights stored as float32) with
    the sketch draws and probes. Never P."""
    s = sizes
    Xs, ys = jax_universe(s["seed"], s["n_dates"], s["window"],
                          s["n_assets"])
    out = {"meta": json.dumps(dict(s, platform=jax.default_backend()))}
    for dtype in ((np.float32, np.float64) if s["f64"] else (np.float32,)):
        qps = jax.jit(jax.vmap(jax_build_tracking_qp))(
            jnp.asarray(Xs, dtype), jnp.asarray(ys, dtype))
        for name, over in SECONDARY.items():
            if dtype == np.float64 and name not in COMPACTED:
                continue
            params = JaxParams(**dict(over, backend="xla"))
            t0 = time.perf_counter()
            sol = jax_solve_qp_batch(qps, params)
            x = np.asarray(sol.x)
            if dtype == np.float64:
                out[f"{name}/x_f64"] = x.astype(np.float32)
                out[f"{name}/iters_f64"] = np.asarray(sol.iters)
                print(f"{name} f64: {time.perf_counter() - t0:.1f} s",
                      flush=True)
                continue
            out[f"{name}/params"] = json.dumps(dataclasses.asdict(params))
            out[f"{name}/x"] = x
            out[f"{name}/status"] = np.asarray(sol.status)
            out[f"{name}/iters"] = np.asarray(sol.iters)
            out[f"{name}/tracking_error"] = in_sample_te(Xs, ys, x)
            msg = (f"{name}: {time.perf_counter() - t0:.1f} s, solved "
                   f"{int((out[f'{name}/status'] == 1).sum())}, iters "
                   f"{sorted(set(out[f'{name}/iters'].tolist()))}")
            if name in COMPACTED:
                d = JaxDriver(params)
                d.prewarm(*qps.q.shape, qps.l.shape[-1], dtype=dtype,
                          factor_rows=int(qps.Pf.shape[-2]))
                csol, rep = d.solve(qps)
                assert np.array_equal(np.asarray(csol.iters),
                                      out[f"{name}/iters"])
                for key in REPORT_KEYS:
                    out[f"{name}/report/{key}"] = np.asarray(
                        getattr(rep, key))
                out[f"{name}/report/dispatch_sizes"] = np.asarray(
                    rep.dispatch_sizes)
                msg += (f"; lane-segments {rep.dense_lane_segments} -> "
                        f"{rep.lane_segments}")
            print(msg, flush=True)

    # The 5,000-asset north star, bench.py's recipe and arms.
    X5, y5 = large_universe_np(s["sk_seed"], s["sk_window"], s["sk_assets"])
    bucket, sign, probes = jax_sketch_draws(
        s["sk_window"], s["sk_dim"], s["sketch_seed"], s["sk_assets"],
        s["probes"])
    out["northstar/bucket"] = bucket
    out["northstar/sign"] = sign
    out["northstar/probes"] = probes
    arms = {"dense": JaxParams(**NORTHSTAR)}
    for method, budget in NORTHSTAR_BUDGETS.items():
        arms[method] = JaxParams(**dict(
            NORTHSTAR, method=method, max_iter=budget,
            sketch_dim=s["sk_dim"], sketch_seed=s["sketch_seed"]))
    for arm, params in arms.items():
        out[f"northstar/{arm}/params"] = json.dumps(
            dataclasses.asdict(params))
        for dtype in ((np.float32, np.float64) if s["f64"]
                      else (np.float32,)):
            t0 = time.perf_counter()
            res = jax.jit(lambda A, b, p=params: jax_tracking_step(A, b, p))(
                jnp.asarray(X5, dtype), jnp.asarray(y5, dtype))
            sfx = "" if dtype == np.float32 else "_f64"
            for k in ("status", "iters", "tracking_error", "weights"):
                v = np.asarray(getattr(res, k))
                out[f"northstar/{arm}/{k}{sfx}"] = (
                    v.astype(np.float32) if k == "weights" else v)
            print(f"northstar {arm}{sfx}: {time.perf_counter() - t0:.1f} s, "
                  f"status {int(res.status[0])}, iters "
                  f"{int(res.iters[0])}, TE "
                  f"{float(res.tracking_error[0]):.6e}", flush=True)
    from porqua_tpu.qp.sketch import gram_rel_err as jax_gram_rel_err
    from porqua_tpu.tracking import _sketch_window as jax_sketch_window

    Xsk, _, k_probe = jax_sketch_window(jnp.asarray(X5[0]),
                                        jnp.asarray(y5[0]), s["sk_dim"],
                                        s["sketch_seed"])
    out["northstar/gram_rel_err"] = np.asarray(jax_gram_rel_err(
        jnp.asarray(X5[0]), Xsk, k_probe, s["probes"]))
    np.savez_compressed(path, **out)


def test_write_golden_mode_at_a_small_size(tmp_path, monkeypatch):
    """The --write-golden mode end to end at a tiny size, on one
    compacted config, the PDHG arm and one sketch-fed arm beside the
    dense one (each a JAX compile): every kind of array chip_smoke.py
    reads, with its shape and dtype."""
    here = sys.modules[__name__]
    monkeypatch.setattr(here, "SECONDARY", {
        k: SECONDARY[k] for k in ("compact_trinv", "pdhg")})
    monkeypatch.setattr(here, "COMPACTED", ("compact_trinv",))
    monkeypatch.setattr(here, "NORTHSTAR_BUDGETS", {"napg": 4000})
    path = str(tmp_path / "g.npz")
    write_golden(path, dict(FULL, n_dates=4, window=30, n_assets=12,
                            sk_window=40, sk_assets=60, sk_dim=16,
                            probes=4))
    g = np.load(path)
    meta = json.loads(str(g["meta"]))
    assert meta["n_dates"] == 4 and meta["sk_dim"] == 16
    for name in ("compact_trinv", "pdhg"):
        assert g[f"{name}/x"].shape == (4, 12)
        assert g[f"{name}/x"].dtype == np.float32
        assert g[f"{name}/tracking_error"].shape == (4,)
    assert g["compact_trinv/x_f64"].dtype == np.float32
    assert "pdhg/x_f64" not in g
    assert int(g["compact_trinv/report/lane_segments"]) == int(
        g["compact_trinv/report/dispatch_sizes"].sum())
    assert g["northstar/bucket"].shape == (40,)
    assert g["northstar/probes"].shape == (4, 60)
    for arm in ("dense", "napg"):
        assert g[f"northstar/{arm}/weights"].shape == (1, 60)
        assert g[f"northstar/{arm}/weights_f64"].dtype == np.float32
        assert g[f"northstar/{arm}/iters_f64"].dtype == np.int32
    assert float(g["northstar/gram_rel_err"]) > 0.0


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: python tests/test_torch_compaction.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    write_golden()
    print(f"wrote {GOLDEN} in {time.perf_counter() - t0:.1f} s")


def test_entry_points_need_a_device_without_cuda(monkeypatch, batch):
    """No silent CPU fallback: the driver, the one-shot wrapper and the
    sketch path raise without a card and without ``device``."""
    from porqua_tpu_torch.qp.sketch import tracking_step_sketched

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompactingDriver(PARAMS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.compaction.solve_batch_compacted(batch, PARAMS)
    Xs, ys = pt.synthetic_universe_np(1, 2, 16, 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tracking_step_sketched(Xs, ys, PARAMS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.tracking_step(Xs, ys, pt.SolverParams(sketch_dim=8))
