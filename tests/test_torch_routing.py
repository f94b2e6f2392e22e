"""The port's solver router (``porqua_tpu_torch/serve/routing.py``) and
the routed service against the JAX package's on the same inputs in the
same process, and the committed JAX golden of ``chip_smoke.py``'s
phase 10 (``routed_serve_phase``).

Host logic is held exact: the table ``seed_from_aggregate`` builds, the
decisions, ``force``, the table versions and the shadow choices (which
loser, which dispatch deferred) for the same seed and dispatch
sequence. Solver answers follow the serving tests' rules
(``tests/test_torch_serve.py``): status and iterations equal, x within
X_ATOL.

Regenerate the golden (XLA-CPU; the north-star stream on PDHG and NAPG,
the JAX package's routed run whose aggregate seeds the table, and the
blend's pools on their routed backends):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_routing.py --write-golden
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

from porqua_tpu.obs.harvest import HarvestSink as JaxSink
from porqua_tpu.obs.harvest import aggregate as jax_aggregate
from porqua_tpu.obs.harvest import solve_record as jax_solve_record
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps
from porqua_tpu.qp.solve import solve_qp_batch as jax_solve_qp_batch
from porqua_tpu.serve import BucketLadder as JaxLadder
from porqua_tpu.serve import SolveService as JaxService
from porqua_tpu.serve import workloads as jax_workloads
from porqua_tpu.serve.bucketing import Bucket as JaxBucket
from porqua_tpu.serve.loadgen import (
    build_tracking_requests as jax_tracking_requests)
from porqua_tpu.serve.routing import SolverRouter as JaxRouter

import porqua_tpu_torch as pt
from porqua_tpu_torch.obs import HarvestSink, aggregate, solve_record
from porqua_tpu_torch.serve import Bucket, BucketLadder, SolveService
from porqua_tpu_torch.serve.routing import METHODS, SolverRouter
from tests.test_torch_serve import (GOLDEN_BATCH, NORTHSTAR, TIMEOUT,
                                    X_ATOL, grid_requests, jax_params,
                                    port_params)
from tests.test_torch_serve import SMALL_GOLDEN
from tests.test_torch_serve import write_golden as write_serve_golden

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                      "route_golden.npz")

#: The golden's sizes. ``stream``: the serving golden's north-star
#: stream (serve_golden.npz), answered on the two losing backends in
#: batches of ``batch``. ``agg_requests``: how many of its requests the
#: JAX package's routed run (one per dispatch, a shadow on every one)
#: serves to build the aggregate that seeds the table. ``blend``: the
#: three-tenant blend (README "Multi-tenant serving & workload
#: library"'s tracking / LAD / turnover tenants): tracking at the north
#: star's 500 assets (bucket 512 x 8, ADMM); LAD at 128 assets (2n = 256
#: variables, 257 rows: bucket 256 x 512, the largest at which a dense
#: kernel form fits, so every ladder can be prewarmed; PDHG); turnover
#: at 15 assets (30 variables, 31 rows: bucket 32 x 32, NAPG). NAPG
#: projects the rows one after another, each by a 32-step bisection, so
#: its cost per iteration grows with the bucket's rows: one 8-lane
#: dispatch of the pool takes 10.8 s at 15 assets and 80.2 s at 24 (the
#: 128-row bucket) on an H100 80GB HBM3 at 700 W
#: (scripts/torch_blend_probe.py), and 15 assets is the largest turnover
#: size whose bucket has 32 rows.
FULL = dict(
    stream=dict(n_requests=NORTHSTAR["n_requests"],
                n_assets=NORTHSTAR["n_assets"], batch=GOLDEN_BATCH),
    agg_requests=8,
    blend=dict(
        spec=("alpha:tracking:diurnal:rate=40,n_assets=500,window=252,"
              "pool=16;beta:lad:heavy_tailed:rate=15,n_assets=128,"
              "window=252,pool=8;gamma:turnover:bursty:rate=8,"
              "burst_factor=10,n_assets=15,window=252,pool=8"),
        duration_s=0.4, seed=0,
        routes={"alpha": "admm", "beta": "pdhg", "gamma": "napg"}))
#: ``SMALL``: the rehearsal's sizes. At 20 assets PDHG and NAPG stop at
#: different iterations on each of the stream's requests (XLA-CPU), so
#: the shadow rule's control, the other loser's golden, fails whichever
#: lanes the first dispatch takes.
SMALL = dict(
    stream=dict(n_requests=8, n_assets=20, batch=8),
    agg_requests=2,
    blend=dict(
        spec=("alpha:tracking:diurnal:rate=40,n_assets=40,window=64,"
              "pool=3;beta:lad:heavy_tailed:rate=15,n_assets=12,"
              "window=64,pool=2;gamma:turnover:steady:rate=5,"
              "n_assets=3,window=64,pool=2"),
        duration_s=0.2, seed=0,
        routes={"alpha": "admm", "beta": "pdhg", "gamma": "napg"}))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_batch(padded, dtype=np.float32):
    stack = jax_stack_qps(padded, stack_fn=np.stack)
    return JaxQP(*(None if a is None else jnp.asarray(np.asarray(a, dtype))
                   for a in stack))


def jax_answers(reqs, params, batch, n_keep=None):
    """Status, iterations and x (the first ``n_keep`` entries, else the
    natural size) of ``reqs`` solved by the JAX package in batches of
    ``batch``, bucket-padded, f32."""
    padded = [JaxLadder().pad(q)[1] for q in reqs]
    out = {"status": [], "iters": [], "x": []}
    for lo in range(0, len(padded), batch):
        sol = jax_solve_qp_batch(_jax_batch(padded[lo:lo + batch]), params)
        out["status"].append(np.asarray(sol.status))
        out["iters"].append(np.asarray(sol.iters))
        out["x"].append(np.asarray(sol.x)[:, :n_keep or reqs[0].n])
    return {k: np.concatenate(v) for k, v in out.items()}


def jax_routed_records(reqs, params, shadow_seed=0):
    """The JAX package's routed service over ``reqs``, one request per
    dispatch, a shadow solve on a losing backend after every dispatch:
    its harvest records (the routed and the shadow ones)."""
    router = JaxRouter(params, shadow_rate=1.0, shadow_seed=shadow_seed)
    sink = JaxSink(None)
    svc = JaxService(params, max_batch=1, max_wait_ms=1.0,
                     warm_start=False, router=router, harvest=sink)
    svc.start()
    try:
        for q in reqs:
            svc.solve(q, timeout=600)
    finally:
        svc.stop()
    return sink.buffered()


def write_golden(path=GOLDEN, sizes=FULL):
    """The phase-10 golden on XLA-CPU (f32, backend "xla"):

    * ``stream/<method>/{status,iters,x}`` for ``method`` in pdhg, napg:
      the serving golden's north-star stream (rebuilt from its seed, not
      stored), bucket-padded, solved by the JAX package in batches of
      ``batch`` with the serving params and that method — the answer a
      shadow re-solve on that loser must give;
    * ``aggregate``: the JAX package's ``aggregate`` of its routed run
      over the first ``agg_requests`` requests, and ``seeded``: the
      table its router seeds from it (with the version);
    * ``blend/<tenant>/{status,iters,x}``: each tenant's problem pool
      (``workloads.build_problems``) solved on the backend the tenant is
      routed to, in one batch, x at the natural size."""
    st, bl = sizes["stream"], sizes["blend"]
    params = jax_params("dense")
    reqs = jax_tracking_requests(st["n_requests"], st["n_assets"],
                                 NORTHSTAR["window"], NORTHSTAR["seed"])
    out = {}
    for method in ("pdhg", "napg"):
        t0 = time.perf_counter()
        ans = jax_answers(reqs, dataclasses.replace(params, method=method),
                          st["batch"], st["n_assets"])
        for k, v in ans.items():
            out[f"stream/{method}/{k}"] = v
        print(f"stream {method}: solved {int((ans['status'] == 1).sum())}/"
              f"{len(reqs)}, iters {sorted(set(ans['iters'].tolist()))}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    records = jax_routed_records(reqs[:sizes["agg_requests"]], params)
    agg = jax_aggregate(records)
    router = JaxRouter(params)
    router.seed_from_aggregate(agg)
    seeded = router.snapshot()
    print(f"routed run: {len(records)} records "
          f"({sorted({r['solver'] for r in records})}); seeded table "
          f"{seeded['table']} (version {seeded['table_version']}), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    buckets = {}
    for spec in jax_workloads.parse_tenant_specs(bl["spec"]):
        method = bl["routes"][spec.name]
        pool = jax_workloads.build_problems(spec, seed=bl["seed"])
        b = JaxLadder().select(pool[0])
        buckets[spec.name] = f"{b.n}x{b.m}"
        t0 = time.perf_counter()
        ans = jax_answers(pool, dataclasses.replace(params, method=method),
                          len(pool))
        for k, v in ans.items():
            out[f"blend/{spec.name}/{k}"] = v
        print(f"blend {spec.name} ({spec.problem}, {buckets[spec.name]}) on "
              f"{method}: solved {int((ans['status'] == 1).sum())}/"
              f"{len(pool)}, iters {ans['iters'].tolist()}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["aggregate"] = json.dumps(agg)
    out["meta"] = json.dumps(dict(
        stream=dict(st, window=NORTHSTAR["window"], seed=NORTHSTAR["seed"]),
        agg_requests=sizes["agg_requests"], blend=bl,
        blend_buckets=buckets, params=dataclasses.asdict(params),
        seeded=seeded["table"], seeded_version=seeded["table_version"],
        platform=jax.default_backend()))
    np.savez_compressed(path, **out)


# ---------------------------------------------------------------------
# Host logic against the JAX package's
# ---------------------------------------------------------------------

def synthetic_records(mods, rng):
    """Records of three backends over two buckets and two eps, with
    and without latency, built by each package's constructor."""
    solve_record_, Params = mods
    out = []
    for i in range(60):
        method = METHODS[i % 3]
        out.append(solve_record_(
            "serve.shadow" if i % 4 else "serve", 24, 1,
            1 if (i % 11) else 2, int(rng.integers(1, 12)) * 25, 1e-4,
            1e-4, -0.1, params=Params(method=method,
                                      eps_abs=[1e-3, 1e-5][i % 2]),
            bucket=["32x8", "512x8"][(i // 2) % 2],
            solve_s=None if i % 5 == 0 else 1e-3 * (1 + (i * 7) % 9),
            tenant=["a", "b"][i % 2]))
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_seed_from_aggregate_matches_jax(seed):
    jrec = synthetic_records((jax_solve_record, jax_params_cls()),
                             np.random.default_rng(seed))
    trec = synthetic_records((solve_record, pt.SolverParams),
                             np.random.default_rng(seed))
    agg = aggregate(trec)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "t"}
                        for r in rs]
    assert strip(trec) == strip(jrec)
    assert agg == jax_aggregate(jrec)
    jr, tr = JaxRouter(jax_params("dense")), SolverRouter(port_params(
        "dense"))
    assert tr.seed_from_aggregate(agg) == jr.seed_from_aggregate(agg)
    assert tr.snapshot() == jr.snapshot()
    # Seeding again from the same evidence is a new version.
    tr.seed_from_aggregate(agg)
    jr.seed_from_aggregate(agg)
    assert tr.table_version == jr.table_version == 2


def jax_params_cls():
    from porqua_tpu.qp.solve import SolverParams

    return SolverParams


def test_decisions_force_and_versions_match_jax():
    jr, tr = JaxRouter(jax_params("dense")), SolverRouter(port_params(
        "dense"))
    jb, tb = JaxBucket(32, 8), Bucket(32, 8)
    jb2, tb2 = JaxBucket(64, 8, 16), Bucket(64, 8, 16)
    got, want = [], []
    for router, b, b2, out in ((tr, tb, tb2, got), (jr, jb, jb2, want)):
        out.append([router.route(b), router.route(b2)])
        out.append(router.set_table({("32x8", 1e-3): "pdhg",
                                     ("64x8", 1e-3): "napg"}))
        out.append([router.decide(b)[0], router.decide(b2)[0]])
        router.force("admm")
        out.append([router.route(b), router.route(b2)])
        router.force(None)
        out.append(router.route(b))
        out.append(router.set_table({}))
        out.append(router.route(b))
        with pytest.raises(ValueError, match="unknown method"):
            router.force("simplex")
        with pytest.raises(ValueError, match="unknown method"):
            router.set_table({("32x8", 1e-3): "simplex"})
        out.append(router.snapshot())
    assert got == want
    assert got[2] == ["pdhg", "napg"] and tr.decide(tb)[1] is tr.caches["admm"]


class _Req:
    def __init__(self, i):
        self.n_orig, self.m_orig = 24, 1
        self.tenant = None
        self.trace_id = None


def shadow_sequence(router, make_solution, n_dispatch=24):
    """Run ``maybe_shadow`` over a dispatch sequence with stub caches
    (each loser answers ``make_solution(method)``): the losers chosen,
    the deferrals and the emitted records."""
    for m, cache in router.caches.items():
        cache.get = (lambda *a, m=m, **k:
                     (lambda qp, x0, y0: make_solution(m)))
    sink = []

    class Sink:
        def emit(self, rec):
            sink.append(rec)

    live = [_Req(i) for i in range(2)]
    primary = {"status": np.array([1, 1]), "iters": np.array([50, 75]),
               "obj": np.array([0.1, 0.2]), "solve_s": 0.01}
    ran = []
    for d in range(n_dispatch):
        ran.append(router.maybe_shadow(
            Bucket(32, 8), 2, None, None, None, None, None,
            ["admm", "pdhg"][d % 2], primary, live, Sink()))
        if d % 8 == 7:
            router.reset_shadow_budget()
    return ran, [(r["solver"], r["shadow_of"], r["delta_iters"],
                  r["agree"]) for r in sink], router.snapshot()


def test_shadow_choices_match_jax():
    """The same shadow seed and dispatch sequence shadow the same
    dispatches onto the same losers in both packages, with the same
    budget deferrals and per-lane deltas."""
    def jax_sol(m):
        it = {"admm": 50, "pdhg": 200, "napg": 25}[m]
        return type("S", (), dict(
            status=np.array([1, 2]), iters=np.array([it, it]),
            prim_res=np.zeros(2), dual_res=np.zeros(2),
            obj_val=np.array([0.1, 0.3])))

    def port_sol(m):
        s = jax_sol(m)
        fields = {k: torch.as_tensor(getattr(s, k))
                  for k in ("status", "iters", "prim_res", "dual_res",
                            "obj_val")}
        return type("S", (), dict(fields, x=torch.zeros(2, 3),
                                  y=torch.zeros(2, 1)))

    kw = dict(shadow_rate=0.6, shadow_seed=11, shadow_budget_per_tick=3)
    got = shadow_sequence(SolverRouter(port_params("dense"), **kw), port_sol)
    want = shadow_sequence(JaxRouter(jax_params("dense"), **kw), jax_sol)
    assert got == want
    assert got[2]["shadow_deferred"] > 0
    assert {s for s, _, _, _ in got[1]} == {"admm", "pdhg", "napg"}


def tiny_qps(n=4):
    """Six-variable requests in one 8 x 4 bucket (the chaos suite's)."""
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((12, 6))
        out.append(pt.CanonicalQP.build(
            A.T @ A / 12 + np.eye(6), rng.standard_normal(6),
            C=np.ones((1, 6)), l=np.ones(1), u=np.ones(1), lb=np.zeros(6),
            ub=np.ones(6), device="cpu"))
    return out


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["micro", "continuous"])
def test_prewarm_leaves_zero_recompiles_after_a_flip(continuous):
    """Prewarm builds every backend's ladder, so routing each bucket's
    dispatches through all three backends in turn compiles nothing."""
    params = pt.SolverParams(max_iter=500, eps_abs=1e-5, eps_rel=1e-5,
                             polish=False, backend="pallas")
    router = SolverRouter(params)
    svc = SolveService(params, ladder=BucketLadder(n_rungs=(8,),
                                                   m_rungs=(4,)),
                       max_batch=2, router=router, continuous=continuous,
                       device="cpu")
    qps = tiny_qps()
    with svc:
        assert svc.prewarm(qps[0]) == 3 * 2
        svc.metrics.reset_window()
        for method in METHODS + (None,):
            router.force(method)
            for q in qps:
                assert svc.solve(q, timeout=TIMEOUT).found
        snap = svc.snapshot()
    assert snap["compiles"] == 0
    assert snap["routed_admm"] == 2 * len(qps)
    assert snap["routed_pdhg"] == snap["routed_napg"] == len(qps)


def test_routed_service_matches_jax():
    """16 grid requests through both packages' routed services (the
    table seeded to send the bucket to PDHG, a shadow on a loser after
    every dispatch, four batches of four): equal answers per request,
    the same shadow choices with the same per-lane outcomes."""
    jreq, treq = grid_requests("dense")
    kw = dict(max_batch=4, max_wait_ms=2000.0, warm_start=False)
    rkw = dict(shadow_rate=1.0, shadow_seed=5)
    table = {("32x8", 1e-3): "pdhg"}
    out = []
    for Service, Router, Sink, params, reqs, extra in (
            (JaxService, JaxRouter, JaxSink, jax_params("dense"), jreq, {}),
            (SolveService, SolverRouter, HarvestSink, port_params("dense"),
             treq, dict(device="cpu"))):
        router = Router(params, **rkw)
        router.set_table(table)
        sink = Sink(None)
        svc = Service(params, router=router, harvest=sink, **kw, **extra)
        with svc:
            tickets = [svc.submit(q) for q in reqs]
            res = [svc.result(t, timeout=TIMEOUT) for t in tickets]
        recs = sink.buffered()
        out.append((res, [(r["source"], r["solver"], r["status"],
                           r["iters"]) for r in recs], svc.snapshot()))
    (jres, jrecs, jsnap), (tres, trecs, tsnap) = out
    assert [r.status for r in tres] == [r.status for r in jres]
    assert [r.iters for r in tres] == [r.iters for r in jres]
    np.testing.assert_allclose(np.stack([r.x for r in tres]),
                               np.stack([r.x for r in jres]), atol=X_ATOL,
                               rtol=0)
    assert trecs == jrecs
    assert sum(s == "serve.shadow" for s, *_ in trecs) == 16
    for key in ("routed_pdhg", "routed_admm", "shadow_solves", "completed"):
        assert tsnap[key] == jsnap[key], key


def test_write_golden_and_rehearse_phase10_at_a_small_size(tmp_path,
                                                           monkeypatch):
    """The --write-golden mode end to end at a small size (with a small
    serving golden for the stream), then phase 10 itself on the CPU
    against them: every check passes but those that count kernel
    launches, which only the card can meet. One test, so the goldens'
    JAX compiles run once."""
    import chip_smoke

    serve_path = str(tmp_path / "serve.npz")
    route_path = str(tmp_path / "route.npz")
    st = SMALL["stream"]
    write_serve_golden(serve_path, n_requests=st["n_requests"],
                       n_assets=st["n_assets"], batch=st["batch"])
    # The committed small serving golden (phase 11's rehearsal reads it)
    # is this stream's.
    fresh, committed = np.load(serve_path), np.load(SMALL_GOLDEN)
    assert json.loads(str(fresh["meta"])) == json.loads(
        str(committed["meta"]))
    assert sorted(fresh.files) == sorted(committed.files)
    for k in fresh.files:
        if fresh[k].dtype.kind in "fi":
            np.testing.assert_allclose(fresh[k], committed[k], rtol=0,
                                       atol=1e-7, err_msg=k)
        elif k != "meta":
            assert fresh[k] == committed[k], k
    write_golden(route_path, SMALL)
    g = np.load(route_path)
    meta = json.loads(str(g["meta"]))
    assert meta["seeded"] and meta["blend_buckets"] == {
        "alpha": "64x8", "beta": "32x32", "gamma": "32x8"}
    for m in ("pdhg", "napg"):
        assert g[f"stream/{m}/x"].shape == (8, 20)
        assert g[f"stream/{m}/x"].dtype == np.float32
        assert (g[f"stream/{m}/status"] == 1).all()
    assert (g["stream/pdhg/iters"] != g["stream/napg/iters"]).all()
    assert g["blend/beta/x"].shape == (2, 24)

    monkeypatch.setattr(chip_smoke, "SERVE_PATH", serve_path)
    monkeypatch.setattr(chip_smoke, "ROUTE_PATH", route_path)
    monkeypatch.setattr(chip_smoke, "kernel_row", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "profile_run",
                        lambda run, label, top=10: run())
    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    monkeypatch.setattr(chip_smoke, "STREAM_MAX_BATCH", 8)
    monkeypatch.setattr(chip_smoke, "BLEND_MAX_BATCH", 2)
    added = chip_smoke.routed_serve_phase({}, lambda: None, device="cpu")
    assert added == ["routed_k2", "routed_k1"]
    failed = chip_smoke.FAILURES
    assert len(failed) == 4 and all("launched" in f for f in failed), failed


@pytest.mark.parametrize("cells", ["calibration", "chaos"])
def test_phase10_calibration_and_chaos_cells_on_the_cpu(monkeypatch, cells):
    """The calibration drills and the chaos cells that phase 10 ran,
    now phase 16's (``chip_smoke.load_driver_phase``, through the
    ``porqua_tpu_torch.cli`` drivers), in classic mode on the CPU: the
    promote drill and the calibration cells, or the rest of the matrix.
    Every check passes but the two that count K2's launches (the card's
    alone; the kernel row is stubbed)."""
    import chip_smoke
    from porqua_tpu_torch.cli import chaos_suite
    from porqua_tpu_torch.ops import admm_kernel

    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    monkeypatch.setattr(chip_smoke, "LOAD_CLASSIC", (
        chaos_suite.CALIBRATION_CELLS if cells == "calibration" else
        tuple(chaos_suite.SCENARIOS) + chaos_suite.TENANT_CELLS
        + chaos_suite.ROUTE_CELLS))
    monkeypatch.setattr(chip_smoke, "LOAD_CONTINUOUS", ())
    monkeypatch.setattr(chip_smoke, "kernel_row", lambda *a: None)
    monkeypatch.setattr(admm_kernel, "dense_form", lambda *a: "cluster")
    assert chip_smoke.load_driver_phase({}, lambda: None,
                                        device="cpu") == ["load_k2"]
    failed = chip_smoke.FAILURES
    assert len(failed) == 2, failed
    assert failed[0].startswith("[load] K2 launched in the fault-free")
    assert failed[1].startswith("[load] the drivers' cells launched K2")


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: python tests/test_torch_routing.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    write_golden()
    print(f"wrote {GOLDEN} in {time.perf_counter() - t0:.1f} s "
          f"({os.path.getsize(GOLDEN) / 1e6:.2f} MB)")
