"""The port's telemetry warehouse (``porqua_tpu_torch/obs/harvest.py``)
against the JAX package's on the same inputs: ``solve_record`` field by
field, ``aggregate`` on the same records, the sink's dataset, and the
``harvest=`` hooks of ``run_batch``, ``solve_batch_compacted`` and the
checkpointed scan, which must emit the same records as the JAX
package's. Timings (``t``, ``wall_s``, ``solve_s``), the device label
and the per-dispatch roofline ``profile`` (the JAX package's XLA cost
harvest, item 19) are left out of the comparison; integer fields are
exact, float fields (f64 runs) within FLOAT_RTOL."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from porqua_tpu import batch as jbatch
from porqua_tpu import checkpoint as jck
from porqua_tpu import compaction as jcompaction
from porqua_tpu.batch import FIXED_UNIVERSE as JAX_FIXED
from porqua_tpu.obs import harvest as jh
from porqua_tpu.qp.solve import SolverParams as JaxParams

import porqua_tpu_torch as pt
from porqua_tpu_torch import batch as tbatch
from porqua_tpu_torch import builders as tb
from porqua_tpu_torch import checkpoint as tck
from porqua_tpu_torch import compaction as tcompaction
from porqua_tpu_torch.obs import harvest as th
from tests.test_torch_checkpoint import (batch_pair, jax_service,
                                         market_service, scan_problem)

SKIP = ("t", "wall_s", "solve_s", "device", "profile")
FLOAT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_records_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in set(w) - set(SKIP):
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=FLOAT_RTOL,
                                             abs=1e-12), k
            else:
                assert g[k] == w[k], k


RING = {"iters": [25, 50], "prim_res": [1e-2, 1e-4],
        "dual_res": [1e-3, 1e-5], "rho": [0.1, 0.4]}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(bucket="32x8", warm=True, warm_src="explicit", wall_s=0.1,
         solve_s=0.05, device="cuda:0", trace_id="abc", ring=RING,
         segments=3, batch=8, tenant="fund-a", shadow_of="admm",
         delta_iters=-5),
    dict(compaction={"lane_segments": 4}, profile={"seconds": 0.1}),
], ids=["bare", "full", "compaction"])
def test_solve_record_matches_jax(kw):
    args = ("serve", 24, 1, 1, 75, 1e-4, 2e-4, -0.25)
    for params in ((None, None), (JaxParams(method="pdhg"),
                                  pt.SolverParams(method="pdhg"))):
        want = jh.solve_record(*args, params=params[0], **kw)
        got = th.solve_record(*args, params=params[1], **kw)
        assert got.pop("t") > 0 and want.pop("t") > 0
        assert got == want


def _records(rng):
    """Records across tenants, buckets, eps, solvers, sources and one
    audit annotation, built by the JAX package's constructor."""
    out = []
    for i in range(40):
        out.append(jh.solve_record(
            ["serve", "serve.shadow", "batch"][i % 3], 24 + 8 * (i % 2), 1,
            1 if i % 7 else 2, int(rng.integers(1, 20)) * 25, 1e-4, 1e-4,
            -0.1, params=JaxParams(method=["admm", "pdhg", "napg"][i % 3],
                                   eps_abs=[1e-3, 1e-5][i % 2]),
            bucket=f"32x{8 * (1 + i % 2)}", warm=bool(i % 4 == 0),
            solve_s=1e-3 * (1 + i % 5), tenant=["a", "b", None][i % 3],
            ring=RING if i % 6 == 0 else None,
            **({"shadow_of": "admm"} if i % 3 == 1 else {})))
    out.append({"source": "calibration.audit", "version": 1})
    legacy = dict(out[0])
    legacy.pop("tenant")
    out.append(legacy)
    return out


def test_aggregate_matches_jax(rng):
    records = _records(rng)
    assert th.aggregate(records) == jh.aggregate(records)
    assert th.aggregate([]) == jh.aggregate([])


@pytest.mark.parametrize("suffix", [".jsonl", ".jsonl.gz"])
def test_sink_dataset_matches_jax(tmp_path, rng, suffix):
    records = _records(rng)
    for mod, name in ((jh, "j"), (th, "t")):
        with mod.HarvestSink(str(tmp_path / f"{name}{suffix}")) as sink:
            for r in records:
                sink.emit(r)
            assert sink.counters() == {"harvest_records": len(records),
                                       "harvest_write_failures": 0,
                                       "harvest_dropped": 0}
    got = th.load_harvest(str(tmp_path / f"t{suffix}"))
    assert got == jh.load_harvest(str(tmp_path / f"j{suffix}"))
    mem = th.HarvestSink(None, buffer_capacity=3)
    for r in records[:5]:
        mem.emit(r)
    assert mem.buffered() == records[:3] and mem.dropped == 2


def test_run_batch_harvest_matches_jax():
    """``run_batch(harvest=)``: one record per rebalance date, source
    "batch", as the JAX package's; the port's records say cpu:0."""
    import porqua_tpu as rj
    from porqua_tpu import builders as jb

    kw = dict(max_iter=4000, eps_abs=1e-8, eps_rel=1e-8)
    jsink, tsink = jh.HarvestSink(None), th.HarvestSink(None)
    jbatch.run_batch(market_service(rj, jb, rj.MeanVariance()),
                     JaxParams(**kw), dtype=np.float64, harvest=jsink)
    tbatch.run_batch(market_service(pt, tb, pt.MeanVariance()),
                     pt.SolverParams(**kw), dtype=torch.float64,
                     harvest=tsink, device="cpu")
    got, want = tsink.buffered(), jsink.buffered()
    assert len(got) == 5
    assert_records_match(got, want)
    assert {r["device"] for r in got} == {"cpu:0"}
    assert {r["source"] for r in got} == {"batch"}


def test_compacted_harvest_matches_jax(rng):
    """``solve_batch_compacted(harvest=)``: one record per lane with the
    compaction accounting, source "batch.compacted"."""
    jq, tq = batch_pair(rng, n_problems=4)
    kw = dict(max_iter=4000, eps_abs=1e-8, eps_rel=1e-8)
    jsink, tsink = jh.HarvestSink(None), th.HarvestSink(None)
    jcompaction.solve_batch_compacted(jq, JaxParams(**kw), harvest=jsink)
    tcompaction.solve_batch_compacted(tq, pt.SolverParams(**kw),
                                      harvest=tsink, device="cpu")
    got, want = tsink.buffered(), jsink.buffered()
    assert_records_match(got, want)
    assert all(r["compaction"]["lane_segments"] > 0 for r in got)
    assert {r["device"] for r in got} == {"cpu:0"}


def test_checkpointed_scan_harvest_matches_jax(tmp_path):
    """``solve_scan_l1_checkpointed(harvest=)``: one record per date of
    each segment this run solved, date 0 cold and the rest warm from the
    scan carry, lanes numbered by date."""
    jq, tq, w_init = scan_problem()
    kw = dict(max_iter=2000, eps_abs=1e-7, eps_rel=1e-7)
    jsink, tsink = jh.HarvestSink(None), th.HarvestSink(None)
    jck.solve_scan_l1_checkpointed(jq, 6, w_init, 0.01, str(tmp_path / "j"),
                                   params=JaxParams(**kw), segment_size=2,
                                   universes=JAX_FIXED, harvest=jsink)
    tck.solve_scan_l1_checkpointed(tq, 6, w_init, 0.01, str(tmp_path / "t"),
                                   params=pt.SolverParams(**kw),
                                   segment_size=2,
                                   universes=tbatch.FIXED_UNIVERSE,
                                   harvest=tsink, device="cpu")
    got, want = tsink.buffered(), jsink.buffered()
    assert_records_match(got, want)
    assert [r["lane"] for r in got] == list(range(6))
    assert [r["warm"] for r in got] == [False] + [True] * 5
