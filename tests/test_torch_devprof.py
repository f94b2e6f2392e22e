"""The port's device-cost plane (``porqua_tpu_torch/obs/devprof.py``,
``obs/profile.py::qp_solve_profile``, the executable cache's harvest)
against the JAX package's on the same inputs where both define the
result (the CostRecord readers, the measured-rates arithmetic, the
roofline verdict, the per-dispatch profile, the CostLog files), and
on the CPU alone where the port counts its own program: the dispatch
counter's flops and bytes, the records of a real cache, the served
bits with the plane on and off, the profiler window's states, and
chip_smoke.py's phase 11 at a small size.

The JAX package's own harvest (its ``cost_analysis`` of an XLA
executable) is not an oracle here: its test
``tests/test_devprof.py::TestCostRecord::test_harvest_from_real_executable``
fails, and the port counts a different program. The
port's records are held to their documented definition."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from porqua_tpu.obs import devprof as jdevprof
from porqua_tpu.obs.profile import qp_solve_profile as jax_qp_solve_profile

import porqua_tpu_torch as pt
from porqua_tpu_torch.obs import devprof
from porqua_tpu_torch.obs.profile import qp_solve_profile
from porqua_tpu_torch.serve import (BucketLadder, ExecutableCache,
                                    SolveService, slot_ladder)
from tests.test_torch_serve import (SMALL_GOLDEN, SMALL_SIZES, grid_requests,
                                    jax_params, port_params, solve_all)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(seed=0):
    """CostRecords of both packages' schema (the JAX package's field
    names, a few entries and buckets, a later record for one identity)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (entry, bucket, slots) in enumerate(
            [("solve", "32x8", 1), ("solve", "32x8", 4), ("step", "64x8", 2),
             ("admit", "64x8", 2), ("solve", "512x8xf252", 8),
             ("solve", "32x8", 4)]):
        out.append({"v": 1, "t": 1000.0 + i, "kind": "solve"
                    if entry == "solve" else "continuous", "entry": entry,
                    "bucket": bucket, "slots": slots, "dtype": "float32",
                    "device": "cuda:0", "compile_s": float(rng.random()),
                    "flops": float(rng.integers(1, 10 ** 9)),
                    "bytes_accessed": float(rng.integers(1, 10 ** 8)),
                    "peak_bytes": float(rng.integers(1, 10 ** 7)),
                    "hlo_hash": f"{i:016x}"})
    return out


STAGES = {"serve/solve_batch": 0.75, "serve/admit": 0.125,
          "serve/segment_step": 0.5, "serve/finalize": 0.0625,
          "serve/queue_wait": 1.5}


def _drop_t(d):
    return {k: v for k, v in d.items() if k != "t"}


# ---------------------------------------------------------------------------
# the readers, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seconds, model_flops, model_bytes", [
    (None, None, None), (0.25, None, None), (0.25, 3e8, 2e7),
    (0.0, 3e8, None)])
def test_measured_rates_match_jax(seconds, model_flops, model_bytes):
    for rec in _records():
        assert devprof.measured_rates(
            rec, seconds, model_flops, model_bytes) == jdevprof.measured_rates(
            rec, seconds, model_flops, model_bytes)


@pytest.mark.parametrize("top", [1, 3, 10])
def test_roofline_verdict_matches_jax(top):
    """The same ranking, candidates and verdict, except ``t``, with no
    known card (``device_kind=""``) and with stage seconds or none."""
    for stages in (None, STAGES):
        mine = devprof.roofline_verdict(_records(), stages, top=top)
        ref = jdevprof.roofline_verdict(_records(), stages, top=top)
        assert _drop_t(mine) == _drop_t(ref)
    assert devprof.ENTRY_STAGES == jdevprof.ENTRY_STAGES
    assert devprof.COST_SCHEMA_VERSION == jdevprof.COST_SCHEMA_VERSION


def test_roofline_verdict_reads_the_cards_ridge_point():
    """With the card's name the ridge point is its bf16 peak over its
    bandwidth (the JAX package's definition), and rows are classified."""
    v = devprof.roofline_verdict(_records(), STAGES,
                                 device_kind="NVIDIA H100 80GB HBM3")
    assert v["ridge_flops_per_byte"] == 989e12 / 3.35e12
    assert all(r.get("bound") in ("memory", "compute") for r in v["ranked"])
    assert devprof.roofline_verdict(
        [], device_kind="NVIDIA A100")["ridge_flops_per_byte"] is None


@pytest.mark.parametrize("suffix", [".jsonl", ".jsonl.gz"])
def test_cost_log_files_match_jax(tmp_path, suffix):
    """The same records through both packages' CostLog (appending, then
    a truncating ``write_cost_records``): the same JSONL lines."""
    recs = _records()
    paths = {}
    for tag, mod in (("port", devprof), ("jax", jdevprof)):
        path = str(tmp_path / f"{tag}{suffix}")
        with mod.CostLog(path) as log:
            for r in recs[:3]:
                log.emit(r)
            assert log.counters() == {"cost_records": 3,
                                      "cost_write_failures": 0}
        with mod.CostLog(path) as log:
            log.emit(recs[3])
        paths[tag] = path
        assert mod.load_cost_records(path) == recs[:4]
    opener = gzip.open if suffix.endswith(".gz") else open
    lines = {}
    for tag, path in paths.items():
        with opener(path, "rt") as f:
            lines[tag] = f.read()
    assert lines["port"] == lines["jax"]
    for tag, mod in (("port", devprof), ("jax", jdevprof)):
        assert mod.write_cost_records(paths[tag], recs[4:]) == 2
        assert mod.load_cost_records(paths[tag]) == recs[4:]


def test_cost_log_dead_sink_counts_and_never_raises(tmp_path):
    """A sink that cannot open, and one that dies mid-run, count
    ``write_failures``; ``emit`` never raises; the memory log buffers."""
    dead = devprof.CostLog(str(tmp_path / "no" / "such" / "dir.jsonl"))
    dead.emit(_records()[0])
    assert dead.write_failures == 1 and dead.records == 1
    log = devprof.CostLog(str(tmp_path / "c.jsonl"))
    log._sink.close()                   # the disk goes away
    log.emit(_records()[0])
    log.emit(_records()[1])
    assert log.write_failures == 1 and log.records == 2
    log.close()
    mem = devprof.CostLog(buffer_capacity=2)
    for r in _records():
        mem.emit(r)
    assert mem.records == 6 and mem.buffered() == _records()[:2]


COST = {"flops": 4.5e8, "bytes_accessed": 6.25e7, "peak_bytes": 3.0e7}


@pytest.mark.parametrize("kind", ["dense", "factored"])
@pytest.mark.parametrize("cost", [None, COST], ids=["model", "cost"])
def test_qp_solve_profile_matches_jax(kind, cost):
    """The per-dispatch profile with no known card: equal to the JAX
    package's except the ``cost_source`` label of a cost record
    ("torch" here, "xla" there)."""
    jp = jax_params(kind)
    fr = 40 if kind == "factored" else None
    args = (512, 8, 37.5, 0.0125)
    kw = dict(batch=4, factor_rows=fr, device_kind="",
              stage_seconds={"serve/solve_batch": 0.0125})
    mine = qp_solve_profile(*args, params=port_params(kind), cost=cost, **kw)
    ref = jax_qp_solve_profile(*args, params=jp, cost=cost, **kw)
    assert mine.pop("cost_source") == ("model" if cost is None else "torch")
    assert ref.pop("cost_source") == ("model" if cost is None else "xla")
    assert mine == ref


def test_qp_solve_profile_reads_the_cards_peaks():
    """On the card the MFU fields read against its f32 and bf16 peaks
    (TF32 off: the f32 rate is the compute ceiling)."""
    p = qp_solve_profile(512, 8, 25.0, 0.01, batch=256, factor_rows=252,
                         device_kind="NVIDIA H100 80GB HBM3", cost=COST)
    assert p["cost_source"] == "torch" and p["flops_xla"] == COST["flops"]
    assert p["mfu_f32_est"] == pytest.approx(COST["flops"] / 0.01 / 67e12)
    assert p["mfu_bf16_peak"] == pytest.approx(COST["flops"] / 0.01 / 989e12)
    assert p["hbm_utilization"] == pytest.approx(
        COST["bytes_accessed"] / 0.01 / 3.35e12)
    assert p["peak_bytes"] == COST["peak_bytes"]


# ---------------------------------------------------------------------------
# the port's own counting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 6, 7, 3)])
def test_dispatch_counter_counts_a_matmul(shape):
    """One ``torch.matmul``: exactly 2 m n k flops (times the batch),
    and each input read once plus the output written once."""
    g = torch.Generator().manual_seed(0)
    if len(shape) == 3:
        m, k, n = shape
        a, b = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g)
        batch = 1
    else:
        batch, m, k, n = shape
        a = torch.randn(batch, m, k, generator=g)
        b = torch.randn(batch, k, n, generator=g)
    out, c = devprof.count_call(torch.matmul, a, b)
    assert torch.equal(out, torch.matmul(a, b))
    assert c.flops == 2 * batch * m * n * k
    assert c.bytes_accessed == 4 * batch * (m * k + k * n + m * n)
    assert c.kernel_flops == 0 and c.segments == 0
    assert c.op_hash and c.peak_bytes is None
    assert devprof.count_call(torch.matmul, a, b)[1].op_hash == c.op_hash
    assert devprof.count_call(torch.matmul, a[..., :2, :],
                              b)[1].op_hash != c.op_hash


def test_cache_harvests_one_record_per_entry():
    """A real cache at a small bucket on the CPU: one record per built
    entry (three for a continuous triple), each with the schema's
    fields, flops and bytes above 0, segments counted, no kernel part
    and no memory fields on the CPU; the op hash equal for the same
    entry built by a second cache and distinct across shapes."""
    _, treq = grid_requests("dense", n=1)
    bucket = BucketLadder().select(treq[0])
    params = port_params("dense")
    cache = ExecutableCache(params)
    assert cache.prewarm(bucket, 2, torch.float32, "cpu",
                         continuous=True) == 4
    recs = cache.cost_records()
    kinds = sorted((r["kind"], r["entry"], r["slots"]) for r in recs)
    assert kinds == sorted([("solve", "solve", s) for s in (1, 2)]
                           + [("continuous", e, s) for s in (1, 2)
                              for e in ("admit", "step", "finalize")])
    for r in recs:
        assert r["v"] == 1 and r["cost_source"] == "torch"
        assert r["bucket"] == "32x8" and r["device"] == "cpu:0"
        assert r["dtype"] == "float32" and r["compile_s"] > 0
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert r["kernel_flops"] == r["kernel_bytes"] == 0
        assert r["kernel_launches"] == {}
        assert r["segments"] == (1 if r["entry"] in ("solve", "step")
                                 else 0)
        for k in ("peak_bytes", "argument_bytes", "output_bytes",
                  "temp_bytes", "alias_bytes", "generated_code_bytes"):
            assert r[k] is None
    assert len({r["hlo_hash"] for r in recs}) == len(recs)
    twin = ExecutableCache(params)
    twin.get(bucket, 2, torch.float32, "cpu")
    assert (twin.cost_record_for(bucket, 2, torch.float32)["hlo_hash"]
            == cache.cost_record_for(bucket, 2, torch.float32,
                                     device_label="cpu:0")["hlo_hash"])
    assert cache.cost_record_for(bucket, 2, torch.float32, kind="continuous",
                                 device_label="cuda:0") is None
    stats = cache.bucket_stats()["32x8"]
    assert stats["bytes_accessed_max"] == max(r["bytes_accessed"]
                                              for r in recs)
    assert "peak_bytes_max" not in stats
    assert cache.prometheus_gauges()["bucket_peak_bytes"] == []
    assert ExecutableCache(params, cost_log=False).cost_log is None


@pytest.mark.parametrize("kind", ["dense", "factored"])
def test_plane_off_serves_the_same_bits(kind):
    """The same requests through a service with the plane on (default,
    harvesting, profiles on the records) and one with
    ``cost_log=False``: bit-identical answers; the records of the first
    carry the counted profile, the second's the model's."""
    _, treq = grid_requests(kind, n=6)
    out = {}
    for cost_log in (None, False):
        sink = pt.obs.HarvestSink(None)
        with SolveService(port_params(kind), max_batch=8, max_wait_ms=50.0,
                          warm_start=False, harvest=sink, cost_log=cost_log,
                          device="cpu") as svc:
            svc.prewarm(treq[0])
            res = solve_all(svc, treq)
            health = svc._health_payload()["cache"]
        out[cost_log] = res
        profs = [h["profile"] for h in sink.buffered()]
        assert len(profs) == len(treq)
        if cost_log is None:
            assert health["cost_records"] == len(slot_ladder(8))
            assert {p["cost_source"] for p in profs} == {"torch"}
            assert all(p["flops_xla"] > 0 and "flops_model_ratio" in p
                       for p in profs)
        else:
            assert "cost_records" not in health
            assert {p["cost_source"] for p in profs} == {"model"}
    for a, b in zip(out[None], out[False]):
        assert np.array_equal(a.x, b.x)
        assert (a.status, a.iters, a.obj_val) == (b.status, b.iters,
                                                  b.obj_val)


def test_profile_window_states_and_trace(tmp_path):
    """idle -> tracing -> stopped (by the caller, then by its timer),
    a second ``stop`` a no-op, a Chrome trace written; a window that
    cannot write lands in ``failed`` with its error and never raises."""
    w = devprof.ProfileWindow(str(tmp_path / "a"))
    assert w.state == "idle" and not w.stop()
    assert w.start() and w.state == "tracing" and not w.start()
    torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    assert w.stop() and w.state == "stopped" and w.stopped_by == "caller"
    assert not w.stop() and w.error is None
    with open(w.trace_file) as f:
        assert "traceEvents" in json.load(f)
    assert os.path.dirname(w.trace_file) == str(tmp_path / "a")

    t = devprof.ProfileWindow(str(tmp_path / "b"), window_s=0.2)
    assert t.start()
    t._done.wait(30)
    assert t.state == "stopped" and t.stopped_by == "timer"
    assert not t.stop() and os.path.exists(t.trace_file)

    blocker = tmp_path / "c"
    blocker.write_text("a file where the trace directory would go")
    f = devprof.ProfileWindow(str(blocker))
    assert f.start()
    assert not f.stop() and f.state == "failed" and f.error
    assert f.trace_file is None


def test_cost_record_never_raises():
    """A refused analysis lands as None fields."""
    rec = devprof.cost_record(None, entry="solve", kind="solve",
                              bucket="32x8", slots=1)
    assert rec["flops"] is None and rec["bytes_accessed"] is None
    assert rec["peak_bytes"] is None and rec["hlo_hash"] is None
    assert rec["cost_source"] == "torch" and rec["v"] == 1


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 11 on the CPU
# ---------------------------------------------------------------------------

#: Phase 11's checks that only the card can meet: peak memory (the CPU
#: has none to read), the kernel launches (the plain twins count
#: none), the card's peaks (MFU, the ridge point) and the kernel's name
#: in the trace.
CARD_ONLY = ("every record has peak bytes above 0",
             "kernel_flops = launches x launch_cost",
             "bucket_peak_bytes",
             "the burst launched the cluster form",
             "MFU fields against the card's peaks",
             "the trace names the kernel",
             "ridge point")


def test_rehearse_phase11_at_a_small_size(monkeypatch):
    """Phase 11 on the CPU against the small serving golden (8 requests,
    20 assets, bucket 32 x 8, max_batch 8; the phase-10 rehearsal holds
    it equal to a fresh write): every check passes but the card-only
    ones, each of which fails for both services."""
    import chip_smoke

    assert SMALL_SIZES == dict(n_requests=8, n_assets=20, batch=8)
    monkeypatch.setattr(chip_smoke, "SERVE_PATH", SMALL_GOLDEN)
    monkeypatch.setattr(chip_smoke, "kernel_row", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    monkeypatch.setattr(chip_smoke, "STREAM_MAX_BATCH", 8)
    monkeypatch.setattr(chip_smoke, "COST_WINDOW_S", 0.2)
    assert chip_smoke.cost_phase({}, lambda: None, device="cpu") == [
        "cost_k2", "cost_k1"]
    failed = chip_smoke.FAILURES
    assert len(failed) == 2 * len(CARD_ONLY), failed
    for tag in ("cost_trinv", "cost_woodbury"):
        for what in CARD_ONLY:
            assert sum(f.startswith(f"[{tag}]") and what in f
                       for f in failed) == 1, (tag, what, failed)
