"""The rest of the port's ``obs/`` (``report.py``, ``ledger.py``,
``federation.py``) against the JAX package's on the same inputs: the
run ledger's rows, files and trend baseline; the text report over one
serving run's trace, event log, snapshot, harvest and cost files (the
port's run, rendered by both packages: the same text); and the fleet
collector over the same worker streams in the scenarios of the JAX
package's ``tests/test_federation.py`` that need no subprocess (the
same merged report, liveness events, bundles and Prometheus text, less
the times). Host code: held exact."""

import json
import os
import types

import pytest
import torch

from porqua_tpu.obs import federation as jfederation
from porqua_tpu.obs import ledger as jledger
from porqua_tpu.obs import report as jreport
from porqua_tpu.obs.exposition import prometheus_text as jax_prometheus_text
from porqua_tpu.obs.flight import FlightRecorder as JaxFlight
from porqua_tpu.obs.flight import load_bundle as jax_load_bundle
from porqua_tpu.obs.slo import SLOEngine as JaxEngine
from porqua_tpu.obs.slo import default_slos as jax_default_slos
from porqua_tpu.resilience.faults import FaultClock as JaxClock

from porqua_tpu_torch import obs
from porqua_tpu_torch.obs import federation, ledger, report
from porqua_tpu_torch.obs.exposition import prometheus_text
from porqua_tpu_torch.resilience.faults import FaultClock
from porqua_tpu_torch.serve.loadgen import run_loadgen
from tests.test_torch_serve import grid_requests, port_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAMPS = ("t", "ts", "pid", "window_seconds", "uptime_s", "now",
          "elapsed_s", "path", "bundle_path")


def stamp_free(x):
    """``x`` without its wall-clock stamps and process ids (recursive);
    bundle paths by file name (each package writes under its own
    directory)."""
    if isinstance(x, dict):
        return {k: ([os.path.basename(p) for p in v]
                    if k == "incident_bundle_paths" else stamp_free(v))
                for k, v in x.items() if k not in STAMPS}
    if isinstance(x, (list, tuple)):
        return [stamp_free(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# the run ledger
# ---------------------------------------------------------------------------

def test_ledger_rows_files_and_trend_match_jax(tmp_path):
    bench = {"value": 3.5, "vs_baseline": 1.9, "iters_p50": 25,
             "xla_cost": {"flops": 1e9, "bytes_accessed": 2e8},
             "config_serving": {"throughput_solves_per_s": 650.0,
                                "cost_summary": {"peak_bytes_max": 7e6}}}
    loadgen = {"throughput_solves_per_s": 512.0, "latency_p50_ms": 4.5,
               "recompiles_after_warmup": 0, "errors": 0, "solved": 512,
               "tenant_fairness": {"tenants": 2, "quiet_p99_ratio": 1.25}}
    fleet = {"workers": 3, "workers_lost": ["w1"], "duration_s": 25.0,
             "fleet": {"completed": 156, "harvest_records": 116},
             "reconciled": True, "incident_bundles": 1}
    for extract in ("metrics_from_bench", "metrics_from_loadgen",
                    "metrics_from_fleet"):
        for payload in (bench, loadgen, fleet, {}):
            assert getattr(ledger, extract)(payload) == getattr(
                jledger, extract)(payload)
    paths = {}
    for tag, mod in (("port", ledger), ("jax", jledger)):
        path = str(tmp_path / f"{tag}.jsonl")
        assert mod.load_ledger(path) == []
        for i, (kind, payload, extract) in enumerate(
                [("bench", bench, "metrics_from_bench"),
                 ("serve_loadgen", loadgen, "metrics_from_loadgen"),
                 ("fleet_loadgen", fleet, "metrics_from_fleet")] * 3):
            row = mod.ledger_row(
                kind, getattr(mod, extract)(payload), t=1000.0 + i,
                rev="abc123" if i % 2 else None,
                gate={"ok": i % 3 != 0, "n_pass": 5, "n_fail": i % 3,
                      "failed": ["a", "b"]} if kind == "bench" else None,
                artifact=f"BENCH_r{i:02d}.json", note="n" if i else None)
            mod.append_row(path, row)
        paths[tag] = path
        with pytest.raises(ValueError, match="unknown ledger kind"):
            mod.ledger_row("nope", {})
    with open(paths["port"]) as f, open(paths["jax"]) as g:
        assert f.read() == g.read()
    rows = ledger.load_ledger(paths["port"])
    assert rows == jledger.load_ledger(paths["jax"]) and len(rows) == 9
    for metric in ("value", "throughput_solves_per_s", "workers_lost",
                   "fleet.completed", "missing"):
        for window in (1, 2, 5):
            for kind in (None, "bench", "fleet_loadgen"):
                assert ledger.rolling_median(
                    rows, metric, window, kind) == jledger.rolling_median(
                    rows, metric, window, kind)
    flat = ledger.metrics_from_bench(bench)
    assert ledger.nest_metrics(flat) == jledger.nest_metrics(flat)
    assert ledger.LEDGER_SCHEMA_VERSION == jledger.LEDGER_SCHEMA_VERSION


# ---------------------------------------------------------------------------
# the text report over one serving run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """One small port serving run (two tenants, rings, harvest, the cost
    plane) and its five artifacts on disk, plus the loadgen report."""
    tmp = tmp_path_factory.mktemp("run")
    files = {k: str(tmp / name) for k, name in (
        ("trace", "trace.json"), ("events", "events.jsonl"),
        ("snapshot", "metrics.jsonl"), ("harvest", "harvest.jsonl"),
        ("costs", "costs.jsonl"))}
    _, treq = grid_requests("dense", n=8)
    rep = run_loadgen(treq, port_params("dense"), max_batch=4, device="cpu",
                      trace_out=files["trace"], events_out=files["events"],
                      jsonl_path=files["snapshot"],
                      harvest_out=files["harvest"], ring_size=8,
                      cost_out=files["costs"], tenants=["a", "b"] * 4)
    assert rep["solved"] == 8 and rep["cost_records"] == 3
    return files, rep


def load_artifacts(files, pkg):
    with open(files["trace"]) as f:
        trace = json.load(f)
    with open(files["snapshot"]) as f:
        snapshot = json.loads(f.read().strip().splitlines()[-1])
    return dict(trace=trace, events=pkg.load_jsonl(files["events"]),
                snapshot=snapshot, harvest=pkg.load_harvest(files["harvest"]),
                costs=pkg.load_cost_records(files["costs"]))


def test_render_report_matches_jax(run_files):
    """Every section from the same files, read by both packages' readers
    and rendered by both: the same text. The port's harvest records
    carry counted (``cost_source: "torch"``) profiles, which the port's
    report counts as measured exactly as both count the JAX package's
    ``"xla"`` ones."""
    import porqua_tpu.obs as jobs

    files, rep = run_files
    mine = load_artifacts(files, obs)
    ref = load_artifacts(files, jobs)
    assert mine == ref
    assert {h["profile"]["cost_source"] for h in mine["harvest"]} == {
        "torch"}
    as_xla = [dict(h, profile=dict(h["profile"], cost_source="xla"))
              for h in ref["harvest"]]
    fleet = scenario_report(federation, FaultClock, tmp=None)
    text = report.render_report(fleet=fleet, tenants=rep, **mine)
    assert text == jreport.render_report(fleet=fleet, tenants=rep,
                                         **dict(ref, harvest=as_xla))
    assert report.render_report(fleet=fleet, tenants=rep, **dict(
        mine, harvest=as_xla)) == text
    assert len(text.split("\n" + "-" * 64 + "\n")) == 11
    assert "measured-vs-model (per bucket" in text
    assert "device cost / memory (3 CostRecords)" in text
    for name in ("span_coverage", "coverage_stats", "span_aggregate"):
        assert getattr(report, name)(mine["trace"]) == getattr(
            jreport, name)(ref["trace"])
    assert obs.trace.coverage_stats is report.coverage_stats
    assert report.render_report() == jreport.render_report()


def test_costs_section_counts_xla_and_torch_profiles():
    """A harvest record whose profile came from either package's cost
    plane counts as measured; a model-only profile does not."""
    costs = [{"bucket": "32x8", "kind": "solve", "entry": "solve",
              "slots": 4, "bytes_accessed": 2e6, "peak_bytes": 1e6,
              "compile_s": 0.5, "hlo_hash": "ab" * 8}]
    for source, measured in (("xla", True), ("torch", True),
                             ("model", False)):
        harvest = [{"bucket": "32x8", "profile": {
            "cost_source": source, "flops_model_ratio": 1.5,
            "bytes_model_ratio": 0.5}}]
        text = report.costs_section(costs, harvest)
        assert ("measured-vs-model (per bucket" in text) == measured
        if source != "torch":
            assert text == jreport.costs_section(costs, harvest)


# ---------------------------------------------------------------------------
# the fleet collector
# ---------------------------------------------------------------------------

PORT = types.SimpleNamespace(
    FleetCollector=federation.FleetCollector,
    WorkerStream=federation.WorkerStream, FaultClock=FaultClock,
    FlightRecorder=obs.FlightRecorder, SLOEngine=obs.SLOEngine,
    default_slos=obs.default_slos, prometheus_text=prometheus_text,
    load_bundle=obs.load_bundle)
JAX = types.SimpleNamespace(
    FleetCollector=jfederation.FleetCollector,
    WorkerStream=jfederation.WorkerStream, FaultClock=JaxClock,
    FlightRecorder=JaxFlight, SLOEngine=JaxEngine,
    default_slos=jax_default_slos, prometheus_text=jax_prometheus_text,
    load_bundle=jax_load_bundle)


def slo_sample(completed, failed=0, counts=(0, 0), le=(0.01, 0.1)):
    """A synthetic cumulative ``ServeMetrics.slo_sample()`` payload."""
    counts = tuple(counts) + (0,) * (len(le) + 1 - len(counts))
    return {"completed": completed, "failed": failed, "expired": 0,
            "retry_giveups": 0, "validation_failures": 0,
            "latency_le": tuple(le), "latency_counts": counts,
            "latency_count": sum(counts)}


HIST = {"solve_latency_seconds": {"le": (0.01, 0.1), "counts": [5, 2, 0],
                                  "sum": 0.1, "count": 7}}
VITALS = {"rss_bytes": 5e8, "open_fds": 9, "threads": 3, "queue_depth": 0}


def make_fleet(P, tmp, workers=("w0", "w1"), **kw):
    clock = kw.pop("clock", None) or P.FaultClock()
    kw.setdefault("heartbeat_timeout_s", 5.0)
    kw.setdefault("rollup_window_s", 2.0)
    col = P.FleetCollector(clock=clock, **kw)
    streams = {}
    for wid in workers:
        path = os.path.join(tmp, f"{wid}.jsonl")
        col.add_worker(wid, path)
        streams[wid] = P.WorkerStream(path, wid)
        streams[wid].hello(latency_le=[0.01, 0.1])
    return col, streams, clock


def fleet_view(P, col, flight=None, error=None):
    """Everything the collector shows, less its times."""
    metrics = P.prometheus_text(
        col.snapshot(), prefix="porqua_fleet", histograms=col.histograms(),
        extra_counters=col.counters(), labeled_gauges=col.worker_gauges())
    view = {"report": col.report(), "snapshot": col.snapshot(),
            "slo_sample": col.slo_sample(), "histograms": col.histograms(),
            "rollups": col.rollups(), "gauges": col.worker_gauges(),
            "events": col.events.events(), "counters": col.counters(),
            "metrics": [ln for ln in metrics.splitlines()
                        if not any(s in ln for s in ("uptime", "window_sec",
                                                     "elapsed", "_t "))],
            "error": error}
    if flight is not None:
        view["bundles"] = [P.load_bundle(b) if isinstance(b, str) else b
                           for b in flight.bundles()]
    return stamp_free(json.loads(json.dumps(view, default=str)))


def sc_merge(P, tmp):
    col, s, clock = make_fleet(P, tmp)
    s["w0"].sample(slo_sample(10, failed=1, counts=(6, 4, 1)), hist=HIST,
                   snap={"occupancy_mean": 0.8, "submitted": 10},
                   vitals=VITALS)
    s["w1"].sample(slo_sample(20, counts=(15, 5, 0)),
                   snap={"occupancy_mean": 0.6, "submitted": 20})
    for wid in ("w0", "w1"):
        s[wid].event({"kind": "backpressure_reject", "severity": "warn",
                      "trace_id": "t17"})
    col.drain()
    s["w0"].sample(slo_sample(25))
    s["w0"].sample(slo_sample(40, counts=(30, 10)))
    col.drain()
    col.drain()
    return fleet_view(P, col)


def sc_torn_and_garbage(P, tmp):
    col, s, _ = make_fleet(P, tmp, workers=("w0",))
    s["w0"].sample(slo_sample(5))
    col.drain()
    with open(s["w0"].path, "a") as f:
        f.write("not json at all\n")
        f.write('{"t": 1, "w": "w0", "kind": "sample", "slo"')
    col.drain()
    with open(s["w0"].path, "a") as f:
        f.write(': %s}\n' % json.dumps(slo_sample(9)))
    col.drain()
    return fleet_view(P, col)


def sc_ladder_refused(P, tmp):
    col = P.FleetCollector(clock=P.FaultClock())
    s = {}
    for wid, le in (("a", [0.01, 0.1]), ("b", [0.02, 0.2])):
        path = os.path.join(tmp, f"{wid}.jsonl")
        col.add_worker(wid, path)
        s[wid] = P.WorkerStream(path, wid)
        s[wid].hello(latency_le=le)
    s["a"].sample(slo_sample(5, counts=(5, 0)))
    error = None
    try:
        col.drain()
    except ValueError as exc:
        error = str(exc)
    s["b"].sample(slo_sample(99, counts=(90, 9)))
    col.drain()
    with pytest.raises(ValueError, match="already registered"):
        col.add_worker("a", os.path.join(tmp, "other.jsonl"))
    return fleet_view(P, col, error=error)


def sc_throughput_and_rollups(P, tmp):
    col, s, clock = make_fleet(P, tmp, rollup_capacity=4)
    clock.advance(300.0)
    total = 0
    for i in range(7):
        total += 10
        s["w0"].sample(slo_sample(total), vitals=VITALS)
        s["w1"].sample(slo_sample(2 * total), vitals=VITALS)
        clock.advance(2.0 if i != 3 else 6.0)
        col.drain()
    for wid, n in (("w0", total), ("w1", 2 * total)):
        s[wid].report({"completed": n, "failed": 0, "harvest_records": n,
                       "throughput_solves_per_s": 12.0, "duration_s": 10.0})
    col.drain()
    return fleet_view(P, col)


def sc_liveness(P, tmp):
    clock = P.FaultClock()
    flight = P.FlightRecorder(out_dir=None, debounce_s=0.0, clock=clock)
    col, s, _ = make_fleet(P, tmp, clock=clock, flight=flight,
                           workers=("w0", "w1", "w2"))
    for wid in s:
        s[wid].sample(slo_sample(10), vitals=VITALS)
    s["w2"].report({"completed": 10, "failed": 0, "harvest_records": 10})
    col.drain()
    for i in range(4):
        clock.advance(2.0)
        s["w1"].sample(slo_sample(12 + i), vitals=VITALS)
        col.drain()
    s["w1"].report({"completed": 15, "failed": 0})
    col.drain()
    clock.advance(60.0)
    col.drain()
    assert col.check_liveness() == []
    return fleet_view(P, col, flight)


def sc_crash_cell(P, tmp):
    clock = P.FaultClock()
    flight = P.FlightRecorder(out_dir=os.path.join(tmp, "incidents"),
                              debounce_s=0.0, clock=clock)
    col, s, _ = make_fleet(P, tmp, workers=("w0", "w1", "w2"), clock=clock,
                           flight=flight)
    for wid, n in (("w0", 50), ("w1", 40), ("w2", 60)):
        s[wid].sample(slo_sample(n, counts=(n, 0)))
    with open(s["w1"].path, "a") as f:
        f.write('{"t": 2, "w": "w1", "kind": "sam')
    col.drain()
    for i in range(4):
        clock.advance(2.0)
        for wid, n in (("w0", 50 + i), ("w2", 60 + i)):
            s[wid].sample(slo_sample(n, counts=(n, 0)))
        col.drain()
    for wid, n in (("w0", 53), ("w2", 63)):
        s[wid].sample(slo_sample(n, counts=(n, 0)))
        s[wid].report({"completed": n, "failed": 0, "harvest_records": n,
                       "recompiles_after_warmup": 0,
                       "throughput_solves_per_s": 10.0})
    col.drain()
    return fleet_view(P, col, flight)


def sc_fleet_slo(P, tmp):
    clock = P.FaultClock()
    engine = P.SLOEngine(P.default_slos(), clock=clock,
                         min_eval_interval_s=0.0)
    flight = P.FlightRecorder(out_dir=None, debounce_s=0.0, clock=clock)
    col, s, _ = make_fleet(P, tmp, clock=clock, slo=engine, flight=flight)
    s["w0"].sample(slo_sample(100))
    s["w1"].sample(slo_sample(100))
    col.drain()
    clock.advance(10.0)
    s["w0"].sample(slo_sample(110))
    s["w1"].sample(slo_sample(102, failed=90))
    col.drain()
    view = fleet_view(P, col, flight)
    view["slo"] = stamp_free(engine.status())
    return view


def sc_dead_stream(P, tmp):
    stream = P.WorkerStream(os.path.join(tmp, "s.jsonl"), "w0")
    stream.hello(latency_le=[0.1])
    stream.close()
    stream.sample(slo_sample(1))
    dead = P.WorkerStream(os.path.join(tmp, "no", "dir.jsonl"), "w1")
    dead.heartbeat()
    return {"records": stream.records, "failures": stream.write_failures,
            "dead": (dead.records, dead.write_failures)}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_merge, sc_torn_and_garbage, sc_ladder_refused,
    sc_throughput_and_rollups, sc_liveness, sc_crash_cell, sc_fleet_slo,
    sc_dead_stream)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_scenarios_match_jax(name, tmp_path):
    """The same worker streams through both packages' collectors: the
    same merged report, events, bundles and Prometheus text."""
    views = {}
    for tag, P in (("port", PORT), ("jax", JAX)):
        d = tmp_path / tag
        d.mkdir()
        views[tag] = SCENARIOS[name](P, str(d))
    assert views["port"] == views["jax"]
    v = views["port"]
    if name == "merge":
        assert v["slo_sample"]["completed"] == 60
        assert v["histograms"]["solve_latency_seconds"]["counts"] == [5, 2, 0]
        assert sorted(e["trace_id"] for e in v["events"]
                      if e["kind"] == "backpressure_reject") == [
            "w0/t17", "w1/t17"]
    elif name == "ladder_refused":
        assert "ladder" in v["error"] and v["report"]["reconciled"]
        assert v["counters"]["fleet_ladder_refusals"] == 1
    elif name == "crash_cell":
        assert v["report"]["workers_lost"] == ["w1"]
        assert v["report"]["fleet"]["completed"] == 53 + 40 + 63
        assert [b["trigger"]["kind"] for b in v["bundles"]].count(
            "worker_lost") == 1
    elif name == "liveness":
        assert [e["worker"] for e in v["events"]
                if e["kind"] == "worker_lost"] == ["w0"]
    elif name == "fleet_slo":
        assert v["slo"]["alerts_fired"] >= 1
    elif name == "dead_stream":
        assert v == {"records": 1, "failures": 1, "dead": (0, 2)}


def scenario_report(mod, clock_cls, tmp):
    """A finished two-worker fleet's merged report (for the report's
    fleet section)."""
    import tempfile

    tmp = tmp or tempfile.mkdtemp(prefix="fleet-")
    P = PORT if mod is federation else JAX
    col, s, _ = make_fleet(P, tmp)
    for wid, n in (("w0", 7), ("w1", 9)):
        s[wid].sample(slo_sample(n, counts=(n, 0)), vitals=VITALS)
        s[wid].report({"completed": n, "failed": 0, "harvest_records": n,
                       "recompiles_after_warmup": 0,
                       "throughput_solves_per_s": 3.5})
    col.drain()
    return stamp_free(col.report())
