"""The port's observability pillars (``porqua_tpu_torch/obs``: events,
spans, exposition, vitals) against the JAX package's on the same inputs:
the same event records less their timestamps, the same spans and Chrome
trace, ``prometheus_text`` byte-equal on the same snapshot, the same
vitals keys and trend transitions, and a live ``/metrics`` scrape of a
CPU service equal to its snapshot. Host logic: held exact."""

import json
import urllib.request

import numpy as np
import pytest
import torch

from porqua_tpu.obs import events as jevents
from porqua_tpu.obs import exposition as jexposition
from porqua_tpu.obs import trace as jtrace
from porqua_tpu.obs import vitals as jvitals
from porqua_tpu.obs.report import coverage_stats as jax_coverage_stats
from porqua_tpu.serve.metrics import COUNTERS as JAX_COUNTERS

import porqua_tpu_torch as pt
from porqua_tpu_torch import obs
from porqua_tpu_torch.obs import events, exposition, trace, vitals
from porqua_tpu_torch.serve import ServeMetrics, SolveService
from porqua_tpu_torch.serve.metrics import COUNTERS
from tests.test_torch_serve import TIMEOUT, grid_requests, port_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _stamp_free(e):
    return {k: v for k, v in e.items() if k not in ("t", "ts")}


def drive_bus(mod, path=None):
    bus = mod.EventBus(capacity=4, path=path)
    seen = []
    bus.add_listener(lambda e: seen.append(e["kind"]))
    bus.add_listener(lambda e: 1 / 0)          # a broken listener
    for i in range(6):
        bus.emit("compile", "warn" if i % 2 else "info", trace_id=f"t{i}",
                 bucket="32x8", slots=i)
    bus.emit("odd", "no-such-severity", detail={"a": [1, 2]})
    return bus, seen


def test_event_bus_matches_jax(tmp_path):
    jbus, jseen = drive_bus(jevents, str(tmp_path / "j.jsonl"))
    tbus, tseen = drive_bus(events, str(tmp_path / "t.jsonl"))
    assert tseen == jseen
    assert (tbus.dropped, tbus.sink_failures, tbus.listener_failures) == (
        jbus.dropped, jbus.sink_failures, jbus.listener_failures)
    assert [_stamp_free(e) for e in tbus.events()] == [
        _stamp_free(e) for e in jbus.events()]
    assert [_stamp_free(e) for e in tbus.events("compile")] == [
        _stamp_free(e) for e in jbus.events("compile")]
    jbus.close()
    tbus.close()
    got = events.load_jsonl(str(tmp_path / "t.jsonl"))
    want = jevents.load_jsonl(str(tmp_path / "j.jsonl"))
    assert [_stamp_free(e) for e in got] == [_stamp_free(e) for e in want]
    assert len(got) == 7


def drive_spans(mod):
    rec = mod.SpanRecorder(capacity=5)
    a0 = rec.anchor_mono
    ids = [rec.new_trace() for _ in range(2)]
    for k, tid in enumerate(ids):
        base = a0 + 1.0 + k
        rec.record("submit", base, base + 0.001, trace_id=tid, n=24)
        rec.record("queue_wait", base + 0.001, base + 0.004, trace_id=tid)
        rec.record("solve", base + 0.004, base + 0.010, trace_id=tid,
                   slots=4)
    return rec, ids


def test_spans_and_chrome_trace_match_jax():
    jrec, jids = drive_spans(jtrace)
    trec, tids = drive_spans(trace)
    assert trec.dropped == jrec.dropped == 1
    strip = lambda s: (s.name, s.trace_id is not None, s.args)
    assert [strip(s) for s in trec.spans()] == [strip(s)
                                                for s in jrec.spans()]
    assert [round(s.duration, 9) for s in trec.spans()] == [
        round(s.duration, 9) for s in jrec.spans()]
    tt, jt = trec.chrome_trace(), jrec.chrome_trace()
    assert len(tt["traceEvents"]) == len(jt["traceEvents"])
    for a, b in zip(tt["traceEvents"], jt["traceEvents"]):
        assert {k: v for k, v in a.items() if k != "args"} == {
            k: v for k, v in b.items() if k != "args"}
    assert trace.coverage_stats(tt)["n_traces"] == jax_coverage_stats(
        jt)["n_traces"] == 2
    assert trace.coverage_stats(tt)["cover_min"] == pytest.approx(
        jax_coverage_stats(jt)["cover_min"])


def _snapshot():
    m = ServeMetrics()
    m.set_device("cuda:0", degraded=False)
    for i in range(40):
        m.inc("submitted")
        m.inc("completed")
        m.inc_tenant("fund \"a\"\n" if i % 3 else "b", "completed")
        m.observe_latency(1e-3 * (1 + i % 7))
        m.observe_tenant_latency("b", 2e-3)
        m.observe_queue_wait(1e-4 * i)
        m.observe_status(1 if i % 5 else 2)
        m.observe_request_iters(25 * (1 + i % 3))
    m.observe_batch(8, 8, 0.01, 40.0)
    m.inc("routed_pdhg", 3)
    return m


def test_prometheus_text_is_byte_equal():
    m = _snapshot()
    snap = m.snapshot()
    kw = dict(histograms=m.histograms(),
              extra_counters={"events_dropped": 2, "harvest_records": 40},
              extra_gauges={"slo_burn_rate": 0.5, "vitals_rss_bytes": 1e9},
              labeled_gauges={**m.tenant_labeled_gauges(),
                              "bucket_compiles_total": [
                                  ({"bucket": "512x8"}, 9)]})
    got = exposition.prometheus_text(snap, **kw)
    assert got == jexposition.prometheus_text(snap, **kw)
    assert 'tenant="fund \\"a\\"\\n"' in got
    assert COUNTERS == JAX_COUNTERS


def test_vitals_keys_and_trend_match_jax():
    assert set(vitals.process_vitals(queue_depth=3)) == set(
        jvitals.process_vitals(queue_depth=3))
    rss = list(np.linspace(1e8, 1e8, 25)) + list(np.linspace(1e8, 4e8, 20))
    tt = vitals.VitalsTrend(min_samples=5)
    jt = jvitals.VitalsTrend(min_samples=5)
    got, want = [], []
    for v in rss + [1e8] * 30:
        got += tt.observe("w0", {"rss_bytes": v, "threads": 4})
        want += jt.observe("w0", {"rss_bytes": v, "threads": 4})
    assert [_stamp_free(e) for e in got] == [_stamp_free(e) for e in want]
    assert [e["state"] for e in got] == ["firing", "resolved"]
    assert tt.counters() == jt.counters()
    assert tt.status() == jt.status()


def test_live_metrics_scrape_of_a_cpu_service():
    """``start_http`` on a routed, observed CPU service: ``/metrics``
    carries every counter of the snapshot, ``/healthz`` the service
    state, and ``vitals()`` the process sample."""
    _, treq = grid_requests("dense", n=4)
    svc = SolveService(port_params("dense"), max_batch=4, device="cpu",
                       obs=obs.Observability(),
                       harvest=obs.HarvestSink(None),
                       slo=obs.SLOEngine(obs.default_slos()))
    with svc:
        svc.prewarm(treq[0])
        for q in treq:
            assert svc.solve(q, timeout=TIMEOUT).found
        port = svc.start_http()
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        snap = svc.snapshot()
        keys = set(svc.vitals())
    prom = dict(line.split(" ", 1) for line in text.splitlines()
                if line.startswith("porqua_serve_") and "{" not in line)
    for key in COUNTERS:
        assert float(prom[f"porqua_serve_{key}"]) == float(snap[key]), key
    assert float(prom["porqua_serve_harvest_records"]) == 4
    assert "porqua_serve_slo_burn_rate" in text or "slo_" in text
    assert health["ok"] and health["device"] == "cpu:0"
    assert health["harvest_records"] == 4 and "slo" in health
    assert keys == {"t", "rss_bytes", "open_fds", "threads", "queue_depth"}
