"""The port's readers under ``porqua_tpu_torch/cli/`` against the JAX
package's scripts.

The same inputs, drawn from a numpy seed here, are written as the files
the serving stack writes (a harvest dataset, an event log, a Chrome
trace, a metrics snapshot, CostRecords, a fleet report, a tenant report,
a flight bundle) by the JAX package's writers and by the port's; each
file goes through the JAX script's ``main`` (loaded from ``scripts/``)
and through the twin's, and the rendered text must be equal character
for character, the ``--json``/``--out`` payloads equal with floats
within 1e-12 relative. Every twin's ``--selftest`` passes, and every
twin's ``--help`` names the JAX script's options (plus ``--device``
where the twin runs anything on a device).
"""

import ast
import gzip
import importlib
import importlib.util
import json
import math
import os
import re
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")

#: The twins, each with whether it takes ``--device``.
TWINS = {
    "incident_report": False,
    "harvest_report": False,
    "obs_report": False,
    "roofline_report": False,
    "run_checks": True,
    "hlolint_report": True,
    "serve_loadgen": True,
    "tsan_smoke": True,
    "slo_smoke": True,
}

H100 = "NVIDIA H100 80GB HBM3"


def jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module."""
    key = f"_jax_script_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def twin(name):
    return importlib.import_module(f"porqua_tpu_torch.cli.{name}")


def run_jax(name, argv, capsys, monkeypatch):
    mod = jax_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    rc = mod.main()
    return rc, capsys.readouterr().out


def run_port(name, argv, capsys):
    capsys.readouterr()
    rc = twin(name).main(list(argv))
    return rc, capsys.readouterr().out


def assert_close(a, b, path="$"):
    """Equal JSON trees, floats within 1e-12 relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        else:
            assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# the two packages' writers
# ---------------------------------------------------------------------------

class Pkg:
    """One package's writers, by name: ``jax`` or ``port``."""

    def __init__(self, which):
        self.which = which
        if which == "jax":
            from porqua_tpu import obs
            from porqua_tpu.obs import devprof, flight, harvest
            from porqua_tpu.qp.solve import SolverParams
            from porqua_tpu.serve.metrics import ServeMetrics
        else:
            from porqua_tpu_torch import obs
            from porqua_tpu_torch.obs import devprof, flight, harvest
            from porqua_tpu_torch.qp.solve import SolverParams
            from porqua_tpu_torch.serve.metrics import ServeMetrics
        self.obs, self.devprof, self.flight = obs, devprof, flight
        self.harvest, self.SolverParams = harvest, SolverParams
        self.ServeMetrics = ServeMetrics


def harvest_records(pkg, seed):
    """A seeded dataset over three tenants, two buckets, two tolerances,
    three backends (served and shadow records), warm and cold starts,
    ring trajectories and a calibration audit chain."""
    rng = np.random.default_rng(seed)
    sr, P = pkg.harvest.solve_record, pkg.SolverParams
    out = []
    for i in range(48):
        bucket = ("32x4", "512x8")[int(rng.integers(2))]
        eps = (1e-3, 1e-5)[int(rng.integers(2))]
        method = ("admm", "pdhg", "napg")[int(rng.integers(3))]
        shadow = method != "admm"
        iters = int(25 * rng.integers(1, 40))
        k = int(rng.integers(1, 6))
        warm = bool(rng.integers(2))
        out.append(sr(
            "serve.shadow" if shadow else ("serve", "batch")[i % 2],
            int(rng.integers(8, 500)), int(rng.integers(1, 9)),
            int(rng.choice([1, 1, 1, 2])), iters,
            float(10.0 ** rng.uniform(-7, -2)),
            float(10.0 ** rng.uniform(-7, -2)), float(rng.normal()),
            params=P(eps_abs=eps, eps_rel=eps, method=method),
            bucket=bucket, warm=warm,
            warm_src="explicit" if warm else None,
            solve_s=float(rng.uniform(1e-4, 5e-3)),
            tenant=(None, "fund-a", "fund-b")[int(rng.integers(3))],
            segments=iters // 25, batch=int(rng.integers(1, 64)),
            ring={"iters": [25 * (j + 1) for j in range(k)],
                  "prim_res": [float(x) for x in 10.0 ** -rng.uniform(
                      1, 6, k)],
                  "dual_res": [float(x) for x in 10.0 ** -rng.uniform(
                      1, 6, k)],
                  "rho": [0.1] * k} if i % 3 == 0 else None,
            **({"shadow_of": "admm",
                "delta_iters": int(rng.integers(-20, 20)),
                "agree": True} if shadow else {})))
    out.append({"v": 1, "source": "calibration.audit", "t": 10.0,
                "action": "promote", "table_version": 1,
                "table": {"32x4@1e-03": "pdhg"}, "prior_table": {},
                "diff": {"32x4@1e-03": {
                    "old": "admm", "new": "pdhg",
                    "evidence": {"shadow": {
                        "samples": int(rng.integers(8, 32)),
                        "win_rate": float(rng.uniform(0.6, 1.0))}}}}})
    out.append({"v": 1, "source": "calibration.audit", "t": 20.0,
                "action": "rollback", "table_version": 2, "table": {},
                "prior_table": {"32x4@1e-03": "pdhg"}, "diff": {},
                "reason": "anomaly_fired +1 since promotion"})
    return out


def write_harvest(pkg, path, seed):
    with pkg.harvest.HarvestSink(path) as sink:
        for rec in harvest_records(pkg, seed):
            sink.emit(rec)
    return path


def cost_records(seed):
    rng = np.random.default_rng(seed)
    out = []
    for entry, kind in (("solve", "solve"), ("step", "continuous"),
                        ("admit", "continuous"),
                        ("finalize", "continuous")):
        for slots in (8, 64, 256):
            flops = float(10.0 ** rng.uniform(7, 13))
            out.append({
                "v": 1, "t": 0.0, "kind": kind, "entry": entry,
                "bucket": ("32x8", "512x8")[int(rng.integers(2))],
                "slots": slots, "dtype": "<f4", "device": "cuda:0",
                "compile_s": float(rng.uniform(0.1, 3.0)), "flops": flops,
                "bytes_accessed": float(10.0 ** rng.uniform(6, 10)),
                "peak_bytes": float(10.0 ** rng.uniform(6, 9)),
                "hlo_hash": f"{int(rng.integers(1 << 62)):016x}"})
    out.append({"v": 1, "t": 0.0, "kind": "solve", "entry": "solve",
                "bucket": "8x4", "slots": 8, "dtype": "<f4",
                "device": "cuda:0", "flops": None, "bytes_accessed": None})
    return out


def observed_run(pkg, seed):
    """A seeded traced run through the package's own recorders: spans
    of eight requests, convergence rings, faults and recovery, SLO and
    anomaly transitions, a calibration cycle."""
    rng = np.random.default_rng(seed)
    o = pkg.obs.Observability()
    for i in range(8):
        t0 = 10.0 + float(rng.uniform(0, 0.1))
        tid = o.spans.new_trace()
        edges = np.cumsum([t0, *rng.uniform(1e-4, 4e-3, 5)])
        for name, a, b in zip(
                ("submit", "queue_wait", "assemble", "solve", "resolve"),
                edges[:-1], edges[1:]):
            o.spans.record(name, float(a), float(b), trace_id=tid,
                           bucket="32x8")
        k = i + 2
        o.events.emit("convergence_ring", trace_id=tid, iters_final=25 * k,
                      iters=[25 * (j + 1) for j in range(k)],
                      prim_res=[float(x) for x in 10.0 ** -rng.uniform(
                          1, 6, k)],
                      dual_res=[float(x) for x in 10.0 ** -rng.uniform(
                          1, 6, k)],
                      rho=[0.1] * k)
    o.events.emit("compile", bucket="32x8", slots=8,
                  seconds=float(rng.uniform(0.1, 2)))
    o.events.emit("breaker_open", "error", primary="cuda:0",
                  fallback="cpu:0", failures=2)
    for _ in range(int(rng.integers(1, 4))):
        o.events.emit("fault_injected", "warn", seam="serve.dispatch",
                      fault_kind="device_lost", scenario="device_lost")
    o.events.emit("retry_scheduled", "warn", request_id="r1", attempt=2,
                  delay_s=float(rng.uniform(0, 0.1)),
                  error="SolveError: injected device loss")
    o.events.emit("retry_giveup", "error", request_id="r2",
                  reason="deadline", attempts=2, hedges=0,
                  error="DeadlineExpired: budget spent")
    o.events.emit("slo_alert", "error", slo="availability", rule="fast",
                  state="firing", burn_short=float(rng.uniform(15, 30)),
                  burn_long=float(rng.uniform(14.5, 20)), threshold=14.4,
                  short_s=300.0, long_s=3600.0, rule_severity="page")
    o.events.emit("convergence_anomaly", "warn", state="firing",
                  bucket="32x8", eps=1e-3,
                  ewma_iters=float(rng.uniform(500, 900)),
                  iters_band=300.0, ewma_waste=0.51, waste_band=0.35, n=12)
    o.events.emit("breaker_close", "info", primary="cuda:0")
    diff = {"32x8@1e-03": {"old": "admm", "new": "pdhg"}}
    o.events.emit("route_reseed", "info", state="candidate",
                  table_version=0, n_cells=1, diff=diff)
    o.events.emit("route_reseed", "info", state="promoted",
                  table_version=1, n_cells=1, diff=diff,
                  table={"32x8@1e-03": "pdhg"})
    o.events.emit("route_rollback", "error",
                  reason="anomaly_fired +1 since promotion",
                  table_version=2, restored_table={}, diff=diff)
    return o


def fleet_report(seed):
    rng = np.random.default_rng(seed)
    rows = [{"worker": f"w{i}", "status": "ok",
             "completed": int(rng.integers(500, 2000)),
             "failed": int(rng.integers(0, 3)),
             "throughput_solves_per_s": float(rng.uniform(100, 300)),
             "latency_p50_ms": float(rng.uniform(2, 6)),
             "latency_p99_ms": float(rng.uniform(8, 14)),
             "recompiles_after_warmup": 0,
             "vitals": {"rss_bytes": float(rng.uniform(4e8, 6e8)),
                        "open_fds": 40, "threads": 12, "queue_depth": 3}}
            for i in range(2)]
    rows.append({"worker": "w2", "status": "lost", "completed": 400,
                 "failed": 0})
    return {
        "workers": 3, "workers_lost": ["w2"], "worker_lost_bundles": 1,
        "reconciled": True,
        "reconciliation": {"completed_sample_equals_rows": True,
                           "harvest_equals_completed": True},
        "rows": rows,
        "fleet": {"completed": sum(r["completed"] for r in rows),
                  "failed": 2, "harvest_records": 2380,
                  "throughput_solves_per_s": float(rng.uniform(400, 600))},
        "rollups_tail": [{"completed": int(rng.integers(400, 500)),
                          "span_s": 30.0} for _ in range(6)],
        "rollup_windows": 20,
        "slo": {"slos": {"availability": {"compliance": float(
            rng.uniform(0.99, 1.0))}, "latency": {"compliance": 0.991}},
            "firing": [], "alerts_fired": 1},
        "vitals_anomalous": ["w1/rss_bytes"],
    }


def tenant_report(seed):
    rng = np.random.default_rng(seed)
    tenants = {}
    for name in ("alpha", "beta", "gamma"):
        sub = int(rng.integers(300, 2000))
        rej = int(rng.integers(0, sub // 2)) if name == "gamma" else 0
        tenants[name] = {"submitted": sub, "completed": sub - rej,
                         "rejected": rej, "expired": 0, "failed": 0,
                         "latency_p50_ms": float(rng.uniform(3, 6)),
                         "latency_p99_ms": float(rng.uniform(9, 30))}
    return {"tenants": tenants,
            "tenant_slo": {"alpha": {"alerts_fired": 0},
                           "beta": {"alerts_fired": 0},
                           "gamma": {"alerts_fired": 1}},
            "tenant_fairness": {
                "offenders": ["gamma"], "tenants": 3,
                "quiet_p99_ratio": float(rng.uniform(1.0, 1.3)),
                "victim_shed_share": 0.0, "offender_alerts": 1,
                "nonoffender_alerts": 0, "harvest_reconciled": 1}}


def flight_bundle(pkg, out_dir, seed):
    """One ``breaker_open`` bundle from the package's FlightRecorder,
    fed seeded solves, snapshots, SLO state and events."""
    rng = np.random.default_rng(seed)
    metrics = pkg.ServeMetrics()
    o = pkg.obs.Observability()
    slo = pkg.obs.SLOEngine(pkg.obs.default_slos())
    rec = pkg.flight.FlightRecorder(out_dir=out_dir, debounce_s=5.0)
    rec.attach(metrics=metrics, obs=o, params="SolverParams(seeded)",
               slo=slo)
    o.events.add_listener(rec.on_event)
    for i in range(12):
        metrics.inc("completed")
        metrics.observe_latency(float(rng.uniform(1e-3, 2e-2)))
        rec.record_solve({"v": 1, "status": int(rng.choice([1, 1, 2])),
                          "iters": int(25 * rng.integers(1, 40)),
                          "bucket": "32x8"})
        if i % 4 == 3:
            rec.record_snapshot(metrics.snapshot())
    metrics.inc("dispatch_failures", 2)
    o.events.emit("fault_injected", "warn", seam="serve.dispatch",
                  fault_kind="device_lost", scenario="device_lost")
    o.events.emit("probe_failure", "warn", device="cuda:0",
                  timeout_s=float(rng.uniform(1, 30)))
    o.events.emit("breaker_open", "error", primary="cuda:0",
                  fallback="cpu:0", failures=2)
    (path,) = rec.bundles()
    return path


# ---------------------------------------------------------------------------
# renderer parity
# ---------------------------------------------------------------------------

@pytest.fixture(params=["jax", "port"])
def writer(request):
    return Pkg(request.param)


def test_incident_report_renders_the_same(writer, tmp_path, capsys,
                                          monkeypatch):
    path = flight_bundle(writer, str(tmp_path), seed=3)
    rc_j, out_j = run_jax("incident_report", [path], capsys, monkeypatch)
    rc_p, out_p = run_port("incident_report", [path], capsys)
    assert rc_j == rc_p == 0
    assert out_p == out_j
    for needle in ("trigger: breaker_open", "breaker history",
                   "slo status", "recent solves: 12 records",
                   "trajectory: 3 snapshots"):
        assert needle in out_p, needle
    # The renderer itself, on the loaded dict.
    bundle = Pkg("port").flight.load_bundle(path)
    assert twin("incident_report").render_bundle(bundle) == \
        jax_script("incident_report").render_bundle(bundle)


def test_harvest_report_renders_the_same(writer, tmp_path, capsys,
                                         monkeypatch):
    path = write_harvest(writer, str(tmp_path / "h.jsonl.gz"), seed=11)
    other = write_harvest(Pkg("port" if writer.which == "jax" else "jax"),
                          str(tmp_path / "o.jsonl"), seed=11)
    texts = []
    for argv in ([path], [path, other]):
        rc_j, out_j = run_jax("harvest_report", argv, capsys, monkeypatch)
        rc_p, out_p = run_port("harvest_report", argv, capsys)
        assert rc_j == rc_p == 0
        assert out_p == out_j
        texts.append(out_p)
    for needle in ("tenants: default", "fund-a", "solver comparison",
                   "calibration audit", "admm->pdhg",
                   "active table v2: (empty)"):
        assert needle in texts[0], needle
    # Both packages write the same dataset: the report of the two files
    # together counts every solve record twice (the audit records are
    # annotations, not records).
    assert "harvest dataset: 48 records" in texts[0]
    assert "harvest dataset: 96 records" in texts[1]
    # --json and --out: the same aggregate.
    jo, po = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    rc_j, out_j = run_jax("harvest_report", [path, "--json", "--out", jo],
                          capsys, monkeypatch)
    rc_p, out_p = run_port("harvest_report", [path, "--json", "--out", po],
                           capsys)
    assert rc_j == rc_p == 0
    assert_close(json.loads(out_p), json.loads(out_j))
    with open(jo) as f, open(po) as g:
        assert_close(json.load(g), json.load(f))


def test_harvest_report_reads_schema_v1(tmp_path, capsys, monkeypatch):
    """A v1 dataset (no tenant field) reads back on the legacy tenant
    lane in both packages."""
    records = harvest_records(Pkg("port"), seed=5)
    path = str(tmp_path / "v1.jsonl.gz")
    with gzip.open(path, "wt") as f:
        for rec in records:
            rec = {k: v for k, v in rec.items() if k != "tenant"}
            f.write(json.dumps(dict(rec, v=1)) + "\n")
    rc_j, out_j = run_jax("harvest_report", [path], capsys, monkeypatch)
    rc_p, out_p = run_port("harvest_report", [path], capsys)
    assert rc_j == rc_p == 0 and out_p == out_j
    assert "tenants: (pre-tenant) x48" in out_p


def test_obs_report_renders_the_same(writer, tmp_path, capsys, monkeypatch):
    o = observed_run(writer, seed=7)
    d = tmp_path
    trace, events = str(d / "trace.json"), str(d / "events.jsonl")
    o.write(trace_path=trace, events_path=events)
    metrics = writer.ServeMetrics()
    rng = np.random.default_rng(7)
    for _ in range(20):
        metrics.inc("completed")
        metrics.observe_latency(float(rng.uniform(1e-3, 3e-2)))
    snaps = str(d / "serve.jsonl")
    metrics.write_jsonl(snaps)
    metrics.write_jsonl(snaps)
    harvest = write_harvest(writer, str(d / "h.jsonl.gz"), seed=13)
    costs = str(d / "costs.jsonl.gz")
    assert writer.devprof.write_cost_records(costs, cost_records(17)) == 13
    fleet, tenants = str(d / "fleet.json"), str(d / "tenants.json")
    with open(fleet, "w") as f:
        json.dump(fleet_report(19), f)
    with open(tenants, "w") as f:
        json.dump(tenant_report(23), f)
    argv = ["--trace", trace, "--events", events, "--metrics", snaps,
            "--harvest", harvest, "--costs", costs, "--fleet", fleet,
            "--tenants", tenants]
    rc_j, out_j = run_jax("obs_report", argv, capsys, monkeypatch)
    rc_p, out_p = run_port("obs_report", argv, capsys)
    assert rc_j == rc_p == 0
    assert out_p == out_j
    for needle in ("stage waterfall", "span coverage", "convergence rings",
                   "faults / recovery", "slo / alert timeline",
                   "calibration timeline", "harvest convergence analytics",
                   "device cost / memory (13 CostRecords)",
                   "fleet workers (3)", "tenants (3)",
                   "latency / throughput"):
        assert needle in out_p, needle
    # Each input alone renders the same too.
    for i in range(0, len(argv), 2):
        rc_j, out_j = run_jax("obs_report", argv[i:i + 2], capsys,
                              monkeypatch)
        rc_p, out_p = run_port("obs_report", argv[i:i + 2], capsys)
        assert rc_j == rc_p == 0 and out_p == out_j, argv[i]


def test_roofline_report_renders_the_same(writer, tmp_path, capsys,
                                          monkeypatch):
    costs = str(tmp_path / "costs.jsonl")
    writer.devprof.write_cost_records(costs, cost_records(29))
    report = str(tmp_path / "report.json")
    with open(report, "w") as f:
        json.dump({"profile_stages": {"serve/segment_step": 2.5,
                                      "serve/admit": 0.125,
                                      "serve/finalize": 0.25,
                                      "serve/solve_batch": 0.75}}, f)
    jo, po = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    base = ["--costs", costs, "--report", report, "--top", "3",
            "--device-kind", ""]
    rc_j, out_j = run_jax("roofline_report", base + ["--out", jo], capsys,
                          monkeypatch)
    rc_p, out_p = run_port("roofline_report", base + ["--out", po], capsys)
    assert rc_j == rc_p == 0
    assert out_p.replace(po, jo) == out_j
    with open(jo) as f, open(po) as g:
        want, got = json.load(f), json.load(g)
    # The verdict's wall-clock stamp is the one field that may differ.
    assert abs(want.pop("t") - got.pop("t")) < 60.0
    assert_close(got, want)
    assert "  device " not in out_p and "ridge" not in out_p
    # The card's name classifies against the port's peaks table.
    from porqua_tpu_torch.profiling import device_peaks

    rc, out = run_port("roofline_report", ["--costs", costs,
                                           "--device-kind", H100,
                                           "--out", po], capsys)
    assert rc == 0
    with open(po) as f:
        verdict = json.load(f)
    flops, bw = device_peaks(H100)
    assert verdict["ridge_flops_per_byte"] == pytest.approx(flops / bw)
    assert f"device {H100}, ridge {flops / bw:.1f} flops/byte" in out
    for row in verdict["ranked"]:
        if row.get("arithmetic_intensity") is not None:
            want = ("memory" if row["arithmetic_intensity"]
                    < flops / bw else "compute")
            assert row["bound"] == want, row
        else:
            assert "bound" not in row
    # A kind the table does not know gets no classification.
    rc, out = run_port("roofline_report", ["--costs", costs,
                                           "--device-kind", "TPU v5 lite",
                                           "--out", po], capsys)
    with open(po) as f:
        verdict = json.load(f)
    assert rc == 0 and verdict["ridge_flops_per_byte"] is None
    assert all("bound" not in r for r in verdict["ranked"])


# ---------------------------------------------------------------------------
# selftests, help, imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,flag", [
    ("incident_report", "--selftest"), ("harvest_report", "--selftest"),
    ("obs_report", "--selftest"), ("roofline_report", "--selftest"),
    ("hlolint_report", "--selftest"),
    ("serve_loadgen", "--workloads-selftest")])
def test_selftest_passes(name, flag, capsys):
    rc, out = run_port(name, [flag], capsys)
    assert rc == 0
    assert out.rstrip().endswith("selftest: ok")


def jax_options(name):
    """The ``--`` options a JAX script's parser declares (read from its
    source: running its ``--help`` would import the script's plane)."""
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    opts = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            opts |= {a.value for a in node.args
                     if isinstance(a, ast.Constant)
                     and str(a.value).startswith("--")}
    return opts


@pytest.mark.parametrize("name", sorted(TWINS))
def test_help_names_the_jax_scripts_options(name, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        twin(name).main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    opts = set(re.findall(r"^  (?:-\w+, )?(--[\w-]+)", text, re.M)) - \
        {"--help"}
    want = jax_options(name) | ({"--device"} if TWINS[name] else set())
    assert opts == want
    if TWINS[name]:
        # The one option the twin adds comes last.
        assert re.findall(r"^  (--[\w-]+)", text, re.M)[-1] == "--device"


def test_twins_import_no_jax_package_or_script():
    scripts = {s[:-3] for s in os.listdir(SCRIPTS) if s.endswith(".py")}
    for name in TWINS:
        with open(os.path.join(ROOT, "porqua_tpu_torch", "cli",
                               f"{name}.py")) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "porqua_tpu",
                                   "scripts", *scripts), (name, m)
        assert "sys.path" not in ast.unparse(tree), name
        assert "JAX_PLATFORMS" not in ast.unparse(tree), name
