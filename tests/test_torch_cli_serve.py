"""The port's serving and analysis tools under ``porqua_tpu_torch/cli/``
run in-process on the CPU (``--device cpu``).

* ``serve_loadgen`` prints one JSON report line whose keys are the JAX
  script's at the same size and flags, and its artifacts render through
  the port's readers and the JAX scripts alike, to the same text.
* ``tsan_smoke`` passes with the sanitizer live (its locks built and
  taken), and leaves ``PORQUA_TSAN`` as it found it; ``slo_smoke``
  passes.
* ``run_checks`` finds nothing in the port, ``cli/`` included, and one
  finding per AST rule in a seeded tree.
* ``hlolint_report`` holds two programs against the committed op
  baseline (clean, no flips), and a harvest into a new baseline
  round-trips without touching the committed one.
* Every tool that runs anything on a device raises without a card
  unless it is given ``--device cpu``.
"""

import hashlib
import json
import os
import re
import textwrap

import pytest
import torch

from tests.test_torch_cli import run_jax, run_port, twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "porqua_tpu_torch")

#: The report keys of ``scripts/serve_loadgen.py`` at LOADGEN_FLAGS
#: (taken from the JAX script's run: ``test_loadgen_keys_are_the_jax_
#: scripts`` holds them to it).
LOADGEN_KEYS = sorted([
    "batches", "chaos", "continuous", "cost_out", "cost_records",
    "cost_summary", "degraded", "device", "dropped_arrivals", "elapsed_s",
    "error_sample", "errors", "events_out", "faults_injected",
    "harvest_out", "harvest_records", "harvest_records_measured",
    "harvest_write_failures", "hedges_fired", "hedges_won",
    "incident_bundle_paths", "incident_bundles",
    "incident_dumps_suppressed", "iters_mean", "lane_segments",
    "lanes_retired_budget", "latency_mean_ms", "latency_p50_ms",
    "latency_p99_ms", "max_batch", "max_wait_ms", "mode", "n_assets",
    "n_requests", "occupancy_mean", "prewarm_compiles", "profile_stages",
    "queue_depth_max", "rate", "recompiles_after_warmup",
    "resumed_requests", "retries", "retry_giveups",
    "segment_occupancy_mean", "slo", "solved", "span_cover_median",
    "span_cover_min", "spans_dropped", "status_counts",
    "throughput_solves_per_s", "trace_events", "trace_out",
    "validation_failures", "warm_hits", "wasted_lane_fraction",
    "workload"])

LOADGEN_FLAGS = ["--workload", "grid", "--requests", "64", "--max-batch",
                 "16", "--rings", "4", "--slo"]


def artifact_flags(d):
    return ["--jsonl", os.path.join(d, "serve.jsonl"),
            "--trace-out", os.path.join(d, "trace.json"),
            "--events-out", os.path.join(d, "events.jsonl"),
            "--harvest-out", os.path.join(d, "harvest.jsonl"),
            "--cost-out", os.path.join(d, "costs.jsonl"),
            "--flight-out", os.path.join(d, "flight")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The op baseline is recorded on one thread (its fingerprints hold
    # bit for bit only in one summation order).
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# serve_loadgen and its readers
# ---------------------------------------------------------------------------

def without_measured(text):
    """The report without its measured-vs-model block."""
    out, skip = [], False
    for line in text.splitlines():
        if line.startswith("  measured-vs-model"):
            skip = True
            continue
        if skip and line.startswith("    "):
            continue
        skip = False
        out.append(line)
    return "\n".join(out)


def assert_bundles_are_latency_alerts(report, flight_dir, events_path):
    """The run's incident bundles are exactly its latency alerts.

    A fault-free run answers every request and validates every answer,
    so availability and wrong-answers hold at full compliance and never
    alert. The latency SLO reads wall-clock time: on a loaded host more
    than the budget's share of requests can take longer than the target,
    and its burn-rate rules then fire, each firing alert one trigger of
    the flight recorder, which dumps the first and debounces the rest
    (30 s). The report's counters and the event log are read while the
    dispatch thread may still be emitting its last evaluation's alert;
    once the run has returned its service has stopped, so the recorder
    has seen every trigger: one bundle on disk if any alert fired, none
    otherwise, each a firing latency alert whose burns crossed its
    threshold."""
    from porqua_tpu_torch.obs.flight import load_bundle

    slo = report["slo"]["slos"]
    for name in ("availability", "wrong_answers"):
        assert slo[name]["compliance"] == 1.0, (name, slo[name])
        assert all(a["state"] == "inactive"
                   for a in slo[name]["alerts"].values()), (name, slo[name])
    fired = report["slo"]["alerts_fired"]
    assert sorted(report["slo"]["firing"]) == sorted(
        f"latency/{rule}" for rule, a in slo["latency"]["alerts"].items()
        if a["state"] == "firing")
    assert len(report["slo"]["firing"]) == fired
    for a in slo["latency"]["alerts"].values():
        if a["state"] == "firing":
            assert a["burn_short"] >= a["threshold"], a
            assert a["burn_long"] >= a["threshold"], a
    if slo["latency"]["compliance"] == 1.0:
        assert fired == 0
    with open(events_path) as f:
        alerts = [e for e in map(json.loads, f) if e["kind"] == "slo_alert"]
    assert len(alerts) <= fired
    assert all((e["slo"], e["state"]) == ("latency", "firing")
               for e in alerts), alerts
    assert (report["incident_bundles"]
            + report["incident_dumps_suppressed"]) <= fired
    names = os.listdir(flight_dir) if os.path.isdir(flight_dir) else []
    paths = sorted(os.path.join(flight_dir, n) for n in names)
    assert len(paths) == min(fired, 1)
    assert report["incident_bundles"] == len(
        report["incident_bundle_paths"])
    assert set(report["incident_bundle_paths"]) <= set(paths)
    for path in paths:
        trigger = load_bundle(path)["trigger"]
        assert (trigger["kind"], trigger["slo"], trigger["state"]) == (
            "slo_alert", "latency", "firing"), trigger


def test_loadgen_report_line_and_its_artifacts(tmp_path, capsys,
                                               monkeypatch):
    d = str(tmp_path)
    rc, out = run_port("serve_loadgen", LOADGEN_FLAGS + artifact_flags(d)
                       + ["--device", "cpu"], capsys)
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert sorted(report) == LOADGEN_KEYS
    assert report["device"] == "cpu:0" and report["workload"] == "grid"
    assert report["errors"] == 0 and report["recompiles_after_warmup"] == 0
    assert report["harvest_records_measured"] == 64
    assert report["solved"] == 64
    assert_bundles_are_latency_alerts(report, os.path.join(d, "flight"),
                                      os.path.join(d, "events.jsonl"))
    # The artifacts through the port's readers and the JAX scripts.
    rep = os.path.join(d, "report.json")
    with open(rep, "w") as f:
        json.dump(report, f)
    for name, argv in (
            ("obs_report", ["--trace", os.path.join(d, "trace.json"),
                            "--events", os.path.join(d, "events.jsonl"),
                            "--metrics", os.path.join(d, "serve.jsonl"),
                            "--harvest", os.path.join(d, "harvest.jsonl"),
                            "--costs", os.path.join(d, "costs.jsonl")]),
            ("harvest_report", [os.path.join(d, "harvest.jsonl")]),
            ("roofline_report", ["--costs", os.path.join(d, "costs.jsonl"),
                                 "--report", rep])):
        rc_p, out_p = run_port(name, argv, capsys)
        rc_j, out_j = run_jax(name, argv, capsys, monkeypatch)
        assert rc_p == rc_j == 0, name
        if name == "obs_report":
            # The one section that differs by design: the port's
            # counted profiles (cost_source "torch") are measured ones;
            # the JAX script counts only XLA's.
            assert "measured-vs-model (per bucket" in out_p
            assert "no harvest records with XLA-measured" in out_j
            out_p, out_j = without_measured(out_p), without_measured(out_j)
        assert out_p == out_j, name


@pytest.mark.slow
def test_loadgen_keys_are_the_jax_scripts(tmp_path, capsys, monkeypatch):
    """The JAX script at the same size and flags (its run takes the
    XLA-CPU compiles of its bucket ladder)."""
    rc, out = run_jax("serve_loadgen", LOADGEN_FLAGS
                      + artifact_flags(str(tmp_path)), capsys, monkeypatch)
    assert rc == 0
    assert sorted(json.loads(out.splitlines()[-1])) == LOADGEN_KEYS


# ---------------------------------------------------------------------------
# the smokes
# ---------------------------------------------------------------------------

def test_tsan_smoke_runs_with_the_sanitizer_live(capsys, monkeypatch):
    from porqua_tpu_torch.analysis import tsan

    built, taken = [], []

    class Counted(tsan.TSanLock):
        def __init__(self, name):
            super().__init__(name)
            built.append(name)

        def acquire(self, *args, **kwargs):
            taken.append(self.name)
            return super().acquire(*args, **kwargs)

    monkeypatch.setattr(tsan, "TSanLock", Counted)
    monkeypatch.delenv("PORQUA_TSAN", raising=False)
    rc, out = run_port("tsan_smoke", ["--requests", "32", "--device",
                                      "cpu"], capsys)
    assert rc == 0, out
    assert out.startswith("tsan_smoke: ") and " 0 violations" in out
    # The serve stack's locks were sanitizer locks, and were taken.
    assert {"ServeMetrics", "ExecutableCache", "DeviceHealth",
            "RetryManager", "WarmStartCache"} <= set(built), set(built)
    assert len(taken) > 100
    # The stack takes its locks one at a time (no lock is taken under
    # another), so the order graph stays empty, as the JAX package's.
    assert "order graph 0 nodes / 0 edges" in out
    assert "PORQUA_TSAN" not in os.environ
    monkeypatch.setenv("PORQUA_TSAN", "0")
    rc, out = run_port("tsan_smoke", ["--requests", "8", "--json",
                                      "--device", "cpu"], capsys)
    assert rc == 0 and os.environ["PORQUA_TSAN"] == "0"
    assert json.loads(out)["tsan"]["tsan_violations"] == []


def test_slo_smoke_passes(capsys):
    rc, out = run_port("slo_smoke", ["--device", "cpu"], capsys)
    assert rc == 0
    # The breaker's bundle, or (the latency SLO reading wall-clock time
    # on a loaded host) a latency alert's that debounced it.
    assert re.match(r"slo_smoke: ok — 1 bundle \((breaker_open|slo_alert "
                    r"latency, breaker_open debounced)\), ", out), out


@pytest.mark.parametrize("name,argv", [
    ("serve_loadgen", ["--requests", "4"]),
    ("tsan_smoke", ["--requests", "4"]),
    ("slo_smoke", []),
    ("hlolint_report", ["--labels", "serve_entry"])])
def test_device_work_needs_the_card_or_cpu(name, argv, capsys,
                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_port(name, argv, capsys)


def test_run_checks_contracts_need_the_card_or_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    assert twin("run_checks").main(["--select", "GC101"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# run_checks
# ---------------------------------------------------------------------------

def test_run_checks_port_tree_clean(capsys):
    rc, out = run_port("run_checks", ["--no-contracts", "--format", "json",
                                      "--stats"], capsys)
    payload = json.loads(out)
    assert rc == 0 and payload["count"] == 0, payload["findings"]
    assert payload["stats"]["suppressions_total"] == 0
    assert payload["stats"]["files"] > 90
    # cli/ is in the default scan.
    rc, out = run_port("run_checks", ["--no-contracts",
                                      os.path.join(PORT, "cli")], capsys)
    assert rc == 0 and out.strip() == "graftcheck: 0 findings — clean"


#: One file per AST rule, each with one violation.
SEEDED = {
    "qp/precision.py": ("GC001", """\
        def f(x):
            return x.half()
        """),
    "qp/admm.py": ("GC002", """\
        def _make_segment(qp, params):
            def segment(x):
                return x.sum().item()
            return segment
        """),
    "serve/compile.py": ("GC003", """\
        import torch

        def per_call(fn):
            return torch.compile(fn)
        """),
    "qp/debug.py": ("GC004", """\
        def f(x):
            breakpoint()
            return x
        """),
    "ops/eager.py": ("GC005", """\
        import torch

        torch.cuda.init()
        """),
    "serve/guarded.py": ("GC006", """\
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self._data = {}  # guarded-by: self._lock

            def bad(self, k, v):
                self._data[k] = v
        """),
    "serve/seam.py": ("GC007", """\
        from porqua_tpu_torch.resilience import faults as _faults

        def dispatch(batch):
            _faults.fire("serve.dispatch")
            return batch
        """),
    "serve/shared.py": ("GC008", """\
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                self._n += 1

            def bump(self):
                with self._lock:
                    self._n += 1
        """),
    "serve/inversion.py": ("GC009", """\
        from porqua_tpu_torch.analysis import tsan

        class AB:
            def __init__(self):
                self._a = tsan.lock("fxA")
                self._b = tsan.lock("fxB")

            def fwd(self):
                with self._a:
                    with self._b:
                        pass

            def rev(self):
                with self._b:
                    with self._a:
                        pass
        """),
    "serve/sleepy.py": ("GC010", """\
        import threading
        import time

        class Q:
            def __init__(self):
                self._lock = threading.Lock()

            def drain(self):
                with self._lock:
                    time.sleep(0.1)
        """),
}


def test_run_checks_one_finding_per_ast_rule(tmp_path, capsys):
    for rel, (_, src) in SEEDED.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    rc, out = run_port("run_checks", [str(tmp_path), "--no-contracts",
                                      "--format", "json"], capsys)
    assert rc == 1
    got = sorted((f["rule"], os.path.relpath(f["path"], tmp_path))
                 for f in json.loads(out)["findings"])
    assert got == sorted((rule, rel) for rel, (rule, _) in SEEDED.items())
    rc, out = run_port("run_checks", [str(tmp_path), "--no-contracts",
                                      "--select", "GC004,GC009"], capsys)
    assert rc == 1
    assert out.splitlines()[-1] == "graftcheck: 2 findings"
    assert [ln.split(": ")[1].split()[0] for ln in
            out.splitlines()[:-1]] == ["GC004", "GC009"]


# ---------------------------------------------------------------------------
# hlolint_report
# ---------------------------------------------------------------------------

LABELS = "serve_entry,continuous_step"


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_hlolint_report_against_the_committed_baseline(tmp_path, capsys):
    from porqua_tpu_torch.analysis import hlo

    out_path = str(tmp_path / "report.json")
    rc, out = run_port("hlolint_report", ["--device", "cpu", "--labels",
                                          LABELS, "--out", out_path],
                       capsys)
    assert rc == 0, out
    assert "hlolint: 2 programs harvested, 0 finding(s)" in out
    assert out.splitlines()[-2] == "hlolint: clean"
    with open(out_path) as f:
        report = json.load(f)
    assert report["fingerprints"] == {"flipped": [], "missing": [],
                                      "new": []}
    assert report["baseline_path"] == hlo.DEFAULT_BASELINE_PATH
    assert sorted(r["program"] for r in report["programs"]) == \
        sorted(LABELS.split(","))
    assert all(r["fingerprint_status"] == "ok" for r in report["programs"])


def test_hlolint_report_harvest_round_trips(tmp_path, capsys):
    from porqua_tpu_torch.analysis import hlo

    committed = _digest(hlo.DEFAULT_BASELINE_PATH)
    base = str(tmp_path / "base.json")
    rc, out = run_port("hlolint_report", ["--harvest", "--baseline", base,
                                          "--labels", LABELS, "--device",
                                          "cpu"], capsys)
    assert rc == 0
    assert out.startswith(f"baseline written to {base}: 2 programs")
    with open(base) as f:
        written = json.load(f)
    assert sorted(written["programs"]) == sorted(LABELS.split(","))
    assert written["device"] == "cpu" and written["suppressions"] == []
    part = str(tmp_path / "part.json")
    rc, out = run_port("hlolint_report", ["--baseline", base, "--labels",
                                          LABELS, "--bench-part", part,
                                          "--device", "cpu"], capsys)
    assert rc == 0 and "hlolint: clean" in out
    with open(part) as f:
        payload = json.load(f)
    assert payload["source"] == "hlolint_report"
    assert payload["config_hlo"]["programs"] == 2
    assert payload["config_hlo"]["fingerprint_flips"] == 0
    assert payload["config_hlo"]["findings_total"] == 0
    # The harvest wrote only the file it was given.
    assert _digest(hlo.DEFAULT_BASELINE_PATH) == committed
    # A flipped fingerprint fails the check and names the program.
    written["programs"]["serve_entry"]["fingerprint"] = "0" * 32
    with open(base, "w") as f:
        json.dump(written, f)
    rc, out = run_port("hlolint_report", ["--baseline", base, "--labels",
                                          LABELS, "--device", "cpu"], capsys)
    assert rc == 1 and "fingerprints flipped: serve_entry" in out


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_rehearse_phase15_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.cli_phase`` on the CPU at a cut size, over phase 10
    and phase 11 files written here by the port's own writers: every
    check passes but the card-only ones (the roofline's classification
    against the card's ridge point, once for the run's CostRecords and
    once for phase 11's)."""
    import chip_smoke
    from porqua_tpu_torch.obs import devprof

    from tests.test_torch_cli import (Pkg, cost_records, flight_bundle,
                                      write_harvest)

    port = Pkg("port")
    p10 = tmp_path / "porqua-phase10-x"
    (p10 / "routed_trinv").mkdir(parents=True)
    flight_bundle(port, str(p10 / "routed_trinv"), seed=2)
    harvest = write_harvest(port, str(p10 / "routed_trinv.jsonl"), seed=3)
    p11 = tmp_path / "porqua-phase11-x"
    p11.mkdir()
    costs = str(p11 / "cost_trinv.costs.jsonl")
    devprof.write_cost_records(costs, [dict(r, device="cpu:0")
                                       for r in cost_records(4)])
    artifacts = {"phase10": {"harvest": [harvest],
                             "flight": [str(p10 / "routed_trinv")]},
                 "phase11": {"costs": [costs]}}
    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    monkeypatch.setattr(chip_smoke, "CLI_LOADGEN", [
        "--workload", "grid", "--requests", "48", "--max-batch", "16"])
    monkeypatch.setattr(chip_smoke, "CLI_TSAN", ["--requests", "32"])
    monkeypatch.setattr(chip_smoke, "CLI_HLO_LABELS",
                        "serve_entry,continuous_step")
    chip_smoke.cli_phase(artifacts, device="cpu")
    failed = chip_smoke.FAILURES
    assert len(failed) == 2, failed
    assert failed[0].startswith("[cli roofline_report] ranks") \
        and "against the card's ridge point ('')" in failed[0]
    assert failed[1].startswith("[cli roofline_report] ranks 13 entries "
                                "of cost_trinv.costs.jsonl")
