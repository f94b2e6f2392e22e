"""The port's fleet load generator (``porqua_tpu_torch/cli/fleet_loadgen``)
against the JAX package's ``scripts/fleet_loadgen.py``, on the CPU.

* The collector unit pass runs the same synthetic streams through the
  JAX package's collector plane and the port's: equal merged counters,
  tenant merge, namespacing, liveness, reconciliation, rollup bound,
  vitals trend and ladder refusal; the JAX script's own unit pass runs
  beside it.
* A 2-worker spawn mini-soak at the JAX selftest's sizes, through the
  command line with ``jax`` and ``porqua_tpu`` made unimportable in the
  parent and in every spawned worker: the report reconciles exactly
  (fleet ``completed`` = the workers' sum = the harvest records), zero
  survivor recompiles, at least two rollup windows, no lost worker,
  ``ok``; its keys are the JAX script's (``FLEET_KEYS``, taken from the
  script's code); every answer was served on the CPU; its ``--ledger``
  row, read by the JAX package's ledger, gives the JAX
  ``metrics_from_fleet`` figures of the same report.
* A 2-worker crash cell loses exactly worker 1 (exit 17), with one
  ``worker_lost`` bundle, and the survivor reconciles.
* A worker that cannot reach its device exits non-zero and the report
  is not ``ok``; a worker hung before its hello is lost (one
  ``worker_lost`` bundle) and killed; ``device``/``platform`` contradictions and a missing
  card raise before anything is spawned.
* ``--help`` names the JAX script's options plus ``--device``.
"""

import ast
import json
import os
import re
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from tests.test_torch_cli import jax_options, jax_script, twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "fleet_loadgen.py")
FLEET = twin("fleet_loadgen")

#: The report keys of ``scripts/fleet_loadgen.py`` with ``--port``,
#: ``--events-out`` and ``--ledger`` and without ``--tenants``: its
#: collector's report and the keys its ``run_fleet`` and ``main`` add
#: (``test_fleet_keys_are_the_jax_scripts`` derives them from there).
FLEET_KEYS = sorted([
    "collector", "crash_worker", "duration_s", "events_out",
    "events_written", "fleet", "http_port", "incident_bundle_paths",
    "incident_bundles", "ledger_row", "ok", "rate", "reconciled",
    "reconciliation", "rollup_windows", "rollups_tail", "rows", "slo",
    "survivor_recompiles", "tenants", "vitals_anomalies",
    "vitals_anomalous", "wall_s", "worker_lost_bundles", "workers",
    "workers_exit", "workers_lost"])

#: The JAX selftest's mini-soak (``scripts/fleet_loadgen.py:641-646``).
SOAK = dict(workers=2, rate=300.0, duration_s=10.0, n_assets=16,
            window=64, pool=128, max_batch=64, emit_interval_s=0.5,
            heartbeat_timeout_s=8.0, rollup_window_s=2.0)


def soak_argv():
    return [a for k, v in SOAK.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


# ---------------------------------------------------------------------------
# the collector unit pass
# ---------------------------------------------------------------------------

def test_unit_pass_equals_the_jax_collectors():
    from porqua_tpu.obs import FlightRecorder, SLOEngine, default_slos
    from porqua_tpu.obs.federation import FleetCollector, WorkerStream
    from porqua_tpu.obs.vitals import VitalsTrend
    from porqua_tpu.resilience.faults import FaultClock

    jax_api = SimpleNamespace(
        FleetCollector=FleetCollector, WorkerStream=WorkerStream,
        FlightRecorder=FlightRecorder, SLOEngine=SLOEngine,
        default_slos=default_slos, VitalsTrend=VitalsTrend,
        FaultClock=FaultClock)
    mine = FLEET._unit_pass(FLEET._port_api())
    assert mine == FLEET._unit_pass(jax_api)
    assert mine["merged"]["latency_counts"] == (21, 9, 1)
    assert mine["statuses"] == {"w0": "lost", "w1": "running"}
    assert mine["bundle_kinds"].count("worker_lost") == 1
    assert mine["workers_lost"] == ["w0"] and mine["rollups"] <= 4
    assert "ladder" in mine["ladder"]
    # The JAX script's own pass and the port's, each asserting inside.
    jax_script("fleet_loadgen")._selftest_units()
    FLEET._selftest_units()


# ---------------------------------------------------------------------------
# the mini-soak, with JAX unimportable in every process
# ---------------------------------------------------------------------------

def run_soak(d):
    """The JAX selftest's mini-soak through the port's command line, run
    from ``d``, whose ``jax`` and ``porqua_tpu`` raise on import, first
    on the path of the parent and (spawn hands it on) of every worker."""
    block = d / "block"
    for name in ("jax", "porqua_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in the port')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(block), ROOT])}
    env.pop("JAX_PLATFORMS", None)
    control = subprocess.run([sys.executable, "-c", "import jax"], cwd=d,
                             env=env, capture_output=True, text=True)
    assert control.returncode != 0 and "blocked" in control.stderr
    out = subprocess.run(
        [sys.executable, "-m", "porqua_tpu_torch.cli.fleet_loadgen",
         *soak_argv(), "--out-dir", str(d / "run"),
         "--events-out", str(d / "events.jsonl"), "--port", "0",
         "--ledger", str(d / "ledger.jsonl"), "--out", str(d / "rep.json"),
         "--device", "cpu"],
        cwd=d, env=env, capture_output=True, text=True, timeout=240)
    return SimpleNamespace(dir=d, rc=out.returncode, stdout=out.stdout,
                           stderr=out.stderr)


def stream_reports(run_dir):
    """Each worker's final report as its stream holds it."""
    reports = {}
    for name in sorted(os.listdir(run_dir)):
        with open(os.path.join(run_dir, name)) as f:
            for line in f:
                rec = json.loads(line)
                if rec["kind"] == "report":
                    reports[rec["w"]] = rec["report"]
    return reports


def test_mini_soak_reconciles_exactly_and_its_ledger_row(tmp_path):
    """The soak's report, its workers' streams, and its ``--ledger`` row
    read by the JAX package's ledger: the JAX ``metrics_from_fleet``
    figures of the same report."""
    from porqua_tpu.obs import ledger as jax_ledger

    from porqua_tpu_torch.obs import ledger

    soak = run_soak(tmp_path)
    assert soak.rc == 0, soak.stderr[-4000:]
    lines = soak.stdout.splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    with open(soak.dir / "rep.json") as f:
        assert json.load(f) == report
    assert sorted(report) == FLEET_KEYS
    assert report["ok"] and report["reconciled"], report["reconciliation"]
    assert report["workers_lost"] == [] and report["worker_lost_bundles"] == 0
    assert report["workers_exit"] == {"w0": 0, "w1": 0}
    assert report["survivor_recompiles"] == 0
    assert report["rollup_windows"] >= 2
    rows = report["rows"]
    assert [r["status"] for r in rows] == ["ok", "ok"]
    per_worker = sum(int(r["completed"]) for r in rows)
    assert per_worker == report["fleet"]["completed"] > 0
    assert report["fleet"]["harvest_records"] == per_worker
    assert report["fleet"]["recompiles_after_warmup"] == 0
    assert sum(int(r["harvest_records"]) for r in rows) == per_worker
    # Arrival k (due at k / rate) is worker k % 2's: neither worker
    # takes more than its half of the arrivals due in the soak.
    for r in rows:
        assert r["completed"] + r["dropped_arrivals"] <= 1500, r
    # Every answer of the measured window was served on the CPU.
    reports = stream_reports(soak.dir / "run")
    assert {w: r["devices"] for w, r in reports.items()} == {
        r["worker"]: {"cpu:0": r["completed"]} for r in rows}
    with open(report["events_out"]) as f:
        assert sum(1 for _ in f) == report["events_written"]
    assert isinstance(report["http_port"], int) and report["http_port"] > 0
    entries = jax_ledger.load_ledger(str(soak.dir / "ledger.jsonl"))
    assert len(entries) == 1 and entries[0]["kind"] == "fleet_loadgen"
    assert entries[0]["run_id"] == report["ledger_row"]
    assert entries[0]["artifact"] == str(soak.dir / "rep.json")
    assert entries[0]["note"] == "workers=2 rate=300"
    flat = jax_ledger.metrics_from_fleet(report)
    assert entries[0]["metrics"] == flat == ledger.metrics_from_fleet(report)
    assert flat["workers_lost"] == 0
    assert flat["fleet.completed"] == report["fleet"]["completed"]


def test_fleet_keys_are_the_jax_scripts():
    """``FLEET_KEYS`` is what the JAX script's code gives at the soak's
    flags: its collector's report (every optional section on) and the
    keys ``run_fleet`` and ``main`` set, less the ``--tenants`` one."""
    from porqua_tpu.obs import FlightRecorder, SLOEngine, default_slos
    from porqua_tpu.obs.federation import FleetCollector, WorkerStream
    from porqua_tpu.obs.vitals import VitalsTrend

    import tempfile

    with tempfile.TemporaryDirectory() as td:
        col = FleetCollector(slo=SLOEngine(default_slos()),
                             flight=FlightRecorder(out_dir=None),
                             vitals_trend=VitalsTrend())
        path = os.path.join(td, "w0.jsonl")
        col.add_worker("w0", path)
        s = WorkerStream(path, "w0")
        s.hello(latency_le=[0.1])
        s.sample({"completed": 1, "failed": 0, "expired": 0,
                  "latency_le": (0.1,), "latency_counts": (1, 0),
                  "latency_count": 1},
                 snap={"tenants": {"default": {"completed": 1}}})
        s.close()
        col.drain()
        keys = set(col.report())
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("run_fleet",
                                                           "main"):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Subscript)
                        and isinstance(node.ctx, ast.Store)
                        and getattr(node.value, "id", None) == "report"):
                    keys.add(node.slice.value)
    assert sorted(keys - {"tenant_spec"}) == FLEET_KEYS


# ---------------------------------------------------------------------------
# the crash cell and the device rule
# ---------------------------------------------------------------------------

def test_crash_cell_loses_exactly_the_crashed_worker(tmp_path):
    from porqua_tpu_torch.obs.flight import load_bundle

    report = FLEET.run_fleet(
        **{**SOAK, "duration_s": 8.0}, poll_interval_s=0.5, drain_s=60.0,
        crash_worker=1, crash_after_s=2.0, out_dir=str(tmp_path / "run"),
        flight_out=str(tmp_path / "flight"), device="cpu")
    assert report["ok"], json.dumps(report, indent=1, default=str)
    assert report["crash_worker"] == "w1"
    assert report["workers_lost"] == ["w1"]
    assert report["workers_exit"] == {"w0": 0, "w1": FLEET.CRASH_EXIT}
    assert FLEET.CRASH_EXIT == 17
    assert report["worker_lost_bundles"] == 1
    lost = [p for p in report["incident_bundle_paths"]
            if "worker_lost" in os.path.basename(p)]
    assert len(lost) == 1
    assert load_bundle(lost[0])["trigger"]["worker"] == "w1"
    rows = {r["worker"]: r for r in report["rows"]}
    assert rows["w0"]["status"] == "ok" and rows["w1"]["status"] == "lost"
    assert report["reconciled"] and report["survivor_recompiles"] == 0
    assert rows["w0"]["harvest_records"] == rows["w0"]["completed"] > 0
    assert report["fleet"]["harvest_records"] == rows["w0"]["completed"]
    # The crash fired about 2 s in: the survivor served its whole shard.
    assert rows["w1"]["completed"] < rows["w0"]["completed"]


def test_worker_without_its_device_exits_and_the_report_is_not_ok(
        tmp_path):
    """No fallback: a worker given a card the host does not have exits
    non-zero, its stream goes stale, and the fleet says so."""
    report = FLEET.run_fleet(
        workers=1, rate=10.0, duration_s=1.0, pool=4, n_assets=4,
        window=16, emit_interval_s=0.25, poll_interval_s=0.25,
        heartbeat_timeout_s=2.0, out_dir=str(tmp_path / "run"),
        device="cuda:0")
    assert report["workers_exit"]["w0"] not in (0, None)
    assert report["workers_lost"] == ["w0"]
    assert report["fleet"]["completed"] == 0
    assert not report["ok"]


def hang_before_hello(cfg):
    """A worker that hangs before its hello, as one stuck opening its
    device would."""
    time.sleep(600)


def test_worker_hung_before_its_hello_is_lost_and_killed(tmp_path,
                                                         monkeypatch):
    """A silent worker joins the collector START_GRACE_S after its
    spawn, goes stale, lands one ``worker_lost`` bundle, and is killed:
    the run ends."""
    monkeypatch.setattr(FLEET, "_worker_main", hang_before_hello)
    monkeypatch.setattr(FLEET, "START_GRACE_S", 1.0)
    report = FLEET.run_fleet(
        workers=1, rate=10.0, duration_s=1.0, pool=4, n_assets=4,
        window=16, emit_interval_s=0.25, poll_interval_s=0.25,
        heartbeat_timeout_s=1.0, out_dir=str(tmp_path / "run"),
        flight_out=str(tmp_path / "flight"), device="cpu")
    assert report["workers_lost"] == ["w0"]
    assert report["worker_lost_bundles"] == 1
    assert report["workers_exit"] == {"w0": -signal.SIGKILL}
    assert report["fleet"]["completed"] == 0 and not report["ok"]
    assert report["wall_s"] < 60


def test_device_and_platform_are_checked_before_spawning(monkeypatch,
                                                         tmp_path):
    assert FLEET._fleet_device("cpu", None) == "cpu"
    assert FLEET._fleet_device(None, "cpu") == "cpu"
    assert FLEET._fleet_device("gpu", "cuda:0") == "cuda:0"
    for platform, device in (("cpu", "cuda:0"), ("gpu", "cpu"),
                             ("tpu", None)):
        with pytest.raises(ValueError, match="platform"):
            FLEET.run_fleet(platform=platform, device=device,
                        out_dir=str(tmp_path / "never"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FLEET.run_fleet(out_dir=str(tmp_path / "never"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FLEET.main(["--duration-s", "1"])
    assert not (tmp_path / "never").exists()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_help_is_the_jax_scripts_plus_device(capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        FLEET.main(["--help"])
    assert exc.value.code == 0
    opts = re.findall(r"^  (?:-\w+, )?(--[\w-]+)", capsys.readouterr().out,
                      re.M)
    assert set(opts) - {"--help"} == jax_options("fleet_loadgen") | {
        "--device"}
    assert opts[-1] == "--device"


def test_run_fleet_keeps_the_jax_signature():
    import inspect

    mine = inspect.signature(FLEET.run_fleet).parameters
    ref = inspect.signature(jax_script("fleet_loadgen").run_fleet).parameters
    assert list(mine)[:-1] == list(ref)
    assert all(mine[k].default == ref[k].default for k in ref)
    assert list(mine)[-1] == "device" and mine["device"].default is None


def test_imports_no_jax_package_or_script():
    with open(os.path.join(ROOT, "porqua_tpu_torch", "cli",
                           "fleet_loadgen.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module])
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib",
                                               "porqua_tpu", "scripts"), m
    assert "JAX_PLATFORMS" not in ast.unparse(tree)
