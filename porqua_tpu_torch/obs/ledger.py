"""The longitudinal run ledger: one row per measured run, forever (the
port of ``porqua_tpu/obs/ledger.py``, the same rows and readers).

Every committed BENCH artifact so far is a point-in-time file a human
eyeballed once; nothing machine-readable strings them into a
trajectory. The ledger is that time series: ``bench.py``,
``scripts/serve_loadgen.py``, and ``scripts/fleet_loadgen.py`` append
ONE schema-versioned JSONL row per run (``--ledger``) carrying the git
revision, the run kind, the key metrics (a FLAT dict of the same
dotted metric paths the bench gate's rule table uses), the gate
verdict when one was computed, and the artifact path. Readers:

* ``scripts/trend_report.py`` renders the per-metric trajectory (and
  ``--backfill`` seeds the ledger from the committed
  ``BENCH_r01``-``BENCH_r05`` / ``BENCH_GATE_r07`` / ``SLO_r09``
  artifacts, so the series starts with real history);
* ``scripts/bench_gate.py --trend`` gates a fresh payload against the
  **rolling median of the last K rows** instead of a single committed
  baseline — a slow three-PR drift that stays inside each PR's
  pairwise tolerance is exactly what the rolling window catches.

Rows are append-only and self-describing; :func:`rolling_median` is
the single definition of the trend baseline (median, not mean — one
outlier host must not drag the bar). Pure host code, stdlib only.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "LEDGER_SCHEMA_VERSION",
    "append_row",
    "git_rev",
    "ledger_row",
    "load_ledger",
    "metrics_from_bench",
    "metrics_from_fleet",
    "metrics_from_loadgen",
    "nest_metrics",
    "rolling_median",
]

#: Bump when a field changes meaning; additive fields don't need it.
LEDGER_SCHEMA_VERSION = 1

#: Known values of a row's ``kind`` field (the producer inventory).
KINDS = ("bench", "serve_loadgen", "fleet_loadgen")

#: Bench-payload metric paths lifted into a ledger row (the same
#: dotted paths the bench-gate RULES table reads, so ``--trend`` can
#: rebuild a baseline payload from rolling medians 1:1).
BENCH_METRICS = (
    "value",
    "vs_baseline",
    "vs_baseline_steady_state",
    "device_solved",
    "device_median_te",
    "iters_p50",
    "iters_p95",
    "iters_max",
    "wasted_iteration_fraction",
    "xla_cost.flops",
    "xla_cost.bytes_accessed",
    "xla_cost.peak_bytes",
    "config_serving.throughput_solves_per_s",
    "config_serving.latency_p50_ms",
    "config_serving.latency_p99_ms",
    "config_serving.occupancy_mean",
    "config_serving.recompiles_after_warmup",
    "config_serving.cost_summary.bytes_accessed_max",
    "config_serving.cost_summary.peak_bytes_max",
    "config_compaction.recompiles_in_measured_solve",
    "config_compaction.te_drift",
    "config_compaction.lane_segments_reduction",
    "config_hlo.programs",
    "config_hlo.findings_total",
    "config_hlo.findings_max_per_program",
    "config_hlo.fingerprint_flips",
    "config_hlo.top_target_bytes",
    "config_calibration.recompiles_after_warmup",
    "config_calibration.harvest_reconciled",
    "config_calibration.unsolved",
    "config_calibration.promotions",
    "config_calibration.rollbacks",
    "config_calibration.route_table_version",
    "config_calibration.win_rate",
    "config_napg.napg_te_rel_drift",
    "config_napg.vs_baseline",
    "config_routing.napg_routed_any",
    "config_routing.recompiles_after_warmup",
    "config_northstar_5k.gram_rel_err",
    "config_northstar_5k.te_rel_drift_max",
    "config_northstar_5k.vs_dense",
    "config_northstar_5k.recompiles_after_warmup",
)

#: Loadgen-report metrics lifted into a ledger row. The
#: ``tenant_fairness.*`` paths exist only on multi-tenant runs
#: (``run_loadgen(tenants=...)`` — README "Multi-tenant serving &
#: workload library"); absent metrics are simply not recorded, same
#: as any older report shape.
LOADGEN_METRICS = (
    "throughput_solves_per_s",
    "latency_p50_ms",
    "latency_p99_ms",
    "occupancy_mean",
    "recompiles_after_warmup",
    "errors",
    "solved",
    "dropped_arrivals",
    "route_table_version",
    "tenant_fairness.tenants",
    "tenant_fairness.quiet_p99_ratio",
    "tenant_fairness.victim_shed_share",
    "tenant_fairness.offender_alerts",
    "tenant_fairness.nonoffender_alerts",
    "tenant_fairness.harvest_reconciled",
)

#: Fleet-report metrics lifted into a ledger row.
FLEET_METRICS = (
    "workers",
    "workers_lost",
    "duration_s",
    "fleet.completed",
    "fleet.failed",
    "fleet.dropped_arrivals",
    "fleet.throughput_solves_per_s",
    "fleet.harvest_records",
    "fleet.recompiles_after_warmup",
    "incident_bundles",
    "reconciled",
)


def git_rev(root: Optional[str] = None) -> Optional[str]:
    """Short git revision of ``root`` (best-effort: a ledger row from
    an exported tarball simply has no rev)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=root or os.getcwd(), capture_output=True, text=True,
            timeout=10)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except (OSError, subprocess.SubprocessError):
        return None


def _lookup(payload: Dict[str, Any], dotted: str):
    cur: Any = payload
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _extract(payload: Dict[str, Any],
             paths: Iterable[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path in paths:
        val = _lookup(payload, path)
        if isinstance(val, bool):
            val = int(val)
        if isinstance(val, (int, float)):
            out[path] = val
    return out


def metrics_from_bench(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Flat ``{dotted_path: value}`` metrics from one bench payload."""
    return _extract(payload, BENCH_METRICS)


def metrics_from_loadgen(report: Dict[str, Any]) -> Dict[str, Any]:
    """Flat metrics from one ``run_loadgen`` report."""
    return _extract(report, LOADGEN_METRICS)


def metrics_from_fleet(report: Dict[str, Any]) -> Dict[str, Any]:
    """Flat metrics from one ``fleet_loadgen`` merged report. The
    report's ``workers_lost`` is a list of worker ids; the ledger
    records its COUNT (a crash cell's loss must be visible in the
    trend series, and ids don't aggregate)."""
    out = _extract(report, FLEET_METRICS)
    lost = report.get("workers_lost")
    if isinstance(lost, (list, tuple)):
        out["workers_lost"] = len(lost)
    return out


def ledger_row(kind: str,
               metrics: Dict[str, Any],
               run_id: Optional[str] = None,
               rev: Optional[str] = None,
               gate: Optional[Dict[str, Any]] = None,
               artifact: Optional[str] = None,
               note: Optional[str] = None,
               t: Optional[float] = None) -> Dict[str, Any]:
    """Build one ledger row (the schema's single constructor).

    ``metrics`` is a FLAT dict of dotted metric paths; ``gate`` is a
    compact bench-gate verdict summary (``ok`` / ``n_pass`` /
    ``n_fail`` / ``failed``); ``run_id`` defaults to a
    ``<kind>-<unix-time>`` stamp and is the idempotency key backfill
    dedupes on."""
    if kind not in KINDS:
        raise ValueError(f"unknown ledger kind {kind!r}; known: "
                         f"{', '.join(KINDS)}")
    t = time.time() if t is None else float(t)
    row: Dict[str, Any] = {
        "v": LEDGER_SCHEMA_VERSION,
        "t": t,
        "run_id": run_id if run_id is not None else f"{kind}-{int(t)}",
        "kind": kind,
        "metrics": dict(metrics),
    }
    if rev is not None:
        row["rev"] = str(rev)
    if gate is not None:
        row["gate"] = {"ok": bool(gate.get("ok")),
                       "n_pass": gate.get("n_pass"),
                       "n_fail": gate.get("n_fail"),
                       "failed": list(gate.get("failed", ()))[:8]}
    if artifact is not None:
        row["artifact"] = str(artifact)
    if note is not None:
        row["note"] = str(note)
    return row


def append_row(path: str, row: Dict[str, Any]) -> Dict[str, Any]:
    """Append one row to the ledger file (one json.dumps line);
    returns the row. Plain O_APPEND semantics: concurrent producers
    each land a whole line."""
    with open(path, "a") as f:
        f.write(json.dumps(row, default=str) + "\n")
    return row


def load_ledger(path: str) -> List[Dict[str, Any]]:
    """Read a ledger back, oldest row first (blank lines skipped;
    a missing file is an empty ledger, not an error — the first run
    creates it)."""
    if not os.path.exists(path):
        return []
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _median(values: List[float]) -> float:
    vals = sorted(values)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def rolling_median(rows: Iterable[Dict[str, Any]],
                   metric: str,
                   window: int = 5,
                   kind: Optional[str] = None) -> Optional[float]:
    """THE trend baseline: the median of ``metric`` over the last
    ``window`` rows that actually carry it (optionally restricted to
    one producer ``kind``). ``None`` when no row carries the metric —
    an empty series gates nothing, it never fails a candidate."""
    series = [float(r["metrics"][metric]) for r in rows
              if (kind is None or r.get("kind") == kind)
              and isinstance(r.get("metrics"), dict)
              and isinstance(r["metrics"].get(metric), (int, float))]
    if not series:
        return None
    return _median(series[-int(window):])


def nest_metrics(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Re-nest a flat ``{dotted_path: value}`` dict into the payload
    shape the bench-gate rule table looks metrics up in."""
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        cur = out
        parts = path.split(".")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
            if not isinstance(cur, dict):  # pragma: no cover - key clash
                break
        else:
            cur[parts[-1]] = value
    return out
