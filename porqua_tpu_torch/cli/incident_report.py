"""Render an incident flight-recorder bundle as a post-mortem report.

Consumes one self-contained ``incident-*.json.gz`` bundle dumped by
the :class:`porqua_tpu_torch.obs.flight.FlightRecorder` (triggers:
breaker open, retry give-up, validation failure, sanitizer error,
harvest sink death, firing SLO alert, convergence anomaly) and prints
what an on-call responder asks first:

* **what tripped** — the trigger event, its severity, its fields;
* **what config was running** — the SolverParams fingerprint;
* **what the service looked like** — the metrics snapshot at dump
  time plus the snapshot trajectory INTO the incident;
* **what the breaker did** — the per-device open/close/probe history;
* **what the SLOs say** — compliance, burn rates, firing alerts;
* **what was being solved** — recent SolveRecords (status mix,
  iteration quantiles) and the tail of warn/error events.

Usage::

    python -m porqua_tpu_torch.cli.incident_report /path/incident-0001-breaker_open.json.gz
    python -m porqua_tpu_torch.cli.incident_report --selftest

``--selftest`` builds a recorder in-process, trips it through a real
event-bus listener, round-trips the bundle through disk, and checks
the rendering end to end (no device work).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List


def _fmt_fields(e: Dict[str, Any], skip=("t", "kind", "severity")) -> str:
    return " ".join(f"{k}={v}" for k, v in e.items() if k not in skip)


def render_bundle(bundle: Dict[str, Any]) -> str:
    """The full text report from one loaded bundle dict."""
    import numpy as np

    rule = "-" * 64
    trigger = bundle.get("trigger", {})
    lines: List[str] = [
        f"incident bundle v{bundle.get('v', '?')} seq "
        f"{bundle.get('seq', '?')}",
        f"trigger: {trigger.get('kind', '?')} "
        f"[{trigger.get('severity', '?')}]  {_fmt_fields(trigger)}",
    ]
    cfg = bundle.get("config", {})
    if cfg:
        lines.append(
            "config: " + " ".join(
                f"{k}={v}" for k, v in cfg.items() if k != "params"))
    lines.append(rule)

    counters = bundle.get("counters")
    if counters:
        lines.append("service state at dump")
        hot = [(k, v) for k, v in counters.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)
               and v]
        width = max((len(k) for k, _ in hot), default=1)
        for k, v in hot:
            lines.append(f"  {k:<{width}}  "
                         f"{v if isinstance(v, int) else round(v, 4)}")
        snaps = bundle.get("snapshots") or []
        if snaps:
            lines.append(
                f"  trajectory: {len(snaps)} snapshots; completed "
                + " -> ".join(str(s.get("completed", "?"))
                              for s in snaps[-6:]))
        lines.append(rule)

    history = bundle.get("breaker_history") or {}
    if history:
        lines.append("breaker history (per device)")
        for device, entries in sorted(history.items()):
            lines.append(f"  {device}:")
            for e in entries[-8:]:
                lines.append(f"    {e.get('kind', '?'):<14} "
                             f"{_fmt_fields(e, skip=('t', 'kind'))}")
        lines.append(rule)

    slo = bundle.get("slo")
    if slo:
        lines.append("slo status")
        for name, s in slo.get("slos", {}).items():
            alerts = ", ".join(
                f"{r}={a['state']}(burn {a['burn_short']:g}/"
                f"{a['burn_long']:g})"
                for r, a in s.get("alerts", {}).items())
            lines.append(f"  {name:<14} compliance "
                         f"{s.get('compliance', 1.0):.6f}  {alerts}")
        firing = slo.get("firing") or []
        lines.append("  firing: " + (", ".join(firing) if firing
                                     else "(none)"))
        lines.append(rule)

    anomaly = bundle.get("anomaly")
    if anomaly:
        lines.append("convergence anomaly status")
        for label, g in anomaly.get("groups", {}).items():
            flag = "ANOMALOUS" if g.get("anomalous") else "ok"
            lines.append(
                f"  {label:<16} {flag:<9} ewma iters "
                f"{g.get('ewma_iters', 0.0):g} / band "
                f"{g.get('iters_band', 0.0):g}  waste "
                f"{g.get('ewma_waste', 0.0):g} / "
                f"{g.get('waste_band', 0.0):g}  n={g.get('n', 0)}")
        lines.append(rule)

    solves = bundle.get("solves") or []
    if solves:
        by_status: Dict[int, int] = {}
        for r in solves:
            s = int(r.get("status", 0))
            by_status[s] = by_status.get(s, 0) + 1
        iters = np.asarray([int(r.get("iters", 0)) for r in solves])
        lines.append(
            f"recent solves: {len(solves)} records, status "
            + " ".join(f"{k}:{v}" for k, v in sorted(by_status.items()))
            + f", iters p50/p95 {np.percentile(iters, 50):.0f}/"
              f"{np.percentile(iters, 95):.0f}")
        lines.append(rule)

    events = bundle.get("events") or []
    notable = [e for e in events
               if e.get("severity") in ("warn", "error")]
    lines.append(f"event tail: {len(events)} events, "
                 f"{len(notable)} warn/error")
    for e in notable[-12:]:
        lines.append(f"  ! {e.get('severity')} {e.get('kind')} "
                     f"{_fmt_fields(e)}")
    spans = bundle.get("spans") or []
    if spans:
        lines.append(f"span tail: {len(spans)} spans "
                     f"(last: {spans[-1].get('name', '?')})")
    return "\n".join(lines)


def _selftest() -> int:
    """Recorder -> trigger -> disk -> load -> render."""
    import tempfile

    from porqua_tpu_torch.obs import Observability
    from porqua_tpu_torch.obs.flight import FlightRecorder, load_bundle
    from porqua_tpu_torch.serve.metrics import ServeMetrics

    with tempfile.TemporaryDirectory() as td:
        metrics = ServeMetrics()
        obs = Observability()
        bus = obs.events
        rec = FlightRecorder(out_dir=td, debounce_s=5.0, max_bundles=4)
        rec.attach(metrics=metrics, obs=obs,
                   params="SolverParams(selftest)")
        bus.add_listener(rec.on_event)

        for i in range(6):
            metrics.inc("completed")
            metrics.observe_latency(0.004 + 0.001 * i)
            rec.record_solve({"v": 1, "status": 1 + (i % 2),
                              "iters": 50 * (i + 1), "bucket": "32x8"})
        rec.record_snapshot(metrics.snapshot())
        bus.emit("probe_failure", "warn", device="cuda:0", timeout_s=30.0)
        # The trigger: one breaker_open through the real listener path.
        bus.emit("breaker_open", "error", primary="cuda:0",
                 fallback="cpu:0", failures=2)
        # Debounced: a second trigger inside the window must not dump.
        bus.emit("breaker_open", "error", primary="cuda:0",
                 fallback="cpu:0", failures=3)

        bundles = rec.bundles()
        assert len(bundles) == 1, bundles
        assert rec.suppressed == 1, rec.suppressed
        bundle = load_bundle(bundles[0])
        assert bundle["trigger"]["kind"] == "breaker_open", bundle["trigger"]
        assert bundle["config"]["fingerprint"], bundle["config"]
        assert len(bundle["solves"]) == 6
        assert "cuda:0" in bundle["breaker_history"]

        text = render_bundle(bundle)
        for needle in ("trigger: breaker_open", "fingerprint=",
                       "service state at dump", "breaker history",
                       "cuda:0", "probe_failure",
                       "recent solves: 6 records", "iters p50/p95",
                       "event tail"):
            assert needle in text, \
                f"selftest: {needle!r} missing from report"
        print(text)
    print("\nincident_report selftest: ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle", nargs="?", default=None,
                    help="incident bundle path (.json.gz, from "
                         "FlightRecorder / serve_loadgen --flight-out)")
    ap.add_argument("--selftest", action="store_true",
                    help="build, dump, reload and render a synthetic "
                         "incident end to end")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest()
    if not args.bundle:
        ap.error("give a bundle path or --selftest")

    from porqua_tpu_torch.obs.flight import load_bundle

    print(render_bundle(load_bundle(args.bundle)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
