"""SLO/flight smoke: a loadgen window with one injected device loss.

The end-to-end check of the live operational plane: drive a short
closed-loop load window through a real :class:`SolveService` on
``--device`` with the SLO engine armed and the flight recorder writing
to a scratch directory, inject the builtin ``device_lost`` chaos
scenario, and assert that

* the breaker trip produced EXACTLY one incident bundle (debounce
  spans the window), triggered by ``breaker_open``; the latency SLO
  (0.25 s) reads wall-clock time, and on a loaded host its burn-rate
  alert can fire first: then the one bundle is that firing latency
  alert, the breaker's dump is debounced, and the event log shows the
  trip after it;
* the bundle parses back from disk self-contained (trigger, config
  fingerprint, counters, event history) and renders through
  :func:`porqua_tpu_torch.cli.incident_report.render_bundle`;
* the report carries the SLO status section and the run finished with
  zero recompiles.

Usage:
    python -m porqua_tpu_torch.cli.slo_smoke [--device D]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the service runs on (default: the "
                         "card)")
    args = ap.parse_args(argv)

    from porqua_tpu_torch.cli.incident_report import render_bundle
    from porqua_tpu_torch.obs.flight import load_bundle
    from porqua_tpu_torch.serve.loadgen import (build_tracking_requests,
                                                run_loadgen)

    requests = build_tracking_requests(96, n_assets=16, window=64)
    with tempfile.TemporaryDirectory() as td:
        events_path = os.path.join(td, "events.jsonl")
        report = run_loadgen(
            requests, max_batch=32, max_wait_ms=2.0,
            chaos="device_lost", slo=True,
            flight_out=os.path.join(td, "flight"), events_out=events_path,
            device=args.device)

        assert report["faults_injected"] >= 1, report
        assert report["recompiles_after_warmup"] == 0, report
        assert report["incident_bundles"] == 1, report
        paths = report["incident_bundle_paths"]
        assert len(paths) == 1, paths
        bundle = load_bundle(paths[0])
        with open(events_path) as f:
            events = [json.loads(line) for line in f]
        trips = [e["t"] for e in events if e["kind"] == "breaker_open"]
        assert trips, "no breaker_open in the event log"
        assert any(e["kind"] == "fault_injected" for e in events), \
            "no fault in the event log"
        trigger = bundle["trigger"]
        if trigger["kind"] == "breaker_open":
            taken = "breaker_open"
            assert bundle["counters"]["dispatch_failures"] >= 1, \
                bundle["counters"]
            assert any(e["kind"] == "fault_injected"
                       for e in bundle["events"]), "no fault in event tail"
        else:
            taken = "slo_alert latency, breaker_open debounced"
            assert (trigger["kind"], trigger.get("slo"),
                    trigger.get("state")) == (
                        "slo_alert", "latency", "firing"), trigger
            assert trigger["t"] <= min(trips), (trigger, trips)
            assert report["incident_dumps_suppressed"] >= 1, report
        assert bundle["config"]["fingerprint"], bundle["config"]
        assert "availability" in report["slo"]["slos"], report["slo"]
        text = render_bundle(bundle)
        for needle in (f"trigger: {trigger['kind']}", "fingerprint=",
                       "service state at dump", "slo status",
                       "availability"):
            assert needle in text, f"{needle!r} missing from render"

    print(f"slo_smoke: ok — 1 bundle ({taken}), "
          f"{report['faults_injected']} faults injected, "
          f"{report['errors']} errors, "
          f"{report['throughput_solves_per_s']:.0f} solves/s, "
          f"0 recompiles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
