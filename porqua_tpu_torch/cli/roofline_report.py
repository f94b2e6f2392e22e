"""Measured roofline + fusion-target attribution from CostRecords.

The reader half of the device-cost plane: joins a CostRecord dataset —
what the counted warm-up of each compiled serving entry moved and
computed (flops, bytes accessed, peak device memory;
``serve_loadgen --cost-out``) — with a run's measured per-stage seconds
(the ``profile_stages`` field of a loadgen report captured with
``--trace-out``), ranks entries by measured bytes accessed, and emits
the top fusion candidates as a machine-readable verdict JSON
(``--out``).

Each ranked row carries the counted flops / bytes / peak memory, the
arithmetic intensity (flops per byte), and — when ``--device-kind``
names a card with known peaks (``porqua_tpu_torch.profiling``'s table:
the H100) — a memory/compute-bound classification against the card's
ridge point; a kind the table does not know gets no classification.
``--selftest`` builds a synthetic warehouse in-process and checks the
pipeline end to end (no device work).

Examples::

    python -m porqua_tpu_torch.cli.serve_loadgen \\
        --cost-out costs.jsonl --trace-out trace.json > report.json
    python -m porqua_tpu_torch.cli.roofline_report --costs costs.jsonl \\
        --report report.json --device-kind "NVIDIA H100 80GB HBM3" \\
        --out roofline_verdict.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _render(verdict: dict, top: int = 10) -> str:
    lines = [f"measured roofline: {verdict['executables']} executables "
             f"from {verdict['records_in']} CostRecords"]
    if verdict.get("device_kind"):
        ridge = verdict.get("ridge_flops_per_byte")
        lines.append(f"  device {verdict['device_kind']}"
                     + (f", ridge {ridge:.1f} flops/byte"
                        if ridge else ""))
    lines.append(f"  {'rank':>4} {'entry':<10} {'bucket':<12} "
                 f"{'slots':>5} {'MB accessed':>12} {'peak MB':>8} "
                 f"{'flops/byte':>10}  bound")
    for row in verdict["ranked"][:top]:
        ba = row.get("bytes_accessed")
        pk = row.get("peak_bytes")
        ai = row.get("arithmetic_intensity")
        lines.append(
            f"  {row['rank']:>4} {str(row.get('entry')):<10} "
            f"{str(row.get('bucket')):<12} "
            f"{row.get('slots') or 0:>5} "
            f"{(ba or 0) / 1e6:>12.2f} {(pk or 0) / 1e6:>8.2f} "
            f"{(f'{ai:.2f}' if ai is not None else '-'):>10}  "
            f"{row.get('bound', '-')}")
    if verdict.get("stages_ranked"):
        lines.append("  measured stage seconds (descending):")
        for s in verdict["stages_ranked"][:8]:
            lines.append(f"    {s['stage']:<24} {s['seconds']:.4f}s")
    lines.append("  fusion candidates (by measured bytes):")
    for c in verdict["fusion_candidates"]:
        lines.append(
            f"    {c.get('entry')} {c.get('bucket')} x{c.get('slots')}: "
            f"{(c.get('bytes_accessed') or 0) / 1e6:.2f} MB — "
            f"{c.get('reason')}")
    lines.append(f"verdict: {verdict['verdict']}")
    return "\n".join(lines)


def _selftest() -> int:
    """Synthetic warehouse -> verdict -> render, through the real
    on-disk formats — no device work."""
    import tempfile

    from porqua_tpu_torch.obs.devprof import (
        CostLog, load_cost_records, roofline_verdict, write_cost_records)

    def rec(entry, bucket, slots, flops, bytes_acc, peak,
            kind="solve", device="cuda:0"):
        return {"v": 1, "t": 0.0, "kind": kind, "entry": entry,
                "bucket": bucket, "slots": slots, "dtype": "<f4",
                "device": device, "compile_s": 1.0, "flops": flops,
                "bytes_accessed": bytes_acc, "peak_bytes": peak,
                "hlo_hash": f"h-{entry}-{slots}"}

    records = [
        # The big memory-bound segment stepper: the expected #1 target.
        rec("step", "512x8", 256, 2.0e9, 8.0e9, 1.2e9,
            kind="continuous"),
        rec("step", "512x8", 128, 1.0e9, 4.0e9, 0.6e9,
            kind="continuous"),
        # A compute-heavy solve (high intensity: above any ridge).
        rec("solve", "512x8", 256, 9.0e12, 6.0e9, 1.0e9),
        # Small admit/finalize programs.
        rec("admit", "512x8", 256, 1.0e8, 3.0e8, 2.0e8,
            kind="continuous"),
        rec("finalize", "512x8", 256, 5.0e8, 9.0e8, 4.0e8,
            kind="continuous"),
        # A record with no counts: ranked last, never a candidate.
        {"v": 1, "t": 0.0, "kind": "solve", "entry": "solve",
         "bucket": "32x8", "slots": 8, "dtype": "<f4",
         "device": "cuda:0", "flops": None, "bytes_accessed": None},
    ]
    # Append-only semantics: a re-compile of the same identity must
    # supersede, not double-count.
    records.append(rec("step", "512x8", 256, 2.0e9, 8.5e9, 1.25e9,
                       kind="continuous"))

    stage_seconds = {"serve/segment_step": 2.0, "serve/admit": 0.1,
                     "serve/finalize": 0.2, "serve/solve_batch": 0.5}
    verdict = roofline_verdict(records, stage_seconds=stage_seconds,
                               top=3, device_kind="NVIDIA H100 80GB HBM3")
    assert verdict["executables"] == 6, verdict["executables"]
    assert verdict["records_in"] == 7
    ranked = verdict["ranked"]
    assert ranked[0]["entry"] == "step" and ranked[0]["slots"] == 256
    assert ranked[0]["bytes_accessed"] == 8.5e9  # latest record won
    assert ranked[0]["bound"] == "memory"
    assert ranked[0]["stage_seconds"]["serve/segment_step"] == 2.0
    assert ranked[0]["min_achieved_gbps"] > 0
    # The compute-bound solve is excluded from candidates when a ridge
    # exists and memory-bound rows are available.
    solve_row = next(r for r in ranked if r["entry"] == "solve"
                     and r["bucket"] == "512x8")
    assert solve_row["bound"] == "compute"
    cands = verdict["fusion_candidates"]
    assert cands and all(c["bound"] == "memory" for c in cands)
    assert cands[0]["entry"] == "step"
    assert "top fusion target: step" in verdict["verdict"]
    # Without a known device: intensity reported, candidates ranked by
    # bytes alone (the compute-heavy solve may rank, honestly labeled).
    v2 = roofline_verdict(records, top=2)
    assert v2["ridge_flops_per_byte"] is None
    assert "bound" not in v2["ranked"][0]
    assert len(v2["fusion_candidates"]) == 2
    # Stage ranking orders by measured seconds.
    assert verdict["stages_ranked"][0]["stage"] == "serve/segment_step"

    # Round-trip through the on-disk formats (JSONL + gz + CostLog).
    with tempfile.TemporaryDirectory() as td:
        for name in ("costs.jsonl", "costs.jsonl.gz"):
            path = os.path.join(td, name)
            n = write_cost_records(path, records)
            assert n == 7
            loaded = load_cost_records(path)
            assert len(loaded) == 7
            assert loaded[0]["entry"] == "step"
        # A dead log counts failures instead of raising (compile-path
        # posture, same as HarvestSink).
        log = CostLog(os.path.join(td, "nodir", "x.jsonl"))
        assert log.write_failures == 1
        log.emit(records[0])
        assert log.records == 1
        out_path = os.path.join(td, "verdict.json")
        with open(out_path, "w") as f:
            json.dump(verdict, f)
        with open(out_path) as f:
            reloaded = json.load(f)
        assert reloaded["fusion_candidates"][0]["entry"] == "step"

    text = _render(verdict)
    for needle in ("measured roofline", "fusion candidates",
                   "step", "memory", "ridge",
                   "measured stage seconds", "top fusion target"):
        assert needle in text, f"selftest: {needle!r} missing"
    print(text)
    print("\nroofline_report selftest: ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--costs", default=None,
                    help="CostRecord dataset (JSONL/.gz; serve_loadgen "
                         "--cost-out)")
    ap.add_argument("--report", default=None,
                    help="a loadgen/bench report JSON whose "
                         "profile_stages (or config_serving."
                         "profile_stages) supplies measured stage "
                         "seconds to join against")
    ap.add_argument("--device-kind", default="",
                    help="the card's name (torch.cuda.get_device_name) "
                         "for ridge-point classification (e.g. 'NVIDIA "
                         "H100 80GB HBM3'); default empty = rank by "
                         "bytes without a bound label")
    ap.add_argument("--top", type=int, default=5,
                    help="fusion candidates to emit (default 5)")
    ap.add_argument("--out", default=None,
                    help="write the machine-readable verdict JSON here")
    ap.add_argument("--selftest", action="store_true",
                    help="synthetic warehouse -> verdict -> render; "
                         "asserts the pipeline end to end")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest()
    if not args.costs:
        ap.error("--costs is required (or --selftest)")

    from porqua_tpu_torch.obs.devprof import load_cost_records, roofline_verdict

    records = load_cost_records(args.costs)
    stage_seconds = None
    device_kind = args.device_kind
    if args.report:
        with open(args.report) as f:
            report = json.load(f)
        stage_seconds = (report.get("profile_stages")
                         or (report.get("config_serving") or {})
                         .get("profile_stages"))
        if not device_kind:
            device_kind = report.get("device_kind") or ""

    verdict = roofline_verdict(records, stage_seconds=stage_seconds,
                               top=args.top, device_kind=device_kind)
    verdict["costs_path"] = args.costs
    print(_render(verdict, top=max(args.top, 10)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1)
        print(f"verdict written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
