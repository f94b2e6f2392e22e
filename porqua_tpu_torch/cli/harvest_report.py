"""Aggregate a solver-telemetry harvest dataset into the policy table.

Input: one or more JSONL(.gz) datasets written by a
:class:`porqua_tpu_torch.obs.HarvestSink` (``serve_loadgen
--harvest-out``, ``batch.solve_batch(harvest=...)``, the checkpointed
scan); schema v1 and v2 datasets, the JAX package's included.
Output: the policy-ready rollup — per-(tenant, bucket, eps) iteration
quantiles, wasted-iteration attribution, warm-vs-cold iteration
deltas, status/source breakdowns, the per-backend routing evidence and
the calibration audit chain — as a text table (default) or JSON
(``--json``), with the full aggregate optionally written to ``--out``.

``--selftest`` builds a synthetic dataset in-process and checks the
aggregate + rendering end to end (no device work).

Examples::

    python -m porqua_tpu_torch.cli.serve_loadgen \\
        --harvest-out /tmp/harvest.jsonl --rings 16
    python -m porqua_tpu_torch.cli.harvest_report /tmp/harvest.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List


def render_table(agg: Dict[str, Any]) -> str:
    lines = [
        f"harvest dataset: {agg['records']} records "
        f"({agg['ring_records']} with ring trajectories)",
        "sources: " + ", ".join(f"{k} x{v}"
                                for k, v in sorted(agg["sources"].items())),
    ]
    tenants = agg.get("tenants")
    if tenants:
        # Schema v2: per-(tenant, bucket, eps) groups. v1 datasets
        # read back with the legacy sentinel tenant.
        lines.append("tenants: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(tenants.items())))
    lines += [
        "",
        f"{'tenant':<14} {'bucket':<12} {'eps_abs':>9} {'count':>6} "
        f"{'p50':>6} "
        f"{'p95':>6} {'max':>6} {'wasted':>7} {'warm':>5} {'cold':>5} "
        f"{'w-c iters':>9}  status",
    ]
    for g in agg["groups"]:
        eps = g["eps_abs"]
        wc = g.get("warm_minus_cold_iters_mean")
        status = ",".join(f"{k}:{v}"
                          for k, v in sorted(g["status_counts"].items()))
        lines.append(
            f"{g.get('tenant', '-'):<14} {g['bucket']:<12} "
            f"{(f'{eps:.0e}' if eps is not None else '-'):>9} "
            f"{g['count']:>6} {g['iters']['p50']:>6.0f} "
            f"{g['iters']['p95']:>6.0f} {g['iters']['max']:>6.0f} "
            f"{g['wasted_iteration_fraction']:>7.3f} "
            f"{g['warm_count']:>5} {g['cold_count']:>5} "
            f"{(f'{wc:+.1f}' if wc is not None else '-'):>9}  {status}")
    solver_lines = _render_solver_table(agg)
    if solver_lines:
        lines += [""] + solver_lines
    return "\n".join(lines)


def _solver_winner(by_solver: Dict[str, Dict[str, Any]]) -> str:
    """The backend this cell's evidence favors — the same ordering
    :meth:`porqua_tpu_torch.serve.routing.SolverRouter.seed_from_aggregate`
    uses (solved share first, then mean dispatch latency when every
    backend has one, then iteration p95, then name), re-stated here
    on plain dicts so the report needs no service."""
    have_lat = all(e.get("solve_s_mean") is not None
                   for e in by_solver.values())

    def score(item):
        name, e = item
        solved = e["status_counts"].get("1", 0) / max(e["count"], 1)
        primary = (e["solve_s_mean"] if have_lat else e["iters"]["p95"])
        return (-solved, primary, e["iters"]["p95"], name)

    return min(by_solver.items(), key=score)[0]


def _render_solver_table(agg: Dict[str, Any]) -> List[str]:
    """Per-(tenant, bucket, eps) backend comparison — one row per
    backend with evidence in the cell (ADMM/PDHG/NAPG, or any future
    addition: the table grows with the dataset's ``by_solver`` axis).
    Rendered only when the dataset actually carries the backend axis
    with more than one backend somewhere (a pure pre-PDHG dataset,
    where every record reads back as "admm", adds no section). ``win``
    marks the backend the routing seed would pick for the cell."""
    rows = [g for g in agg["groups"] if g.get("by_solver")]
    if not any(len(g["by_solver"]) > 1 for g in rows):
        return []
    lines = [
        "solver comparison (routing evidence per cell; win = seed pick; "
        "routed = router dispatches vs shadow re-solves):",
        f"{'tenant':<14} {'bucket':<12} {'eps_abs':>9} {'solver':<6} "
        f"{'count':>6} {'routed':>6} {'p50':>6} {'p95':>6} "
        f"{'solve_ms':>9} {'solved%':>8} {'win':>4}",
    ]
    for g in rows:
        eps = g["eps_abs"]
        winner = _solver_winner(g["by_solver"])
        for sv, e in sorted(g["by_solver"].items()):
            lat = e.get("solve_s_mean")
            solved = (100.0 * e["status_counts"].get("1", 0)
                      / max(e["count"], 1))
            lines.append(
                f"{g.get('tenant', '-'):<14} {g['bucket']:<12} "
                f"{(f'{eps:.0e}' if eps is not None else '-'):>9} "
                f"{sv:<6} {e['count']:>6} {e.get('routed', 0):>6} "
                f"{e['iters']['p50']:>6.0f} "
                f"{e['iters']['p95']:>6.0f} "
                f"{(f'{lat * 1e3:.2f}' if lat is not None else '-'):>9} "
                f"{solved:>7.0f}% {('*' if sv == winner else ''):>4}")
    return lines


def render_calibration_table(records: List[Dict[str, Any]]) -> List[str]:
    """The calibration-evidence table: the closed-loop audit chain
    (``source="calibration.audit"`` records the live
    :class:`porqua_tpu_torch.obs.Calibrator` lands in the warehouse at every
    candidate/promote/rollback). Each changed cell renders with the
    shadow win-rate and sample count the promotion was gated on, the
    route flip, and the table version at the action; the final line is
    the active table the chain replays to. Empty when the dataset
    carries no audit records (every pre-calibration dataset). Plain
    dict reads, as the rest of the report."""
    audits = sorted((r for r in records
                     if r.get("source") == "calibration.audit"),
                    key=lambda r: (int(r.get("table_version", 0)),
                                   float(r.get("t", 0.0))))
    if not audits:
        return []
    lines = [
        "calibration audit (closed-loop route re-seeding; win% = "
        "shadow win rate gating the action):",
        f"{'action':<10} {'version':>7} {'cell':<16} {'route':<12} "
        f"{'samples':>7} {'win%':>5}  reason",
    ]
    for rec in audits:
        action = rec.get("action", "?")
        version = int(rec.get("table_version", 0))
        reason = rec.get("reason", "")
        diff = rec.get("diff") or {}
        if not diff:
            lines.append(f"{action:<10} {version:>7} {'-':<16} "
                         f"{'-':<12} {'-':>7} {'-':>5}  {reason}")
            continue
        for cell, d in sorted(diff.items()):
            shadow = (d.get("evidence") or {}).get("shadow") or {}
            samples = shadow.get("samples")
            win = shadow.get("win_rate")
            route = f"{d.get('old', '?')}->{d.get('new', '?')}"
            lines.append(
                f"{action:<10} {version:>7} {cell:<16} {route:<12} "
                f"{(str(samples) if samples is not None else '-'):>7} "
                f"{(f'{win * 100:.0f}' if win is not None else '-'):>5}"
                f"  {reason}")
    swaps = [r for r in audits
             if r.get("action") in ("promote", "rollback")]
    if swaps:
        last = swaps[-1]
        table = ", ".join(
            f"{c}:{m}"
            for c, m in sorted((last.get("table") or {}).items()))
        lines.append(f"active table v{int(last.get('table_version', 0))}"
                     f": {table or '(empty)'}")
    return lines


def _selftest() -> int:
    from porqua_tpu_torch.obs.harvest import (
        HarvestSink, aggregate, load_harvest, solve_record)
    from porqua_tpu_torch.qp.solve import SolverParams

    import tempfile

    p_loose = SolverParams(eps_abs=1e-3, eps_rel=1e-3)
    p_tight = SolverParams(eps_abs=1e-5, eps_rel=1e-5)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "harvest.jsonl.gz")
        with HarvestSink(path) as sink:
            # Two (bucket, eps) groups with a known structure: tight-eps
            # records straggle (one lane at 500 iters), warm starts
            # save 50 iters on average.
            for i in range(16):
                sink.emit(solve_record(
                    "serve", 24, 1, 1, 25, 1e-4, 1e-4, -1.0,
                    params=p_loose, bucket="32x4", warm=False,
                    ring={"iters": [25], "prim_res": [1e-4],
                          "dual_res": [1e-4], "rho": [0.1]}))
            for i in range(8):
                warm = i % 2 == 0
                iters = (100 if warm else 150) if i < 7 else 500
                sink.emit(solve_record(
                    "batch", 500, 1, 1 if i < 7 else 2, iters,
                    1e-6, 1e-6, -2.0, params=p_tight, bucket="512x4",
                    warm=warm, warm_src="explicit" if warm else None))
        records = load_harvest(path)
        assert len(records) == 24, len(records)

    agg = aggregate(records)
    assert agg["records"] == 24 and agg["ring_records"] == 16, agg
    assert agg["sources"] == {"serve": 16, "batch": 8}, agg["sources"]
    by_bucket = {g["bucket"]: g for g in agg["groups"]}
    loose, tight = by_bucket["32x4"], by_bucket["512x4"]
    assert loose["wasted_iteration_fraction"] == 0.0, loose
    # 7 lanes at <=6 segments + 1 at 20 segments: the straggler tax.
    assert tight["wasted_iteration_fraction"] > 0.5, tight
    assert tight["warm_minus_cold_iters_mean"] < 0, tight
    assert tight["iters"]["max"] == 500.0, tight

    # Tenant axis (schema v2): tagged records group per (tenant,
    # bucket, eps); untagged producers land on the "default" lane.
    tagged = records + [solve_record(
        "serve", 24, 1, 1, 30, 1e-4, 1e-4, -1.0, params=p_loose,
        bucket="32x4", tenant="fund-a")]
    agg2 = aggregate(tagged)
    assert agg2["tenants"] == {"default": 24, "fund-a": 1}, agg2["tenants"]
    keys = {(g["tenant"], g["bucket"]) for g in agg2["groups"]}
    assert ("fund-a", "32x4") in keys and ("default", "32x4") in keys

    text = render_table(agg2)
    for needle in ("32x4", "512x4", "1e-05", "serve x17", "batch x8",
                   "fund-a", "tenants: default x24, fund-a x1"):
        assert needle in text, f"selftest: {needle!r} missing:\n{text}"
    # A solver-absent dataset (every record above) renders NO backend
    # section — those records all read back as "admm" and a
    # one-backend table says nothing.
    assert "solver comparison" not in text, text

    # The backend axis: shadow-compare records put every backend in
    # one cell; the comparison table renders one row per backend with
    # the seed pick marked. PDHG solves the cell in a third of the
    # iterations and half the dispatch latency -> it wins the
    # three-way cell; NAPG's matured-but-slower stream renders as a
    # contender row without flipping the pick.
    p_pdhg = SolverParams(eps_abs=1e-3, eps_rel=1e-3, method="pdhg")
    p_napg = SolverParams(eps_abs=1e-3, eps_rel=1e-3, method="napg")
    routed = list(records)
    for i in range(16):
        routed.append(solve_record(
            "serve.shadow", 24, 1, 1, 9, 1e-4, 1e-4, -1.0,
            params=p_pdhg, bucket="32x4", solve_s=5e-4,
            shadow_of="admm", delta_iters=-16, agree=True))
    for i in range(8):
        routed.append(solve_record(
            "serve.shadow", 24, 1, 1, 40, 1e-4, 1e-4, -1.0,
            params=p_napg, bucket="32x4", solve_s=2e-3,
            shadow_of="admm", delta_iters=15, agree=True))
    agg3 = aggregate(routed)
    cell = next(g for g in agg3["groups"] if g["bucket"] == "32x4")
    assert set(cell["by_solver"]) == {"admm", "pdhg", "napg"}, cell
    assert _solver_winner(cell["by_solver"]) == "pdhg", cell
    # Routed-decision counts: the 16 serve dispatches all ran on the
    # router's pick (admm); the pdhg/napg records are shadow
    # re-solves, so their evidence cells show counts but routed 0.
    assert cell["by_solver"]["admm"]["routed"] == 16, cell
    assert cell["by_solver"]["pdhg"]["routed"] == 0, cell
    assert cell["by_solver"]["napg"]["routed"] == 0, cell
    text3 = render_table(agg3)
    for needle in ("solver comparison", "pdhg", "napg",
                   "serve.shadow x24", "routed"):
        assert needle in text3, f"selftest: {needle!r} missing:\n{text3}"
    assert text3.count("*") >= 1, text3
    pdhg_row = next(ln for ln in text3.splitlines()
                    if " pdhg " in f" {ln} " and "32x4" in ln)
    assert " 16 " in pdhg_row and " 0 " in pdhg_row, pdhg_row
    napg_row = next(ln for ln in text3.splitlines()
                    if " napg " in f" {ln} " and "32x4" in ln)
    assert " 8 " in napg_row and " 0 " in napg_row, napg_row
    # A dataset without audit records renders no calibration section.
    assert render_calibration_table(routed) == [], "unexpected audit"

    # Calibration audit chain: a promote (with the evidence diff the
    # gate held — shadow win-rate + sample counts) and a rollback.
    # Audit records carry no solve fields, so the aggregate must count
    # them as annotations (never a group) while the calibration table
    # renders the chain and the active table it replays to.
    audited = list(routed)
    audited.append({
        "v": 1, "source": "calibration.audit", "t": 10.0,
        "action": "promote", "table_version": 1,
        "table": {"32x4@1e-03": "pdhg"}, "prior_table": {},
        "diff": {"32x4@1e-03": {
            "old": "admm", "new": "pdhg",
            "evidence": {"shadow": {"samples": 16, "wins": 15,
                                    "win_rate": 0.9375}}}}})
    audited.append({
        "v": 1, "source": "calibration.audit", "t": 20.0,
        "action": "rollback", "table_version": 2, "table": {},
        "prior_table": {"32x4@1e-03": "pdhg"}, "diff": {},
        "reason": "anomaly_fired +1 since promotion"})
    agg4 = aggregate(audited)
    assert agg4["annotations"] == 2, agg4["annotations"]
    assert agg4["sources"].get("calibration.audit") == 2, agg4["sources"]
    text4 = "\n".join(render_calibration_table(audited))
    for needle in ("calibration audit", "promote", "32x4@1e-03",
                   "admm->pdhg", " 16 ", "94", "rollback",
                   "anomaly_fired +1 since promotion",
                   "active table v2: (empty)"):
        assert needle in text4, f"selftest: {needle!r} missing:\n{text4}"

    print(text)
    print("\nharvest_report selftest: ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("datasets", nargs="*",
                    help="harvest JSONL(.gz) files (HarvestSink output)")
    ap.add_argument("--json", action="store_true",
                    help="print the aggregate as JSON instead of a table")
    ap.add_argument("--out", default=None,
                    help="also write the aggregate JSON here")
    ap.add_argument("--selftest", action="store_true",
                    help="synthetic dataset through aggregate + render")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest()
    if not args.datasets:
        ap.error("give at least one harvest dataset (or --selftest)")

    from porqua_tpu_torch.obs.harvest import aggregate, load_harvest

    records: List[Dict[str, Any]] = []
    for path in args.datasets:
        records.extend(load_harvest(path))
    agg = aggregate(records)
    agg["datasets"] = list(args.datasets)
    if args.json:
        print(json.dumps(agg, indent=1))
    else:
        print(render_table(agg))
        cal_lines = render_calibration_table(records)
        if cal_lines:
            print()
            print("\n".join(cal_lines))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(agg, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
