"""Op-trace lint report: findings joined to the roofline.

The reader half of the op-trace lint plane: records every
``contracts`` entry-point program on ``--device``
(:mod:`porqua_tpu_torch.analysis.hlo`: a real run under a dispatch
mode, one aten op or kernel launch per line), runs the GC201-GC206
rules (:mod:`porqua_tpu_torch.analysis.hlolint`) against the
baseline's budgets, diffs every program's fingerprint against the
baseline's — a flip on an unchanged source tree names the program
whose op trace changed — and joins the finding table with a measured
roofline verdict (``roofline_report --out``) so a GC201 fusion miss and
the roofline's top fusion candidate point at the same program by the
same measured-bytes axis.

The committed baseline, ``porqua_tpu_torch/testdata/op_baseline.json``,
is recorded on the CPU on one thread; every op line of a fingerprint
names its device, so a harvest on the card is compared against a
baseline harvested on the card (``--harvest --baseline PATH``).

Modes::

    # rebuild the baseline (fingerprints, peak/padding budgets, finding
    # floors) after an intentional program change; writes only the
    # --baseline file (default the committed one):
    python -m porqua_tpu_torch.cli.hlolint_report --harvest --device cpu

    # the report mode: fresh harvest vs the baseline (exit 1 on
    # findings or fingerprint flips; with --labels, only the named
    # programs' baseline entries are compared):
    python -m porqua_tpu_torch.cli.hlolint_report --device cpu \\
        --roofline roofline_verdict.json --out hlolint_report.json

    # write a payload file carrying only the config_hlo part (the
    # harvest summarized against the baseline):
    python -m porqua_tpu_torch.cli.hlolint_report --device cpu \\
        --bench-part hlo_payload.json

``--selftest`` seeds one violation per rule into synthetic op-trace
text and asserts rule id + program + location, plus the suppression
and fingerprint-flip joins — no device work.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _fingerprint_status(label: str, diff: dict) -> str:
    if label in diff.get("flipped", ()):
        return "FLIPPED"
    if label in diff.get("new", ()):
        return "new"
    return "ok"


def build_report(programs, baseline, findings, stats,
                 roofline=None) -> dict:
    """The machine-readable join: per-program harvest rows with
    fingerprint status, the finding table, and (when a roofline verdict
    is supplied) the measured-bytes agreement between the lint's
    widest program and the roofline's top fusion candidate."""
    from porqua_tpu_torch.analysis import hlo, hlolint

    diff = (hlo.compare_fingerprints(baseline, programs)
            if baseline else {"flipped": [], "missing": [],
                              "new": [hp.label for hp in programs]})
    by_rule: dict = {}
    by_program: dict = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        prog = hlolint.path_program(f.path) or f.path
        by_program[prog] = by_program.get(prog, 0) + 1
    rows = []
    for hp in sorted(programs, key=lambda h: -(h.bytes_accessed or 0.0)):
        rows.append({
            "program": hp.label,
            "hlo_lines": hp.hlo_text.count("\n") + 1,
            "flops": hp.flops,
            "bytes_accessed": hp.bytes_accessed,
            "peak_bytes": hp.peak_bytes,
            "compile_s": round(hp.compile_s, 3),
            "fingerprint": hp.fingerprint,
            "fingerprint_status": _fingerprint_status(hp.label, diff),
            "findings": by_program.get(hp.label, 0),
        })
    report = {
        "programs": rows,
        "findings": [f.to_dict() for f in findings],
        "findings_by_rule": by_rule,
        "findings_by_program": by_program,
        "fingerprints": diff,
        "suppressed_by_rule": stats.get("hlo_suppressions_by_rule", {}),
        "baseline_schema": (baseline or {}).get("schema"),
        "clean": not findings and not diff["flipped"]
        and not diff["missing"],
    }
    if roofline:
        cands = roofline.get("fusion_candidates") or []
        top_hlo = rows[0]["program"] if rows else None
        top_roofline = cands[0].get("entry") if cands else None
        # The join is by the shared measured-bytes axis: the lint's
        # widest program should be the family the roofline's top
        # candidate names (roofline entries are short stage names —
        # "step", "solve" — inside the lint's program labels).
        agree = bool(top_hlo and top_roofline
                     and str(top_roofline) in str(top_hlo))
        report["roofline"] = {
            "top_candidate": top_roofline,
            "top_candidate_bytes": (cands[0].get("bytes_accessed")
                                    if cands else None),
            "top_hlo_program": top_hlo,
            "top_hlo_bytes": rows[0]["bytes_accessed"] if rows else None,
            "agree": agree,
            "verdict": roofline.get("verdict"),
        }
    return report


def _render(report: dict, top: int = 24) -> str:
    lines = [f"hlolint: {len(report['programs'])} programs harvested, "
             f"{len(report['findings'])} finding(s)"]
    lines.append(f"  {'program':<28} {'lines':>6} {'MB acc':>8} "
                 f"{'peak MB':>8} {'compile s':>9} {'find':>4}  fingerprint")
    for row in report["programs"][:top]:
        ba = row.get("bytes_accessed") or 0
        pk = row.get("peak_bytes") or 0
        lines.append(
            f"  {row['program']:<28} {row['hlo_lines']:>6} "
            f"{ba / 1e6:>8.2f} {pk / 1e6:>8.2f} "
            f"{row['compile_s']:>9.2f} {row['findings']:>4}  "
            f"{row['fingerprint_status']}")
    fps = report["fingerprints"]
    for kind in ("flipped", "missing"):
        if fps.get(kind):
            lines.append(f"  fingerprints {kind}: "
                         + ", ".join(fps[kind])
                         + (" — the program re-lowered differently on "
                            "this tree" if kind == "flipped" else
                            " — harvest coverage regressed"))
    if report.get("suppressed_by_rule"):
        lines.append("  suppressed: " + ", ".join(
            f"{r}={n}" for r, n in
            sorted(report["suppressed_by_rule"].items())))
    for f in report["findings"]:
        lines.append(f"  {f['path']}:{f['line']}:{f['col']}: "
                     f"{f['rule']} {f['message']}")
    rj = report.get("roofline")
    if rj:
        lines.append(
            f"  roofline join: lint top {rj['top_hlo_program']} "
            f"({(rj['top_hlo_bytes'] or 0) / 1e6:.2f} MB) vs verdict "
            f"top {rj['top_candidate']} "
            f"({(rj['top_candidate_bytes'] or 0) / 1e6:.2f} MB) — "
            + ("same target" if rj["agree"] else "targets differ"))
    lines.append("hlolint: " + ("clean" if report["clean"]
                                else "NOT clean"))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# selftest — one seeded violation per rule, no device work
# ---------------------------------------------------------------------------

_SEED_GC201 = """\
OpTrace seed201
%a0 = param() -> f32[256,256] @cpu
%a1 = param() -> f32[256,256] @cpu
%0 = aten.mul.Tensor(%a0, %a1) -> f32[256,256] @cpu
%1 = aten.add.Tensor(%0, %a0) -> f32[256,256] @cpu
"""

_SEED_GC202 = """\
OpTrace seed202
%a0 = param() -> f32[64,64] @cpu
%a1 = param() -> f32[64,64] @cpu
%0 = aten.mul.Tensor(%a0, %a1) -> f32[64,64] @cpu
%1 = aten.mul.Tensor(%a0, %a1) -> f32[64,64] @cpu
%2 = aten.sub.Tensor(%0, %1) -> f32[64,64] @cpu
"""

_SEED_GC203 = """\
OpTrace seed203
%a0 = param() -> f32[128,128] @cpu
%0 = aten.transpose.int(%a0, #0, #1) -> f32[128,128] @cpu
%1 = aten.clone.default(%0) -> f32[128,128] @cpu
"""

_SEED_GC206 = """\
OpTrace seed206
%a0 = param() -> f32[32,32] @cpu
%0 = aten._to_copy.default(%a0, #f64) -> f64[32,32] @cpu
%1 = aten.mm.default(%0, %0) -> f64[32,32] @cpu
%2 = aten._to_copy.default(%1, #f32) -> f32[32,32] @cpu
"""

_SEED_CLEAN = """\
OpTrace clean
%a0 = param() -> f32[64,64] @cpu
%a1 = param() -> f32[64,64] @cpu
%0 = aten.mm.default(%a0, %a1) -> f32[64,64] @cpu
%k0 = kernel:admm_segment/cluster() -> () @card
"""


def _selftest() -> int:
    """One seeded violation per GC20x rule through the real parser and
    rules, asserting rule id + program anchor + trace line; then the
    suppression, stats, and fingerprint-flip joins through
    lint_harvest/build_report — synthetic text only, no device work."""
    from porqua_tpu_torch.analysis import hlo, hlolint

    def one(findings, rule, program):
        assert len(findings) == 1, (rule, [f.format() for f in findings])
        f = findings[0]
        assert f.rule == rule, f.format()
        assert f.path == hlolint.hlo_path(program), f.format()
        return f

    # GC201: the unfused mul->add pair, anchored at the producer.
    mod = hlolint.parse_trace(_SEED_GC201)
    f = one(hlolint.lint_module(mod, "seed201"), "GC201", "seed201")
    assert f.line == 4 and "mul -> add" in f.message, f.format()

    # GC202: the same op on identical operands twice, anchored at the
    # repeat.
    mod = hlolint.parse_trace(_SEED_GC202)
    f = one(hlolint.lint_module(mod, "seed202"), "GC202", "seed202")
    assert f.line == 5 and "repeats %0" in f.message, f.format()
    # The same repeat under the byte floor is noise, not a finding.
    tiny = hlolint.check_redundant_materialization(
        mod, "seed202", min_bytes=1 << 20)
    assert tiny == [], [x.format() for x in tiny]

    # GC203: transpose feeding clone, anchored at the consumer.
    mod = hlolint.parse_trace(_SEED_GC203)
    f = one(hlolint.lint_module(mod, "seed203"), "GC203", "seed203")
    assert f.line == 4 and "transpose" in f.message, f.format()

    # GC204: a ladder cell 90% dead against a 25% budget.
    f = one(hlolint.check_padding_waste(
        "bucket_ladder[512x8]", natural_bytes=1000.0,
        padded_bytes=10000.0, budget=0.25, bucket="512x8", line=3),
        "GC204", "bucket_ladder[512x8]")
    assert f.line == 3 and "512x8" in f.message, f.format()

    # GC205: measured peak over the committed bound.
    f = one(hlolint.check_temp_peak("seed205", peak_bytes=2.0e6,
                                    budget_bytes=1.5e6, line=1),
            "GC205", "seed205")
    assert "2000000" in f.message and "1500000" in f.message, f.format()

    # GC206: an f64 product inside an f32 program (one finding per op;
    # the widening copy anchors first).
    mod = hlolint.parse_trace(_SEED_GC206)
    found = hlolint.lint_module(mod, "seed206")
    assert [x.rule for x in found] == ["GC206", "GC206"], found
    assert found[0].line == 3 and "f64" in found[0].message
    assert found[0].path == hlolint.hlo_path("seed206")

    # The clean trace reports nothing.
    assert hlolint.lint_module(hlolint.parse_trace(_SEED_CLEAN),
                               "clean") == []

    # lint_harvest join: a synthetic harvest through the baseline's
    # budgets, suppressions, and stats plumbing (no device work — the
    # HarvestedProgram rows are hand-built).
    def hp(label, text, fingerprint, bytes_accessed, peak):
        return hlo.HarvestedProgram(
            label=label, hlo_text=text, fingerprint=fingerprint,
            flops=1.0e6, bytes_accessed=bytes_accessed,
            memory={"peak_bytes": peak}, compile_s=0.1,
            record={"entry": label})

    programs = [hp("seed202", _SEED_GC202, "aa", 4.0e6, 2.0e6),
                hp("clean", _SEED_CLEAN, "bb", 8.0e6, 1.0e6)]
    baseline = {
        "schema": hlo.BASELINE_SCHEMA_VERSION,
        "programs": {
            "seed202": {"fingerprint": "aa", "peak_budget": 1.5e6},
            "clean": {"fingerprint": "FLIP", "peak_budget": 4.0e6},
            "gone": {"fingerprint": "cc"},
        },
        "padding": {"budgets": {}},
        "suppressions": [
            {"program": "seed202", "rule": "GC202",
             "reason": "seeded repeat, selftest only"},
            {"program": "seed202", "rule": "GC205"},  # no reason: ignored
        ],
    }
    stats: dict = {}
    findings = hlo.lint_harvest(programs, baseline=baseline,
                                include_padding=False, stats_out=stats)
    # GC202 suppressed (with reason), GC205 NOT (reasonless entry);
    # the surviving finding is seed202's peak over budget.
    assert stats["hlo_programs"] == 2
    assert stats["hlo_suppressions_by_rule"] == {"GC202": 1}, stats
    assert [f.rule for f in findings] == ["GC205"], (
        [f.format() for f in findings])

    # build_report: the fingerprint diff names the flipped program and
    # the lost one; the roofline join agrees when the verdict's top
    # candidate names the lint's widest program.
    roofline = {"fusion_candidates": [
        {"entry": "clean", "bytes_accessed": 8.0e6}],
        "verdict": "top fusion target: clean"}
    report = build_report(programs, baseline, findings, stats,
                          roofline=roofline)
    assert report["fingerprints"]["flipped"] == ["clean"]
    assert report["fingerprints"]["missing"] == ["gone"]
    assert report["findings_by_rule"] == {"GC205": 1}
    assert report["suppressed_by_rule"] == {"GC202": 1}
    assert not report["clean"]
    assert report["programs"][0]["program"] == "clean"  # widest first
    assert report["programs"][0]["fingerprint_status"] == "FLIPPED"
    assert report["roofline"]["agree"] is True
    text = _render(report)
    for needle in ("hlolint: 2 programs", "FLIPPED", "missing: gone",
                   "GC205", "suppressed: GC202=1", "roofline join",
                   "same target", "NOT clean"):
        assert needle in text, f"selftest: {needle!r} missing\n{text}"

    # A clean harvest against a matching baseline renders clean.
    ok = build_report(
        [hp("clean", _SEED_CLEAN, "bb", 8.0e6, 1.0e6)],
        {"programs": {"clean": {"fingerprint": "bb",
                                "peak_budget": 4.0e6}},
         "suppressions": []},
        [], {})
    assert ok["clean"] and "clean" in _render(ok)
    print("hlolint_report selftest: ok")
    return 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--harvest", action="store_true",
                    help="rebuild the baseline artifact from a fresh "
                         "harvest and write it to --baseline")
    ap.add_argument("--baseline", default=None,
                    help="baseline artifact path (default the "
                         "committed porqua_tpu_torch/testdata/"
                         "op_baseline.json)")
    ap.add_argument("--labels", default=None,
                    help="comma-separated program labels to restrict "
                         "the harvest (default: every entry point)")
    ap.add_argument("--roofline", default=None,
                    help="a roofline_report --out verdict JSON to "
                         "join against")
    ap.add_argument("--bench-part", default=None,
                    help="write a minimal payload file carrying the "
                         "config_hlo part here")
    ap.add_argument("--out", default=None,
                    help="write the machine-readable report JSON here")
    ap.add_argument("--selftest", action="store_true",
                    help="seeded violation per rule + joins; no "
                         "device work")
    ap.add_argument("--device", default=None,
                    help="device the entry points run on (default: the "
                         "card)")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest()

    from porqua_tpu_torch.analysis import hlo

    baseline_path = args.baseline or hlo.DEFAULT_BASELINE_PATH
    labels = ([s.strip() for s in args.labels.split(",") if s.strip()]
              if args.labels else None)

    def progress(label, seconds):
        print(f"  recorded {label} in {seconds:.1f}s", file=sys.stderr)

    programs = hlo.harvest_entry_points(labels=labels, progress=progress,
                                        device=args.device)
    if not programs:
        print("hlolint_report: harvest matched no programs",
              file=sys.stderr)
        return 2

    if args.harvest:
        artifact = hlo.build_baseline(programs)
        with open(baseline_path, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=True)
            f.write("\n")
        total = sum(sum(e["findings_by_rule"].values())
                    for e in artifact["programs"].values())
        print(f"baseline written to {baseline_path}: "
              f"{len(artifact['programs'])} programs, "
              f"{len(artifact['padding']['budgets'])} padding cells, "
              f"{total} finding(s) recorded as the floor")
        return 0

    baseline = hlo.load_baseline(baseline_path)
    if baseline is None:
        print(f"hlolint_report: no baseline at {baseline_path} — run "
              "--harvest first (comparing against nothing would be a "
              "vacuous pass)", file=sys.stderr)
        return 2
    if labels is not None:
        # A restricted harvest is held against the baseline's entries
        # for the requested programs: the others were not asked for,
        # so they are not coverage the harvest lost.
        baseline = dict(baseline, programs={
            k: v for k, v in baseline.get("programs", {}).items()
            if k in labels})

    stats: dict = {}
    findings = hlo.lint_harvest(programs, baseline=baseline,
                                stats_out=stats)
    roofline = None
    if args.roofline:
        with open(args.roofline) as f:
            roofline = json.load(f)
    report = build_report(programs, baseline, findings, stats,
                          roofline=roofline)
    report["baseline_path"] = baseline_path
    print(_render(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report written to {args.out}")
    if args.bench_part:
        part = hlo.bench_hlo_part(baseline=baseline, programs=programs)
        payload = {"t": time.time(), "source": "hlolint_report",
                   "config_hlo": part}
        with open(args.bench_part, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"bench part written to {args.bench_part}")
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
