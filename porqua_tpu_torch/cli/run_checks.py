"""graftcheck CLI: run the static-analysis suite over a source tree.

Usage:
    python -m porqua_tpu_torch.cli.run_checks [paths ...] [options]

Defaults to scanning ``porqua_tpu_torch/`` — every package subtree,
the command-line tools under ``cli/`` among them, which must scan
clean with zero suppressions — with every AST rule (GC001-GC010;
GC007 enforces the ``if faults.enabled():`` guard on every
fault-injection seam; GC008-GC010 are the concurrency plane — shared
state inferred from the thread-root reachability graph, static
lock-order deadlock detection, and blocking calls under a lock — whose
runtime half is the ``PORQUA_TSAN=1`` lock-order sanitizer exercised
by ``python -m porqua_tpu_torch.cli.tsan_smoke``) plus the op-trace
contracts (GC101-GC111) of :mod:`porqua_tpu_torch.analysis.contracts`
against the real entry points run on ``--device``: no host reads or
transfers inside a program, the declared dtypes, and the identity
contracts (a live fault injector, the telemetry, SLO, flight, devprof,
fleet, tenancy, routing and calibration planes leave every program's
op trace identical to the bare one). With ``--hlo`` (or a
``--select`` naming any GC20x rule) the op-trace lint runs too:
:mod:`porqua_tpu_torch.analysis.hlo` records every entry point and
:mod:`porqua_tpu_torch.analysis.hlolint` lints the traces — GC201
fusion miss, GC202 redundant materialization, GC203 layout churn,
GC204 bucket-ladder padding waste, GC205 peak budget, GC206 dtype
drift — against the committed ``porqua_tpu_torch/testdata/
op_baseline.json`` (peak budgets, padding budgets, suppression table).
Exit status: 0 clean, 1 findings, 2 internal/usage error.

Options:
    --format {text,json}   output format (default text)
    --select GC001,GC002   run only these rules (AST, contract, or
                           GC20x op-trace rules)
    --no-contracts         skip the op-trace contract checks (used when
                           scanning fixture trees that are not the
                           real package)
    --hlo                  also record + lint every entry point's op
                           trace (GC201-GC206)
    --stats                emit per-rule finding AND suppression
                           counts (JSON: a "stats" object in the
                           payload, schema 2; text: a summary block)
    --device DEVICE        where the contracts and the op-trace harvest
                           run (default: the card, which they need
                           unless given ``cpu``)

Suppressions: ``# graftcheck: disable=GC00x`` (line),
``# graftcheck: disable-file=GC00x`` (file).
"""

import argparse
import json
import os
import sys

#: The port's package directory: the default scan path.
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The op-trace contract rules (``analysis.contracts``).
_CONTRACT_RULES = {f"GC{n}" for n in range(101, 112)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="run_checks",
        description="graftcheck: static analysis for porqua_tpu_torch")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories "
                             "(default: porqua_tpu_torch/)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to run")
    parser.add_argument("--no-contracts", action="store_true",
                        help="skip the op-trace entry-point contracts")
    parser.add_argument("--hlo", action="store_true",
                        help="record + lint every entry point's op trace "
                             "(GC201-GC206)")
    parser.add_argument("--stats", action="store_true",
                        help="emit per-rule finding/suppression counts")
    parser.add_argument("--device", default=None,
                        help="device the contracts and the op-trace "
                             "harvest run on (default: the card)")
    args = parser.parse_args(argv)

    paths = args.paths or [_PACKAGE]
    for p in paths:
        if not os.path.exists(p):
            print(f"run_checks: path does not exist: {p}", file=sys.stderr)
            return 2
    rules = None
    if args.select:
        rules = {r.strip() for r in args.select.split(",") if r.strip()}

    from porqua_tpu_torch.analysis.hlolint import HLO_RULES
    from porqua_tpu_torch.analysis.lint import (RULE_DOCS, iter_py_files,
                                                scan_paths)

    hlo_rules = set(HLO_RULES)

    if not iter_py_files(paths):
        # A gate that scanned zero files must not report "clean" —
        # that is how a typo'd CI invocation silently goes vacuous.
        print(f"run_checks: no Python files found under {paths}",
              file=sys.stderr)
        return 2

    stats: dict = {}
    findings = scan_paths(paths, rules=rules,
                          stats_out=stats if args.stats else None)

    if not args.no_contracts and (rules is None
                                  or rules & _CONTRACT_RULES):
        try:
            from porqua_tpu_torch.analysis import contracts

            findings += contracts.check_entry_points(device=args.device)
        except Exception as exc:  # noqa: BLE001 - CLI boundary
            # A run that *errors* is not a clean pass: report as an
            # internal failure (exit 2) rather than pretending the
            # contracts ran.
            print(f"run_checks: op-trace contracts failed: {exc!r}",
                  file=sys.stderr)
            return 2

    if args.hlo or (rules is not None and rules & hlo_rules):
        try:
            from porqua_tpu_torch.analysis import hlo as hlo_harvest

            findings += hlo_harvest.lint_harvest(
                hlo_harvest.harvest_entry_points(device=args.device),
                baseline=hlo_harvest.load_baseline(),
                rules=(rules & hlo_rules if rules is not None else None),
                stats_out=stats if args.stats else None)
        except Exception as exc:  # noqa: BLE001 - CLI boundary
            # Same bar as the contracts: a harvest that errors is not
            # a clean pass.
            print(f"run_checks: op-trace harvest failed: {exc!r}",
                  file=sys.stderr)
            return 2

    if rules is not None:
        # --select filters everything reported, the contract and
        # op-trace findings included. GC000 (file does not parse) is
        # exempt: a file the linter cannot read must never report
        # clean, whatever was selected.
        findings = [f for f in findings
                    if f.rule in rules or f.rule == "GC000"]

    if args.stats:
        # Contract and op-trace findings land after the AST scan:
        # recount per rule over the final (selected) finding list so the
        # stats describe exactly what is reported; the baseline's
        # suppression table folds into suppressions_by_rule.
        stats["schema"] = 2
        by_rule: dict = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        stats["findings_by_rule"] = by_rule
        for rule, n in stats.get("hlo_suppressions_by_rule", {}).items():
            sup = stats.setdefault("suppressions_by_rule", {})
            sup[rule] = sup.get(rule, 0) + n
        stats["suppressions_total"] = sum(
            stats.get("suppressions_by_rule", {}).values())

    if args.format == "json":
        payload = {
            "findings": [f.to_dict() for f in findings],
            "count": len(findings),
            "rules": RULE_DOCS,
        }
        if args.stats:
            payload["stats"] = stats
        print(json.dumps(payload, indent=2))
    else:
        for f in findings:
            print(f.format())
        if args.stats:
            print("rule      findings  suppressions")
            names = sorted(set(stats["findings_by_rule"])
                           | set(stats["suppressions_by_rule"]))
            for rule in names:
                print(f"{rule:<9} {stats['findings_by_rule'].get(rule, 0):>8}"
                      f"  {stats['suppressions_by_rule'].get(rule, 0):>12}")
            print(f"files scanned: {stats['files']}; suppressions "
                  f"total: {stats['suppressions_total']}")
        n = len(findings)
        print(f"graftcheck: {n} finding{'s' if n != 1 else ''}"
              + ("" if n else " — clean"))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
