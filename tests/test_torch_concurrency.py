"""GC006 and GC008-GC010 in the port (``porqua_tpu_torch.analysis.
guards`` and ``.concurrency``) against the JAX package's checkers.

Each case re-runs one snippet test of ``tests/test_analysis.py`` or
``tests/test_concurrency.py`` with its ``scan_paths`` wrapped: the JAX
checker's findings go back to the test (whose own assertions run as
before) and every scanned file is also scanned by the port's checker.
Restricted to GC006/GC008-GC010, the two give the same ``(rule, path,
line, col)`` set on every shared snippet. The port tree itself scans
clean under these rules, as the JAX tree does under its own.
"""

import importlib
import inspect
import os

import pytest

from porqua_tpu_torch.analysis.lint import scan_paths as port_scan

RULES = {"GC006", "GC008", "GC009", "GC010"}

CASES = [("test_analysis", name) for name in (
    "test_gc006_guarded_by",
    "test_gc006_setitem_slice_and_rotate_mutators",
    "test_gc006_nested_def_does_not_inherit_lock",
)] + [("test_concurrency", name) for name in (
    "test_gc008_multi_root_mutation_detected",
    "test_gc008_single_root_and_locked_state_clean",
    "test_gc008_caller_holds_annotation_protects",
    "test_gc008_callback_root_counts",
    "test_gc009_inversion_reports_both_sites",
    "test_gc009_cross_object_cycle_through_call_graph",
    "test_gc009_consistent_order_clean",
    "test_gc010_untimed_queue_and_sleep_under_lock",
    "test_gc010_result_compile_and_transitive",
    "test_gc010_untimed_event_wait_flagged_condition_wait_exempt",
    "test_gc010_block_true_is_not_a_bound",
    "test_gc008_positional_thread_target_and_timer_function_kwarg",
    "test_gc008_tuple_assign_reports_both_attrs",
    "test_gc010_positional_block_and_timeout_spellings",
    "test_gc008_bound_method_callback_is_a_root",
    "test_concurrency_rules_clean_on_shipped_tree",
    "test_stats_count_findings_and_suppressions",
)]


def _key(findings):
    return sorted((f.rule, os.path.abspath(f.path), f.line, f.col)
                  for f in findings if f.rule in RULES)


@pytest.mark.parametrize("module,name", CASES,
                         ids=[name for _, name in CASES])
def test_same_findings_as_the_jax_checker(module, name, tmp_path,
                                          monkeypatch):
    mod = importlib.import_module(f"tests.{module}")
    real = mod.scan_paths
    compared = []

    def both(paths, rules=None, stats_out=None):
        theirs = real(paths, rules=rules, stats_out=stats_out)
        wanted = RULES if rules is None else set(rules) & RULES
        if wanted:
            mine = port_scan(paths, rules=wanted)
            compared.append((_key(theirs), _key(mine)))
        return theirs

    monkeypatch.setattr(mod, "scan_paths", both)
    fn = getattr(mod, name)
    kwargs = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: kwargs[p] for p in inspect.signature(fn).parameters})
    assert compared, f"{name} scanned nothing"
    for theirs, mine in compared:
        assert mine == theirs


def test_port_tree_clean_under_the_concurrency_rules():
    import porqua_tpu_torch

    pkg = os.path.dirname(porqua_tpu_torch.__file__)
    stats = {}
    findings = port_scan([pkg], rules=RULES, stats_out=stats)
    assert [f.format() for f in findings] == []
    assert stats["files"] > 80
    assert stats["suppressions_by_rule"] == {}
