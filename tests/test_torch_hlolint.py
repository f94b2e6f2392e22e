"""The port's rules over the op trace (GC201-GC206) and its harvester.

Seeded op-trace text for every rule of
``porqua_tpu_torch.analysis.hlolint`` (the rule id and the line it
anchors to), the parser, the suppression table, the recorder on a real
call, ``bucket_padding_cells`` against the JAX package's, and the
committed op baseline (``porqua_tpu_torch/testdata/op_baseline.json``):
each entry point recorded on the CPU has the baseline's fingerprint,
stays within its peak budget and has no more findings than recorded.

Rewrite the baseline after an intended change to a program::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hlolint.py --write-baseline
"""

import functools
import json
import sys

import pytest
import torch

from porqua_tpu_torch.analysis import hlo
from porqua_tpu_torch.analysis.hlolint import (
    LintConfig, apply_suppressions, check_dtype_drift, check_fusion_miss,
    check_layout_churn, check_padding_waste,
    check_redundant_materialization, check_temp_peak, hlo_path,
    lint_module, parse_trace, path_program, shape_bytes)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The baseline is recorded on one thread: the iteration counts (and
    # so the traces) hold bit for bit only in one summation order.
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def trace(lines, name="prog"):
    return parse_trace("\n".join([f"OpTrace {name}", *lines]) + "\n")


BIG = "f32[256,512]"     # 512 KiB: over every byte threshold
SMALL = "f32[4,16]"


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def test_parser_reads_every_field():
    t = trace([
        "%a0 = param() -> f32[4,16] @cpu",
        "%c0 = const() -> f32[16] @cpu",
        "%0 = aten.mul.Tensor(%a0, %c0) -> f32[4,16] @cpu",
        "%1, %2 = aten.max.dim(%0, #1) -> (f32[4], s64[4]) @cuda:0",
        "%3 = aten._local_scalar_dense.default(%1) -> scalar @cuda:0 "
        "!declared",
        "%k0 = kernel:admm_segment/cluster() -> () @card",
        "not an op line",
    ])
    assert t.name == "prog"
    assert [i.op for i in t.params] == ["param"]
    assert [i.name for i in t.ops] == ["0", "1", "3", "k0"]
    mul = t.by_name["0"]
    assert mul.operands == ("a0", "c0") and mul.base == "mul"
    assert mul.bytes == 256 and mul.line == 4
    mx = t.by_name["2"]
    assert mx.names == ("1", "2") and mx.device == "cuda:0"
    assert mx.bytes == 4 * 4 + 8 * 4
    read = t.by_name["3"]
    assert read.declared and read.shape == "scalar" and read.bytes == 0
    assert t.by_name["k0"].op == "kernel:admm_segment/cluster"


def test_shape_arithmetic_and_anchors():
    assert shape_bytes("f32[4,16]") == 256
    assert shape_bytes("pred[8]") == 8
    assert shape_bytes("(f64[2], s32[])") == 20
    assert shape_bytes("scalar") == 0
    assert path_program(hlo_path("serve_entry[pdhg]")) == "serve_entry[pdhg]"
    assert path_program("qp/admm.py") is None


# ---------------------------------------------------------------------------
# seeded rules
# ---------------------------------------------------------------------------

def test_gc201_fusion_miss_ranked_widest_first():
    t = trace([
        "%a0 = param() -> f32[256,512] @cpu",
        f"%0 = aten.mul.Tensor(%a0, %a0) -> f32[128,512] @cpu",
        "%1 = aten.add.Tensor(%0, %a0) -> f32[128,512] @cpu",
        f"%2 = aten.sub.Tensor(%a0, %a0) -> {BIG} @cpu",
        "%3 = aten.sum.dim_IntList(%2, #[-1]) -> f32[256] @cpu",
        f"%4 = aten.mul.Tensor(%a0, %a0) -> {SMALL} @cpu",
        "%5 = aten.add.Tensor(%4, %4) -> f32[4,16] @cpu",
    ])
    found = check_fusion_miss(t, "p")
    assert [(f.rule, f.line) for f in found] == [("GC201", 5), ("GC201", 3)]
    assert "sub -> sum" in found[0].message
    assert check_fusion_miss(t, "p", min_bytes=1 << 30) == []


def test_gc202_same_op_same_operands():
    t = trace([
        "%a0 = param() -> f32[256,512] @cpu",
        f"%0 = aten.mul.Tensor(%a0, #2.0) -> {BIG} @cpu",
        f"%1 = aten.mul.Tensor(%a0, #3.0) -> {BIG} @cpu",
        f"%2 = aten.mul.Tensor(%a0, #2.0) -> {BIG} @cpu",
        f"%3 = aten.add_.Tensor(%a0, #1.0) -> {BIG} @cpu",
        f"%4 = aten.add_.Tensor(%a0, #1.0) -> {BIG} @cpu",
        f"%5 = aten.zeros.default(#[256,512]) -> {BIG} @cpu",
        f"%6 = aten.zeros.default(#[256,512]) -> {BIG} @cpu",
        f"%7 = aten.neg.default(%a0) -> {SMALL} @cpu",
        f"%8 = aten.neg.default(%a0) -> {SMALL} @cpu",
    ])
    found = check_redundant_materialization(t, "p")
    assert [(f.rule, f.line) for f in found] == [("GC202", 5)]
    assert "repeats %0" in found[0].message


def test_gc203_copy_chains():
    t = trace([
        "%a0 = param() -> f32[256,512] @cpu",
        f"%0 = aten.transpose.int(%a0, #0, #1) -> f32[512,256] @cpu",
        f"%1 = aten.clone.default(%0) -> f32[512,256] @cpu",
        f"%2 = aten.clone.default(%a0) -> {BIG} @cpu",
        f"%3 = aten.transpose.int(%a0, #0, #1) -> f32[16,4] @cpu",
        f"%4 = aten.clone.default(%3) -> f32[16,4] @cpu",
    ])
    assert [(f.rule, f.line) for f in check_layout_churn(t, "p")] == \
        [("GC203", 4)]
    assert check_layout_churn(t, "p", min_bytes=1 << 30) == []


def test_gc204_padding_waste_both_forms():
    found = check_padding_waste("p", natural_bytes=100, padded_bytes=400,
                                budget=0.5, bucket="32x8")
    assert [(f.rule, f.line) for f in found] == [("GC204", 1)]
    assert "bucket 32x8" in found[0].message
    assert check_padding_waste("p", 300, 400, budget=0.5) == []
    t = trace(["%a0 = param() -> f32[10,10] @cpu",
               "%a1 = param() -> f32[10] @cpu"])
    assert [f.line for f in check_padding_waste(
        "p", natural_bytes=100, module=t, budget=0.5)] == [2]


def test_gc205_peak_budget():
    assert [f.rule for f in check_temp_peak("p", 2000.0, 1000.0)] == ["GC205"]
    assert check_temp_peak("p", 900.0, 1000.0) == []
    assert check_temp_peak("p", None, 1000.0) == []
    assert check_temp_peak("p", 2000.0, None) == []


def test_gc206_dtype_drift_once_per_op():
    t = trace([
        "%a0 = param() -> f32[4] @cpu",
        "%0 = aten._to_copy.default(%a0, #f64) -> f64[4] @cpu",
        "%1 = aten._to_copy.default(%0, #f64) -> f64[4] @cpu",
        "%2 = aten.mul.Tensor(%0, %0) -> f64[4] @cpu",
        "%3 = aten.mul.Tensor(%a0, %a0) -> f32[4] @cpu",
    ])
    found = check_dtype_drift(t, "p")
    assert [(f.rule, f.line) for f in found] == [("GC206", 3), ("GC206", 5)]
    assert check_dtype_drift(t, "p", expect_float="f64") == []


def test_lint_module_config_and_rule_selection():
    t = trace([
        "%a0 = param() -> f32[256,512] @cpu",
        f"%0 = aten.sub.Tensor(%a0, %a0) -> {BIG} @cpu",
        "%1 = aten.sum.default(%0) -> f32[] @cpu",
        "%2 = aten._to_copy.default(%1, #f64) -> f64[] @cpu",
    ])
    rules = [f.rule for f in lint_module(t, "p", peak_bytes=10.0,
                                         peak_budget=5.0)]
    assert sorted(rules) == ["GC201", "GC205", "GC206"]
    assert [f.rule for f in lint_module(t, "p", rules={"GC206"})] == \
        ["GC206"]
    assert lint_module(t, "p", config=LintConfig(
        fusion_miss_min_bytes=1 << 30), rules={"GC201"}) == []


def test_suppressions_need_a_reason():
    f1 = check_temp_peak("a", 2.0, 1.0)[0]
    f2 = check_temp_peak("b", 2.0, 1.0)[0]
    kept, counts = apply_suppressions([f1, f2], [
        {"program": "a", "rule": "GC205", "reason": "known"},
        {"program": "b", "rule": "GC205"}])
    assert kept == [f2] and counts == {"GC205": 1}
    kept, counts = apply_suppressions([f1, f2], [
        {"program": "*", "rule": "GC205", "reason": "all"}])
    assert kept == [] and counts == {"GC205": 2}


# ---------------------------------------------------------------------------
# the recorder and the ladder cells
# ---------------------------------------------------------------------------

def test_record_program_runs_the_same_bits():
    a = torch.arange(12.0).reshape(3, 4)
    b = torch.ones(4, 2)

    def fn(x, y):
        z = (x @ y) * 2.0
        return z.sum(dim=-1), z

    rec = hlo.record_program("probe", fn, (a, b))
    ref = fn(a, b)
    assert all(torch.equal(u, v) for u, v in zip(rec.output, ref))
    t = parse_trace(rec.text)
    assert t.name == "probe" and [p.shape for p in t.params] == \
        ["f32[3,4]", "f32[4,2]"]
    assert [i.base for i in t.ops] == ["mm", "mul", "sum"]
    assert t.ops[0].operands == ("a0", "a1")
    assert rec.n_ops == 3 and rec.flops == 2 * 3 * 4 * 2
    # At the peak: the arguments (48 + 32 B), the product and z (24 B
    # each; the product is freed once the multiply has read it).
    assert rec.peak_bytes == 48 + 32 + 24 + 24
    assert hlo.record_program("probe", fn, (a, b)).fingerprint == \
        rec.fingerprint


def test_bucket_padding_cells_equal_the_jax_packages():
    import jax.numpy as jnp

    from porqua_tpu.analysis import hlo as jax_hlo

    mine = hlo.bucket_padding_cells()
    theirs = jax_hlo.bucket_padding_cells(dtype=jnp.float32)
    assert mine == theirs
    assert hlo.padding_findings(mine) == [] or all(
        f.rule == "GC204" for f in hlo.padding_findings(mine))


# ---------------------------------------------------------------------------
# the committed baseline
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def programs():
    return {label: (fn, args) for label, fn, args in
            hlo.entry_point_programs(device="cpu")}


def baseline():
    base = hlo.load_baseline()
    assert base is not None, "no committed op baseline"
    return base


def test_baseline_covers_every_entry_point_and_is_clean():
    base = baseline()
    assert set(base["programs"]) == set(programs())
    assert base["suppressions"] == []
    assert base["device"] == "cpu" and base["dtype"] == "float32"
    assert base["padding"]["cells"] == hlo.bucket_padding_cells()
    assert hlo.padding_findings(
        base["padding"]["cells"], budgets=base["padding"]["budgets"]) == []


def _labels():
    base = hlo.load_baseline()
    return sorted(base["programs"]) if base else []


@pytest.mark.parametrize("label", _labels())
def test_program_matches_the_baseline(label):
    entry = baseline()["programs"][label]
    fn, args = programs()[label]
    hp = hlo.lower_program(label, fn, args)
    assert hp.fingerprint == entry["fingerprint"], \
        f"{label}: the op trace changed ({hp.n_ops} ops, baseline " \
        f"{entry['ops']}); rewrite the baseline if the change is intended"
    assert hp.n_ops == entry["ops"]
    assert hp.peak_bytes <= entry["peak_budget"]
    found = hlo.lint_harvest([hp], baseline=baseline(),
                             include_padding=False)
    by_rule = {}
    for f in found:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    for rule, count in by_rule.items():
        assert count <= entry["findings_by_rule"].get(rule, 0), (label, rule)
    assert hp.record["kind"] == "hlolint" and hp.record["entry"] == label


def write_baseline(path=hlo.DEFAULT_BASELINE_PATH):
    """Record every entry point on the CPU (one thread) and write the
    baseline."""
    torch.set_num_threads(1)
    progs = hlo.harvest_entry_points(
        device="cpu", progress=lambda label, s: print(
            f"{label}: {s:.2f} s", file=sys.stderr))
    base = hlo.build_baseline(progs)
    with open(path, "w") as f:
        json.dump(base, f, indent=1, sort_keys=True)
        f.write("\n")
    return base


if __name__ == "__main__":
    if "--write-baseline" in sys.argv:
        write_baseline()
