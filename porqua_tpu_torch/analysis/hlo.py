"""The op-trace harvester: every entry-point program, run and recorded
(the port of ``porqua_tpu/analysis/hlo.py``).

The JAX package lowers each entry point through
``jit(...).lower(...).compile()`` and reads the optimized HLO, the
compiler's cost and memory analyses and the HLO fingerprint. The port's
"lowered program" is what runs: :func:`record_program` runs a program
on real inputs under a ``TorchDispatchMode`` and records every aten op
(its name, operands, result dtype and shape, device) and every
hand-written kernel launch, as text, one op per line
(:mod:`porqua_tpu_torch.analysis.hlolint` gives the format and parses
it back). With it come

* the cost plane's flops and bytes (:mod:`porqua_tpu_torch.obs.devprof`
  counts the same run);
* the peak: on the card the ``torch.cuda.max_memory_allocated`` delta
  over the run plus the arguments already there; on the CPU the
  arguments plus the high-water mark of the live op outputs (a result
  counts from its op until its tensor is freed);
* the fingerprint: a blake2b digest of the trace text (op, operands,
  dtype, shape and device of every line);
* the declared host reads (``sanitize.explicit_transfer()``) and the
  segments the run stepped, which the contracts hold against each other.

The programs are the ``*_program`` builders of
:mod:`porqua_tpu_torch.analysis.contracts` (one definition of "the
program" for both planes), at the JAX programs' own sizes on seeded
problems. The baseline is the port's own file,
``porqua_tpu_torch/testdata/op_baseline.json`` (fingerprints, cost,
peak budgets, padding cells, the finding counts at build time and the
empty suppression table); it is recorded on the CPU, where the trace is
the plain twins' ops.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from porqua_tpu_torch.analysis import hlolint, sanitize
from porqua_tpu_torch.analysis.lint import Finding

__all__ = [
    "BASELINE_SCHEMA_VERSION",
    "DEFAULT_BASELINE_PATH",
    "HarvestedProgram",
    "bench_hlo_part",
    "bucket_padding_cells",
    "build_baseline",
    "compare_fingerprints",
    "entry_point_programs",
    "harvest_entry_points",
    "lint_harvest",
    "load_baseline",
    "lower_program",
    "padding_findings",
    "record_program",
]

#: Bump when a baseline field changes meaning.
BASELINE_SCHEMA_VERSION = 1

#: The committed fingerprint/budget file of the port.
DEFAULT_BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "testdata", "op_baseline.json")

#: Peak-memory headroom the baseline grants each program (GC205 bound =
#: peak x headroom at build time).
PEAK_HEADROOM = 1.25

_HLO_DTYPES = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int32: "s32", torch.int64: "s64",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}


_SHAPES: Dict[tuple, str] = {}


def _shape_text(t: torch.Tensor) -> str:
    key = (t.dtype, tuple(t.shape))
    text = _SHAPES.get(key)
    if text is None:
        dims = ",".join(str(d) for d in t.shape)
        text = _SHAPES[key] = f"{_HLO_DTYPES.get(t.dtype, str(t.dtype))}[{dims}]"
    return text


def _literal(a) -> str:
    """A non-tensor operand as trace text; objects without a stable
    text (a generator) by their type."""
    if isinstance(a, (list, tuple)):
        return "[" + ",".join(_literal(b) for b in a) + "]"
    if isinstance(a, float):
        return repr(a)
    if isinstance(a, torch.dtype):
        return _HLO_DTYPES.get(a, str(a))
    if a is None or isinstance(a, (bool, int, str, torch.device,
                                   torch.layout, torch.memory_format)):
        return str(a).replace(" ", "")
    return type(a).__name__


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpRecording:
    """What one recorded run gives: the trace text and what was counted
    beside it."""

    text: str
    n_ops: int
    fingerprint: str
    flops: float
    bytes_accessed: float
    kernel_launches: Dict[str, int]
    segments: int
    peak_bytes: Optional[float]
    declared_reads: int
    output: Any = None


_Tensor = torch.Tensor
_LOCAL_SCALAR = torch.ops.aten._local_scalar_dense.default


def _counter_class():
    from porqua_tpu_torch.obs import devprof

    class _Recorder(devprof._Counter):
        """devprof's counter (flops, bytes, launches, segments) that also
        writes the op trace."""

        def __init__(self, label: str, cost: bool) -> None:
            super().__init__()
            self.label = label
            self.cost = cost
            self._ops: Dict[Any, str] = {}
            self.lines: List[str] = [f"OpTrace {label}"]
            self._names: Dict[int, Tuple[Any, str]] = {}
            self._next = 0
            self._consts = 0
            self._kernels = 0
            self.declared = 0
            self.live = 0
            self.peak = 0

        def name_of(self, t: torch.Tensor) -> str:
            hit = self._names.get(id(t))
            if hit is not None and hit[0]() is t:
                return hit[1]
            name = f"c{self._consts}"
            self._consts += 1
            self.lines.append(f"%{name} = const() -> {_shape_text(t)} "
                              f"@{t.device}")
            self._bind(t, name)
            return name

        def _bind(self, t: torch.Tensor, name: str) -> None:
            # A weak reference: holding the tensor would change the run
            # (autograd adds a detach for a result Python still holds).
            self._names[id(t)] = (weakref.ref(t), name)

        def param(self, t: torch.Tensor, i: int) -> None:
            name = f"a{i}"
            self.lines.append(f"%{name} = param() -> {_shape_text(t)} "
                              f"@{t.device}")
            self._bind(t, name)
            if self.cost:
                self.live += t.untyped_storage().nbytes()
                self.peak = max(self.peak, self.live)

        def _track(self, t: torch.Tensor) -> None:
            nbytes = t.untyped_storage().nbytes()
            self.live += nbytes
            self.peak = max(self.peak, self.live)

            def free(n=nbytes, rec=weakref.ref(self)):
                r = rec()
                if r is not None:
                    r.live -= n

            weakref.finalize(t, free)

        def record(self, func, args, kwargs, out) -> None:
            operands = []
            in_ptrs = set()
            name_of = self.name_of
            for a in (*args, *kwargs.values()) if kwargs else args:
                if isinstance(a, _Tensor):
                    operands.append("%" + name_of(a))
                    if self.cost and a.device.type != "meta":
                        in_ptrs.add(a.untyped_storage().data_ptr())
                elif isinstance(a, (list, tuple)) and any(
                        isinstance(b, _Tensor) for b in a):
                    for b in a:
                        if isinstance(b, _Tensor):
                            operands.append("%" + name_of(b))
                            if self.cost and b.device.type != "meta":
                                in_ptrs.add(b.untyped_storage().data_ptr())
                else:
                    operands.append("#" + _literal(a))
            names, shapes, device = [], [], None
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if not isinstance(t, _Tensor):
                    continue
                name = str(self._next)
                self._next += 1
                self._bind(t, name)
                names.append("%" + name)
                shapes.append(_shape_text(t))
                device = t.device
                if self.cost and not func.is_view \
                        and t.device.type != "meta" \
                        and t.untyped_storage().data_ptr() not in in_ptrs:
                    self._track(t)
            if not names:
                names = [f"%{self._next}"]
                self._next += 1
                shapes = ["scalar"]
                device = next((a.device for a in args
                               if isinstance(a, _Tensor)), "cpu")
            shape = shapes[0] if len(shapes) == 1 else \
                "(" + ", ".join(shapes) + ")"
            declared = ""
            if sanitize._EXPLICIT.get():
                declared = " !declared"
                if func is _LOCAL_SCALAR:
                    self.declared += 1
            op = self._ops.get(func)
            if op is None:
                op = self._ops[func] = str(func)
            self.lines.append(
                f"{', '.join(names)} = {op}({', '.join(operands)}) -> "
                f"{shape} @{device}{declared}")

        def kernel(self, name: str, form: str, flops: float,
                   nbytes: float) -> None:
            super().kernel(name, form, flops, nbytes)
            self.lines.append(f"%k{self._kernels} = kernel:{name}/{form}() "
                              "-> () @card")
            self._kernels += 1

    return _Recorder


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def record_program(label: str, fn, args, device=None,
                   cost: bool = True) -> OpRecording:
    """Run ``fn(*args)`` once under the op recorder; returns its trace
    and counts (:class:`OpRecording`, the output included). The ops run
    as they would without it, so the output is the same bits.
    ``cost=False`` records the trace, the launches, the segments and
    the declared reads only (flops, bytes and the CPU peak stay 0): the
    contracts' fast path."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from porqua_tpu_torch.obs import devprof

    rec = _counter_class()(label, cost)
    leaves = list(_leaves(args))
    for i, t in enumerate(leaves):
        rec.param(t, i)

    class _TraceMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if rec.cost:
                rec.op(func, args, kwargs, out)
            rec.record(func, args, kwargs, out)
            return out

    dev = next((t.device for t in leaves if t.is_cuda), None)
    if dev is None and device is not None and \
            torch.device(device).type == "cuda":
        dev = torch.device(device)
    if dev is not None and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    token = devprof._COUNTER.set(rec)
    try:
        if dev is not None:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        with _TraceMode():
            out = fn(*args)
        if dev is not None:
            torch.cuda.synchronize(dev)
            peak = float(torch.cuda.max_memory_allocated(dev) - before
                         + sum(t.nbytes for t in leaves if t.device == dev))
        else:
            peak = float(rec.peak)
    finally:
        devprof._COUNTER.reset(token)
    text = "\n".join(rec.lines) + "\n"
    c = rec.call
    return OpRecording(
        text=text, n_ops=len(rec.lines) - 1 - len(leaves) - rec._consts,
        fingerprint=hashlib.blake2b(text.encode(), digest_size=8).hexdigest(),
        flops=c.flops, bytes_accessed=c.bytes_accessed,
        kernel_launches=dict(c.kernel_launches), segments=c.segments,
        peak_bytes=peak, declared_reads=rec.declared, output=out)


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

def entry_point_programs(dtype=torch.float32,
                         factor_rows: int = 8,
                         ring_size: int = 8,
                         device=None):
    """Every program ``contracts.check_entry_points`` sweeps, as
    ``[(label, fn, example_args)]`` on ``device`` (default: the card),
    with the JAX package's labels. ``serve_entry`` /
    ``serve_entry[pdhg]`` / ``serve_entry[napg]`` are the routed
    dispatch set."""
    from porqua_tpu_torch.analysis import contracts
    from porqua_tpu_torch.qp.solve import SolverParams

    progs: List[Tuple[str, Any, tuple]] = []
    kw = dict(dtype=dtype, device=device)

    def add(label: str, pair) -> None:
        fn, args = pair
        progs.append((label, fn, args))

    add("solve_batch", contracts.solve_batch_program(**kw))
    add("solve_batch[factored]", contracts.solve_batch_program(
        factor_rows=factor_rows, **kw))
    add("serve_entry", contracts.serve_entry_program(**kw))
    add("serve_entry[factored]", contracts.serve_entry_program(
        factor_rows=factor_rows, **kw))
    add("tracking_step", contracts.tracking_program(**kw))
    if ring_size:
        rings = SolverParams(ring_size=ring_size)
        add("solve_batch[rings]", contracts.solve_batch_program(
            params=rings, **kw))
        add("serve_entry[rings]", contracts.serve_entry_program(
            params=rings, **kw))
    add("compaction_step", contracts.compaction_step_program(**kw))
    add("compaction_step[factored]", contracts.compaction_step_program(
        factor_rows=factor_rows, **kw))
    progs += contracts.continuous_programs(**kw)
    for method in ("pdhg", "napg"):
        p = SolverParams(method=method)
        add(f"solve_batch[{method}]", contracts.solve_batch_program(
            params=p, **kw))
        add(f"serve_entry[{method}]", contracts.serve_entry_program(
            params=p, **kw))
        if ring_size:
            add(f"solve_batch[{method},rings]", contracts.solve_batch_program(
                params=SolverParams(method=method, ring_size=ring_size),
                **kw))
        add(f"compaction_step[{method}]", contracts.compaction_step_program(
            params=p, **kw))
        for label, fn, args in contracts.continuous_programs(params=p, **kw):
            progs.append((f"{label}[{method}]", fn, args))
    # The sketch-fed tracking path (window 8 -> sketch dimension 4
    # compresses, exercising the enabled branch).
    add("tracking_step[sketch]", contracts.tracking_program(
        params=SolverParams(sketch_dim=4), **kw))
    return progs


@dataclasses.dataclass
class HarvestedProgram:
    """One recorded entry point and everything the lint reads off it."""

    label: str
    hlo_text: str
    fingerprint: Optional[str]
    flops: Optional[float]
    bytes_accessed: Optional[float]
    memory: Dict[str, Optional[float]]
    compile_s: float
    record: Dict[str, Any]  #: the devprof CostRecord (warehouse schema)
    n_ops: int = 0

    @property
    def peak_bytes(self) -> Optional[float]:
        return self.memory.get("peak_bytes")

    def parse(self) -> "hlolint.OpTrace":
        return hlolint.parse_trace(self.hlo_text)


def lower_program(label: str, fn, args,
                  cost_log=None) -> HarvestedProgram:
    """Record one program and capture its cost, peak and fingerprint.
    The CostRecord goes through
    :func:`porqua_tpu_torch.obs.devprof.cost_record` (kind
    ``"hlolint"``) so the harvest shares the warehouse schema, and
    optionally lands in a live ``CostLog``. ``compile_s`` is the
    recorded run's seconds."""
    from porqua_tpu_torch.obs.devprof import CountedCall, cost_record

    t0 = time.perf_counter()
    r = record_program(label, fn, args)
    seconds = time.perf_counter() - t0
    leaves = list(_leaves(args))
    device = leaves[0].device.type if leaves else "cpu"
    counted = CountedCall(
        flops=r.flops, bytes_accessed=r.bytes_accessed,
        kernel_launches=r.kernel_launches, segments=r.segments,
        op_hash=r.fingerprint,
        argument_bytes=float(sum(t.nbytes for t in leaves)),
        output_bytes=float(sum(t.nbytes for t in _leaves(r.output))),
        peak_bytes=r.peak_bytes)
    rec = cost_record(counted, entry=label, kind="hlolint", device=device,
                      compile_s=seconds)
    if cost_log is not None:
        cost_log.emit(rec)
    return HarvestedProgram(
        label=label, hlo_text=r.text, fingerprint=r.fingerprint,
        flops=r.flops, bytes_accessed=r.bytes_accessed,
        memory={"peak_bytes": r.peak_bytes,
                "argument_bytes": counted.argument_bytes,
                "output_bytes": counted.output_bytes},
        compile_s=seconds, record=rec, n_ops=r.n_ops)


def harvest_entry_points(dtype=torch.float32,
                         factor_rows: int = 8,
                         ring_size: int = 8,
                         labels: Optional[Iterable[str]] = None,
                         cost_log=None,
                         progress=None,
                         device=None) -> List[HarvestedProgram]:
    """Record every entry-point program (optionally only ``labels``) on
    ``device`` (default: the card). ``progress`` is an optional
    ``callable(label, seconds)`` hook for CLIs."""
    wanted = set(labels) if labels is not None else None
    out: List[HarvestedProgram] = []
    for label, fn, args in entry_point_programs(
            dtype=dtype, factor_rows=factor_rows, ring_size=ring_size,
            device=device):
        if wanted is not None and label not in wanted:
            continue
        hp = lower_program(label, fn, args, cost_log=cost_log)
        if progress is not None:
            progress(label, hp.compile_s)
        out.append(hp)
    return out


# ---------------------------------------------------------------------------
# GC204 — bucket-ladder padding cells
# ---------------------------------------------------------------------------

def _qp_lane_bytes(n: int, m: int, dtype=torch.float32) -> int:
    """Input bytes of one lane of the batched QP at shape (n, m), from
    the solver's own ``batch_shape_struct``."""
    from porqua_tpu_torch.qp.solve import batch_shape_struct

    struct = batch_shape_struct(1, n, m, dtype=dtype)
    return int(sum(t.numel() * t.element_size()
                   for t in _leaves(tuple(struct))))


def bucket_padding_cells(n_rungs: Optional[Sequence[int]] = None,
                         m_rungs: Optional[Sequence[int]] = None,
                         dtype=torch.float32) -> List[Dict[str, Any]]:
    """The worst-case dead-lane byte share per bucket of the serving
    ladder: for each ``(n, m)`` rung pair, the natural shape that pads
    worst is one past the previous rung on both axes (the GC204
    cells)."""
    from porqua_tpu_torch.serve.bucketing import (DEFAULT_M_RUNGS,
                                                  DEFAULT_N_RUNGS)

    n_rungs = tuple(n_rungs or DEFAULT_N_RUNGS)
    m_rungs = tuple(m_rungs or DEFAULT_M_RUNGS)
    cells: List[Dict[str, Any]] = []
    for i, n in enumerate(n_rungs):
        nat_n = (n_rungs[i - 1] + 1) if i else 1
        for j, m in enumerate(m_rungs):
            nat_m = (m_rungs[j - 1] + 1) if j else 1
            padded = _qp_lane_bytes(n, m, dtype=dtype)
            natural = _qp_lane_bytes(nat_n, nat_m, dtype=dtype)
            cells.append({
                "bucket": f"{n}x{m}",
                "natural": f"{nat_n}x{nat_m}",
                "padded_bytes": padded,
                "natural_bytes": natural,
                "share": 1.0 - natural / padded,
            })
    return cells


def padding_findings(cells: Iterable[Dict[str, Any]],
                     budgets: Optional[Dict[str, float]] = None,
                     default_budget: float = 0.25) -> List[Finding]:
    """GC204 over ladder cells: each cell's worst-case share against
    its per-bucket budget (``budgets[bucket]``, else the default)."""
    findings: List[Finding] = []
    budgets = budgets or {}
    for idx, cell in enumerate(cells):
        bucket = cell["bucket"]
        findings += hlolint.check_padding_waste(
            f"bucket_ladder[{bucket}]",
            natural_bytes=cell["natural_bytes"],
            padded_bytes=cell["padded_bytes"],
            budget=float(budgets.get(bucket, default_budget)),
            bucket=bucket, line=idx + 1)
    return findings


# ---------------------------------------------------------------------------
# lint harness + baseline
# ---------------------------------------------------------------------------

def lint_harvest(programs: Sequence[HarvestedProgram],
                 baseline: Optional[Dict[str, Any]] = None,
                 config: Optional[hlolint.LintConfig] = None,
                 rules: Optional[Iterable[str]] = None,
                 include_padding: bool = True,
                 stats_out: Optional[Dict[str, Any]] = None,
                 ) -> List[Finding]:
    """Run GC201-GC206 over a harvest. The baseline supplies the GC205
    peak budgets, the GC204 budgets and the suppression table; without
    one GC205 checks nothing and GC204 uses the default budget."""
    base_programs = (baseline or {}).get("programs", {})
    base_padding = (baseline or {}).get("padding", {})
    findings: List[Finding] = []
    for hp in programs:
        entry = base_programs.get(hp.label, {})
        findings += hlolint.lint_module(
            hp.parse(), hp.label, config=config, peak_bytes=hp.peak_bytes,
            peak_budget=entry.get("peak_budget"), rules=rules)
    selected = set(rules) if rules is not None else set(hlolint.HLO_RULES)
    if include_padding and "GC204" in selected:
        findings += padding_findings(
            bucket_padding_cells(),
            budgets=base_padding.get("budgets"),
            default_budget=float(base_padding.get("default_budget", 0.25)))
    findings, suppressed = hlolint.apply_suppressions(
        findings, (baseline or {}).get("suppressions", ()))
    if stats_out is not None:
        stats_out["hlo_programs"] = len(programs)
        stats_out["hlo_suppressions_by_rule"] = suppressed
    return findings


def load_baseline(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Read the committed baseline; ``None`` when absent."""
    path = path or DEFAULT_BASELINE_PATH
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def build_baseline(programs: Sequence[HarvestedProgram],
                   config: Optional[hlolint.LintConfig] = None,
                   padding_margin: float = 0.02) -> Dict[str, Any]:
    """The committed file: per-program fingerprints, cost, GC205 peak
    budgets (peak x headroom), the finding counts at build time (the
    "no more than the baseline" floor), the GC204 ladder cells with
    per-bucket budgets (share + margin) and the empty suppression
    table."""
    cfg = config or hlolint.LintConfig()
    entries: Dict[str, Any] = {}
    for hp in programs:
        found = hlolint.lint_module(hp.parse(), hp.label, config=cfg,
                                    peak_bytes=hp.peak_bytes,
                                    peak_budget=None)
        by_rule: Dict[str, int] = {}
        for f in found:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        peak = hp.peak_bytes
        entries[hp.label] = {
            "fingerprint": hp.fingerprint,
            "flops": hp.flops,
            "bytes_accessed": hp.bytes_accessed,
            "peak_bytes": peak,
            "peak_budget": (None if peak is None
                            else float(int(peak * PEAK_HEADROOM))),
            "ops": hp.n_ops,
            "findings_by_rule": by_rule,
        }
    cells = bucket_padding_cells()
    budgets = {c["bucket"]: round(c["share"] + padding_margin, 4)
               for c in cells}
    return {
        "schema": BASELINE_SCHEMA_VERSION,
        "dtype": "float32",
        "device": "cpu",
        "config": dataclasses.asdict(cfg),
        "programs": entries,
        "padding": {"default_budget": cfg.padding_budget,
                    "budgets": budgets, "cells": cells},
        "suppressions": [],
    }


def compare_fingerprints(baseline: Dict[str, Any],
                         programs: Sequence[HarvestedProgram],
                         ) -> Dict[str, List[str]]:
    """Diff a fresh harvest's fingerprints against the baseline's:
    ``flipped`` (a program whose op trace changed), ``missing``
    (baseline programs the harvest lost) and ``new``."""
    base = baseline.get("programs", {})
    fresh = {hp.label: hp.fingerprint for hp in programs}
    flipped = sorted(
        label for label, fp in fresh.items()
        if label in base and base[label].get("fingerprint")
        and fp and fp != base[label]["fingerprint"])
    missing = sorted(set(base) - set(fresh))
    new = sorted(set(fresh) - set(base))
    return {"flipped": flipped, "missing": missing, "new": new}


def bench_hlo_part(baseline: Optional[Dict[str, Any]] = None,
                   programs: Optional[Sequence[HarvestedProgram]] = None,
                   dtype=torch.float32, device=None) -> Dict[str, Any]:
    """A harvest linted against the baseline, summarized: program
    coverage, finding counts in total, by rule and by program,
    fingerprint flips and the widest program's bytes."""
    if baseline is None:
        baseline = load_baseline()
    if programs is None:
        programs = harvest_entry_points(dtype=dtype, device=device)
    findings = lint_harvest(programs, baseline=baseline)
    by_program: Dict[str, int] = {}
    by_rule: Dict[str, int] = {}
    for f in findings:
        prog = hlolint.path_program(f.path) or f.path
        by_program[prog] = by_program.get(prog, 0) + 1
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    top = max(programs, key=lambda hp: hp.bytes_accessed or 0.0,
              default=None)
    flips = (compare_fingerprints(baseline, programs)["flipped"]
             if baseline else [])
    part: Dict[str, Any] = {
        "programs": len(programs),
        "findings_total": len(findings),
        "findings_by_rule": by_rule,
        "findings_by_program": by_program,
        "findings_max_per_program": max(by_program.values(), default=0),
        "fingerprint_flips": len(flips),
        "flipped_programs": flips,
        "compile_s_total": round(sum(hp.compile_s for hp in programs), 3),
    }
    if top is not None:
        part["top_target"] = top.label
        part["top_target_bytes"] = top.bytes_accessed
    return part
