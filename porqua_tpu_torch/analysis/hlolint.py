"""hlolint for the port: rules over a program's recorded op trace (the
port of ``porqua_tpu/analysis/hlolint.py``).

The JAX package lints the optimized HLO that XLA emits. The port has no
compiler between the code and the card: what runs is the sequence of
aten ops (and hand-written kernel launches) that
:mod:`porqua_tpu_torch.analysis.hlo` records from a real run of each
entry point and renders as text, one op per line::

    %a0 = param() -> f32[4,16,16] @cpu
    %7 = aten.mul.Tensor(%3, %a1) -> f32[4,16] @cpu
    %8 = aten._local_scalar_dense.default(%7) -> scalar @cpu !declared
    %k0 = kernel:admm_segment/cluster() -> () @card

(operands: ``%`` names of earlier outputs or of the program's
arguments, ``#`` literals; the result's dtype in HLO spelling and its
shape; the device; ``!declared`` marks a host read or copy made inside
``sanitize.explicit_transfer()``). :func:`parse_trace` reads that text
back and the rules run over it:

* **GC201 fusion miss**: an elementwise producer whose materialized
  result, at least the byte threshold wide, feeds an elementwise or
  reduce consumer. Eager torch materializes every intermediate, so
  this finds what XLA fused; the findings rank fusion targets
  widest first.
* **GC202 redundant op**: the same op on the same operands (and
  literals) twice in one trace, its result over the byte threshold.
* **GC203 layout churn**: a copy/transpose/contiguous whose operand is
  itself one.
* **GC204 padding waste**: a bucket-padded shape whose dead-lane byte
  share exceeds its budget.
* **GC205 peak budget**: the program's peak bytes over its committed
  bound.
* **GC206 dtype drift**: a float64 (or complex128) result in a float32
  program.

Findings reuse :class:`porqua_tpu_torch.analysis.lint.Finding`; the
``path`` is the virtual ``<hlo:PROGRAM>`` anchor and the line indexes
the trace text. Suppressions are per-(program, rule) entries of the
committed baseline (:func:`apply_suppressions`); the shipped baseline
carries none. Pure stdlib: the parser and every rule run on text.
"""

from __future__ import annotations

import dataclasses
import re
from typing import (Any, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Set, Tuple)

from porqua_tpu_torch.analysis.lint import Finding

__all__ = [
    "HLO_RULES",
    "LintConfig",
    "OpInstruction",
    "OpTrace",
    "apply_suppressions",
    "check_dtype_drift",
    "check_fusion_miss",
    "check_layout_churn",
    "check_padding_waste",
    "check_redundant_materialization",
    "check_temp_peak",
    "hlo_path",
    "lint_module",
    "parse_trace",
    "path_program",
    "shape_bytes",
]

#: The op-trace rule ids this module owns (documented in
#: ``lint.RULE_DOCS``).
HLO_RULES = ("GC201", "GC202", "GC203", "GC204", "GC205", "GC206")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_ARRAY_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")


def shape_bytes(shape: str) -> int:
    """Total bytes of a trace shape string: one array (``f32[4,16]``), a
    scalar array (``f32[]``) or a tuple (the sum). Unknown dtypes count
    4; ``scalar`` and ``()`` count 0."""
    total = 0
    for dtype, dims in _ARRAY_RE.findall(shape):
        count = 1
        for d in dims.split(","):
            if d:
                count *= int(d)
        total += count * _DTYPE_BYTES.get(dtype, 4)
    return total


def shape_dtypes(shape: str) -> Set[str]:
    """The element dtypes a shape string mentions."""
    return {dtype for dtype, _ in _ARRAY_RE.findall(shape)}


@dataclasses.dataclass
class OpInstruction:
    """One parsed op-trace line."""

    names: Tuple[str, ...]     #: output names without the leading ``%``
    op: str                    #: ``aten.mul.Tensor``, ``param``, ``kernel:...``
    operands: Tuple[str, ...]  #: referenced ``%names``
    operand_text: str          #: the whole operand list (literals included)
    shape: str                 #: result shape string
    device: str
    line: int                  #: 1-based line in the trace text
    declared: bool = False

    @property
    def name(self) -> str:
        return self.names[0] if self.names else ""

    @property
    def bytes(self) -> int:
        return shape_bytes(self.shape)

    @property
    def base(self) -> str:
        """The op without its namespace and overload: ``mul`` for
        ``aten.mul.Tensor``."""
        parts = self.op.split(".")
        return parts[1] if len(parts) > 1 and parts[0] == "aten" else self.op


@dataclasses.dataclass
class OpTrace:
    """A parsed op trace: its instructions in order plus the raw text."""

    name: str
    text: str
    instructions: List[OpInstruction]

    def __post_init__(self) -> None:
        self.by_name: Dict[str, OpInstruction] = {}
        for instr in self.instructions:
            for n in instr.names:
                self.by_name[n] = instr

    @property
    def params(self) -> List[OpInstruction]:
        return [i for i in self.instructions if i.op == "param"]

    @property
    def ops(self) -> List[OpInstruction]:
        return [i for i in self.instructions
                if i.op not in ("param", "const")]


_HEADER_RE = re.compile(r"^OpTrace\s+(\S+)")
_LINE_RE = re.compile(
    r"^(?P<names>%[\w.]+(?:,\s*%[\w.]+)*)\s*=\s*(?P<op>[^\s(]+)\("
    r"(?P<operands>.*)\)\s*->\s*(?P<shape>.+?)\s+@(?P<device>\S+)"
    r"(?P<declared>\s+!declared)?\s*$")
_REF_RE = re.compile(r"%([\w.]+)")


def parse_trace(text: str) -> OpTrace:
    """Parse op-trace text into the list the rules walk. Lines that do
    not match an op line are skipped."""
    name = ""
    instrs: List[OpInstruction] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if not stripped:
            continue
        h = _HEADER_RE.match(stripped)
        if h:
            name = h.group(1)
            continue
        m = _LINE_RE.match(stripped)
        if not m:
            continue
        instrs.append(OpInstruction(
            names=tuple(_REF_RE.findall(m.group("names"))),
            op=m.group("op"),
            operands=tuple(_REF_RE.findall(m.group("operands"))),
            operand_text=m.group("operands"),
            shape=m.group("shape"),
            device=m.group("device"),
            line=lineno,
            declared=bool(m.group("declared"))))
    return OpTrace(name=name, text=text, instructions=instrs)


# ---------------------------------------------------------------------------
# finding anchors
# ---------------------------------------------------------------------------

_HLO_PATH_RE = re.compile(r"^<hlo:(.+)>$")


def hlo_path(program: str) -> str:
    """The virtual path findings on ``program``'s trace anchor to."""
    return f"<hlo:{program}>"


def path_program(path: str) -> Optional[str]:
    """Inverse of :func:`hlo_path`; ``None`` for ordinary file paths."""
    m = _HLO_PATH_RE.match(path)
    return m.group(1) if m else None


@dataclasses.dataclass
class LintConfig:
    """Thresholds the rules judge against (the committed baseline
    records the config it was built with)."""

    #: GC201: minimum bytes of a materialized intermediate.
    fusion_miss_min_bytes: float = 65536.0
    #: GC203: minimum bytes moved twice before churn is a finding.
    churn_min_bytes: float = 16384.0
    #: GC202: minimum bytes a duplicated result must reach.
    dup_min_bytes: float = 4096.0
    #: GC204: default dead-lane byte share budget per bucket.
    padding_budget: float = 0.25
    #: GC206: the widest float the program may produce.
    expect_float: str = "f32"


# ---------------------------------------------------------------------------
# GC201 — fusion miss
# ---------------------------------------------------------------------------

_ELEMENTWISE = {
    "abs", "add", "sub", "rsub", "mul", "div", "neg", "reciprocal",
    "sqrt", "rsqrt", "exp", "expm1", "log", "log1p", "pow", "sign",
    "sgn", "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    "where", "lt", "le", "gt", "ge", "eq", "ne", "logical_and",
    "logical_or", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_not", "tanh", "sin", "cos", "floor", "ceil", "round",
    "addcmul", "addcdiv", "lerp", "square", "fmod", "remainder",
    "isnan", "isinf", "isfinite", "nan_to_num", "relu", "sigmoid",
}
_REDUCERS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
             "all", "norm", "linalg_vector_norm", "argmax", "argmin",
             "cumsum", "logsumexp"}


def check_fusion_miss(module: OpTrace, program: str,
                      min_bytes: float = 65536.0) -> List[Finding]:
    """GC201: an elementwise producer feeding an elementwise or reduce
    consumer, each its own op: the intermediate goes to memory where a
    fused kernel would keep it in registers. Only intermediates at
    least ``min_bytes`` wide count. Ranked widest first."""
    ranked: List[Tuple[int, Finding]] = []
    flagged: Set[str] = set()
    for instr in module.ops:
        if instr.base not in (_ELEMENTWISE | _REDUCERS):
            continue
        for op_name in instr.operands:
            prod = module.by_name.get(op_name)
            if prod is None or prod.name in flagged \
                    or prod.base not in _ELEMENTWISE:
                continue
            nbytes = prod.bytes
            if nbytes < min_bytes:
                continue
            flagged.add(prod.name)
            ranked.append((nbytes, Finding(
                "GC201", hlo_path(program), prod.line, 1,
                f"fusion miss: {prod.base} -> {instr.base} run as two "
                f"ops; the {prod.shape} intermediate materializes "
                f"{nbytes} B per call (threshold {int(min_bytes)} B)")))
    ranked.sort(key=lambda pair: (-pair[0], pair[1].line))
    return [f for _, f in ranked]


# ---------------------------------------------------------------------------
# GC202 — redundant materialization
# ---------------------------------------------------------------------------

_NOT_COMPUTE = {"param", "const", "empty", "empty_like", "empty_strided",
                "zeros", "zeros_like", "ones", "ones_like", "full",
                "full_like", "arange", "scalar_tensor", "lift_fresh",
                "detach", "alias", "view", "_unsafe_view", "expand",
                "unsqueeze", "squeeze", "select", "slice", "t",
                "transpose", "permute", "as_strided", "_reshape_alias",
                "eye", "_local_scalar_dense", "_to_copy", "copy_",
                "clone", "split", "unbind", "split_with_sizes"}


def check_redundant_materialization(module: OpTrace, program: str,
                                    min_bytes: float = 4096.0,
                                    ) -> List[Finding]:
    """GC202: the same op on identical operands and literals twice in
    one trace (the Gram build or a residual norm computed twice instead
    of reused). In-place ops, allocations, views and copies are not
    computations; an in-place write renames its tensor, so the same
    text on a mutated tensor is not a repeat. Results under
    ``min_bytes`` are noise."""
    findings: List[Finding] = []
    seen: Dict[Tuple[str, str, str], OpInstruction] = {}
    for instr in module.ops:
        if instr.base in _NOT_COMPUTE or instr.base.endswith("_") \
                or instr.op.startswith("kernel:") or not instr.operands:
            continue
        key = (instr.op, instr.operand_text, instr.shape)
        prev = seen.get(key)
        if prev is None:
            seen[key] = instr
            continue
        if instr.bytes < min_bytes:
            continue
        findings.append(Finding(
            "GC202", hlo_path(program), instr.line, 1,
            f"redundant materialization: {instr.op}({instr.operand_text}) "
            f"-> {instr.shape} repeats %{prev.name} (line {prev.line}) "
            "with identical operands"))
    return findings


# ---------------------------------------------------------------------------
# GC203 — layout churn
# ---------------------------------------------------------------------------

_MOVERS = {"_to_copy", "copy_", "clone", "contiguous", "transpose", "t",
           "permute"}


def check_layout_churn(module: OpTrace, program: str,
                       min_bytes: float = 16384.0) -> List[Finding]:
    """GC203: a copy/transpose/contiguous whose operand is itself one:
    the same bytes moved twice for layout's sake. Pairs under
    ``min_bytes`` are latency noise."""
    findings: List[Finding] = []
    for instr in module.ops:
        if instr.base not in _MOVERS:
            continue
        for op_name in instr.operands:
            prod = module.by_name.get(op_name)
            if prod is None or prod.base not in _MOVERS:
                continue
            nbytes = max(instr.bytes, prod.bytes)
            if nbytes < min_bytes:
                continue
            findings.append(Finding(
                "GC203", hlo_path(program), instr.line, 1,
                f"layout churn: {prod.base} (line {prod.line}) -> "
                f"{instr.base} moves {nbytes} B twice for layout; fold "
                "the transposition into the producer"))
    return findings


# ---------------------------------------------------------------------------
# GC204 — padding waste
# ---------------------------------------------------------------------------

def check_padding_waste(program: str,
                        natural_bytes: float,
                        padded_bytes: Optional[float] = None,
                        budget: float = 0.25,
                        module: Optional[OpTrace] = None,
                        bucket: Optional[str] = None,
                        line: int = 1) -> List[Finding]:
    """GC204: the dead-lane byte share ``1 - natural/padded`` of a
    bucket-padded program over its budget. The padded bytes come from
    the trace's parameters when a ``module`` is given, or are passed
    directly (the ladder arithmetic of ``hlo.bucket_padding_cells``)."""
    if module is not None and module.params:
        padded_bytes = float(sum(p.bytes for p in module.params))
        line = module.params[0].line
    if not padded_bytes or natural_bytes is None:
        return []
    share = 1.0 - float(natural_bytes) / float(padded_bytes)
    if share <= budget:
        return []
    where = f" (bucket {bucket})" if bucket else ""
    return [Finding(
        "GC204", hlo_path(program), line, 1,
        f"padding waste{where}: dead-lane byte share {share:.3f} over "
        f"budget {budget:.3f}: {int(padded_bytes - natural_bytes)} of "
        f"{int(padded_bytes)} padded input bytes are dead lanes")]


# ---------------------------------------------------------------------------
# GC205 — peak budget
# ---------------------------------------------------------------------------

def check_temp_peak(program: str,
                    peak_bytes: Optional[float],
                    budget_bytes: Optional[float],
                    line: int = 1) -> List[Finding]:
    """GC205: the program's peak bytes over its committed bound. No
    bound or no measurement checks nothing."""
    if peak_bytes is None or budget_bytes is None:
        return []
    if float(peak_bytes) <= float(budget_bytes):
        return []
    return [Finding(
        "GC205", hlo_path(program), line, 1,
        f"peak budget: peak {int(peak_bytes)} B exceeds the committed "
        f"bound {int(budget_bytes)} B: a bigger live range (a new "
        "temporary) lands here before it runs the card out of memory")]


# ---------------------------------------------------------------------------
# GC206 — dtype drift
# ---------------------------------------------------------------------------

_WIDER_THAN = {
    "f16": {"f32", "f64", "c64", "c128"},
    "bf16": {"f32", "f64", "c64", "c128"},
    "f32": {"f64", "c128"},
    "f64": set(),
}


def check_dtype_drift(module: OpTrace, program: str,
                      expect_float: str = "f32") -> List[Finding]:
    """GC206: a result wider than the program's float policy (f64 in an
    f32 program). One finding per op: the first occurrence anchors it."""
    wide = _WIDER_THAN.get(expect_float, {"f64", "c128"})
    if not wide:
        return []
    findings: List[Finding] = []
    seen: Set[str] = set()
    for instr in module.instructions:
        hit = shape_dtypes(instr.shape) & wide
        if not hit or instr.op in seen:
            continue
        seen.add(instr.op)
        findings.append(Finding(
            "GC206", hlo_path(program), instr.line, 1,
            f"dtype drift: {instr.op} produces {'/'.join(sorted(hit))} in "
            f"a {expect_float} program"))
    return findings


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def lint_module(module: OpTrace,
                program: str,
                config: Optional[LintConfig] = None,
                peak_bytes: Optional[float] = None,
                peak_budget: Optional[float] = None,
                rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run every trace-scoped rule (GC201/202/203/206, and GC205 when a
    peak and its budget are given) over one parsed program. GC204 is
    ladder-scoped: drive :func:`check_padding_waste` from the cells."""
    cfg = config or LintConfig()
    selected = set(rules) if rules is not None else set(HLO_RULES)
    findings: List[Finding] = []
    if "GC201" in selected:
        findings += check_fusion_miss(module, program,
                                      cfg.fusion_miss_min_bytes)
    if "GC202" in selected:
        findings += check_redundant_materialization(module, program,
                                                    cfg.dup_min_bytes)
    if "GC203" in selected:
        findings += check_layout_churn(module, program,
                                       cfg.churn_min_bytes)
    if "GC205" in selected:
        findings += check_temp_peak(program, peak_bytes, peak_budget)
    if "GC206" in selected:
        findings += check_dtype_drift(module, program, cfg.expect_float)
    return findings


def apply_suppressions(
        findings: Sequence[Finding],
        suppressions: Iterable[Mapping[str, Any]],
) -> Tuple[List[Finding], Dict[str, int]]:
    """Filter findings against baseline suppression entries
    (``{"program": <label or "*">, "rule": "GC2xx", "reason": ...}``)
    and count what was suppressed per rule. Entries without a reason are
    ignored: an unexplained suppression is a finding, not a policy."""
    table: Set[Tuple[str, str]] = set()
    for entry in suppressions:
        rule = str(entry.get("rule", ""))
        prog = str(entry.get("program", "*"))
        if rule and entry.get("reason"):
            table.add((prog, rule))
    kept: List[Finding] = []
    counts: Dict[str, int] = {}
    for f in findings:
        prog = path_program(f.path) or f.path
        if (prog, f.rule) in table or ("*", f.rule) in table:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        else:
            kept.append(f)
    return kept, counts
