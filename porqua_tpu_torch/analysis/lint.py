"""graftcheck: AST lint rules for the port's device discipline (the
port of ``porqua_tpu/analysis/lint.py``).

The port rests on conventions no Python runtime enforces: every product
of the QP stack in full float32 (a float32 product on the card may run
in TF32, which floors the ADMM residuals the way the TPU's default bf16
passes did), no host<->device syncs in the code that runs once per
segment, no recompiles or kernel builds in steady state, and no
CUDA work at import time. This module makes them machine-checked.

Rules (each suppressible per line with ``# graftcheck: disable=GC00x``
or per file with ``# graftcheck: disable-file=GC00x``), with the JAX
package's rule ids restated for torch:

GC001  Precision: anything that turns TF32 on
       (``torch.backends.cuda.matmul.allow_tf32`` /
       ``torch.backends.cudnn.allow_tf32`` set to anything but
       ``False``) or lowers ``torch.set_float32_matmul_precision`` below
       ``"highest"``, anywhere in library code
       (``qp/canonical.py::_PrecisionPolicy``, which sets the safe
       values, is exempt); half or bfloat16 casts and ``torch.autocast``
       inside the precision-policy modules (``qp/``, ``estimators/``,
       ``tracking.py``, ``accounting.py``); a Triton ``tl.dot`` without
       ``input_precision="ieee"``.
GC002  Host-sync hazard in hot code: ``.item()``, ``.cpu()``,
       ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()`` and
       ``float()/int()/bool()`` of a non-literal, in code reachable from
       the declared roots (:data:`HOT_ROOTS`: the segment steps, the
       operator builds, prepare and finalize, the compaction repack, the
       serve entry body and the kernel wrappers, the counterparts of
       the JAX package's jit roots). Reachability follows the call
       graph across modules (same-module names, ``from x import y``
       bindings, module-alias attributes). A read the code means to
       make sits in a ``with sanitize.explicit_transfer():`` block,
       which the runtime transfer guard lets through too (the segment
       loop's one read per segment); a cast of a shape, a length or a
       ``params`` field (host scalars) is not a read.
GC003  Recompile hazard: ``torch.compile``, ``torch.jit.script`` /
       ``trace``, CUDA-graph capture (``torch.cuda.graph``,
       ``CUDAGraph``, ``make_graphed_callables``) or an extension build
       (``torch.utils.cpp_extension.load*``) inside a loop, or inside a
       function body of a steady-state module (``qp/``, ``serve/``,
       ``ops/``, ``tracking.py``, ``batch.py``, ``backtest.py``,
       ``accounting.py``) without a cache (an assignment to a ``self.``
       attribute, or a ``functools.cache``/``lru_cache`` function);
       kernel builds go through ``ops/_build.py`` only, so an extension
       build anywhere else is flagged.
GC004  Stray debug hooks in library code: ``breakpoint()``,
       ``pdb.set_trace()``, ``torch.autograd.set_detect_anomaly`` /
       ``detect_anomaly``.
GC005  Module-level CUDA work at import time: ``torch.cuda.init`` /
       ``current_device`` / ``set_device`` / ``synchronize`` and the
       other context-creating calls, tensors placed on ``"cuda"``
       (``device="cuda..."``, ``.cuda()``, ``.to("cuda...")``), and a
       kernel build (``_build.build``/``library``, ``_library``,
       ``cpp_extension.load*``), executed at module scope (class
       bodies, decorator expressions and default-argument values
       included).
GC007  Fault-injection seam (``porqua_tpu_torch.resilience.faults.fire``)
       not lexically inside an ``if faults.enabled():`` guard (the
       JAX package's rule).

GC006 (the ``# guarded-by:`` thread-safety lint) lives in
:mod:`porqua_tpu_torch.analysis.guards`; GC008-GC010 (inferred lock
discipline, static deadlock detection, blocking call under a lock) in
:mod:`porqua_tpu_torch.analysis.concurrency`; GC101-GC111 (op-trace
contracts) in :mod:`porqua_tpu_torch.analysis.contracts`; GC201-GC206
(rules over the op trace) in :mod:`porqua_tpu_torch.analysis.hlolint`.
This module is pure stdlib ``ast``: it imports nothing of torch.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "ModuleInfo",
    "RULE_DOCS",
    "iter_py_files",
    "load_module",
    "scan_paths",
    "suppression_stats",
]

RULE_DOCS = {
    "GC001": "precision: TF32, half casts or autocast in the float32 policy",
    "GC002": "host-device sync hazard in hot code",
    "GC003": "recompile hazard",
    "GC004": "stray debug hook in library code",
    "GC005": "CUDA work at module import time",
    "GC006": "guarded-by attribute mutated without its lock",
    "GC007": "fault seam not guarded by the injector-enabled check",
    "GC008": "unannotated shared state mutated from multiple thread roots",
    "GC009": "lock-order cycle (potential deadlock)",
    "GC010": "blocking call while holding a lock",
    "GC101": "float64 leaked into a float32 program's op trace",
    "GC102": "undeclared transfer or host read inside a program",
    "GC103": "unstable output dtype of a program",
    "GC104": "fault injection perturbs a program's op trace",
    "GC105": "telemetry (harvest/profiling) perturbs a program's op trace",
    "GC106": "live plane (SLO/flight/anomaly) perturbs a program's op trace",
    "GC107": "device-cost plane perturbs a program's op trace",
    "GC108": "fleet federation plane perturbs a program's op trace",
    "GC109": "tenant plane perturbs a program's op trace",
    "GC110": "solver routing perturbs a program's op trace",
    "GC111": "calibration loop perturbs a program's op trace",
    # Rules over the recorded op trace of every entry-point program
    # (porqua_tpu_torch/analysis/hlolint.py, harvested by analysis/hlo.py).
    "GC201": "fusion miss: materialized elementwise/reduce intermediate "
             "past the byte threshold",
    "GC202": "redundant materialization: the same op on the same "
             "operands twice",
    "GC203": "layout churn: chained copy/transpose/contiguous data "
             "movement",
    "GC204": "padding waste: bucket dead-lane byte share over the "
             "per-bucket budget",
    "GC205": "temporary-peak budget: the program's peak over its "
             "committed bound",
    "GC206": "dtype drift: float64 emitted in a float32 program",
}

_CAST_BUILTINS = {"float", "int", "bool"}
_HOST_READS = {"item", "cpu", "tolist", "numpy"}

#: The declared hot roots (GC002): module path suffix -> functions whose
#: bodies are the port's device programs, the counterparts of the JAX
#: package's jit roots. The loop drivers (``qp/admm.py::run_segments``,
#: ``CompactingDriver.solve``) are not roots: their one read per segment
#: is declared with ``sanitize.explicit_transfer()``.
HOT_ROOTS: Dict[str, Tuple[str, ...]] = {
    "qp/admm.py": ("_make_segment", "admm_segment_step", "admm_init"),
    "qp/pdhg.py": ("_make_pdhg_segment", "pdhg_segment_step", "pdhg_init"),
    "qp/napg.py": ("_make_napg_segment", "napg_segment_step", "napg_init"),
    "qp/solve.py": ("_prepare_impl", "_finalize_impl", "_solve_impl",
                    "prepare_batch", "segment_step_batch",
                    "finalize_batch"),
    "compaction.py": ("step_and_repack", "lane_active"),
    "tracking.py": ("build_tracking_qp", "tracking_step"),
    "ops/admm_kernel.py": ("admm_segment", "admm_segment_factored"),
}

_SUPPRESS_LINE_RE = re.compile(
    r"#\s*graftcheck:\s*disable\s*=\s*([A-Za-z0-9_,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*graftcheck:\s*disable-file\s*=\s*([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file line."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ModuleInfo:
    """One parsed file plus everything the rules need: import aliases,
    suppression tables, and parent links on every AST node."""

    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.posix = "/" + path.replace(os.sep, "/").lstrip("/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._gc_parent = node  # type: ignore[attr-defined]

        # The JAX names stay: the concurrency rules (shared with the JAX
        # package) treat jax/jnp/numpy heads as same-thread calls.
        self.jnp_aliases: Set[str] = set()
        self.np_aliases: Set[str] = set()
        self.jax_aliases: Set[str] = set()
        self.torch_aliases: Set[str] = set()
        self.partial_names: Set[str] = set()
        self.functools_aliases: Set[str] = set()
        #: ``from pkg.mod import name as alias`` -> alias: (pkg.mod, name)
        self.imported_from: Dict[str, Tuple[str, str]] = {}
        #: ``import pkg.mod as alias`` -> alias: pkg.mod
        self.module_aliases: Dict[str, str] = {}
        self._collect_imports()

        self.file_suppress: Set[str] = set()
        self.line_suppress: Dict[int, Set[str]] = {}
        self._collect_suppressions()

        #: name -> function/async defs bound to it anywhere in the file
        self.defs_by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs_by_name.setdefault(node.name, []).append(node)

    # -- imports -----------------------------------------------------

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name, bound = alias.name, alias.asname or alias.name
                    if name == "jax.numpy":
                        self.jnp_aliases.add(bound)
                    elif name == "numpy":
                        self.np_aliases.add(bound)
                    elif name == "jax":
                        self.jax_aliases.add(bound)
                    elif name == "torch":
                        self.torch_aliases.add(bound)
                    elif name == "functools":
                        self.functools_aliases.add(bound)
                    if "." in name and alias.asname:
                        self.module_aliases[bound] = name
                    elif "." not in name:
                        self.module_aliases.setdefault(bound, name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if node.module == "jax" and alias.name == "numpy":
                        self.jnp_aliases.add(bound)
                    elif node.module == "functools" and alias.name == "partial":
                        self.partial_names.add(bound)
                    self.imported_from[bound] = (node.module, alias.name)

    # -- suppressions ------------------------------------------------

    def _collect_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_FILE_RE.search(line)
            if m:
                self.file_suppress |= _parse_rule_list(m.group(1))
            m = _SUPPRESS_LINE_RE.search(line)
            if m:
                self.line_suppress.setdefault(i, set()).update(
                    _parse_rule_list(m.group(1)))

    def suppressed(self, rule: str, line: int) -> bool:
        for pool in (self.file_suppress, self.line_suppress.get(line, ())):
            if "all" in pool or rule in pool:
                return True
        return False

    # -- chain helpers -----------------------------------------------

    def attr_chain(self, node: ast.AST) -> Optional[List[str]]:
        """``torch.cuda.synchronize`` -> ['torch', 'cuda', 'synchronize'];
        None when the expression is not a pure Name/Attribute chain."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return parts[::-1]
        return None

    def qualified(self, node: ast.AST) -> Optional[List[str]]:
        """The chain of ``node`` with its head resolved through the
        file's imports (``from torch import cuda as c; c.init`` ->
        ['torch', 'cuda', 'init']); None for a non-chain."""
        chain = self.attr_chain(node)
        if not chain:
            return None
        head = self.imported_from.get(chain[0])
        if head is not None:
            src, orig = head
            return src.split(".") + [orig] + chain[1:]
        if chain[0] in self.module_aliases:
            return self.module_aliases[chain[0]].split(".") + chain[1:]
        return chain

    def _is_partial(self, call: ast.Call) -> bool:
        chain = self.attr_chain(call.func)
        if not chain:
            return False
        if len(chain) == 1 and chain[0] in self.partial_names:
            return True
        return (len(chain) == 2 and chain[0] in self.functools_aliases
                and chain[1] == "partial")


def _parse_rule_list(raw: str) -> Set[str]:
    return {tok.strip() for tok in raw.split(",") if tok.strip()}


def _ancestors(node: ast.AST) -> Iterable[ast.AST]:
    node = getattr(node, "_gc_parent", None)
    while node is not None:
        yield node
        node = getattr(node, "_gc_parent", None)


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _const(node: Optional[ast.AST]):
    return node.value if isinstance(node, ast.Constant) else None


# ---------------------------------------------------------------------------
# path scoping
# ---------------------------------------------------------------------------

def in_precision_scope(posix_path: str) -> bool:
    p = posix_path
    return ("/qp/" in p or "/estimators/" in p
            or p.endswith("/tracking.py") or p.endswith("/accounting.py"))


def in_steady_state_scope(posix_path: str) -> bool:
    p = posix_path
    return ("/qp/" in p or "/serve/" in p or "/ops/" in p
            or p.endswith("/tracking.py") or p.endswith("/batch.py")
            or p.endswith("/backtest.py") or p.endswith("/accounting.py"))


def in_library_scope(posix_path: str) -> bool:
    p = posix_path
    return not ("/tests/" in p or "/scripts/" in p or "/examples/" in p)


# ---------------------------------------------------------------------------
# GC001 — precision
# ---------------------------------------------------------------------------

_TF32_FLAGS = (("torch", "backends", "cuda", "matmul", "allow_tf32"),
               ("torch", "backends", "cudnn", "allow_tf32"))
_LOW_DTYPES = {"float16", "half", "bfloat16"}


def _in_class(node: ast.AST, name: str) -> bool:
    return any(isinstance(a, ast.ClassDef) and a.name == name
               for a in _ancestors(node))


def _check_gc001(mod: ModuleInfo) -> List[Finding]:
    if not in_library_scope(mod.posix):
        return []
    out: List[Finding] = []
    policy = mod.posix.endswith("/qp/canonical.py")
    scoped = in_precision_scope(mod.posix)

    def emit(node: ast.AST, what: str) -> None:
        if policy and _in_class(node, "_PrecisionPolicy"):
            return
        if not mod.suppressed("GC001", node.lineno):
            out.append(Finding(
                "GC001", mod.path, node.lineno, node.col_offset,
                f"{what}: the QP stack runs every product in full float32 "
                "(policy: qp/canonical.HP)"))

    def low_dtype(node: Optional[ast.AST]) -> bool:
        chain = mod.qualified(node) if node is not None else None
        return bool(chain and len(chain) == 2 and chain[0] == "torch"
                    and chain[1] in _LOW_DTYPES)

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                chain = mod.qualified(t)
                if chain and tuple(chain) in _TF32_FLAGS \
                        and _const(node.value) is not False:
                    emit(node, f"{'.'.join(chain)} set to something other "
                               "than False turns TF32 on")
        if not isinstance(node, ast.Call):
            continue
        chain = mod.qualified(node.func) or []
        if chain == ["torch", "set_float32_matmul_precision"]:
            arg = node.args[0] if node.args else _kw(node, "precision")
            if _const(arg) != "highest":
                emit(node, "set_float32_matmul_precision below 'highest' "
                           "lets float32 products run in TF32")
        if chain[:2] == ["triton", "language"] and chain[-1] == "dot":
            prec = _const(_kw(node, "input_precision"))
            if prec != "ieee" and _const(_kw(node, "allow_tf32")) is not False:
                emit(node, "tl.dot without input_precision='ieee' runs "
                           "float32 operands in TF32")
        if not scoped:
            continue
        if chain[:1] == ["torch"] and chain[-1] == "autocast" or \
                chain[-2:] == ["amp", "autocast"]:
            emit(node, "torch.autocast in a precision-policy module")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("half", "bfloat16") and not node.args:
            emit(node, f".{node.func.attr}() cast in a precision-policy "
                       "module")
        elif low_dtype(_kw(node, "dtype")) or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("to", "type")
                and any(low_dtype(a) for a in node.args)):
            emit(node, "a half/bfloat16 dtype in a precision-policy module")
    return out


# ---------------------------------------------------------------------------
# GC002 — host-sync hazards in hot code
# ---------------------------------------------------------------------------

def _root_names(mod: ModuleInfo,
                roots: Dict[str, Sequence[str]]) -> Set[str]:
    names: Set[str] = set()
    for suffix, fns in roots.items():
        if mod.posix.endswith("/" + suffix.lstrip("/")):
            names.update(fns)
    return names


class _Reachability:
    """Cross-module reachability from the declared hot roots; edges
    follow plain-name calls (same module + ``from x import y`` bindings
    + module-alias attributes) and bare-method calls (same module)."""

    def __init__(self, mods: Sequence[ModuleInfo],
                 roots: Dict[str, Sequence[str]]) -> None:
        self.mods = mods
        self.roots = roots
        self.by_modname: Dict[str, ModuleInfo] = {}
        for m in mods:
            dotted = m.posix.lstrip("/").removesuffix(".py").replace("/", ".")
            self.by_modname[dotted] = m
        #: reachable (mod, function-or-lambda node) pairs
        self.reached: Set[Tuple[int, int]] = set()
        self.work: List[Tuple[ModuleInfo, ast.AST]] = []

    def _module_for(self, dotted: str) -> Optional[ModuleInfo]:
        if dotted in self.by_modname:
            return self.by_modname[dotted]
        # Tolerate roots scanned from a subdirectory: match on suffix.
        for name, m in self.by_modname.items():
            if name.endswith("." + dotted) or dotted.endswith("." + name):
                return m
        return None

    def _add(self, mod: ModuleInfo, node: ast.AST) -> None:
        key = (id(mod), id(node))
        if key not in self.reached:
            self.reached.add(key)
            self.work.append((mod, node))

    def _resolve_name(self, mod: ModuleInfo, name: str) -> None:
        for node in mod.defs_by_name.get(name, ()):
            self._add(mod, node)
        if name in mod.imported_from:
            src_mod, orig = mod.imported_from[name]
            target = self._module_for(src_mod)
            if target is not None:
                for node in target.defs_by_name.get(orig, ()):
                    self._add(target, node)

    def _resolve_call(self, mod: ModuleInfo, call: ast.Call) -> None:
        func = call.func
        if isinstance(func, ast.Name):
            self._resolve_name(mod, func.id)
            return
        chain = mod.attr_chain(func)
        if chain and len(chain) == 2 and chain[0] in mod.module_aliases:
            target = self._module_for(mod.module_aliases[chain[0]])
            if target is not None:
                for node in target.defs_by_name.get(chain[1], ()):
                    self._add(target, node)
                return
        if isinstance(func, ast.Attribute):
            # Bare-method call (self.foo(...), qp.foo(...)): resolve to
            # same-module defs only; cross-module resolution by bare
            # name would be collision-prone.
            for node in mod.defs_by_name.get(func.attr, ()):
                self._add(mod, node)

    def run(self) -> Dict[int, Set[int]]:
        for mod in self.mods:
            for name in _root_names(mod, self.roots):
                for node in mod.defs_by_name.get(name, ()):
                    self._add(mod, node)
        while self.work:
            mod, node = self.work.pop()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    self._resolve_call(mod, sub)
        per_mod: Dict[int, Set[int]] = {}
        for mod_id, node_id in self.reached:
            per_mod.setdefault(mod_id, set()).add(node_id)
        return per_mod


def _declared_transfer(mod: ModuleInfo, node: ast.AST) -> bool:
    """``node`` sits in a ``with ...explicit_transfer():`` block."""
    for anc in _ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    chain = mod.attr_chain(expr.func)
                    if chain and chain[-1] == "explicit_transfer":
                        return True
    return False


_HOST_TYPES = {"int", "bool", "float", "str"}


def _host_scalar(mod: ModuleInfo, arg: ast.AST, depth: int = 0) -> bool:
    """A cast argument that is a host value by construction: a literal,
    a shape/length expression, a ``params`` field, a parameter annotated
    ``int``/``bool``/``float``/``str``, or a local name bound to one of
    these."""
    if isinstance(arg, ast.Constant):
        return True
    for sub in ast.walk(arg):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "n", "m", "batch_shape"):
            return True
        if isinstance(sub, ast.Call):
            fn = sub.func
            if isinstance(fn, ast.Name) and fn.id == "len":
                return True
            if isinstance(fn, ast.Attribute) and fn.attr in (
                    "dim", "numel", "size"):
                return True
    chain = mod.attr_chain(arg)
    if chain and len(chain) >= 2 and (
            chain[0].endswith("params") or chain[:2] == ["self", "params"]):
        return True
    if not isinstance(arg, ast.Name) or depth > 3:
        return False
    for fn in _ancestors(arg):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg == arg.id:
                return (isinstance(p.annotation, ast.Name)
                        and p.annotation.id in _HOST_TYPES)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == arg.id
                    for t in node.targets):
                return _host_scalar(mod, node.value, depth + 1)
    return False


def _check_gc002(mods: Sequence[ModuleInfo],
                 reached: Dict[int, Set[int]]) -> List[Finding]:
    out: List[Finding] = []
    for mod in mods:
        node_ids = reached.get(id(mod), set())
        if not node_ids:
            continue
        nodes = [n for n in ast.walk(mod.tree) if id(n) in node_ids]
        seen: Set[Tuple[str, int]] = set()

        def emit(node: ast.AST, what: str) -> None:
            key = (what, node.lineno)
            if key in seen or mod.suppressed("GC002", node.lineno) \
                    or _declared_transfer(mod, node):
                return
            seen.add(key)
            out.append(Finding(
                "GC002", mod.path, node.lineno, node.col_offset,
                f"{what} in hot code forces a host-device sync; keep the "
                "segment path device-only or declare the read with "
                "sanitize.explicit_transfer()"))

        for fn in nodes:
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if isinstance(func, ast.Attribute) \
                        and func.attr in _HOST_READS and not node.args \
                        and not node.keywords:
                    emit(node, f".{func.attr}()")
                chain = mod.qualified(func)
                if chain == ["torch", "cuda", "synchronize"]:
                    emit(node, "torch.cuda.synchronize()")
                if isinstance(func, ast.Name) and func.id in _CAST_BUILTINS \
                        and len(node.args) == 1 \
                        and not _host_scalar(mod, node.args[0]):
                    emit(node, f"{func.id}() of a (possibly device) tensor")
    return out


# ---------------------------------------------------------------------------
# GC003 — recompile hazards
# ---------------------------------------------------------------------------

_COMPILERS = {
    ("torch", "compile"): "torch.compile",
    ("torch", "jit", "script"): "torch.jit.script",
    ("torch", "jit", "trace"): "torch.jit.trace",
    ("torch", "cuda", "graph"): "CUDA-graph capture",
    ("torch", "cuda", "CUDAGraph"): "CUDA-graph capture",
    ("torch", "cuda", "make_graphed_callables"): "CUDA-graph capture",
}
_EXT_BUILDS = {"load", "load_inline"}


def _compiler_of(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    chain = mod.qualified(call.func)
    if not chain:
        return None
    if tuple(chain) in _COMPILERS:
        return _COMPILERS[tuple(chain)]
    if len(chain) >= 2 and chain[-2] == "cpp_extension" \
            and chain[-1] in _EXT_BUILDS:
        return f"cpp_extension.{chain[-1]}"
    return None


def _cached_fn(mod: ModuleInfo, fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        chain = mod.qualified(target) or []
        if chain[-1:] in (["cache"], ["lru_cache"], ["cached_property"]):
            return True
    return False


def _check_gc003(mod: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    steady = in_steady_state_scope(mod.posix)
    builder = mod.posix.endswith("/ops/_build.py")

    def emit(node: ast.AST, msg: str) -> None:
        if not mod.suppressed("GC003", node.lineno):
            out.append(Finding("GC003", mod.path, node.lineno,
                               node.col_offset, msg))

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _compiler_of(mod, node)
        if what is None:
            continue
        if what.startswith("cpp_extension"):
            if not builder and in_library_scope(mod.posix):
                emit(node, f"{what} builds a kernel outside ops/_build.py: "
                           "kernel builds go through the one cached builder")
            continue
        in_loop = any(isinstance(a, (ast.For, ast.While, ast.comprehension))
                      for a in _ancestors(node))
        enclosing = next((a for a in _ancestors(node) if isinstance(
            a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))), None)
        parent = getattr(node, "_gc_parent", None)
        is_decorator = isinstance(parent, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)) \
            and node in parent.decorator_list
        cached_on_self = (
            isinstance(parent, ast.Assign)
            and any(isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self" for t in parent.targets))
        if in_loop:
            emit(node, f"{what} inside a loop recompiles every iteration; "
                       "hoist it out and cache it")
        elif steady and enclosing is not None and not is_decorator \
                and not cached_on_self and not _cached_fn(mod, enclosing):
            emit(node, f"{what} inside a function in a steady-state module "
                       "recompiles on every call; cache it at module scope, "
                       "on self, or in a functools.cache function")
    return out


# ---------------------------------------------------------------------------
# GC004 — stray debug hooks
# ---------------------------------------------------------------------------

def _check_gc004(mod: ModuleInfo) -> List[Finding]:
    if not in_library_scope(mod.posix):
        return []
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = mod.qualified(node.func) or []
        msg = None
        if isinstance(node.func, ast.Name) and node.func.id == "breakpoint":
            msg = "breakpoint() left in library code"
        elif chain[:1] in (["pdb"], ["ipdb"]) and chain[-1] in (
                "set_trace", "post_mortem", "run", "runcall"):
            msg = f"{'.'.join(chain)}() left in library code"
        elif chain[:2] == ["torch", "autograd"] and chain[-1] in (
                "set_detect_anomaly", "detect_anomaly"):
            msg = (f"torch.autograd.{chain[-1]}() left in library code "
                   "(a sync per op)")
        if msg and not mod.suppressed("GC004", node.lineno):
            out.append(Finding("GC004", mod.path, node.lineno,
                               node.col_offset, msg))
    return out


# ---------------------------------------------------------------------------
# GC007 — fault seams guarded by the injector-enabled predicate
# ---------------------------------------------------------------------------

def _faults_bindings(mod: ModuleInfo) -> Tuple[Set[str], Set[str], Set[str]]:
    """Names bound to the fault-injection module / its entry points:
    ``(module_aliases, bare_fire_names, bare_enabled_names)`` —
    covering ``import porqua_tpu_torch.resilience.faults as _faults``,
    ``from porqua_tpu_torch.resilience import faults``, and
    ``from porqua_tpu_torch.resilience.faults import fire, enabled``."""
    mod_aliases: Set[str] = set()
    for alias, target in mod.module_aliases.items():
        if target.endswith("resilience.faults"):
            mod_aliases.add(alias)
    bare_fire: Set[str] = set()
    bare_enabled: Set[str] = set()
    for alias, (src, orig) in mod.imported_from.items():
        if orig == "faults" and src.endswith("resilience"):
            mod_aliases.add(alias)
        elif src.endswith("resilience.faults"):
            if orig == "fire":
                bare_fire.add(alias)
            elif orig == "enabled":
                bare_enabled.add(alias)
    return mod_aliases, bare_fire, bare_enabled


def _check_gc007(mod: ModuleInfo) -> List[Finding]:
    """Every ``faults.fire(...)`` seam must sit lexically inside an
    ``if`` whose test calls ``faults.enabled()``. The guard is what
    makes the disabled path one module-global predicate (no injector
    lookup, no RNG, no allocation) — an unguarded seam silently turns
    the production hot path into a per-call function boundary AND
    breaks the bit-identical-when-disabled promise the chaos suite's
    A/B leans on. The resilience package itself is exempt (it IS the
    plane), as are tests/scripts/examples."""
    if not in_library_scope(mod.posix) or "/resilience/" in mod.posix:
        return []
    mod_aliases, bare_fire, bare_enabled = _faults_bindings(mod)
    if not mod_aliases and not bare_fire:
        return []

    def is_enabled_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        chain = mod.attr_chain(node.func)
        if not chain:
            return False
        if len(chain) == 1 and chain[0] in bare_enabled:
            return True
        return (len(chain) == 2 and chain[0] in mod_aliases
                and chain[1] == "enabled")

    def positively_tests_enabled(test: ast.AST) -> bool:
        # enabled() must appear in the test OUTSIDE any `not`:
        # `if not faults.enabled():` selects exactly the disabled path
        # the rule exists to keep seam-free.
        negated: Set[ast.AST] = set()
        for sub in ast.walk(test):
            if isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.Not):
                negated.update(ast.walk(sub.operand))
        return any(is_enabled_call(sub) and sub not in negated
                   for sub in ast.walk(test))

    def guarded(node: ast.AST) -> bool:
        # The fire() must sit in the If's BODY (not the orelse — a
        # seam in the else branch of an enabled() check is precisely
        # the unguarded/disabled-path placement being linted for).
        child: ast.AST = node
        for anc in _ancestors(node):
            if (isinstance(anc, ast.If) and child in anc.body
                    and positively_tests_enabled(anc.test)):
                return True
            child = anc
        return False

    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = mod.attr_chain(node.func)
        if not chain:
            continue
        is_fire = ((len(chain) == 1 and chain[0] in bare_fire)
                   or (len(chain) == 2 and chain[0] in mod_aliases
                       and chain[1] == "fire"))
        if not is_fire or guarded(node):
            continue
        if not mod.suppressed("GC007", node.lineno):
            out.append(Finding(
                "GC007", mod.path, node.lineno, node.col_offset,
                "fault seam fired without the enabled() guard; wrap in "
                "`if faults.enabled():` so the disabled path stays one "
                "module-global predicate (and bit-identical)"))
    return out


# ---------------------------------------------------------------------------
# GC005 — CUDA work at import time
# ---------------------------------------------------------------------------

_CUDA_EAGER = {"init", "current_device", "set_device", "synchronize",
               "get_device_name", "get_device_properties", "mem_get_info",
               "memory_allocated", "max_memory_allocated",
               "reset_peak_memory_stats", "current_stream", "Stream",
               "Event", "empty_cache", "manual_seed", "manual_seed_all"}
_KERNEL_BUILDS = {"build", "library", "_library"}


def _module_level_exprs(tree: ast.Module) -> Iterable[ast.AST]:
    """Every expression evaluated at import time: module/class-body
    statements, plus decorator lists and default-argument values of
    module-level defs (their *bodies* are not executed at import)."""
    stack: List[ast.AST] = [tree]
    while stack:
        scope = stack.pop()
        for stmt in scope.body:
            if isinstance(stmt, ast.ClassDef):
                yield from stmt.decorator_list
                yield from stmt.bases
                stack.append(stmt)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from stmt.decorator_list
                yield from (d for d in stmt.args.defaults)
                yield from (d for d in stmt.args.kw_defaults if d)
            else:
                yield stmt


def _runs_later(node: ast.AST) -> bool:
    """True when ``node`` sits in a function or lambda *body* (runs at
    call time), even inside a module-level compound statement.
    Decorator expressions and default-argument values are not bodies."""
    child = node
    for anc in _ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and child in anc.body:
            return True
        if isinstance(anc, ast.Lambda) and child is anc.body:
            return True
        child = anc
    return False


def _cuda_literal(node: Optional[ast.AST]) -> bool:
    v = _const(node)
    return isinstance(v, str) and v.startswith("cuda")


def _check_gc005(mod: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    for expr in _module_level_exprs(mod.tree):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call) or _runs_later(node):
                continue
            chain = mod.qualified(node.func) or []
            msg = None
            if chain[:2] == ["torch", "cuda"] and len(chain) == 3 \
                    and chain[2] in _CUDA_EAGER:
                msg = (f"module-level torch.cuda.{chain[2]}() creates a "
                       "CUDA context at import time")
            elif _cuda_literal(_kw(node, "device")) or (
                    isinstance(node.func, ast.Attribute)
                    and (node.func.attr == "cuda" or (
                        node.func.attr == "to" and node.args
                        and _cuda_literal(node.args[0])))):
                msg = ("module-level tensor on the card initializes CUDA "
                       "at import time; build it lazily")
            elif chain and chain[-1] in _KERNEL_BUILDS and (
                    "_build" in chain or chain[-1] == "_library") or (
                    len(chain) >= 2 and chain[-2] == "cpp_extension"):
                msg = ("module-level kernel build: kernels build on first "
                       "use, never at import")
            if msg and not mod.suppressed("GC005", node.lineno):
                out.append(Finding("GC005", mod.path, node.lineno,
                                   node.col_offset, msg))
    return out


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return files


def load_module(path: str) -> ModuleInfo:
    with open(path, "r", encoding="utf-8") as fh:
        return ModuleInfo(path, fh.read())


def suppression_stats(mods: Sequence[ModuleInfo]) -> Dict[str, int]:
    """Per-rule suppression-directive counts across ``mods`` (each
    file-level directive counts 1 per rule, each line directive 1 per
    (line, rule)). The CLI's ``--stats`` surfaces these so suppression
    creep is visible in CI output — the shipped tree's bar is zero.
    Only recognized rule ids (and ``all``) are counted: a directive
    naming a rule that does not exist suppresses nothing real (doc
    examples spelling ``GC00x`` would otherwise read as creep)."""
    known = set(RULE_DOCS) | {"all"}
    out: Dict[str, int] = {}
    for mod in mods:
        for rule in mod.file_suppress:
            if rule in known:
                out[rule] = out.get(rule, 0) + 1
        for rules in mod.line_suppress.values():
            for rule in rules:
                if rule in known:
                    out[rule] = out.get(rule, 0) + 1
    return out


def scan_paths(paths: Sequence[str],
               rules: Optional[Set[str]] = None,
               stats_out: Optional[dict] = None,
               roots: Optional[Dict[str, Sequence[str]]] = None,
               ) -> List[Finding]:
    """Run every AST rule (GC001-GC010) over ``paths`` (files or
    directory trees). ``rules`` restricts to a subset of rule ids.
    ``stats_out``, when given, is populated with per-rule finding and
    suppression counts plus the scanned-file count. ``roots`` replaces
    :data:`HOT_ROOTS` (module path suffix -> function names) for GC002."""
    mods: List[ModuleInfo] = []
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        try:
            mods.append(load_module(path))
        except SyntaxError as exc:
            findings.append(Finding(
                "GC000", path, exc.lineno or 0, exc.offset or 0,
                f"file does not parse: {exc.msg}"))

    def want(rule: str) -> bool:
        return rules is None or rule in rules

    reached: Dict[int, Set[int]] = {}
    if want("GC002"):
        reached = _Reachability(
            mods, HOT_ROOTS if roots is None else roots).run()

    for mod in mods:
        if want("GC001"):
            findings.extend(_check_gc001(mod))
        if want("GC003"):
            findings.extend(_check_gc003(mod))
        if want("GC004"):
            findings.extend(_check_gc004(mod))
        if want("GC005"):
            findings.extend(_check_gc005(mod))
        if want("GC007"):
            findings.extend(_check_gc007(mod))
    if want("GC002"):
        findings.extend(_check_gc002(mods, reached))
    if want("GC006"):
        from porqua_tpu_torch.analysis.guards import check_guarded_by
        for mod in mods:
            findings.extend(check_guarded_by(mod))
    if want("GC008") or want("GC009") or want("GC010"):
        from porqua_tpu_torch.analysis.concurrency import check_concurrency
        findings.extend(check_concurrency(mods, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if stats_out is not None:
        by_rule: Dict[str, int] = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        stats_out["files"] = len(mods)
        stats_out["findings_by_rule"] = by_rule
        stats_out["suppressions_by_rule"] = suppression_stats(mods)
    return findings
