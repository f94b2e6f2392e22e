"""GC006: ``# guarded-by:`` annotation-driven thread-safety lint (the
port of ``porqua_tpu/analysis/guards.py``, the same rule).

The serving stack (``serve/batcher.py``, ``serve/service.py``,
``serve/bucketing.py``) shares mutable state between the caller
threads, the dispatch thread, and scrap probe threads. The lock
discipline is a convention: certain attributes may only be *mutated*
while holding a specific lock. This lint makes the convention
declarative and machine-checked:

* Annotate the attribute at its initialization site (same line, or a
  comment-only line directly above)::

      self._lock = threading.Lock()
      self._cache = {}  # guarded-by: self._lock

* Every later mutation of ``self._cache`` — assignment, augmented
  assignment, ``del``, subscript store, or a mutating method call
  (``append``/``pop``/``update``/``move_to_end``/...) — must occur
  lexically inside ``with self._lock:`` in the same method, or inside
  a method whose ``def`` line carries the same annotation (the
  "caller holds the lock" contract, for private helpers invoked under
  the lock)::

      def _trip(self) -> None:  # guarded-by: self._lock
          self._degraded = True

* ``__init__``/``__post_init__``/``__new__`` are exempt (the object is
  not yet shared), and *reads* are not checked — the discipline here
  is writer-side; racy reads that matter are the writer's bug to
  prevent by publishing consistent snapshots.

A ``with`` held-lock context does NOT propagate into nested ``def``s:
a nested function is typically a thread target or callback that runs
without the lock.

Scope: GC006 is **opt-in** — it enforces exactly the attributes
someone annotated. Its inference-side complement is GC008
(:mod:`porqua_tpu_torch.analysis.concurrency`), which walks the thread-root
reachability graph and flags *unannotated* ``self`` attributes
mutated from two or more roots with no lock held; an attribute GC008
surfaces is fixed by adding the ``# guarded-by:`` annotation (plus
the lock, where the mutation was a true race), which moves it into
this rule's jurisdiction. The writer-side rules here and the
mutation detection in GC008 share one ``_MUTATORS`` vocabulary.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from porqua_tpu_torch.analysis.lint import Finding, ModuleInfo

__all__ = ["check_guarded_by"]

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*self\.(\w+)")

#: method names whose call on a guarded attribute mutates it
#: (shared with GC008's mutation detection). ``__setitem__`` /
#: ``__delitem__`` cover the explicit dunder-call spelling of a
#: subscript/slice store (``self._data.__setitem__(slice(0, k), v)``)
#: — the operator forms are caught as Subscript targets; ``rotate``
#: is deque's in-place rotation.
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popitem", "popleft", "clear", "update",
    "setdefault", "move_to_end", "sort", "reverse", "rotate",
    "__setitem__", "__delitem__",
}

_CTOR_EXEMPT = {"__init__", "__post_init__", "__new__", "__del__"}


def _guard_on_line(mod: ModuleInfo, lineno: int) -> Set[str]:
    """Lock names annotated on ``lineno`` (1-based) or on a
    comment-only line directly above it."""
    locks: Set[str] = set()
    if 1 <= lineno <= len(mod.lines):
        locks.update(_GUARD_RE.findall(mod.lines[lineno - 1]))
    if lineno >= 2:
        above = mod.lines[lineno - 2].strip()
        if above.startswith("#"):
            locks.update(_GUARD_RE.findall(above))
    return locks


def _self_attr(node: ast.AST) -> str | None:
    """'attr' when ``node`` is exactly ``self.attr``."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _collect_guarded(mod: ModuleInfo, cls: ast.ClassDef) -> Dict[str, str]:
    """attr -> lock name, from annotated ``self.attr = ...`` sites."""
    guarded: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                for lock in _guard_on_line(mod, node.lineno):
                    guarded[attr] = lock
    return guarded


class _MethodWalker:
    """Walk one method body tracking which locks are lexically held."""

    def __init__(self, mod: ModuleInfo, cls_name: str, method_name: str,
                 guarded: Dict[str, str], findings: List[Finding]) -> None:
        self.mod = mod
        self.cls_name = cls_name
        self.method_name = method_name
        self.guarded = guarded
        self.findings = findings

    def _locks_in_with(self, node: ast.With) -> Set[str]:
        locks: Set[str] = set()
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None:
                locks.add(attr)
        return locks

    def _flag(self, node: ast.AST, attr: str, verb: str) -> None:
        if self.mod.suppressed("GC006", node.lineno):
            return
        lock = self.guarded[attr]
        self.findings.append(Finding(
            "GC006", self.mod.path, node.lineno, node.col_offset,
            f"{self.cls_name}.{attr} is guarded-by self.{lock} but is "
            f"{verb} in {self.method_name}() without holding it; wrap in "
            f"`with self.{lock}:` or annotate the def line if callers "
            f"hold the lock"))

    def _check_target(self, target: ast.AST, node: ast.AST,
                      held: Set[str], verb: str) -> None:
        attr = _self_attr(target)
        if attr is None and isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
        if attr is None and isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_target(elt, node, held, verb)
            return
        if attr is not None and attr in self.guarded \
                and self.guarded[attr] not in held:
            self._flag(node, attr, verb)

    def _check_exprs(self, node: ast.AST, held: Set[str]) -> None:
        """Expression-level checks over one simple statement (or one
        compound statement's header expression)."""
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                for t in targets:
                    self._check_target(t, sub, held, "assigned")
            elif isinstance(sub, ast.AugAssign):
                self._check_target(sub.target, sub, held, "updated")
            elif isinstance(sub, ast.Delete):
                for t in sub.targets:
                    self._check_target(t, sub, held, "deleted")
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _MUTATORS:
                attr = _self_attr(sub.func.value)
                if attr is not None and attr in self.guarded \
                        and self.guarded[attr] not in held:
                    self._flag(sub, attr, f"mutated via .{sub.func.attr}()")

    def walk(self, stmts, held: Set[str]) -> None:
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # Nested def: runs later (thread target, callback) —
                # the lexically held lock does not apply; honor a
                # caller-holds annotation on its own def line.
                self.walk(node.body, _guard_on_line(self.mod, node.lineno))
            elif isinstance(node, ast.With):
                self.walk(node.body, held | self._locks_in_with(node))
            elif hasattr(node, "body"):
                # Compound statement (if/for/while/try/match): check
                # its header expressions, then recurse into each block
                # so nested `with self._lock:` contexts are honored.
                for field in ("test", "iter", "target", "subject"):
                    header = getattr(node, field, None)
                    if header is not None:
                        self._check_exprs(header, held)
                for field in ("body", "orelse", "finalbody"):
                    sub_stmts = getattr(node, field, None)
                    if sub_stmts:
                        self.walk(sub_stmts, held)
                for handler in getattr(node, "handlers", []) or []:
                    self.walk(handler.body, held)
            else:
                self._check_exprs(node, held)


def check_guarded_by(mod: ModuleInfo) -> List[Finding]:
    """Run the GC006 lint over every class in ``mod``."""
    findings: List[Finding] = []
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded = _collect_guarded(mod, cls)
        if not guarded:
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name in _CTOR_EXEMPT:
                continue
            held = _guard_on_line(mod, method.lineno)
            _MethodWalker(mod, cls.name, method.name, guarded,
                          findings).walk(method.body, held)
    return findings
