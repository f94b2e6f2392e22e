"""graftcheck concurrency plane: GC008-GC010 static thread-safety rules
(the port of ``porqua_tpu/analysis/concurrency.py``; the rules are the
JAX package's, and ``torch.*`` calls, like ``jax.*`` ones, run a
callable argument on the calling thread).

The serve stack runs at least six concurrent actors — caller threads,
the batcher dispatch loop, continuous-cohort steppers, the
RetryManager timer thread, the EventBus/HTTP exposition server, and
breaker probe threads — and every recent review round found real
threading bugs in it. GC006 (:mod:`porqua_tpu_torch.analysis.guards`) only
checks attributes someone remembered to annotate with ``# guarded-by:``;
these rules close that opt-in blindness by *inferring* the lock
discipline from the code:

GC008  **Shared-state inference.** Build a thread-root reachability
       graph — roots are ``threading.Thread(target=...)`` /
       ``threading.Timer`` targets (each spawn site its own root),
       future/timer callbacks (any callable escaping into a call
       argument — ``add_done_callback``, retry-wheel lambdas — one
       root per escape site), ``http.server`` request-handler classes
       (the exposition daemon's threads), and the public API itself
       (every public method, the caller-thread root) — then walk the
       call graph (``self.m()``, attribute calls through inferred
       attribute types, same-module and ``from x import y`` names,
       subclass overrides of inherited thread targets) and flag any
       ``self._x`` *mutated* from two or more distinct roots when the
       mutation site is not inside ``with self.<lock>:``, the method
       does not carry a caller-holds ``# guarded-by:`` def-line
       annotation, and the attribute itself is not ``guarded-by``-
       annotated (annotated attributes are GC006's jurisdiction).
       ``__init__``/``__post_init__``/``__new__``/``__del__`` are
       exempt (the object is not yet / no longer shared), as are
       attributes holding intrinsically thread-safe stdlib objects
       (``threading.Lock``/``Event``/..., ``queue.Queue``/...).

GC009  **Static deadlock detection.** Extract the lock-acquisition-
       order graph: a node per ``(class, lock attribute)`` (lockdep-
       style — instances of one class share a node) or module-level
       lock; an edge ``A -> B`` whenever ``B`` is acquired while ``A``
       is lexically held — including *cross-object* acquisitions
       reached through the call graph (``with self._lock:`` calling a
       method of another class that takes its own lock). Any cycle is
       reported as a potential deadlock with every participating
       acquisition site in the message. ``threading.Condition(lock)``
       attributes alias to their underlying lock's node.

GC010  **Blocking call under a lock.** While a lock is held (lexically
       or transitively through the call graph), flag: untimed
       ``queue.put``/``queue.get`` (receiver inferred as a
       ``queue.Queue``-family object), ``future.result()`` without a
       timeout, ``.block_until_ready()``, AOT compilation
       (``aot_compile_*`` / ``jit(...).lower(...)`` /
       ``.lower(...).compile()``), ``time.sleep``, and socket/HTTP
       calls (``socket.*``, ``urllib.request.urlopen``,
       ``requests.*``). ``Condition.wait`` is exempt (it releases the
       lock), as is anything carrying an explicit timeout — the rule
       targets *unbounded* waits and multi-second work that wedge
       every other thread contending for the lock.

The runtime half of this plane is :mod:`porqua_tpu_torch.analysis.tsan`
(``PORQUA_TSAN=1``): the same acquisition-order discipline enforced on
live lock operations, so an inversion the static pass cannot see
(dynamic dispatch, callbacks) still raises under the stress passes.

All three rules run over the same :class:`~porqua_tpu_torch.analysis.lint.
ModuleInfo` set as GC001-GC007 (one parse per file) via
:func:`check_concurrency`; they are pure stdlib ``ast``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from porqua_tpu_torch.analysis.lint import Finding, ModuleInfo

__all__ = ["check_concurrency"]

#: Constructors whose instances are intrinsically thread-safe: mutation
#: through their methods needs no external lock, so GC008 skips
#: attributes initialized to one of these.
_THREADSAFE_CTORS = {
    ("threading", "Lock"), ("threading", "RLock"), ("threading", "Event"),
    ("threading", "Condition"), ("threading", "Semaphore"),
    ("threading", "BoundedSemaphore"), ("threading", "Barrier"),
    ("queue", "Queue"), ("queue", "SimpleQueue"), ("queue", "LifoQueue"),
    ("queue", "PriorityQueue"),
}

#: Constructors marking an attribute/local as a queue for GC010's
#: untimed put/get check.
_QUEUE_CTORS = {("queue", "Queue"), ("queue", "SimpleQueue"),
                ("queue", "LifoQueue"), ("queue", "PriorityQueue")}

#: The tsan drop-in lock factory also mints lock objects (GC008's
#: thread-safe exemption and GC009's lock-attr detection both honor
#: it): ``self._lock = tsan.lock("...")``.
_TSAN_FACTORIES = {"lock"}

_CTOR_EXEMPT = {"__init__", "__post_init__", "__new__", "__del__"}

#: Call-argument callables passed to these heads run on the *calling*
#: thread (tracing/functional wrappers), not on a new root.
_SAME_THREAD_HEADS = {"jax", "jnp", "torch", "functools", "np", "numpy",
                      "sorted", "min", "max", "map", "filter"}

_API_ROOT = "api"


def _is_property_def(node: ast.AST) -> bool:
    """A @property / @cached_property / @x.setter-decorated def:
    ``self.name`` referencing it is an attribute ACCESS, not a bound
    method escaping as a callback."""
    for dec in getattr(node, "decorator_list", ()):
        if isinstance(dec, ast.Name) \
                and dec.id in ("property", "cached_property"):
            return True
        if isinstance(dec, ast.Attribute) \
                and dec.attr in ("setter", "getter", "deleter"):
            return True
    return False


def _is_public_entry(name: str) -> bool:
    """Methods reachable from arbitrary caller threads: the public
    surface plus the dunders callers invoke (``with svc:``, len,
    call)."""
    if not name.startswith("_"):
        return True
    return name in ("__call__", "__enter__", "__exit__", "__len__",
                    "__contains__", "__iter__", "__getitem__")


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class _Class:
    """One scanned class: methods, resolved bases, inferred attribute
    types, guarded-by map, and lock-alias table."""

    def __init__(self, mod: ModuleInfo, node: ast.ClassDef) -> None:
        self.mod = mod
        self.node = node
        self.name = node.name
        self.methods: Dict[str, ast.AST] = {}
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
        self.bases: List["_Class"] = []          # resolved later
        self.base_names: List[str] = []
        for b in node.bases:
            chain = mod.attr_chain(b)
            if chain:
                self.base_names.append(chain[-1])
        self.attr_types: Dict[str, Set["_Class"]] = {}
        #: attrs initialized to thread-safe stdlib objects
        self.threadsafe_attrs: Set[str] = set()
        #: attrs initialized to queue.Queue-family objects
        self.queue_attrs: Set[str] = set()
        #: attrs that look like locks (Lock/RLock ctor or tsan.lock)
        self.lock_attrs: Set[str] = set()
        #: Condition attr -> underlying lock attr
        self.lock_aliases: Dict[str, str] = {}
        self.guarded: Dict[str, str] = {}        # attr -> lock (GC006 map)

    def mro(self) -> List["_Class"]:
        out, seen = [], set()
        stack = [self]
        while stack:
            c = stack.pop(0)
            if id(c) in seen:
                continue
            seen.add(id(c))
            out.append(c)
            stack.extend(c.bases)
        return out

    def find_method(self, name: str) -> List[Tuple["_Class", ast.AST]]:
        for c in self.mro():
            if name in c.methods:
                return [(c, c.methods[name])]
        return []


class _Analyzer:
    """Shared cross-module model for the three rules."""

    def __init__(self, mods: Sequence[ModuleInfo]) -> None:
        from porqua_tpu_torch.analysis.guards import _collect_guarded

        self.mods = mods
        self.by_modname: Dict[str, ModuleInfo] = {}
        for m in mods:
            dotted = m.posix.lstrip("/").removesuffix(".py").replace("/", ".")
            self.by_modname[dotted] = m
        # class registry
        self.classes: List[_Class] = []
        self.class_of_node: Dict[int, _Class] = {}
        self.classes_by_name: Dict[str, List[_Class]] = {}
        for mod in mods:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    c = _Class(mod, node)
                    c.guarded = _collect_guarded(mod, node)
                    self.classes.append(c)
                    self.class_of_node[id(node)] = c
                    self.classes_by_name.setdefault(c.name, []).append(c)
        for c in self.classes:
            for bname in c.base_names:
                rc = self._resolve_class_name(c.mod, bname)
                if rc is not None:
                    c.bases.append(rc)
        self.subclasses: Dict[int, List[_Class]] = {}
        for c in self.classes:
            for anc in c.mro()[1:]:
                self.subclasses.setdefault(id(anc), []).append(c)
        #: function node -> enclosing class (methods and nested defs)
        self.owner: Dict[int, Optional[_Class]] = {}
        for mod in mods:
            self._map_owners(mod.tree, None)
        for c in self.classes:
            self._infer_attr_types(c)

    # -- registry helpers --------------------------------------------

    def _module_for(self, dotted: str) -> Optional[ModuleInfo]:
        if dotted in self.by_modname:
            return self.by_modname[dotted]
        for name, m in self.by_modname.items():
            if name.endswith("." + dotted) or dotted.endswith("." + name):
                return m
        return None

    def _resolve_class_name(self, mod: ModuleInfo,
                            name: str) -> Optional[_Class]:
        """``name`` used in ``mod``: a class defined there, or imported
        from a scanned module."""
        for c in self.classes_by_name.get(name, ()):
            if c.mod is mod:
                return c
        if name in mod.imported_from:
            src, orig = mod.imported_from[name]
            target = self._module_for(src)
            if target is not None:
                for c in self.classes_by_name.get(orig, ()):
                    if c.mod is target:
                        return c
        return None

    def _map_owners(self, node: ast.AST,
                    cls: Optional[_Class]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._map_owners(child, self.class_of_node[id(child)])
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                self.owner[id(child)] = cls
                # nested defs keep the method's class for `self`
                self._map_owners(child, cls)
            else:
                self._map_owners(child, cls)

    # -- attribute type inference ------------------------------------

    def _classes_in_expr(self, mod: ModuleInfo,
                         expr: ast.AST) -> Set[_Class]:
        out: Set[_Class] = set()
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                chain = mod.attr_chain(sub.func)
                if chain and len(chain) == 1:
                    rc = self._resolve_class_name(mod, chain[0])
                    if rc is not None:
                        out.add(rc)
        return out

    def _names_in_annotation(self, mod: ModuleInfo,
                             ann: ast.AST) -> Set[_Class]:
        out: Set[_Class] = set()
        for sub in ast.walk(ann):
            if isinstance(sub, ast.Name):
                rc = self._resolve_class_name(mod, sub.id)
                if rc is not None:
                    out.add(rc)
            elif isinstance(sub, ast.Constant) \
                    and isinstance(sub.value, str):
                # forward references: `owner: "Outer"`
                try:
                    parsed = ast.parse(sub.value, mode="eval")
                except SyntaxError:
                    continue
                for leaf in ast.walk(parsed):
                    if isinstance(leaf, ast.Name):
                        rc = self._resolve_class_name(mod, leaf.id)
                        if rc is not None:
                            out.add(rc)
        return out

    @staticmethod
    def _ctor_id(mod: ModuleInfo, expr: ast.AST) -> Optional[Tuple[str, str]]:
        """``(module, Name)`` for a stdlib constructor call like
        ``threading.Lock()`` / ``queue.Queue(...)`` under any import
        style."""
        if not isinstance(expr, ast.Call):
            return None
        chain = mod.attr_chain(expr.func)
        if not chain:
            return None
        if len(chain) == 1:
            imp = mod.imported_from.get(chain[0])
            return (imp[0], imp[1]) if imp else None
        head = mod.module_aliases.get(chain[0], chain[0])
        return (head, chain[-1])

    def _infer_attr_types(self, c: _Class) -> None:
        mod = c.mod
        # __init__ parameter annotations feeding `self.x = param`
        param_ann: Dict[str, Set[_Class]] = {}
        init = c.methods.get("__init__")
        if init is not None:
            args = init.args
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                if a.annotation is not None:
                    param_ann[a.arg] = self._names_in_annotation(
                        mod, a.annotation)
        for node in ast.walk(c.node):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            value = node.value
            if value is None:
                continue
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                attr = t.attr
                found = self._classes_in_expr(mod, value)
                if isinstance(value, ast.Name) and value.id in param_ann:
                    found |= param_ann[value.id]
                if found:
                    self.attr_union(c, attr, found)
                ctor = self._ctor_id(mod, value)
                # `cond_expr if x else y`: look inside for ctor calls
                ctors = {self._ctor_id(mod, sub)
                         for sub in ast.walk(value)
                         if isinstance(sub, ast.Call)}
                ctors.discard(None)
                if ctor is not None:
                    ctors.add(ctor)
                for cid in ctors:
                    if cid in _THREADSAFE_CTORS:
                        c.threadsafe_attrs.add(attr)
                    if cid in _QUEUE_CTORS:
                        c.queue_attrs.add(attr)
                    if cid in (("threading", "Lock"), ("threading", "RLock")):
                        c.lock_attrs.add(attr)
                    if cid is not None and cid[0].endswith("tsan") \
                            and cid[1] in _TSAN_FACTORIES:
                        c.lock_attrs.add(attr)
                        c.threadsafe_attrs.add(attr)
                    if cid == ("threading", "Condition"):
                        c.lock_attrs.add(attr)
                        # Condition(self._lock): alias to the real lock
                        for sub in ast.walk(value):
                            if isinstance(sub, ast.Call):
                                sid = self._ctor_id(mod, sub)
                                if sid == ("threading", "Condition") \
                                        and sub.args:
                                    a0 = sub.args[0]
                                    if isinstance(a0, ast.Attribute) \
                                            and isinstance(a0.value, ast.Name) \
                                            and a0.value.id == "self":
                                        c.lock_aliases[attr] = a0.attr

    @staticmethod
    def attr_union(c: _Class, attr: str, found: Set[_Class]) -> None:
        c.attr_types.setdefault(attr, set()).update(found)

    # -- call resolution ---------------------------------------------

    def resolve_call(self, mod: ModuleInfo, cls: Optional[_Class],
                     call: ast.Call
                     ) -> List[Tuple[ModuleInfo, Optional[_Class], ast.AST]]:
        """Callee candidates for one call site. Deliberately narrow:
        bare names (local defs + ``from x import y``), ``self.m()``
        (MRO + subclass overrides), ``self.attr.m()`` through inferred
        attribute types, ``module_alias.f()``. Unresolvable attribute
        calls resolve to nothing — cross-module resolution by bare
        method name would drown the rules in name-collision edges."""
        func = call.func
        out: List[Tuple[ModuleInfo, Optional[_Class], ast.AST]] = []
        if isinstance(func, ast.Name):
            name = func.id
            if name in mod.imported_from:
                src, orig = mod.imported_from[name]
                target = self._module_for(src)
                if target is not None:
                    for node in target.defs_by_name.get(orig, ()):
                        out.append((target, self.owner.get(id(node)), node))
                    return out
            for node in mod.defs_by_name.get(name, ()):
                owner = self.owner.get(id(node))
                # bare-name calls cannot reach methods of other classes
                if owner is None or owner is cls:
                    out.append((mod, owner, node))
            return out
        chain = mod.attr_chain(func)
        if chain is None:
            return out
        if len(chain) == 2 and chain[0] == "self" and cls is not None:
            for c, node in cls.find_method(chain[1]):
                out.append((c.mod, c, node))
            # a Thread target bound on a base may run a subclass
            # override — include them so inherited dispatch loops are
            # walked at the subclass too.
            for sub in self.subclasses.get(id(cls), ()):
                if chain[1] in sub.methods:
                    out.append((sub.mod, sub, sub.methods[chain[1]]))
            return out
        if len(chain) == 3 and chain[0] == "self" and cls is not None:
            for c in self.mro_attr_types(cls, chain[1]):
                for cc, node in c.find_method(chain[2]):
                    out.append((cc.mod, cc, node))
            return out
        if len(chain) == 2 and chain[0] in mod.module_aliases:
            target = self._module_for(mod.module_aliases[chain[0]])
            if target is not None:
                for node in target.defs_by_name.get(chain[1], ()):
                    if self.owner.get(id(node)) is None:
                        out.append((target, None, node))
        return out

    @staticmethod
    def mro_attr_types(cls: _Class, attr: str) -> Set[_Class]:
        out: Set[_Class] = set()
        for c in cls.mro():
            out |= c.attr_types.get(attr, set())
        return out

    def mro_flag(self, cls: Optional[_Class], attr: str,
                 field: str) -> bool:
        if cls is None:
            return False
        return any(attr in getattr(c, field) for c in cls.mro())

    def mro_guard(self, cls: Optional[_Class],
                  attr: str) -> Optional[str]:
        if cls is None:
            return None
        for c in cls.mro():
            if attr in c.guarded:
                return c.guarded[attr]
        return None

    def lock_node(self, cls: Optional[_Class], mod: ModuleInfo,
                  attr: str) -> str:
        """Lockdep-style node name for one acquisition: per class (the
        base-most class in the scanned hierarchy that inits the lock),
        aliases (Condition) folded onto the underlying lock."""
        if cls is not None:
            for c in cls.mro():
                if attr in c.lock_aliases:
                    attr = c.lock_aliases[attr]
                    break
            owner = cls
            for c in reversed(cls.mro()):
                if attr in c.lock_attrs or attr in c.guarded.values():
                    owner = c
                    break
            return f"{owner.name}.{attr}"
        base = mod.posix.rsplit("/", 1)[-1].removesuffix(".py")
        return f"{base}.{attr}"


# ---------------------------------------------------------------------------
# thread roots
# ---------------------------------------------------------------------------

def _thread_ctor_kind(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    cid = _Analyzer._ctor_id(mod, call)
    if cid == ("threading", "Thread"):
        return "thread"
    if cid == ("threading", "Timer"):
        return "timer"
    return None


class _Roots:
    """Root set + reachability: maps every (function node) to the set
    of thread roots that can execute it."""

    def __init__(self, an: _Analyzer) -> None:
        self.an = an
        #: (id(func node)) -> set of root ids
        self.roots_of: Dict[int, Set[str]] = {}
        self.work: List[Tuple[ModuleInfo, Optional[_Class], ast.AST, str]] = []

    def _add(self, mod: ModuleInfo, cls: Optional[_Class],
             node: ast.AST, root: str) -> None:
        pool = self.roots_of.setdefault(id(node), set())
        if root not in pool:
            pool.add(root)
            self.work.append((mod, cls, node, root))

    def _add_callable_expr(self, mod: ModuleInfo, cls: Optional[_Class],
                           expr: ast.AST, root: str) -> None:
        if isinstance(expr, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            self._add(mod, self.an.owner.get(id(expr), cls), expr, root)
            return
        if isinstance(expr, ast.Name):
            for node in mod.defs_by_name.get(expr.id, ()):
                owner = self.an.owner.get(id(node))
                if owner is None or owner is cls:
                    self._add(mod, owner, node, root)
            return
        chain = mod.attr_chain(expr)
        if chain and len(chain) == 2 and chain[0] == "self" \
                and cls is not None:
            for c, node in cls.find_method(chain[1]):
                if not _is_property_def(node):
                    self._add(c.mod, c, node, root)
            for sub in self.an.subclasses.get(id(cls), ()):
                if chain[1] in sub.methods \
                        and not _is_property_def(sub.methods[chain[1]]):
                    self._add(sub.mod, sub, sub.methods[chain[1]], root)

    def collect(self) -> None:
        an = self.an
        for mod in an.mods:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                cls = self._enclosing_class(mod, node)
                kind = _thread_ctor_kind(mod, node)
                if kind == "thread":
                    name = None
                    target = None
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = kw.value
                        elif kw.arg == "name" and isinstance(
                                kw.value, ast.Constant):
                            name = kw.value.value
                    # positional: Thread(group, target, name, ...) —
                    # the FIRST slot is group, not target.
                    if target is None and len(node.args) >= 2:
                        target = node.args[1]
                    if target is not None:
                        root = f"thread:{name or f'{mod.path}:{node.lineno}'}"
                        self._add_callable_expr(mod, cls, target, root)
                    continue
                if kind == "timer":
                    # Timer(interval, function, ...) — function may be
                    # positional or the `function=` keyword.
                    fn_expr = (node.args[1] if len(node.args) >= 2
                               else None)
                    if fn_expr is None:
                        for kw in node.keywords:
                            if kw.arg == "function":
                                fn_expr = kw.value
                    if fn_expr is not None:
                        self._add_callable_expr(
                            mod, cls, fn_expr,
                            f"timer:{mod.path}:{node.lineno}")
                    continue
                # escaping callables: a lambda/def handed into ANY call
                # runs on whatever thread the holder chooses (future
                # callbacks, timer wheels) — its own root per site.
                # Tracing/functional heads (jax.*, functools.partial)
                # run the callable on the calling thread; their args
                # are walked as part of the enclosing function instead.
                head_chain = mod.attr_chain(node.func)
                head = head_chain[0] if head_chain else None
                if head in _SAME_THREAD_HEADS \
                        or head in mod.jnp_aliases or head in mod.jax_aliases \
                        or head in mod.np_aliases \
                        or head in mod.functools_aliases \
                        or (head is not None and head in mod.partial_names):
                    continue
                # **spread keywords (kw.arg None) unpack DATA mappings
                # (`f(**self.arguments)`), never escape a callable.
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords
                                              if kw.arg is not None]:
                    if isinstance(arg, ast.Lambda):
                        self._add(mod, an.owner.get(id(arg), cls), arg,
                                  f"cb:{mod.path}:{arg.lineno}")
                    elif isinstance(arg, ast.Attribute):
                        # a BOUND METHOD escaping as a callback
                        # (fut.add_done_callback(self._on_done)) is a
                        # root exactly like a lambda; _add_callable_expr
                        # only roots names that resolve to methods, so
                        # data attributes passed as arguments add
                        # nothing.
                        self._add_callable_expr(
                            mod, cls, arg,
                            f"cb:{mod.path}:{arg.lineno}")
        # HTTP handler classes: every method runs on a server thread.
        for c in an.classes:
            if any(b == "BaseHTTPRequestHandler" for b in c.base_names):
                for name, meth in c.methods.items():
                    if name not in _CTOR_EXEMPT:
                        self._add(c.mod, c, meth, "http-handler")
        # the caller-thread root: the public API surface
        for c in an.classes:
            for name, meth in c.methods.items():
                if _is_public_entry(name):
                    self._add(c.mod, c, meth, _API_ROOT)
        for mod in an.mods:
            for name, nodes in mod.defs_by_name.items():
                for node in nodes:
                    if an.owner.get(id(node)) is None \
                            and not name.startswith("_"):
                        self._add(mod, None, node, _API_ROOT)

    def _enclosing_class(self, mod: ModuleInfo,
                         node: ast.AST) -> Optional[_Class]:
        n = getattr(node, "_gc_parent", None)
        while n is not None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return self.an.owner.get(id(n))
            if isinstance(n, ast.ClassDef):
                return self.an.class_of_node[id(n)]
            n = getattr(n, "_gc_parent", None)
        return None

    def run(self) -> None:
        self.collect()
        an = self.an
        while self.work:
            mod, cls, fn, root = self.work.pop()
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                if _thread_ctor_kind(mod, sub) is not None:
                    continue  # spawns a root, handled in collect()
                for (m2, c2, n2) in an.resolve_call(mod, cls, sub):
                    self._add(m2, c2, n2, root)


# ---------------------------------------------------------------------------
# GC008 — shared-state inference
# ---------------------------------------------------------------------------

def _held_locks_at(node: ast.AST) -> Set[str]:
    """Lock attrs lexically held at ``node`` via ``with self.X:``
    contexts inside the enclosing function (nested defs break the
    chain — they run later, without the lock)."""
    held: Set[str] = set()
    child: ast.AST = node
    anc = getattr(node, "_gc_parent", None)
    while anc is not None:
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            break
        if isinstance(anc, ast.With) and child in anc.body:
            for item in anc.items:
                ce = item.context_expr
                if isinstance(ce, ast.Attribute) \
                        and isinstance(ce.value, ast.Name) \
                        and ce.value.id == "self":
                    held.add(ce.attr)
        child = anc
        anc = getattr(anc, "_gc_parent", None)
    return held


def _enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    anc = getattr(node, "_gc_parent", None)
    while anc is not None:
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return anc
        anc = getattr(anc, "_gc_parent", None)
    return None


def _enclosing_method(node: ast.AST) -> Optional[ast.AST]:
    """The outermost enclosing function whose parent is a ClassDef."""
    fn = _enclosing_function(node)
    while fn is not None:
        parent = getattr(fn, "_gc_parent", None)
        if isinstance(parent, ast.ClassDef):
            return fn
        fn = _enclosing_function(fn)
    return None


def _iter_self_mutations(mod: ModuleInfo, fn: ast.AST
                         ) -> Iterable[Tuple[str, ast.AST, str]]:
    """(attr, site node, verb) for every ``self.attr`` mutation inside
    ``fn``'s own body (nested defs excluded — they are walked as their
    own functions)."""
    from porqua_tpu_torch.analysis.guards import _MUTATORS, _self_attr

    def own(node: ast.AST) -> bool:
        return _enclosing_function(node) is fn

    def targets_of(t: ast.AST) -> Iterable[str]:
        attr = _self_attr(t)
        if attr is None and isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
        if attr is not None:
            yield attr
        elif isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                yield from targets_of(elt)

    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            continue
        if not own(node):
            continue
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in tgts:
                for attr in targets_of(t):
                    yield attr, node, "assigned"
        elif isinstance(node, ast.AugAssign):
            for attr in targets_of(node.target):
                yield attr, node, "updated"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                for attr in targets_of(t):
                    yield attr, node, "deleted"
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value)
            if attr is not None:
                yield attr, node, f"mutated via .{node.func.attr}()"


def _check_gc008(an: _Analyzer, roots: _Roots) -> List[Finding]:
    from porqua_tpu_torch.analysis.guards import _guard_on_line

    # (hierarchy-root class, attr) -> list of
    #   (cls, mod, site, verb, roots, protected)
    records: Dict[Tuple[int, str], List[tuple]] = {}
    anchor: Dict[int, _Class] = {}

    for c in an.classes:
        chain = c.mro()
        anchor[id(c)] = chain[-1] if chain else c

    for c in an.classes:
        mod = c.mod
        for mname, meth in c.methods.items():
            if mname in _CTOR_EXEMPT:
                continue
            fns = [meth] + [n for n in ast.walk(meth)
                            if isinstance(n, (ast.FunctionDef,
                                              ast.AsyncFunctionDef,
                                              ast.Lambda)) and n is not meth]
            for fn in fns:
                fn_roots = roots.roots_of.get(id(fn), set())
                if not fn_roots:
                    continue
                caller_holds = _guard_on_line(mod, fn.lineno) \
                    if not isinstance(fn, ast.Lambda) else set()
                for attr, site, verb in _iter_self_mutations(mod, fn):
                    if an.mro_guard(c, attr) is not None:
                        continue  # GC006's jurisdiction
                    if verb.startswith("mutated via") \
                            and an.mro_flag(c, attr, "threadsafe_attrs"):
                        continue  # Queue.put / Event.clear etc.
                    held = _held_locks_at(site) | caller_holds
                    protected = bool(held)
                    key = (id(anchor[id(c)]), attr)
                    records.setdefault(key, []).append(
                        (c, mod, site, verb, frozenset(fn_roots),
                         protected))

    out: List[Finding] = []
    # dedup per (path, line, ATTR): `self._a, self._b = f()` mutates
    # two attributes on one line — both must be reported, or one scan
    # understates the unguarded surface.
    seen: Set[Tuple[str, int, str]] = set()
    for (_, attr), recs in records.items():
        all_roots: Set[str] = set()
        for _, _, _, _, rts, _ in recs:
            all_roots |= rts
        if len(all_roots) < 2:
            continue
        for c, mod, site, verb, _, protected in recs:
            if protected:
                continue
            if mod.suppressed("GC008", site.lineno):
                continue
            key = (mod.path, site.lineno, attr)
            if key in seen:
                continue
            seen.add(key)
            roots_desc = ", ".join(sorted(all_roots))
            out.append(Finding(
                "GC008", mod.path, site.lineno, site.col_offset,
                f"{c.name}.{attr} is {verb} here but is written from "
                f"multiple thread roots ({roots_desc}) with no lock "
                f"held; wrap in `with self.<lock>:` or annotate the "
                f"attribute `# guarded-by: self.<lock>` (GC006 then "
                f"enforces it)"))
    return out


# ---------------------------------------------------------------------------
# lock regions (shared by GC009/GC010)
# ---------------------------------------------------------------------------

class _Region:
    """One lexically-held lock: the With node (or guarded-by method
    body) plus everything needed to attribute findings."""

    def __init__(self, node: ast.AST, mod: ModuleInfo,
                 cls: Optional[_Class], lock_attr: str,
                 body: List[ast.AST]) -> None:
        self.node = node
        self.mod = mod
        self.cls = cls
        self.lock_attr = lock_attr
        self.body = body

    def site(self) -> str:
        return f"{self.mod.path}:{self.node.lineno}"


def _module_lock_names(mod: ModuleInfo) -> Set[str]:
    """Module-level names bound to Lock/RLock constructors."""
    out: Set[str] = set()
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call):
            cid = _Analyzer._ctor_id(mod, stmt.value)
            if cid in (("threading", "Lock"), ("threading", "RLock")):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _iter_regions(an: _Analyzer) -> Iterable[_Region]:
    from porqua_tpu_torch.analysis.guards import _guard_on_line

    for mod in an.mods:
        mod_locks = _module_lock_names(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.With):
                fn = _enclosing_function(node)
                cls = an.owner.get(id(fn)) if fn is not None else None
                for item in node.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Attribute) \
                            and isinstance(ce.value, ast.Name) \
                            and ce.value.id == "self" and cls is not None:
                        yield _Region(node, mod, cls, ce.attr, node.body)
                    elif isinstance(ce, ast.Name) and ce.id in mod_locks:
                        yield _Region(node, mod, None, ce.id, node.body)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls = an.owner.get(id(node))
                if cls is None:
                    continue
                for lock in _guard_on_line(mod, node.lineno):
                    # caller-holds methods: body runs under the lock
                    yield _Region(node, mod, cls, lock, node.body)


def _walk_region(an: _Analyzer, region: _Region, visit_fn) -> None:
    """Call ``visit_fn(mod, cls, fn_node_or_None, stmt_iterable,
    depth, path)`` for the region body and, transitively, every
    resolvable callee body (bounded)."""
    seen: Set[int] = set()

    # Direct body: all nodes excluding nested function bodies (those
    # run later, without the lock).
    def iter_nodes(body, owner_fn):
        for stmt in body:
            for sub in ast.walk(stmt):
                if _enclosing_function(sub) is owner_fn:
                    yield sub

    def recurse(mod, cls, body, owner_fn, depth, path):
        nodes = list(iter_nodes(body, owner_fn))
        visit_fn(mod, cls, nodes, depth, path)
        if depth >= 6:
            return
        for sub in nodes:
            if not isinstance(sub, ast.Call):
                continue
            if _thread_ctor_kind(mod, sub) is not None:
                continue  # spawning a thread is not calling its target
            for (m2, c2, n2) in an.resolve_call(mod, cls, sub):
                if id(n2) in seen or isinstance(n2, ast.Lambda):
                    continue
                seen.add(id(n2))
                name = getattr(n2, "name", "<fn>")
                recurse(m2, c2, n2.body, n2, depth + 1,
                        path + [f"{name}() at {m2.path}:{n2.lineno}"])

    owner = (region.node if isinstance(
        region.node, (ast.FunctionDef, ast.AsyncFunctionDef))
        else _enclosing_function(region.node))
    recurse(region.mod, region.cls, region.body, owner, 0, [])


# ---------------------------------------------------------------------------
# GC009 — static deadlock detection
# ---------------------------------------------------------------------------

def _check_gc009(an: _Analyzer) -> List[Finding]:
    #: edge (held lock node -> acquired lock node) ->
    #:   (outer-region mod/node, inner-acquisition mod/node)
    edges: Dict[Tuple[str, str],
                Tuple[ModuleInfo, ast.AST, ModuleInfo, ast.AST]] = {}

    for region in _iter_regions(an):
        held = an.lock_node(region.cls, region.mod, region.lock_attr)

        def visit(mod, cls, nodes, depth, path,
                  held=held, region=region):
            for sub in nodes:
                if not isinstance(sub, ast.With):
                    continue
                for item in sub.items:
                    ce = item.context_expr
                    acquired: Optional[str] = None
                    if isinstance(ce, ast.Attribute) \
                            and isinstance(ce.value, ast.Name) \
                            and ce.value.id == "self" \
                            and cls is not None \
                            and an.mro_flag(cls, ce.attr, "lock_attrs"):
                        acquired = an.lock_node(cls, mod, ce.attr)
                    elif isinstance(ce, ast.Name) \
                            and ce.id in _module_lock_names(mod):
                        acquired = an.lock_node(None, mod, ce.id)
                    if acquired is not None and acquired != held:
                        edges.setdefault(
                            (held, acquired),
                            (region.mod, region.node, mod, sub))

        _walk_region(an, region, visit)

    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    out: List[Finding] = []
    reported: Set[frozenset] = set()

    def dfs(start: str, node: str, path: List[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cyc = frozenset(path)
                if cyc in reported:
                    continue
                reported.add(cyc)
                cycle_nodes = path + [start]
                sites = []
                for a, b in zip(cycle_nodes, cycle_nodes[1:]):
                    emod, enode, imod, isite = edges[(a, b)]
                    sites.append(
                        f"{a} -> {b} (held at {emod.path}:{enode.lineno}"
                        f", acquired at {imod.path}:{isite.lineno})")
                emod, enode, _, _ = edges[(cycle_nodes[0], cycle_nodes[1])]
                if not emod.suppressed("GC009", enode.lineno):
                    out.append(Finding(
                        "GC009", emod.path, enode.lineno, enode.col_offset,
                        "lock-order cycle (potential deadlock): "
                        + "; ".join(sites)
                        + " — acquire these locks in one global order"))
            elif nxt not in path and nxt > start:
                # Only walk nodes > start: each cycle is enumerated
                # exactly once, rooted at its smallest node.
                dfs(start, nxt, path + [nxt])

    for start in sorted(graph):
        dfs(start, start, [start])
    return out


# ---------------------------------------------------------------------------
# GC010 — blocking call under a lock
# ---------------------------------------------------------------------------

def _queue_typed(an: _Analyzer, mod: ModuleInfo, cls: Optional[_Class],
                 nodes_fn: ast.AST, recv: ast.AST) -> bool:
    """Is ``recv`` a queue.Queue-family object? self.attr via inferred
    attr kinds; bare local names via same-function ctor assignment."""
    if isinstance(recv, ast.Attribute) and isinstance(recv.value, ast.Name):
        if recv.value.id == "self":
            return an.mro_flag(cls, recv.attr, "queue_attrs")
        # two-level: self.batcher.queue — look through one typed hop
    chain = mod.attr_chain(recv)
    if chain and len(chain) == 3 and chain[0] == "self" and cls is not None:
        for c in an.mro_attr_types(cls, chain[1]):
            if an.mro_flag(c, chain[2], "queue_attrs"):
                return True
    if isinstance(recv, ast.Name):
        fn = nodes_fn
        if fn is not None:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign) \
                        and isinstance(sub.value, ast.Call) \
                        and _Analyzer._ctor_id(mod, sub.value) in _QUEUE_CTORS:
                    for t in sub.targets:
                        if isinstance(t, ast.Name) and t.id == recv.id:
                            return True
    return False


def _has_timeout(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout":
            return True
        # block=False is a NON-blocking call; block=True (or a
        # non-constant) leaves the wait unbounded and exempts nothing.
        if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


def _queue_wait_unbounded(meth: str, call: ast.Call) -> bool:
    """Is this queue ``get``/``put`` an UNBOUNDED wait? Keyword and
    positional spellings both count — ``get(block, timeout)``,
    ``put(item, block, timeout)``: ``block=False`` (either spelling)
    is non-blocking, any timeout bounds the wait."""
    if _has_timeout(call):
        return False
    block_pos = 0 if meth == "get" else 1
    args = call.args
    if len(args) > block_pos:
        blk = args[block_pos]
        if isinstance(blk, ast.Constant) and blk.value is False:
            return False
    if len(args) > block_pos + 1:
        return False  # positional timeout present
    return True


def _condition_typed(an: _Analyzer, cls: Optional[_Class],
                     recv: ast.AST) -> bool:
    """Is ``recv`` a ``self.<attr>`` known to be a
    ``threading.Condition`` (recorded in the class's lock-alias
    table)? Condition.wait releases its lock while blocked — the one
    ``.wait`` that is correct under that lock."""
    if cls is None or not isinstance(recv, ast.Attribute) \
            or not isinstance(recv.value, ast.Name) \
            or recv.value.id != "self":
        return False
    return any(recv.attr in c.lock_aliases for c in cls.mro())


def _blocking_what(an: _Analyzer, mod: ModuleInfo, cls: Optional[_Class],
                   fn: Optional[ast.AST], call: ast.Call) -> Optional[str]:
    func = call.func
    chain = mod.attr_chain(func)
    if isinstance(func, ast.Attribute):
        meth = func.attr
        if meth == "block_until_ready":
            return ".block_until_ready()"
        if meth == "result" and not call.args and not _has_timeout(call):
            return "future.result() with no timeout"
        if meth in ("get", "put") and _queue_wait_unbounded(meth, call) \
                and _queue_typed(an, mod, cls, fn, func.value):
            return f"untimed queue.{meth}()"
        if meth == "compile":
            src = ast.unparse(func.value)
            if "lower(" in src or "jit(" in src:
                return "AOT compile (.lower(...).compile())"
        if meth == "lower":
            src = ast.unparse(func.value)
            if "jit(" in src:
                return "AOT trace (jit(...).lower(...))"
    if chain:
        head = mod.module_aliases.get(chain[0], chain[0])
        imp = mod.imported_from.get(chain[0])
        if len(chain) == 2 and head == "time" and chain[1] == "sleep":
            return "time.sleep()"
        if imp is not None and imp == ("time", "sleep"):
            return "time.sleep()"
        if head == "socket" and len(chain) >= 2:
            return f"socket call socket.{'.'.join(chain[1:])}()"
        if head == "requests" and len(chain) == 2:
            return f"HTTP call requests.{chain[1]}()"
        if chain[-1] == "urlopen":
            if (imp is not None and imp[0].startswith("urllib")) \
                    or head.startswith("urllib"):
                return "HTTP call urlopen()"
        if chain[-1].startswith("aot_compile"):
            return f"AOT compile ({chain[-1]})"
    return None


def _check_gc010(an: _Analyzer) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int, str]] = set()

    for region in _iter_regions(an):
        lock_name = an.lock_node(region.cls, region.mod, region.lock_attr)
        # Condition.wait is the one blocking call that's CORRECT under
        # its own lock (it releases it); the region's lock aliases to
        # the condition's underlying lock, so exempt wait entirely.

        def visit(mod, cls, nodes, depth, path,
                  lock_name=lock_name, region=region):
            for sub in nodes:
                if not isinstance(sub, ast.Call):
                    continue
                if isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "wait":
                    # Exempt only Condition.wait (it RELEASES the lock
                    # while blocked) and timeout-bounded waits. An
                    # untimed Event.wait() under a lock is the
                    # unbounded-wait deadlock this rule exists for:
                    # the setter may need the very lock we hold.
                    if sub.args or _has_timeout(sub) \
                            or _condition_typed(an, cls, sub.func.value):
                        continue
                    what = "untimed .wait()"
                else:
                    owner_fn = _enclosing_function(sub)
                    what = _blocking_what(an, mod, cls, owner_fn, sub)
                if what is None:
                    continue
                key = (mod.path, sub.lineno, lock_name)
                if key in seen or mod.suppressed("GC010", sub.lineno):
                    continue
                seen.add(key)
                via = (f" (reached via {' -> '.join(path)})"
                       if path else "")
                out.append(Finding(
                    "GC010", mod.path, sub.lineno, sub.col_offset,
                    f"{what} while holding {lock_name} (acquired at "
                    f"{region.site()}){via}; blocking work under a "
                    f"lock wedges every thread contending for it — "
                    f"move it outside the critical section or bound "
                    f"it with a timeout"))

        _walk_region(an, region, visit)
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def check_concurrency(mods: Sequence[ModuleInfo],
                      rules: Optional[Set[str]] = None) -> List[Finding]:
    """Run GC008/GC009/GC010 over an already-parsed module set."""
    def want(rule: str) -> bool:
        return rules is None or rule in rules

    an = _Analyzer(mods)
    out: List[Finding] = []
    if want("GC008"):
        roots = _Roots(an)
        roots.run()
        out.extend(_check_gc008(an, roots))
    if want("GC009"):
        out.extend(_check_gc009(an))
    if want("GC010"):
        out.extend(_check_gc010(an))
    return out
