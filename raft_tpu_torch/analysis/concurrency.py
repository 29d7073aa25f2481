"""graftcheck ``--threads`` — concurrency-discipline rules T001–T004.

The port's copy of ``raft_tpu.analysis.concurrency``, scanning
``raft_tpu_torch`` (the rules are package-agnostic: ``run_threads`` over
``raft_tpu`` gives raft_tpu's findings). The serving/comms stack is the
busiest multi-threaded code in the repo (Batcher admission,
dispatch/completion/watchdog threads, MetricsServer handler threads,
host_p2p accept/serve/send loops). This module makes
the lock discipline *checkable*: every class that owns a threading
primitive or spawns a thread declares which lock covers each piece of
shared state, and four pure-AST rules audit the declarations.

Rules
-----
T001  unguarded shared state — an attribute written after ``__init__``
      from a derived thread entry point must be covered by a
      ``# guarded_by: <lock>`` declaration (or ``@guarded_by("lock")``
      on the writing method), be of a synchronized/atomic-registered
      type (``queue.Queue``, ``threading.Event``, ``collections.deque``
      …), or carry a baseline justification.
T002  lock-order cycles over the acquires-while-holding graph: a cycle
      (including a self-loop — re-acquiring a non-reentrant Lock) is a
      deadlock hazard.
T003  blocking call while holding a lock: ``Future.result()`` /
      ``Queue.get()`` / ``.join()`` / ``.acquire()`` / ``.wait()``
      without a timeout, ``time.sleep``, socket ``recv``/``accept``, or
      acquiring an un-analyzable (foreign) lock, lexically inside a
      ``with <lock>`` region — directly or through a self-method call.
      ``Condition.wait`` on a condition of the *same* class is excluded
      (it releases the lock; T004 owns it).
T004  ``Condition.wait`` outside a predicate ``while`` loop (spurious
      wakeups and stolen predicates make a bare ``if``+``wait`` wrong).

Thread model — derived, not hand-listed
---------------------------------------
A class is *concurrency-visible* when it assigns a threading primitive
to ``self``, spawns a ``threading.Thread``/``Timer``, or subclasses an
HTTP handler. Its entry points ("roots") are discovered from the AST:

* ``threading.Thread(target=self.m)`` / ``Timer(..., self.m)`` call
  sites (a spawn site under a loop marks the root multi-instance);
* ``do_*`` methods of HTTP handler subclasses (one instance per
  request thread — always multi-instance);
* every public method, as a single "client" pseudo-root: callers may
  invoke the object from any number of threads (the presence of a lock
  on the class is the declaration of that contract).

An attribute write is a hazard when a multi-instance root reaches it or
two distinct roots reach it (closure over ``self.m()`` calls).

Known limits (documented, deliberate): module-level globals guarded by
module-level locks are out of scope, as are locks reached through
``self.other_object._lock`` (cross-object edges are not modeled —
T003's foreign-lock heuristic flags the acquisition instead).

The lock-order graph can be exported as DOT via :func:`lock_order_dot`
(``python -m raft_tpu_torch.analysis --threads --dot``); cycles render red.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from raft_tpu_torch.analysis.astutils import ModuleInfo
from raft_tpu_torch.analysis.findings import Finding

__all__ = [
    "guarded_by", "ClassModel", "build_class_models",
    "rule_unguarded_shared_state", "rule_lock_order",
    "rule_blocking_while_locked", "rule_condition_wait_loop",
    "THREAD_RULES", "THREAD_SCAN_DIRS", "run_threads",
    "lock_order_dot", "thread_model_summary",
]

#: directories scanned by ``--threads`` (tests/tools spawn throwaway
#: threads by design and would drown the signal).
THREAD_SCAN_DIRS = ("raft_tpu_torch",)


def guarded_by(lock_name: str):
    """Runtime no-op decorator form of the ``# guarded_by:`` annotation.

    ``@guarded_by("_lock")`` on a method declares that the method runs
    with ``self._lock`` held by every caller; writes inside it are
    treated as covered by that lock and T003 treats its body as a
    lock-held region. The comment form is preferred for attributes."""
    def deco(fn):
        return fn
    return deco


_GUARD_RE = re.compile(r"#\s*guarded_by:\s*([A-Za-z_]\w*)")

_LOCK_CTORS = {"threading.Lock", "threading.RLock"}
_COND_CTORS = {"threading.Condition"}
#: constructed types whose instances are internally synchronized (or
#: GIL-atomic for the mutations this codebase performs on them) — an
#: attribute holding one needs no guarded_by declaration.
_SYNC_CTORS = _LOCK_CTORS | _COND_CTORS | {
    "threading.Semaphore", "threading.BoundedSemaphore",
    "threading.Event", "threading.Barrier", "threading.local",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "collections.deque", "itertools.count",
}
_HTTP_HANDLER_BASES = {
    "BaseHTTPRequestHandler", "SimpleHTTPRequestHandler",
    "CGIHTTPRequestHandler", "BaseRequestHandler", "StreamRequestHandler",
}
#: method calls that mutate common containers in place.
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "add", "insert",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
}
#: ``obj.meth()`` with no args and no timeout kwarg that can block
#: forever (the no-args requirement excludes ``str.join``/``dict.get``).
_BLOCKING_NOARG = {"result", "get", "join", "acquire", "wait"}
#: socket-ish calls that block regardless of arguments.
_BLOCKING_ALWAYS = {"accept"}
_FOREIGN_LOCK_RE = re.compile(r"(^|_)(lock|mutex|cv|cond)\w*$")


# ------------------------------------------------------------ class model


def _self_attr(node) -> Optional[str]:
    """``self.X`` → ``"X"`` else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _write_targets(node) -> List[str]:
    """Attributes of ``self`` written by an assignment-like target:
    ``self.x = …``, ``self.x += …``, ``self.x[i] = …``."""
    out = []
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    for t in targets:
        while isinstance(t, ast.Subscript):
            t = t.value
        attr = _self_attr(t)
        if attr:
            out.append(attr)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                a = _self_attr(e)
                if a:
                    out.append(a)
    return out


@dataclasses.dataclass
class ClassModel:
    """Everything T001–T004 need to know about one class."""

    name: str
    node: ast.ClassDef
    mod: ModuleInfo
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    cond_attrs: Set[str] = dataclasses.field(default_factory=set)
    #: condition attr -> the lock attr it shares (Condition(self._lock)),
    #: or None for a Condition with its own internal lock.
    cond_underlying: Dict[str, Optional[str]] = dataclasses.field(
        default_factory=dict)
    sync_attrs: Set[str] = dataclasses.field(default_factory=set)
    attr_names: Set[str] = dataclasses.field(default_factory=set)
    guards: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    method_guards: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: attr -> [(method, lineno)] for writes outside __init__.
    writes: Dict[str, List[Tuple[str, int]]] = dataclasses.field(
        default_factory=dict)
    #: root method -> kind ("thread" | "timer" | "http" | "client").
    roots: Dict[str, str] = dataclasses.field(default_factory=dict)
    multi_roots: Set[str] = dataclasses.field(default_factory=set)
    spawns_threads: bool = False
    is_http_handler: bool = False
    self_calls: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    #: per-method T002/T003 walk products (filled by _walk_methods).
    direct_acquires: Dict[str, Set[str]] = dataclasses.field(
        default_factory=dict)
    blocking_ops: Dict[str, List[Tuple[int, str]]] = dataclasses.field(
        default_factory=dict)
    held_calls: Dict[str, List[Tuple[str, str, int]]] = dataclasses.field(
        default_factory=dict)
    edges: Set[Tuple[str, str, int]] = dataclasses.field(default_factory=set)
    held_findings: List[Finding] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------ queries
    @property
    def relevant(self) -> bool:
        return bool(self.lock_attrs or self.cond_attrs
                    or self.spawns_threads or self.is_http_handler)

    def canon_lock(self, attr: str) -> str:
        """Condition attrs collapse onto the lock they share."""
        if attr in self.cond_underlying:
            return self.cond_underlying[attr] or attr
        return attr

    def lock_expr_canon(self, expr) -> Optional[str]:
        """``with self.X`` context expr → canonical lock name, if X is a
        lock/condition attribute of this class."""
        attr = _self_attr(expr)
        if attr and (attr in self.lock_attrs or attr in self.cond_attrs):
            return self.canon_lock(attr)
        return None

    def acquires_closure(self, method: str,
                         _seen: Optional[Set[str]] = None) -> Set[str]:
        seen = _seen if _seen is not None else set()
        if method in seen:
            return set()
        seen.add(method)
        out = set(self.direct_acquires.get(method, ()))
        for callee in self.self_calls.get(method, ()):
            if callee in self.methods:
                out |= self.acquires_closure(callee, seen)
        return out

    def blocking_closure(self, method: str,
                         _seen: Optional[Set[str]] = None,
                         ) -> List[Tuple[int, str]]:
        seen = _seen if _seen is not None else set()
        if method in seen:
            return []
        seen.add(method)
        out = list(self.blocking_ops.get(method, ()))
        for callee in self.self_calls.get(method, ()):
            if callee in self.methods:
                out.extend(self.blocking_closure(callee, seen))
        return out

    def reachable_from(self, root: str) -> Set[str]:
        out: Set[str] = set()
        frontier = [root]
        while frontier:
            m = frontier.pop()
            if m in out or m not in self.methods:
                continue
            out.add(m)
            frontier.extend(self.self_calls.get(m, ()))
        return out


class _ClassScanner(ast.NodeVisitor):
    """First pass over one class body: attrs, guards, writes, spawns,
    self-calls. Descends into nested functions (closures run on behalf
    of the method that made them) but not into nested classes."""

    def __init__(self, model: ClassModel):
        self.m = model
        self.method: Optional[str] = None
        self.in_init = False
        self.loop_depth = 0

    # ------------------------------------------------------- structure
    def visit_ClassDef(self, node):  # noqa: N802 (ast visitor API)
        if node is self.m.node:
            self.generic_visit(node)
        # nested classes get their own ClassModel

    def visit_FunctionDef(self, node):  # noqa: N802
        if self.method is None:
            self.method = node.name
            self.in_init = node.name in ("__init__", "__new__",
                                         "__post_init__")
            self.m.methods[node.name] = node
            self.m.self_calls.setdefault(node.name, set())
            guard = _method_guard(self.m.mod, node)
            if guard:
                self.m.method_guards[node.name] = guard
            self.generic_visit(node)
            self.method = None
            self.in_init = False
        else:
            self.generic_visit(node)  # nested def: same method context

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_While(self, node):  # noqa: N802
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = visit_While

    # ----------------------------------------------------- assignments
    def _record_assign(self, node, value):
        for attr in _write_targets(node):
            self.m.attr_names.add(attr)
            self._record_guard_comment(attr, node)
            if self.in_init or self.method is None:
                self._classify_ctor(attr, value)
            else:
                self.m.writes.setdefault(attr, []).append(
                    (self.method or "<class>", node.lineno))

    def visit_Assign(self, node):  # noqa: N802
        self._record_assign(node, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):  # noqa: N802
        self._record_assign(node, node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node):  # noqa: N802
        self._record_assign(node, None)
        self.generic_visit(node)

    def _record_guard_comment(self, attr: str, node) -> None:
        for ln in {node.lineno, getattr(node, "end_lineno", node.lineno)}:
            if 0 < ln <= len(self.m.mod.lines):
                match = _GUARD_RE.search(self.m.mod.lines[ln - 1])
                if match:
                    self.m.guards.setdefault(attr, set()).add(match.group(1))

    def _classify_ctor(self, attr: str, value) -> None:
        if not isinstance(value, ast.Call):
            return
        dotted = self.m.mod.resolve(value.func)
        if dotted in _COND_CTORS:
            self.m.cond_attrs.add(attr)
            underlying = _self_attr(value.args[0]) if value.args else None
            self.m.cond_underlying[attr] = underlying
            self.m.sync_attrs.add(attr)
        elif dotted in _LOCK_CTORS:
            self.m.lock_attrs.add(attr)
            self.m.sync_attrs.add(attr)
        elif dotted in _SYNC_CTORS:
            self.m.sync_attrs.add(attr)

    # ----------------------------------------------------------- calls
    def visit_Call(self, node):  # noqa: N802
        dotted = self.m.mod.resolve(node.func)
        if dotted in ("threading.Thread", "threading.Timer"):
            self.m.spawns_threads = True
            target = None
            for kw in node.keywords:
                if kw.arg in ("target", "function"):
                    target = kw.value
            if (target is None and dotted == "threading.Timer"
                    and len(node.args) >= 2):
                target = node.args[1]
            attr = _self_attr(target) if target is not None else None
            if attr:
                kind = "timer" if dotted == "threading.Timer" else "thread"
                self.m.roots[attr] = kind
                if self.loop_depth > 0:
                    self.m.multi_roots.add(attr)
        # self.m2(...) feeds the per-class call graph
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
                and self.method is not None):
            self.m.self_calls.setdefault(self.method, set()).add(
                node.func.attr)
        # mutator calls on self.X count as writes to X
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS):
            attr = _self_attr(node.func.value)
            if attr and not self.in_init and self.method is not None:
                self.m.attr_names.add(attr)
                self.m.writes.setdefault(attr, []).append(
                    (self.method, node.lineno))
        self.generic_visit(node)


def _method_guard(mod: ModuleInfo, node) -> Optional[str]:
    """``@guarded_by("_lock")`` decorator → "_lock"."""
    for dec in node.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        dotted = mod.dotted(dec.func) or ""
        if dotted.split(".")[-1] == "guarded_by" and dec.args:
            arg = dec.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                return arg.value
    return None


class _HoldWalker(ast.NodeVisitor):
    """Second pass over one method: tracks the lexical stack of held
    locks through ``with`` statements, recording acquires-while-holding
    edges (T002), blocking-while-locked sites (T003), and the method's
    blocking summary for interprocedural propagation."""

    def __init__(self, model: ClassModel, method: str):
        self.m = model
        self.method = method
        self.held: List[Tuple[str, int]] = []
        guard = model.method_guards.get(method)
        if guard and guard != "atomic":
            self.held.append((model.canon_lock(guard), model.node.lineno))

    # ------------------------------------------------------------ with
    def visit_With(self, node):  # noqa: N802
        acquired: List[str] = []
        for item in node.items:
            self.visit(item.context_expr)  # evaluated before acquisition
            canon = self.m.lock_expr_canon(item.context_expr)
            if canon is not None:
                self.m.direct_acquires.setdefault(self.method, set()).add(
                    canon)
                for held, _ in self.held:
                    self.m.edges.add((held, canon, node.lineno))
                acquired.append(canon)
            elif self.held:
                self._maybe_foreign_lock(item.context_expr, node.lineno)
        self.held.extend((c, node.lineno) for c in acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]

    visit_AsyncWith = visit_With

    def _maybe_foreign_lock(self, expr, lineno: int) -> None:
        name = None
        if isinstance(expr, ast.Name):
            name = expr.id
        elif isinstance(expr, ast.Attribute):
            name = expr.attr
        if name and _FOREIGN_LOCK_RE.search(name):
            self._t003(lineno,
                       f"acquires un-analyzable lock '{name}' while "
                       f"holding {self._held_desc()}")

    # ----------------------------------------------------------- calls
    def visit_Call(self, node):  # noqa: N802
        desc = self._blocking_desc(node)
        if desc is not None:
            self.m.blocking_ops.setdefault(self.method, []).append(
                (node.lineno, desc))
            if self.held:
                self._t003(node.lineno,
                           f"{desc} while holding {self._held_desc()}")
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
                and node.func.attr in self.m.methods
                and self.held):
            for held, _ in self.held:
                self.m.held_calls.setdefault(self.method, []).append(
                    (held, node.func.attr, node.lineno))
        self.generic_visit(node)

    def _blocking_desc(self, node) -> Optional[str]:
        dotted = self.m.mod.resolve(node.func)
        if dotted == "time.sleep":
            return "time.sleep()"
        if not isinstance(node.func, ast.Attribute):
            return None
        meth = node.func.attr
        nonblocking = any(kw.arg in ("timeout", "block", "blocking")
                          for kw in node.keywords)
        recv_attr = _self_attr(node.func.value)
        if meth in _BLOCKING_ALWAYS:
            return f"blocking .{meth}() call"
        if meth not in _BLOCKING_NOARG or node.args or nonblocking:
            return None
        if meth == "wait":
            # Condition.wait on our own condition releases the held
            # lock — that is T004's subject, not a T003 block.
            if recv_attr in self.m.cond_attrs:
                return None
            return "untimed .wait() call"
        if meth == "acquire" and recv_attr is not None:
            held_names = {h for h, _ in self.held}
            if self.m.canon_lock(recv_attr) in held_names:
                return None  # re-acquire shows up as a T002 self-loop
        return f"untimed .{meth}() call"

    def _t003(self, lineno: int, message: str) -> None:
        if self.m.mod.suppressed(lineno, "T003"):
            return
        self.m.held_findings.append(Finding(
            rule="T003", file=self.m.mod.relfile,
            qualname=f"{self.m.name}.{self.method}", line=lineno,
            message=message))

    def _held_desc(self) -> str:
        return ", ".join(sorted({f"self.{h}" for h, _ in self.held}))

    # nested defs/classes run later, outside the held region
    def visit_FunctionDef(self, node):  # noqa: N802
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def build_class_models(mod: ModuleInfo) -> List[ClassModel]:
    """All concurrency-visible classes of one module, fully scanned (once a
    module: the four rules share them)."""
    if "class_models" in mod.derived:
        return mod.derived["class_models"]
    models = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        model = ClassModel(name=node.name, node=node, mod=mod)
        for base in node.bases:
            base_name = (mod.dotted(base) or "").split(".")[-1]
            if base_name in _HTTP_HANDLER_BASES:
                model.is_http_handler = True
        _ClassScanner(model).visit(node)
        if not model.relevant:
            continue
        _finish_roots(model)
        for name, fn in model.methods.items():
            walker = _HoldWalker(model, name)
            for stmt in fn.body:
                walker.visit(stmt)
        models.append(model)
    mod.derived["class_models"] = models
    return models


def _finish_roots(model: ClassModel) -> None:
    if model.is_http_handler:
        for name in model.methods:
            if name.startswith("do_"):
                model.roots[name] = "http"
                model.multi_roots.add(name)
    for name in model.methods:
        if name.startswith("_") and not (name.startswith("__")
                                         and name.endswith("__")):
            continue
        if name in ("__init__", "__new__", "__post_init__"):
            continue
        if name in model.roots:
            # a PUBLIC thread/timer target also has client callers: the
            # spawned thread plus any caller makes it multi-instance
            model.multi_roots.add(name)
            continue
        model.roots[name] = "client"
    # the object may be driven from any number of caller threads: every
    # client-facing root is multi-instance by contract
    for name, kind in model.roots.items():
        if kind in ("client", "http"):
            model.multi_roots.add(name)


# ------------------------------------------------------------------ rules


def _t001_class(model: ClassModel) -> List[Finding]:
    out: List[Finding] = []
    # method reachability per root, computed once
    reach = {root: model.reachable_from(root) for root in model.roots}
    for attr, sites in sorted(model.writes.items()):
        if attr in model.sync_attrs:
            continue
        sites = [s for s in sites
                 if not model.mod.suppressed(s[1], "T001")]
        if not sites:
            continue
        writing_methods = {m for m, _ in sites}
        declared = set(model.guards.get(attr, ()))
        for m in writing_methods:
            g = model.method_guards.get(m)
            if g:
                declared.add(g)
        if declared:
            bogus = {g for g in declared
                     if g != "atomic" and g not in model.attr_names}
            if bogus:
                out.append(Finding(
                    rule="T001", file=model.mod.relfile,
                    qualname=f"{model.name}.{attr}", line=sites[0][1],
                    message=(f"guarded_by names "
                             f"{', '.join(sorted(repr(b) for b in bogus))} "
                             f"but no such attribute exists on "
                             f"{model.name}")))
            continue
        writing_roots = {root for root, methods in reach.items()
                         if methods & writing_methods}
        hazard = (len(writing_roots) >= 2
                  or bool(writing_roots & model.multi_roots))
        if not hazard:
            continue
        roots_desc = ", ".join(
            f"{r} ({model.roots[r]})" for r in sorted(writing_roots))
        out.append(Finding(
            rule="T001", file=model.mod.relfile,
            qualname=f"{model.name}.{attr}", line=sites[0][1],
            message=(f"shared attribute written from thread entry "
                     f"point(s) {roots_desc} without a guarded_by "
                     f"declaration or synchronized type")))
    return out


def rule_unguarded_shared_state(mod: ModuleInfo) -> List[Finding]:
    """T001 over one module."""
    out: List[Finding] = []
    for model in build_class_models(mod):
        out.extend(_t001_class(model))
    return out


def _interprocedural_edges(model: ClassModel) -> None:
    """Edges through ``self.m()`` calls made while holding a lock."""
    for method, calls in model.held_calls.items():
        for held, callee, lineno in calls:
            for lock in model.acquires_closure(callee):
                model.edges.add((held, lock, lineno))


def _global_lock_graph(models: Sequence[ClassModel],
                       ) -> Dict[str, Set[Tuple[str, int, str]]]:
    """node "Class.lock" -> {(dst_node, lineno, relfile)}."""
    graph: Dict[str, Set[Tuple[str, int, str]]] = {}
    for model in models:
        _interprocedural_edges(model)
        for attr in sorted(model.lock_attrs
                           | {model.canon_lock(c)
                              for c in model.cond_attrs}):
            graph.setdefault(f"{model.name}.{attr}", set())
        for src, dst, lineno in model.edges:
            graph.setdefault(f"{model.name}.{src}", set()).add(
                (f"{model.name}.{dst}", lineno, model.mod.relfile))
            graph.setdefault(f"{model.name}.{dst}", set())
    return graph


def _find_cycles(graph: Dict[str, Set[Tuple[str, int, str]]],
                 ) -> List[List[str]]:
    """Elementary cycles via per-node DFS (graphs here are tiny)."""
    cycles: List[List[str]] = []
    seen_keys: Set[Tuple[str, ...]] = set()
    adj = {n: sorted({d for d, _, _ in dsts})
           for n, dsts in graph.items()}
    for start in sorted(adj):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt == start:
                    key = tuple(sorted(path))
                    if key not in seen_keys:
                        seen_keys.add(key)
                        cycles.append(path[:])
                elif nxt not in path and nxt > start:
                    stack.append((nxt, [*path, nxt]))
    return cycles


def rule_lock_order(mod: ModuleInfo) -> List[Finding]:
    """T002 over one module's classes."""
    models = build_class_models(mod)
    graph = _global_lock_graph(models)
    out: List[Finding] = []
    for cycle in _find_cycles(graph):
        lineno = 0
        for node in cycle:
            for dst, ln, _rel in graph.get(node, ()):
                if dst in cycle:
                    lineno = lineno or ln
        out.append(Finding(
            rule="T002", file=mod.relfile,
            qualname="cycle:" + "->".join(sorted(cycle)), line=lineno,
            message=("lock-order cycle (deadlock hazard): "
                     + " -> ".join([*cycle, cycle[0]])
                     + "; pick one acquisition order or merge the locks")))
    return out


def rule_blocking_while_locked(mod: ModuleInfo) -> List[Finding]:
    """T003 over one module: direct sites plus self-calls that reach a
    blocking operation while a lock is held."""
    out: List[Finding] = []
    for model in build_class_models(mod):
        out.extend(model.held_findings)
        for method, calls in model.held_calls.items():
            for held, callee, lineno in calls:
                if mod.suppressed(lineno, "T003"):
                    continue
                blocked = model.blocking_closure(callee)
                if blocked:
                    _, desc = blocked[0]
                    out.append(Finding(
                        rule="T003", file=mod.relfile,
                        qualname=f"{model.name}.{method}", line=lineno,
                        message=(f"calls self.{callee}() which reaches "
                                 f"{desc} while holding self.{held}")))
    return out


def rule_condition_wait_loop(mod: ModuleInfo) -> List[Finding]:
    """T004 over one module: ``cond.wait`` must sit under a ``while``."""
    out: List[Finding] = []
    for model in build_class_models(mod):
        for name, fn in model.methods.items():
            parents: Dict[ast.AST, ast.AST] = {}
            for parent in ast.walk(fn):
                for child in ast.iter_child_nodes(parent):
                    parents[child] = parent
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "wait"):
                    continue
                attr = _self_attr(node.func.value)
                if attr not in model.cond_attrs:
                    continue
                if mod.suppressed(node.lineno, "T004"):
                    continue
                cur = parents.get(node)
                in_while = False
                while cur is not None and not isinstance(
                        cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if isinstance(cur, ast.While):
                        in_while = True
                        break
                    cur = parents.get(cur)
                if not in_while:
                    out.append(Finding(
                        rule="T004", file=mod.relfile,
                        qualname=f"{model.name}.{name}", line=node.lineno,
                        message=(f"self.{attr}.wait() outside a predicate "
                                 f"'while' loop — spurious wakeups and "
                                 f"stolen predicates require re-checking "
                                 f"the condition in a loop")))
    return out


THREAD_RULES = (rule_unguarded_shared_state, rule_lock_order,
                rule_blocking_while_locked, rule_condition_wait_loop)


# ------------------------------------------------------------ entrypoints


def run_threads(root: str,
                dirs: Iterable[str] = THREAD_SCAN_DIRS) -> List[Finding]:
    """Run T001–T004 over the tree at ``root`` (default: raft_tpu_torch
    only; tests/tools spawn intentionally racy throwaway threads)."""
    from raft_tpu_torch.analysis import collect_modules
    modules, findings = collect_modules(root, dirs)
    for mod in modules:
        for rule in THREAD_RULES:
            findings.extend(rule(mod))
    seen = set()
    unique = []
    for f in findings:
        ident = (f.key, f.line, f.message)
        if ident not in seen:
            seen.add(ident)
            unique.append(f)
    unique.sort(key=lambda f: (f.file, f.line, f.rule))
    return unique


def _all_models(root: str,
                dirs: Iterable[str] = THREAD_SCAN_DIRS) -> List[ClassModel]:
    from raft_tpu_torch.analysis import collect_modules
    modules, _ = collect_modules(root, dirs)
    models: List[ClassModel] = []
    for mod in modules:
        models.extend(build_class_models(mod))
    return models


def lock_order_dot(root: str,
                   dirs: Iterable[str] = THREAD_SCAN_DIRS) -> str:
    """The acquires-while-holding graph as Graphviz DOT. Nodes are
    ``Class.lock_attr``; edges mean "acquired while holding"; edges on
    a cycle render red. An edge-free graph documents the leaf-lock
    discipline: no code path holds two analyzer-visible locks at once."""
    models = _all_models(root, dirs)
    graph = _global_lock_graph(models)
    cyclic_nodes: Set[str] = set()
    for cycle in _find_cycles(graph):
        cyclic_nodes.update(cycle)
    out = ["digraph lock_order {",
           '  rankdir=LR; node [shape=box, fontname="monospace"];']
    for node in sorted(graph):
        color = ', color=red' if node in cyclic_nodes else ""
        out.append(f'  "{node}" [label="{node}"{color}];')
    for src in sorted(graph):
        for dst, lineno, relfile in sorted(graph[src]):
            red = (" color=red," if src in cyclic_nodes
                   and dst in cyclic_nodes else "")
            out.append(f'  "{src}" -> "{dst}" '
                       f'[{red} label="{relfile}:{lineno}"];')
    out.append("}")
    return "\n".join(out) + "\n"


def thread_model_summary(root: str,
                         dirs: Iterable[str] = THREAD_SCAN_DIRS,
                         ) -> List[str]:
    """Human-readable derived thread model, one line per class — what
    ``--threads`` discovered, for the CLI report."""
    lines = []
    for model in _all_models(root, dirs):
        roots = ", ".join(
            f"{name}[{kind}{'*' if name in model.multi_roots else ''}]"
            for name, kind in sorted(model.roots.items()))
        locks = ", ".join(sorted(model.lock_attrs)) or "-"
        lines.append(f"{model.mod.relfile}: {model.name} "
                     f"locks({locks}) roots({roots})")
    return lines
