"""Tier F — typed-failure & resource-lifecycle flow analysis (F001–F005).

The serving fabric rests on invariants that, before this tier, existed
only as convention plus chaos tests:

- every failure crossing an API boundary is **typed** (an exported
  exception class classified by ``isinstance``, never a string match);
- every Request/Future a function takes ownership of is **settled
  exactly once** or visibly handed off on every path, exception edges
  included;
- every exception caught is **accounted** (re-raised, settled into a
  future, or recorded to a metric/span/log) — "shed typed, never
  silently";
- every thread/timer/server/socket stored on ``self`` is **reclaimed**
  from the class's ``stop``/``close``/``__exit__``;
- every blocking wait in request-path code carries a **budget** derived
  from the rider's deadline or config, never bare or a bald literal.

Like Tier A (:mod:`.rules_ast`) and Tier T (:mod:`.concurrency`) this is
pure ``ast`` — the scanned code is never imported. This is the port's copy
of ``raft_tpu.analysis.flow``; the package scanned is a parameter
(``raft_tpu_torch`` by default), so ``run_flow(root, package="raft_tpu")``
gives raft_tpu's findings. The scan scope is the request path:
``<package>/serving``, ``<package>/obs``, ``<package>/parallel/host_p2p.py``
and ``<package>/neighbors/mutable.py`` (:func:`flow_scan_paths`).

Rules:

- **F001 untyped raise** — every ``raise`` constructing a class must
  resolve, through an AST class-hierarchy index climbed across the
  scanned modules, to the typed hierarchy exported by
  ``<package>/serving/__init__.py`` (``__all__``), or be one of the
  programmer-error whitelist (``TypeError``/``ValueError``/
  ``AssertionError`` — argument validation only). Re-raises of caught
  values and dynamic raises (``raise self._error``) are skipped.
  Classifying a failure by matching ``str(e)`` text inside a handler is
  its own F001 finding: types are the contract, messages are for humans.
- **F002 future settle discipline** — a function that owns a
  Request/Future (calls ``set_result``/``set_exception``/``_finish``/
  ``settle`` on it, creates it via ``Future()``, or receives it from
  ``submit``) must settle it or visibly hand it off (pass to a call,
  store into shared state, return it, await it) on every path of the
  statement-level CFG, exception edges included. Two unconditional
  settles with no once-guard (``itertools.count`` + ``next``,
  ``set_running_or_notify_cancel``, ``InvalidStateError`` absorption)
  are flagged too.
- **F003 swallowed exception** — an ``except`` body that neither
  re-raises, settles a future, records to a metric/span/logger,
  captures the failure into state, nor passes the bound exception on.
- **F004 resource lifecycle** — each Thread/Timer/MetricsServer/
  HTTP server/socket/file stored on ``self`` must have a
  ``join``/``cancel``/``close``/``shutdown`` reachable from the class's
  reclaim roots (``stop``/``close``/``shutdown``/``__exit__``/
  ``__del__``) through the per-class self-call graph. Alias swaps
  (``t, self._t = self._t, None`` then ``t.join()``) and container
  iteration (``for s in self._socks: s.close()``) count.
- **F005 unbudgeted blocking call** — ``result()``/``get()``/``wait()``/
  ``join()``/``acquire()`` in request-path code must pass a timeout
  derived from ``remaining_ms``/deadline/config — an expression, not
  bare and not a numeric literal. Lifecycle methods and methods
  reachable from a class's own thread/timer roots (background loops,
  per the Tier T derived model) are excluded.

The CFG model (F002) is an intraprocedural abstract interpretation over
the statement AST: per-path state in {UNSET, SETTLED}; ``if`` joins by
union, loops run their body once and union with the skip path (a loop
body that settles its loop variable settles the iterated target —
vacuously true for empty collections, like the code itself), ``try``
handlers enter from the union of every prefix state of the try body
(the exception edge), an ``except InvalidStateError`` handler enters
SETTLED (the only way ``set_*`` raises it is that the future already
was). ``raise`` is an acceptable exit — ownership reverts to the
caller with the exception. Known limit: implicit raises from unguarded
calls are not modeled; only statements inside a ``try`` contribute
exception edges.

Suppression and baselines are shared with every other tier: inline
``# graftcheck: F00X`` on the flagged line, or a justified entry in
``raft_tpu_torch/analysis/baseline.json``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from raft_tpu_torch.analysis.astutils import ModuleInfo
from raft_tpu_torch.analysis.concurrency import build_class_models
from raft_tpu_torch.analysis.findings import Finding
from raft_tpu_torch.analysis.rules_ast import PACKAGE, _enclosing_qualname

__all__ = [
    "FLOW_SCAN_DIRS", "FLOW_SCAN_FILES", "FLOW_RULES", "FlowContext",
    "flow_scan_paths",
    "rule_untyped_raise", "rule_settle_discipline",
    "rule_swallowed_exception", "rule_resource_lifecycle",
    "rule_unbudgeted_blocking", "run_flow", "flow_stats",
]

#: request-path packages scanned by Tier F, under the package's directory.
FLOW_SCAN_DIRS = ("serving", "obs")
#: single request-path modules outside those packages.
FLOW_SCAN_FILES = ("parallel/host_p2p.py", "neighbors/mutable.py")


def flow_scan_paths(package: str = PACKAGE) -> tuple:
    """(directories, files) Tier F scans for ``package``, relative to the
    scan root."""
    return (tuple(f"{package}/{d}" for d in FLOW_SCAN_DIRS),
            tuple(f"{package}/{f}" for f in FLOW_SCAN_FILES))

#: F001 whitelist: programmer errors on argument validation only.
PROGRAMMER_ERRORS = frozenset({"TypeError", "ValueError", "AssertionError"})

#: builtin exception names recognized as class raises (anything else
#: lowercase is assumed a dynamic re-raise and skipped).
_BUILTIN_EXCS = frozenset({
    "BaseException", "Exception", "ArithmeticError", "AssertionError",
    "AttributeError", "BlockingIOError", "BrokenPipeError", "BufferError",
    "ConnectionAbortedError", "ConnectionError", "ConnectionRefusedError",
    "ConnectionResetError", "EOFError", "FileExistsError",
    "FileNotFoundError", "IOError", "ImportError", "IndexError",
    "InterruptedError", "KeyError", "KeyboardInterrupt", "LookupError",
    "MemoryError", "NameError", "NotImplementedError", "OSError",
    "OverflowError", "PermissionError", "RecursionError", "RuntimeError",
    "StopIteration", "SystemExit", "TimeoutError", "TypeError",
    "ValueError", "ZeroDivisionError",
})

#: attribute calls that settle a Request/Future.
SETTLE_ATTRS = frozenset({"set_result", "set_exception", "_finish",
                          "settle"})
#: attribute calls that consume/await one (discharges ownership).
WAIT_ATTRS = frozenset({"result", "wait", "get", "exception", "cancel",
                        "done", "add_done_callback"})
#: attribute calls whose return value is an owned future.
SUBMIT_ATTRS = frozenset({"submit"})

#: except-body calls that count as recording the failure (F003).
RECORD_ATTRS = frozenset({
    "inc", "observe", "set", "record", "record_event", "emit", "log",
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "put", "put_nowait", "append", "offer", "set_exception",
    "set_result", "_finish", "settle",
})
#: resolved-callee name fragments that also count as recording.
_RECORD_NAME_PARTS = ("log", "record", "emit", "warn")

#: constructors whose results stored on ``self`` must be reclaimed
#: (resolved last segment -> human kind for the message).
RESOURCE_CTORS = {
    "Thread": "thread", "Timer": "timer", "MetricsServer": "http server",
    "ThreadingHTTPServer": "http server", "HTTPServer": "http server",
    "socket": "socket", "create_connection": "socket",
    "create_server": "socket", "open": "file", "Popen": "process",
}
#: attribute calls that reclaim a resource.
RECLAIM_ATTRS = frozenset({"join", "cancel", "close", "shutdown",
                           "server_close", "stop", "terminate", "release",
                           "kill", "detach"})
#: methods from which a reclaim must be reachable.
RECLAIM_ROOTS = ("stop", "close", "shutdown", "terminate", "__exit__",
                 "__del__")

#: blocking primitives that must carry a budget in request-path code.
BLOCKING_ATTRS = frozenset({"result", "get", "wait", "join", "acquire"})
#: methods excluded from F005: lifecycle edges block deliberately
#: (drain on stop, join on close) and are never on a rider's path.
LIFECYCLE_METHODS = frozenset({
    "__init__", "__enter__", "__exit__", "__del__", "start", "stop",
    "close", "shutdown", "drain", "terminate",
})


# --------------------------------------------------------------- helpers


def _shallow(node) -> Iterable[ast.AST]:
    """``ast.walk`` that does not descend into nested function/class
    definitions (they are analyzed as their own entries)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


def _root_name(node) -> Optional[str]:
    """Receiver-chain root: ``req.fut.set_result`` -> "req"."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _contains_name(node, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _unwrap_iter(node):
    """Peel ``enumerate``/``sorted``/``list``/``reversed``/``tuple``
    wrappers off a for-loop iterable."""
    while (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
           and node.func.id in ("enumerate", "sorted", "list", "reversed",
                                "tuple") and node.args):
        node = node.args[0]
    return node


def _loop_var_names(target) -> Set[str]:
    """Names bound by a for-loop target (handles ``for j, r in ...``)."""
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _module_all(tree: ast.AST) -> Set[str]:
    """Names in a module's ``__all__`` list/tuple of string constants."""
    out: Set[str] = set()
    for node in ast.iter_child_nodes(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "__all__"
                   for t in node.targets):
            continue
        if isinstance(node.value, (ast.List, ast.Tuple)):
            for e in node.value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out.add(e.value)
    return out


# ---------------------------------------------------------- flow context


class FlowContext:
    """Cross-module state shared by the F rules: the class-hierarchy
    index (class name -> base-class last segments, merged over every
    scanned module) and the typed-export set F001 certifies against."""

    def __init__(self, modules: Iterable[ModuleInfo],
                 typed_exports: Optional[Set[str]] = None):
        self.class_bases: Dict[str, Set[str]] = {}
        own_exports: Set[str] = set()
        for mod in modules:
            own_exports |= _module_all(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                bases = self.class_bases.setdefault(node.name, set())
                for b in node.bases:
                    dotted = mod.resolve(b)
                    if dotted:
                        bases.add(dotted.rsplit(".", 1)[-1])
        #: fall back to the scanned modules' own ``__all__`` so a
        #: standalone fixture module declares its typed hierarchy the
        #: same way serving/__init__.py does.
        self.typed_exports = (set(typed_exports)
                              if typed_exports is not None else own_exports)

    def is_typed(self, name: str) -> bool:
        """Does ``name`` (or any transitive base) reach a typed export?"""
        seen: Set[str] = set()
        frontier = [name]
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.add(n)
            if n in self.typed_exports:
                return True
            frontier.extend(self.class_bases.get(n, ()))
        return False


def _serving_exports(root: str, package: str = PACKAGE
                     ) -> Optional[Set[str]]:
    """``__all__`` of <root>/<package>/serving/__init__.py, the typed
    hierarchy F001 certifies against (plus the RaftError base)."""
    path = os.path.join(root, package, "serving", "__init__.py")
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
    except SyntaxError:
        return None
    names = _module_all(tree)
    return (names | {"RaftError"}) if names else None


# ------------------------------------------------------------------ F001


def _raise_sites(mod: ModuleInfo) -> List[ast.Raise]:
    return [n for n in ast.walk(mod.tree) if isinstance(n, ast.Raise)]


def _handler_bound_names(mod: ModuleInfo) -> Set[str]:
    return {n.name for n in ast.walk(mod.tree)
            if isinstance(n, ast.ExceptHandler) and n.name}


def rule_untyped_raise(mod: ModuleInfo,
                       ctx: Optional[FlowContext] = None) -> List[Finding]:
    """F001: every constructed raise resolves to the typed hierarchy or
    the programmer-error whitelist; str(e) matching is flagged too."""
    ctx = ctx if ctx is not None else FlowContext([mod])
    out: List[Finding] = []
    caught = _handler_bound_names(mod)
    for node in _raise_sites(mod):
        if node.exc is None:
            continue  # bare re-raise inside a handler
        candidates = ([node.exc.body, node.exc.orelse]
                      if isinstance(node.exc, ast.IfExp) else [node.exc])
        for cand in candidates:
            cls_expr = cand.func if isinstance(cand, ast.Call) else cand
            dotted = mod.resolve(cls_expr)
            if dotted is None:
                continue  # dynamic (computed expression)
            last = dotted.rsplit(".", 1)[-1]
            if isinstance(cand, ast.Name) and cand.id in caught:
                continue  # re-raise of a caught value
            class_like = (last in ctx.class_bases or last in _BUILTIN_EXCS
                          or last in ctx.typed_exports
                          or (last[:1].isupper() and isinstance(cand,
                                                                ast.Call)))
            if not class_like:
                continue  # dynamic re-raise of a stored exception
            if ctx.is_typed(last) or last in PROGRAMMER_ERRORS:
                continue
            if mod.suppressed(node.lineno, "F001"):
                continue
            out.append(Finding(
                "F001", mod.relfile, _enclosing_qualname(mod, node),
                node.lineno,
                f"raise {last}: not in the typed serving failure "
                "hierarchy (serving/__init__.__all__) or the "
                "TypeError/ValueError/AssertionError validation "
                "whitelist — callers classify failures by isinstance, "
                "so an untyped raise is unclassifiable"))
    # str(e) text matching inside handlers: its own F001 finding
    for handler in ast.walk(mod.tree):
        if not isinstance(handler, ast.ExceptHandler) or not handler.name:
            continue
        for cmp_node in ast.walk(handler):
            if not isinstance(cmp_node, ast.Compare):
                continue
            exprs = [cmp_node.left, *cmp_node.comparators]
            hit = any(
                isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                and c.func.id == "str" and c.args
                and _contains_name(c.args[0], handler.name)
                for e in exprs for c in ast.walk(e))
            if not hit or mod.suppressed(cmp_node.lineno, "F001"):
                continue
            out.append(Finding(
                "F001", mod.relfile, _enclosing_qualname(mod, cmp_node),
                cmp_node.lineno,
                f"classifies the caught failure by matching "
                f"str({handler.name}) text — messages are for humans; "
                "classify by isinstance on the typed hierarchy"))
    return out


# ------------------------------------------------------------------ F002


def _has_once_guard(fn_node) -> bool:
    """Settle-once idioms that make a double settle deliberate."""
    for n in _shallow(fn_node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "next" and n.args):
            src = ast.dump(n.args[0]).lower()
            if "once" in src:
                return True
        if isinstance(n, ast.Attribute) \
                and n.attr == "set_running_or_notify_cancel":
            return True
        if isinstance(n, ast.Call) and _contains_invalid_state(n):
            return True
        if isinstance(n, ast.ExceptHandler) and n.type is not None \
                and _mentions_invalid_state(n.type):
            return True
    return False


def _mentions_invalid_state(node) -> bool:
    return any(isinstance(n, (ast.Name, ast.Attribute))
               and (getattr(n, "id", None) == "InvalidStateError"
                    or getattr(n, "attr", None) == "InvalidStateError")
               for n in ast.walk(node))


def _only_invalid_state(exc_type: ast.AST) -> bool:
    """True when an ``except`` clause catches InvalidStateError and
    nothing else (``except (X, InvalidStateError)`` stays accountable
    for X)."""
    elts = exc_type.elts if isinstance(exc_type, ast.Tuple) else [exc_type]
    names = [e.attr if isinstance(e, ast.Attribute)
             else getattr(e, "id", "") for e in elts]
    return bool(names) and all(n == "InvalidStateError" for n in names)


def _contains_invalid_state(call: ast.Call) -> bool:
    """``contextlib.suppress(InvalidStateError)``-shaped call."""
    func = call.func
    name = (func.attr if isinstance(func, ast.Attribute)
            else getattr(func, "id", ""))
    return name == "suppress" and any(
        _mentions_invalid_state(a) for a in call.args)


def _settle_targets(mod: ModuleInfo, info) -> Dict[str, str]:
    """Owned names in one function: params the function settles, locals
    from ``submit``/``Future()``, settle-called aliases of param attrs.
    -> {name: "param" | "local"} — locals only become owned at their
    creating assignment (the walker starts them VOID, not UNSET)."""
    node = info.node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return {}
    params = {p for p in info.params if p not in ("self", "cls")}
    submit_locals: Dict[str, int] = {}
    param_aliases: Dict[str, int] = {}
    loop_map: Dict[str, str] = {}
    for n in _shallow(node):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            tgt, val = n.targets[0].id, n.value
            calls = [c for c in ast.walk(val) if isinstance(c, ast.Call)]
            for c in calls:
                attr = (c.func.attr if isinstance(c.func, ast.Attribute)
                        else None)
                dotted = mod.resolve(c.func) or ""
                if attr in SUBMIT_ATTRS \
                        or dotted.rsplit(".", 1)[-1] == "Future":
                    submit_locals[tgt] = n.lineno
            if isinstance(val, ast.Attribute) \
                    and _root_name(val) in params:
                param_aliases[tgt] = n.lineno
        elif isinstance(n, ast.For):
            it_root = _root_name(_unwrap_iter(n.iter))
            if it_root:
                for v in _loop_var_names(n.target):
                    loop_map[v] = it_root
    targets: Dict[str, str] = {}
    for n in _shallow(node):
        if not (isinstance(n, ast.Call) and isinstance(n.func,
                                                       ast.Attribute)
                and n.func.attr in SETTLE_ATTRS):
            continue
        root = _root_name(n.func.value)
        if root is None:
            continue
        root = loop_map.get(root, root)
        if root in params:
            targets.setdefault(root, "param")
        elif root in submit_locals or root in param_aliases:
            targets.setdefault(root, "local")
    for name in submit_locals:
        targets.setdefault(name, "local")  # a dropped future is the bug
    return targets


#: per-path states: VOID (local target not created yet on this path),
#: UNSET (owned, not settled), SETTLED (settled or visibly handed off).
_VOID, _UNSET, _SETTLED = "n", "u", "s"


class _SettleWalker:
    """Path-sensitive abstract interpreter for one (function, target):
    the F002 CFG model described in the module docstring."""

    def __init__(self, mod: ModuleInfo, info, target: str,
                 origin: str = "param"):
        self.mod = mod
        self.info = info
        self.target = target
        self.origin = origin
        self.once_guard = _has_once_guard(info.node)
        self.findings: List[Tuple[int, str]] = []  # (lineno, kind)

    def analyze(self) -> List[Tuple[int, str]]:
        init = _UNSET if self.origin == "param" else _VOID
        out = self._exec(self.info.node.body, frozenset({init}))
        if _UNSET in out:
            last = self.info.node.body[-1]
            self.findings.append(
                (getattr(last, "end_lineno", last.lineno), "unsettled"))
        return self.findings

    # ------------------------------------------------------- event scan
    def _events(self, expr, target: Optional[str] = None) -> List[str]:
        """Ordered-ish event list ("settle"/"discharge") for one
        expression tree. Nested defs/lambdas referencing the target are
        a discharge (the obligation escapes into the closure)."""
        target = target if target is not None else self.target
        events: List[str] = []

        def visit(n):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                if _contains_name(n, target):
                    events.append("discharge")
                return
            if isinstance(n, ast.Call):
                func = n.func
                if isinstance(func, ast.Attribute) \
                        and _root_name(func.value) == target:
                    if func.attr in SETTLE_ATTRS:
                        events.append("settle")
                    elif func.attr in WAIT_ATTRS:
                        events.append("discharge")
                for arg in list(n.args) + [kw.value for kw in n.keywords]:
                    root = _root_name(arg) if not isinstance(
                        arg, ast.Starred) else _root_name(arg.value)
                    if root == target:
                        events.append("discharge")
            if isinstance(n, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                              ast.DictComp)):
                for gen in n.generators:
                    if _root_name(_unwrap_iter(gen.iter)) == target:
                        for v in _loop_var_names(gen.target):
                            elts = ([n.key, n.value]
                                    if isinstance(n, ast.DictComp)
                                    else [n.elt])
                            for e in elts:
                                sub = self._events(e, target=v)
                                if "settle" in sub:
                                    events.append("settle")
                                elif "discharge" in sub:
                                    events.append("discharge")
            for child in ast.iter_child_nodes(n):
                visit(child)

        visit(expr)
        return events

    def _apply(self, events: List[str], states: frozenset,
               lineno: int) -> frozenset:
        for ev in events:
            if ev == "settle":
                if states == frozenset({_SETTLED}) and not self.once_guard:
                    self.findings.append((lineno, "double"))
                states = frozenset({_SETTLED})
            elif ev == "discharge":
                states = frozenset({_SETTLED})
        return states

    # ------------------------------------------------------- statements
    def _exec(self, stmts, states: frozenset) -> frozenset:
        for st in stmts:
            states = self._stmt(st, states)
            if not states:
                break  # every path through this statement exits
        return states

    def _exec_prefix(self, stmts, states: frozenset
                     ) -> Tuple[frozenset, frozenset]:
        """(fallthrough states, union of every PRE-statement state) —
        the latter feeds exception-edge handler entry: a statement that
        raises contributes the state it started from (an assignment
        whose RHS raises never binds)."""
        seen = frozenset()
        for st in stmts:
            seen |= states
            states = self._stmt(st, states)
            if not states:
                break
        return states, seen or states

    def _stmt(self, st, states: frozenset) -> frozenset:
        t = self.target
        if isinstance(st, ast.Return):
            if st.value is not None:
                states = self._apply(self._events(st.value), states,
                                     st.lineno)
                if _contains_name(st.value, t):
                    states = frozenset({_SETTLED})
            if _UNSET in states and not self.mod.suppressed(st.lineno,
                                                            "F002"):
                self.findings.append((st.lineno, "unsettled"))
            return frozenset()
        if isinstance(st, ast.Raise):
            if st.exc is not None:
                self._apply(self._events(st.exc), states, st.lineno)
            return frozenset()  # ownership reverts with the exception
        if isinstance(st, (ast.Break, ast.Continue)):
            return frozenset()
        if isinstance(st, ast.If):
            pre = self._apply(self._events(st.test), states, st.lineno)
            return (self._exec(st.body, pre)
                    | self._exec(st.orelse, pre))
        if isinstance(st, (ast.For, ast.AsyncFor)):
            pre = self._apply(self._events(st.iter), states, st.lineno)
            loop_vars = _loop_var_names(st.target)
            if _root_name(_unwrap_iter(st.iter)) == t:
                # settling/consuming each element settles the iterated
                # target (vacuously for empty collections)
                for v in loop_vars:
                    sub_events = [e for s in st.body
                                  for e in self._events(s, target=v)]
                    if "settle" in sub_events or "discharge" in sub_events:
                        self._exec(st.body, frozenset({_SETTLED}))
                        pre = frozenset({_SETTLED})
                        break
                else:
                    pre = pre | self._exec(st.body, pre)
            else:
                pre = pre | self._exec(st.body, pre)
            return pre | self._exec(st.orelse, pre)
        if isinstance(st, ast.While):
            pre = self._apply(self._events(st.test), states, st.lineno)
            out = pre | self._exec(st.body, pre)
            return out | self._exec(st.orelse, out)
        if isinstance(st, ast.Try):
            body_out, seen = self._exec_prefix(st.body, states)
            handler_outs: List[frozenset] = []
            for h in st.handlers:
                h_in = seen
                if h.type is not None and _mentions_invalid_state(h.type):
                    h_in = frozenset({_SETTLED})
                handler_outs.append(self._exec(h.body, h_in))
            out = body_out
            if st.orelse:
                out = self._exec(st.orelse, out) if out else out
            for h_out in handler_outs:
                out = out | h_out
            if st.finalbody:
                out = self._exec(st.finalbody, out or seen)
            return out
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                states = self._apply(self._events(item.context_expr),
                                     states, st.lineno)
            return self._exec(st.body, states)
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            if _contains_name(st, t):
                return frozenset({_SETTLED})  # escapes into the closure
            return states
        if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = st.value
            if value is not None:
                states = self._apply(self._events(value), states,
                                     st.lineno)
                targets = (st.targets if isinstance(st, ast.Assign)
                           else [st.target])
                if any(isinstance(tg, ast.Name) and tg.id == t
                       for tg in targets):
                    # binding the target name (re)starts the obligation
                    states = frozenset({_UNSET})
                stored = any(
                    isinstance(tg, (ast.Attribute, ast.Subscript))
                    or (isinstance(tg, (ast.Tuple, ast.List)) and any(
                        isinstance(e, (ast.Attribute, ast.Subscript))
                        for e in tg.elts))
                    for tg in targets)
                if stored and _contains_name(value, t):
                    states = frozenset({_SETTLED})
            return states
        # Expr / Assert / Delete / Global / Pass / import / Match ...
        events: List[str] = []
        for child in ast.iter_child_nodes(st):
            events.extend(self._events(child))
        return self._apply(events, states, st.lineno)


def rule_settle_discipline(mod: ModuleInfo,
                           ctx: Optional[FlowContext] = None
                           ) -> List[Finding]:
    """F002: owned futures settle or hand off on every path; double
    settles need a once-guard."""
    out: List[Finding] = []
    for qual, info in mod.functions.items():
        for target, origin in sorted(_settle_targets(mod, info).items()):
            walker = _SettleWalker(mod, info, target, origin)
            for lineno, kind in walker.analyze():
                if mod.suppressed(lineno, "F002"):
                    continue
                if kind == "double":
                    msg = (f"{target}: settled twice on an unconditional "
                           "path with no once-guard (itertools.count + "
                           "next, set_running_or_notify_cancel, or "
                           "InvalidStateError absorption)")
                else:
                    msg = (f"{target}: owned future/request may leave "
                           "this function unsettled on some path — "
                           "settle it, enqueue/return it, or hand it "
                           "to exactly one next driver on every exit")
                out.append(Finding("F002", mod.relfile, qual, lineno, msg))
    return out


def settle_owner_count(mod: ModuleInfo) -> int:
    """(function, owned target) pairs F002 analyzed — non-vacuity."""
    return sum(len(_settle_targets(mod, info))
               for info in mod.functions.values())


# ------------------------------------------------------------------ F003


def _handler_accounts(mod: ModuleInfo, handler: ast.ExceptHandler) -> bool:
    for n in handler.body:
        for sub in ast.walk(n):
            if isinstance(sub, (ast.Raise, ast.Return, ast.Break,
                                ast.Continue, ast.Assign, ast.AugAssign,
                                ast.AnnAssign)):
                return True
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            attr = func.attr if isinstance(func, ast.Attribute) else None
            if attr in RECORD_ATTRS:
                return True
            dotted = (mod.resolve(func) or "").rsplit(".", 1)[-1].lower()
            if any(p in dotted for p in _RECORD_NAME_PARTS):
                return True
            if handler.name and any(
                    _contains_name(a, handler.name)
                    for a in list(sub.args)
                    + [kw.value for kw in sub.keywords]):
                return True  # the failure is passed on, not dropped
    return False


def _is_best_effort_teardown(try_node: ast.Try) -> bool:
    """``try: sock.close() except OSError: pass`` — a try body made of
    nothing but reclaim calls is best-effort teardown of something
    already dying; silence is the correct accounting there."""
    for st in try_node.body:
        if not (isinstance(st, ast.Expr)
                and isinstance(st.value, ast.Call)
                and isinstance(st.value.func, ast.Attribute)
                and st.value.func.attr in RECLAIM_ATTRS):
            return False
    return bool(try_node.body)


def rule_swallowed_exception(mod: ModuleInfo,
                             ctx: Optional[FlowContext] = None
                             ) -> List[Finding]:
    """F003: an except body must account for the failure somehow."""
    out: List[Finding] = []
    for try_node in ast.walk(mod.tree):
        if not isinstance(try_node, ast.Try):
            continue
        teardown = _is_best_effort_teardown(try_node)
        for node in try_node.handlers:
            if teardown and all(isinstance(s, ast.Pass)
                                for s in node.body):
                continue
            if node.type is not None and _only_invalid_state(node.type):
                # the F002 once-guard idiom: losing a settle race to the
                # completion that already landed is the designed outcome
                continue
            if _handler_accounts(mod, node):
                continue
            if mod.suppressed(node.lineno, "F003"):
                continue
            out.append(Finding(
                "F003", mod.relfile, _enclosing_qualname(mod, node),
                node.lineno,
                "except body swallows the failure: it neither re-raises, "
                "settles a future, records to a metric/span/log, "
                "captures the exception into state, nor passes it on — "
                "breaks the shed-typed-never-silently accounting"))
    return out


# ------------------------------------------------------------------ F004


@dataclasses.dataclass
class _ClassResources:
    name: str
    node: ast.ClassDef
    methods: Dict[str, ast.AST]
    self_calls: Dict[str, Set[str]]
    resources: Dict[str, Tuple[str, int]]  # attr -> (kind, lineno)


def _scan_class_resources(mod: ModuleInfo,
                          cls: ast.ClassDef) -> _ClassResources:
    methods: Dict[str, ast.AST] = {}
    self_calls: Dict[str, Set[str]] = {}
    resources: Dict[str, Tuple[str, int]] = {}
    for child in cls.body:
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        methods[child.name] = child
        calls = self_calls.setdefault(child.name, set())
        for n in ast.walk(child):
            if isinstance(n, ast.Call) and isinstance(n.func,
                                                      ast.Attribute) \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id == "self":
                calls.add(n.func.attr)
            if isinstance(n, ast.Assign):
                for tgt, val in _paired_targets(n):
                    attr = _self_attr_name(tgt)
                    if attr is None or not isinstance(val, ast.Call):
                        continue
                    dotted = mod.resolve(val.func) or ""
                    kind = RESOURCE_CTORS.get(dotted.rsplit(".", 1)[-1])
                    if kind is not None:
                        resources.setdefault(attr, (kind, n.lineno))
    return _ClassResources(cls.name, cls, methods, self_calls, resources)


def _paired_targets(assign: ast.Assign) -> List[Tuple[ast.AST, ast.AST]]:
    """(target, value) pairs, unpacking parallel tuple assignment
    (``a, self.x = self.x, None``) positionally."""
    pairs: List[Tuple[ast.AST, ast.AST]] = []
    for tgt in assign.targets:
        if isinstance(tgt, (ast.Tuple, ast.List)) \
                and isinstance(assign.value, (ast.Tuple, ast.List)) \
                and len(tgt.elts) == len(assign.value.elts):
            pairs.extend(zip(tgt.elts, assign.value.elts))
        else:
            pairs.append((tgt, assign.value))
    return pairs


def _self_attr_name(node) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                      ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _method_reclaims(method: ast.AST, attrs: Set[str]) -> Set[str]:
    """Resource attrs reclaimed in one method body: direct
    ``self.X.close()``, alias swaps, container iteration, or handing
    ``self.X`` to a call."""
    aliases: Dict[str, str] = {}
    loop_map: Dict[str, str] = {}
    for n in ast.walk(method):
        if isinstance(n, ast.Assign):
            for tgt, val in _paired_targets(n):
                src = _self_attr_name(val)
                if src in attrs and isinstance(tgt, ast.Name):
                    aliases[tgt.id] = src
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            it = _unwrap_iter(n.iter)
            src = _self_attr_name(it)
            if src is None and isinstance(it, ast.Call) \
                    and isinstance(it.func, ast.Attribute):
                src = _self_attr_name(it.func.value)  # self.X.values()
            if src is None and isinstance(it, ast.Name):
                src = aliases.get(it.id)
            if src in attrs:
                for v in _loop_var_names(n.target):
                    loop_map[v] = src
    reclaimed: Set[str] = set()
    for n in ast.walk(method):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) \
                and n.func.attr in RECLAIM_ATTRS:
            recv = n.func.value
            attr = _self_attr_name(recv)
            if attr is None and isinstance(recv, ast.Name):
                attr = aliases.get(recv.id, loop_map.get(recv.id))
            if attr in attrs:
                reclaimed.add(attr)
        for arg in list(n.args) + [kw.value for kw in n.keywords]:
            attr = _self_attr_name(arg)
            if attr is None and isinstance(arg, ast.Name):
                attr = aliases.get(arg.id)
            if attr in attrs:
                reclaimed.add(attr)  # handed to a reaper helper
    return reclaimed


def _reachable_methods(cr: _ClassResources, roots: Iterable[str]
                       ) -> Set[str]:
    out: Set[str] = set()
    frontier = [r for r in roots if r in cr.methods]
    while frontier:
        m = frontier.pop()
        if m in out:
            continue
        out.add(m)
        frontier.extend(c for c in cr.self_calls.get(m, ())
                        if c in cr.methods)
    return out


def rule_resource_lifecycle(mod: ModuleInfo,
                            ctx: Optional[FlowContext] = None
                            ) -> List[Finding]:
    """F004: every resource stored on self is reclaimed from a reclaim
    root (stop/close/shutdown/__exit__/__del__)."""
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        cr = _scan_class_resources(mod, node)
        if not cr.resources:
            continue
        roots = [r for r in RECLAIM_ROOTS if r in cr.methods]
        reachable = _reachable_methods(cr, roots)
        attrs = set(cr.resources)
        reclaimed: Set[str] = set()
        for m in reachable:
            reclaimed |= _method_reclaims(cr.methods[m], attrs)
        for attr in sorted(attrs - reclaimed):
            kind, lineno = cr.resources[attr]
            if mod.suppressed(lineno, "F004"):
                continue
            why = (f"no {'/'.join(RECLAIM_ROOTS[:4])} method exists to "
                   "reclaim it" if not roots else
                   f"not reclaimed from {'/'.join(roots)} (or any method "
                   "they reach)")
            out.append(Finding(
                "F004", mod.relfile, f"{cr.name}.{attr}", lineno,
                f"self.{attr} ({kind}) is created but {why} — join/"
                "cancel/close/shutdown it so stop() leaves nothing "
                "running"))
    return out


def resource_count(mod: ModuleInfo) -> int:
    """Reclaimable self-attr resources seen — non-vacuity."""
    return sum(len(_scan_class_resources(mod, node).resources)
               for node in ast.walk(mod.tree)
               if isinstance(node, ast.ClassDef))


# ------------------------------------------------------------------ F005


def _background_methods(mod: ModuleInfo) -> Set[str]:
    """Qualnames reachable from a class's own thread/timer/http roots
    (Tier T derived model) — background loops may block deliberately.
    "client" pseudo-roots (any public method) are NOT excluded: those
    run on the caller's thread, i.e. exactly the request path."""
    out: Set[str] = set()
    for model in build_class_models(mod):
        for root, kind in model.roots.items():
            if kind == "client":
                continue
            for m in model.reachable_from(root):
                out.add(f"{model.name}.{m}")
    return out


def _timeout_expr(call: ast.Call) -> Tuple[Optional[ast.AST], bool]:
    """(timeout expression, skip) for one blocking call. ``skip`` is
    True for shapes that aren't blocking waits (``d.get(key)``)."""
    attr = call.func.attr
    for kw in call.keywords:
        if kw.arg == "timeout":
            return kw.value, False
        if kw.arg in ("block", "blocking") \
                and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return None, True  # non-blocking poll
    if attr in ("result", "wait", "join"):
        return (call.args[0], False) if call.args else (None, False)
    if attr in ("get", "acquire"):
        # get(block, timeout) / acquire(blocking, timeout): the budget is
        # the 2nd positional and the 1st is a literal bool; any other
        # 1st positional means a mapping lookup (d.get(key, default)),
        # and a 1-arg get/acquire(False) is a lookup/poll
        if call.args:
            first = call.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, bool)):
                return None, True
            if len(call.args) >= 2:
                return call.args[1], False
            return None, first.value is False
        return None, False
    return None, False


def rule_unbudgeted_blocking(mod: ModuleInfo,
                             ctx: Optional[FlowContext] = None
                             ) -> List[Finding]:
    """F005: request-path blocking calls carry a derived budget."""
    background = _background_methods(mod)
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in BLOCKING_ATTRS):
            continue
        qual = _enclosing_qualname(mod, node)
        parts = qual.split(".")
        if parts[-1] in LIFECYCLE_METHODS:
            continue
        if len(parts) >= 2 and ".".join(parts[-2:]) in background:
            continue
        if _root_name(node.func.value) == "str":
            continue
        timeout, skip = _timeout_expr(node)
        if skip:
            continue
        attr = node.func.attr
        if timeout is None:
            if attr == "join" and not isinstance(
                    node.func.value, (ast.Name, ast.Attribute)):
                continue  # "sep".join-style, not a thread join
            if mod.suppressed(node.lineno, "F005"):
                continue
            out.append(Finding(
                "F005", mod.relfile, qual, node.lineno,
                f"bare blocking {attr}() in request-path code — pass a "
                "timeout derived from remaining_ms/deadline/config so "
                "an unhealthy dependency degrades the request, not the "
                "process"))
        elif isinstance(timeout, ast.Constant) \
                and isinstance(timeout.value, (int, float)) \
                and not isinstance(timeout.value, bool):
            if mod.suppressed(node.lineno, "F005"):
                continue
            out.append(Finding(
                "F005", mod.relfile, qual, node.lineno,
                f"blocking {attr}() with literal timeout "
                f"{timeout.value!r} — derive the budget from "
                "remaining_ms/deadline/config, not a magic constant"))
    return out


# ------------------------------------------------------------ entrypoints


FLOW_RULES = (rule_untyped_raise, rule_settle_discipline,
              rule_swallowed_exception, rule_resource_lifecycle,
              rule_unbudgeted_blocking)


def collect_flow_modules(root: str, package: str = PACKAGE
                         ) -> Tuple[List[ModuleInfo], List[Finding]]:
    """Request-path modules under ``root``: the FLOW_SCAN_DIRS packages
    plus the FLOW_SCAN_FILES singletons. Parse failures become E000."""
    from raft_tpu_torch.analysis import collect_modules, parse_module
    dirs, files = flow_scan_paths(package)
    modules, findings = collect_modules(root, dirs)
    for rel in files:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            continue
        modname = rel[:-3].replace("/", ".").replace(os.sep, ".")
        try:
            modules.append(parse_module(path, rel, modname))
        except SyntaxError as e:
            findings.append(Finding(
                rule="E000", file=rel, qualname="<module>",
                line=e.lineno or 0, message=f"syntax error: {e.msg}"))
    return modules, findings


def run_flow(root: str, rules: Optional[Iterable] = None,
             package: str = PACKAGE) -> List[Finding]:
    """Run F001–F005 over ``package``'s request path at ``root``."""
    modules, findings = collect_flow_modules(root, package)
    ctx = FlowContext(modules, typed_exports=_serving_exports(root, package))
    for mod in modules:
        for rule in (rules if rules is not None else FLOW_RULES):
            findings.extend(rule(mod, ctx))
    seen = set()
    unique: List[Finding] = []
    for f in findings:
        ident = (f.key, f.line, f.message)
        if ident not in seen:
            seen.add(ident)
            unique.append(f)
    unique.sort(key=lambda f: (f.file, f.line, f.rule))
    return unique


def flow_stats(root: str, package: str = PACKAGE) -> Dict[str, int]:
    """What the sweep actually saw — the non-vacuity counters the live
    tests assert on (a resolver regression must not pass as "zero
    findings")."""
    modules, _ = collect_flow_modules(root, package)
    return {
        "modules": len(modules),
        "raise_sites": sum(len(_raise_sites(m)) for m in modules),
        "settle_owners": sum(settle_owner_count(m) for m in modules),
        "resources": sum(resource_count(m) for m in modules),
    }
