"""Shared AST infrastructure for the Tier-A rules (nothing scanned is
imported).

The port's counterpart of ``raft_tpu.analysis.astutils``. Per module this
builds:

- an import-alias map so rules can resolve ``F.pad`` →
  ``torch.nn.functional.pad`` or ``np.asarray`` → ``numpy.asarray``
  whatever the local alias is;
- a function table keyed by dotted qualname (``Class.method``,
  ``outer.inner`` for nested defs), each with the class it is a method of;
- a call graph over the module: bare-name calls (and functions passed by
  name, ``map(step, ...)``) and ``self.method()`` calls within a class,
  from which the rules take call closures (the request path of an entry
  point) and transitive callers (the solve that sized a tile).

raft_tpu's version also derives which functions run under ``jax.jit``;
the port has no tracing compiler, so its hot-path scope is the request
path instead (:func:`raft_tpu_torch.analysis.rules_ast.request_path`).
Heuristics are per-module by design, as in raft_tpu: cross-module
resolution would need whole-program import resolution for marginal extra
recall.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Optional


@dataclasses.dataclass
class FunctionInfo:
    name: str
    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    parent: Optional[str]  # enclosing function qualname, None at module level
    lineno: int
    params: tuple = ()
    #: qualname of the class this is a method of (None for functions)
    cls: Optional[str] = None
    calls: set = dataclasses.field(default_factory=set)  # bare callee names
    #: ``self.<name>()`` calls made in the body
    self_calls: set = dataclasses.field(default_factory=set)


class ModuleInfo:
    """Parsed module + call graph; input to every Tier-A rule."""

    def __init__(self, path: str, relfile: str, modname: str):
        self.path = path
        self.relfile = relfile
        self.modname = modname  # e.g. "raft_tpu_torch.ops.select_k"
        parts = modname.split(".")
        #: containing package ("raft_tpu_torch.ops"; the top at top level)
        self.package = ".".join(parts[:-1]) if len(parts) > 1 else parts[0]
        with open(path) as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=path)
        self.aliases: dict[str, str] = {}  # local name -> dotted origin
        self.functions: dict[str, FunctionInfo] = {}
        self.name_index: dict[str, list] = {}  # bare name -> [qualnames]
        #: products the tiers derive from this module once (the thread
        #: rules' class models)
        self.derived: dict = {}
        self._collect_imports()
        self._collect_functions()
        self._collect_calls()

    # -------------------------------------------------------------- building
    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:  # relative import: anchor in this package
                    base = ".".join(
                        [*self.modname.split(".")[:-node.level], node.module])
                else:
                    base = node.module
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{base}.{a.name}"

    def _collect_functions(self) -> None:
        def visit(node, prefix, parent_fn, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    args = child.args
                    params = tuple(
                        a.arg for a in (args.posonlyargs + args.args
                                        + args.kwonlyargs))
                    self.functions[qual] = FunctionInfo(
                        name=child.name, qualname=qual, node=child,
                        parent=parent_fn, lineno=child.lineno, params=params,
                        cls=cls)
                    self.name_index.setdefault(child.name, []).append(qual)
                    visit(child, f"{qual}.", qual, None)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.", parent_fn,
                          f"{prefix}{child.name}")
                elif not isinstance(child, ast.expr):
                    # a def is a statement: no expression holds one
                    visit(child, prefix, parent_fn, cls)

        visit(self.tree, "", None, None)

    def _collect_calls(self) -> None:
        for info in self.functions.values():
            collector = _CallCollector(skip_node=info.node)
            for child in ast.iter_child_nodes(info.node):
                collector.visit(child)
            info.calls = collector.names
            info.self_calls = collector.self_names

    # ------------------------------------------------------------- utilities
    def dotted(self, node) -> Optional[str]:
        """`a.b.c` Attribute/Name chain → "a.b.c", else None."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    def resolve(self, node_or_str) -> Optional[str]:
        """Dotted path with the first segment expanded through imports."""
        dotted = (node_or_str if isinstance(node_or_str, str)
                  else self.dotted(node_or_str))
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        origin = self.aliases.get(head, head)
        return f"{origin}.{rest}" if rest else origin

    def callees(self, qualname: str) -> set:
        """In-module functions ``qualname`` calls: by bare name, through
        ``self.method()`` within its class, and its own nested defs."""
        info = self.functions[qualname]
        out = set()
        for name in info.calls:
            out.update(self.name_index.get(name, ()))
        owner = info.cls
        if owner is None and info.parent is not None:
            # a closure inside a method calls its class through self too
            top = info
            while top.parent is not None:
                top = self.functions[top.parent]
            owner = top.cls
        if owner is not None:
            for name in info.self_calls:
                q = f"{owner}.{name}"
                if q in self.functions:
                    out.add(q)
        out.update(q for q, f in self.functions.items()
                   if f.parent == qualname)
        return out

    def call_closure(self, roots: Iterable[str]) -> set:
        """Qualnames reachable from ``roots`` (included) through
        :meth:`callees`."""
        reach = set()
        frontier = [q for q in roots if q in self.functions]
        while frontier:
            q = frontier.pop()
            if q in reach:
                continue
            reach.add(q)
            frontier.extend(self.callees(q) - reach)
        return reach

    def callers_of(self, qualname: str) -> set:
        """Transitive in-module callers of ``qualname`` (incl. itself)."""
        edges = {q: self.callees(q) for q in self.functions}
        wanted = {qualname}
        changed = True
        while changed:
            changed = False
            for q, callees in edges.items():
                if q not in wanted and callees & wanted:
                    wanted.add(q)
                    changed = True
        return wanted

    def suppressed(self, lineno: int, rule: str) -> bool:
        """Inline escape hatch: ``# graftcheck: RXXX`` on the flagged line."""
        if 0 < lineno <= len(self.lines):
            line = self.lines[lineno - 1]
            if "graftcheck:" in line:
                tail = line.split("graftcheck:", 1)[1]
                return rule in tail
        return False


class _CallCollector(ast.NodeVisitor):
    """Names called within one function body, not descending into nested
    function/class definitions (they have their own entries)."""

    def __init__(self, skip_node):
        self.skip = skip_node
        self.names: set = set()
        self.self_names: set = set()

    def visit_FunctionDef(self, node):  # noqa: N802 (ast visitor API)
        if node is self.skip:
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):  # noqa: N802 (ast visitor API)
        pass

    def visit_Call(self, node):  # noqa: N802 (ast visitor API)
        func = node.func
        if isinstance(func, ast.Name):
            self.names.add(func.id)
        elif (isinstance(func, ast.Attribute)
              and isinstance(func.value, ast.Name)
              and func.value.id == "self"):
            self.self_names.add(func.attr)
        # functional references too: map(step, ...), pool.submit(work, ...)
        for arg in node.args:
            if isinstance(arg, ast.Name):
                self.names.add(arg.id)
        self.generic_visit(node)
