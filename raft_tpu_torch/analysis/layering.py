"""R004 — layering: no module reaches another package's underscore-private
names (the ``detail::`` convention from the reference codebase: RAFT keeps
``detail/`` internals package-private and cross-package consumers go
through the public headers; CUDA's separation is enforced by the linker,
ours must be enforced by this rule).

The port's counterpart of ``raft_tpu.analysis.layering``. The root
package is a parameter (``raft_tpu_torch`` by default), so the same code
runs over raft_tpu for parity. Checked forms, across every subpackage of
the root:

- ``from <root>.other.mod import _private``
- ``from <root>.other import _private_module``
- attribute reads through an imported module alias: ``ivf_pq._core(...)``

Same-package use of privates is the point of the convention and is always
allowed; dunder names are not private. Two consumers are exempt:
``<root>.analysis`` (the memory audit introspects the routes' cores the
way a profiler would) and ``tests`` (white-box unit tests exercise
private cores by design — the layering contract is about production
call paths, and ``tools``/library code stays fully subject).
"""

from __future__ import annotations

import ast
from typing import Iterable

from raft_tpu_torch.analysis.astutils import ModuleInfo
from raft_tpu_torch.analysis.findings import Finding

ROOT = "raft_tpu_torch"
#: top-level trees exempt from R004 entirely
EXEMPT_TOPLEVEL = frozenset({"tests"})


def _under(dotted: str, root: str) -> bool:
    """``dotted`` names ``root`` or something in it."""
    return dotted == root or dotted.startswith(root + ".")


def _is_private(name: str) -> bool:
    return name.startswith("_") and not name.startswith("__")


def _package_of(module_path: str, known_modules: set) -> str:
    """Containing package of a dotted module path ("<root>.neighbors"
    for "<root>.neighbors.ivf_pq"; packages map to themselves)."""
    if module_path in known_modules and _looks_like_package(
            module_path, known_modules):
        return module_path
    head = module_path.rsplit(".", 1)[0]
    return head if head else module_path


def _looks_like_package(module_path: str, known_modules: set) -> bool:
    prefix = module_path + "."
    return any(m.startswith(prefix) for m in known_modules)


def check_layering(modules: Iterable[ModuleInfo], root: str = ROOT) -> list:
    """R004 over ``modules``; ``root`` is the package whose privates are
    guarded (``<root>.analysis`` may reach them)."""
    modules = list(modules)
    known = {m.modname for m in modules}
    out = []
    for mod in modules:
        if (mod.package == f"{root}.analysis"
                or mod.modname.split(".")[0] in EXEMPT_TOPLEVEL):
            continue
        out.extend(_check_module(mod, known, root))
    return out


def _check_module(mod: ModuleInfo, known: set, root: str) -> list:
    out = []

    def flag(lineno, name, target_pkg):
        if mod.suppressed(lineno, "R004"):
            return
        out.append(Finding(
            "R004", mod.relfile, _enclosing(mod, lineno), lineno,
            f"{mod.package} reaches private `{name}` of {target_pkg}; "
            "cross-package access must go through a public name "
            "(detail:: layering)"))

    # --- import forms
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            base = node.module
            if node.level:
                base = ".".join(
                    [*mod.modname.split(".")[:-node.level], node.module])
            if not _under(base, root):
                continue
            for a in node.names:
                if a.name == "*" or not _is_private(a.name):
                    continue
                # the imported name may itself be a private submodule
                target_mod = base if f"{base}.{a.name}" not in known \
                    else f"{base}.{a.name}"
                pkg = _package_of(target_mod, known)
                if pkg != mod.package:
                    flag(node.lineno, f"{base}.{a.name}", pkg)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if not _under(a.name, root):
                    continue
                if any(_is_private(seg) for seg in a.name.split(".")):
                    pkg = _package_of(a.name, known)
                    if pkg != mod.package:
                        flag(node.lineno, a.name, pkg)

    # --- attribute reads through module aliases: `ivf_pq._search_lut_core`
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Attribute)
                and _is_private(node.attr)
                and isinstance(node.ctx, ast.Load)):
            continue
        dotted = mod.dotted(node.value)
        if not dotted:
            continue
        resolved = mod.resolve(dotted)
        if not (resolved and _under(resolved, root)
                and resolved in known):
            continue
        pkg = _package_of(resolved, known)
        if pkg != mod.package:
            flag(node.lineno, f"{resolved}.{node.attr}", pkg)
    return out


def _enclosing(mod: ModuleInfo, lineno: int) -> str:
    best, best_span = "<module>", None
    for info in mod.functions.values():
        end = getattr(info.node, "end_lineno", info.lineno)
        if info.lineno <= lineno <= end:
            span = end - info.lineno
            if best_span is None or span < best_span:
                best, best_span = info.qualname, span
    return best
