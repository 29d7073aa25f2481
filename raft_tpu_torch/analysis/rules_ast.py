"""Tier-A rules R001/R002/R003/R005/R006/R007 for the port — pure AST.

The port's counterparts of ``raft_tpu.analysis.rules_ast``. raft_tpu's
hot path is whatever ``jax.jit`` traces; the port's is the **request
path**: the module-local call closure of each search entry point
(:func:`request_path`). Each rule is a function ``(ModuleInfo) ->
list[Finding]``; R006 and R007 take the root package as a parameter
(``package``, ``raft_tpu_torch`` by default), so the same code checks
raft_tpu for parity.

- **R001 host sync** on the request path: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``np.asarray``/``np.array`` of a tensor,
  ``torch.cuda.synchronize``, and ``torch.bincount``/``nonzero``/
  ``unique``, which read their result's size back to the host. Each one
  waits for the card's queue to drain before the host can go on.
- **R002** a Python ``if``/``while`` on a tensor value on the request
  path: the test reads the value back (a sync) and the branch taken
  depends on data the host had to wait for.
- **R003** a kernel library load (``gpu_kernels.build_all``/``_lib``,
  ``ctypes.CDLL``) or a CUDA-graph capture inside a ``for``/``while``
  loop: the build, load or capture recurs every iteration.
- **R005** a torch op shaping 3 or more symbolic dims on the request
  path, with no dominating workspace solve (``plan_*``,
  ``solve_joint_tiles``, ``choose_tile_rows``, ``workspace_limit_bytes``)
  in the function or an in-module caller: an unbudgeted live set.
- **R006** a public ``search``/``build``/``knn`` of ``<package>.neighbors``
  without ``core.tracing.range``/``annotate``.
- **R007** a dispatch decision (``fused_dispatch[_explained]``,
  ``plan_sharded_search``, ``choose_operating_point``) with no
  execution-plan attribution (``obs.explain.record_dispatch``,
  ``note_select_k``, ``sharded._record_plan``, ``record_choice``) in the
  same top-level function.
"""

from __future__ import annotations

import ast
from typing import Optional

from raft_tpu_torch.analysis.astutils import ModuleInfo
from raft_tpu_torch.analysis.findings import Finding

#: the package the port's rules scope by default
PACKAGE = "raft_tpu_torch"

#: resolved calls that wait for the device (R001)
HOST_SYNC_CALLS = frozenset({
    "torch.cuda.synchronize", "torch.bincount", "torch.nonzero",
    "torch.unique", "torch.unique_consecutive",
})
#: method names that copy a tensor to the host or read it back (R001)
HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero",
                               "unique", "bincount", "synchronize"})
#: numpy constructors that read a tensor argument back (R001)
NUMPY_FROM_TENSOR = frozenset({"numpy.asarray", "numpy.array"})

#: torch calls that return Python values or metadata, never a tensor
STATIC_TORCH_CALLS = frozenset({
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_name",
    "torch.cuda.current_stream", "torch.cuda.Event",
    "torch.get_default_dtype", "torch.promote_types", "torch.result_type",
    "torch.can_cast", "torch.Size", "torch.no_grad", "torch.inference_mode",
})
#: attribute reads of a tensor that are host metadata
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                          "numel", "dim", "size", "itemsize", "element_size",
                          "is_contiguous", "stride", "data_ptr", "layout",
                          "requires_grad", "type"})

#: workspace planners whose presence in a caller chain certifies that a
#: multi-axis intermediate was sized from the memory budget (R005)
GUARD_CALLS = frozenset({
    "solve_joint_tiles", "choose_tile_rows", "choose_tiles",
    "_choose_tiles", "solve_host_tier", "solve_merge_bytes",
})
GUARD_PREFIX = "plan_"
GUARD_ATTR = "workspace_limit_bytes"


def _is_torch_call(mod: ModuleInfo, node) -> bool:
    """A ``torch.*`` call that produces a tensor (not a static query, nor
    ``torch.cuda``/``backends``/``distributed``/``profiler``/``utils``)."""
    if not isinstance(node, ast.Call):
        return False
    dotted = mod.resolve(node.func)
    if not dotted or dotted in STATIC_TORCH_CALLS:
        return False
    return dotted.startswith("torch.") and not dotted.startswith(
        ("torch.cuda.", "torch.backends.", "torch.distributed.",
         "torch.profiler.", "torch.utils."))


def _contains_torch_call(mod: ModuleInfo, node) -> bool:
    return any(_is_torch_call(mod, n) for n in _walk_expr(node))


def _walk_expr(node):
    """ast.walk that skips the static parts of an expression: metadata
    attributes (``x.shape``, ``x.dim()``), ``len``/``isinstance``."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Attribute) and n.attr in STATIC_ATTRS:
            continue
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in STATIC_ATTRS):
            continue
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in ("len", "isinstance", "getattr", "hasattr",
                                  "str", "type", "id", "callable")):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _walk_shallow(nodes):
    """ast.walk over statements without entering nested function/class
    definitions."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _body(info):
    return list(ast.iter_child_nodes(info.node))


# ------------------------------------------------------------ request path

def _entry_points(mod: ModuleInfo, package: str) -> list:
    """The search entry points of one module: every ``search``/``knn``/
    ``search_*`` function or method under ``<package>.neighbors`` and in
    ``<package>.parallel.sharded``; the ``search`` functions of
    ``<package>.serving.searchers``."""
    name = mod.modname
    if name == f"{package}.serving.searchers":
        return [q for q, f in mod.functions.items() if f.name == "search"]
    if not (name.startswith(f"{package}.neighbors.")
            or name == f"{package}.parallel.sharded"):
        return []
    return [q for q, f in mod.functions.items()
            if f.name in ("search", "knn") or f.name.startswith("search_")]


def request_path(mod: ModuleInfo, package: str = PACKAGE) -> set:
    """Qualnames on the request path of ``mod``: the module-local call
    closure of its search entry points (nested defs included)."""
    return mod.call_closure(_entry_points(mod, package))


def _request_bodies(mod: ModuleInfo, package: str):
    for qual in sorted(request_path(mod, package)):
        info = mod.functions[qual]
        yield info, _body(info)


# ----------------------------------------------------------------- R001
def _tensor_locals(mod: ModuleInfo, stmts) -> set:
    """Names assigned directly from a torch call in this body."""
    names = set()
    for node in _walk_shallow(stmts):
        if isinstance(node, ast.Assign) and _is_torch_call(mod, node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    names.update(e.id for e in t.elts
                                 if isinstance(e, ast.Name))
    return names


def _is_tensor_expr(mod: ModuleInfo, node, tensors: set) -> bool:
    if _contains_torch_call(mod, node):
        return True
    return any(isinstance(n, ast.Name) and n.id in tensors
               for n in _walk_expr(node))


def rule_host_sync(mod: ModuleInfo, package: str = PACKAGE) -> list:
    """R001: a host sync on the request path."""
    out = []
    for info, stmts in _request_bodies(mod, package):
        tensors = _tensor_locals(mod, stmts)
        for node in _walk_shallow(stmts):
            if not isinstance(node, ast.Call):
                continue
            msg = None
            dotted = mod.resolve(node.func)
            if dotted in HOST_SYNC_CALLS:
                msg = (f"{dotted}() waits for the device on the request "
                       "path")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in HOST_SYNC_METHODS
                  and not node.args and not node.keywords
                  and mod.resolve(node.func.value) not in ("numpy", "np")):
                msg = (f".{node.func.attr}() reads a tensor back to the "
                       "host on the request path")
            elif (dotted in NUMPY_FROM_TENSOR and node.args
                  and _is_tensor_expr(mod, node.args[0], tensors)):
                msg = (f"{dotted}() of a tensor copies it to the host on "
                       "the request path")
            elif (dotted in ("float", "int", "bool") and node.args
                  and _contains_torch_call(mod, node.args[0])):
                msg = (f"{dotted}() of a tensor reads it back on the "
                       "request path")
            if msg and not mod.suppressed(node.lineno, "R001"):
                out.append(Finding("R001", mod.relfile, info.qualname,
                                   node.lineno, msg))
    return out


# ----------------------------------------------------------------- R002
def _names_tested(test: ast.AST) -> set:
    """Name loads in a test expression, excluding metadata reads
    (``x.shape[0]``, ``len(x)``, ``x.dim()``) and identity tests."""
    skip = set()
    for node in ast.walk(test):
        if (isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS
                and isinstance(node.value, ast.Name)):
            skip.add(id(node.value))
        if (isinstance(node, ast.Compare)
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in node.ops)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    skip.add(id(sub))
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("len", "isinstance", "getattr",
                                     "hasattr", "str", "type")):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    skip.add(id(sub))
    return {n.id for n in ast.walk(test)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            and id(n) not in skip}


def rule_tensor_branch(mod: ModuleInfo, package: str = PACKAGE) -> list:
    """R002: a Python ``if``/``while`` on a tensor value on the request
    path — (a) a test containing a torch call, (b) a test naming a local
    assigned from one (metadata reads excluded)."""
    out = []
    for info, stmts in _request_bodies(mod, package):
        tensors = _tensor_locals(mod, stmts)
        for node in _walk_shallow(stmts):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            kind = "if" if isinstance(node, ast.If) else "while"
            msg = None
            if _contains_torch_call(mod, node.test):
                msg = (f"`{kind}` branches on a torch expression on the "
                       "request path (a read-back of device data)")
            else:
                hit = _names_tested(node.test) & tensors
                if hit:
                    msg = (f"`{kind}` branches on tensor value(s) "
                           f"{', '.join(sorted(hit))} on the request path; "
                           "use torch.where or decide on the host's data")
            if msg and not mod.suppressed(node.lineno, "R002"):
                out.append(Finding("R002", mod.relfile, info.qualname,
                                   node.lineno, msg))
    return out


# ----------------------------------------------------------------- R003
#: resolved calls (or call-name suffixes) that load or build a kernel
#: library, and that capture a CUDA graph
LIBRARY_LOADS = frozenset({"ctypes.CDLL", "ctypes.cdll.LoadLibrary",
                           "ctypes.PyDLL"})
LIBRARY_SUFFIXES = ("gpu_kernels.build_all", "gpu_kernels._lib")
GRAPH_CAPTURES = frozenset({"torch.cuda.graph", "torch.cuda.CUDAGraph",
                            "torch.cuda.make_graphed_callables"})


def _load_or_capture(mod: ModuleInfo, node: ast.Call) -> Optional[str]:
    dotted = mod.resolve(node.func) or ""
    if dotted in LIBRARY_LOADS or dotted.endswith(LIBRARY_SUFFIXES):
        return "kernel library load"
    if (mod.modname.endswith(".gpu_kernels")
            and isinstance(node.func, ast.Name)
            and node.func.id in ("build_all", "_lib")):
        return "kernel library load"
    if dotted in GRAPH_CAPTURES or (isinstance(node.func, ast.Attribute)
                                    and node.func.attr == "capture_begin"):
        return "CUDA-graph capture"
    return None


def rule_recompile_hazard(mod: ModuleInfo) -> list:
    """R003: a kernel library load or build, or a CUDA-graph capture,
    inside a ``for``/``while`` loop — its cost recurs every iteration;
    hoist it out of the loop."""
    out = []
    seen = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            continue
        for sub in _walk_shallow(node.body + node.orelse):
            if not isinstance(sub, ast.Call) or id(sub) in seen:
                continue
            what = _load_or_capture(mod, sub)
            if what is None or mod.suppressed(sub.lineno, "R003"):
                continue
            seen.add(id(sub))
            out.append(Finding(
                "R003", mod.relfile, _enclosing_qualname(mod, sub),
                sub.lineno,
                f"{what} inside a loop: it recurs every iteration; hoist "
                "it out of the loop"))
    return out


# ----------------------------------------------------------------- R005
#: torch factories whose shape is their positional dims (or one tuple)
SHAPE_FACTORIES = frozenset({
    "torch.empty", "torch.zeros", "torch.ones", "torch.full",
    "torch.rand", "torch.randn", "torch.randint",
})
#: tensor methods whose positional dims (or one tuple) shape the result
SHAPE_METHODS = frozenset({"reshape", "view", "expand", "new_empty",
                           "new_zeros", "new_ones", "new_full", "repeat"})


def _symbolic_dims(args) -> int:
    """How many of these dim expressions are not integer literals."""
    n = 0
    for a in args:
        if isinstance(a, ast.Constant) and isinstance(a.value, int):
            continue
        if (isinstance(a, ast.UnaryOp)
                and isinstance(a.operand, ast.Constant)):
            continue
        n += 1
    return n


def _dims_of(args):
    if len(args) == 1 and isinstance(args[0], (ast.Tuple, ast.List)):
        return args[0].elts
    return [a for a in args if not isinstance(a, ast.Starred)]


def _shape_args(mod: ModuleInfo, node: ast.Call):
    """The dim expressions of a shape-producing call, or None."""
    dotted = mod.resolve(node.func)
    if dotted in SHAPE_FACTORIES:
        if dotted == "torch.full":
            return _dims_of(node.args[:1])
        if dotted == "torch.randint":
            shp = [k.value for k in node.keywords if k.arg == "size"]
            if shp:
                return _dims_of(shp)
            return _dims_of(node.args[-1:]) if node.args else None
        return _dims_of(node.args)
    if dotted == "torch.broadcast_to" and len(node.args) >= 2:
        return _dims_of(node.args[1:2])
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in SHAPE_METHODS and node.args
            and mod.resolve(node.func.value) != "torch"):
        if node.func.attr == "new_full":
            return _dims_of(node.args[:1])
        return _dims_of(node.args)
    return None


def _einsum_out_rank(node: ast.Call) -> Optional[int]:
    if (node.args and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and "->" in node.args[0].value):
        return len(node.args[0].value.split("->")[1].strip())
    return None


def _is_guard_call(mod: ModuleInfo, node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    last = (mod.resolve(node.func) or "").rsplit(".", 1)[-1]
    return last in GUARD_CALLS or last.startswith(GUARD_PREFIX)


def _function_is_guarded(mod: ModuleInfo, qualname: str) -> bool:
    """The function — or anything that (transitively) calls it in this
    module — consults a workspace planner, so its dims were solved from
    the memory budget."""
    for caller in mod.callers_of(qualname):
        info = mod.functions[caller]
        for node in _walk_shallow(ast.iter_child_nodes(info.node)):
            if isinstance(node, ast.Attribute) and node.attr == GUARD_ATTR:
                return True
            if _is_guard_call(mod, node):
                return True
    return False


def rule_unguarded_broadcast(mod: ModuleInfo,
                             package: str = PACKAGE) -> list:
    """R005: a torch op shaping >= 3 symbolic dims on the request path with
    no dominating workspace solve. Its memory grows with the product of
    those dims; unless a caller sized them from the budget, the live set
    is unbudgeted (the class that produced raft_tpu's 1M-row LUT crash)."""
    out = []
    guarded: dict = {}
    for info, stmts in _request_bodies(mod, package):
        for node in _walk_shallow(stmts):
            if not isinstance(node, ast.Call):
                continue
            dotted = mod.resolve(node.func)
            n_sym, what = None, None
            shape_args = _shape_args(mod, node)
            if shape_args is not None and len(shape_args) >= 3:
                n_sym = _symbolic_dims(shape_args)
                what = (dotted or node.func.attr).rsplit(".", 1)[-1]
            elif dotted == "torch.einsum":
                rank = _einsum_out_rank(node)
                if rank is not None and rank >= 3:
                    n_sym, what = rank, "einsum"
            if n_sym is None or n_sym < 3:
                continue
            top = info.qualname
            while mod.functions[top].parent is not None:
                top = mod.functions[top].parent
            if top not in guarded:
                guarded[top] = _function_is_guarded(mod, top)
            if guarded[top] or mod.suppressed(node.lineno, "R005"):
                continue
            out.append(Finding(
                "R005", mod.relfile, info.qualname, node.lineno,
                f"`{what}` shapes {n_sym} symbolic dims on the request path "
                "with no workspace solve (plan_* / solve_joint_tiles / "
                "choose_tile_rows / workspace_limit_bytes) in any enclosing "
                "caller — unbudgeted live set"))
    return out


# ----------------------------------------------------------------- R006
#: module-level entry-point names that must run under a tracing scope
TRACED_ENTRY_NAMES = frozenset({"search", "build", "knn"})


def rule_untraced_entry_point(mod: ModuleInfo,
                              package: str = PACKAGE) -> list:
    """R006: public search/build/knn of ``<package>.neighbors`` without a
    tracing scope (``core.tracing.range`` or ``annotate``): profiles
    attribute device time to an algorithm through those scopes."""
    if not mod.modname.startswith(f"{package}.neighbors."):
        return []
    decorators = {f"{package}.core.tracing.range",
                  f"{package}.core.tracing.annotate"}
    out = []
    for qual, info in sorted(mod.functions.items()):
        if (info.parent is not None or "." in qual
                or info.name not in TRACED_ENTRY_NAMES
                or info.name.startswith("_")):
            continue
        decorated = False
        for dec in info.node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if mod.resolve(target) in decorators:
                decorated = True
                break
        if decorated or mod.suppressed(info.lineno, "R006"):
            continue
        out.append(Finding(
            "R006", mod.relfile, qual, info.lineno,
            f"public entry point {info.name}() lacks a tracing scope; "
            "decorate with @tracing.range(...) so profiles attribute "
            "device time to the algorithm"))
    return out


# ----------------------------------------------------------------- R007
#: the kernel modules that define the dispatch helpers: raft_tpu's Pallas
#: module and the port's CUDA one
KERNEL_MODULES = ("ops.pallas_kernels", "ops.gpu_kernels")


def dispatch_tables(package: str) -> tuple:
    """(dispatch calls, attribution calls, scopes, exempt modules) of R007
    for ``package``."""
    dispatch = {f"{package}.parallel.sharded.plan_sharded_search",
                f"{package}.planner.adaptive.choose_operating_point"}
    for km in KERNEL_MODULES:
        dispatch |= {f"{package}.{km}.fused_dispatch",
                     f"{package}.{km}.fused_dispatch_explained"}
    attribution = frozenset({
        f"{package}.obs.explain.record_dispatch",
        f"{package}.obs.explain.note_select_k",
        f"{package}.parallel.sharded._record_plan",
        f"{package}.planner.adaptive.record_choice",
    })
    scopes = tuple(f"{package}.{sub}." for sub in
                   ("neighbors", "ops", "parallel", "planner"))
    exempt = frozenset(f"{package}.{km}" for km in KERNEL_MODULES)
    return frozenset(dispatch), attribution, scopes, exempt


def rule_unattributed_dispatch(mod: ModuleInfo,
                               package: str = PACKAGE) -> list:
    """R007: a function that consults the fused gate, the sharded merge
    plan or the adaptive policy chooses between engines, and the losing
    branch must never fall back silently: it must also call
    ``obs.explain.record_dispatch`` (or ``note_select_k``, the sharded
    ``_record_plan``, the planner's ``record_choice``). Nested defs count
    toward their top-level function."""
    dispatch, attribution, scopes, exempt = dispatch_tables(package)
    if not mod.modname.startswith(scopes) or mod.modname in exempt:
        return []
    out = []
    for qual, info in sorted(mod.functions.items()):
        if info.parent is not None:
            continue  # rolled up into the enclosing top-level function
        dispatch_nodes = []
        attributed = False
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            dotted = mod.resolve(node.func)
            if dotted and "." not in dotted:
                # a bare call to a module-local helper
                dotted = f"{mod.modname}.{dotted}"
            if dotted in dispatch:
                dispatch_nodes.append(node)
            elif dotted in attribution:
                attributed = True
        if attributed:
            continue
        for node in dispatch_nodes:
            if mod.suppressed(node.lineno, "R007"):
                continue
            out.append(Finding(
                "R007", mod.relfile, qual, node.lineno,
                "dispatch decision (fused_dispatch) with no execution-"
                "plan attribution in this function: call "
                "obs.explain.record_dispatch on every resolved branch "
                "so fallbacks are reason-coded, never silent"))
    return out


def _enclosing_qualname(mod: ModuleInfo, node) -> str:
    """Innermost function whose span contains ``node`` (by line)."""
    best, best_span = "<module>", None
    for info in mod.functions.values():
        end = getattr(info.node, "end_lineno", info.lineno)
        if info.lineno <= node.lineno <= end:
            span = end - info.lineno
            if best_span is None or span < best_span:
                best, best_span = info.qualname, span
    return best


AST_RULES = (rule_host_sync, rule_tensor_branch, rule_recompile_hazard,
             rule_unguarded_broadcast, rule_untraced_entry_point,
             rule_unattributed_dispatch)
