"""Tier K for CUDA — kernel-discipline analysis of ``csrc/`` (K001–K005).

The port's counterpart of ``raft_tpu.analysis.kernels``. raft_tpu's Tier K
reads the Pallas kernels' Python AST; the port's kernels are CUDA C++, so
this tier is plain text analysis of ``raft_tpu_torch/csrc/*.cu``/``*.cuh``
(and ``*.h``) with the comments stripped. It runs no compiler and builds
nothing: a bug it catches here would otherwise be found on the card or not
at all, since the CPU tests run each kernel's plain version. The Pallas
rules are not carried over literally:

- **K001 async-copy pairing.** In each function: every
  ``cp.async.commit_group`` (or a call of a helper or local lambda that
  commits) reaches a ``cp.async.wait_group`` before the function ends, and
  a loop that commits a group also waits on one before its back edge;
  likewise ``wgmma.commit_group`` and ``wgmma.wait_group``. Every barrier
  an ``mbarrier.init`` sets up is waited, in the function or in one it
  hands the barrier to; where the init's arrival count is a literal, the
  sites that arrive on that barrier in the function number as many.
- **K002 shared-memory accounting.** Every
  ``cudaFuncSetAttribute(…MaxDynamicSharedMemorySize…)`` and every launch
  with dynamic shared memory takes its bytes from a ``*_smem_bytes``
  accountant (``csrc/smem_budget.h``), and that accountant names a Python
  twin in ``ops/gpu_kernels.py``, which the planners solve against. The
  dynamic half is :func:`kernel_smem_audit`: the twins against the C++
  accountants at planner-domain shapes, on the CPU through ``g++``
  (:func:`build_smem_budget`) and on the card through each kernel
  library's exports.
- **K003 alignment.** Statically: a kernel whose code issues asynchronous
  copies, TMA loads or ``wgmma`` into its ``extern __shared__`` buffer
  declares it ``__align__(16)`` or wider, or realigns its address.
  Numerically (in the audit, at each plan): the 16-byte ``cp.async`` copies
  of the IVF scans need 16-byte row strides, the TF32 and ``wgmma`` tiles
  need the plan's ``d_pad`` at the kernel's multiple and TMA boxes
  16-byte-aligned strides.
- **K004 CPU/card divergence.** The counterpart of interpret divergence:
  every branch of the Python package on ``device.type == "cpu"``,
  ``is_cuda``, ``torch.cuda.is_available()`` or ``_on_cpu`` that picks a
  kernel's plain version is flagged every time, and justified in the
  baseline; that makes the list of kernel-side paths the CPU tests never
  see an explicit one.
- **K005 barrier divergence.** Pallas's carry-arity rule has no CUDA
  meaning; this rule flags a ``__syncthreads()`` (or ``bar.sync``) under a
  condition that reads ``threadIdx`` or a lane or warp id derived from it:
  threads of one block that skip the barrier hang the others or race.

Suppression and baselines are shared with every other tier: ``//
graftcheck: K00X`` on the flagged line of a CUDA source (``#`` in
Python), or a justified entry in ``raft_tpu_torch/analysis/baseline.json``.
"""

from __future__ import annotations

import ast
import ctypes
import dataclasses
import hashlib
import os
import re
import subprocess
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from raft_tpu_torch.analysis.astutils import ModuleInfo
from raft_tpu_torch.analysis.findings import Finding
from raft_tpu_torch.analysis.rules_ast import PACKAGE, _enclosing_qualname

__all__ = [
    "KERNEL_SCAN_DIRS", "KERNEL_RULES", "CudaSource", "CudaFunction",
    "rule_async_pairing", "rule_smem_accounting", "rule_alignment",
    "rule_cpu_divergence", "rule_barrier_divergence", "run_kernels",
    "kernel_stats", "kernel_smem_audit", "SmemAuditResult",
    "collect_cuda_sources", "python_accountants", "build_smem_budget",
    "SmemQueries", "SWEEP_POINTS", "ROUTE_KERNELS", "launch_limits",
]

#: directories scanned by the CUDA rules, relative to the scan root
KERNEL_SCAN_DIRS = (f"{PACKAGE}/csrc",)
_CUDA_SUFFIXES = (".cu", ".cuh", ".h")

# --------------------------------------------------------------- the text


def _strip(text: str) -> Tuple[str, str]:
    """→ (comments blanked, comments and string contents blanked). Both
    keep every character's offset and every newline, so a position maps to
    the same line in the source; the second is the code's skeleton, where
    braces and parentheses inside ``asm`` strings no longer count."""
    out, skel = list(text), list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            for p in range(i, j):
                out[p] = skel[p] = " "
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            for p in range(i, j):
                if text[p] != "\n":
                    out[p] = skel[p] = " "
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            for p in range(i + 1, min(j, n)):
                if text[p] != "\n":
                    skel[p] = " "
            i = j + 1
        else:
            i += 1
    skel_s = "".join(skel)
    # preprocessor lines carry no code structure (#pragma unroll, #include)
    skel_s = re.sub(r"(?m)^[ \t]*#.*$", lambda m: " " * len(m.group(0)),
                    skel_s)
    return "".join(out), skel_s


def _match(text: str, i: int, open_c: str, close_c: str) -> int:
    """Index of the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_c:
            depth += 1
        elif text[j] == close_c:
            depth -= 1
            if depth == 0:
                return j
    return len(text) - 1


def _split_args(text: str) -> List[str]:
    """Top-level comma-separated pieces of an argument list's text."""
    out, depth, cur = [], 0, []
    for c in text:
        if c in "([{<":
            depth += 1
        elif c in ")]}>":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


@dataclasses.dataclass
class CudaFunction:
    """One function definition of a CUDA source: ``kind`` is "global",
    "device" (``__device__``, also ``__host__ __device__``) or "host";
    ``body`` the [start, end) offsets inside its braces."""

    name: str
    kind: str
    body: Tuple[int, int]


_SCOPE_HEADER = re.compile(
    r"^\s*(?:template\s*<.*>\s*)?(namespace\b|struct\b|class\b|union\b|"
    r"extern\s+\"\s*\"|extern\s+\"C\")", re.S)
_FUNC_TAIL = re.compile(r"\)\s*(?:const|noexcept|override|final|\s)*$", re.S)


class CudaSource:
    """A CUDA file, its comment-free text and skeleton, and its function
    definitions (nested scopes — namespaces, structs — are walked; the
    bodies of functions are not scanned for further definitions)."""

    def __init__(self, path: str, relfile: str):
        self.path = path
        self.relfile = relfile
        with open(path) as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.text, self.skel = _strip(self.source)
        self._line_starts = [0]
        for m in re.finditer("\n", self.source):
            self._line_starts.append(m.end())
        self.functions: List[CudaFunction] = []
        self._scan_scope(0, len(self.skel))

    def line_of(self, offset: int) -> int:
        lo, hi = 0, len(self._line_starts) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._line_starts[mid] <= offset:
                lo = mid
            else:
                hi = mid - 1
        return lo + 1

    def suppressed(self, lineno: int, rule: str) -> bool:
        if 0 < lineno <= len(self.lines):
            line = self.lines[lineno - 1]
            if "graftcheck:" in line:
                return rule in line.split("graftcheck:", 1)[1]
        return False

    def _scan_scope(self, start: int, end: int) -> None:
        sk = self.skel
        i, seg = start, start
        while i < end:
            c = sk[i]
            if c in ";}":
                seg = i + 1
            elif c == "(":
                i = _match(sk, i, "(", ")")
            elif c == "{":
                close = _match(sk, i, "{", "}")
                header = sk[seg:i]
                if _SCOPE_HEADER.match(header):
                    self._scan_scope(i + 1, close)
                elif "(" in header and _FUNC_TAIL.search(header) \
                        and "=" not in header.split("(", 1)[0]:
                    self._add_function(header, i, close)
                i, seg = close, close + 1
            i += 1

    def _add_function(self, header: str, brace: int, close: int) -> None:
        h = header.rstrip()
        last = h.rfind(")")
        depth, j = 0, last
        while j >= 0:
            if h[j] == ")":
                depth += 1
            elif h[j] == "(":
                depth -= 1
                if depth == 0:
                    break
            j -= 1
        m = re.search(r"((?:[A-Za-z_]\w*::)*(?:operator\s*\(\s*\)|"
                      r"[A-Za-z_~]\w*))\s*$", h[:j])
        if not m:
            return
        name = re.sub(r"\s+", "", m.group(1))
        if name in ("if", "for", "while", "switch", "return", "sizeof",
                    "__launch_bounds__"):
            return
        kind = ("global" if "__global__" in h else
                "device" if "__device__" in h else "host")
        self.functions.append(CudaFunction(name, kind, (brace + 1, close)))

    def body_text(self, fn: CudaFunction) -> str:
        return self.text[fn.body[0]:fn.body[1]]

    def body_skel(self, fn: CudaFunction) -> str:
        return self.skel[fn.body[0]:fn.body[1]]


def collect_cuda_sources(root: str, dirs: Iterable[str] = KERNEL_SCAN_DIRS
                         ) -> List[CudaSource]:
    out = []
    for d in dirs:
        base = os.path.join(root, d)
        if not os.path.isdir(base):
            continue
        for fn in sorted(os.listdir(base)):
            if fn.endswith(_CUDA_SUFFIXES):
                path = os.path.join(base, fn)
                out.append(CudaSource(path, os.path.relpath(path, root)))
    return out


# ---------------------------------------------------- primitives, helpers

#: PTX mnemonics of the asynchronous machinery, by event kind
PRIMITIVES = {
    "cp_commit": re.compile(r"cp\.async\.(?:bulk\.)?commit_group"),
    "cp_wait": re.compile(r"cp\.async\.(?:bulk\.)?wait_(?:group|all)"),
    "wg_commit": re.compile(r"wgmma\.commit_group"),
    "wg_wait": re.compile(r"wgmma\.wait_group"),
    "mb_init": re.compile(r"mbarrier\.init"),
    "mb_arrive_tx": re.compile(r"mbarrier\.arrive\.expect_tx"),
    "mb_arrive": re.compile(r"mbarrier\.arrive(?!\.expect_tx)"),
    "mb_wait": re.compile(r"mbarrier\.(?:try_wait|test_wait|wait)"),
}
#: commit kind → the wait kind that retires its groups
PAIRS = {"cp_commit": "cp_wait", "wg_commit": "wg_wait"}
_NAMES = {"cp_commit": "cp.async group", "wg_commit": "wgmma group"}
_ASYNC_USE = re.compile(r"cp\.async|wgmma\.|cp\.async\.bulk")
_CALL = re.compile(r"\b((?:[A-Za-z_]\w*::)*)([A-Za-z_]\w*)\s*"
                   r"(?:<[^;{}()<>]*(?:<[^;{}()<>]*>[^;{}()<>]*)*>)?\s*\(")


def _kinds_in(text: str) -> Set[str]:
    return {k for k, rx in PRIMITIVES.items() if rx.search(text)}


class _Index:
    """Functions of every scanned source by name: each one's primitive
    kinds, and the helpers (device functions holding exactly one kind)."""

    def __init__(self, sources: List[CudaSource]):
        self.by_name: Dict[str, List[Tuple[CudaSource, CudaFunction]]] = {}
        for src in sources:
            for fn in src.functions:
                self.by_name.setdefault(fn.name.split("::")[-1], []).append(
                    (src, fn))
        self.helpers: Dict[str, str] = {}
        for name, defs in self.by_name.items():
            kinds = set()
            for src, fn in defs:
                kinds |= _kinds_in(src.body_text(fn))
            if len(kinds) == 1 and all(fn.kind == "device" for _, fn in defs):
                self.helpers[name] = next(iter(kinds))
        self._uses: Dict[str, Set[str]] = {}

    def uses(self, name: str, _seen: Optional[Set[str]] = None) -> Set[str]:
        """Primitive kinds and async uses a function reaches through the
        calls in its body (names resolved over every scanned source)."""
        if name in self._uses:
            return self._uses[name]
        seen = _seen if _seen is not None else set()
        if name in seen:
            return set()
        seen.add(name)
        out: Set[str] = set()
        for src, fn in self.by_name.get(name, ()):
            text = src.body_text(fn)
            out |= _kinds_in(text)
            if _ASYNC_USE.search(text):
                out.add("async")
            for m in _CALL.finditer(src.body_skel(fn)):
                callee = m.group(2)
                if callee != name and callee in self.by_name:
                    out |= self.uses(callee, seen)
        if _seen is None:
            self._uses[name] = out
        return out


def _events(src: CudaSource, fn: CudaFunction, index: _Index) -> List[tuple]:
    """(offset, kind, first argument) of the asynchronous events in one
    function body: PTX mnemonics, calls of helpers, and calls of local
    lambdas that commit or wait."""
    lo, hi = fn.body
    text, skel = src.text, src.skel
    out = []
    for kind, rx in PRIMITIVES.items():
        for m in rx.finditer(text, lo, hi):
            out.append((m.start(), kind, None))
    lambdas = {}
    for m in re.finditer(r"\bauto\s+([A-Za-z_]\w*)\s*=\s*\[[^\]]*\]\s*"
                         r"\([^)]*\)\s*(?:->\s*[\w:<>]+\s*)?\{", skel[lo:hi]):
        b0 = lo + m.end() - 1
        b1 = _match(skel, b0, "{", "}")
        kinds = _kinds_in(text[b0:b1])
        for c in _CALL.finditer(skel, b0, b1):
            if c.group(2) in index.helpers:
                kinds.add(index.helpers[c.group(2)])
        lambdas[m.group(1)] = kinds & set(PAIRS) | kinds & set(PAIRS.values())
    for m in _CALL.finditer(skel, lo, hi):
        name = m.group(2)
        open_p = m.end() - 1
        close_p = _match(skel, open_p, "(", ")")
        args = _split_args(skel[open_p + 1:close_p])
        first = args[0] if args else None
        if name in index.helpers:
            out.append((m.start(), index.helpers[name], first))
        elif name in lambdas:
            for kind in lambdas[name]:
                out.append((m.start(), kind, None))
    out.sort()
    return out


def _loops(skel: str, lo: int, hi: int) -> List[Tuple[int, int, int]]:
    """(keyword offset, body start, body end) of the braced loops between
    ``lo`` and ``hi``."""
    out = []
    for m in re.finditer(r"\b(for|while)\s*\(", skel[lo:hi]):
        p = lo + m.end() - 1
        q = _match(skel, p, "(", ")")
        r = q + 1
        while r < hi and skel[r].isspace():
            r += 1
        if r < hi and skel[r] == "{":
            out.append((lo + m.start(), r + 1, _match(skel, r, "{", "}")))
    for m in re.finditer(r"\bdo\s*\{", skel[lo:hi]):
        b = lo + m.end() - 1
        out.append((lo + m.start(), b + 1, _match(skel, b, "{", "}")))
    return out


_BARRIER_BASE = re.compile(r"[A-Za-z_]\w*")


def _barrier_base(expr: Optional[str], aliases: Dict[str, str]
                  ) -> Optional[str]:
    """The array or variable a barrier expression names: ``smem_u32(full +
    s)`` → "full"; local aliases (``bar = smem_u32(full + s)``) resolved."""
    if not expr:
        return None
    e = expr
    for wrapper in ("smem_u32", "__cvta_generic_to_shared",
                    "static_cast", "reinterpret_cast"):
        e = re.sub(rf"(?:\w+::)*{wrapper}\s*(?:<[^>]*>)?\s*\(", "(", e)
    names = [n for n in _BARRIER_BASE.findall(e)
             if n not in ("uint32_t", "uint64_t", "int", "const")]
    if not names:
        return None
    return aliases.get(names[0], names[0])


def _aliases(skel: str) -> Dict[str, str]:
    """``name = smem_u32(base + ...)``-style locals → their base."""
    out = {}
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*=\s*(?:\w+::)*smem_u32\s*"
                         r"\(\s*&?\s*([A-Za-z_]\w*)", skel):
        out[m.group(1)] = m.group(2)
    return out


def rule_async_pairing(src: CudaSource, index: Optional[_Index] = None
                       ) -> List[Finding]:
    """K001 over one CUDA source."""
    index = index or _Index([src])
    out: List[Finding] = []

    def emit(fn, offset, msg):
        line = src.line_of(offset)
        if not src.suppressed(line, "K001"):
            out.append(Finding("K001", src.relfile, fn.name, line, msg))

    for fn in src.functions:
        if fn.name in index.helpers:
            continue  # the primitive itself
        events = _events(src, fn, index)
        if not events:
            continue
        for commit, wait in PAIRS.items():
            commits = [e for e in events if e[1] == commit]
            if not commits:
                continue
            last = commits[-1][0]
            if not any(e[1] == wait and e[0] > last for e in events):
                emit(fn, last,
                     f"{_NAMES[commit]} committed here never reaches a "
                     f"{wait.replace('_', '.')} before the function ends: "
                     "its copies may still be landing when the buffer is "
                     "read or the block exits")
            for kw, b0, b1 in _loops(src.skel, *fn.body):
                inner = [e for e in events if b0 <= e[0] < b1]
                c_in = [e for e in inner if e[1] == commit]
                if c_in and not any(e[1] == wait for e in inner):
                    emit(fn, c_in[0][0],
                         f"{_NAMES[commit]} committed inside the loop at "
                         f"line {src.line_of(kw)} with no wait before its "
                         "back edge: groups pile up across iterations")
        skel = src.body_skel(fn)
        aliases = _aliases(skel)
        inits = [e for e in events if e[1] == "mb_init"]
        for off, _, arg in inits:
            base = _barrier_base(arg, aliases)
            if base is None:
                continue
            waited = any(e[1] == "mb_wait"
                         and _barrier_base(e[2], aliases) == base
                         for e in events)
            if not waited:
                for m in _CALL.finditer(src.skel, *fn.body):
                    callee = m.group(2)
                    if callee not in index.by_name or callee == fn.name:
                        continue
                    p = m.end() - 1
                    args = _split_args(src.skel[p + 1:_match(src.skel, p,
                                                              "(", ")")])
                    if base in args and "mb_wait" in index.uses(callee):
                        waited = True
                        break
            if not waited:
                emit(fn, off, f"mbarrier '{base}' initialised here is never "
                              "waited: its phase flips unobserved and the "
                              "consumer reads its stage unguarded")
            p = src.skel.find("(", off)
            args = _split_args(src.skel[p + 1:_match(src.skel, p, "(", ")")])
            count = args[1].strip() if len(args) > 1 else ""
            if re.fullmatch(r"\d+", count):
                arrivals = [e for e in events
                            if e[1] in ("mb_arrive", "mb_arrive_tx")
                            and _barrier_base(e[2], aliases) == base]
                if arrivals and len(arrivals) != int(count):
                    emit(fn, off,
                         f"mbarrier '{base}' expects {count} arrival(s) a "
                         f"phase but {len(arrivals)} site(s) arrive on it: "
                         "the phase never completes or completes early")
    return out


# ------------------------------------------------------- K002: accounting

_SMEM_ACCOUNTANT = re.compile(r"\b(?:[A-Za-z_]\w*::)*([A-Za-z_]\w*_smem_bytes)"
                              r"\s*\(")


def python_accountants(root: str, package: str = PACKAGE) -> Set[str]:
    """Names of the ``*_smem_bytes`` functions of ``ops/gpu_kernels.py``
    (parsed, not imported)."""
    path = os.path.join(root, package, "ops", "gpu_kernels.py")
    try:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return set()
    return {n.name for n in ast.iter_child_nodes(tree)
            if isinstance(n, ast.FunctionDef)
            and n.name.endswith("_smem_bytes")}


def _unwrap(expr: str) -> str:
    e = expr.strip()
    while True:
        m = re.fullmatch(r"(?:static_cast|reinterpret_cast)\s*<[^>]*>\s*"
                         r"\((.*)\)", e, re.S)
        if m:
            e = m.group(1).strip()
            continue
        if e.startswith("(") and _match(e, 0, "(", ")") == len(e) - 1:
            e = e[1:-1].strip()
            continue
        return e


def _resolve_bytes(expr: str, scope: str, file_skel: str, depth: int = 0
                   ) -> str:
    """An identifier's initializer, looked up in the function then the
    file, until an expression that is not a bare name."""
    e = _unwrap(expr)
    if depth > 4 or not re.fullmatch(r"[A-Za-z_]\w*", e):
        return e
    for text in (scope, file_skel):
        m = None
        for m in re.finditer(rf"\b{e}\s*=\s*([^;]+);", text):
            pass
        if m is not None:
            return _resolve_bytes(m.group(1), scope, file_skel, depth + 1)
    return e


def _smem_sites(src: CudaSource) -> List[Tuple[CudaFunction, int, str]]:
    """(host function, offset, bytes expression) of each attribute setting
    and each launch with a dynamic shared-memory argument."""
    out = []
    for fn in src.functions:
        lo, hi = fn.body
        skel = src.skel
        for m in re.finditer(r"\bcudaFuncSetAttribute\s*\(", skel[lo:hi]):
            p = lo + m.end() - 1
            args = _split_args(skel[p + 1:_match(skel, p, "(", ")")])
            if len(args) >= 3 and "MaxDynamicSharedMemorySize" in args[1]:
                out.append((fn, lo + m.start(), args[2]))
        for m in re.finditer(r"<<<(.*?)>>>", skel[lo:hi], re.S):
            args = _split_args(m.group(1))
            if len(args) >= 3:
                out.append((fn, lo + m.start(), args[2]))
    return out


def rule_smem_accounting(src: CudaSource,
                         twins: Optional[Set[str]] = None) -> List[Finding]:
    """K002 (static facet) over one CUDA source."""
    out = []
    for fn, off, expr in _smem_sites(src):
        line = src.line_of(off)
        if src.suppressed(line, "K002"):
            continue
        resolved = _resolve_bytes(expr, src.body_skel(fn), src.skel)
        if re.fullmatch(r"0+[uUlL]*", resolved):
            continue
        names = _SMEM_ACCOUNTANT.findall(resolved)
        if not names:
            out.append(Finding(
                "K002", src.relfile, fn.name, line,
                f"dynamic shared memory `{_unwrap(expr)}` (= "
                f"`{' '.join(resolved.split())[:80]}`) does not come from a "
                "*_smem_bytes accountant: the planners cannot see what the "
                "launch asks for"))
            continue
        if twins is not None:
            for name in names:
                if name not in twins:
                    out.append(Finding(
                        "K002", src.relfile, fn.name, line,
                        f"accountant {name} has no Python twin in "
                        "ops/gpu_kernels.py: the planners solve against "
                        "another formula than the launch uses"))
    return out


# ------------------------------------------------------- K003: alignment


def rule_alignment(src: CudaSource, index: Optional[_Index] = None
                   ) -> List[Finding]:
    """K003 (static facet): a kernel that issues asynchronous copies, TMA
    loads or ``wgmma`` keeps its ``extern __shared__`` buffer 16-byte
    aligned (``__align__(N)``, N >= 16, or a realignment of its address)."""
    index = index or _Index([src])
    out = []
    for fn in src.functions:
        if fn.kind != "global":
            continue
        body = src.body_skel(fn)
        text = src.body_text(fn)
        uses = "async" in index.uses(fn.name.split("::")[-1]) or \
            _ASYNC_USE.search(text)
        if not uses:
            continue
        for m in re.finditer(r"extern\s+__shared__\s+(.*?)\b([A-Za-z_]\w*)"
                             r"\s*\[\s*\]", body):
            quals, name = m.group(1), m.group(2)
            al = re.search(r"__align__\s*\(\s*(\d+)\s*\)", quals)
            if al and int(al.group(1)) >= 16:
                continue
            if re.search(rf"reinterpret_cast\s*<\s*uintptr_t\s*>\s*\(\s*"
                         rf"{name}\s*\).*?&\s*~", body, re.S):
                continue
            line = src.line_of(fn.body[0] + m.start())
            if src.suppressed(line, "K003"):
                continue
            out.append(Finding(
                "K003", src.relfile, fn.name, line,
                f"extern __shared__ '{name}' is only guaranteed its element's "
                "alignment, but this kernel issues 16-byte asynchronous "
                "copies, TMA loads or wgmma into shared memory: declare it "
                "__align__(16) or realign its address"))
    return out


# -------------------------------------------- K005: barrier divergence

_BARRIER = re.compile(r"__syncthreads\s*\(|\bbar\.sync\b|\bbarrier\.sync\b")


def _tainted(skel: str) -> Set[str]:
    """Locals derived from threadIdx (lane, warp, tid, ...)."""
    names: Set[str] = set()
    decl = re.compile(r"\b(?:const\s+)?(?:int|unsigned|uint32_t|int32_t|"
                      r"long\s+long|auto|size_t)\s+([^;()]*?=[^;]*);")
    changed = True
    while changed:
        changed = False
        for m in decl.finditer(skel):
            for piece in _split_args(m.group(1)):
                if "=" not in piece:
                    continue
                lhs, rhs = piece.split("=", 1)
                lhs = lhs.strip()
                if not re.fullmatch(r"[A-Za-z_]\w*", lhs) or lhs in names:
                    continue
                ids = set(re.findall(r"[A-Za-z_]\w*", rhs))
                if "threadIdx" in rhs or ids & names:
                    names.add(lhs)
                    changed = True
    return names


def rule_barrier_divergence(src: CudaSource) -> List[Finding]:
    """K005 over one CUDA source: a block barrier under a condition that
    reads the thread's index."""
    out = []
    for fn in src.functions:
        if fn.kind not in ("global", "device"):
            continue
        lo, hi = fn.body
        skel, text = src.skel, src.text
        tainted = _tainted(skel[lo:hi])
        for m in re.finditer(r"\b(if|while|for)\s*\(", skel[lo:hi]):
            p = lo + m.end() - 1
            q = _match(skel, p, "(", ")")
            cond = skel[p + 1:q]
            live = tainted
            if m.group(1) == "for":
                parts = cond.split(";")
                if len(parts) == 3:
                    cond = parts[1]
                    # a name the loop declares afresh from an index-free
                    # value shadows the outer, derived one
                    for piece in _split_args(parts[0]):
                        lhs, _, rhs = piece.partition("=")
                        name = lhs.split()[-1] if lhs.split() else ""
                        if rhs and "threadIdx" not in rhs and not set(
                                re.findall(r"[A-Za-z_]\w*", rhs)) & tainted:
                            live = live - {name}
            ids = set(re.findall(r"[A-Za-z_]\w*", cond))
            if "threadIdx" not in cond and not ids & live:
                continue
            r = q + 1
            while r < hi and skel[r].isspace():
                r += 1
            end = _match(skel, r, "{", "}") if skel[r:r + 1] == "{" else \
                skel.find(";", r)
            body = text[r:end + 1]
            b = _BARRIER.search(body)
            if not b:
                continue
            line = src.line_of(r + b.start())
            if src.suppressed(line, "K005") or src.suppressed(
                    src.line_of(lo + m.start()), "K005"):
                continue
            out.append(Finding(
                "K005", src.relfile, fn.name, line,
                f"block barrier under a condition on the thread's index "
                f"(`{' '.join(cond.split())[:60]}`, line "
                f"{src.line_of(lo + m.start())}): threads that skip it hang "
                "the block or race past it"))
    return out


# ---------------------------------------- K004: CPU/card divergence (py)

#: device tests that decide between the card and the CPU
_DEVICE_TEST_CALLS = ("_on_cpu", "torch.cuda.is_available")


def _is_device_test(mod: ModuleInfo, test: ast.AST) -> Optional[str]:
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr == "is_cuda":
            return "is_cuda"
        if isinstance(n, ast.Compare):
            sides = [n.left, *n.comparators]
            if any(isinstance(s, ast.Attribute) and s.attr == "type"
                   for s in sides) and any(
                    isinstance(s, ast.Constant) and s.value in ("cpu", "cuda")
                    for s in sides):
                return "device.type"
        if isinstance(n, ast.Call):
            dotted = mod.resolve(n.func) or ""
            for name in _DEVICE_TEST_CALLS:
                if dotted == name or dotted.endswith("." + name) \
                        or dotted == name.rsplit(".", 1)[-1]:
                    return name
    return None


def _calls_plain(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name.endswith("_plain"):
                return True
    return False


def rule_cpu_divergence(mod: ModuleInfo) -> List[Finding]:
    """K004 over one Python module of the package: a branch on the device
    that picks a kernel's plain version."""
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        what = _is_device_test(mod, node.test)
        if what is None:
            continue
        branches = ([*node.body, *node.orelse] if isinstance(node, ast.If)
                    else [node.body, node.orelse])
        if not any(_calls_plain(b) for b in branches):
            continue
        if mod.suppressed(node.lineno, "K004"):
            continue
        out.append(Finding(
            "K004", mod.relfile, _enclosing_qualname(mod, node), node.lineno,
            f"branch on the device ({what}) picks a kernel's plain version: "
            "the CPU tests run this side only, the kernel side runs on the "
            "card alone (keep it enumerated: baseline with justification)"))
    return out


# ------------------------------------------------------------ entrypoints

KERNEL_RULES = (rule_async_pairing, rule_smem_accounting, rule_alignment,
                rule_barrier_divergence)


def _python_modules(root: str, package: str) -> Tuple[list, list]:
    from raft_tpu_torch.analysis import collect_modules
    return collect_modules(root, (package,))


def run_kernels(root: str, rules: Optional[Iterable] = None,
                package: str = PACKAGE) -> List[Finding]:
    """K001–K005 over ``<package>/csrc`` and (K004) the package's Python
    modules at ``root``."""
    sources = collect_cuda_sources(root, (f"{package}/csrc",))
    index = _Index(sources)
    twins = python_accountants(root, package)
    wanted = set(rules) if rules is not None else None
    findings: List[Finding] = []
    for src in sources:
        for rule in KERNEL_RULES:
            if wanted is not None and rule not in wanted:
                continue
            if rule is rule_smem_accounting:
                findings.extend(rule(src, twins))
            elif rule is rule_barrier_divergence:
                findings.extend(rule(src))
            else:
                findings.extend(rule(src, index))
    if wanted is None or rule_cpu_divergence in wanted:
        modules, errors = _python_modules(root, package)
        findings.extend(errors)
        for mod in modules:
            findings.extend(rule_cpu_divergence(mod))
    seen = set()
    unique: List[Finding] = []
    for f in findings:
        ident = (f.key, f.line, f.message)
        if ident not in seen:
            seen.add(ident)
            unique.append(f)
    unique.sort(key=lambda f: (f.file, f.line, f.rule))
    return unique


def kernel_stats(root: str, package: str = PACKAGE) -> Dict[str, int]:
    """What the scan saw — the non-vacuity counters (a parser regression
    must not pass as "zero findings")."""
    sources = collect_cuda_sources(root, (f"{package}/csrc",))
    index = _Index(sources)
    kernels = async_sites = launches = accounted = 0
    for src in sources:
        for fn in src.functions:
            if fn.kind == "global":
                kernels += 1
            if fn.name not in index.helpers:
                async_sites += len(_events(src, fn, index))
        sites = _smem_sites(src)
        launches += len(re.findall(r"<<<", src.skel))
        accounted += sum(1 for fn, _, e in sites if _SMEM_ACCOUNTANT.search(
            _resolve_bytes(e, src.body_skel(fn), src.skel)))
    return {"sources": len(sources), "kernels": kernels,
            "async_sites": async_sites, "launches": launches,
            "accounted_smem_sites": accounted}


# -------------------------------------------- the C++ accountants, built


def build_smem_budget(root: str, out_dir: Optional[str] = None,
                      package: str = PACKAGE) -> str:
    """Build ``csrc/smem_budget.h`` alone with the host's C++ compiler into
    a small library (default: ``build/<package>/`` under ``root``), keyed
    by a hash of the header, the command and the compiler's version; →
    the library's path."""
    header = os.path.join(root, package, "csrc", "smem_budget.h")
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, "-std=c++17", "-O1", "-x", "c++", "-shared", "-fPIC",
           "-I", os.path.dirname(header)]
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join(cmd).encode() + version.encode())
    with open(header, "rb") as f:
        h.update(f.read())
    out_dir = out_dir or os.path.join(root, "build", package)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"smem_budget-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run([*cmd, "-o", tmp, "-"],
                       input='#include "smem_budget.h"\n', text=True,
                       check=True, capture_output=True)
        os.replace(tmp, path)
    return path


#: the accountants' C signatures (all int arguments)
ACCOUNTANT_ARITY = {
    "l2_topk_tc_smem_bytes": 3, "l2_topk_fma_smem_bytes": 1,
    "ivf_topk_smem_bytes": 2, "ivf_topk_per_query_smem_bytes": 2,
    "ivf_scan_smem_bytes": 1, "ivf_group_smem_bytes": 1,
    "select_k_smem_bytes": 1, "pq_topk_smem_bytes": 3,
    "pq_grouped_smem_bytes": 4, "cagra_topk_smem_bytes": 4,
    "cagra_warp_smem_bytes": 4, "l2_argmin_smem_bytes": 3,
}


class SmemQueries:
    """The ``rtt_<accountant>`` exports of a library built from
    ``smem_budget.h``: the g++ build of the header, or any kernel library
    on the card. Calling ``q(name, *args)`` gives the C++ bytes."""

    def __init__(self, lib):
        self.lib = ctypes.CDLL(lib) if isinstance(lib, str) else lib
        self._fns: Dict[str, Callable] = {}

    def __call__(self, name: str, *args) -> int:
        fn = self._fns.get(name)
        if fn is None:
            fn = getattr(self.lib, f"rtt_{name}")
            fn.argtypes = [ctypes.c_int] * ACCOUNTANT_ARITY[name]
            fn.restype = ctypes.c_longlong
            self._fns[name] = fn
        return int(fn(*(int(a) for a in args)))


# ------------------------------------------ K002/K003: the dynamic sweep

#: the planner-domain shapes of each kernel: the main path's
#: (``chip_smoke.py``: 10,000 queries over 1M × 128 rows, k = 10, 1,024
#: lists of 1,456 slots, 32 probes), the served bucket 8, and the largest
#: the planner admits
SWEEP_POINTS = {
    "fused_l2_topk": [dict(m=10_000, n=1_000_000, d=128, k=10),
                      dict(m=8, n=1_000_000, d=128, k=10),
                      dict(m=10_000, n=1_000_000, d=128, k=1024)],
    "fused_ivf_topk": [dict(nq=10_000, n_probes=32, n_lists=1024, pad=1456,
                            rot=128, k=10, elem_bytes=4),
                       dict(nq=8, n_probes=32, n_lists=1024, pad=1456,
                            rot=128, k=10, elem_bytes=2),
                       dict(nq=10_000, n_probes=32, n_lists=1024, pad=1456,
                            rot=128, k=1024, elem_bytes=4)],
    "select_k": [dict(n=1024, k=32), dict(n=320, k=10),
                 dict(n=1024, k=1024)],
    "fused_pq_topk": [dict(nq=10_000, n_probes=32, n_lists=1024, pad=1456,
                           pq_dim=64, pq_len=2, k=10),
                      dict(nq=8, n_probes=32, n_lists=1024, pad=1456,
                           pq_dim=64, pq_len=2, k=10),
                      dict(nq=10_000, n_probes=32, n_lists=1024, pad=1456,
                           pq_dim=64, pq_len=2, k=1024)],
    "fused_cagra_topk": [dict(itopk=64, dim=128, width=1, degree=32),
                         dict(itopk=64, dim=128, width=1, degree=32),
                         dict(itopk=1024, dim=128, width=4, degree=64)],
    "fused_l2_argmin": [dict(m=1_000_000, n=1024, d=128),
                        dict(m=8, n=1024, d=128),
                        dict(m=1_000_000, n=1024, d=2048)],
    "ivf_scan": [dict(n_pairs=440 * 32, n_lists=1024, rot=128,
                      elem_bytes=4),
                 dict(n_pairs=8 * 32, n_lists=1024, rot=128, elem_bytes=2),
                 dict(n_pairs=10_000 * 1024, n_lists=24_575, rot=100,
                      elem_bytes=1)],
    "ring_shift": [dict(ranks=4), dict(ranks=4), dict(ranks=8)],
}
#: the served bucket 8's row of each kernel (SWEEP_POINTS[...][1]) and the
#: label of each point
POINT_LABELS = ("main", "bucket8", "largest")


@dataclasses.dataclass
class SmemAuditResult:
    """One (kernel, point) of the sweep: the plan's route, its accountant's
    bytes by the Python twin and by the C++ one (None when no library was
    given), the dynamic bytes a block takes (``block_bytes``: the
    accountant's, or warps × a warp's slice on CAGRA's warp route), the
    limit, the block's threads and what the alignment check found."""

    kernel: str
    point: str
    route: str
    accountant: str
    args: tuple
    python_bytes: int
    cxx_bytes: Optional[int]
    block_bytes: int
    limit: int
    threads: int
    alignment: List[str]
    ok: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _plan_point(gk, kernel: str, p: dict, n_sm: int):
    """→ (route, accountant name, C args, Python bytes, threads a block,
    alignment problems, dynamic bytes a block) of one kernel at one
    point."""
    bad: List[str] = []
    if kernel == "fused_l2_topk":
        plan = gk.plan_fused_topk(p["m"], p["n"], p["d"], p["k"], n_sm)
        if plan.route == "tc":
            if plan.d_pad % gk.TC_BK or (plan.d_pad * 4) % 16:
                bad.append(f"d_pad {plan.d_pad} is not a multiple of the "
                           f"{gk.TC_BK}-float k-slice with 16-byte rows")
            if plan.split_len % gk.TC_BN:
                bad.append(f"split_len {plan.split_len} cuts a "
                           f"{gk.TC_BN}-row TMA box")
            args = (p["k"], plan.stages, plan.wgs)
            return ("tc", "l2_topk_tc_smem_bytes", args, plan.smem,
                    128 * plan.wgs + 32, bad)
        return ("fma", "l2_topk_fma_smem_bytes", (p["k"],), plan.smem, 256,
                bad)
    if kernel == "fused_ivf_topk":
        plan = gk.plan_fused_ivf(p["nq"], p["n_probes"], p["n_lists"],
                                 p["pad"], p["rot"], p["k"], p["elem_bytes"],
                                 n_sm)
        bad += _ivf_copy_alignment(gk, p["rot"], p["elem_bytes"])
        if plan.route == "grouped":
            return ("grouped", "ivf_topk_smem_bytes",
                    (p["k"], p["elem_bytes"]), plan.smem, 128, bad)
        return ("per_query", "ivf_topk_per_query_smem_bytes",
                (p["rot"], p["k"]), plan.smem, 256, bad)
    if kernel == "select_k":
        plan = gk.plan_select_k(p["n"], p["k"])
        if plan.route == "register":
            return ("register", "", (), 0, 128, bad)
        return ("shared", "select_k_smem_bytes", (p["k"],),
                gk.select_k_smem_bytes(p["k"]), 256, bad)
    if kernel == "fused_pq_topk":
        plan = gk.plan_fused_pq(p["nq"], p["n_probes"], p["n_lists"],
                                p["pad"], p["pq_dim"], p["pq_len"], p["k"])
        if plan.route == "grouped":
            return ("grouped", "pq_grouped_smem_bytes",
                    (p["pq_dim"], p["pq_len"], plan.warps,
                     int(plan.res_chunked)), plan.smem, 32 * plan.warps, bad)
        return ("per_query", "pq_topk_smem_bytes",
                (p["pq_dim"], p["pq_len"], p["k"]), plan.smem, 256, bad)
    if kernel == "fused_cagra_topk":
        plan = gk.plan_fused_cagra(p["itopk"], p["dim"], p["width"],
                                   p["degree"])
        args = (p["itopk"], p["dim"], p["width"], p["degree"])
        if plan.route == "warp":
            per_warp = gk.cagra_warp_smem_bytes(*args)
            if plan.smem != plan.warps * per_warp:
                bad.append("the warp route's bytes are not warps × slice")
            return ("warp", "cagra_warp_smem_bytes", args, per_warp,
                    32 * plan.warps, bad)
        return ("block", "cagra_topk_smem_bytes", args, plan.smem, 128, bad)
    if kernel == "fused_l2_argmin":
        plan = gk.plan_fused_argmin(p["m"], p["n"], p["d"])
        if plan.d_pad % gk.TC_BK or (plan.d_pad * 4) % 16:
            bad.append(f"d_pad {plan.d_pad} is not a multiple of the "
                       f"{gk.TC_BK}-float k-slice with 16-byte rows")
        return (plan.route, "l2_argmin_smem_bytes",
                (int(plan.route == "resident"), plan.d_pad, plan.stages),
                plan.smem, 288, bad)
    if kernel == "ivf_scan":
        bad += _ivf_copy_alignment(gk, p["rot"], p["elem_bytes"])
        return ("grouped", "ivf_scan_smem_bytes", (p["elem_bytes"],),
                gk.ivf_scan_smem_bytes(p["elem_bytes"]), 128, bad)
    if kernel == "ring_shift":
        return ("copy", "", (), 0, 256, bad)
    raise KeyError(kernel)


def _ivf_copy_alignment(gk, rot: int, elem_bytes: int) -> List[str]:
    """The IVF scans copy four elements at a time (a 16-byte ``cp.async``
    over f32 rows) when ``rot`` is a multiple of four, else one: both the
    list rows (``rot`` elements) and the staged rows (``IVF_STAGE_ROW``)
    must then start on a copy's boundary."""
    v = 4 if rot % 4 == 0 else 1
    copy = v * elem_bytes
    bad = []
    if copy >= 4:
        if (rot * elem_bytes) % copy:
            bad.append(f"list rows of {rot * elem_bytes} bytes break "
                       f"{copy}-byte cp.async copies")
        if (gk.IVF_STAGE_ROW * elem_bytes) % copy:
            bad.append(f"staged rows of {gk.IVF_STAGE_ROW * elem_bytes} "
                       f"bytes break {copy}-byte cp.async copies")
    return bad


def kernel_smem_audit(queries=None, points: Optional[dict] = None,
                      n_sm: int = 132, limit: Optional[int] = None
                      ) -> Tuple[List[SmemAuditResult], List[Finding]]:
    """The dynamic half of K002 and K003: each kernel's plan at its sweep
    points (default :data:`SWEEP_POINTS`), its Python accountant against
    the C++ one (``queries``, when given: one :class:`SmemQueries` for
    every kernel, or a dict of them by kernel, each kernel's own library on
    the card), the bytes against the limit (default
    ``gpu_kernels.SMEM_LIMIT``, the card's opt-in maximum) and the plan's
    alignment. Imports the port's ``ops.gpu_kernels`` (torch, no card). →
    (results, findings)."""
    from raft_tpu_torch.ops import gpu_kernels as gk

    limit = gk.SMEM_LIMIT if limit is None else int(limit)
    points = SWEEP_POINTS if points is None else points
    results: List[SmemAuditResult] = []
    findings: List[Finding] = []
    for kernel, pts in points.items():
        for label, p in zip(POINT_LABELS, pts):
            route, acc, args, py_bytes, threads, bad = _plan_point(
                gk, kernel, p, n_sm)
            block = py_bytes * (threads // 32 if route == "warp" else 1)
            cxx = None
            q = queries.get(kernel) if isinstance(queries, dict) \
                else queries
            if acc and q is not None:
                cxx = q(acc, *args)
            ok = True
            where = f"{kernel}@{label}"
            if cxx is not None and cxx != py_bytes:
                ok = False
                findings.append(Finding(
                    "K002", "smem-audit", f"{kernel}.{acc}", 0,
                    f"{where}: the Python accountant gives {py_bytes} bytes, "
                    f"the C++ one {cxx}: the planner and the launch disagree"))
            if block > limit:
                ok = False
                findings.append(Finding(
                    "K002", "smem-audit", f"{kernel}.{acc}", 0,
                    f"{where}: the plan asks {block} bytes of shared "
                    f"memory a block, above the limit {limit}"))
            for problem in bad:
                ok = False
                findings.append(Finding("K003", "smem-audit",
                                        f"{kernel}.{route}", 0,
                                        f"{where}: {problem}"))
            results.append(SmemAuditResult(
                kernel, label, route, acc, tuple(args), py_bytes, cxx, block,
                limit, threads, bad, ok))
    return results, findings


#: the kernel each (kernel, route) of a plan launches, by the identifier
#: ptxas reports it under (``obs.costs.ptxas_figures``)
ROUTE_KERNELS = {
    ("fused_l2_topk", "tc"): "tc_topk_kernel",
    ("fused_l2_topk", "fma"): "fma_topk_kernel",
    ("fused_ivf_topk", "grouped"): "grouped_topk_kernel",
    ("fused_ivf_topk", "per_query"): "fused_ivf_topk_kernel",
    ("select_k", "register"): "select_reg_kernel",
    ("select_k", "shared"): "select_rows_kernel",
    ("fused_pq_topk", "grouped"): "grouped_pq_kernel",
    ("fused_pq_topk", "per_query"): "fused_pq_topk_kernel",
    ("fused_cagra_topk", "warp"): "fused_cagra_warp_kernel",
    ("fused_cagra_topk", "block"): "fused_cagra_kernel",
    ("fused_l2_argmin", "resident"): "tc_argmin_kernel",
    ("fused_l2_argmin", "scratch"): "tc_argmin_kernel",
    ("ivf_scan", "grouped"): "ivf_scan_kernel",
    ("ring_shift", "copy"): "ring_shift_kernel",
}
#: a block's register file (65,536 32-bit registers on Hopper)
REGISTERS_PER_BLOCK = 65536


def launch_limits(results: List[SmemAuditResult], ptxas: Dict[str, dict],
                  smem_optin: int) -> Tuple[List[dict], List[Finding]]:
    """The card's half of the sweep: for each result, the route's kernel
    in its library's ptxas report (``ptxas[kernel]``: name → figures, every
    template instance of it), its static shared memory plus the plan's
    dynamic bytes against ``smem_optin``
    (``shared_memory_per_block_optin``), its registers × the block's
    threads against the register file, and its spills. → (rows,
    findings)."""
    rows, findings = [], []
    for r in results:
        name = ROUTE_KERNELS[(r.kernel, r.route)]
        figs = [f for k, f in ptxas.get(r.kernel, {}).items()
                if k.split("#")[0] == name]
        where = f"{r.kernel}@{r.point}"
        if not figs:
            findings.append(Finding(
                "K002", "smem-audit", f"{r.kernel}.{r.route}", 0,
                f"{where}: no ptxas figures for {name} in the library's "
                "report"))
            continue
        static = max(f.get("static_smem", 0) for f in figs)
        regs = max(f.get("registers", 0) for f in figs)
        spills = max(f.get("spill_stores", 0) for f in figs)
        row = {"kernel": r.kernel, "point": r.point, "route": r.route,
               "ptxas_kernel": name, "instances": len(figs),
               "accountant": r.accountant, "accountant_bytes": r.python_bytes,
               "cxx_bytes": r.cxx_bytes, "dynamic_smem": r.block_bytes,
               "static_smem": static,
               "smem_limit": smem_optin, "registers": regs,
               "threads": r.threads, "spill_stores": spills,
               "alignment": r.alignment}
        row["ok"] = (static + r.block_bytes <= smem_optin
                     and regs * r.threads <= REGISTERS_PER_BLOCK)
        if static + r.block_bytes > smem_optin:
            findings.append(Finding(
                "K002", "smem-audit", f"{r.kernel}.{r.route}", 0,
                f"{where}: static {static} + dynamic {r.block_bytes} bytes "
                f"of shared memory exceed the card's {smem_optin}"))
        if regs * r.threads > REGISTERS_PER_BLOCK:
            findings.append(Finding(
                "K002", "smem-audit", f"{r.kernel}.{r.route}", 0,
                f"{where}: {regs} registers × {r.threads} threads exceed "
                f"the block's {REGISTERS_PER_BLOCK}"))
        rows.append(row)
    return rows, findings
