"""AST hazard linter for the PyTorch / CUDA pitfalls this port has hit.

Every rule encodes a failure mode the port met on its way to one H100
(``CHANGES.md``, ROADMAP "Traps"); the CUDA rule reads ``csrc/*.cu``:

====== ===========================  ===========================================
code   name                         catches
====== ===========================  ===========================================
RT001  host-sync-in-captured        ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                                    ``.numpy()``, ``int()`` / ``float()`` /
                                    ``bool()`` over a torch result,
                                    ``torch.cuda.synchronize()`` inside a
                                    captured function: a host read in a step
                                    unit breaks its CUDA graph (or stalls an
                                    eager step on the card)
RT002  host-tensor-in-captured      ``torch.tensor`` / ``torch.as_tensor`` /
                                    ``torch.from_numpy`` inside a captured
                                    function: a blocking host-to-device copy
                                    on every step (C1, fixed in PR 16; keep
                                    constants in ``device.const``)
RT003  side-effect-in-captured      ``print`` / ``warnings.warn`` inside a
                                    captured function: runs once, at the
                                    capture, not on each replay
RT004  kernel-dtype                 tensor constructors without ``dtype=`` in
                                    ``kernels/``: the element type then
                                    follows the fill value or the default
                                    dtype, not the payload
RT005  float-divisor                ``/`` by a float literal or ``float(...)``
                                    in ``core/`` and ``serve/``: on CUDA,
                                    PyTorch divides a tensor by a Python
                                    float as a multiply by its reciprocal;
                                    divide by a 0-dim tensor of the working
                                    dtype (``device.const``)
RT006  nondeterministic-accumulate  ``index_add_`` / ``scatter_add_`` /
                                    ``scatter_reduce`` / ``index_put_(...,
                                    accumulate=True)``, and ``index_select`` /
                                    ``gather`` / advanced indexing by a
                                    tensor (their backwards are index-adds)
                                    in ``core/``, ``serve/``,
                                    ``resilience/`` and ``models/``: CUDA's
                                    atomic adds break the bitwise bars
                                    (PR 25's ``_GatherRows``)
RT007  unsynced-timing-span         a ``time.perf_counter()`` / ``time()``
                                    span over device work whose stop read
                                    has no ``synchronize`` (device, stream or
                                    event), host read or obs span in the
                                    window: the clock measures the launch
RT008  bare-except-in-recovery      ``except:`` / ``except Exception`` whose
                                    handler neither re-raises nor records the
                                    error (no ``raise``, and no call that
                                    warns / logs / prints / records)
RT009  unchecked-kernel-launch      a ``<<<...>>>`` launch in ``*.cu`` that no
                                    ``cudaGetLastError`` /
                                    ``cudaPeekAtLastError`` follows before
                                    the next launch or the function's end: a
                                    failed launch would pass for a kernel
                                    that ran
====== ===========================  ===========================================

Suppression: append ``# noqa`` (all rules) or ``# noqa: RT005, RT006``
(``// noqa: RT009`` in CUDA) to the flagged line, with the reason beside
it.  The captured context is a deliberate under-approximation: a function
counts as captured when it is handed to a capture (``StepFns`` members,
``BlockGraphs.run`` / the pipelines' and engine's ``_issue``,
``torch.cuda.make_graphed_callables``, a call inside ``with
torch.cuda.graph(...)``), is the ``forward`` / ``backward`` of a
``torch.autograd.Function``, or is decorated with one of those; helpers
only ever called from captured code are not chased, so host-side code
never gets a false positive.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["RULES", "Rule", "Diagnostic", "lint_paths", "lint_file",
           "iter_source_files"]


@dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str


RULES: Dict[str, Rule] = {r.code: r for r in (
    Rule("RT001", "host-sync-in-captured",
         "host read or device sync inside a captured function"),
    Rule("RT002", "host-tensor-in-captured",
         "tensor made from host data inside a captured function"),
    Rule("RT003", "side-effect-in-captured",
         "host side effect inside a captured function"),
    Rule("RT004", "kernel-dtype",
         "tensor constructor without explicit dtype in kernel code"),
    Rule("RT005", "float-divisor",
         "division by a Python float on a device path"),
    Rule("RT006", "nondeterministic-accumulate",
         "atomic accumulate (or an index-add backward) on a bitwise path"),
    Rule("RT007", "unsynced-timing-span",
         "timing span over device work stops the clock without a sync"),
    Rule("RT008", "bare-except-in-recovery",
         "broad except swallows the error without re-raise or logging"),
    Rule("RT009", "unchecked-kernel-launch",
         "CUDA kernel launch with no launch-error read after it"),
)}


@dataclass(frozen=True)
class Diagnostic:
    path: str
    line: int
    col: int
    code: str
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"[{RULES[self.code].name}] {self.message}")


_NOQA_RE = re.compile(r"(?:#|//)\s*noqa(?::\s*(?P<codes>RT\d{3}"
                      r"(?:\s*,\s*RT\d{3})*))?")

# calls that hand a function to a capture: every argument naming a
# function is a step unit
_CAPTURE_BINDERS = {"StepFns", "make_graphed_callables", "_issue"}
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
_TENSOR_REDUCTIONS = {"sum", "max", "min", "mean", "any", "all", "norm",
                      "prod", "amax", "amin", "count_nonzero", "abs"}
_HOST_TENSORS = {"tensor", "as_tensor", "from_numpy"}
_CTORS = {"zeros", "ones", "empty", "full", "arange", "tensor", "rand",
          "randn", "randint", "linspace", "eye"}
_ACCUMULATES = {"index_add_", "index_add", "scatter_add_", "scatter_add",
                "scatter_reduce", "scatter_reduce_", "index_reduce",
                "index_reduce_"}
_INDEX_ADD_BACKWARD = {"index_select", "gather"}
_TIME_READS = {"time", "perf_counter", "monotonic"}
# device work a timing span can cover, beside torch calls: the port's
# entry points that launch on the card
_DEVICE_ENTRIES = {"simulate", "run_block", "serve_wave", "prefill",
                   "decode_step", "loss_fn", "backward", "fwd", "rev",
                   "exchange", "run_training", "step"}
_SYNCS = {"synchronize", "elapsed_time", "span", "time_fn"} | _HOST_READS
_BUILTINS = {"print", "len", "range", "int", "float", "str", "bool", "list",
             "dict", "tuple", "set", "min", "max", "sum", "sorted", "abs",
             "round", "enumerate", "zip", "isinstance", "getattr", "repr"}


def _qual(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain ('torch.cuda.synchronize'),
    else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last(call: ast.Call) -> str:
    """The called name's last part: ``x.item()`` -> ``item``."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return _qual(call.func) or ""


def _scope_nodes(scope: ast.AST) -> List[ast.AST]:
    """Descendants of ``scope``, not descending into nested functions."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        out.append(node)
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))
    return out


# --------------------------------------------------------------------------
# per-file model
# --------------------------------------------------------------------------

class _FileModel:
    """Imports and captured functions of one parsed module."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.parts = Path(path).parts
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.torch: Set[str] = set()
        self.time_mods: Set[str] = set()
        self.time_funcs: Set[str] = set()
        self._collect_imports()
        self.funcs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs.setdefault(node.name, []).append(node)
        self.captured = self._collect_captured()

    def in_tree(self, *names: str) -> bool:
        return any(n in self.parts for n in names)

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" or a.name.startswith("torch."):
                        self.torch.add(a.asname or "torch")
                    elif a.name == "time":
                        self.time_mods.add(a.asname or "time")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in _TIME_READS:
                        self.time_funcs.add(a.asname or a.name)

    def is_torch(self, fq: Optional[str]) -> bool:
        return bool(fq) and fq.split(".")[0] in self.torch

    def _fn_names_of_arg(self, arg: ast.AST) -> List[str]:
        """Functions an argument names: ``f``, ``self.f``,
        ``partial(f, ...)``."""
        if isinstance(arg, ast.Name):
            return [arg.id]
        if isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name) \
                and arg.value.id in ("self", "cls"):
            return [arg.attr]
        if isinstance(arg, ast.Call) and \
                (_qual(arg.func) or "").split(".")[-1] == "partial":
            return [n for a in arg.args[:1] for n in self._fn_names_of_arg(a)]
        return []

    def _is_binder(self, call: ast.Call) -> bool:
        fq = _qual(call.func) or ""
        last = fq.split(".")[-1]
        return last in _CAPTURE_BINDERS or fq.endswith("graphs.run")

    def _collect_captured(self) -> List[ast.AST]:
        names: Set[str] = set()
        nodes: List[ast.AST] = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and self._is_binder(node):
                for a in list(node.args) + [k.value for k in node.keywords]:
                    names.update(self._fn_names_of_arg(a))
                    if isinstance(a, ast.Lambda):
                        nodes.append(a)
            elif isinstance(node, ast.With) and any(
                    (_qual(i.context_expr.func) or "").endswith("cuda.graph")
                    for i in node.items
                    if isinstance(i.context_expr, ast.Call)):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        names.update(self._fn_names_of_arg(sub.func))
            elif isinstance(node, ast.ClassDef) and any(
                    (_qual(b) or "").split(".")[-1] == "Function"
                    for b in node.bases):
                nodes.extend(f for f in node.body
                             if isinstance(f, ast.FunctionDef)
                             and f.name in ("forward", "backward"))
        for defs in self.funcs.values():
            for fn in defs:
                for dec in fn.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if (_qual(target) or "").split(".")[-1] in \
                            _CAPTURE_BINDERS:
                        names.add(fn.name)
        for name in sorted(names):
            nodes.extend(self.funcs.get(name, []))
        return nodes


# --------------------------------------------------------------------------
# rule passes
# --------------------------------------------------------------------------

def _contains_torch_result(model: _FileModel, node: ast.AST) -> bool:
    """The expression holds a torch call or a tensor reduction."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if model.is_torch(_qual(sub.func)) or \
                    (isinstance(sub.func, ast.Attribute)
                     and sub.func.attr in _TENSOR_REDUCTIONS):
                return True
    return False


def _check_captured(model: _FileModel, fn: ast.AST,
                    out: List[Diagnostic]) -> None:
    path = model.path
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        fq = _qual(node.func) or ""
        last = _last(node)
        at = (path, node.lineno, node.col_offset)
        if isinstance(node.func, ast.Attribute) and last in _HOST_READS:
            out.append(Diagnostic(
                *at, "RT001",
                f"`.{last}()` reads the device from the host inside a "
                "captured function; keep the value on the device (or read "
                "it once outside the step)"))
        elif model.is_torch(fq) and last == "synchronize":
            out.append(Diagnostic(
                *at, "RT001",
                "a device sync inside a captured function breaks the "
                "capture; sync from the host driver"))
        elif isinstance(node.func, ast.Name) \
                and node.func.id in ("int", "float", "bool") \
                and node.args and _contains_torch_result(model, node.args[0]):
            out.append(Diagnostic(
                *at, "RT001",
                f"`{node.func.id}()` over a tensor result waits for the "
                "device; keep it a 0-dim tensor"))
        elif model.is_torch(fq) and last in _HOST_TENSORS:
            out.append(Diagnostic(
                *at, "RT002",
                f"`torch.{last}` copies host data to the device on every "
                "step (C1); build it once (`device.const`) and pass it in"))
        if isinstance(node.func, ast.Name) and node.func.id == "print":
            out.append(Diagnostic(
                *at, "RT003",
                "`print` inside a captured function runs at the capture, "
                "not on each replay; report from the host driver"))
        elif fq == "warnings.warn":
            out.append(Diagnostic(
                *at, "RT003",
                "`warnings.warn` inside a captured function fires at the "
                "capture, not per step; warn from the host driver"))


def _check_kernel_dtypes(model: _FileModel, out: List[Diagnostic]) -> None:
    for node in ast.walk(model.tree):
        if not (isinstance(node, ast.Call) and model.is_torch(
                _qual(node.func))):
            continue
        last = _last(node)
        if last in _CTORS and not any(k.arg == "dtype"
                                      for k in node.keywords):
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "RT004",
                f"`torch.{last}` without an explicit dtype in kernel code; "
                "pass dtype= (match the payload tensor)"))


def _is_float_divisor(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
        and node.func.id == "float"


def _check_float_divisors(model: _FileModel, out: List[Diagnostic]) -> None:
    for node in ast.walk(model.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            divisor = node.right
        elif isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Div):
            divisor = node.value
        else:
            continue
        if _is_float_divisor(divisor):
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "RT005",
                f"division by the Python float `{ast.unparse(divisor)}`: on "
                "CUDA a tensor is multiplied by its reciprocal instead; "
                "divide by a 0-dim tensor of the working dtype "
                "(`device.const`)"))


def _tensor_names(model: _FileModel, fn: ast.AST) -> Set[str]:
    """Names a function binds to an expression holding a torch call."""
    names: Set[str] = set()
    for node in _scope_nodes(fn):
        if isinstance(node, ast.Assign) and \
                _contains_torch_result(model, node.value) and not (
                    isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and node.value.func.id in _BUILTINS):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _check_accumulates(model: _FileModel, out: List[Diagnostic]) -> None:
    scopes = [model.tree] + [f for defs in model.funcs.values()
                             for f in defs]
    seen: Set[Tuple[int, int]] = set()
    for scope in scopes:
        tensors = _tensor_names(model, scope) if scope is not model.tree \
            else set()
        for node in _scope_nodes(scope):
            msg = None
            if isinstance(node, ast.Call):
                last = _last(node)
                if last in _ACCUMULATES:
                    msg = f"`{last}` accumulates with atomics on CUDA"
                elif last in ("index_put_", "index_put") and any(
                        k.arg == "accumulate" and not (
                            isinstance(k.value, ast.Constant)
                            and k.value.value is False)
                        for k in node.keywords):
                    msg = f"`{last}(accumulate=True)` adds with atomics on " \
                          "CUDA"
                elif last in _INDEX_ADD_BACKWARD and \
                        isinstance(node.func, ast.Attribute):
                    msg = f"`{last}`'s backward is an atomic index-add on " \
                          "CUDA"
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load):
                idx = node.slice.elts if isinstance(node.slice, ast.Tuple) \
                    else [node.slice]
                if any((isinstance(i, ast.Name) and i.id in tensors)
                       or (isinstance(i, ast.Call)
                           and _contains_torch_result(model, i))
                       for i in idx):
                    msg = "indexing by a tensor: its backward is an " \
                          "atomic index-add on CUDA"
            if msg and (node.lineno, node.col_offset) not in seen:
                seen.add((node.lineno, node.col_offset))
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "RT006",
                    f"{msg}, so its sums differ run to run; sum in a fixed "
                    "order (`_GatherRows`, a sort-based segment sum) or say "
                    "why the order cannot matter here"))


def _is_time_read(model: _FileModel, call: ast.Call) -> bool:
    fq = _qual(call.func) or ""
    parts = fq.split(".")
    if len(parts) == 2 and parts[0] in model.time_mods:
        return parts[1] in _TIME_READS
    return len(parts) == 1 and parts[0] in model.time_funcs


def _is_device_work(model: _FileModel, call: ast.Call) -> bool:
    fq = _qual(call.func) or ""
    last = _last(call)
    if model.is_torch(fq):
        return not fq.startswith(tuple(f"{t}.cuda" for t in model.torch))
    if isinstance(call.func, ast.Name) and last in _BUILTINS:
        return False
    return last in _DEVICE_ENTRIES or last.endswith(("_fn", "_step"))


def _check_timing_spans(model: _FileModel, out: List[Diagnostic]) -> None:
    scopes = [model.tree] + [f for defs in model.funcs.values()
                             for f in defs]
    for scope in scopes:
        nodes = _scope_nodes(scope)
        starts: Dict[str, List[int]] = {}
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and isinstance(n.value, ast.Call) \
                    and _is_time_read(model, n.value):
                starts.setdefault(n.targets[0].id, []).append(n.lineno)
        if not starts:
            continue
        calls = [n for n in nodes if isinstance(n, ast.Call)]
        for n in nodes:
            if not (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)
                    and isinstance(n.right, ast.Name)
                    and n.right.id in starts
                    and isinstance(n.left, ast.Call)
                    and _is_time_read(model, n.left)):
                continue
            opened = [ln for ln in starts[n.right.id] if ln <= n.lineno]
            if not opened:
                continue
            t_start = max(opened)
            window = [c for c in calls if t_start <= c.lineno <= n.lineno]
            worked = any(_is_device_work(model, c) for c in window)
            synced = any(_last(c) in _SYNCS for c in window)
            if worked and not synced:
                out.append(Diagnostic(
                    model.path, n.lineno, n.col_offset, "RT007",
                    f"timing span `{n.right.id}` covers device work but "
                    "stops the clock without a sync; CUDA launches return "
                    "before the work ends, so this measures the launch — "
                    "`torch.cuda.synchronize()` (or an event's) before the "
                    "read, or use `repro_torch.obs.span`"))


_BROAD_EXC = {"Exception", "BaseException"}
# a handler "records" the error when it calls anything that, by name,
# warns / logs / prints / emits / records a report
_HANDLER_OK_RE = re.compile(
    r"(warn|warning|error|exception|critical|print|log|emit|fail|"
    r"fallback|record|latch)", re.IGNORECASE)


def _is_broad_except(type_node: Optional[ast.AST]) -> bool:
    if type_node is None:                 # bare `except:`
        return True
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad_except(el) for el in type_node.elts)
    return (_qual(type_node) or "").split(".")[-1] in _BROAD_EXC


def _check_except_handlers(model: _FileModel, out: List[Diagnostic]) -> None:
    """RT008 (the reference's RA009): a broad ``except`` may only re-raise
    or make the swallow loud; ``except SomeType:`` is never flagged."""
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.ExceptHandler) or \
                not _is_broad_except(node.type):
            continue
        handled = any(
            isinstance(sub, ast.Raise)
            or (isinstance(sub, ast.Call)
                and _HANDLER_OK_RE.search(_last(sub) or "_"))
            for stmt in node.body for sub in ast.walk(stmt))
        if not handled:
            caught = "bare `except:`" if node.type is None else \
                f"`except {ast.unparse(node.type)}`"
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "RT008",
                f"{caught} neither re-raises nor records the error; a "
                "recovery path must not silently eat faults it cannot "
                "classify — catch the concrete exception types, or "
                "warn/log/re-raise in the handler"))


# --------------------------------------------------------------------------
# CUDA sources
# --------------------------------------------------------------------------

_CU_STRIP_RE = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\])*"', re.S)
_ERROR_READ_RE = re.compile(r"\bcuda(?:GetLastError|PeekAtLastError)\s*\(")


def _blank(m: re.Match) -> str:
    return re.sub(r"[^\n]", " ", m.group(0))


def _function_bodies(code: str) -> Dict[str, List[Tuple[int, int]]]:
    """Outermost function bodies ``{name: [(open, close), ...]}`` of a
    CUDA source with comments and strings blanked."""
    bodies: Dict[str, List[Tuple[int, int]]] = {}
    stack: List[Tuple[int, Optional[str]]] = []
    for i, ch in enumerate(code):
        if ch == "{":
            stack.append((i, _function_name(code, i)))
        elif ch == "}" and stack:
            start, name = stack.pop()
            if name and not any(n for _, n in stack):
                bodies.setdefault(name, []).append((start, i))
    return bodies


def _function_name(code: str, brace: int) -> Optional[str]:
    """The name of the function whose body opens at ``brace``, or None
    when the brace opens anything else."""
    k = brace - 1
    while k >= 0 and code[k].isspace():
        k -= 1
    for word in ("const", "noexcept"):
        if code[max(0, k - len(word) + 1):k + 1] == word:
            k -= len(word)
            while k >= 0 and code[k].isspace():
                k -= 1
    if k < 0 or code[k] != ")":
        return None
    depth = 0
    while k >= 0:
        depth += {")": 1, "(": -1}.get(code[k], 0)
        if depth == 0:
            break
        k -= 1
    m = re.search(r"([A-Za-z_]\w*)\s*$", code[max(0, k - 256):k])
    if not m or m.group(1) in ("if", "for", "while", "switch", "catch"):
        return None
    return m.group(1)


def lint_cuda(path: str, source: str) -> List[Diagnostic]:
    """RT009 over one CUDA source.  A function's launches are its
    ``<<<`` launches and its calls to functions that launch without
    reading the error after; its last launch must be followed by a
    ``cudaGetLastError`` / ``cudaPeekAtLastError`` before it returns.
    Where it is not, the function's callers take its launches over; one
    that no function of the file calls (an ``extern "C"`` entry) is
    flagged at its last launch."""
    code = _CU_STRIP_RE.sub(_blank, source)
    bodies = _function_bodies(code)
    unchecked: Dict[str, int] = {}      # function -> its last launch
    changed = True
    while changed:
        changed = False
        calls = re.compile(r"<<<" if not unchecked else
                           r"<<<|\b(?:" + "|".join(map(re.escape, unchecked))
                           + r")\s*(?:<[^;{}()]*>)?\s*\(")
        for name, spans in bodies.items():
            for start, end in spans:
                events = [m.start() for m in calls.finditer(code, start, end)]
                if not events or name in unchecked:
                    continue
                if not _ERROR_READ_RE.search(code, events[-1], end):
                    unchecked[name] = events[-1]
                    changed = True
    called = {n for n in unchecked
              if re.search(r"\b" + re.escape(n) + r"\s*(?:<[^;{}()]*>)?\s*\(",
                           "".join(code[a:b] for other, spans in
                                   bodies.items() if other != n
                                   for a, b in spans))}
    lines = source.splitlines()
    out = [Diagnostic(path, code.count("\n", 0, at) + 1, 0, "RT009",
                      "kernel launch with no `cudaGetLastError()` / "
                      "`cudaPeekAtLastError()` after it: a launch that fails "
                      "passes for a kernel that ran; return the error to the "
                      "wrapper")
           for name, at in unchecked.items() if name not in called]
    return [d for d in out if not _suppressed(lines, d)]


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def _suppressed(lines: List[str], diag: Diagnostic) -> bool:
    if diag.line - 1 >= len(lines):
        return False
    m = _NOQA_RE.search(lines[diag.line - 1])
    if not m:
        return False
    codes = m.group("codes")
    return not codes or diag.code in re.findall(r"RT\d{3}", codes)


def iter_source_files(paths: Iterable[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(f for f in path.rglob("*")
                                if f.suffix in (".py", ".cu")))
        elif path.suffix in (".py", ".cu"):
            files.append(path)
    return files


def _lint_python(model: _FileModel) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for fn in model.captured:
        _check_captured(model, fn, out)
    if model.in_tree("kernels"):
        _check_kernel_dtypes(model, out)
    if model.in_tree("core", "serve"):
        _check_float_divisors(model, out)
    if model.in_tree("core", "serve", "resilience", "models"):
        _check_accumulates(model, out)
    _check_timing_spans(model, out)
    _check_except_handlers(model, out)
    seen, diags = set(), []
    for d in out:
        key = (d.line, d.col, d.code)
        if key in seen or _suppressed(model.source_lines, d):
            continue
        seen.add(key)
        diags.append(d)
    return diags


def lint_file(path: str) -> List[Diagnostic]:
    src = Path(path).read_text()
    if Path(path).suffix == ".cu":
        return lint_cuda(str(path), src)
    return _lint_python(_FileModel(str(path), src))


def lint_paths(paths: Iterable[str]) -> Tuple[List[Diagnostic], int]:
    """Lint every ``*.py`` and ``*.cu`` under ``paths``; returns
    (diagnostics, n_files)."""
    files = iter_source_files(paths)
    diags = [d for f in files for d in lint_file(str(f))]
    diags.sort(key=lambda d: (d.path, d.line, d.col, d.code))
    return diags, len(files)
