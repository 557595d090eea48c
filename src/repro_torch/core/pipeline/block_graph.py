"""An MD block's device work as CUDA graphs: one graph per step unit.

The reference runs a whole ``nstlist`` block as one jitted program, with
no host round trip between steps (the paper's "launch tens to hundreds of
time-steps before CPU-GPU sync").  The port issues each operation from
Python, so a steady pruned step costs the host several times its device
time.  :class:`BlockGraphs` captures the device work of one step unit of
the step pipeline (``off``'s serial step; the ``double_buffer`` ring's
prologue, its skew-one unit per ring slot and its epilogue drain), and of
each between-block rebin and prune, as a CUDA graph and replays it: one
graph launch a step.

Why a step and not the whole block: a block graph is keyed by the block's
tier ladder, which at grappa-45k changes at every prune, so in a real run
it would never replay; and its capture (a block's Python issue plus the
instantiation of ~20,000 nodes on the dense path) costs more than a
40-step run gains.  A unit is captured inside the block at a twentieth of
that cost and replays for the rest of the block, whatever its ladder.

A graph works on fixed memory, which sets the design:

* **Static inputs and outputs.**  Before each replay the caller's inputs
  (the state a step carries) are copied into the graph's own buffers,
  made outside the graphs' pool with the inputs' strides.  The block's
  constants (the step context: atom indices, tier batches) are copied
  only when the caller passes other tensor objects than at the last
  replay; a constant is never changed in place.  The outputs are
  returned as clones with their strides: the next replay overwrites the
  graph's own.
* **Key and cache.**  A graph is keyed by the caller's kind and key and
  by the structure, shapes, strides and dtypes of the inputs and
  constants, with their non-tensor leaves (a tier's slot count).  The
  cache keeps the ``SIZE`` most recently used graphs; all of them share
  one memory pool (``torch.cuda.graph_pool_handle()``), which is safe
  because replays run one at a time on one stream and each one's outputs
  are cloned before the next.
* **Warm-up.**  The first ``WARM`` calls of a key run eagerly and are
  the calls' results.  They do the one-time host work a capture refuses
  (a library's build and ctypes resolve, the plan's index maps and
  their host checks, the signal words, the pair schedule's padded pairs,
  constants copied from the host).  Two, so that what a run calls only
  twice (a 40-step run's rebin) never pays a capture it cannot repay.
  The next call captures and replays.
* **Counters.**  Each kernel wrapper counts its launches in Python.  A
  capture launches nothing, so the counters are put back after it.  The
  captured graph's kernel nodes are then counted by kernel name through
  the driver API (:func:`kernel_nodes`), and they must equal what the
  wrappers counted while it was captured, or the capture raises.  Each
  replay adds the graph's node counts: the counters count kernels that
  ran, with or without graphs.
* **No destruction during a capture.**  An engine holds a reference
  cycle (its step functions close over it), so its graphs die only when
  the garbage collector runs; a graph or pool destroyed while another
  capture is open invalidates that capture.  A capture therefore holds
  the collector off until it ends.

A capture or replay that fails raises; nothing falls back to eager
issue.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import gc
import re
import time
from typing import Any, Callable, Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import halo_pack, nonbonded

# the MD kernels by the identifier of their ``__global__`` function, each
# with the (object, attribute) launch counter its wrapper adds one to
KERNEL_NODES = {
    "pack_kernel": (halo_pack.pack, "launches"),
    "pack_convert_kernel": (halo_pack.pack, "wire_launches"),
    "unpack_add_kernel": (halo_pack.unpack_add, "launches"),
    "put_signal_kernel": (halo_pack.put_signal, "launches"),
    "put_signal_convert_kernel": (halo_pack.put_signal, "wire_launches"),
    "fused_pulses_kernel": (halo_pack.fused_pulses, "launches"),
    "pair_forces_kernel": (nonbonded.pair_forces, "launches"),
    "scatter_accum_kernel": (nonbonded.scatter_accum, "launches"),
}

# every launch counter of the MD kernels' wrappers; ``inverse_builds``
# counts PyTorch work, which a capture must not hold (it runs at warm-up)
KERNEL_COUNTERS = tuple(dict.fromkeys(KERNEL_NODES.values())) + (
    (halo_pack.unpack_add, "inverse_builds"),)


# -- the driver API: a captured graph's kernel nodes by name -----------------

class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_CU_GRAPH_NODE_TYPE_KERNEL = 0
_driver_lib: List[Any] = []


def _driver():
    if not _driver_lib:
        _driver_lib.append(ctypes.CDLL("libcuda.so.1"))
    return _driver_lib[0]


def _cu(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _kernel_ident(name: str):
    """The :data:`KERNEL_NODES` identifier a kernel's name holds, or
    None: in a mangled name as its length-prefixed source name, else as
    a whole word."""
    for ident in KERNEL_NODES:
        if name.startswith("_Z"):
            if f"{len(ident)}{ident}" in name:
                return ident
        elif re.search(rf"\b{ident}\b", name):
            return ident
    return None


def kernel_nodes(graph: torch.cuda.CUDAGraph, names=None
                 ) -> Dict[Tuple, int]:
    """The MD kernels' nodes of a captured, kept graph
    (``CUDAGraph(keep_graph=True)``), counted per launch counter of
    :data:`KERNEL_NODES` by the name the driver gives each kernel node;
    every kernel node's name is added to the set ``names`` if given."""
    cu = _driver()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    _cu(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts: Dict[Tuple, int] = {}
    for node in nodes[:n.value]:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        _cu(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        p = _KernelNodeParams()
        _cu(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
            "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            _cu(cu.cuFuncGetName(ctypes.byref(name),
                                 ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            _cu(cu.cuKernelGetName(ctypes.byref(name),
                                   ctypes.c_void_p(p.kern)),
                "cuKernelGetName")
        text = (name.value or b"").decode()
        if names is not None:
            names.add(text)
        ident = _kernel_ident(text)
        if ident is not None:
            counter = KERNEL_NODES[ident]
            counts[counter] = counts.get(counter, 0) + 1
    return counts


# -- inputs and outputs ------------------------------------------------------

_TENSOR = "tensor"


def _flatten(x, leaves: list):
    """Append ``x``'s tensors to ``leaves``; return its structure, with
    every non-tensor leaf in it (hashable: it is part of a key)."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, dict):
        return (dict, tuple(x), tuple(_flatten(v, leaves)
                                      for v in x.values()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return (type(x), names, tuple(_flatten(getattr(x, f), leaves)
                                      for f in names))
    if isinstance(x, (tuple, list)):
        return (type(x), None, tuple(_flatten(v, leaves) for v in x))
    hash(x)
    return ("const", x, None)


def _build(sig, leaves):
    """Inverse of :func:`_flatten` over an iterator of tensors."""
    if sig == _TENSOR:
        return next(leaves)
    head, names, parts = sig
    if head == "const":
        return names
    vals = [_build(p, leaves) for p in parts]
    if head is dict:
        return dict(zip(names, vals))
    if names is not None:
        return head(**dict(zip(names, vals)))
    if hasattr(head, "_fields"):
        return head(*vals)
    return head(vals)


def _layout(leaves) -> tuple:
    return tuple((tuple(x.shape), x.stride(), x.dtype) for x in leaves)


def _buffer(x: torch.Tensor) -> torch.Tensor:
    """A new tensor of ``x``'s shape, strides and dtype (not filled)."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device=x.device)


def _clone(x):
    """A copy of a captured function's result: tensors copied with their
    strides, numpy arrays copied, containers rebuilt, anything else
    shared."""
    if isinstance(x, torch.Tensor):
        return _buffer(x).copy_(x)
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


class CapturedBlock:
    """One captured graph: its input and constant buffers, its outputs,
    and the MD kernels' launches of one replay, from its nodes."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: list,
                 consts: list, out: Any, launches: Dict[Tuple, int]):
        self.graph = graph
        self.inputs = inputs
        self.consts = consts
        self.out = out
        self.launches = launches
        self._last: Sequence[torch.Tensor] = ()    # consts copied last

    def replay(self, inputs: Sequence[torch.Tensor],
               consts: Sequence[torch.Tensor]) -> Any:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        if len(self._last) != len(consts) or any(
                a is not b for a, b in zip(self._last, consts)):
            for buf, x in zip(self.consts, consts):
                buf.copy_(x)
            self._last = tuple(consts)
        self.graph.replay()
        for (obj, attr), n in self.launches.items():
            setattr(obj, attr, getattr(obj, attr) + n)
        return _clone(self.out)


class BlockGraphs:
    """A bounded cache of captured step units on one CUDA device.

    ``run(kind, key, fn, inputs, consts)`` returns ``fn(*inputs,
    *consts)``: eagerly for the first ``WARM`` calls of a key, then
    through a graph captured at the next call and replayed from then on.
    ``kind`` names the work (a step unit, ``"rebin"``, ``"prune"``) in
    the key and in :meth:`stats`.
    """

    SIZE = 16       # graphs kept: the ring's units, prologue and epilogue
                    # at depth 4, the rebin and prune, a previous ladder's
    WARM = 2        # eager calls of a key before its capture

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"block graphs need a CUDA device, got "
                             f"{device}")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: "collections.OrderedDict[Hashable, CapturedBlock]" = \
            collections.OrderedDict()
        self._warm: "collections.OrderedDict[Hashable, int]" = \
            collections.OrderedDict()
        self._stream = None                         # captures
        self.calls = {"eager": collections.Counter(),
                      "captures": collections.Counter(),
                      "replays": collections.Counter()}
        self.capture_ms: list = []

    def stats(self) -> dict:
        """Eager calls, captures and replays (totals and per kind), the
        graphs cached and each capture's ms."""
        out = {k: sum(c.values()) for k, c in self.calls.items()}
        out.update({f"{k}_by_kind": dict(c) for k, c in self.calls.items()})
        out.update(cached=len(self._graphs),
                   capture_ms=list(self.capture_ms))
        return out

    def graphs(self):
        """``(key, CapturedBlock)`` of every cached graph, oldest first;
        a key's first element is its kind."""
        return list(self._graphs.items())

    def clear(self):
        """Drop every cached graph (their pool memory returns to the
        allocator) and the warm-up counts; later captures go to a new
        pool, as the allocator retires a pool whose graphs are all gone.
        Refused while a capture is open on the current stream: destroying
        a graph then invalidates that capture."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("BlockGraphs.clear() during a capture")
        self._graphs.clear()
        self._warm.clear()
        self.pool = torch.cuda.graph_pool_handle()

    def run(self, kind: str, key: tuple, fn: Callable, inputs: Sequence,
            consts: Sequence = ()):
        in_leaves, c_leaves = [], []
        sig = (_flatten(tuple(inputs), in_leaves),
               _flatten(tuple(consts), c_leaves))
        full = (kind,) + tuple(key) + sig + (_layout(in_leaves),
                                              _layout(c_leaves))
        block = self._graphs.get(full)
        if block is None:
            seen = self._warm.pop(full, 0)
            if seen < self.WARM:
                self._warm[full] = seen + 1
                if len(self._warm) > 8 * self.SIZE:
                    self._warm.popitem(last=False)
                self.calls["eager"][kind] += 1
                return fn(*inputs, *consts)
            block = self._capture(kind, fn, sig, in_leaves, c_leaves)
            self._graphs[full] = block
            if len(self._graphs) > self.SIZE:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(full)
        self.calls["replays"][kind] += 1
        return block.replay(in_leaves, c_leaves)

    def _capture(self, kind, fn, sig, in_leaves, c_leaves) -> CapturedBlock:
        inputs = [_buffer(x) for x in in_leaves]
        consts = [_buffer(x) for x in c_leaves]
        args = _build(sig[0], iter(inputs)) + _build(sig[1], iter(consts))
        before = tuple(getattr(obj, attr) for obj, attr in KERNEL_COUNTERS)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        try:
            # capture_begin / capture_end on a stream of our own, not
            # torch.cuda.graph, which syncs the device and empties the
            # allocator's cache (every later allocation a cudaMalloc)
            # before each capture
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self.pool)
                try:
                    out = fn(*args)
                finally:
                    graph.capture_end()
        finally:
            main.wait_stream(self._stream)
            if collecting:
                gc.enable()
            moved = {c: getattr(*c) - b
                     for c, b in zip(KERNEL_COUNTERS, before)}
            # a capture launches nothing
            for (obj, attr), b in zip(KERNEL_COUNTERS, before):
                setattr(obj, attr, b)
        names: set = set()
        launches = kernel_nodes(graph, names)
        held = {c: n for c, n in moved.items() if n}
        if held != launches:
            raise RuntimeError(
                f"captured {kind!r} graph: its kernel nodes "
                f"{_named(launches)} differ from the launches its wrappers "
                f"counted {_named(held)}; its kernels: {sorted(names)}")
        graph.instantiate()
        self.calls["captures"][kind] += 1
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        return CapturedBlock(graph, inputs, consts, out, launches)


def _named(counts: Dict[Tuple, int]) -> dict:
    return {f"{obj.__name__}.{attr}": n for (obj, attr), n in counts.items()}
