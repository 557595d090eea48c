"""Phase tracing: profiler ranges on the device path, span timers on the host.

The port of the JAX package's ``obs/tracing.py`` in PyTorch's idiom:

* :meth:`PhaseTracer.scope` is ``torch.profiler.record_function``
  (``obs.<name>``), a range that the profiler records around the
  operations issued inside it.  It is metadata only and cannot change
  what runs, so trajectories stay bitwise the same with it.  A scope
  inside a step unit that the engine captured as a CUDA graph
  (:mod:`repro_torch.core.pipeline.block_graph`) is recorded only while
  the unit runs eagerly: a replay launches the graph, so the profiler
  then names the graph's kernels, not the scopes.
* :meth:`PhaseTracer.step_metrics`: the reference's per-step ``obs/*``
  ledger counters.  The port's ledger is host bookkeeping, so they are
  host values (``numpy.int32``), read from the ledger after each step's
  transitions and never made into device tensors on the step path: the
  step graphs do not see them, and a traced run replays the same graphs
  with the same bits.  The disabled :data:`NULL_TRACER` adds nothing.
* :func:`span` / :func:`time_fn` time host regions on ``perf_counter``.
  ``span``'s ``sync()`` registers tensors whose CUDA devices are
  synchronized before the clock stops, so work issued asynchronously is
  inside the measurement; ``time_fn`` runs its warm-up calls, then its
  iterations, each synchronized, and reports their median.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

# the phase vocabulary (the paper's Fig. 6 lanes); scopes are free-form
# but these are the names the exporter and README use
PHASES = (
    "pack_send",          # gather halo payload + issue puts (fwd)
    "fwd_release",        # coordinate put-with-signal released
    "fwd_acquire",        # consumer's signal wait before reading halo
    "force",              # extended-block pair forces (tier ladder)
    "rev_release",        # force-return put released at fill time
    "rev_acquire",        # integrator's wait on returned forces
    "integrate_begin",    # kick-drift half step
    "integrate_finish",   # final kick
    "roll_prune",         # rolling inner prune between rebins
    "rebin_seam",         # rebin/migration gather at the block seam
)


@dataclass(frozen=True)
class PhaseTracer:
    """Per-engine tracing switch.

    ``scope`` is always active (metadata only).  ``step_metrics`` grows
    a step's outputs, so it is gated on ``enabled``.
    """

    enabled: bool = False

    def scope(self, name: str):
        """Profiler range ``obs.<name>`` for one pipeline phase."""
        return torch.profiler.record_function(f"obs.{name}")

    def step_metrics(self, ledger, led) -> Dict[str, Any]:
        """Per-step ledger counters as extra ``obs/*`` metrics (host
        ``numpy.int32`` values): none when disabled."""
        if not self.enabled:
            return {}
        return {
            "obs/in_flight": np.int32(ledger.in_flight(led)),
            "obs/released": np.int32(led.released.sum()),
            "obs/acquired": np.int32(led.acquired.sum()),
            "obs/clobbers": np.int32(led.clobbers.sum()),
        }


NULL_TRACER = PhaseTracer(enabled=False)


def is_obs_metric(key: str) -> bool:
    """True for metric keys owned by tracing (``obs/`` prefix)."""
    return key.startswith("obs/")


def strip_obs_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """The physics-only view of a step-metrics dict."""
    return {k: v for k, v in metrics.items() if not is_obs_metric(k)}


# --------------------------------------------------------------------------
# host-side spans
# --------------------------------------------------------------------------

def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in a nested container."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    return out


def block_until_ready(tree):
    """Synchronize every CUDA device holding a tensor of ``tree`` (the
    counterpart of ``jax.block_until_ready``); returns ``tree``."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


class Span:
    """One timed host-side region; ``dur`` is valid after the ``with``."""

    __slots__ = ("name", "meta", "t0", "dur", "_sync")

    def __init__(self, name: str, meta: dict):
        self.name = name
        self.meta = meta
        self.t0 = 0.0
        self.dur = 0.0
        self._sync: Any = None

    def sync(self, tree):
        """Register tensors whose CUDA devices are synchronized before
        the clock stops (returns ``tree`` so call sites stay one-liners)."""
        self._sync = (tree,) if self._sync is None else self._sync + (tree,)
        return tree


@contextlib.contextmanager
def span(name: str, registry=None, **meta):
    """Time a host-side region on ``perf_counter``.

    The CUDA devices of any tensor passed through ``sp.sync(...)`` are
    synchronized before the stop-read, so work issued asynchronously is
    inside the measurement.  With a registry, emits a ``span`` record and
    observes the duration in the ``span/<name>`` histogram.
    """
    sp = Span(name, meta)
    sp.t0 = time.perf_counter()
    try:
        yield sp
    finally:
        if sp._sync is not None:
            block_until_ready(sp._sync)
        sp.dur = time.perf_counter() - sp.t0
        if registry is not None:
            registry.emit("span", name=name, t0=sp.t0, dur=sp.dur, **meta)
            registry.histogram(f"span/{name}").observe(sp.dur)


@dataclass
class TimingResult:
    """Per-iteration wall times from :func:`time_fn` (seconds)."""

    name: str
    times: List[float]

    @property
    def median(self) -> float:
        vs = sorted(self.times)
        return vs[len(vs) // 2]

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)


def _settle(result) -> None:
    """Synchronize ``result``'s CUDA devices, or, when it holds no CUDA
    tensor, the current CUDA device if CUDA is in use."""
    if not _cuda_devices(result, set()) and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    block_until_ready(result)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            name: Optional[str] = None, registry=None) -> TimingResult:
    """Median-of-``iters`` timing after ``warmup`` calls; every call is
    synchronized (its result's CUDA devices, else the current one) inside
    its measurement."""
    label = name or getattr(fn, "__name__", "fn")
    for _ in range(max(0, warmup)):
        _settle(fn(*args))
    times = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        _settle(fn(*args))
        times.append(time.perf_counter() - t0)
    result = TimingResult(name=label, times=times)
    if registry is not None:
        registry.emit("timing", name=label, iters=len(times),
                      median_s=result.median, best_s=result.best)
        registry.histogram(f"timing/{label}").observe(result.median)
    return result
