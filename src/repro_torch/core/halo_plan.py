"""Plan-based halo exchange on the virtual domain mesh.

The port of the JAX package's ``core/halo_plan.py``: a frozen
:class:`HaloSpec`, a construct-once :class:`HaloPlan` bound to a
:class:`~repro_torch.launch.mesh.DomainMesh` and a device, and the
``serialized`` / ``fused`` / ``pallas`` backends.  The ``"pallas"`` name
is kept so that specs read alike in both packages; here it drives the
CUDA pack / unpack-add kernels of :mod:`repro_torch.kernels.halo_pack`.

Block tensors carry every domain: ``(D_0, .., D_{nd-1}, *local)`` with
one leading dim per decomposed axis, in ``spec.axis_names`` order.  The
pure-arithmetic accounting (:func:`compute_exchange_stats`,
:func:`latency_model`, :func:`overlap_model`, :meth:`HaloPlan.stats`)
returns the same dicts as the reference for the same spec and local
shape.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.schedule_verifier import (
    VERIFY_MODES,
    check_halo_config,
)
from repro_torch.core import halo as _halo
from repro_torch.core.schedule import PulseSchedule
from repro_torch.device import resolve_device
from repro_torch.kernels import halo_pack
from repro_torch.launch.mesh import DomainMesh

Region = Tuple[int, ...]

_UNSET = object()


# --------------------------------------------------------------------------
# spec
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class HaloSpec:
    """Frozen, hashable description of a halo exchange.

    ``wrap_shift`` is the per-dimension periodic-image shift added to
    feature components when data crosses the periodic boundary (the
    paper's ``coordShift``), stored as a nested tuple.  ``dtype`` /
    ``feature_elems`` feed the byte accounting of :meth:`HaloPlan.stats`.
    ``pulses`` is the per-dim pulse count (``None`` = one per dim).
    ``wire_dtype`` (compressed payloads) belongs to a later slice of the
    port: a plan with one set raises ``NotImplementedError``.
    """

    axis_names: Tuple[str, ...]
    widths: Tuple[int, ...]
    backend: str = "fused"
    wrap_shift: Optional[Tuple[Tuple[float, ...], ...]] = None
    dtype: str = "float32"
    feature_elems: int = 1
    pulses: Optional[Tuple[int, ...]] = None
    wire_dtype: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "widths",
                           tuple(int(w) for w in self.widths))
        if len(self.axis_names) != len(self.widths):
            raise ValueError("axis_names and widths must have equal length")
        if self.pulses is not None:
            object.__setattr__(self, "pulses",
                               tuple(int(n) for n in self.pulses))
        if self.wrap_shift is not None:
            object.__setattr__(
                self, "wrap_shift",
                tuple(tuple(float(v) for v in row)
                      for row in np.asarray(self.wrap_shift)))

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    def with_wrap_shift(self, wrap_shift) -> "HaloSpec":
        return dataclasses.replace(self, wrap_shift=wrap_shift)

    def wrap_shift_array(self, device=None) -> Optional[torch.Tensor]:
        if self.wrap_shift is None:
            return None
        return torch.as_tensor(np.asarray(self.wrap_shift, dtype=self.dtype),
                               device=device)


# --------------------------------------------------------------------------
# backend registry
# --------------------------------------------------------------------------

class HaloBackend:
    """Executor over whole block tensors (every domain at once).

    ``critical_path`` names which of the two chained-bytes models in
    :meth:`HaloPlan.stats` describes this backend's execution.
    """

    name: str = "?"
    critical_path: str = "serialized"

    def fwd(self, plan: "HaloPlan", local: torch.Tensor,
            wrap_shift: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def rev(self, plan: "HaloPlan", ext: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _local_shape(self, plan: "HaloPlan", ext: torch.Tensor
                     ) -> Tuple[int, ...]:
        nd = plan.spec.ndim
        return tuple(ext.shape[nd + d] - plan.spec.widths[d]
                     for d in range(nd))


class SerializedBackend(HaloBackend):
    """MPI-like baseline: one full slab per pulse, sequential."""

    name = "serialized"

    def fwd(self, plan, local, wrap_shift):
        return _halo.exchange_fwd_serialized(local, plan.sched,
                                             plan.axis_sizes, wrap_shift)

    def rev(self, plan, ext):
        return _halo.exchange_rev_serialized(ext, plan.sched,
                                             plan.axis_sizes)


class FusedBackend(HaloBackend):
    """Dependency-partitioned phases (paper Alg. 3/4/6)."""

    name = "fused"
    critical_path = "fused"

    def fwd(self, plan, local, wrap_shift):
        return _halo.exchange_fwd_fused(local, plan.sched, plan.axis_sizes,
                                        wrap_shift)

    def rev(self, plan, ext):
        return _halo.exchange_rev_fused(ext, plan.sched, plan.axis_sizes,
                                        self._local_shape(plan, ext))


class PallasBackend(HaloBackend):
    """Pack / unpack-add through the CUDA kernels of ``kernels.halo_pack``.

    Each pulse is pack (gather into a contiguous send buffer, paper
    Alg. 3 line 7) -> neighbour shift (the put) -> concat or unpack-add.
    The index maps are static per local shape, built once and kept on
    the plan's device as int32 (the paper's DD-time index-map build).
    One launch serves every domain: a block viewed as
    ``(n_dom, prod(local[:d+1]), -1)`` numbers its rows per domain
    exactly as the reference's ``reshape(prod(shape[:d+1]), -1)``, so
    the same map holds for all domains.  Pulses run in serialized order,
    so the serialized critical-path model applies.  On a CUDA block the
    kernels run or raise; on a CPU block their plain forms run.
    """

    name = "pallas"
    critical_path = "serialized"

    @staticmethod
    def _rows_along(shape: Sequence[int], d: int, lo: int, hi: int
                    ) -> np.ndarray:
        """Row ids of ``reshape(prod(shape[:d+1]), -1)`` whose coordinate
        along axis ``d`` lies in ``[lo, hi)``."""
        n_rows = int(np.prod(shape[:d + 1], dtype=np.int64))
        coord = np.arange(n_rows, dtype=np.int64) % shape[d]
        return np.nonzero((coord >= lo) & (coord < hi))[0].astype(np.int32)

    def _maps(self, plan, local_shape: Tuple[int, ...]):
        cached = plan._index_maps.get(local_shape)
        if cached is not None:
            return cached

        def rows(shape, d: int, lo: int, hi: int) -> torch.Tensor:
            # the kernels trust the maps (an index past the block traps
            # them), so check each once here, on the host
            a = self._rows_along(shape, d, lo, hi)
            n_rows = math.prod(shape[:d + 1])
            if a.size and not (a.min() >= 0 and a.max() < n_rows):
                raise ValueError(f"halo index map for dim {d} of local shape "
                                 f"{tuple(shape)} leaves [0, {n_rows})")
            return torch.as_tensor(a, dtype=torch.int32, device=plan.device)

        fwd_maps, rev_maps = [], []
        shape = list(local_shape)
        for pulse in plan.sched.serialized_order():
            d, w, off = pulse.dim, pulse.width, pulse.offset
            if w:
                fwd_maps.append(rows(shape, d, off, off + w))
                shape[d] += w
            else:
                fwd_maps.append(None)
        for pulse in reversed(plan.sched.serialized_order()):
            d, w, off = pulse.dim, pulse.width, pulse.offset
            if w:
                n = shape[d] - w
                pack_idx = rows(shape, d, n, shape[d])
                shape[d] = n
                add_idx = rows(shape, d, off, off + w)
                rev_maps.append((pack_idx, add_idx))
            else:
                rev_maps.append(None)
        plan._index_maps[local_shape] = (tuple(fwd_maps), tuple(rev_maps))
        return plan._index_maps[local_shape]

    @staticmethod
    def _rows2d(x: torch.Tensor, nd: int, d: int) -> torch.Tensor:
        """``(n_dom, prod(local[:d+1]), -1)`` view of a block tensor."""
        n_dom = math.prod(x.shape[:nd])
        return x.contiguous().reshape(n_dom, math.prod(x.shape[nd:nd + d + 1]),
                                      -1)

    def fwd(self, plan, local, wrap_shift):
        sched = plan.sched
        nd = plan.spec.ndim
        shifter = _halo._Shifter(plan.axis_sizes, wrap_shift)
        fwd_maps, _ = self._maps(plan, tuple(local.shape[nd:2 * nd]))
        ext = local
        for pulse, idx in zip(sched.serialized_order(), fwd_maps):
            if idx is None:
                continue
            d, w = pulse.dim, pulse.width
            shape = ext.shape
            slab = halo_pack.pack(self._rows2d(ext, nd, d), idx).reshape(
                shape[:nd + d] + (w,) + shape[nd + d + 1:])
            recv = shifter(_halo.recv_from_next(slab, d), d)
            ext = torch.cat([ext, recv], dim=nd + d)
        return ext

    def rev(self, plan, ext):
        sched = plan.sched
        nd = plan.spec.ndim
        _, rev_maps = self._maps(plan, self._local_shape(plan, ext))
        out = ext
        for pulse, maps in zip(reversed(sched.serialized_order()), rev_maps):
            if maps is None:
                continue
            pack_idx, add_idx = maps
            d, w = pulse.dim, pulse.width
            shape = out.shape
            halo_rows = halo_pack.pack(self._rows2d(out, nd, d), pack_idx)
            slab = halo_rows.reshape(shape[:nd + d] + (w,)
                                     + shape[nd + d + 1:])
            recv = _halo.recv_from_prev(slab, d)
            body = out.narrow(nd + d, 0, shape[nd + d] - w)
            body2d = self._rows2d(body, nd, d)
            rows = recv.reshape(body2d.shape[0], add_idx.shape[0], -1)
            out = halo_pack.unpack_add(body2d, add_idx,
                                       rows).reshape(body.shape)
        return out


_BACKENDS: Dict[str, Callable[[], HaloBackend]] = {}


def register_backend(name: str, factory: Callable[[], HaloBackend]) -> None:
    """Register a halo backend under ``name`` (the config axis value)."""
    _BACKENDS[name] = factory


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def get_backend(name: str) -> HaloBackend:
    try:
        return _BACKENDS[name]()
    except KeyError:
        raise ValueError(
            f"unknown halo backend {name!r}; "
            f"available: {available_backends()}") from None


register_backend("serialized", SerializedBackend)
register_backend("fused", FusedBackend)
register_backend("pallas", PallasBackend)


# --------------------------------------------------------------------------
# byte / critical-path accounting
# --------------------------------------------------------------------------

# default link model for the latency term in HaloPlan.stats: an
# InfiniBand-class inter-node hop (~1.5 us) at NVLink-class payload
# bandwidth; both are per-call configurable
DEFAULT_LINK_LATENCY_S = 1.5e-6
DEFAULT_BANDWIDTH_BPS = 5.0e10


def compute_exchange_stats(sched: PulseSchedule,
                           local_shape: Sequence[int],
                           itemsize: int,
                           feature_elems: int = 1) -> dict:
    """Bytes moved per phase/pulse and the two critical-path models.

    Both designs move the same regions, hence the single ``total_bytes``;
    the serialized design chains every pulse's full slab, the fused one
    only the largest transfer of each phase.  ``exchanged_cells`` is the
    exchanged region volume in cells, from which every byte field derives.
    """
    ndim = sched.ndim
    widths = sched.widths

    def vol_cells(region: Region) -> int:
        v = 1
        for d in range(ndim):
            v *= widths[d] if d in region else local_shape[d]
        return v

    def vol(region: Region) -> int:
        return vol_cells(region) * feature_elems * itemsize

    ser_pulse_bytes = []
    shape = list(local_shape)
    for pulse in sched.serialized_order():
        d = pulse.dim
        slab = 1
        for k in range(ndim):
            slab *= pulse.width if k == d else shape[k]
        ser_pulse_bytes.append(slab * feature_elems * itemsize)
        shape[d] += pulse.width

    fused_phases = []
    for phase in sched.forward_phases():
        fused_phases.append({
            "regions": [{"dims": r, "bytes": vol(r)} for r in phase],
            "phase_bytes": sum(vol(r) for r in phase),
            "phase_critical_bytes": max((vol(r) for r in phase), default=0),
        })

    cells = sum(vol_cells(r) for phase in sched.forward_phases()
                for r in phase)
    total = sum(p["phase_bytes"] for p in fused_phases)
    if total != cells * feature_elems * itemsize or \
            total != sum(ser_pulse_bytes):
        raise AssertionError("slab/region accounting mismatch")
    return {
        "exchanged_cells": cells,
        "total_bytes": total,
        "serialized_pulse_bytes": ser_pulse_bytes,
        "serialized_critical_bytes": sum(ser_pulse_bytes),
        "fused_phases": fused_phases,
        "fused_critical_bytes": sum(p["phase_critical_bytes"]
                                    for p in fused_phases),
        "dependent_fraction": sched.dependent_fraction(local_shape),
    }


def latency_model(stats: dict,
                  link_latency_s: float = DEFAULT_LINK_LATENCY_S,
                  bandwidth_Bps: float = DEFAULT_BANDWIDTH_BPS) -> dict:
    """alpha-beta time model for one exchange direction (paper §6.2).

    The serialized design pays ``alpha + bytes / BW`` per chained message;
    the fused design one ``alpha`` per phase plus its largest transfer.
    """
    ser_msgs = [b for b in stats["serialized_pulse_bytes"] if b > 0]
    phases = [p for p in stats["fused_phases"] if p["phase_bytes"] > 0]
    serialized_s = sum(link_latency_s + b / bandwidth_Bps for b in ser_msgs)
    fused_s = sum(link_latency_s + p["phase_critical_bytes"] / bandwidth_Bps
                  for p in phases)
    return {
        "link_latency_s": link_latency_s,
        "bandwidth_Bps": bandwidth_Bps,
        "serialized_messages": len(ser_msgs),
        "fused_phase_messages": [len(p["regions"]) for p in phases],
        "serialized_time_s": serialized_s,
        "fused_time_s": fused_s,
        "fused_speedup": serialized_s / fused_s if fused_s else 1.0,
    }


def overlap_model(stats: dict, critical_path: str,
                  pipeline: str = "off", depth: int = 2) -> dict:
    """Per-step exposed-vs-overlapped communication under a step pipeline.

    ``pipeline="off"`` leaves both directions' stages exposed;
    ``"double_buffer"`` at window ``depth`` hides the whole reverse
    exchange and all but ``1 / (depth - 1)`` of the forward stages.
    An analytic model, as in the reference.
    """
    if critical_path == "serialized":
        stages = len([b for b in stats["serialized_pulse_bytes"] if b > 0])
    else:
        stages = len([p for p in stats["fused_phases"]
                      if p["phase_bytes"] > 0])
    if pipeline == "double_buffer":
        if depth < 2:
            raise ValueError("double_buffer overlap model needs depth >= 2")
        window = depth - 1
        exposed = stages / window
        overlapped_stages = 2 * stages - exposed
        overlapped_bytes = int(round(
            stats["total_bytes"] * (2 - 1 / window)))
    else:
        depth = 1
        exposed = 2 * stages
        overlapped_bytes = 0
        overlapped_stages = 0
    return {
        "pipeline": pipeline,
        "depth": depth,
        "exposed_phases_per_step": exposed,
        "overlapped_phases_per_step": overlapped_stages,
        "overlapped_bytes_per_step": overlapped_bytes,
        "exchanged_bytes_per_step": 2 * stats["total_bytes"],
    }


# --------------------------------------------------------------------------
# plan
# --------------------------------------------------------------------------

class HaloPlan:
    """Construct-once / execute-many halo exchange on a virtual mesh.

    Build with :meth:`HaloPlan.build`; execute with :meth:`fwd` /
    :meth:`rev` (or their aliases :meth:`fwd_local` / :meth:`rev_local`,
    kept so that engine code reads as in the reference).  Block tensors
    must lie on the plan's device.
    """

    def __init__(self, spec: HaloSpec, mesh: DomainMesh, device="cuda",
                 verify: str = "error"):
        for a in spec.axis_names:
            if a not in mesh.shape:
                raise ValueError(f"mesh has no axis {a!r}; "
                                 f"mesh axes: {tuple(mesh.shape)}")
        if verify not in VERIFY_MODES:
            raise ValueError(f"unknown verify mode {verify!r}; "
                             f"available: {VERIFY_MODES}")
        if spec.wire_dtype is not None:
            raise NotImplementedError(
                f"wire_dtype={spec.wire_dtype!r} is not ported yet: "
                "compressed halo payloads come with the wire-compression "
                "slice of the port")
        self.device = resolve_device(device)
        self.spec = spec
        self.mesh = mesh
        self.backend = get_backend(spec.backend)
        # nonsense (widths, pulses) combinations fail here, with the
        # verifier's messages
        self.sched: PulseSchedule = check_halo_config(
            spec.axis_names, spec.widths, spec.pulses)
        self.axis_sizes: Tuple[int, ...] = tuple(
            int(mesh.shape[a]) for a in spec.axis_names)
        self._wrap = spec.wrap_shift_array(self.device)
        self._index_maps: Dict[Tuple[int, ...], Any] = {}
        self._stats_cache: Dict[Tuple, dict] = {}

    @classmethod
    def build(cls, spec: HaloSpec, mesh: DomainMesh, device="cuda",
              verify: str = "error") -> "HaloPlan":
        return cls(spec, mesh, device=device, verify=verify)

    # -- introspection -----------------------------------------------------

    def extended_shape(self, local_shape: Sequence[int]) -> Tuple[int, ...]:
        """Per-domain extended-block shape for a given local block shape."""
        out = list(local_shape)
        for d, w in enumerate(self.spec.widths):
            out[d] += w
        return tuple(out)

    def stats(self, local_shape: Sequence[int],
              itemsize: Optional[int] = None,
              feature_elems: Optional[int] = None,
              pipeline: str = "off", depth: int = 2,
              link_latency_s: float = DEFAULT_LINK_LATENCY_S,
              bandwidth_Bps: float = DEFAULT_BANDWIDTH_BPS,
              index_elems: int = 0, index_itemsize: int = 4,
              occupancy: Optional[float] = None) -> dict:
        """Byte / critical-path stats for this plan's schedule, with the
        alpha-beta ``latency`` model, the step-``pipeline`` overlap model,
        the side-channel index bytes and the occupancy-adjusted
        ``useful_bytes``; the dense wire fields equal the payload's."""
        if itemsize is None:
            itemsize = int(np.dtype(self.spec.dtype).itemsize)
        if feature_elems is None:
            feature_elems = self.spec.feature_elems
        key = (tuple(local_shape), itemsize, feature_elems, pipeline,
               depth, link_latency_s, bandwidth_Bps, index_elems,
               index_itemsize, occupancy)
        if key not in self._stats_cache:
            stats = dict(compute_exchange_stats(
                self.sched, tuple(local_shape), itemsize, feature_elems))
            cells = stats["exchanged_cells"]
            stats["bytes_index"] = cells * index_elems * index_itemsize
            stats["occupancy"] = occupancy
            stats["useful_bytes"] = (
                None if occupancy is None
                else int(round(stats["total_bytes"] * occupancy)))
            # payloads ride dense in this slice: both directions at the
            # payload itemsize, no scale words
            stats["wire_dtype"] = None
            stats["wire_itemsize_fwd"] = itemsize
            stats["wire_itemsize_rev"] = itemsize
            stats["wire_itemsize"] = itemsize
            stats["wire_bytes_fwd"] = cells * feature_elems * itemsize
            stats["wire_bytes_rev"] = cells * feature_elems * itemsize
            stats["wire_bytes"] = (stats["wire_bytes_fwd"]
                                   + stats["wire_bytes_rev"])
            stats["wire_reduction"] = (
                2 * stats["total_bytes"] / stats["wire_bytes"]
                if stats["wire_bytes"] else 1.0)
            stats["latency"] = latency_model(stats, link_latency_s,
                                             bandwidth_Bps)
            overlap = overlap_model(stats, self.backend.critical_path,
                                    pipeline, depth)
            stats["overlap"] = overlap
            stats["exposed_phases_per_step"] = \
                overlap["exposed_phases_per_step"]
            stats["overlapped_bytes_per_step"] = \
                overlap["overlapped_bytes_per_step"]
            self._stats_cache[key] = stats
        return self._stats_cache[key]

    # -- execution ---------------------------------------------------------

    def _resolve_shift(self, wrap_shift):
        if wrap_shift is _UNSET:
            return self._wrap
        if wrap_shift is None:
            return None
        return torch.as_tensor(wrap_shift, device=self.device)

    def _check(self, x: torch.Tensor) -> None:
        nd = self.spec.ndim
        if x.device != self.device:
            raise ValueError(f"block tensor on {x.device}, plan on "
                             f"{self.device}")
        if tuple(x.shape[:nd]) != self.axis_sizes:
            raise ValueError(
                f"leading domain dims {tuple(x.shape[:nd])} do not match "
                f"the mesh {self.axis_sizes} (axes {self.spec.axis_names})")

    def fwd(self, local: torch.Tensor, wrap_shift=_UNSET) -> torch.Tensor:
        """Coordinate exchange: ``(*domains, *local)`` -> extended blocks
        (each local dim ``d`` grows by ``widths[d]``)."""
        self._check(local)
        return self.backend.fwd(self, local, self._resolve_shift(wrap_shift))

    def rev(self, ext: torch.Tensor) -> torch.Tensor:
        """Force-return exchange (adjoint of :meth:`fwd`)."""
        self._check(ext)
        return self.backend.rev(self, ext)

    # the reference's device-local names; every call here sees all domains
    fwd_local = fwd
    rev_local = rev

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "HaloPlan.exchange (the autograd exchange whose backward is "
            "the reverse path) is not ported yet: it comes with a later "
            "slice of the port")

    def __repr__(self):
        return (f"HaloPlan(backend={self.spec.backend!r}, "
                f"axes={self.spec.axis_names}, widths={self.spec.widths}, "
                f"mesh={self.mesh.shape}, device={str(self.device)!r})")


# the "signal" backend lives with the step pipeline and registers on
# import; the cycle is benign (it only uses names defined above)
import repro_torch.core.pipeline.signal_backend  # noqa: E402,F401
