"""Plan-based halo exchange on the virtual domain mesh.

The port of the JAX package's ``core/halo_plan.py``: a frozen
:class:`HaloSpec`, a construct-once :class:`HaloPlan` bound to a
:class:`~repro_torch.launch.mesh.DomainMesh` and a device, and the
``serialized`` / ``fused`` / ``pallas`` backends.  The ``"pallas"`` name
is kept so that specs read alike in both packages; here it drives the
CUDA pack / unpack-add kernels of :mod:`repro_torch.kernels.halo_pack`.

Compressed payloads (``HaloSpec.wire_dtype``, :mod:`repro_torch.core.wire`)
are quantized at the plan seam, as in the reference: :meth:`HaloPlan.fwd`
grids an f64 payload to the float32 floor before the sends and splices
the exact body back; :meth:`HaloPlan.rev` rounds the force return to the
named format.  The pallas and signal backends then ship f32 rows through
the kernels' converting forms (quantize-into-pack).  One deliberate
difference: they apply the periodic wrap shifts after the exchange, not
per hop, so every row they convert is a copy of a gridded payload row and
the cast is exact.  The reference shifts per hop and its kernels round
the shifted rows a later dim forwards (the corner and edge cells) once
more, so with wrap shifts its pallas and signal backends differ from its
serialized one; here every backend gives the serialized result.

Block tensors carry every domain: ``(D_0, .., D_{nd-1}, *local)`` with
one leading dim per decomposed axis, in ``spec.axis_names`` order.  A
lane plan (:meth:`HaloPlan.with_lanes`) takes ``(R, D_0, .., *local)``:
``R`` independent replicas of the domain grid (the MD server's lanes),
each exchanged as the plain plan exchanges one, with one launch of each
kernel for all of them.  The
pure-arithmetic accounting (:func:`compute_exchange_stats`,
:func:`latency_model`, :func:`overlap_model`, :meth:`HaloPlan.stats`)
returns the same dicts as the reference for the same spec and local
shape.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.analysis.schedule_verifier import (
    VERIFY_MODES,
    check_halo_config,
)
from repro_torch.core import halo as _halo
from repro_torch.core import wire as _wire
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
    ``wire_dtype`` (one of :data:`repro_torch.core.wire.WIRE_DTYPES`)
    compresses floating payloads: the coordinate (forward) direction at
    the float32 floor, the force return in the named format; integer
    payloads (the MD engine's ``cell_i`` exchange) ride dense.
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
        if self.wire_dtype is not None and \
                self.wire_dtype not in _wire.WIRE_DTYPES:
            raise ValueError(
                f"unknown wire_dtype {self.wire_dtype!r}; "
                f"available: {_wire.WIRE_DTYPES} or None")
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
            wrap_shift: Optional[torch.Tensor], slot: int = 0
            ) -> torch.Tensor:
        raise NotImplementedError

    def rev(self, plan: "HaloPlan", ext: torch.Tensor, slot: int = 0
            ) -> torch.Tensor:
        raise NotImplementedError

    def ships_fwd_wire(self, plan: "HaloPlan",
                       local_shape: Sequence[int]) -> bool:
        """Whether the forward direction ships the plan's wire dtype at
        this local shape (what :meth:`HaloPlan.stats` accounts)."""
        return True

    def _local_shape(self, plan: "HaloPlan", ext: torch.Tensor
                     ) -> Tuple[int, ...]:
        L = plan.n_lead
        return tuple(ext.shape[L + d] - plan.spec.widths[d]
                     for d in range(plan.spec.ndim))


class SerializedBackend(HaloBackend):
    """MPI-like baseline: one full slab per pulse, sequential."""

    name = "serialized"

    def fwd(self, plan, local, wrap_shift, slot=0):
        return _halo.exchange_fwd_serialized(local, plan.sched,
                                             plan.axis_sizes, wrap_shift,
                                             plan.lead)

    def rev(self, plan, ext, slot=0):
        return _halo.exchange_rev_serialized(ext, plan.sched,
                                             plan.axis_sizes, plan.lead)


class FusedBackend(HaloBackend):
    """Dependency-partitioned phases (paper Alg. 3/4/6)."""

    name = "fused"
    critical_path = "fused"

    def fwd(self, plan, local, wrap_shift, slot=0):
        return _halo.exchange_fwd_fused(local, plan.sched, plan.axis_sizes,
                                        wrap_shift, plan.lead)

    def rev(self, plan, ext, slot=0):
        return _halo.exchange_rev_fused(ext, plan.sched, plan.axis_sizes,
                                        self._local_shape(plan, ext),
                                        plan.lead)


class RevMaps(NamedTuple):
    """One reverse pulse's maps (int32, on the plan's device): the halo
    rows it packs, the body rows it adds them into, and that map's
    inverse (:func:`repro_torch.kernels.halo_pack.inverse_map`), which
    ``unpack_add``'s kernel reads."""

    pack_idx: torch.Tensor
    add_idx: torch.Tensor
    add_inv: torch.Tensor


class PallasBackend(HaloBackend):
    """Pack / unpack-add through the CUDA kernels of ``kernels.halo_pack``.

    Each pulse is pack (gather into a contiguous send buffer, paper
    Alg. 3 line 7) -> neighbour shift (the put) -> concat or unpack-add.
    The index maps are static per local shape, built once and kept on
    the plan's device as int32 (the paper's DD-time index-map build).
    One launch serves every domain: a block viewed as
    ``(n_dom, prod(local[:d+1]), -1)`` numbers its rows per domain
    exactly as the reference's ``reshape(prod(shape[:d+1]), -1)``, so
    the same map holds for all domains (and, on a lane plan, for every
    lane's domains: lanes only multiply ``n_dom``).  Pulses run in
    serialized order, so the serialized critical-path model applies.  On a CUDA block the
    kernels run or raise; on a CPU block their plain forms run.

    With an f64 payload under a wire format the forward packs convert to
    f32 rows (B1w) and the receiver casts back; the wrap shifts then wait
    until every halo has arrived (:meth:`_fwd_wire`).
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
        """The forward pulses' pack maps and the reverse pulses'
        :class:`RevMaps`, built once per local shape."""
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
            return torch.as_tensor(a, dtype=torch.int32)

        fwd_maps, rev_maps = [], []
        shape = list(local_shape)
        for pulse in plan.sched.serialized_order():
            d, w, off = pulse.dim, pulse.width, pulse.offset
            if w:
                fwd_maps.append(rows(shape, d, off, off + w).to(plan.device))
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
                # unpack_add's kernel reads the inverse (a repeated row
                # raises here)
                add_inv = halo_pack.inverse_map(add_idx,
                                                math.prod(shape[:d + 1]))
                rev_maps.append(RevMaps(*(t.to(plan.device) for t in (
                    pack_idx, add_idx, add_inv))))
            else:
                rev_maps.append(None)
        plan._index_maps[local_shape] = (tuple(fwd_maps), tuple(rev_maps))
        return plan._index_maps[local_shape]

    def ships_fwd_wire(self, plan, local_shape: Sequence[int]) -> bool:
        """False for a plan with a pulse that forwards its own dim's halo
        (a halo wider than the block, several hops): see :meth:`_fwd_wire`."""
        return not any(p.offset + p.width > local_shape[p.dim]
                       for p in plan.sched.serialized_order())

    def _fwd_wire(self, plan, local: torch.Tensor) -> Optional[str]:
        """The forward packs' wire dtype, or None to ship dense.

        The payload reaching the backend is already on the float32 grid
        (the plan seam rounded it), so converting a packed row is exact
        as long as the row is a copy of a payload row.  The wrap shifts
        break that (a shifted coordinate is off the grid), so the wire
        path ships unshifted rows and :meth:`_shift_halos` applies the
        shifts afterwards.  A multi-hop plan would need them per hop: it
        ships dense, and :meth:`HaloPlan.stats` counts its forward bytes
        dense.
        """
        L = plan.n_lead
        if not self.ships_fwd_wire(plan,
                                   local.shape[L:L + plan.spec.ndim]):
            return None
        return plan.wire_pack_dtype(local.dtype)

    @staticmethod
    def _shift_halos(plan, ext: torch.Tensor, wrap_shift,
                     local_shape: Sequence[int]) -> torch.Tensor:
        """Add the wrap shifts to ``ext``'s halos in place, dim by dim in
        pulse order: every element gets the additions the serialized
        exchange gives it, in the same order (a halo cell of dim ``d``
        holds the same shifts of earlier dims whichever domain along
        ``d`` forwarded it), so the result is the serialized one."""
        if wrap_shift is None:
            return ext
        L = plan.n_lead
        shifter = _halo._Shifter(plan.axis_sizes, wrap_shift, plan.lead)
        for d, w in enumerate(plan.spec.widths):
            if w:
                halo = ext.narrow(L + d, local_shape[d], w)
                halo.copy_(shifter(halo, d))
        return ext

    @staticmethod
    def _rows2d(x: torch.Tensor, nd: int, d: int) -> torch.Tensor:
        """``(n_dom, prod(local[:d+1]), -1)`` view of a block tensor."""
        n_dom = math.prod(x.shape[:nd])
        return x.contiguous().reshape(n_dom, math.prod(x.shape[nd:nd + d + 1]),
                                      -1)

    def fwd(self, plan, local, wrap_shift, slot=0):
        sched = plan.sched
        nd = plan.n_lead
        local_shape = tuple(local.shape[nd:nd + plan.spec.ndim])
        wire = self._fwd_wire(plan, local)
        shifter = _halo._Shifter(plan.axis_sizes,
                                 wrap_shift if wire is None else None,
                                 plan.lead)
        fwd_maps, _ = self._maps(plan, local_shape)
        ext = local
        for pulse, idx in zip(sched.serialized_order(), fwd_maps):
            if idx is None:
                continue
            d, w = pulse.dim, pulse.width
            shape = ext.shape
            slab = halo_pack.pack(self._rows2d(ext, nd, d), idx,
                                  wire_dtype=wire).reshape(
                shape[:nd + d] + (w,) + shape[nd + d + 1:])
            recv = _halo.recv_from_next(slab, plan.lead + d)
            if wire is not None:
                recv = recv.to(local.dtype)     # dequantize after receive
            ext = torch.cat([ext, shifter(recv, d)], dim=nd + d)
        if wire is not None:
            ext = self._shift_halos(plan, ext, wrap_shift, local_shape)
        return ext

    def rev(self, plan, ext, slot=0):
        sched = plan.sched
        nd = plan.n_lead
        _, rev_maps = self._maps(plan, self._local_shape(plan, ext))
        out = ext
        for pulse, maps in zip(reversed(sched.serialized_order()), rev_maps):
            if maps is None:
                continue
            d, w = pulse.dim, pulse.width
            shape = out.shape
            halo_rows = halo_pack.pack(self._rows2d(out, nd, d),
                                       maps.pack_idx)
            slab = halo_rows.reshape(shape[:nd + d] + (w,)
                                     + shape[nd + d + 1:])
            recv = _halo.recv_from_prev(slab, plan.lead + d)
            body = out.narrow(nd + d, 0, shape[nd + d] - w)
            body2d = self._rows2d(body, nd, d)
            rows = recv.reshape(body2d.shape[0], maps.add_idx.shape[0], -1)
            out = halo_pack.unpack_add(body2d, maps.add_idx, rows,
                                       maps.add_inv).reshape(body.shape)
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
    kept so that engine code reads as in the reference) or the
    differentiable :meth:`exchange`.  Block tensors must lie on the
    plan's device.
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
        self.device = resolve_device(device)
        self.spec = spec
        self.mesh = mesh
        self.backend = get_backend(spec.backend)
        # the wire-format gate first: a format whose measured NVE drift
        # exceeds the dense-f32 bound is rejected here (verify="warn" /
        # "off" are the escape hatches); the int8 scale is one per domain
        self.wire = _wire.make_codec(spec.wire_dtype, n_lead=spec.ndim)
        self.wire_drift = _wire.gate_wire_config(spec.wire_dtype, verify)
        # nonsense (widths, pulses) combinations fail here, with the
        # verifier's messages
        self.sched: PulseSchedule = check_halo_config(
            spec.axis_names, spec.widths, spec.pulses)
        self.axis_sizes: Tuple[int, ...] = tuple(
            int(mesh.shape[a]) for a in spec.axis_names)
        self._wrap = spec.wrap_shift_array(self.device)
        self._index_maps: Dict[Tuple[int, ...], Any] = {}
        self._stats_cache: Dict[Tuple, dict] = {}
        # replica lanes in front of the domain grid (with_lanes): 0 / None
        # on a plain plan
        self.lead = 0
        self.lanes: Optional[int] = None

    @classmethod
    def build(cls, spec: HaloSpec, mesh: DomainMesh, device="cuda",
              verify: str = "error") -> "HaloPlan":
        return cls(spec, mesh, device=device, verify=verify)

    def with_lanes(self, lanes: int) -> "HaloPlan":
        """This plan over ``lanes`` independent replicas of its domain
        grid: block tensors ``(lanes, *domains, *local)``.  Each lane is
        exchanged exactly as this plan exchanges a block (its halos never
        cross the lane dim), with one launch of each kernel serving every
        lane: the pack / unpack-add maps are this plan's, lanes only
        multiply the domain count of a launch, and the signal kernels
        ring over the ``(lanes, *domains)`` mesh along axis ``1 + d``.
        The lane plan keeps its own index maps and signal words (sized
        for ``lanes`` times the domains) and its own wire codec (one
        int8 scale per lane and domain)."""
        if self.lead:
            raise ValueError("with_lanes on a lane plan: lanes do not nest")
        if int(lanes) < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        plan = object.__new__(type(self))
        plan.__dict__.update(self.__dict__)
        plan.lead = 1
        plan.lanes = int(lanes)
        plan.wire = _wire.make_codec(self.spec.wire_dtype,
                                     n_lead=1 + self.spec.ndim)
        plan._index_maps = {}
        return plan

    @property
    def n_lead(self) -> int:
        """Leading dims of a block tensor before its local block: the
        lanes (on a lane plan) and the domain grid."""
        return self.lead + self.spec.ndim

    @property
    def block_dims(self) -> Tuple[int, ...]:
        """The leading dims a block tensor must have: ``axis_sizes``, with
        the lane count in front on a lane plan (the signal kernels' ring
        mesh)."""
        return ((self.lanes,) if self.lead else ()) + self.axis_sizes

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
        the side-channel index bytes, the occupancy-adjusted
        ``useful_bytes`` and the per-direction wire accounting (with a
        wire format, ``latency_wire``: the same model at the mean wire
        itemsize)."""
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
            # per direction: coordinates (fwd) at the float32 floor (dense
            # where the backend ships them dense), the force return (rev)
            # in the named format, int8 with one 4-byte scale per
            # serialized message; ``wire_bytes`` covers both directions
            # of a step against ``2 * total_bytes`` dense
            wire = self.wire
            stats["wire_dtype"] = self.spec.wire_dtype
            stats["wire_itemsize_fwd"] = (
                itemsize if wire is None
                or not self.backend.ships_fwd_wire(self, local_shape)
                else wire.fwd_itemsize(self.spec.dtype))
            stats["wire_itemsize_rev"] = (itemsize if wire is None
                                          else wire.wire_itemsize)
            stats["wire_itemsize"] = stats["wire_itemsize_rev"]
            n_msgs = len([b for b in stats["serialized_pulse_bytes"]
                          if b > 0])
            scale_overhead = (0 if wire is None or wire.is_float
                              else 4 * n_msgs)
            stats["wire_bytes_fwd"] = (cells * feature_elems
                                       * stats["wire_itemsize_fwd"])
            stats["wire_bytes_rev"] = (cells * feature_elems
                                       * stats["wire_itemsize_rev"]
                                       + scale_overhead)
            stats["wire_bytes"] = (stats["wire_bytes_fwd"]
                                   + stats["wire_bytes_rev"])
            stats["wire_reduction"] = (
                2 * stats["total_bytes"] / stats["wire_bytes"]
                if stats["wire_bytes"] else 1.0)
            stats["latency"] = latency_model(stats, link_latency_s,
                                             bandwidth_Bps)
            if wire is not None:
                # the same alpha-beta model at the mean wire itemsize:
                # latency terms unchanged, bandwidth terms scaled
                mean_itemsize = (stats["wire_itemsize_fwd"]
                                 + stats["wire_itemsize_rev"]) / 2
                lat_w = latency_model(
                    compute_exchange_stats(self.sched, tuple(local_shape),
                                           mean_itemsize, feature_elems),
                    link_latency_s, bandwidth_Bps)
                lat_w["wire_speedup_fused"] = (
                    stats["latency"]["fused_time_s"] / lat_w["fused_time_s"]
                    if lat_w["fused_time_s"] else 1.0)
                lat_w["wire_speedup_serialized"] = (
                    stats["latency"]["serialized_time_s"]
                    / lat_w["serialized_time_s"]
                    if lat_w["serialized_time_s"] else 1.0)
                stats["latency_wire"] = lat_w
            overlap = overlap_model(stats, self.backend.critical_path,
                                    pipeline, depth)
            stats["overlap"] = overlap
            stats["exposed_phases_per_step"] = \
                overlap["exposed_phases_per_step"]
            stats["overlapped_bytes_per_step"] = \
                overlap["overlapped_bytes_per_step"]
            self._stats_cache[key] = stats
        return self._stats_cache[key]

    def publish_stats(self, registry, local_shape: Sequence[int],
                      **kw) -> dict:
        """:meth:`stats`, also published as a ``halo_stats`` record (with
        the backend's critical-path model, which the Perfetto exporter's
        predicted lanes key on) into ``registry``, a
        :class:`~repro_torch.obs.registry.MetricsRegistry`.  The registry
        stays out of the stats cache key."""
        stats = self.stats(local_shape, **kw)
        registry.emit("halo_stats", backend=self.spec.backend,
                      critical_path=self.backend.critical_path,
                      local_shape=tuple(local_shape), data=stats)
        return stats

    # -- execution ---------------------------------------------------------

    def _resolve_shift(self, wrap_shift):
        if wrap_shift is _UNSET:
            return self._wrap
        if wrap_shift is None:
            return None
        return torch.as_tensor(wrap_shift, device=self.device)

    def _check(self, x: torch.Tensor) -> None:
        nd = self.n_lead
        if x.device != self.device:
            raise ValueError(f"block tensor on {x.device}, plan on "
                             f"{self.device}")
        if tuple(x.shape[:nd]) != self.block_dims:
            raise ValueError(
                f"leading domain dims {tuple(x.shape[:nd])} do not match "
                f"the mesh {self.block_dims} (axes "
                f"{('lanes',) * self.lead + self.spec.axis_names})")

    def _wire_active(self, x: torch.Tensor) -> bool:
        """Wire compression applies to floating payloads only: integer
        side channels (the MD engine's ``cell_i`` exchange) ride dense."""
        return self.wire is not None and x.is_floating_point()

    def wire_pack_dtype(self, dtype: torch.dtype) -> Optional[str]:
        """Wire dtype of the forward direction's converting pack / put
        kernels: the float32 floor, so f64 payloads pack f32 rows and
        narrower (or integer) payloads pack dense."""
        if self.wire is None or not dtype.is_floating_point:
            return None
        return self.wire.fwd_wire_dtype(dtype)

    def _body_idx(self, local_shape: Sequence[int]) -> Tuple[slice, ...]:
        """Index of every domain's local body inside extended blocks
        (halos are appended at the high end of each decomposed dim)."""
        return (slice(None),) * self.n_lead + tuple(
            slice(0, int(n)) for n in local_shape)

    def fwd(self, local: torch.Tensor, wrap_shift=_UNSET, slot: int = 0
            ) -> torch.Tensor:
        """Coordinate exchange: ``(*domains, *local)`` -> extended blocks
        (each local dim ``d`` grows by ``widths[d]``).

        With ``spec.wire_dtype`` an f64 payload is gridded to the float32
        floor before the sends and the exact body spliced back after:
        received halo data is wire-lossy, local data never is.  ``slot``
        is the step pipeline's ledger slot: the ``signal`` backend keeps
        one set of signal words per slot, so launches of different slots
        never share a word; the other backends ignore it.
        """
        self._check(local)
        shift = self._resolve_shift(wrap_shift)
        if self.wire_pack_dtype(local.dtype) is None:
            return self.backend.fwd(self, local, shift, slot)
        # the backend's extended block is a new tensor: splice in place
        ext = self.backend.fwd(self, self.wire.fwd_roundtrip(local), shift,
                               slot)
        ext[self._body_idx(local.shape[self.n_lead:])] = local
        return ext

    def rev(self, ext: torch.Tensor, slot: int = 0) -> torch.Tensor:
        """Force-return exchange (adjoint of :meth:`fwd`).  With a wire
        format the halo-region contributions are wire-rounded before the
        return puts; the body (never sent) stays exact.  ``slot`` as in
        :meth:`fwd`."""
        self._check(ext)
        if not self._wire_active(ext):
            return self.backend.rev(self, ext, slot)
        return self.backend.rev(self, self._rev_wire(ext, None)[0], slot)

    # the reference's device-local names; every call here sees all domains
    fwd_local = fwd
    rev_local = rev

    def rev_local_ef(self, ext: torch.Tensor, ef: torch.Tensor,
                     slot: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`rev` with error-feedback state (``ext``-shaped)."""
        self._check(ext)
        q, new_ef = self._rev_wire(ext, ef)
        return self.backend.rev(self, q, slot), new_ef

    def rev_local_raw(self, ext: torch.Tensor, slot: int = 0
                      ) -> torch.Tensor:
        """Reverse exchange with no wire seam, for a buffer that is
        already wire-gridded (the step pipeline's slot ring decodes at
        drain; quantizing again would apply error feedback twice)."""
        self._check(ext)
        return self.backend.rev(self, ext, slot)

    def _rev_wire(self, ext, ef):
        q, new_ef = self.wire.roundtrip(ext, ef)
        if q is ext:            # a cast to the payload's own dtype
            return ext, new_ef
        body = self._body_idx(self.backend._local_shape(self, ext))
        q[body] = ext[body]
        return q, new_ef

    # -- wire-format slot-ring codec (pipeline extended-force buffers) -----

    def wire_encode_ext(self, F_ext: torch.Tensor,
                        ef: Optional[torch.Tensor] = None):
        """Encode an extended-force buffer into slot-ring parts:
        ``(parts, new_ef)``, the wire-dtyped tensor (and the int8 scale)
        followed by the exact body.  :meth:`wire_decode_ext` inverts it;
        the composition equals :meth:`_rev_wire` bitwise, which keeps
        ``off`` == ``double_buffer``."""
        parts, new_ef = self.wire.encode(F_ext, ef)
        body = self._body_idx(self.backend._local_shape(self, F_ext))
        return parts + (F_ext[body],), new_ef

    def wire_decode_ext(self, parts, dtype) -> torch.Tensor:
        """Decode slot-ring parts back to the wire-gridded extended-force
        buffer with the exact body spliced in (drain side)."""
        wire_parts, bodyv = parts[:-1], parts[-1]
        F = self.wire.decode(wire_parts, dtype)
        if F is wire_parts[0]:  # a cast to the payload's own dtype
            F = F.clone()
        L = self.n_lead
        F[self._body_idx(bodyv.shape[L:L + self.spec.ndim])] = bodyv
        return F

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable coordinate exchange whose backward *is* the
        reverse exchange (paper Alg. 6 as an autograd rule): a gradient
        through ``plan.exchange`` runs this plan's force-return path."""
        return _Exchange.apply(x, self)

    def __repr__(self):
        return (f"HaloPlan(backend={self.spec.backend!r}, "
                f"axes={self.spec.axis_names}, widths={self.spec.widths}, "
                f"mesh={self.mesh.shape}, device={str(self.device)!r})")


class _Exchange(torch.autograd.Function):
    """``plan.fwd`` forward, ``plan.rev`` backward.  The exchange is
    affine in ``x`` (the wrap shifts are constants), so it saves no
    residuals: the backward is the exact linear adjoint."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return plan.fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.rev(g.contiguous()), None


# the "signal" backend lives with the step pipeline and registers on
# import; the cycle is benign (it only uses names defined above)
import repro_torch.core.pipeline.signal_backend  # noqa: E402,F401
