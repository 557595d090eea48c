"""N-D staged halo exchange on the virtual domain mesh.

The port of the JAX package's ``core/halo.py``.  A block tensor holds
every domain: its leading ``nd`` dims are the domain grid (one per
decomposed axis, in the schedule's axis order) and the local block
follows, so local dim ``d`` sits at tensor dim ``nd + d``.  Every
function also takes ``lead``, a count of batch dims in front of the
domain grid (the MD server's replica lanes): domain dim ``d`` then sits
at ``lead + d`` and local dim ``d`` at ``lead + nd + d``, and no exchange
ever crosses a batch dim.

The JAX ``lax.ppermute`` along axis ``d`` becomes a roll of domain dim
``d``: ``_perm_fwd`` ("receive from the +1 neighbour") is
``torch.roll(x, -1, d)`` and ``_perm_rev`` ("send back to the +1
neighbour", i.e. receive from the -1 one) is ``torch.roll(x, +1, d)``.
``lax.axis_index(a) == n - 1`` becomes a mask over domain dim ``d``.

* :func:`exchange_fwd_serialized` — the MPI-like baseline: one full slab
  per pulse, pulses strictly sequential (each later dim forwards data
  received by the earlier one).
* :func:`exchange_fwd_fused` — the dependency-partitioned redesign
  (paper Alg. 3/4): phase 0 ships every dim's independent slab, phase
  ``p`` only the forwarded regions of depth ``p``.

The reverse (force) exchanges are the exact linear adjoints, walking the
dependency chain backwards (paper Alg. 6) and accumulating with slice
adds.  The public entry point is :class:`repro_torch.core.halo_plan.HaloPlan`.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.schedule import PulseSchedule

Region = Tuple[int, ...]


# --------------------------------------------------------------------------
# small helpers
# --------------------------------------------------------------------------

def delivered(recv: torch.Tensor) -> torch.Tensor:
    """Counts ``recv``, what one neighbour transfer delivered to every
    domain, in ``delivered.bytes`` and returns it.  The rolls below and
    the signal backend's puts call it; the dry run reads the count."""
    delivered.bytes += recv.numel() * recv.element_size()
    return recv


delivered.bytes = 0


def recv_from_next(x: torch.Tensor, d: int) -> torch.Tensor:
    """``ppermute`` with ``_perm_fwd``: domain i receives domain i+1's
    data along domain dim ``d`` (periodic)."""
    return delivered(torch.roll(x, -1, dims=d))


def recv_from_prev(x: torch.Tensor, d: int) -> torch.Tensor:
    """``ppermute`` with ``_perm_rev``: domain i receives domain i-1's
    data along domain dim ``d`` (periodic)."""
    return delivered(torch.roll(x, 1, dims=d))


def _split_high(x: torch.Tensor, axis: int, width: int):
    n = x.shape[axis] - width
    return x.narrow(axis, 0, n), x.narrow(axis, n, width)


def _add_at(x: torch.Tensor, axis: int, start: int, width: int,
            update: torch.Tensor) -> torch.Tensor:
    """``x`` with ``update`` added on ``[start, start + width)`` of
    ``axis`` (a copy; one add per element, as ``x.at[...].add``)."""
    out = x.clone()
    out.narrow(axis, start, width).add_(update)
    return out


class _Shifter:
    """Applies the paper's ``coordShift``: periodic-image shift on wrap.

    The top domain along dim ``d`` receives from domain 0, so its data
    crossed the periodic boundary and gets ``wrap_shift[d]`` added to its
    feature components (the last tensor dim).
    """

    def __init__(self, axis_sizes: Sequence[int],
                 wrap_shift: Optional[torch.Tensor], lead: int = 0):
        self.axis_sizes = tuple(axis_sizes)
        self.wrap_shift = wrap_shift
        self.lead = int(lead)

    def __call__(self, recv: torch.Tensor, d: int) -> torch.Tensor:
        if self.wrap_shift is None:
            return recv
        n = self.axis_sizes[d]
        view = [1] * recv.dim()
        view[self.lead + d] = n
        wrapped = (torch.arange(n, device=recv.device) == n - 1)
        # same arithmetic as where(wrapped, 1, 0) * shift in the reference
        mask = wrapped.to(recv.dtype).reshape(view)
        shift = self.wrap_shift[d].to(device=recv.device, dtype=recv.dtype)
        return recv + mask * shift


# --------------------------------------------------------------------------
# forward (coordinate) exchange
# --------------------------------------------------------------------------

def exchange_fwd_serialized(local: torch.Tensor, sched: PulseSchedule,
                            axis_sizes: Sequence[int],
                            wrap_shift: Optional[torch.Tensor] = None,
                            lead: int = 0) -> torch.Tensor:
    """MPI-like staged exchange: one full slab per pulse, fully sequential."""
    nd = lead + sched.ndim
    shifter = _Shifter(axis_sizes, wrap_shift, lead)
    ext = local
    for pulse in sched.serialized_order():
        d, w, off = pulse.dim, pulse.width, pulse.offset
        if w == 0:
            continue
        # the slab includes halo rows received by earlier pulses: staged
        # forwarding, which forces strict pulse ordering
        slab = ext.narrow(nd + d, off, w)
        recv = shifter(recv_from_next(slab, lead + d), d)
        ext = torch.cat([ext, recv], dim=nd + d)
    return ext


def exchange_fwd_fused(local: torch.Tensor, sched: PulseSchedule,
                       axis_sizes: Sequence[int],
                       wrap_shift: Optional[torch.Tensor] = None,
                       lead: int = 0) -> torch.Tensor:
    """Fused dependency-partitioned exchange (paper Alg. 3/4)."""
    nd = sched.ndim
    shifter = _Shifter(axis_sizes, wrap_shift, lead)
    regions: Dict[Region, torch.Tensor] = {(): local}
    for phase in sched.forward_phases():
        new: Dict[Region, torch.Tensor] = {}
        for region in phase:
            d = max(region)
            w = sched.widths[d]
            if w == 0:
                continue
            src = regions.get(tuple(k for k in region if k != d))
            if src is None:
                continue
            slab = src.narrow(lead + nd + d, 0, w)
            new[region] = shifter(recv_from_next(slab, lead + d), d)
        regions.update(new)  # phase barrier: next phase may read these
    return _assemble(regions, nd, lead)


def _assemble(regions: Dict[Region, torch.Tensor], nd: int,
              lead: int = 0) -> torch.Tensor:
    """Merge region dict into the extended block by progressive concat."""
    current = dict(regions)
    for d in range(nd - 1, -1, -1):
        merged: Dict[Region, torch.Tensor] = {}
        for key, val in current.items():
            if d in key:
                continue
            hi = current.get(tuple(sorted(key + (d,))))
            merged[key] = val if hi is None else torch.cat(
                [val, hi], dim=lead + nd + d)
        current = merged
    return current[()]


def _decompose(ext: torch.Tensor, sched: PulseSchedule,
               local_shape: Sequence[int],
               lead: int = 0) -> Dict[Region, torch.Tensor]:
    """Inverse of :func:`_assemble`: slice the extended block into regions."""
    nd = lead + sched.ndim
    regions: Dict[Region, torch.Tensor] = {}
    for region in ((),) + sched.regions():
        idx = [slice(None)] * ext.dim()
        skip = False
        for d in range(sched.ndim):
            n, w = local_shape[d], sched.widths[d]
            if d in region:
                if w == 0:
                    skip = True
                    break
                idx[nd + d] = slice(n, n + w)
            else:
                idx[nd + d] = slice(0, n)
        if not skip:
            regions[region] = ext[tuple(idx)]
    return regions


# --------------------------------------------------------------------------
# reverse (force) exchange — exact adjoint of the forward copy graph
# --------------------------------------------------------------------------

def exchange_rev_serialized(ext: torch.Tensor, sched: PulseSchedule,
                            axis_sizes: Sequence[int],
                            lead: int = 0) -> torch.Tensor:
    """MPI-like reverse: return halo contributions pulse-by-pulse (x->y->z)."""
    nd = lead + sched.ndim
    out = ext
    for pulse in reversed(sched.serialized_order()):
        d, w, off = pulse.dim, pulse.width, pulse.offset
        if w == 0:
            continue
        body, halo = _split_high(out, nd + d, w)
        out = _add_at(body, nd + d, off, w, recv_from_prev(halo, lead + d))
    return out


def exchange_rev_fused(ext: torch.Tensor, sched: PulseSchedule,
                       axis_sizes: Sequence[int],
                       local_shape: Sequence[int],
                       lead: int = 0) -> torch.Tensor:
    """Fused reverse (paper Alg. 6): deepest regions first, faces last."""
    nd = lead + sched.ndim
    regions = _decompose(ext, sched, local_shape, lead)
    for phase in sched.reverse_phases():
        recvs = []
        for region in phase:
            if region not in regions:
                continue
            d = max(region)
            w = sched.widths[d]
            recv = recv_from_prev(regions.pop(region), lead + d)
            recvs.append((tuple(k for k in region if k != d), d, w, recv))
        for dst_key, d, w, recv in recvs:
            regions[dst_key] = _add_at(regions[dst_key], nd + d, 0, w, recv)
    return regions[()]
