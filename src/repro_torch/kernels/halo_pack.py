"""Halo kernels for Hopper plus their plain forms.

Replaces the TPU kernels of ``src/repro/kernels/halo_pack.py``:

* ``pack`` and ``unpack_add`` (the ``"pallas"`` halo backend's per-pulse
  gather and force-return scatter-add), CUDA source
  ``csrc/halo_pack.cu``;
* ``put_signal`` and ``fused_pulses`` (the ``"signal"`` backend's fused
  pack + put-with-signal, one pulse or all pulses of a dim per launch),
  CUDA source ``csrc/halo_signal.cu``.

Each source's header says what bounds its kernels on an H100 (bytes, and
at the MD path's halo sizes launch latency) and what the design does
about it.

``pack`` and ``put_signal`` take ``wire_dtype=`` (compressed halo
payloads): the gathered rows are rounded to the wire dtype in registers
and only the narrow rows are stored, the reference's quantize-into-pack.
Sources f32 / f64, wires f32 (from f64), bf16 and f16, each rounded as
XLA rounds (:func:`repro_torch.core.wire.wire_cast`); a wire equal to the
source dtype is the plain bit copy.  The converting launches are counted
apart, in ``pack.wire_launches`` and ``put_signal.wire_launches``.

Every function is batched over the virtual domain mesh: ``src`` is
``(n_dom, R, F)``, domains row-major over ``mesh_shape``, and one index
map serves every domain, so a pulse is one launch whatever the domain
count.  A put to the ring neighbour along ``axis`` is a store into that
domain's receive slab: the plain forms spell it as a ``torch.roll`` of
the domain dim (``shift=-1`` is the reference's ``_perm_fwd``, ``+1`` its
``_perm_rev``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version beside it.  Each wrapper counts its launches in a
plain integer attribute (``pack.launches`` and so on), raised only where
the kernel is launched.  Every wrapper launches through
:mod:`repro_torch.kernels._launch` (entry points resolved once, one
checking pass, the raw current stream).

``unpack_add`` adds through the map's inverse (:func:`inverse_map`: for
each destination row the map position that feeds it, or -1), so its
kernel makes one pass over the destination, with no copy before it.  The
pallas backend builds each inverse once per local shape, beside the map;
a caller that passes none gets one built on the card, counted in
``unpack_add.inverse_builds``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core.wire import FP_WIRE, wire_cast
from repro_torch.kernels import _launch
from repro_torch.kernels._launch import (PTR, I64, check, refused, stream,
                                         unsupported)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.int32: "i32"}
_WIRE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}
# the converting entry points: (source, wire) element types
_CONVERTS = ((torch.float64, torch.float32), (torch.float64, torch.bfloat16),
             (torch.float64, torch.float16), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float16))


def _convert_name(src: torch.dtype, wire: torch.dtype) -> str:
    return f"{_SUFFIX[src]}_to_{_WIRE_SUFFIX[wire]}"


# The entry points.  The bit copies are keyed by element width, their
# converting forms by (source, wire) dtype, unpack-add by element type.
_PACK_ARGS = [PTR, PTR, PTR, I64, I64, I64, I64, PTR]
_PACK = _launch.Entries("halo_pack", {
    **{w: (f"halo_pack_b{w}", _PACK_ARGS) for w in (4, 8)},
    **{c: (f"halo_pack_{_convert_name(*c)}", _PACK_ARGS) for c in _CONVERTS}})
_UNPACK_ADD = _launch.Entries("halo_pack", {
    dt: (f"halo_unpack_add_{sfx}", [PTR] * 4 + [I64] * 4 + [PTR])
    for dt, sfx in _SUFFIX.items()})
_PUT_ARGS = [PTR] * 4 + [I64] * 7 + [PTR]
_PUT_SIGNAL = _launch.Entries("halo_signal", {
    **{w: (f"halo_put_signal_b{w}", _PUT_ARGS) for w in (4, 8)},
    **{c: (f"halo_put_signal_{_convert_name(*c)}", _PUT_ARGS)
       for c in _CONVERTS}})
_FUSED_PULSES = _launch.Entries("halo_signal", {
    w: (f"halo_fused_pulses_b{w}", [PTR] * 4 + [I64] * 8 + [PTR])
    for w in (4, 8)})


def _wire_dtype(src: torch.Tensor, wire_dtype) -> Optional[torch.dtype]:
    """The wire dtype a pack of ``src`` converts to, or None for the plain
    bit copy (no ``wire_dtype``, or one equal to the source's)."""
    if wire_dtype is None:
        return None
    wire = FP_WIRE.get(wire_dtype) if isinstance(wire_dtype, str) \
        else wire_dtype
    if wire == src.dtype:
        return None
    if (src.dtype, wire) not in _CONVERTS:
        raise TypeError(f"no wire conversion {src.dtype} -> {wire_dtype}: "
                        "sources float32 / float64, wires float32 (from "
                        "float64), bfloat16 and float16")
    return wire


# ---- pack -------------------------------------------------------------------

def pack_plain(src: torch.Tensor, index_map: torch.Tensor,
               wire_dtype=None) -> torch.Tensor:
    """Plain form of :func:`pack`: gather, mask, then the wire cast."""
    wire = _wire_dtype(src, wire_dtype)
    rows = src.index_select(1, index_map.clamp(min=0).long())
    rows = torch.where((index_map >= 0)[None, :, None], rows,
                       torch.zeros((), dtype=src.dtype, device=src.device))
    return rows if wire is None else wire_cast(rows, wire)


def pack(src: torch.Tensor, index_map: torch.Tensor,
         wire_dtype=None) -> torch.Tensor:
    """``out[b, m] = src[b, index_map[m]]`` (zero row where negative).

    ``src`` (n_dom, R, F) f32 / f64 / int32; ``index_map`` (M,) int32 on
    the same device, entries in ``[-1, R)``; an entry ``>= R`` raises
    here and traps the kernel on the card.  Returns (n_dom, M, F), in
    ``wire_dtype`` when one is given (a name or a torch dtype).
    """
    dev = src.get_device()
    check("src", src, 3, dev, _SUFFIX)
    check("index_map", index_map, 1, dev, torch.int32)
    wire = None if wire_dtype is None else _wire_dtype(src, wire_dtype)
    if not src.is_cuda:
        if src.is_cpu:
            return pack_plain(src, index_map, wire)
        raise unsupported("pack", src)
    n_dom, R, F = src.shape
    M = index_map.numel()
    # sizes as arguments, no dtype keyword: the cheapest allocation call
    out = src.new_empty(n_dom, M, F) if wire is None else \
        src.new_empty((n_dom, M, F), dtype=wire)
    if not (n_dom and M and F):
        return out
    fn = _PACK[src.element_size() if wire is None else (src.dtype, wire)]
    rc = fn(src.data_ptr(), index_map.data_ptr(), out.data_ptr(), n_dom, R,
            M, F, stream(dev))
    if rc:
        raise refused(fn, rc)
    if wire is None:
        pack.launches += 1
    else:
        pack.wire_launches += 1
    return out


pack.launches = 0
pack.wire_launches = 0


# ---- unpack_add -------------------------------------------------------------

def inverse_map(index_map, R: int) -> torch.Tensor:
    """The inverse of a row map: ``inv`` (R,) int32 with ``inv[index_map[m]]
    = m`` and -1 at every row the map does not name, on ``index_map``'s
    device.  Checked on the host: an entry outside ``[0, R)`` raises
    IndexError, a repeated one ValueError (:func:`unpack_add` gives each
    destination row at most one received row)."""
    idx = torch.as_tensor(index_map)
    host = idx.to("cpu", torch.int64)
    if host.dim() != 1:
        raise ValueError(f"index_map must be 1-D, got shape "
                         f"{tuple(host.shape)}")
    M = host.shape[0]
    if M and not (int(host.min()) >= 0 and int(host.max()) < R):
        raise IndexError(f"inverse_map: index outside [0, {R})")
    inv = torch.full((R,), -1, dtype=torch.int32)
    inv[host] = torch.arange(M, dtype=torch.int32)
    if int((inv >= 0).sum()) != M:
        raise ValueError("inverse_map: the map names a row more than once; "
                         "unpack_add needs unique rows")
    return inv.to(idx.device)


def _inverse_on_device(index_map: torch.Tensor, R: int) -> torch.Tensor:
    """:func:`inverse_map` built where ``index_map`` lies, without a host
    sync: an entry outside ``[0, R)`` fails ``scatter_``'s device assert,
    a repeated one the ``_assert_async`` of the round trip."""
    M = index_map.shape[0]
    pos = torch.arange(M, dtype=torch.int32, device=index_map.device)
    inv = torch.full((R,), -1, dtype=torch.int32, device=index_map.device)
    inv.scatter_(0, index_map.long(), pos)
    torch._assert_async(torch.all(inv.index_select(0, index_map) == pos))
    return inv


def unpack_add_plain(dst: torch.Tensor, index_map: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """Plain form of :func:`unpack_add`: clone plus an indexed add (the
    indices are unique, so every element gets exactly one add)."""
    if index_map.numel() and int(index_map.min()) < 0:
        raise IndexError("unpack_add: negative index in the map")
    out = dst.clone()
    idx = index_map.long()
    out[:, idx] = out[:, idx] + rows
    return out


def unpack_add(dst: torch.Tensor, index_map: torch.Tensor,
               rows: torch.Tensor,
               inverse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = dst; out[b, index_map[m]] += rows[b, m]``.

    ``dst`` (n_dom, R, F), ``rows`` (n_dom, M, F) of the same dtype;
    ``index_map`` (M,) int32, unique entries in ``[0, R)``; an entry
    outside raises here (and on the card fails the inverse's build).
    ``inverse`` is ``inverse_map(index_map, R)`` (R,) int32.  On the card
    it takes the place of ``index_map``: the kernel reads only the
    inverse (an entry outside ``[-1, M)`` traps it), so an inverse of
    another map adds rows where that map says; it is built here when not
    given (counted in ``unpack_add.inverse_builds``).  On the CPU a given
    inverse must equal ``inverse_map(index_map, R)`` (ValueError).
    ``dst`` is not written.
    """
    dev = dst.get_device()
    check("dst", dst, 3, dev, _SUFFIX)
    check("rows", rows, 3, dev, dst.dtype)
    check("index_map", index_map, 1, dev, torch.int32)
    n_dom, R, F = dst.shape
    M = index_map.numel()
    if rows.shape != (n_dom, M, F):
        raise ValueError(f"rows shape {tuple(rows.shape)} != "
                         f"{(n_dom, M, F)}")
    if inverse is not None:
        check("inverse", inverse, 1, dev, torch.int32)
        if inverse.numel() != R:
            raise ValueError(f"inverse holds {inverse.numel()} rows, "
                             f"expected {R} (inverse_map(index_map, {R}))")
    if not dst.is_cuda:
        if dst.is_cpu:
            if inverse is not None and not torch.equal(
                    inverse, inverse_map(index_map, R)):
                raise ValueError("inverse is not inverse_map(index_map, "
                                 f"{R})")
            return unpack_add_plain(dst, index_map, rows)
        raise unsupported("unpack_add", dst)
    if not (n_dom and M and F):
        return dst.clone()
    if inverse is None:
        inverse = _inverse_on_device(index_map, R)
        unpack_add.inverse_builds += 1
    out = torch.empty_like(dst)
    fn = _UNPACK_ADD[dst.dtype]
    rc = fn(dst.data_ptr(), inverse.data_ptr(), rows.data_ptr(),
            out.data_ptr(), n_dom, R, M, F, stream(dev))
    if rc:
        raise refused(fn, rc)
    unpack_add.launches += 1
    return out


unpack_add.launches = 0
unpack_add.inverse_builds = 0


# ---- put_signal -------------------------------------------------------------

def _ring(mesh_shape: Sequence[int], axis: int, n_dom: int):
    """(ring size, domain stride) of ``axis`` in a row-major mesh."""
    mesh_shape = tuple(int(n) for n in mesh_shape)
    if math.prod(mesh_shape) != n_dom:
        raise ValueError(f"mesh {mesh_shape} does not hold {n_dom} domains")
    if not 0 <= axis < len(mesh_shape):
        raise ValueError(f"axis {axis} outside mesh {mesh_shape}")
    return mesh_shape[axis], math.prod(mesh_shape[axis + 1:])


def _words(signal: Optional[torch.Tensor], n: int, like: torch.Tensor,
           name: str = "signal") -> torch.Tensor:
    """The caller's signal words (int32, at least ``n``, on ``like``'s
    device), or fresh ones."""
    if signal is None:
        return like.new_empty((n,), dtype=torch.int32)
    check(name, signal, 1, like.get_device(), torch.int32)
    if signal.numel() < n:
        raise ValueError(f"{name} holds {signal.numel()} words, needs {n}")
    return signal


def put_signal_plain(src: torch.Tensor, index_map: torch.Tensor,
                     mesh_shape: Sequence[int], axis: int,
                     shift: int, wire_dtype=None) -> torch.Tensor:
    """Plain form of :func:`put_signal`: the gather (and wire cast), then
    the ring shift."""
    packed = pack_plain(src, index_map, wire_dtype)
    n_dom, M, F = packed.shape
    return torch.roll(packed.reshape(tuple(mesh_shape) + (M, F)), shift,
                      dims=axis).reshape(n_dom, M, F)


def put_signal(src: torch.Tensor, index_map: torch.Tensor,
               mesh_shape: Sequence[int], axis: int, shift: int,
               signal: Optional[torch.Tensor] = None,
               wire_dtype=None) -> torch.Tensor:
    """Fused pack + put to the ring neighbour ``my + shift`` along
    ``axis``; returns every domain's RECEIVED ``(n_dom, M, F)`` buffer:
    ``out[nb(b), m] = src[b, index_map[m]]`` (zero row where negative).

    ``src`` (n_dom, R, F) f32 / f64 / int32, domains row-major over
    ``mesh_shape``; ``index_map`` (M,) int32, entries in ``[-1, R)``; an
    entry ``>= R`` raises here and traps the kernel on the card.
    ``signal`` (int32, at least ``2 * n_dom`` words, ValueError
    otherwise; fresh ones when None) holds each receiver's arrival word,
    then a counter per receiver; the launch resets both.  On the card a
    receiver's arrival word is raised by M once all of its M rows are
    stored, so afterwards ``signal[:n_dom]`` all equal M, and
    ``signal[n_dom:2 * n_dom]`` hold the words the kernel stored for each
    receiver (M times the row's words at the width the launch chose);
    words past ``2 * n_dom`` are not touched.  With ``wire_dtype`` the
    put and the receive buffer are wire-dtyped (the receiver casts back).
    """
    dev = src.get_device()
    check("src", src, 3, dev, _SUFFIX)
    check("index_map", index_map, 1, dev, torch.int32)
    wire = _wire_dtype(src, wire_dtype)
    n_dom, R, F = src.shape
    ring, inner = _ring(mesh_shape, axis, n_dom)
    words = _words(signal, 2 * n_dom, src)
    if not src.is_cuda:
        if src.is_cpu:
            return put_signal_plain(src, index_map, mesh_shape, axis, shift,
                                    wire)
        raise unsupported("put_signal", src)
    M = index_map.shape[0]
    out = src.new_empty(n_dom, M, F) if wire is None else \
        src.new_empty((n_dom, M, F), dtype=wire)
    if not (n_dom and M and F):
        return out
    fn = _PUT_SIGNAL[src.element_size() if wire is None else (src.dtype,
                                                              wire)]
    rc = fn(src.data_ptr(), index_map.data_ptr(), out.data_ptr(),
            words.data_ptr(), n_dom, R, M, F, ring, inner, int(shift),
            stream(dev))
    if rc:
        raise refused(fn, rc)
    if wire is None:
        put_signal.launches += 1
    else:
        put_signal.wire_launches += 1
    return out


put_signal.launches = 0
put_signal.wire_launches = 0


# ---- fused_pulses -----------------------------------------------------------

def _check_fused_maps(index_maps: torch.Tensor, n_local: int) -> None:
    """The staged-forwarding map contract (the kernel traps otherwise)."""
    M = index_maps.shape[1]
    if index_maps.numel() == 0:
        return
    if int(index_maps[0].max()) >= n_local:
        raise IndexError("fused_pulses: pulse 0 index reaches past the "
                         f"{n_local} local rows (no earlier pulse to read)")
    if int(index_maps.max()) >= n_local + M:
        raise IndexError(f"fused_pulses: index past the {n_local} local "
                         f"rows + {M} forwarded rows")


def fused_pulses_words(n_dom: int, n_pulses: int) -> int:
    """The int32 words one :func:`fused_pulses` launch needs: an arrival
    word and a counter per (domain, pulse), then the ticket."""
    return 2 * n_dom * n_pulses + 1


def fused_pulses_plain(src: torch.Tensor, index_maps: torch.Tensor,
                       n_local: int, mesh_shape: Sequence[int],
                       axis: int) -> torch.Tensor:
    """Plain form of :func:`fused_pulses`: a loop over pulses, each a
    select of local or forwarded rows and a put to the -1 neighbour."""
    _check_fused_maps(index_maps, n_local)
    n_dom, _R, F = src.shape
    n_pulses, M = index_maps.shape
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    prev, outs = None, []
    for p in range(n_pulses):
        idx = index_maps[p].long()
        dep = idx >= n_local
        rows = src.index_select(1, torch.where(dep | (idx < 0), 0, idx))
        if prev is not None:
            fwd = prev.index_select(1, torch.where(dep, idx - n_local, 0))
            rows = torch.where(dep[None, :, None], fwd, rows)
        rows = torch.where((idx >= 0)[None, :, None], rows, zero)
        prev = torch.roll(rows.reshape(tuple(mesh_shape) + (M, F)), -1,
                          dims=axis).reshape(n_dom, M, F)
        outs.append(prev)
    return torch.stack(outs, dim=1)


def fused_pulses(src: torch.Tensor, index_maps: torch.Tensor, n_local: int,
                 mesh_shape: Sequence[int], axis: int,
                 words: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All pulses of one dim in one launch (staged forwarding), each put
    to the -1 neighbour along ``axis``; returns ``(n_dom, n_pulses, M,
    F)``, every domain's receive buffers.

    ``index_maps`` (n_pulses, M) int32: entries in ``[0, n_local)`` select
    local rows of ``src`` (n_dom, R, F), entries in ``[n_local, n_local +
    M)`` rows of the previous pulse's receive buffer, negative entries
    zero rows.  A pulse-0 entry ``>= n_local`` or any entry ``>= n_local
    + M`` raises here and traps the kernel on the card.  ``words`` (int32,
    at least :func:`fused_pulses_words` ``(n_dom, n_pulses)`` = 2 x n_dom
    x n_pulses + 1, ValueError otherwise, on the CPU too; fresh when None)
    hold the arrival word of each (domain, pulse), then a counter per
    (domain, pulse), then the ticket; the launch resets them.  On the
    card a receiver's arrival word of a pulse is raised by M once all of
    its M rows of that pulse are stored, so afterwards ``words[:n_dom *
    n_pulses]`` all equal M, each counter holds the words the kernel
    stored for its receiver and pulse (M times the row's words at the
    width the launch chose), and the ticket the launch's block count;
    words past those are not touched.
    """
    dev = src.get_device()
    check("src", src, 3, dev, _SUFFIX)
    check("index_maps", index_maps, 2, dev, torch.int32)
    n_dom, R, F = src.shape
    n_pulses, M = index_maps.shape
    ring, inner = _ring(mesh_shape, axis, n_dom)
    if not 1 <= n_local <= R:
        raise ValueError(f"n_local={n_local} outside [1, {R}]")
    words = _words(words, fused_pulses_words(n_dom, n_pulses), src,
                   "words")
    if not src.is_cuda:
        if src.is_cpu:
            return fused_pulses_plain(src, index_maps, n_local, mesh_shape,
                                      axis)
        raise unsupported("fused_pulses", src)
    out = src.new_empty(n_dom, n_pulses, M, F)
    if not out.numel():
        return out
    fn = _FUSED_PULSES[src.element_size()]
    rc = fn(src.data_ptr(), index_maps.data_ptr(), out.data_ptr(),
            words.data_ptr(), n_dom, R, int(n_local), n_pulses, M, F, ring,
            inner, stream(dev))
    if rc:
        raise refused(fn, rc)
    fused_pulses.launches += 1
    return out


fused_pulses.launches = 0
