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
the kernel is launched.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from repro_torch.core.wire import FP_WIRE, wire_cast
from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.int32: "i32"}
_WIRE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}
# the converting entry points: (source, wire) element types
_CONVERTS = ((torch.float64, torch.float32), (torch.float64, torch.bfloat16),
             (torch.float64, torch.float16), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float16))


def _convert_name(src: torch.dtype, wire: torch.dtype) -> str:
    return f"{_SUFFIX[src]}_to_{_WIRE_SUFFIX[wire]}"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("halo_pack")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for width in (4, 8):            # pack is a bit copy: one entry per width
        fn = getattr(lib, f"halo_pack_b{width}")
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    for src, wire in _CONVERTS:
        fn = getattr(lib, f"halo_pack_{_convert_name(src, wire)}")
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"halo_unpack_add_{sfx}")
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _signal_lib() -> ctypes.CDLL:
    lib = _build.load("halo_signal")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for width in (4, 8):            # bit copies: one entry per width
        fn = getattr(lib, f"halo_put_signal_b{width}")
        fn.argtypes = [ptr, ptr, ptr, ptr] + [i64] * 7 + [ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"halo_fused_pulses_b{width}")
        fn.argtypes = [ptr, ptr, ptr, ptr] + [i64] * 8 + [ptr]
        fn.restype = ctypes.c_int
    for src, wire in _CONVERTS:
        fn = getattr(lib, f"halo_put_signal_{_convert_name(src, wire)}")
        fn.argtypes = [ptr, ptr, ptr, ptr] + [i64] * 7 + [ptr]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device,
           dtype=None) -> None:
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    elif t.dtype not in _SUFFIX:
        raise TypeError(f"{name} dtype {t.dtype} not supported; "
                        f"use one of {tuple(_SUFFIX)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (pass .contiguous())")


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


def _launch(fn, *args, device: torch.device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


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
    _check("src", src, 3, src.device)
    _check("index_map", index_map, 1, src.device, torch.int32)
    wire = _wire_dtype(src, wire_dtype)
    if src.device.type == "cpu":
        return pack_plain(src, index_map, wire)
    if src.device.type != "cuda":
        raise ValueError(f"pack: unsupported device {src.device}")
    n_dom, R, F = src.shape
    M = index_map.shape[0]
    out = torch.empty((n_dom, M, F), dtype=wire or src.dtype,
                      device=src.device)
    if out.numel() == 0:
        return out
    name = (f"halo_pack_b{src.element_size()}" if wire is None
            else f"halo_pack_{_convert_name(src.dtype, wire)}")
    _launch(getattr(_lib(), name), src.data_ptr(), index_map.data_ptr(),
            out.data_ptr(), n_dom, R, M, F, device=src.device)
    if wire is None:
        pack.launches += 1
    else:
        pack.wire_launches += 1
    return out


pack.launches = 0
pack.wire_launches = 0


# ---- unpack_add -------------------------------------------------------------

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
               rows: torch.Tensor) -> torch.Tensor:
    """``out = dst; out[b, index_map[m]] += rows[b, m]``.

    ``dst`` (n_dom, R, F), ``rows`` (n_dom, M, F) of the same dtype;
    ``index_map`` (M,) int32, unique entries in ``[0, R)``; an entry
    outside raises here and traps the kernel on the card.
    """
    _check("dst", dst, 3, dst.device)
    _check("rows", rows, 3, dst.device, dst.dtype)
    _check("index_map", index_map, 1, dst.device, torch.int32)
    n_dom, R, F = dst.shape
    M = index_map.shape[0]
    if tuple(rows.shape) != (n_dom, M, F):
        raise ValueError(f"rows shape {tuple(rows.shape)} != "
                         f"{(n_dom, M, F)}")
    if dst.device.type == "cpu":
        return unpack_add_plain(dst, index_map, rows)
    if dst.device.type != "cuda":
        raise ValueError(f"unpack_add: unsupported device {dst.device}")
    if rows.numel() == 0:
        return dst.clone()
    out = torch.empty_like(dst)
    _launch(getattr(_lib(), f"halo_unpack_add_{_SUFFIX[dst.dtype]}"),
            dst.data_ptr(), index_map.data_ptr(), rows.data_ptr(),
            out.data_ptr(), n_dom, R, M, F, device=dst.device)
    unpack_add.launches += 1
    return out


unpack_add.launches = 0


# ---- put_signal -------------------------------------------------------------

def _ring(mesh_shape: Sequence[int], axis: int, n_dom: int):
    """(ring size, domain stride) of ``axis`` in a row-major mesh."""
    mesh_shape = tuple(int(n) for n in mesh_shape)
    if math.prod(mesh_shape) != n_dom:
        raise ValueError(f"mesh {mesh_shape} does not hold {n_dom} domains")
    if not 0 <= axis < len(mesh_shape):
        raise ValueError(f"axis {axis} outside mesh {mesh_shape}")
    return mesh_shape[axis], math.prod(mesh_shape[axis + 1:])


def _words(signal: Optional[torch.Tensor], n: int,
           device: torch.device) -> torch.Tensor:
    """The caller's signal words (int32, at least ``n``), or fresh ones."""
    if signal is None:
        return torch.empty((n,), dtype=torch.int32, device=device)
    _check("signal", signal, 1, device, torch.int32)
    if signal.numel() < n:
        raise ValueError(f"signal holds {signal.numel()} words, needs {n}")
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
    entry ``>= R`` raises here and traps the kernel on the card.  On the
    card each row is one chunk and raises its receiver's arrival word in
    ``signal`` (int32, >= n_dom words, reset by the launch; fresh ones
    when None), so afterwards ``signal[:n_dom]`` all equal M.  With
    ``wire_dtype`` the put and the receive buffer are wire-dtyped (the
    receiver casts back).
    """
    _check("src", src, 3, src.device)
    _check("index_map", index_map, 1, src.device, torch.int32)
    wire = _wire_dtype(src, wire_dtype)
    n_dom, R, F = src.shape
    ring, inner = _ring(mesh_shape, axis, n_dom)
    if src.device.type == "cpu":
        return put_signal_plain(src, index_map, mesh_shape, axis, shift,
                                wire)
    if src.device.type != "cuda":
        raise ValueError(f"put_signal: unsupported device {src.device}")
    M = index_map.shape[0]
    out = torch.empty((n_dom, M, F), dtype=wire or src.dtype,
                      device=src.device)
    if out.numel() == 0:
        return out
    words = _words(signal, n_dom, src.device)
    name = (f"halo_put_signal_b{src.element_size()}" if wire is None
            else f"halo_put_signal_{_convert_name(src.dtype, wire)}")
    _launch(getattr(_signal_lib(), name), src.data_ptr(),
            index_map.data_ptr(), out.data_ptr(), words.data_ptr(), n_dom, R,
            M, F, ring, inner, int(shift), device=src.device)
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
    >= n_dom * n_pulses + 1; fresh when None) hold the arrival word of
    each (domain, pulse), then the work-item ticket; the launch resets
    them, and afterwards every arrival word equals M.
    """
    _check("src", src, 3, src.device)
    _check("index_maps", index_maps, 2, src.device, torch.int32)
    n_dom, R, F = src.shape
    n_pulses, M = index_maps.shape
    ring, inner = _ring(mesh_shape, axis, n_dom)
    if not 1 <= n_local <= R:
        raise ValueError(f"n_local={n_local} outside [1, {R}]")
    if src.device.type == "cpu":
        return fused_pulses_plain(src, index_maps, n_local, mesh_shape, axis)
    if src.device.type != "cuda":
        raise ValueError(f"fused_pulses: unsupported device {src.device}")
    out = torch.empty((n_dom, n_pulses, M, F), dtype=src.dtype,
                      device=src.device)
    if out.numel() == 0:
        return out
    words = _words(words, n_dom * n_pulses + 1, src.device)
    _launch(getattr(_signal_lib(),
                    f"halo_fused_pulses_b{src.element_size()}"),
            src.data_ptr(), index_maps.data_ptr(), out.data_ptr(),
            words.data_ptr(), n_dom, R, int(n_local), n_pulses, M, F, ring,
            inner, device=src.device)
    fused_pulses.launches += 1
    return out


fused_pulses.launches = 0
