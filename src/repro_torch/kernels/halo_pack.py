"""Halo pack / unpack-add: CUDA kernels for Hopper plus their plain forms.

Replaces the TPU kernels ``src/repro/kernels/halo_pack.py:pack`` and
``:unpack_add`` (the ``"pallas"`` halo backend's per-pulse gather and
force-return scatter-add).  The CUDA source is ``csrc/halo_pack.cu``; its
header says what bounds the kernels on an H100 (bytes, and at the MD
path's halo sizes launch latency) and what the design does about it.

Both functions are batched over the virtual domain mesh: ``src`` is
``(n_dom, R, F)`` and one index map ``(M,)`` serves every domain, so a
pulse is one launch whatever the domain count.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version beside it.  Each wrapper counts its launches in a
plain integer attribute (``pack.launches``, ``unpack_add.launches``),
raised only where the kernel is launched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.int32: "i32"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("halo_pack")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for width in (4, 8):            # pack is a bit copy: one entry per width
        fn = getattr(lib, f"halo_pack_b{width}")
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"halo_unpack_add_{sfx}")
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, ptr]
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


def _launch(fn, *args, device: torch.device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


# ---- pack -------------------------------------------------------------------

def pack_plain(src: torch.Tensor, index_map: torch.Tensor) -> torch.Tensor:
    """Plain form of :func:`pack`: gather plus a mask."""
    rows = src.index_select(1, index_map.clamp(min=0).long())
    return torch.where((index_map >= 0)[None, :, None], rows,
                       torch.zeros((), dtype=src.dtype, device=src.device))


def pack(src: torch.Tensor, index_map: torch.Tensor) -> torch.Tensor:
    """``out[b, m] = src[b, index_map[m]]`` (zero row where negative).

    ``src`` (n_dom, R, F) f32 / f64 / int32; ``index_map`` (M,) int32 on
    the same device, entries in ``[-1, R)``; an entry ``>= R`` raises
    here and traps the kernel on the card.  Returns (n_dom, M, F).
    """
    _check("src", src, 3, src.device)
    _check("index_map", index_map, 1, src.device, torch.int32)
    if src.device.type == "cpu":
        return pack_plain(src, index_map)
    if src.device.type != "cuda":
        raise ValueError(f"pack: unsupported device {src.device}")
    n_dom, R, F = src.shape
    M = index_map.shape[0]
    out = torch.empty((n_dom, M, F), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    _launch(getattr(_lib(), f"halo_pack_b{src.element_size()}"),
            src.data_ptr(), index_map.data_ptr(), out.data_ptr(),
            n_dom, R, M, F, device=src.device)
    pack.launches += 1
    return out


pack.launches = 0


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
