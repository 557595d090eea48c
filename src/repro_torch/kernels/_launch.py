"""The one launch path of every kernel wrapper.

A halo kernel takes 1.4-3 us of device time, so the host path of its
wrapper is most of a call's time.  Everything here is resolved once and
read cheaply on each call:

* :class:`Entries` resolves a library's C entry points into ctypes
  functions with their ``argtypes`` set, at first use (the build, too,
  happens then, never at import); a wrapper picks one by a dict lookup;
* :func:`check` reads each tensor attribute once: rank, device index
  (``get_device()``, -1 on the CPU), dtype, contiguity;
* :func:`stream` reads the caller's current stream as a raw handle, so a
  launch inside ``with torch.cuda.stream(s):`` runs on ``s``;
* :func:`refused` is the error a wrapper raises when the entry point
  returns a ``cudaGetLastError()`` other than 0 (the wrapper tests the
  code inline: a call through one more Python frame costs more than
  the test).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

PTR, I32, I64, F32, F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_float, ctypes.c_double)


class Entries(dict):
    """The C entry points of the library ``csrc/<lib>.cu``, by key.

    ``table`` maps a key (a dtype, an element width, a pair of dtypes) to
    ``(symbol, argtypes)``; each symbol returns an int (its
    ``cudaGetLastError()``).  The first lookup builds the library and
    resolves every symbol into this dict, so a later lookup is a plain
    dict lookup, with no Python frame.
    """

    def __init__(self, lib: str,
                 table: Dict[Hashable, Tuple[str, Sequence[type]]]):
        super().__init__()
        self.lib = lib
        self._table = table

    def __missing__(self, key: Hashable) -> Callable[..., int]:
        if not self:
            cdll = _build.load(self.lib)
            for k, (symbol, argtypes) in self._table.items():
                fn = getattr(cdll, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                self[k] = fn
        if key not in self:
            raise KeyError(key)
        return dict.__getitem__(self, key)


def _device_name(index: int) -> str:
    return "cpu" if index < 0 else f"cuda:{index}"


def check(name: str, t: torch.Tensor, ndim: int, dev: int, dtype,
          refusal: Optional[str] = None) -> None:
    """Refuse ``t`` unless it is ``ndim``-D, on device index ``dev`` (-1:
    the CPU), of ``dtype`` (one torch dtype, or a collection of those
    taken) and contiguous.  ``refusal`` words a dtype outside a
    collection (``{name}`` and ``{dtype}`` are filled in)."""
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.get_device() != dev:
        raise ValueError(f"{name} is on {t.device}, expected "
                         f"{_device_name(dev)}")
    dt = t.dtype
    if type(dtype) is torch.dtype:
        if dt != dtype:
            raise TypeError(f"{name} must be {dtype}, got {dt}")
    elif dt not in dtype:
        raise TypeError(
            refusal.format(name=name, dtype=dt) if refusal else
            f"{name} dtype {dt} not supported; use one of {tuple(dtype)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (pass .contiguous())")


def unsupported(kernel: str, t: torch.Tensor) -> ValueError:
    """The refusal of a tensor on neither the CPU nor a CUDA device."""
    return ValueError(f"{kernel}: unsupported device {t.device}")


def _no_cuda(index: int) -> int:
    raise RuntimeError("this PyTorch build has no CUDA")


# stream(index): the current CUDA stream of device ``index``, as a raw
# handle; PyTorch's own binding, called with no Python frame between
stream: Callable[[int], int] = getattr(torch._C, "_cuda_getCurrentRawStream",
                                       _no_cuda)


def refused(fn: Callable[..., int], rc: int) -> RuntimeError:
    """The error of an entry point ``fn`` that returned the CUDA error
    ``rc`` (a launch refused, or a fault of an earlier one)."""
    return RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")
