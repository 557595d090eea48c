"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
a run never continues on the CPU unless the caller asks for it (the CPU
tests pass ``device="cpu"`` explicitly).

:func:`const` keeps the 0-dim constants of the step code on the device.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it is a CUDA
    device and CUDA is not available.  ``"meta"`` builds shapes without
    storage (the dry run's models); nothing runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda, cpu or "
                         "meta")
    if dev.type == "cuda" and dev.index is None:
        # tensors report their index: compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def const(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` (a number, or a tuple of them) as a tensor of ``dtype``
    on ``device``, made once and shared after (callers never write to
    it).

    ``torch.tensor(v, device="cuda")`` copies from the host and blocks it
    on every call; here a number is a fill on the device and a tuple is
    copied once.  A 0-dim tensor of the working dtype keeps a division a
    true division (on CUDA, PyTorch divides by a Python float as a
    multiply by its reciprocal).
    """
    if isinstance(value, tuple):
        return torch.tensor(value, dtype=dtype, device=device)
    return torch.full((), value, dtype=dtype, device=device)
