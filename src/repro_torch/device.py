"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
a run never continues on the CPU unless the caller asks for it (the CPU
tests pass ``device="cpu"`` explicitly).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it is a CUDA
    device and CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    if dev.type == "cuda" and dev.index is None:
        # tensors report their index: compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
