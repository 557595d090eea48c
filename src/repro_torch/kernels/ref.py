"""Plain PyTorch oracles for the port's kernels (the JAX ``ref.py`` forms)."""
from __future__ import annotations

import torch


# ---- halo_pack.pack --------------------------------------------------------

def pack_ref(src: torch.Tensor, index_map: torch.Tensor) -> torch.Tensor:
    """``src`` (P, F) rows at ``index_map`` (M,); negative -> zero row."""
    rows = src[index_map.clamp(min=0).long()].clone()
    rows[index_map < 0] = 0
    return rows


# ---- halo_pack.unpack_add --------------------------------------------------

def unpack_add_ref(dst: torch.Tensor, index_map: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """``dst`` (P, F) plus ``rows`` (M, F) added at ``index_map``."""
    out = dst.clone()
    out.index_put_((index_map.long(),), rows, accumulate=True)
    return out
