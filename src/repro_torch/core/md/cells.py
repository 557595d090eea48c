"""Cell-grid geometry and atom binning, batched over the domain mesh.

The port of the JAX package's ``core/md/cells.py``.  Atoms live in
cutoff-sized cells with ``capacity`` slots each; the cell grid is the
pair structure and is re-binned every ``nstlist`` steps.  Every function
takes a leading batch of domains: pools are ``(B, P, F)`` and cell arrays
``(B, cz, cy, cx, K, F)``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import const


@dataclasses.dataclass(frozen=True)
class CellLayout:
    """Static geometry of the decomposed cell grid.

    ``mesh_shape`` is the 3-D domain grid (Z, Y, X domains); each domain
    holds ``cells_per_domain`` cutoff-sized cells with ``capacity`` atom
    slots per cell.  Positions are global; a domain's origin is
    ``domain_index * cells_per_domain * cell_size``.
    """

    box: Tuple[float, float, float]
    mesh_shape: Tuple[int, int, int]
    cells_per_domain: Tuple[int, int, int]
    capacity: int

    @property
    def cell_size(self) -> Tuple[float, float, float]:
        return tuple(
            self.box[d] / (self.mesh_shape[d] * self.cells_per_domain[d])
            for d in range(3))

    @property
    def global_cells(self) -> Tuple[int, int, int]:
        return tuple(self.mesh_shape[d] * self.cells_per_domain[d]
                     for d in range(3))

    @property
    def n_local_cells(self) -> int:
        cz, cy, cx = self.cells_per_domain
        return cz * cy * cx

    @property
    def pool(self) -> int:
        """Per-domain atom slot pool (flattened cell slots)."""
        return self.n_local_cells * self.capacity


def choose_layout(box, mesh_shape, r_cut: float, n_atoms: int,
                  safety: float = 2.2, min_capacity: int = 8) -> CellLayout:
    """Pick cutoff-sized cells and a slot capacity with headroom.

    Cell size must be >= r_cut so a one-cell halo covers the cutoff sphere.
    """
    cells = []
    for d in range(3):
        c = int(np.floor(box[d] / (mesh_shape[d] * r_cut)))
        if c < 1:
            raise ValueError(
                f"domain extent {box[d] / mesh_shape[d]:.3f} < r_cut={r_cut}"
                f" along dim {d}: too many domains for this system")
        cells.append(c)
    n_cells = int(np.prod([mesh_shape[d] * cells[d] for d in range(3)]))
    avg_occ = n_atoms / n_cells
    cap = max(min_capacity, int(np.ceil(avg_occ * safety)))
    cap = int(np.ceil(cap / 4) * 4)   # pad for vectorization
    return CellLayout(box=tuple(float(b) for b in box),
                      mesh_shape=tuple(mesh_shape),
                      cells_per_domain=tuple(cells), capacity=cap)


def domain_coords(mesh_shape, device) -> torch.Tensor:
    """(B, 3) int32 domain coordinates, B = prod(mesh_shape) in C order."""
    grids = torch.meshgrid(*[torch.arange(n, device=device)
                             for n in mesh_shape], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1).to(torch.int32)


def bin_to_cells(pos, feats_f, feats_i, layout: CellLayout, domain_index):
    """Scatter flat atom pools into ``(B, cz, cy, cx, K, ...)`` cell arrays.

    ``pos`` (B, P, 3) with invalid slots marked by ``feats_i[..., 0] < 0``
    (the atom id); ``domain_index`` (B, 3) int domain coordinates.
    Returns (cell_f, cell_i, overflow) with ``overflow`` (B,) counting
    atoms beyond a cell's capacity, which are dropped.
    """
    cz, cy, cx = layout.cells_per_domain
    K = layout.capacity
    dev, dtype = pos.device, pos.dtype
    B, P = pos.shape[0], pos.shape[1]
    csz = const(tuple(layout.cell_size), dtype, dev)
    origin = domain_index.to(dtype) * \
        const(tuple(layout.cells_per_domain), dtype, dev) * csz

    valid = feats_i[..., 0] >= 0
    rel = (pos - origin[:, None, :]) / csz
    cell3 = torch.floor(rel).to(torch.int32)
    hi = const((cz - 1, cy - 1, cx - 1), torch.int32, dev)
    cell3 = torch.clamp(cell3, min=torch.zeros_like(hi), max=hi)
    cell_id = (cell3[..., 0] * cy + cell3[..., 1]) * cx + cell3[..., 2]
    n_cells = cz * cy * cx
    cell_id = torch.where(valid, cell_id, n_cells)        # invalid -> sentinel

    sorted_id, order = torch.sort(cell_id, dim=-1, stable=True)
    # rank within the cell: index - first occurrence of this cell id
    first = torch.searchsorted(sorted_id, sorted_id, side="left")
    rank = torch.arange(P, device=dev) - first
    keep = (sorted_id < n_cells) & (rank < K)
    overflow = torch.sum((sorted_id < n_cells) & (rank >= K), dim=-1)

    slot = torch.where(keep, sorted_id * K + rank, n_cells * K)
    Pf = feats_f.shape[-1]
    Pi = feats_i.shape[-1]
    src_f = torch.cat([pos, feats_f], dim=-1)
    src_f = torch.gather(src_f, 1, order[..., None].expand(-1, -1, 3 + Pf))
    src_i = torch.gather(feats_i, 1, order[..., None].expand(-1, -1, Pi))
    cell_f = torch.zeros((B, n_cells * K + 1, 3 + Pf), dtype=dtype, device=dev)
    cell_i = torch.full((B, n_cells * K + 1, Pi), -1, dtype=feats_i.dtype,
                        device=dev)
    # every dropped or invalid atom lands on the one sentinel row
    # n_cells*K; those duplicate writes are harmless only because that row
    # is sliced off below.  Kept atoms have unique slots.
    bidx = torch.arange(B, device=dev)[:, None].expand(B, P)
    cell_f[bidx, slot] = torch.where(keep[..., None], src_f,
                                     torch.zeros((), dtype=dtype, device=dev))
    cell_i[bidx, slot] = torch.where(keep[..., None], src_i,
                                     torch.full((), -1, dtype=src_i.dtype,
                                                device=dev))
    cell_f = cell_f[:, :-1].reshape(B, cz, cy, cx, K, 3 + Pf)
    cell_i = cell_i[:, :-1].reshape(B, cz, cy, cx, K, Pi)
    return cell_f, cell_i, overflow


def cell_counts(cell_i) -> torch.Tensor:
    """Per-cell occupied-slot counts: (..., K, Pi) int arrays -> (...)."""
    return torch.sum(cell_i[..., 0] >= 0, dim=-1).to(torch.int32)


def cell_levels(counts, quantum: int) -> torch.Tensor:
    """Quantized per-cell occupancy levels ``ceil(count / quantum)``
    (level 0 = empty cell); any leading dims."""
    return torch.div(counts + (quantum - 1), quantum,
                     rounding_mode="floor").to(torch.int32)


def cell_bounds(pos, cell_i, big: float = 1e30):
    """Per-cell position bounding boxes over valid slots.

    ``pos`` (..., K, 3); returns ``(lo, hi)`` of shape (..., 3).  Empty
    cells give inverted boxes at ``(+big, -big)``: finite sentinels, so
    gap computations stay NaN-free and a pair touching an empty cell lands
    beyond every cutoff.
    """
    valid = (cell_i[..., 0] >= 0)[..., None]
    big = torch.full((), big, dtype=pos.dtype, device=pos.device)
    lo = torch.amin(torch.where(valid, pos, big), dim=-2)
    hi = torch.amax(torch.where(valid, pos, -big), dim=-2)
    return lo, hi


def cells_to_pool(cell_f, cell_i):
    """Flatten ``(B, cz, cy, cx, K, F)`` cell arrays into ``(B, P, F)``."""
    B = cell_f.shape[0]
    return (cell_f.reshape(B, -1, cell_f.shape[-1]),
            cell_i.reshape(B, -1, cell_i.shape[-1]))
