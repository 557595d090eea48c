"""Domain decomposition on the virtual mesh: migration and re-binning.

The port of the JAX package's ``core/md/domain.py``.  Pools are
``(Dz, Dy, Dx, P, F)``: every domain at once, domain dims leading; with
``lead`` batch dims in front (the MD server's replica lanes) each lane
migrates on its own, its counters summed per lane.  The
reference's ``ppermute`` to the +1 / -1 neighbour becomes a roll of the
domain dim, ``lax.axis_index`` a coordinate grid, ``lax.psum`` a sum
over the domain dims.  Migration runs every ``nstlist`` steps, off the
per-step path; routing is dimension-ordered (Z, Y, X), one hop per dim.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.md.cells import (
    CellLayout,
    bin_to_cells,
    cells_to_pool,
    domain_coords,
)
from repro_torch.device import const

AXES = ("z", "y", "x")


def fmod_floor(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Floored modulo with the reference's rounding: ``fmod`` plus a
    fix-up where signs differ (how ``jnp.mod`` computes it)."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


def _take_rows(flag, pool_f, pool_i, cap: int):
    """Compact up to ``cap`` flagged rows of each domain into a buffer
    (migration moves MD state, which is never differentiated: its gathers
    have no backward)."""
    key = torch.where(flag, 0, 1).to(torch.int32)
    order = torch.sort(key, dim=-1, stable=True).indices
    sel = order[..., :cap]
    sel_valid = torch.gather(flag, -1, sel)  # noqa: RT006
    Ff, Fi = pool_f.shape[-1], pool_i.shape[-1]
    rows = sel[..., None]
    buf_f = torch.where(sel_valid[..., None],
                        torch.gather(  # noqa: RT006
                            pool_f, -2, rows.expand(*sel.shape, Ff)),
                        torch.zeros((), dtype=pool_f.dtype,
                                    device=pool_f.device))
    buf_i = torch.where(sel_valid[..., None],
                        torch.gather(  # noqa: RT006
                            pool_i, -2, rows.expand(*sel.shape, Fi)),
                        torch.full((), -1, dtype=pool_i.dtype,
                                   device=pool_i.device))
    # sel holds distinct rows, so the scatter has no collisions
    sent = torch.zeros_like(flag).scatter(-1, sel, sel_valid)
    dropped = flag.sum(-1) - sel_valid.sum(-1)
    return buf_f, buf_i, sent, dropped


def _merge_rows(pool_f, pool_i, buf_f, buf_i):
    """Place received atoms into empty pool slots; count losses (MD
    state: the gathers have no backward)."""
    empty = pool_i[..., 0] < 0
    key = torch.where(empty, 0, 1).to(torch.int32)
    order = torch.sort(key, dim=-1, stable=True).indices
    m = buf_f.shape[-2]
    dst = order[..., :m]
    incoming = buf_i[..., 0] >= 0
    free = torch.gather(empty, -1, dst)  # noqa: RT006
    ok = incoming & free
    Ff, Fi = pool_f.shape[-1], pool_i.shape[-1]
    dst_f = dst[..., None].expand(*dst.shape, Ff)
    dst_i = dst[..., None].expand(*dst.shape, Fi)
    # dst holds distinct rows, so the scatters have no collisions
    pool_f = pool_f.scatter(-2, dst_f, torch.where(
        ok[..., None], buf_f, torch.gather(pool_f, -2, dst_f)))  # noqa: RT006
    pool_i = pool_i.scatter(-2, dst_i, torch.where(
        ok[..., None], buf_i, torch.gather(pool_i, -2, dst_i)))  # noqa: RT006
    lost = torch.sum(incoming & ~free, dim=-1)
    return pool_f, pool_i, lost


def _lane_sum(x, lead: int):
    """int32 sum of ``x`` over every dim after the first ``lead``."""
    return x.sum(dim=tuple(range(lead, x.dim()))).to(torch.int32)


def migrate(pool_f, pool_i, layout: CellLayout, mig_cap: int,
            lead: int = 0):
    """Dimension-ordered migration of atoms that left their domain.

    pool_f: (*lanes, Dz, Dy, Dx, P, Ff), coordinates first; pool_i:
    (*lanes, Dz, Dy, Dx, P, 2) [id, type] with id < 0 marking empty
    slots, ``lead`` lane dims in front.  Returns the updated pools and a
    dict of counters per lane (0-dim tensors without lanes) that must
    stay zero in healthy runs.
    """
    dev = pool_f.device
    box = const(tuple(layout.box), pool_f.dtype, dev)
    lanes = tuple(pool_f.shape[:lead])
    dropped_total = torch.zeros(lanes, dtype=torch.int32, device=dev)
    lost_total = torch.zeros(lanes, dtype=torch.int32, device=dev)

    # wrap positions into the box first (global coordinates)
    pool_f = pool_f.clone()
    pool_f[..., :3] = fmod_floor(pool_f[..., :3], box)

    for d in range(3):
        S = layout.mesh_shape[d]
        if S == 1:
            continue
        extent = const(layout.cells_per_domain[d] * layout.cell_size[d],
                       pool_f.dtype, dev)
        valid = pool_i[..., 0] >= 0
        dest = torch.floor(pool_f[..., d] / extent).to(torch.int32)
        dest = torch.clamp(dest, 0, S - 1)
        view = [1] * (lead + 4)
        view[lead + d] = S
        me = torch.arange(S, dtype=torch.int32, device=dev).reshape(view)
        rel = torch.remainder(dest - me, S)
        send_hi = valid & (rel == 1)
        # with S == 2 the -1 neighbour is the +1 neighbour: send high only
        send_lo = valid & (rel == S - 1) & (S > 2)
        # anything farther than one domain is a physics bug; route it high
        # and count it so tests can fail loudly
        too_far = valid & (rel != 0) & (rel != 1) & (rel != S - 1)
        send_hi = send_hi | too_far
        dropped_total = dropped_total + _lane_sum(too_far, lead)

        buf_f, buf_i, sent, drop1 = _take_rows(send_hi, pool_f, pool_i,
                                               mig_cap)
        pool_i = torch.where(sent[..., None], -1, pool_i)
        lbuf_f, lbuf_i, lsent, drop2 = _take_rows(send_lo, pool_f, pool_i,
                                                  mig_cap)
        pool_i = torch.where(lsent[..., None], -1, pool_i)
        dropped_total = dropped_total + _lane_sum(drop1 + drop2, lead)

        # +1 neighbour receives (perm (j, j+1)): roll +1; -1 neighbour: -1
        pool_f, pool_i, lost1 = _merge_rows(
            pool_f, pool_i, torch.roll(buf_f, 1, dims=lead + d),
            torch.roll(buf_i, 1, dims=lead + d))
        pool_f, pool_i, lost2 = _merge_rows(
            pool_f, pool_i, torch.roll(lbuf_f, -1, dims=lead + d),
            torch.roll(lbuf_i, -1, dims=lead + d))
        lost_total = lost_total + _lane_sum(lost1 + lost2, lead)

    diag = {"migration_dropped": dropped_total,
            "migration_lost": lost_total}
    return pool_f, pool_i, diag


def rebin(cell_f, cell_i, layout: CellLayout, mig_cap: int, lead: int = 0):
    """Wrap, migrate and re-bin every domain's atoms (each nstlist steps).

    cell_f / cell_i: (*lanes, Dz, Dy, Dx, cz, cy, cx, K, F), ``lead`` lane
    dims in front; the diagnostics are per lane.
    """
    outer = tuple(cell_f.shape[:lead + 3])
    mesh = outer[lead:]
    lanes = outer[:lead]
    B = math.prod(outer)
    pool_f, pool_i = cells_to_pool(
        cell_f.reshape(B, *cell_f.shape[lead + 3:]),
        cell_i.reshape(B, *cell_i.shape[lead + 3:]))
    pool_f = pool_f.reshape(*outer, *pool_f.shape[1:])
    pool_i = pool_i.reshape(*outer, *pool_i.shape[1:])
    pool_f, pool_i, diag = migrate(pool_f, pool_i, layout, mig_cap, lead)
    pool_f = pool_f.reshape(B, *pool_f.shape[lead + 3:])
    pool_i = pool_i.reshape(B, *pool_i.shape[lead + 3:])
    coords = domain_coords(mesh, cell_f.device)
    if lead:
        coords = coords.repeat(math.prod(lanes), 1)
    new_f, new_i, overflow = bin_to_cells(
        pool_f[..., :3], pool_f[..., 3:], pool_i, layout, coords)
    diag["bin_overflow"] = _lane_sum(overflow.reshape(*lanes, -1), lead)
    diag["n_atoms"] = torch.sum(
        (new_i[..., 0] >= 0).reshape(*lanes, -1), dim=lead)
    return (new_f.reshape(*outer, *new_f.shape[1:]),
            new_i.reshape(*outer, *new_i.shape[1:]), diag)
