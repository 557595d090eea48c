"""Cell-pair LJ + reaction-field forces and their scatter-accumulate
epilogue: CUDA kernels for Hopper plus their plain forms.

Replaces the TPU kernels ``src/repro/kernels/nonbonded.py:pair_forces``
(body ``_pair_kernel``) and ``:scatter_accum`` (body
``_scatter_accum_kernel``), the pruned ``"pallas"`` force backend's hot
loop.  The CUDA source is ``csrc/nonbonded.cu``; its header says what
bounds each kernel on an H100 and what the design does about it.

* :func:`pair_forces` — one batch of N cell pairs ``(N, K, 4)`` [x, y, z,
  q]: forces on both sides and each pair's potential energy.  On the
  card a group of lanes serves a pair, one lane per slot of cell B, and
  walks cell A's slots in order; fb sums in each lane's registers, fa and
  the energy over the group's lanes in a fixed tree, so the same inputs
  give the same bits on every run.
* :func:`scatter_accum` — sums the per-pair forces into their cells in
  worklist order (entry ``2*row + side``: A side first, then B), through
  an ordered cell -> entries index (:func:`scatter_index`), with no
  atomics: one warp per cell adds its segment's rows in order, so the
  result is deterministic and bitwise equal to the plain form.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version beside it.  Each wrapper counts its launches in a
plain integer attribute (``pair_forces.launches``,
``scatter_accum.launches``), raised only where the kernel is launched,
through the shared launch path (:mod:`repro_torch.kernels._launch`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.md.forces import ff_tables, pair_terms
from repro_torch.core.md.system import ForceField
from repro_torch.kernels import _launch
from repro_torch.kernels._launch import (F64, I32, I64, PTR, check, refused,
                                         stream, unsupported)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_FLOATS = "{name} must be float32 or float64, got {dtype}"
_PAIR_FORCES = _launch.Entries("nonbonded", {
    dt: (f"nb_pair_forces_{sfx}", [PTR] * 9 + [I32, F64, F64, F64, I64, I64]
         + [PTR] * 4) for dt, sfx in _SUFFIX.items()})
_SCATTER_ACCUM = _launch.Entries("nonbonded", {
    dt: (f"nb_scatter_accum_{sfx}", [PTR] * 4 + [I64] * 3 + [PTR] * 2)
    for dt, sfx in _SUFFIX.items()})


# ---- pair_forces --------------------------------------------------------------

def _pair_args(a, b, ta, tb, same, cnt_a, cnt_b):
    dev = a.get_device()
    check("a", a, 3, dev, _SUFFIX, _FLOATS)
    check("b", b, 3, dev, a.dtype)
    N, K, F = a.shape
    if F != 4 or tuple(b.shape) != (N, K, 4):
        raise ValueError(f"a, b must be (N, K, 4), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    for name, t in (("ta", ta), ("tb", tb)):
        check(name, t, 2, dev, torch.int32)
        if t.shape != (N, K):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(N, K)}")
    if (cnt_a is None) != (cnt_b is None):
        raise ValueError("pass both cnt_a and cnt_b or neither")
    for name, t in (("same", same), ("cnt_a", cnt_a), ("cnt_b", cnt_b)):
        if t is None:
            continue
        check(name, t, 1, dev, torch.int32)
        if t.shape[0] != N:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {N}")
    return N, K


def pair_forces_plain(a, b, ta, tb, same, ff: ForceField, cnt_a=None,
                      cnt_b=None):
    """Plain form of :func:`pair_forces`: the K x K tile as broadcasts,
    the pair terms of the dense path (``forces.pair_terms``)."""
    N, K = _pair_args(a, b, ta, tb, same, cnt_a, cnt_b)
    dev, dtype = a.device, a.dtype
    eps_t, sig_t = ff_tables(ff.eps, ff.sigma, dtype, dev)
    n_types = eps_t.shape[0]
    if cnt_a is not None:
        # binning packs each cell's atoms into a contiguous slot prefix,
        # so slot < count IS slot validity
        iota = torch.arange(K, device=dev, dtype=torch.int32)[None, :]
        valid_a, valid_b = iota < cnt_a[:, None], iota < cnt_b[:, None]
    else:
        valid_a, valid_b = ta >= 0, tb >= 0
    dx = a[:, :, None, :3] - b[:, None, :, :3]
    # r2 as three products and two adds in this order, as the kernel
    # forms it: the cutoff test then sees the same bits on both
    r2 = dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1] \
        + dx[..., 2] * dx[..., 2]
    rc2 = torch.full((), ff.r_cut * ff.r_cut, dtype=dtype, device=dev)
    mask = valid_a[:, :, None] & valid_b[:, None, :] & (r2 < rc2)
    tri = torch.triu(torch.ones((K, K), dtype=torch.bool, device=dev),
                     diagonal=1)
    mask = mask & torch.where(same[:, None, None] > 0, tri[None],
                              torch.ones((), dtype=torch.bool, device=dev))
    tai = torch.clamp(ta, 0, n_types - 1).long()
    tbi = torch.clamp(tb, 0, n_types - 1).long()
    eps = eps_t[tai[:, :, None], tbi[:, None, :]]
    sig = sig_t[tai[:, :, None], tbi[:, None, :]]
    fac, pe = pair_terms(dx, r2, a[:, :, None, 3], b[:, None, :, 3], eps,
                         sig, ff, mask)
    fvec = fac[..., None] * dx
    return (torch.sum(fvec, dim=2), -torch.sum(fvec, dim=1),
            torch.sum(pe, dim=(1, 2)))


def pair_forces(a, b, ta, tb, same, ff: ForceField, cnt_a=None,
                cnt_b=None):
    """Forces and energies of N cell pairs.

    ``a``, ``b`` (N, K, 4) [x, y, z, q], f32 or f64; ``ta``, ``tb`` (N, K)
    int32 atom types (clipped into the force field's table); ``same``
    (N,) int32, nonzero where A is B (only the strict upper triangle
    ``j > i`` interacts).  With ``cnt_a`` / ``cnt_b`` (N,) int32 a slot is
    valid when ``slot < count``; without them when its type is >= 0.
    Returns ``(fa (N, K, 3), fb (N, K, 3), pe (N,))``.

    On the card K has no bound of its own: lanes loop over column chunks
    of cell B.  A block keeps the force field's T x T type-pair terms in
    shared memory (227 KB on an H100: T <= 120 in f32, 85 in f64); more
    types make the C entry refuse the launch, which raises here.  The
    kernel reads each slot as 16-byte words, so ``a`` and ``b`` must
    start on a 16-byte boundary (a fresh tensor does).
    """
    N, K = _pair_args(a, b, ta, tb, same, cnt_a, cnt_b)
    if not a.is_cuda:
        if a.is_cpu:
            return pair_forces_plain(a, b, ta, tb, same, ff, cnt_a, cnt_b)
        raise unsupported("pair_forces", a)
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("pair_forces: a, b must start on a 16-byte "
                         "boundary (the kernel reads 16-byte words)")
    fa = a.new_empty((N, K, 3))
    fb = torch.empty_like(fa)
    pe = a.new_empty((N,))
    if N == 0:
        return fa, fb, pe
    eps_t, sig_t = ff_tables(ff.eps, ff.sigma, a.dtype, a.device)
    fn = _PAIR_FORCES[a.dtype]
    rc = fn(a.data_ptr(), b.data_ptr(), ta.data_ptr(), tb.data_ptr(),
            same.data_ptr(), None if cnt_a is None else cnt_a.data_ptr(),
            None if cnt_b is None else cnt_b.data_ptr(), eps_t.data_ptr(),
            sig_t.data_ptr(), eps_t.shape[0], ff.r_cut * ff.r_cut, ff.k_rf,
            ff.c_rf, N, K, fa.data_ptr(), fb.data_ptr(), pe.data_ptr(),
            stream(a.get_device()))
    if rc:
        raise refused(fn, rc)
    pair_forces.launches += 1
    return fa, fb, pe


pair_forces.launches = 0


# ---- scatter_accum ------------------------------------------------------------

class ScatterIndex(NamedTuple):
    """Ordered cell -> entries index of one pair batch: ``order`` (2N,)
    int32 lists entries ``2*row + side`` grouped by cell, in worklist
    order within a cell; cell ``c`` owns ``order[start[c]:start[c+1]]``
    (``start`` (n_cells + 1,) int32)."""

    order: torch.Tensor
    start: torch.Tensor


def scatter_index(cell_a, cell_b, n_cells: int) -> ScatterIndex:
    """Build the index by a stable sort of the 2N cell ids (index
    preparation, not the reduction; constant while the worklist is)."""
    ids = torch.stack([cell_a, cell_b], dim=1).reshape(-1).long()
    sorted_ids, order = torch.sort(ids, stable=True)
    start = torch.searchsorted(
        sorted_ids, torch.arange(n_cells + 1, dtype=torch.int64,
                                 device=ids.device))
    return ScatterIndex(order.to(torch.int32), start.to(torch.int32))


def _scatter_args(cell_a, cell_b, fa, fb, n_cells, index):
    dev = fa.get_device()
    check("fa", fa, 3, dev, _SUFFIX, _FLOATS)
    check("fb", fb, 3, dev, fa.dtype)
    N, K, C = fa.shape
    if C != 3 or tuple(fb.shape) != (N, K, 3):
        raise ValueError(f"fa, fb must be (N, K, 3), got {tuple(fa.shape)},"
                         f" {tuple(fb.shape)}")
    for name, t in (("cell_a", cell_a), ("cell_b", cell_b)):
        check(name, t, 1, dev, torch.int32)
        if t.shape[0] != N:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {N}")
    if index is not None:
        check("index.order", index.order, 1, dev, torch.int32)
        check("index.start", index.start, 1, dev, torch.int32)
        if index.order.shape[0] != 2 * N or \
                index.start.shape[0] != n_cells + 1:
            raise ValueError("index does not fit this batch")
    return N, K


def scatter_accum_plain(cell_a, cell_b, fa, fb, n_cells: int,
                        index: Optional[ScatterIndex] = None):
    """Plain form of :func:`scatter_accum`: every cell's j-th entry is
    added in a loop over j, so each cell sums its entries in the same
    order as the kernel (and as the sequential reference kernel)."""
    N, K = _scatter_args(cell_a, cell_b, fa, fb, n_cells, index)
    ids = torch.stack([cell_a, cell_b], dim=1).reshape(-1).long()
    out = torch.zeros((n_cells, K, 3), dtype=fa.dtype, device=fa.device)
    if N == 0:
        return out
    if int(ids.min()) < 0 or int(ids.max()) >= n_cells:
        raise IndexError(f"scatter_accum: cell index outside [0, {n_cells})")
    if index is None:
        index = scatter_index(cell_a, cell_b, n_cells)
    order = index.order.long()
    sorted_ids = ids[order]
    rank = torch.arange(2 * N, dtype=torch.int64, device=fa.device) - \
        index.start.long()[sorted_ids]
    vals = torch.stack([fa, fb], dim=1).reshape(2 * N, K, 3)[order]
    for j in range(int(rank.max()) + 1):
        m = rank == j
        cells = sorted_ids[m]          # distinct: one j-th entry per cell
        out[cells] = out[cells] + vals[m]
    return out


def scatter_accum(cell_a, cell_b, fa, fb, n_cells: int,
                  index: Optional[ScatterIndex] = None):
    """Sum (N, K, 3) pair forces into (n_cells, K, 3) cell forces.

    ``cell_a`` / ``cell_b`` (N,) int32 in ``[0, n_cells)``; cell ids
    repeat, and each cell adds its entries in worklist order (row by row,
    A side before B side).  ``index`` is :func:`scatter_index` of the same
    ids, built here when not given.  A cell id outside the range raises
    in the plain form and traps the kernel on the card.
    """
    N, K = _scatter_args(cell_a, cell_b, fa, fb, n_cells, index)
    if not fa.is_cuda:
        if fa.is_cpu:
            return scatter_accum_plain(cell_a, cell_b, fa, fb, n_cells, index)
        raise unsupported("scatter_accum", fa)
    if N == 0:
        return fa.new_zeros((n_cells, K, 3))
    if index is None:
        index = scatter_index(cell_a, cell_b, n_cells)
    out = fa.new_empty((n_cells, K, 3))
    fn = _SCATTER_ACCUM[fa.dtype]
    rc = fn(index.order.data_ptr(), index.start.data_ptr(), fa.data_ptr(),
            fb.data_ptr(), n_cells, K, 2 * N, out.data_ptr(),
            stream(fa.get_device()))
    if rc:
        raise refused(fn, rc)
    scatter_accum.launches += 1
    return out


scatter_accum.launches = 0


def pair_forces_accum(a, b, ta, tb, same, cell_a, cell_b, ff: ForceField,
                      n_cells: int, cnt_a=None, cnt_b=None,
                      index: Optional[ScatterIndex] = None):
    """:func:`pair_forces` followed by the :func:`scatter_accum` epilogue:
    returns the ``(n_cells, K, 3)`` cell forces and the per-pair energies.

    The reference's default epilogue, an XLA scatter-add, is not offered:
    here it would be a float ``index_add_``, which on the card adds with
    atomics in an order that changes from run to run.
    """
    fa, fb, pe = pair_forces(a, b, ta, tb, same, ff, cnt_a=cnt_a,
                             cnt_b=cnt_b)
    return scatter_accum(cell_a, cell_b, fa, fb, n_cells, index=index), pe
