"""Cell-pair LJ + reaction-field forces and their scatter-accumulate
epilogue: CUDA kernels for Hopper plus their plain forms.

Replaces the TPU kernels ``src/repro/kernels/nonbonded.py:pair_forces``
(body ``_pair_kernel``) and ``:scatter_accum`` (body
``_scatter_accum_kernel``), the pruned ``"pallas"`` force backend's hot
loop.  The CUDA source is ``csrc/nonbonded.cu``; its header says what
bounds each kernel on an H100 and what the design does about it.

* :func:`pair_forces` — one batch of N cell pairs ``(N, K, 4)`` [x, y, z,
  q]: forces on both sides and each pair's potential energy.
* :func:`scatter_accum` — sums the per-pair forces into their cells in
  worklist order (entry ``2*row + side``: A side first, then B), through
  an ordered cell -> entries index (:func:`scatter_index`), with no
  atomics: the result is deterministic and bitwise equal to the plain
  form.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version beside it.  Each wrapper counts its launches in a
plain integer attribute (``pair_forces.launches``,
``scatter_accum.launches``), raised only where the kernel is launched.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.md.forces import pair_terms
from repro_torch.core.md.system import ForceField
from repro_torch.kernels import _build
from repro_torch.kernels.halo_pack import _check, _launch

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("nonbonded")
    ptr, i64, f64, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                          ctypes.c_int)
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"nb_pair_forces_{sfx}")
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                       f64, f64, f64, i64, i64, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"nb_scatter_accum_{sfx}")
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _tables(eps, sigma, dtype: torch.dtype, device: torch.device):
    """The force field's (T, T) LJ tables on the device, made once (a
    copy to the card per call would stall the host)."""
    return (torch.tensor(eps, dtype=dtype, device=device),
            torch.tensor(sigma, dtype=dtype, device=device))


def _float_check(name: str, t: torch.Tensor, ndim: int,
                 device: torch.device, dtype=None) -> None:
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name} must be float32 or float64, got {t.dtype}")
    _check(name, t, ndim, device, dtype)


# ---- pair_forces --------------------------------------------------------------

def _pair_args(a, b, ta, tb, same, cnt_a, cnt_b):
    _float_check("a", a, 3, a.device)
    _float_check("b", b, 3, a.device, a.dtype)
    N, K, F = a.shape
    if F != 4 or tuple(b.shape) != (N, K, 4):
        raise ValueError(f"a, b must be (N, K, 4), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    for name, t in (("ta", ta), ("tb", tb)):
        _check(name, t, 2, a.device, torch.int32)
        if tuple(t.shape) != (N, K):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(N, K)}")
    if (cnt_a is None) != (cnt_b is None):
        raise ValueError("pass both cnt_a and cnt_b or neither")
    for name, t in (("same", same), ("cnt_a", cnt_a), ("cnt_b", cnt_b)):
        if t is None:
            continue
        _check(name, t, 1, a.device, torch.int32)
        if t.shape[0] != N:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {N}")
    return N, K


def pair_forces_plain(a, b, ta, tb, same, ff: ForceField, cnt_a=None,
                      cnt_b=None):
    """Plain form of :func:`pair_forces`: the K x K tile as broadcasts,
    the pair terms of the dense path (``forces.pair_terms``)."""
    N, K = _pair_args(a, b, ta, tb, same, cnt_a, cnt_b)
    dev, dtype = a.device, a.dtype
    eps_t, sig_t = _tables(ff.eps, ff.sigma, dtype, dev)
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

    On the card a block holds one column of the K x K tile at the least,
    so K is bounded by the block's shared memory (227 KB on an H100):
    K <= 5,259 in f32 and 2,742 in f64; a deeper cell makes the C entry
    refuse the launch, which raises here.
    """
    N, K = _pair_args(a, b, ta, tb, same, cnt_a, cnt_b)
    if a.device.type == "cpu":
        return pair_forces_plain(a, b, ta, tb, same, ff, cnt_a, cnt_b)
    if a.device.type != "cuda":
        raise ValueError(f"pair_forces: unsupported device {a.device}")
    fa = torch.empty((N, K, 3), dtype=a.dtype, device=a.device)
    fb = torch.empty_like(fa)
    pe = torch.empty((N,), dtype=a.dtype, device=a.device)
    if N == 0:
        return fa, fb, pe
    eps_t, sig_t = _tables(ff.eps, ff.sigma, a.dtype, a.device)
    _launch(getattr(_lib(), f"nb_pair_forces_{_SUFFIX[a.dtype]}"),
            a.data_ptr(), b.data_ptr(), ta.data_ptr(), tb.data_ptr(),
            same.data_ptr(),
            None if cnt_a is None else cnt_a.data_ptr(),
            None if cnt_b is None else cnt_b.data_ptr(),
            eps_t.data_ptr(), sig_t.data_ptr(), eps_t.shape[0],
            ff.r_cut * ff.r_cut, ff.k_rf, ff.c_rf, N, K,
            fa.data_ptr(), fb.data_ptr(), pe.data_ptr(), device=a.device)
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
        sorted_ids, torch.arange(n_cells + 1, device=ids.device))
    return ScatterIndex(order.to(torch.int32), start.to(torch.int32))


def _scatter_args(cell_a, cell_b, fa, fb, n_cells, index):
    _float_check("fa", fa, 3, fa.device)
    _float_check("fb", fb, 3, fa.device, fa.dtype)
    N, K, C = fa.shape
    if C != 3 or tuple(fb.shape) != (N, K, 3):
        raise ValueError(f"fa, fb must be (N, K, 3), got {tuple(fa.shape)},"
                         f" {tuple(fb.shape)}")
    for name, t in (("cell_a", cell_a), ("cell_b", cell_b)):
        _check(name, t, 1, fa.device, torch.int32)
        if t.shape[0] != N:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {N}")
    if index is not None:
        _check("index.order", index.order, 1, fa.device, torch.int32)
        _check("index.start", index.start, 1, fa.device, torch.int32)
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
    rank = torch.arange(2 * N, device=fa.device) - \
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
    if fa.device.type == "cpu":
        return scatter_accum_plain(cell_a, cell_b, fa, fb, n_cells, index)
    if fa.device.type != "cuda":
        raise ValueError(f"scatter_accum: unsupported device {fa.device}")
    if N == 0:
        return torch.zeros((n_cells, K, 3), dtype=fa.dtype, device=fa.device)
    if index is None:
        index = scatter_index(cell_a, cell_b, n_cells)
    out = torch.empty((n_cells, K, 3), dtype=fa.dtype, device=fa.device)
    _launch(getattr(_lib(), f"nb_scatter_accum_{_SUFFIX[fa.dtype]}"),
            index.order.data_ptr(), index.start.data_ptr(), fa.data_ptr(),
            fb.data_ptr(), n_cells, K, 2 * N, out.data_ptr(),
            device=fa.device)
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
