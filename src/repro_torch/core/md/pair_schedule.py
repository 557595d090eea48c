"""Pruned cell-pair force schedules: the sparse NB engine (paper §5.4).

The port of the JAX package's ``core/md/pair_schedule.py``, batched over
the virtual domain mesh.  GROMACS keeps the non-bonded kernels saturated
with a **dual pair list** (Páll et al. 2020): an outer list built at
neighbour-search time with the Verlet-buffer radius, pruned every few
steps into an inner list at a tighter cutoff.  The dense path
(:func:`repro_torch.core.md.forces.compute_forces`) evaluates every
``K x K`` slot pair of all 14 zone products instead, padding included.

* :class:`PairSchedule` — the static worklist: all ``14 * n_local_cells``
  eighth-shell cell pairs of one domain, as flat indices into the trimmed
  extended cell array (the same for every domain).
* :func:`prune_local` — the rebin-cadence outer prune of every domain at
  once: drops pairs with an empty cell or whose bounding boxes sit
  further apart than :func:`prune_radius`; survivors are packed first,
  sorted by descending occupancy level, and the cumulative per-level
  histograms size the static tier ladder
  (:func:`repro_torch.core.md.schedule_opt.tier_plan`).
* :func:`roll_prune` — the ``nstprune``-cadence rolling inner prune:
  re-partitions the outer exec prefix with current coordinates at
  :func:`inner_radius`, inside a block, with no host read.
* the force-backend registry: ``"dense"`` (the 14-zone loop), and
  ``"sparse"`` and ``"pallas"``, one evaluator under two names: the
  tiered worklist through the ``pair_forces`` and ``scatter_accum``
  kernels of :mod:`repro_torch.kernels.nonbonded` (on CPU tensors their
  plain forms).  The reference's two pruned backends differ in their pair
  evaluator (jnp or Pallas) and take an XLA scatter-add as epilogue; here
  both sum in worklist order, since a float ``index_add_`` on the card
  adds with atomics in an order that changes from run to run.

Domains batch because the tier ladder is mesh-global: every domain shares
the tier shapes, so one launch per tier serves the whole mesh.  A pair's
cells are rows ``domain * (n_ext_cells + 1) + cell`` of one flat array
whose last row per domain is an all-empty sentinel cell (count 0): the
sentinel worklist row ``M`` points there, its work is masked to zero and
its scatter lands in the row sliced off at the end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.md.cells import (
    CellLayout,
    cell_bounds,
    cell_counts,
    cell_levels,
)
from repro_torch.core.md.forces import compute_forces, stencil_pairs
from repro_torch.core.md.integrate import fixed_sum
from repro_torch.core.md.schedule_opt import tier_rows, tier_slot_pairs
from repro_torch.core.md.system import ForceField, MDParams
from repro_torch.kernels import nonbonded

# exec-shape quanta: surviving pair counts bucket to multiples of
# PAIR_BUCKET and slot depths to multiples of SLOT_QUANTUM (the capacity
# padding of choose_layout)
PAIR_BUCKET = 64
SLOT_QUANTUM = 4

_BIG = 1e30  # empty-cell bounding-box sentinel (finite: no inf-inf NaNs)


def n_levels(capacity: int) -> int:
    """Occupancy levels of a layout: ``ceil(capacity / SLOT_QUANTUM)``."""
    return -(-int(capacity) // SLOT_QUANTUM)


# --------------------------------------------------------------------------
# static worklist (built once per layout)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PairSchedule:
    """Static eighth-shell cell-pair worklist of one domain.

    ``cell_a`` / ``cell_b`` are flat indices into the trimmed extended
    cell array ``(cz+1, cy+1, cx+1)``; ``same`` flags the self pairs.  The
    dynamic part (which pairs survive a block) is the ``sel`` tensor
    ``(Dz, Dy, Dx, M)`` of :func:`prune_local` / :func:`roll_prune`.
    """

    layout: CellLayout
    cell_a: np.ndarray    # (M,) int32
    cell_b: np.ndarray    # (M,) int32
    same: np.ndarray      # (M,) int32
    _padded: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @classmethod
    def build(cls, layout: CellLayout) -> "PairSchedule":
        for d in range(3):
            if layout.global_cells[d] < 2:
                raise ValueError(
                    "pair schedules need >= 2 global cells per dim "
                    f"(got {layout.global_cells}): with one global cell a "
                    "halo cell aliases its own periodic image, which only "
                    "the dense path's id mask handles")
        cz, cy, cx = layout.cells_per_domain
        ey, ex = cy + 1, cx + 1
        base = np.stack(np.meshgrid(np.arange(cz), np.arange(cy),
                                    np.arange(cx), indexing="ij"),
                        axis=-1).reshape(-1, 3)

        def flat(cells3):
            return ((cells3[:, 0] * ey + cells3[:, 1]) * ex
                    + cells3[:, 2]).astype(np.int32)

        cell_a, cell_b, same = [], [], []
        for a, b in stencil_pairs():
            cell_a.append(flat(base + np.asarray(a)))
            cell_b.append(flat(base + np.asarray(b)))
            same.append(np.full(base.shape[0], int(a == b), np.int32))
        return cls(layout=layout,
                   cell_a=np.concatenate(cell_a),
                   cell_b=np.concatenate(cell_b),
                   same=np.concatenate(same))

    @property
    def n_pairs(self) -> int:
        """Worklist length M = 14 * n_local_cells (the dense pair count)."""
        return int(self.cell_a.shape[0])

    @property
    def n_ext_cells(self) -> int:
        cz, cy, cx = self.layout.cells_per_domain
        return (cz + 1) * (cy + 1) * (cx + 1)

    @property
    def levels(self) -> int:
        """Occupancy-level count of this layout's tier ladders."""
        return n_levels(self.layout.capacity)

    def padded_pairs(self, device: torch.device):
        """``(cell_a, cell_b, same)`` as (M + 1,) int64 tensors on
        ``device``, row ``M`` the sentinel pair (the empty cell
        ``n_ext_cells`` with itself, not a self pair); made once per
        device."""
        key = str(device)
        if key not in self._padded:
            ne = self.n_ext_cells
            self._padded[key] = tuple(
                torch.as_tensor(np.append(v, fill).astype(np.int64),
                                device=device)
                for v, fill in ((self.cell_a, ne), (self.cell_b, ne),
                                (self.same, 0)))
        return self._padded[key]

    def dense_slot_pairs(self) -> int:
        """Slot pairs the dense engine evaluates per domain per step."""
        return self.n_pairs * self.layout.capacity ** 2

    def slot_pair_stats(self, tiers: Optional[Sequence] = None,
                        tiers_inner: Optional[Sequence] = None,
                        n_keep: Optional[int] = None,
                        n_inner: Optional[int] = None,
                        max_occupancy: Optional[int] = None,
                        global_kexec_slot_pairs: Optional[int] = None
                        ) -> dict:
        """Evaluated-work accounting for one pruned block (per domain).

        ``tiers`` is the outer ladder, ``tiers_inner`` the rolling-prune
        ladder executed between refreshes (when the dual list is on);
        ``global_kexec_slot_pairs`` what one global ``k_exec`` rectangle
        would have evaluated.
        """
        dense = self.dense_slot_pairs()
        out = {
            "n_pairs_dense": self.n_pairs,
            "k_capacity": self.layout.capacity,
            "dense_slot_pairs": dense,
        }
        if tiers is None:
            out.update({"evaluated_slot_pairs": dense, "prune_ratio": 1.0})
            return out
        outer = tier_slot_pairs(tiers)
        evaluated = tier_slot_pairs(tiers_inner) if tiers_inner else outer
        out.update({
            "n_pairs_exec": tier_rows(tiers),
            "n_pairs_kept": None if n_keep is None else int(n_keep),
            "tiers": [list(t) for t in tiers],
            "tiers_inner": None if not tiers_inner
            else [list(t) for t in tiers_inner],
            "n_pairs_inner": None if n_inner is None else int(n_inner),
            "max_occupancy": None if max_occupancy is None
            else int(max_occupancy),
            "outer_slot_pairs": outer,
            "evaluated_slot_pairs": evaluated,
            "global_kexec_slot_pairs": global_kexec_slot_pairs,
            "prune_ratio": dense / max(evaluated, 1),
        })
        if global_kexec_slot_pairs:
            out["per_pair_bound_gain"] = \
                global_kexec_slot_pairs / max(evaluated, 1)
        return out


def _drift(params: MDParams, steps: int) -> float:
    """Expected 3-sigma thermal drift of one atom over ``steps`` steps."""
    return steps * params.dt * 3.0 * math.sqrt(
        params.temperature / params.mass)


def prune_radius(params: MDParams) -> float:
    """Verlet-buffer radius of the outer prune: ``r_cut`` plus twice the
    expected per-block drift (bounding boxes go stale within a block)."""
    return params.ff.r_cut + 2.0 * _drift(params, params.nstlist)


def inner_radius(params: MDParams, nstprune: int) -> float:
    """Inner cutoff of the rolling prune, sized like :func:`prune_radius`
    for the ``nstprune`` refresh cadence."""
    return params.ff.r_cut + 2.0 * _drift(params, max(int(nstprune), 1))


# --------------------------------------------------------------------------
# rebin-cadence outer prune and nstprune-cadence rolling prune
# --------------------------------------------------------------------------

def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``like``'s dtype and device, made by a
    fill on the device (no host-to-device copy, which would stall the
    host until the stream drains)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _domains(ext: torch.Tensor) -> Tuple[int, ...]:
    """Leading domain dims of a trimmed extended cell array."""
    return tuple(ext.shape[:-5])


def _pair_geometry(sched: PairSchedule, ext_f, ext_i, idx):
    """Per-pair (bbox gap^2, same flag, occupancy level, counts) of every
    domain at worklist rows ``idx`` (B, n) in ``[0, M]``; the sentinel
    ``M`` reports gap ``_BIG`` and level 0."""
    M, ne = sched.n_pairs, sched.n_ext_cells
    B = idx.shape[0]
    counts = cell_counts(ext_i).reshape(B, ne)
    lvl_cell = cell_levels(counts, SLOT_QUANTUM)
    lo, hi = cell_bounds(ext_f[..., :3], ext_i, big=_BIG)
    lo, hi = lo.reshape(B, ne, 3), hi.reshape(B, ne, 3)

    ca_p, cb_p, same_p = sched.padded_pairs(idx.device)
    idx = idx.long()
    ca, cb, same = ca_p[idx], cb_p[idx], same_p[idx]
    zero_col = torch.zeros((B, 1), dtype=counts.dtype, device=idx.device)
    counts_p = torch.cat([counts, zero_col], dim=1)
    lvl_p = torch.cat([lvl_cell, zero_col], dim=1)

    def box(t, cells):
        cells = torch.clamp(cells, 0, ne - 1)
        return torch.gather(t, 1, cells[..., None].expand(-1, -1, 3))

    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    gap = torch.maximum(zero, torch.maximum(box(lo, ca) - box(hi, cb),
                                            box(lo, cb) - box(hi, ca)))
    d2 = torch.sum(gap * gap, dim=-1)
    d2 = torch.where(idx >= M, _scalar(_BIG, d2), d2)
    lvl = torch.maximum(torch.gather(lvl_p, 1, ca),
                        torch.gather(lvl_p, 1, cb))
    return (d2, same, lvl, torch.gather(counts_p, 1, ca),
            torch.gather(counts_p, 1, cb))


def _pack_by_level(keep, lvl, L: int, base=None):
    """Occupancy-sorted packing of each domain's rows: kept rows first, by
    DESCENDING level, original order within a level (stable sort).
    Returns the permuted rows (B, n) int32 and the cumulative per-level
    histogram ``cum`` (B, L) (``cum[:, l-1]`` = kept rows of level >= l).
    Integer adds only: deterministic on every device."""
    B, n = keep.shape
    key = torch.where(keep, L - lvl, L + 1).to(torch.int32)
    order = torch.sort(key, dim=-1, stable=True).indices
    hist = torch.zeros((B, L + 1), dtype=torch.int32, device=keep.device)
    hist.scatter_add_(1, torch.where(keep, lvl, 0).long(),
                      torch.ones_like(key))
    cum = torch.flip(torch.cumsum(torch.flip(hist[:, 1:], [1]), dim=1,
                                  dtype=torch.int32), [1])
    if base is None:
        return order.to(torch.int32), cum
    return torch.gather(base, 1, order).to(torch.int32), cum


def prune_local(sched: PairSchedule, ext_f: torch.Tensor, ext_i: torch.Tensor,
                r_prune: float, r_inner: Optional[float] = None):
    """Outer prune of the static worklist for one block, every domain.

    ``ext_f`` / ``ext_i`` are the TRIMMED extended arrays ``(*D, cz+1,
    cy+1, cx+1, K, F)``.  Returns ``(sel, cum, cum_inner, max_occ)`` per
    domain: ``sel`` (*D, M) int32 holds the surviving rows packed first by
    descending occupancy level (original order within a level), the
    sentinel ``M`` in the tail; ``cum`` / ``cum_inner`` (*D, L) are the
    cumulative per-level histograms of the outer survivors and of those
    also within ``r_inner`` (``r_inner=None`` repeats ``cum``);
    ``max_occ`` (*D,) the max cell occupancy.
    """
    D = _domains(ext_f)
    B = math.prod(D)
    M, L = sched.n_pairs, sched.levels
    dev = ext_f.device
    idx = torch.arange(M, dtype=torch.int32, device=dev).expand(B, M)
    d2, same, lvl, cnt_a, cnt_b = _pair_geometry(sched, ext_f, ext_i, idx)
    occupied = (cnt_a > 0) & (cnt_b > 0)
    r2p = _scalar(r_prune ** 2, d2)
    keep = torch.where(same > 0, cnt_a >= 2,   # self pair: >= 1 real pair
                       occupied & (d2 < r2p))
    order, cum = _pack_by_level(keep, lvl, L)
    sel = torch.where(idx < cum[:, :1], order, M).to(torch.int32)
    if r_inner is None:
        cum_inner = cum
    else:
        r2i = _scalar(r_inner ** 2, d2)
        keep_in = keep & ((same > 0) | (d2 < r2i))
        _, cum_inner = _pack_by_level(keep_in, lvl, L)
    max_occ = torch.amax(cell_counts(ext_i).reshape(B, -1), dim=1)
    return (sel.reshape(D + (M,)), cum.reshape(D + (L,)),
            cum_inner.reshape(D + (L,)), max_occ.reshape(D))


def roll_prune(sched: PairSchedule, sel: torch.Tensor, ext_f, ext_i,
               r_inner: float):
    """Re-partition each domain's outer exec prefix with CURRENT
    coordinates.

    ``sel`` (*D, n) holds packed rows in ``[0, M]``.  Pairs whose bounding
    boxes now sit beyond ``r_inner`` are stably sorted behind the
    survivors, which are re-sorted by descending level (the inner tier
    ladder's per-pair bounds stay valid).  Dropped pairs stay in the list
    (a later refresh re-examines every row); one inside the ladder adds
    exactly zero force (its box gap bounds every atom distance at
    ``r_inner >= r_cut``).  Returns ``(new_sel, cum_surv)``, ``cum_surv``
    (*D, L) the survivors' cumulative level histogram.  Counts its calls
    in ``roll_prune.calls``.
    """
    D = _domains(ext_f)
    flat = sel.reshape(math.prod(D), -1)
    d2, same, lvl, _cnt_a, _cnt_b = _pair_geometry(sched, ext_f, ext_i,
                                                   flat)
    r2i = _scalar(r_inner ** 2, d2)
    keep = (flat < sched.n_pairs) & ((same > 0) | (d2 < r2i))
    new_sel, cum = _pack_by_level(keep, lvl, sched.levels, base=flat)
    roll_prune.calls += 1
    return new_sel.reshape(sel.shape), cum.reshape(D + (sched.levels,))


roll_prune.calls = 0


# --------------------------------------------------------------------------
# batched execution over the pruned worklist (per tier, all domains)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierBatch:
    """The block-constant part of one tier, all domains at once: ``N =
    n_domains * n_rows`` pairs at ``k`` slots.  Cell ids are rows of the
    flat ``(n_domains * (n_ext_cells + 1), K, ...)`` padded array."""

    k: int
    cell_a: torch.Tensor      # (N,) int32
    cell_b: torch.Tensor      # (N,) int32
    same: torch.Tensor        # (N,) int32
    cnt_a: torch.Tensor       # (N,) int32, clipped to k
    cnt_b: torch.Tensor       # (N,) int32
    ta: torch.Tensor          # (N, k) int32 atom types, -1 = empty slot
    tb: torch.Tensor          # (N, k) int32
    index: nonbonded.ScatterIndex


def prepare_tiers(sched: PairSchedule, ext_i: torch.Tensor, sel, tiers
                  ) -> Tuple[TierBatch, ...]:
    """Gather everything of a tiered worklist that stays fixed while
    ``sel`` and the atoms' cells do (a block, or a rolling-prune
    sub-block): cell rows, counts, types and the scatter index.

    ``ext_i`` is the trimmed extended ``(*D, ..., K, 2)`` index array,
    ``sel`` (*D, >= tier_rows(tiers)) the packed worklist rows, ``tiers``
    the static ``((n_rows, k_slots), ...)`` ladder, deepest first.
    """
    D = _domains(ext_i)
    B = math.prod(D)
    ne = sched.n_ext_cells
    K = ext_i.shape[-2]
    dev = ext_i.device
    ca_p, cb_p, same_p = sched.padded_pairs(dev)
    ids = ext_i[..., 0].reshape(B, ne, K)
    typ = torch.where(ids >= 0, ext_i[..., 1].reshape(B, ne, K),
                      -1).to(torch.int32)
    typ = torch.cat([typ, torch.full((B, 1, K), -1, dtype=torch.int32,
                                     device=dev)], dim=1)
    counts = cell_counts(ext_i).reshape(B, ne)
    counts = torch.cat([counts, torch.zeros((B, 1), dtype=counts.dtype,
                                            device=dev)], dim=1)
    typ, counts = typ.reshape(B * (ne + 1), K), counts.reshape(-1)
    offset = (torch.arange(B, device=dev) * (ne + 1))[:, None]
    sel = sel.reshape(B, -1).long()
    n_cells = B * (ne + 1)
    out, off = [], 0
    for n_t, k_t in tiers:
        k_t = min(int(k_t), K)
        rows = sel[:, off:off + int(n_t)]
        off += int(n_t)
        ca = (ca_p[rows] + offset).reshape(-1)
        cb = (cb_p[rows] + offset).reshape(-1)
        cell_a, cell_b = ca.to(torch.int32), cb.to(torch.int32)
        tk = typ[:, :k_t]
        out.append(TierBatch(
            k=k_t, cell_a=cell_a, cell_b=cell_b,
            same=same_p[rows].reshape(-1).to(torch.int32),
            cnt_a=torch.clamp(counts[ca], max=k_t).to(torch.int32),
            cnt_b=torch.clamp(counts[cb], max=k_t).to(torch.int32),
            ta=tk[ca].contiguous(), tb=tk[cb].contiguous(),
            index=nonbonded.scatter_index(cell_a, cell_b, n_cells)))
    return tuple(out)


def padded_coords(ext_f: torch.Tensor) -> torch.Tensor:
    """The trimmed extended ``(*D, ..., K, 4)`` coordinates as the flat
    ``(n_domains * (n_ext_cells + 1), K, 4)`` array the tier batches index,
    each domain's last row the all-zero sentinel cell."""
    D = _domains(ext_f)
    K, F = ext_f.shape[-2:]
    f2 = ext_f.reshape(math.prod(D), -1, K, F)
    zero = torch.zeros((f2.shape[0], 1, K, F), dtype=f2.dtype,
                       device=f2.device)
    return torch.cat([f2, zero], dim=1).reshape(-1, K, F)


def gather_tier(f2p: torch.Tensor, t: TierBatch):
    """A tier's ``(N, k, 4)`` A and B batches from :func:`padded_coords`."""
    fk = f2p[:, :t.k]
    return fk.index_select(0, t.cell_a), fk.index_select(0, t.cell_b)


def _eval_schedule(ext_f, ff: ForceField, batches: Sequence[TierBatch]):
    """Evaluate a tiered worklist: gather -> pair forces -> ordered
    scatter, every domain at once.

    Returns ``(F_ext, pe)`` as ``compute_forces`` does: the trimmed
    extended force array with halo partial sums, and each domain's
    potential energy.  Tiers accumulate in ladder order.
    """
    D = _domains(ext_f)
    B = math.prod(D)
    K = ext_f.shape[-2]
    f2p = padded_coords(ext_f)
    n_cells = f2p.shape[0]
    F_acc = torch.zeros((n_cells, K, 3), dtype=ext_f.dtype,
                        device=ext_f.device)
    pe = torch.zeros((B,), dtype=ext_f.dtype, device=ext_f.device)
    for t in batches:
        a, b = gather_tier(f2p, t)
        F, pe_pairs = nonbonded.pair_forces_accum(
            a, b, t.ta, t.tb, t.same, t.cell_a, t.cell_b, ff, n_cells,
            cnt_a=t.cnt_a, cnt_b=t.cnt_b, index=t.index)
        F_acc[:, :t.k] += F
        pe = pe + fixed_sum(pe_pairs.reshape(B, -1), 1)
    F_ext = F_acc.reshape(B, -1, K, 3)[:, :-1]
    return F_ext.reshape(ext_f.shape[:-1] + (3,)), pe.reshape(D)


# --------------------------------------------------------------------------
# force-backend registry
# --------------------------------------------------------------------------

def _dense(ext_f, ext_i, layout, ff, **_):
    """The 14-zone loop (the reference's bitwise trajectory path)."""
    return compute_forces(ext_f, ext_i, layout, ff)


def _pruned(ext_f, ext_i, layout, ff, *, sched, batches):
    """The tiered worklist through the nonbonded kernels."""
    return _eval_schedule(ext_f, ff, batches)


ForceBackend = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
_FORCE_BACKENDS: Dict[str, ForceBackend] = {}


def register_force_backend(name: str, fn: ForceBackend) -> None:
    """Register a force engine under ``name`` (the config axis value)."""
    _FORCE_BACKENDS[name] = fn


def force_backends() -> Tuple[str, ...]:
    return tuple(sorted(_FORCE_BACKENDS))


def get_force_backend(name: str) -> ForceBackend:
    try:
        return _FORCE_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown force backend {name!r}; "
            f"available: {force_backends()}") from None


register_force_backend("dense", _dense)
register_force_backend("sparse", _pruned)
register_force_backend("pallas", _pruned)
