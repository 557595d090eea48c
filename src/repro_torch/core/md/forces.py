"""Non-bonded forces: LJ + reaction field over cutoff-sized cell pairs.

The port of the JAX package's ``core/md/forces.py`` (the ``"dense"``
force backend), batched over domains.  Pair assignment follows the
neutral-territory eighth-shell rule: with one-sided halos every global
cell pair within the stencil is computed by exactly one domain, which
gives 14 zone products per base cell (the cell with itself plus 13
pairs of disjoint offsets in {0,1}^3).  Periodic images are pre-shifted
by the halo exchange, so no minimum-image logic appears here.

Constants are tensors of the working dtype on the working device, made
once per (value, dtype, device) (:func:`repro_torch.device.const`), so
an f32 pass stays f32 (and an f64 pass f64), every division is a true
division, as in the reference, and no pass copies from the host.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.md.cells import CellLayout
from repro_torch.core.md.integrate import fixed_sum
from repro_torch.core.md.system import ForceField
from repro_torch.device import const

Offset = Tuple[int, int, int]


def stencil_pairs() -> List[Tuple[Offset, Offset]]:
    """Self pair + the 13 disjoint-offset cell pairs (eighth-shell zones)."""
    offs = list(itertools.product((0, 1), repeat=3))
    pairs: List[Tuple[Offset, Offset]] = [((0, 0, 0), (0, 0, 0))]
    for a, b in itertools.combinations(offs, 2):
        if all(x * y == 0 for x, y in zip(a, b)):
            pairs.append((a, b))
    if len(pairs) != 14:
        raise AssertionError("eighth-shell stencil must have 14 zones")
    return pairs


def _zone(arr, off, shape):
    """Cells ``off + [0, shape)`` of ``(..., Z, Y, X, K, F)`` arrays."""
    cz, cy, cx = shape
    return arr[..., off[0]:off[0] + cz, off[1]:off[1] + cy,
               off[2]:off[2] + cx, :, :]


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return const(float(v), like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def ff_tables(eps, sigma, dtype: torch.dtype, device: torch.device):
    """The force field's (T, T) LJ tables on the device, made once (a
    copy to the card per call would stall the host)."""
    return (torch.tensor(eps, dtype=dtype, device=device),
            torch.tensor(sigma, dtype=dtype, device=device))


def pair_terms(dx, r2, qa, qb, eps, sig, ff: ForceField, mask):
    """Per-pair scalar force factor (F = fac * dx) and potential energy."""
    one = _const(1.0, r2)
    r2safe = torch.where(mask, r2, one)
    inv_r2 = one / r2safe
    sr2 = (sig * sig) * inv_r2
    sr6 = sr2 * sr2 * sr2
    sr12 = sr6 * sr6
    # LJ with potential-shift at the cutoff (forces unchanged)
    fac_lj = _const(24.0, r2) * eps * (_const(2.0, r2) * sr12 - sr6) * inv_r2
    src2 = (sig * sig) / _const(ff.r_cut * ff.r_cut, r2)
    src6 = src2 * src2 * src2
    e_lj = _const(4.0, r2) * eps * ((sr12 - sr6) - (src6 * src6 - src6))
    # reaction field with potential shift c_rf
    inv_r = torch.sqrt(inv_r2)
    qq = qa * qb
    k_rf = _const(ff.k_rf, r2)
    c_rf = _const(ff.c_rf, r2)
    fac_c = qq * (inv_r * inv_r2 - _const(2.0, r2) * k_rf)
    e_c = qq * (inv_r + k_rf * r2safe - c_rf)
    zero = _const(0.0, r2)
    fac = torch.where(mask, fac_lj + fac_c, zero)
    pe = torch.where(mask, e_lj + e_c, zero)
    return fac, pe


def compute_forces(ext_f, ext_i, layout: CellLayout, ff: ForceField):
    """Forces + potential energy on extended (home + halo) cell arrays.

    ext_f: (*D, cz+1, cy+1, cx+1, K, 4) — [x, y, z, charge], halo-shifted
    ext_i: (*D, cz+1, cy+1, cx+1, K, 2) — [atom id, type]; id < 0 = empty
    ``*D`` are the domain dims (with any lane dims in front).  Returns
    (F_ext, pe): forces accumulated at both pair members (halo members
    hold partial sums for the reverse exchange) and each domain's
    potential energy, shape ``D``, summed in a fixed order
    (:func:`~repro_torch.core.md.integrate.fixed_sum`).
    """
    shape = layout.cells_per_domain
    dtype, dev = ext_f.dtype, ext_f.device
    lead = ext_f.dim() - 5
    eps_t, sig_t = ff_tables(ff.eps, ff.sigma, dtype, dev)
    n_types = eps_t.shape[0]
    rc2 = _const(ff.r_cut * ff.r_cut, ext_f)
    K = layout.capacity

    F_ext = torch.zeros(ext_f.shape[:-1] + (3,), dtype=dtype, device=dev)
    pe_total = torch.zeros(ext_f.shape[:lead], dtype=dtype, device=dev)
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    tri = torch.triu(torch.ones((K, K), dtype=torch.bool, device=dev),
                     diagonal=1)
    cz, cy, cx = shape
    for a, b in stencil_pairs():
        A_f, B_f = _zone(ext_f, a, shape), _zone(ext_f, b, shape)
        A_i, B_i = _zone(ext_i, a, shape), _zone(ext_i, b, shape)
        pos_a, q_a = A_f[..., :3], A_f[..., 3]
        pos_b, q_b = B_f[..., :3], B_f[..., 3]
        valid_a, valid_b = A_i[..., 0] >= 0, B_i[..., 0] >= 0
        typ_a = torch.clamp(A_i[..., 1], 0, n_types - 1).long()
        typ_b = torch.clamp(B_i[..., 1], 0, n_types - 1).long()

        dx = pos_a[..., :, None, :] - pos_b[..., None, :, :]
        r2 = torch.sum(dx * dx, dim=-1)
        mask = (valid_a[..., :, None] & valid_b[..., None, :]) & (r2 < rc2)
        if a == b:
            mask = mask & tri        # each intra-cell pair once
        else:
            # a cell meeting its own periodic image: skip self pairs
            mask = mask & ~(eye & (A_i[..., 0:1] == B_i[..., None, :, 0]))

        eps = eps_t[typ_a[..., :, None], typ_b[..., None, :]]
        sig = sig_t[typ_a[..., :, None], typ_b[..., None, :]]
        fac, pe = pair_terms(dx, r2, q_a[..., :, None], q_b[..., None, :],
                             eps, sig, ff, mask)
        fvec = fac[..., None] * dx
        # plain slice adds, never index_add_: the sums stay in one fixed
        # order on every run and every device
        F_ext[..., a[0]:a[0] + cz, a[1]:a[1] + cy, a[2]:a[2] + cx, :, :] += \
            torch.sum(fvec, dim=-2)          # force on A atoms
        F_ext[..., b[0]:b[0] + cz, b[1]:b[1] + cy, b[2]:b[2] + cx, :, :] += \
            -torch.sum(fvec, dim=-3)         # Newton's third law
        pe_total = pe_total + fixed_sum(pe, lead)

    return F_ext, pe_total


# --------------------------------------------------------------------------
# O(N^2) minimum-image oracle (tests only)
# --------------------------------------------------------------------------

def direct_forces_reference(pos, charge, typ, box, ff: ForceField):
    """Direct-sum reference with minimum image; float64 numpy."""
    pos = np.asarray(pos, np.float64)
    q = np.asarray(charge, np.float64)
    t = np.asarray(typ, np.int64)
    box = np.asarray(box, np.float64)
    n = pos.shape[0]
    eps_t = np.asarray(ff.eps, np.float64)
    sig_t = np.asarray(ff.sigma, np.float64)

    dx = pos[:, None, :] - pos[None, :, :]
    dx -= box * np.round(dx / box)
    r2 = np.sum(dx * dx, axis=-1)
    mask = (r2 < ff.r_cut ** 2) & ~np.eye(n, dtype=bool)
    r2safe = np.where(mask, r2, 1.0)
    inv_r2 = 1.0 / r2safe
    eps = eps_t[t[:, None], t[None, :]]
    sig = sig_t[t[:, None], t[None, :]]
    sr2 = sig * sig * inv_r2
    sr6 = sr2 ** 3
    sr12 = sr6 ** 2
    fac_lj = 24 * eps * (2 * sr12 - sr6) * inv_r2
    src6 = (sig * sig / ff.r_cut ** 2) ** 3
    e_lj = 4 * eps * ((sr12 - sr6) - (src6 ** 2 - src6))
    inv_r = np.sqrt(inv_r2)
    qq = q[:, None] * q[None, :]
    fac_c = qq * (inv_r * inv_r2 - 2 * ff.k_rf)
    e_c = qq * (inv_r + ff.k_rf * r2safe - ff.c_rf)
    fac = np.where(mask, fac_lj + fac_c, 0.0)
    pe = 0.5 * np.sum(np.where(mask, e_lj + e_c, 0.0))
    forces = np.sum(fac[..., None] * dx, axis=1)
    return forces, pe
