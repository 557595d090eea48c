"""Plain PyTorch oracles for the port's kernels (the JAX ``ref.py`` forms)."""
from __future__ import annotations

import numpy as np
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


# ---- nonbonded.pair_forces -------------------------------------------------

def pair_forces_ref(a, b, ta, tb, same, ff, cnt_a=None, cnt_b=None):
    """Float64 loop oracle of ``nonbonded.pair_forces`` (tiny sizes only).

    Slot validity is ``type >= 0``, or ``slot < count`` when counts are
    given; a self pair keeps ``j > i``.  Returns float64 ``(fa, fb, pe)``.
    """
    a = np.asarray(torch.as_tensor(a).cpu(), np.float64)
    b = np.asarray(torch.as_tensor(b).cpu(), np.float64)
    ta, tb, same = (np.asarray(torch.as_tensor(x).cpu())
                    for x in (ta, tb, same))
    N, K, _ = a.shape
    if cnt_a is None:
        valid_a, valid_b = ta >= 0, tb >= 0
    else:
        slots = np.arange(K)[None, :]
        valid_a = slots < np.asarray(torch.as_tensor(cnt_a).cpu())[:, None]
        valid_b = slots < np.asarray(torch.as_tensor(cnt_b).cpu())[:, None]
    eps_t, sig_t = np.asarray(ff.eps), np.asarray(ff.sigma)
    T = eps_t.shape[0]
    fa, fb, pe = np.zeros((N, K, 3)), np.zeros((N, K, 3)), np.zeros((N,))
    for n in range(N):
        for i in range(K):
            if not valid_a[n, i]:
                continue
            for j in range(K):
                if not valid_b[n, j] or (same[n] and j <= i):
                    continue
                dx = a[n, i, :3] - b[n, j, :3]
                r2 = float(dx @ dx)
                if r2 >= ff.r_cut ** 2:
                    continue
                ti = min(max(int(ta[n, i]), 0), T - 1)
                tj = min(max(int(tb[n, j]), 0), T - 1)
                eps, sig = eps_t[ti, tj], sig_t[ti, tj]
                sr6 = (sig * sig / r2) ** 3
                sr12 = sr6 ** 2
                fac = 24 * eps * (2 * sr12 - sr6) / r2
                src6 = (sig * sig / ff.r_cut ** 2) ** 3
                e = 4 * eps * ((sr12 - sr6) - (src6 ** 2 - src6))
                qq = a[n, i, 3] * b[n, j, 3]
                fac += qq * (r2 ** -1.5 - 2 * ff.k_rf)
                e += qq * (r2 ** -0.5 + ff.k_rf * r2 - ff.c_rf)
                fa[n, i] += fac * dx
                fb[n, j] -= fac * dx
                pe[n] += e
    return torch.from_numpy(fa), torch.from_numpy(fb), torch.from_numpy(pe)


# ---- flash_attention.flash_attention ---------------------------------------

def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: (BH, L, G, hd); k/v: (BH, S, hd) -> (BH, L, G, hd): one float64
    softmax over all keys (no blocking), masked logits -1e30."""
    qf = torch.as_tensor(q).double()
    kf = torch.as_tensor(k).double()
    vf = torch.as_tensor(v).double()
    L, hd = qf.shape[1], qf.shape[3]
    S = kf.shape[1]
    logits = torch.einsum("blgd,bsd->blgs", qf, kf) / np.sqrt(hd)
    if causal:
        mask = torch.arange(L)[:, None] >= torch.arange(S)[None, :]
        logits = torch.where(mask[None, :, None, :].to(logits.device),
                             logits, -1e30)
    return torch.einsum("blgs,bsd->blgd", torch.softmax(logits, dim=-1), vf)
