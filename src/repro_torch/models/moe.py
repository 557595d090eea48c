"""Mixture-of-Experts FFN on one card.

Port of ``src/repro/models/moe.py`` for one device.  Routing is the
reference's select-then-softmax top-k in float32 with its two aux losses
(switch-style load balance ``moe_lb`` and router z-loss ``moe_z``);
dispatch is its sort-based capacity dispatch: each (token, pick)
assignment gets a slot ``expert * capacity + rank`` in a buffer of
``n_experts * capacity`` rows, ranks past the capacity are dropped, the
expert FFN runs as batched products over experts, and each token's kept
outputs are weighted by their gates and summed.

Dispatches (``moe_fwd(..., dispatch=)``):

* ``"dense"`` -- every expert on every token, weighted by the gates: the
  reference's oracle, with no capacity and so no drops;
* ``"fused"`` / ``"serialized"`` -- what the reference's ``_moe_manual``
  computes on a one-device mesh.  Its expert-parallel branch (``L > 1``)
  and its replicated branch (decode) are then both one capacity dispatch
  over all tokens, and its all-to-alls are identities.  The reference's
  ``fused`` also runs the expert FFN on the all-zero "remote" half of the
  buffer and adds the result; that result is exact zeros, so the port
  skips it and ``fused`` and ``serialized`` are one computation
  (``tests/test_torch_moe.py`` pins both facts).

Rounding points are the reference's: the router in float32 from a float32
cast of ``x``; ``keep * gates`` cast to the compute dtype before the
product; the sum over the k picks in float32, rounded once to the compute
dtype (``jnp.sum`` of bfloat16 accumulates in float32); divisors as 0-dim
tensors.  The k picks of a token are in ``lax.top_k``'s order (value
descending, the lower expert first on ties), which fixes the order of
that sum.

Determinism on CUDA: kept slots are unique, so the dispatch buffer is
filled by a plain indexed copy (dropped assignments all write the
sentinel row, which is cut off).  The gather of expert outputs reads each
kept slot once; its backward adds more than one term only into the
sentinel row, a constant whose gradient is discarded.

The expert share (``share=(index, count)``) is one card's part of
expert parallelism over ``count`` cards: the local half of the reference's
fused EP branch (``local_buf`` / ``local_out`` in ``_moe_manual(ep=True)``),
without the all-to-all.  The layer holds experts ``[index * E / count,
(index + 1) * E / count)`` only, routes the card's tokens over all E
experts exactly as the whole layer does (the same tables, capacity and aux
losses), runs the held experts on their capacity rows and returns their
gated outputs alone; a shared expert is added on share 0.  The shares'
outputs sum to the whole layer's.  Nothing stands in for the other cards
or their traffic; the all-to-alls and the multi-rank branches of
``_moe_manual`` wait for the multi-GPU work.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoECfg
from repro_torch.device import const
from repro_torch.models.layers import ParamDef, ParamDefs, mlp_defs, mlp_fwd

DISPATCHES = ("fused", "serialized", "dense")


def held_experts(m: MoECfg, share) -> range:
    """The experts that ``share`` (``(index, count)`` or None) holds;
    ``ValueError`` unless ``count`` divides the experts and ``index`` is
    one of ``count``."""
    if share is None:
        return range(m.n_experts)
    index, count = share
    if count < 1 or m.n_experts % count or not 0 <= index < count:
        raise ValueError(f"expert share {index}/{count} of {m.n_experts} "
                         "experts: the count must divide them and the index "
                         "be one of the count")
    n = m.n_experts // count
    return range(index * n, (index + 1) * n)


def moe_defs(cfg: ArchConfig, share=None) -> ParamDefs:
    m = cfg.moe
    d = cfg.d_model
    E = len(held_experts(m, share))
    defs: ParamDefs = {
        "router": ParamDef((d, m.n_experts), "small_normal"),
        "w_gate": ParamDef((E, d, m.d_expert)),
        "w_up": ParamDef((E, d, m.d_expert)),
        "w_down": ParamDef((E, m.d_expert, d)),
    }
    if m.shared_expert:
        defs["shared"] = mlp_defs(d, m.d_expert, "swiglu", False)
    return defs


def _top_k(logits: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, value descending,
    the lower index first among equal values (a stable sort)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x2d, router_w, m: MoECfg):
    """Top-k routing (select-then-softmax) + aux losses, in f32.  Returns
    ``(top_e (T, K) int64, top_g (T, K) f32, {"moe_lb", "moe_z"})``."""
    logits = x2d.float() @ router_w.float()
    gates_full = torch.softmax(logits, dim=-1)
    top_g, top_e = _top_k(logits, m.top_k)
    top_g = torch.softmax(top_g, dim=-1)
    T = x2d.shape[0]
    f32, dev = torch.float32, logits.device
    density = gates_full.sum(0) / const(float(T), f32, dev)
    # a float scatter of ones: whole numbers, exact in any order (bincount
    # would read the largest index back to the host)
    flat_e = top_e.reshape(-1)
    counts = torch.zeros(m.n_experts, dtype=f32, device=dev)
    counts.index_add_(0, flat_e,  # noqa: RT006
                      torch.ones(flat_e.shape, dtype=f32, device=dev))
    counts = counts / const(float(T * m.top_k), f32, dev)
    lb_loss = m.n_experts * (density * counts).sum()
    lse = torch.logsumexp(logits, dim=-1)
    z_loss = (lse * lse).sum() / const(float(T), f32, dev)
    return top_e, top_g, {"moe_lb": lb_loss, "moe_z": z_loss}


def _expert_ffn(wg, wu, wd, xe, mlp_type: str):
    """Batched expert MLP: xe (E, C, d) -> (E, C, d)."""
    if mlp_type == "swiglu":
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.bmm(xe, wu), approximate="tanh")
    return torch.bmm(h, wd)


def _dispatch_tables(top_e, top_g, n_experts: int, capacity: int):
    """Sort-based dispatch: ``(slot (T*K,), keep (T*K,))``, slot
    ``e * capacity + rank`` for a kept assignment (its rank among the
    assignments to expert ``e`` in token-major order), the sentinel
    ``n_experts * capacity`` for a dropped one.  ``top_g`` is unused, as
    in the reference."""
    T, K = top_e.shape
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]  # noqa: RT006 - expert ids: no gradient
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(T * K, device=flat_e.device) - first
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted                 # a permutation: no collisions
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank,
                       torch.full_like(rank, n_experts * capacity))
    return slot, keep


def _scatter_tokens(x2d, slot, keep, n_experts, capacity, K):
    """The (E, C, d) dispatch buffer: row ``slot`` holds its token, empty
    slots are zero.  A plain indexed copy: kept slots are unique, dropped
    assignments all land in the sentinel row, which is cut off."""
    T, d = x2d.shape
    buf = x2d.new_zeros((n_experts * capacity + 1, d))
    src = x2d[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = buf.index_put((slot,), src)
    return buf[:-1].reshape(n_experts, capacity, d)


def _gather_outputs(out_buf, slot, keep, gates, T, K):
    """Each token's kept expert outputs times their gates (cast to the
    compute dtype first), summed over the k picks in float32 and rounded
    once."""
    d = out_buf.shape[-1]
    flat = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])
    # kept slots are distinct; dropped ones share the sentinel row, whose
    # gradient is discarded
    per_assign = flat.index_select(0, slot)  # noqa: RT006
    w = (keep.to(gates.dtype) * gates.reshape(-1)).to(per_assign.dtype)
    per_assign = per_assign * w[:, None]
    return per_assign.reshape(T, K, d).sum(1, dtype=torch.float32) \
        .to(out_buf.dtype)


def _capacity(tokens: int, m: MoECfg, n_experts: int) -> int:
    c = int(tokens * m.top_k * m.capacity_factor / n_experts) + 1
    return max(4, ((c + 3) // 4) * 4)


def moe_fwd(p, x, cfg: ArchConfig, dispatch: str = "fused", share=None):
    """MoE FFN layer.  x: (B, L, d).  Returns ``(out, aux_losses)``; with
    ``share`` the held experts' part of ``out`` (see the module
    docstring)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe dispatch {dispatch!r}: one of {DISPATCHES}")
    m = cfg.moe
    held = held_experts(m, share)
    B, L, d = x.shape
    x2d = x.reshape(-1, d)
    top_e, top_g, aux = _route(x2d, p["router"], m)
    if dispatch == "dense":
        outs = torch.zeros_like(x2d)
        for i, e in enumerate(held):          # reference oracle
            wg, wu, wd = (p[k][i] for k in ("w_gate", "w_up", "w_down"))
            if cfg.mlp_type == "swiglu":
                h = F.silu(x2d @ wg) * (x2d @ wu)
            else:
                h = F.gelu(x2d @ wu, approximate="tanh")
            oe = h @ wd
            w = torch.where(top_e == e, top_g, 0.0).sum(-1).to(oe.dtype)
            outs = outs + oe * w[:, None]
        out = outs.reshape(B, L, d)
    else:
        T = B * L
        cap = _capacity(T, m, m.n_experts)
        slot, keep = _dispatch_tables(top_e, top_g, m.n_experts, cap)
        if share is not None:
            # the held experts' slots, counted from the first held one;
            # every other assignment goes to the sentinel row
            lo, hi = held.start * cap, held.stop * cap
            keep = keep & (slot >= lo) & (slot < hi)
            slot = torch.where(keep, slot - lo,
                               torch.full_like(slot, hi - lo))
        buf = _scatter_tokens(x2d, slot, keep, len(held), cap, m.top_k)
        out_buf = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], buf,
                              cfg.mlp_type)
        out = _gather_outputs(out_buf, slot, keep, top_g, T, m.top_k) \
            .reshape(B, L, d)
    if m.shared_expert and (share is None or share[0] == 0):
        out = out + mlp_fwd(p["shared"], x, "swiglu")
    return out, aux
