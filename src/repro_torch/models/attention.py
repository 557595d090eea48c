"""GQA attention: blocked (flash-style) causal / full attention + KV caches.

Port of ``src/repro/models/attention.py`` for one card.  The reference's
sharding modes (``head`` / ``seq``) and the KV-head replication of
``repeat_kv`` have no single-card counterpart: on one device
``ShardingCtx.kv_repeat`` is 1, so caches hold ``n_kv_heads`` heads.

``blocked_attention`` is where the hand-written kernel runs.  The
reference's models take a pure-jnp flash attention here "for lowering
portability" and validate the Pallas kernel, which "implements the same
contraction", separately; the port runs that kernel
(``kernels/flash_attention.py``) for CUDA tensors in the case it covers:
self-attention with ``q_offset == 0``, no ``kv_len_mask``, and L == S when
causal, which is what prefill and the no-cache stack pass.  Any other case
on a CUDA tensor raises ``NotImplementedError``; CPU tensors take the
reference's chunked online softmax in plain PyTorch.  With grad enabled
the kernel call is differentiable (``FlashAttentionFunction``: the
forward's log-sum-exp saved, the backward the hand-written B7b); the CPU
form is differentiated by autograd, as the reference's by JAX.
``decode_attention`` is a plain einsum on either device, as the reference
leaves it to XLA.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import ParamDef, ParamDefs, linear, rms_norm, \
    rotary

NEG_INF = -1e30


def attn_defs(cfg: ArchConfig, cross: bool = False) -> ParamDefs:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    defs: ParamDefs = {
        "wq": ParamDef((d, hq * hd)),
        "wk": ParamDef((d, hkv * hd)),
        "wv": ParamDef((d, hkv * hd)),
        "wo": ParamDef((hq * hd, d)),
    }
    if cfg.use_bias:
        defs["bq"] = ParamDef((hq * hd,), "zeros")
        defs["bk"] = ParamDef((hkv * hd,), "zeros")
        defs["bv"] = ParamDef((hkv * hd,), "zeros")
        defs["bo"] = ParamDef((d,), "zeros")
    if cfg.qk_norm and not cross:
        defs["q_norm"] = ParamDef((hd,), "ones")
        defs["k_norm"] = ParamDef((hd,), "ones")
    return defs


def _chunk(n: int, target: int) -> int:
    c = min(n, target)
    while n % c:
        c -= 1
    return max(c, 1)


def _project_qkv(p, x, cfg: ArchConfig, positions):
    """Self-attention q, k, v (the reference's with ``kv_x = x`` and
    RoPE on)."""
    B, L = x.shape[0], x.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, L, hq, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(B, L, hkv, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, L, hkv, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def _kernel_attention(q, k, v, *, causal: bool, q_offset, kv_len_mask):
    """The CUDA kernel in the (B, L, H, hd) layout, or a raise."""
    B, L, H, hd = q.shape
    S, HK = k.shape[1], k.shape[2]
    if q_offset != 0 or kv_len_mask is not None or (causal and L != S):
        raise NotImplementedError(
            "blocked_attention on CUDA covers self-attention with "
            "q_offset == 0, no kv_len_mask and L == S when causal (what "
            f"prefill passes); got q_offset={q_offset}, kv_len_mask "
            f"{'set' if kv_len_mask is not None else 'None'}, L={L}, S={S}")
    G = H // HK
    qg = q.reshape(B, L, HK, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B * HK, L, G, hd)
    kg = k.permute(0, 2, 1, 3).reshape(B * HK, S, hd)
    vg = v.permute(0, 2, 1, 3).reshape(B * HK, S, hd)
    out = flash_attention(qg.contiguous(), kg.contiguous(), vg.contiguous(),
                          causal=causal)
    return out.reshape(B, HK, L, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, L, H, hd).to(v.dtype)


def blocked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 2048,
                      kv_len_mask: Optional[torch.Tensor] = None):
    """Flash-style attention.  q: (B, L, H, hd); k/v: (B, S, Hkv, hd).

    Heads are grouped (H = Hkv * G).  Returns (B, L, H, hd).
    ``kv_len_mask`` (B, S) masks padded cache slots.  CUDA tensors launch
    the flash kernel (the covered case) or raise; CPU tensors take the
    reference's chunked online softmax (``q_chunk`` x ``kv_chunk`` blocks,
    float32 logits and sums, p rounded to v's dtype).
    """
    if q.device.type == "cuda":
        return _kernel_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len_mask=kv_len_mask)
    if q.device.type != "cpu":
        raise ValueError(f"blocked_attention: unsupported device {q.device}")
    B, L, H, hd = q.shape
    S, HK = k.shape[1], k.shape[2]
    G = H // HK
    scale = hd ** -0.5
    qc = _chunk(L, q_chunk)
    kc = _chunk(S, kv_chunk)
    nq, nk = L // qc, S // kc

    qs = (q.float() * scale).to(q.dtype).float().reshape(B, L, HK, G, hd)
    kf, vf = k.float(), v.float()
    q_pos = q_offset + torch.arange(L)
    k_pos = torch.arange(S)
    outs = []
    for i in range(nq):
        qb = qs[:, i * qc:(i + 1) * qc]
        qp = q_pos[i * qc:(i + 1) * qc]
        m = torch.full((B, HK, G, qc), NEG_INF)
        l = torch.zeros((B, HK, G, qc))
        o = torch.zeros((B, HK, G, qc, hd))
        for j in range(nk):
            ks = slice(j * kc, (j + 1) * kc)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf[:, ks])
            mask = torch.ones((qc, kc), dtype=torch.bool)
            if causal:
                mask = qp[:, None] >= k_pos[ks][None, :]
            if kv_len_mask is not None:
                full = mask & kv_len_mask[:, ks][:, None, None, None, :]
            else:
                full = mask[None, None, None]
            logits = torch.where(full, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vf[:, ks])
            m = m_new
        outs.append(o / l.clamp_min(1e-30)[..., None])   # (B, HK, G, qc, hd)
    out = torch.cat(outs, dim=3)                           # (B, HK, G, L, hd)
    return out.reshape(B, H, L, hd).transpose(1, 2).to(v.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token attention over a (possibly padded) cache.

    q: (B, 1, H, hd); caches: (B, S, HK, hd); cache_len: int or (B,) valid
    prefix length (the new token's K/V must already be written).  Logits,
    softmax and the p.v sum in float32, p rounded to the cache dtype, as
    the reference.
    """
    B, _, H, hd = q.shape
    S, HK = k_cache.shape[1], k_cache.shape[2]
    G = H // HK
    qf = (q.float().reshape(B, HK, G, hd) * hd ** -0.5).to(k_cache.dtype)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf.float(), k_cache.float())
    pos = torch.arange(S, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        lens = cache_len.to(q.device).reshape(-1, 1)
    else:   # a fill on the device: no host-to-device copy
        lens = torch.full((1, 1), int(cache_len), device=q.device)
    valid = pos[None, :] < lens
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p.float(), v_cache.float())
    return out.reshape(B, 1, H, hd).to(v_cache.dtype)


def attention_fwd(p, x, cfg: ArchConfig, *, positions, causal: bool = True,
                  kv_x=None, cache: Optional[dict] = None,
                  cache_index=None):
    """Self-attention sub-layer (projection + core + output proj).

    With ``cache`` set, the new K/V are written into it at
    ``cache_index`` IN PLACE (the reference returns an updated copy; the
    port saves the second buffer) and the same dict is returned: L > 1 is
    a prefill (causal attention over the freshly projected prefix), L == 1
    a decode step over the cache.  Returns (out, cache_or_None).  A
    ``kv_x`` other than ``x`` (cross attention) raises until the
    encoder-decoder port.
    """
    B, L, _ = x.shape
    if kv_x is not None and kv_x is not x:
        raise NotImplementedError(
            "cross attention (encoder-decoder) is not ported yet "
            "(ROADMAP A14: enc-dec)")
    q, k, v = _project_qkv(p, x, cfg, positions)

    new_cache = None
    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        idx = int(cache_index)
        if not 0 <= idx <= kc.shape[1] - L:
            raise IndexError(f"cache write [{idx}, {idx + L}) outside the "
                             f"{kc.shape[1]} cache slots")
        kc[:, idx:idx + L] = k.to(kc.dtype)
        vc[:, idx:idx + L] = v.to(vc.dtype)
        new_cache = cache
        if L > 1:
            out = blocked_attention(q, k, v, causal=True, q_offset=idx)
        else:
            out = decode_attention(q, kc, vc, idx + 1)
    else:
        out = blocked_attention(q, k, v, causal=causal)

    out = out.reshape(B, L, cfg.n_heads * cfg.head_dim)
    out = linear(out, p["wo"], p.get("bo"))
    return out, new_cache


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                      n_attn_layers: int, dtype):
    """Abstract KV cache for one stack of attention layers (stacked dim
    0); ``n_kv_heads`` heads on one card."""
    shape = (n_attn_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}
