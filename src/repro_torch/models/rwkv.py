"""RWKV6 "Finch" block: data-dependent decay linear attention + channel mix.

Port of ``src/repro/models/rwkv.py`` for one card.  The WKV recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

stays the reference's sequential recurrence (the chunked matrix forms need
``exp(-cum log w)`` factors that overflow for fast decays).  Only the state
update is sequential, so only it runs in the loop over tokens: one
``addcmul`` a token, ``S_t = kv_t + w_t * S_{t-1}``, written into a buffer
of the block's states.  What needs no recurrence runs batched over a block
of :data:`WKV_BLOCK` tokens with the reference's products: the outer
products ``k_t^T v_t``, ``r_t . S_{t-1}`` over the stored states and the
bonus ``(r_t * u) . k_t^T v_t``.  The five (two) token-shift mixes run as
one subtraction, one multiply and one add over all of them, each rounded
where the reference rounds it.  A prefill's speed is then set by one launch a
token and layer.

The reference's simplifications stay: the token-shift interpolations use
static learned ``mu``; only the decay LoRA (``w0 + tanh(x A) B``) is data
dependent.  The decode state per layer is the last normed input of each
sub-layer (``shift_tm`` of the time mix's input, ``shift_cm`` of the
channel mix's) and the float32 WKV state; the functions return it beside
their output and the LM writes it into its cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import ParamDef, ParamDefs, rms_norm

WKV_BLOCK = 256        # tokens whose outer products and states are held


def rwkv_defs(cfg: ArchConfig) -> ParamDefs:
    d = cfg.d_model
    H = cfg.rwkv_heads
    hd = cfg.rwkv_head_dim
    lora = cfg.rwkv_decay_lora
    ff = cfg.d_ff
    return {
        "tm": {  # time mix
            "mu": ParamDef((5, d), "small_normal"),       # r,k,v,w,g shifts
            "Wr": ParamDef((d, d)),
            "Wk": ParamDef((d, d)),
            "Wv": ParamDef((d, d)),
            "Wg": ParamDef((d, d)),
            "Wo": ParamDef((d, d)),
            "w0": ParamDef((d,), "zeros"),
            "wA": ParamDef((d, lora), "small_normal"),
            "wB": ParamDef((lora, d), "small_normal"),
            "u": ParamDef((H, hd), "small_normal"),
            "ln_x": ParamDef((d,), "ones"),
        },
        "cm": {  # channel mix
            "mu": ParamDef((2, d), "small_normal"),       # k, r shifts
            "Wk": ParamDef((d, ff)),
            "Wv": ParamDef((ff, d)),
            "Wr": ParamDef((d, d)),
        },
    }


def _token_shift(x, last):
    """Shift right by one token; ``last`` (B, 1, d) is the decode carry."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    """The reference's ``_mix(x, xx, mu[i])`` for every row ``i`` of
    ``mu`` (n, d), stacked on dim 0: the same roundings, in three
    launches for all n."""
    return x + (xx - x) * mu.to(x.dtype)[:, None, None, :]


def _wkv_blocks(r, k, v, w, u, S, block, starts=None):
    """The forward loop over ``(L, B, H, hd)`` inputs from state ``S``:
    ``(out (L, B, H, hd), final state)``; with ``starts`` (a list) each
    block's first state is appended to it."""
    L = r.shape[0]
    ru = r * u
    outs = []
    for s in range(0, L, block):
        T = min(block, L - s)
        if starts is not None:
            starts.append(S)
        kv = k[s:s + T, ..., :, None] * v[s:s + T, ..., None, :]
        states = S.new_empty((T + 1,) + S.shape)
        states[0] = S
        wt = w[s:s + T, ..., None].contiguous()
        for t in range(T):
            torch.addcmul(kv[t], wt[t], states[t], out=states[t + 1])
        out = torch.einsum("tbhk,tbhkv->tbhv", r[s:s + T], states[:T]) + \
            torch.einsum("tbhk,tbhkv->tbhv", ru[s:s + T], kv)
        outs.append(out)
        S = states[T]
    return (torch.cat(outs) if len(outs) > 1 else outs[0]), S


class WKVFunction(torch.autograd.Function):
    """The WKV recurrence with a backward that keeps one block of states.

    The forward is :func:`_wkv_blocks`' loop and saves r, k, v, w, u and
    the state at each block boundary, never one state a token.  The
    backward walks the blocks from last to first: it recomputes the
    block's states ``S_{t-1}`` from its boundary state (the forward's
    ``addcmul``, so the same bits), then runs the reverse recurrence of
    ``G_t = dL/dS_t``, per head with key index i and value index j,

        G_{t-1} = w_t (.)_i G_t + r_t (x) g_t,     g_t = dL/do_t,

    one ``addcmul`` a token into a block buffer that first held the
    outer products ``r_t (x) g_t``, and takes batched over the block

        dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
        dk_t    = G_t . v_t + (r_t u) (v_t . g_t)
        dv_t    = G_t^T . k_t + ((r_t u) . k_t) g_t
        dr_t[i] = sum_j S_{t-1}[i,j] g_t[j] + u[i] k_t[i] (v_t . g_t)
        du[i]   = sum_t r_t[i] k_t[i] (v_t . g_t).

    The block's outer products ``k_t (x) v_t`` live in the same buffer
    while the states are recomputed, so a backward holds two block
    buffers, ``(block + 1, B, H, hd, hd)`` float32 each.  Inputs are
    ``(L, B, H, hd)`` (token-major), ``u`` ``(H, hd)``, ``S0`` ``(B, H,
    hd, hd)``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0, block):
        starts = []
        out, S = _wkv_blocks(r, k, v, w, u, S0, block, starts)
        ctx.block = block
        ctx.save_for_backward(r, k, v, w, u, torch.stack(starts))
        return out, S

    @staticmethod
    def backward(ctx, g_out, g_S):
        r, k, v, w, u, starts = ctx.saved_tensors
        L = r.shape[0]
        block = ctx.block
        G = torch.zeros_like(starts[0]) if g_S is None else g_S
        if g_out is None:
            g_out = torch.zeros_like(r)
        dr, dk, dv, dw = (torch.empty_like(a) for a in (r, k, v, w))
        du = torch.zeros_like(u)
        ru = r * u
        for n in reversed(range(starts.shape[0])):
            s = n * block
            T = min(block, L - s)
            rs, ks, vs, ws, rus, gs = (a[s:s + T] for a in
                                       (r, k, v, w, ru, g_out))
            wt = ws[..., None].contiguous()
            states = starts.new_empty((T + 1,) + starts.shape[1:])
            buf = starts.new_empty((T + 1,) + starts.shape[1:])
            states[0] = starts[n]
            torch.mul(ks[..., :, None], vs[..., None, :], out=buf[:T])
            for t in range(T):
                torch.addcmul(buf[t], wt[t], states[t], out=states[t + 1])
            torch.mul(rs[..., :, None], gs[..., None, :], out=buf[:T])
            buf[T] = G
            for t in reversed(range(T)):
                buf[t].addcmul_(wt[t], buf[t + 1])
            Gt, Sp = buf[1:], states[:T]
            vg = (vs * gs).sum(-1, keepdim=True)           # (T,B,H,1)
            rk = (rus * ks).sum(-1, keepdim=True)
            dw[s:s + T] = torch.einsum("tbhij,tbhij->tbhi", Gt, Sp)
            dk[s:s + T] = torch.einsum("tbhij,tbhj->tbhi", Gt, vs) + rus * vg
            dv[s:s + T] = torch.einsum("tbhij,tbhi->tbhj", Gt, ks) + rk * gs
            dr[s:s + T] = torch.einsum("tbhij,tbhj->tbhi", Sp, gs) + \
                u * ks * vg
            du += (rs * ks * vg).sum((0, 1))
            G = buf[0].clone() if n else buf[0]
            del states, buf
        return dr, dk, dv, dw, du, G, None


def _wkv_scan(r, k, v, w, u, state, block: int = WKV_BLOCK):
    """Sequential WKV recurrence.  r/k/v/w: (B, L, H, hd) f32, u (H, hd),
    state (B, H, hd, hd).  Returns (out (B, L, H, hd), final state).
    With grad enabled and an input that requires it, through
    :class:`WKVFunction` (the same forward bits)."""
    seq = tuple(a.transpose(0, 1) for a in (r, k, v, w))  # (L,B,H,hd)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (r, k, v, w, u, state)):
        out, S = WKVFunction.apply(*seq, u, state, block)
    else:
        out, S = _wkv_blocks(*seq, u, state, block)
    return out.transpose(0, 1), S


def rwkv_time_mix(p, x, cfg: ArchConfig, state: Optional[dict] = None):
    """Time mix of the normed input ``x`` (B, L, d).  Returns (out,
    ``{"shift_tm": x[:, -1:], "wkv": S}`` or None)."""
    B, L, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    last = None if state is None else state["shift_tm"]
    xx = _token_shift(x, last)
    xr, xk, xv, xw, xg = _mix(x, xx, p["mu"])

    f32 = torch.float32
    r = (xr @ p["Wr"]).to(f32).reshape(B, L, H, hd)
    k = (xk @ p["Wk"]).to(f32).reshape(B, L, H, hd)
    v = (xv @ p["Wv"]).to(f32).reshape(B, L, H, hd)
    g = F.silu((xg @ p["Wg"]).to(f32))
    # data-dependent decay (the Finch feature)
    ww = p["w0"].to(f32) + \
        torch.tanh(xw.to(f32) @ p["wA"].to(f32)) @ p["wB"].to(f32)
    w = torch.exp(-torch.exp(ww)).reshape(B, L, H, hd)

    S0 = x.new_zeros((B, H, hd, hd), dtype=f32) if state is None \
        else state["wkv"].to(f32)
    out, S = _wkv_scan(r, k, v, w, p["u"].to(f32), S0)
    out = out.reshape(B, L, d)
    out = rms_norm(out, p["ln_x"], cfg.norm_eps)          # per-channel norm
    out = (out * g).to(x.dtype) @ p["Wo"]
    new_state = None
    if state is not None:
        new_state = {"shift_tm": x[:, -1:], "wkv": S}
    return out, new_state


def rwkv_channel_mix(p, x, state: Optional[dict] = None):
    """Channel mix of the normed input ``x``.  Returns (out,
    ``{"shift_cm": x[:, -1:]}`` or None)."""
    last = None if state is None else state["shift_cm"]
    xx = _token_shift(x, last)
    xk, xr = _mix(x, xx, p["mu"])
    k = torch.square(torch.relu(xk @ p["Wk"]))
    kv = k @ p["Wv"]
    out = torch.sigmoid(xr @ p["Wr"]) * kv
    new_state = None if state is None else {"shift_cm": x[:, -1:]}
    return out, new_state


def rwkv_state_shapes(cfg: ArchConfig, batch: int, n_layers: int, dtype):
    H, hd, d = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    return {
        "shift_tm": TensorSpec((n_layers, batch, 1, d), dtype),
        "shift_cm": TensorSpec((n_layers, batch, 1, d), dtype),
        "wkv": TensorSpec((n_layers, batch, H, hd, hd), torch.float32),
    }
