"""Mamba (S6) block for the Jamba hybrid: the chunked selective scan.

Port of ``src/repro/models/mamba.py`` for one card.  The selective
recurrence ``h_t = dA_t * h_{t-1} + dBx_t`` is a gated linear recurrence:
within a chunk of ``C`` tokens it runs as an associative scan under the
combine ``(a1, b1), (a2, b2) -> (a2 * a1, a2 * b1 + b2)``, across chunks a
loop carries the ``(B, d_inner, d_state)`` state.  The scan is
:func:`associative_scan`, which follows ``lax.associative_scan``'s own
recursion (combine adjacent pairs, scan the half, fill in the even
elements, interleave), so every element is combined in the reference's
order; it touches the chunk's bytes about twice, where a doubling scan
would touch them ``log2(C)`` times.

The chunk is the reference's: ``C = 128``, less one until it divides
``L`` (a prime length runs with ``C = 1``).  The scan runs in
``cfg.mamba_scan_dtype`` (float32 by default; every elementwise op
rounds to it, as the reference's do).  ``softplus`` is ``log(1 + e^x)``
with no threshold (``F.softplus`` returns ``x`` above 20), written as
``jax.nn.softplus``'s ``logaddexp(x, 0)`` is, ``max(x, 0) + log1p(exp(-|x|))``,
and ``silu`` as ``x * (1 / (1 + exp(-x)))``, the reference's ``x *
logistic(x)`` as XLA expands it, so a bfloat16 scan rounds where the
reference's does (PyTorch's fused forms round once).

Decode carries ``(conv window, ssm state)`` per layer: with ``state`` and
``L == 1`` one recurrence step runs; a prefill with ``state`` starts its
convolution from ``state["conv"]`` and its scan from ``state["ssm"]``.
:func:`mamba_fwd` returns the new state beside its output, as the
reference does; the LM writes it into its cache in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import const
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import ParamDef, ParamDefs


def dt_rank(cfg: ArchConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_defs(cfg: ArchConfig) -> ParamDefs:
    d = cfg.d_model
    di = cfg.d_inner_mamba
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    r = dt_rank(cfg)
    return {
        "in_proj": ParamDef((d, 2 * di)),
        "conv_w": ParamDef((di, dc), "normal", scale=0.5),
        "conv_b": ParamDef((di,), "zeros"),
        "x_proj": ParamDef((di, r + 2 * ds)),
        "dt_proj": ParamDef((r, di)),
        "dt_bias": ParamDef((di,), "zeros"),
        "A_log": ParamDef((di, ds), "ones"),
        "D": ParamDef((di,), "ones"),
        "out_proj": ParamDef((di, d)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + e^x)`` for every ``x``, each op
    rounded to ``x``'s dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * logistic(x)``, the logistic as ``1 / (1 +
    exp(-x))``, each op rounded to ``x``'s dtype."""
    one = const(1.0, x.dtype, x.device)
    return x * (one / (one + torch.exp(-x)))


def _causal_conv(x, w, b, window_init=None):
    """Depthwise causal conv over L via shifted adds.  x: (B, L, di).
    Returns ``(out, new_window)``, the window the last ``dc - 1`` rows of
    the padded input."""
    B, L, di = x.shape
    dc = w.shape[1]
    if window_init is None:
        pad = x.new_zeros((B, dc - 1, di))
    else:
        pad = window_init
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for j in range(dc):
        out = out + xp[:, j:j + L] * w[:, j].to(x.dtype)
    new_window = xp[:, L:L + dc - 1] if dc > 1 else pad[:, :0]
    return out + b.to(x.dtype), new_window


def _combine(a1, b1, a2, b2):
    return a2 * a1, a2 * b1 + b2


def _sl(t, dim: int, start, stop=None, step=1):
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def _assemble(first, even, odd, dim: int):
    """The scan from its first element, its even elements 2, 4, ... and
    its odd elements 1, 3, ... along ``dim`` (the reference's concatenate
    and interleave, as three copies into one buffer)."""
    shape = list(first.shape)
    shape[dim] = 1 + even.shape[dim] + odd.shape[dim]
    out = first.new_empty(shape)
    _sl(out, dim, 0, 1).copy_(first)
    _sl(out, dim, 2, None, 2).copy_(even)
    _sl(out, dim, 1, None, 2).copy_(odd)
    return out


def associative_scan(a, b, dim: int = 1):
    """Inclusive scan of ``(a, b)`` along ``dim`` under :func:`_combine`,
    in ``lax.associative_scan``'s recursion order."""
    n = a.shape[dim]
    if n < 2:
        return a, b
    ra, rb = _combine(_sl(a, dim, 0, n - 1, 2), _sl(b, dim, 0, n - 1, 2),
                      _sl(a, dim, 1, None, 2), _sl(b, dim, 1, None, 2))
    oa, ob = associative_scan(ra, rb, dim)
    m = oa.shape[dim]
    a2, b2 = _sl(a, dim, 2, None, 2), _sl(b, dim, 2, None, 2)
    if n % 2 == 0:
        ea, eb = _combine(_sl(oa, dim, 0, m - 1), _sl(ob, dim, 0, m - 1),
                          a2, b2)
    else:
        ea, eb = _combine(oa, ob, a2, b2)
    return (_assemble(_sl(a, dim, 0, 1), ea, oa, dim),
            _assemble(_sl(b, dim, 0, 1), eb, ob, dim))


def _ssm_chunk(carry_h, chunk, A):
    """One chunk of the selective scan.  chunk: (dt, Bc, Cc, xin), each
    (B, C, ...).  Returns (the state after the chunk, y (B, C, di))."""
    dt, Bc, Cc, xin = chunk
    dA = torch.exp(dt[..., None] * A)                     # (B,C,di,ds)
    dBx = dt[..., None] * Bc[:, :, None, :] * xin[..., None]
    a_cum, b_cum = associative_scan(dA, dBx, dim=1)
    h_all = b_cum + a_cum * carry_h[:, None]              # (B,C,di,ds)
    y = torch.einsum("bcds,bcs->bcd", h_all, Cc)
    return h_all[:, -1], y


def _scan(dt, Bc, Cc, xin, A, h, C: int, ends=None):
    """The chunks of the selective scan from state ``h``: ``(y (B, L, di),
    final state)``; with ``ends`` (a list) each chunk's final state is
    appended to it."""
    ys = []
    for s in range(0, dt.shape[1], C):
        h, y = _ssm_chunk(h, tuple(a[:, s:s + C]
                                   for a in (dt, Bc, Cc, xin)), A)
        ys.append(y)
        if ends is not None:
            ends.append(h)
    return (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]), h


class SelectiveScan(torch.autograd.Function):
    """The chunked selective scan with a chunk-recompute backward.

    The forward runs :func:`_ssm_chunk` over the chunks as the no-grad
    path does and saves dt, B, C, xin, A and the ``n + 1`` chunk-boundary
    states ``(B, d_inner, d_state)``.  The backward walks the chunks from
    last to first: it runs the chunk again from its boundary state under
    ``torch.enable_grad()`` and takes ``torch.autograd.grad`` of ``(y,
    h_end)`` against ``(dy, dh_end)``, carrying ``dh`` to the chunk before.
    Only one chunk's graph is alive at a time.  Inputs: dt, xin ``(B, L,
    di)``, Bc, Cc ``(B, L, ds)``, A ``(di, ds)``, h0 ``(B, di, ds)``;
    returns ``(y (B, L, di), h_final)``."""

    @staticmethod
    def forward(ctx, dt, Bc, Cc, xin, A, h0, C):
        hs = [h0]
        y, h = _scan(dt, Bc, Cc, xin, A, h0, C, hs)
        ctx.C = C
        ctx.save_for_backward(dt, Bc, Cc, xin, A, torch.stack(hs))
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, Bc, Cc, xin, A, hs = ctx.saved_tensors
        C = ctx.C
        L = dt.shape[1]
        if dh is None:
            dh = torch.zeros_like(hs[0])
        if dy is None:
            dy = torch.zeros_like(xin)
        grads = [torch.empty_like(a) for a in (dt, Bc, Cc, xin)]
        dA = torch.zeros_like(A)
        for n in reversed(range(L // C)):
            s = n * C
            ins = [a[:, s:s + C].detach().requires_grad_()
                   for a in (dt, Bc, Cc, xin)]
            Ad = A.detach().requires_grad_()
            h = hs[n].detach().requires_grad_()
            with torch.enable_grad():
                h_end, y = _ssm_chunk(h, tuple(ins), Ad)
                got = torch.autograd.grad((y, h_end), (*ins, Ad, h),
                                          (dy[:, s:s + C], dh))
            for g, part in zip(grads, got[:4]):
                g[:, s:s + C] = part
            dA += got[4]
            dh = got[5]
        return (*grads, dA, dh, None)


def mamba_fwd(p, x, cfg: ArchConfig, *, chunk: int = 128,
              state: Optional[dict] = None):
    """x: (B, L, d).  With ``state`` and ``L == 1``, one decode step.

    Returns (out, new_state or None): ``{"conv": (B, dc-1, di) in x's
    dtype, "ssm": (B, di, ds) float32}`` when ``state`` is given."""
    B, L, d = x.shape
    di = cfg.d_inner_mamba
    ds = cfg.mamba_d_state
    r = dt_rank(cfg)
    cdt = getattr(torch, cfg.mamba_scan_dtype)

    xz = (x @ p["in_proj"]).to(cdt)
    xin, z = xz[..., :di], xz[..., di:]
    win0 = None if state is None else state["conv"].to(cdt)
    xin, new_win = _causal_conv(xin, p["conv_w"].to(cdt), p["conv_b"], win0)
    xin = silu(xin)

    proj = xin @ p["x_proj"].to(cdt)
    dt = softplus(proj[..., :r] @ p["dt_proj"].to(cdt)
                  + p["dt_bias"].to(cdt))
    Bc = proj[..., r:r + ds]
    Cc = proj[..., r + ds:]
    A = -torch.exp(p["A_log"].to(cdt))                    # (di, ds)

    if state is not None and L == 1:
        # single-token decode: one recurrence step
        h = state["ssm"].to(cdt)                          # (B, di, ds)
        dA = torch.exp(dt[:, 0, :, None] * A)
        h = dA * h + dt[:, 0, :, None] * Bc[:, 0, None, :] \
            * xin[:, 0, :, None]
        y = torch.einsum("bds,bs->bd", h, Cc[:, 0])[:, None]
        new_state = {"conv": new_win.to(x.dtype), "ssm": h.float()}
    else:
        C = chunk
        while L % C:
            C -= 1
        h = x.new_zeros((B, di, ds), dtype=cdt) if state is None \
            else state["ssm"].to(cdt)
        if torch.is_grad_enabled() and any(
                a.requires_grad for a in (dt, Bc, Cc, xin, A, h)):
            y, h = SelectiveScan.apply(dt, Bc, Cc, xin, A, h, C)
        else:
            y, h = _scan(dt, Bc, Cc, xin, A, h, C)
        new_state = None if state is None else {
            "conv": new_win.to(x.dtype), "ssm": h.float()}

    y = y + xin * p["D"].to(cdt)
    y = y * silu(z)
    out = y.to(x.dtype) @ p["out_proj"]
    return out, new_state


def mamba_state_shapes(cfg: ArchConfig, batch: int, n_layers: int, dtype):
    di, ds, dc = cfg.d_inner_mamba, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "conv": TensorSpec((n_layers, batch, dc - 1, di), dtype),
        "ssm": TensorSpec((n_layers, batch, di, ds), torch.float32),
    }
