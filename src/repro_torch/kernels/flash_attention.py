"""Flash attention for Hopper plus its plain form.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:76``
(``flash_attention``, kernel ``_flash_kernel`` l.25), CUDA source
``csrc/flash_attention.cu``, whose header says what bounds it on an H100
and what the design does about it: bfloat16 on the tensor cores (wgmma,
TMA-fed k / v ring), float32 on the CUDA cores (the dtype picks the entry
point).

The layout is the reference's: q (BH, L, G, hd) grouped queries, k and v
(BH, S, hd), BH = batch * kv heads, G = q heads per kv head; the output is
(BH, L, G, hd) in q's dtype.  Types are float32 and bfloat16, head_dim 16,
32, 64 or 128; anything else raises, on either device, as does a
non-contiguous input.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`flash_attention_plain`, the Pallas algorithm in PyTorch.  The
wrapper counts its launches in ``flash_attention.launches``, raised only
where the kernel is launched, through the shared launch path
(:mod:`repro_torch.kernels._launch`).

Training: with grad enabled and an input that requires grad, a CUDA call
goes through :class:`FlashAttentionFunction`, whose forward launches the
same kernels through their ``_lse`` entries (the same ``out`` bits, plus
each row's float32 log-sum-exp) and whose backward launches B7b,
:func:`flash_attention_backward` (counted in
``flash_attention_backward.launches``; bfloat16 on the tensor cores,
float32 on the CUDA cores, no atomics).  B7b replaces no TPU kernel: the
reference trains through autodiff of its pure-JAX ``blocked_attention``
(``src/repro/models/attention.py:89``) and its Pallas kernel has no
backward.  Its plain form, :func:`flash_attention_backward_plain`, is
autograd through :func:`flash_attention_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import (F32, I32, I64, PTR, refused, stream,
                                         unsupported)

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The bf16 kernel's blocking: KERNEL_ROWS rows of the (L*G, hd) query per
# block, kv tiles of KERNEL_BK keys (csrc/flash_attention.cu, kBlockRows
# and kBN).
KERNEL_ROWS = 128
KERNEL_BK = 128


_FLASH = _launch.Entries("flash_attention", {
    dt: (f"flash_attention_{sfx}", [PTR] * 4 + [I64] * 5 + [I32, F32, PTR])
    for dt, sfx in _SUFFIX.items()})
_FLASH_LSE = _launch.Entries("flash_attention", {
    dt: (f"flash_attention_lse_{sfx}",
         [PTR] * 5 + [I64] * 5 + [I32, F32, PTR])
    for dt, sfx in _SUFFIX.items()})
_FLASH_BWD = _launch.Entries("flash_attention", {
    dt: (f"flash_attention_bwd_{sfx}",
         [PTR] * 10 + [I64] * 5 + [I32, F32, PTR])
    for dt, sfx in _SUFFIX.items()})


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes q (BH, L, G, hd) and k, v "
                         f"(BH, S, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, L, G, hd = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be ({BH}, S, {hd})")
    if L == 0 or G == 0 or k.shape[1] == 0 or BH == 0:
        raise ValueError("flash_attention needs BH, L, G and S >= 1")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; use one of "
                         f"{HEAD_DIMS}")
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (pass .contiguous())")


def kernel_tiling(G: int) -> tuple[int, int]:
    """``(bq, bk)`` at which :func:`flash_attention_plain` follows the bf16
    kernel's blocking: ``bq = KERNEL_ROWS // G`` positions (a block's row
    tile), ``bk = KERNEL_BK`` keys.  Each row then meets the kernel's kv
    tiles in its order (tiles past a row's position are exact no-ops in
    both), so only the order of the float32 sums inside a product differs;
    where ``bk`` does not divide S the plain form lowers it, as the
    reference does."""
    return max(1, KERNEL_ROWS // G), KERNEL_BK


def _block(n: int, target: int) -> int:
    """The reference's block size: ``min(target, n)``, lowered until it
    divides ``n``."""
    b = min(target, n)
    while n % b:
        b -= 1
    return b


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, bq: int = 128,
                          bk: int = 256) -> torch.Tensor:
    """Plain form of :func:`flash_attention`: the Pallas kernel's online
    softmax over (bq, bk) blocks in its order, with its rounding points
    (q scaled in float32 and rounded to k's dtype, float32 logits and
    sums, p rounded to v's dtype, true division by max(l, 1e-30))."""
    BH, L, G, hd = q.shape
    S = k.shape[1]
    bq, bk = _block(L, bq), _block(S, bk)
    scale = hd ** -0.5
    qs = (q.float() * scale).to(k.dtype).float()
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for i in range(L // bq):
        qb = qs[:, i * bq:(i + 1) * bq]                      # (BH, bq, G, hd)
        m = torch.full((BH, bq, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((BH, bq, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((BH, bq, G, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(S // bk):
            if causal and i * bq + bq - 1 < j * bk:
                continue                     # wholly above the diagonal
            logits = torch.einsum("bqgd,bkd->bqgk", qb,
                                  kf[:, j * bk:(j + 1) * bk])
            if causal:
                qpos = i * bq + torch.arange(bq, device=q.device)
                kpos = j * bk + torch.arange(bk, device=q.device)
                mask = qpos[:, None, None] >= kpos[None, None, :]
                logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            m = m_new
            pv = torch.einsum("bqgk,bkd->bqgd", p.to(v.dtype).float(),
                              vf[:, j * bk:(j + 1) * bk])
            acc = acc * corr[..., None] + pv
        out[:, i * bq:(i + 1) * bq] = \
            (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


def _launch_checks(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *more: torch.Tensor) -> None:
    """Grid limits, and the 16-byte start every bf16 tensor the kernels
    read by TMA or in 16-byte words needs (q, k, v; the backward's out and
    dout too)."""
    BH, L, G, _ = q.shape
    S = k.shape[1]
    # a forward block takes 128 rows; the backward's f32 blocks 32 rows or
    # 32 keys (its bf16 blocks 128)
    tile = 32 if more else 128
    too_long = (S + tile - 1) // tile > 65535 if more else S > 2 ** 31 - 1
    if BH > 65535 or (L * G + tile - 1) // tile > 65535 or too_long:
        raise ValueError(f"{name}: grid too large for BH={BH}, "
                         f"L*G={L * G}, S={S}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v, *more)):
        names = "q, k, v" + ", out, dout" * bool(more)
        raise ValueError(f"{name}: bf16 {names} must start on a 16-byte "
                         "boundary (the kernels read them by TMA)")


def _forward(q, k, v, causal: bool, with_lse: bool):
    """Launch the forward kernel: ``out``, and with ``with_lse`` the
    float32 log-sum-exp ``(BH, L, G)`` of every row (else None)."""
    _launch_checks("flash_attention", q, k, v)
    BH, L, G, hd = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    dev = q.get_device()
    if with_lse:
        lse = torch.empty((BH, L, G), dtype=torch.float32, device=q.device)
        fn = _FLASH_LSE[q.dtype]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), BH, L, G, S, hd, int(bool(causal)),
                hd ** -0.5, stream(dev))
    else:
        lse = None
        fn = _FLASH[q.dtype]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
                L, G, S, hd, int(bool(causal)), hd ** -0.5, stream(dev))
    if rc:
        raise refused(fn, rc)
    flash_attention.launches += 1
    return out, lse


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` on CUDA tensors with its gradient: the
    forward saves q, k, v, out and the log-sum-exp, the backward launches
    B7b (:func:`flash_attention_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out,
                                              dout.contiguous(), lse,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 256) -> torch.Tensor:
    """Grouped-query attention, causal (positions from 0 on both sides:
    query l sees keys <= l) or full.  ``bq`` / ``bk`` set the plain
    form's blocking (the reference's defaults); the CUDA kernel picks its
    own tiles.  On CUDA, with grad enabled and an input that requires
    grad, the call is differentiable (:class:`FlashAttentionFunction`)."""
    _check(q, k, v)
    if not q.is_cuda:
        if q.is_cpu:
            return flash_attention_plain(q, k, v, causal=causal, bq=bq,
                                         bk=bk)
        raise unsupported("flash_attention", q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, bool(causal))
    return _forward(q, k, v, causal, with_lse=False)[0]


flash_attention.launches = 0


def _check_backward(q, k, v, out, dout, lse) -> None:
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be {tuple(q.shape[:3])} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dev = q.get_device()
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        if t.get_device() != dev:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (pass "
                             ".contiguous())")


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, dout: torch.Tensor, *,
                                   causal: bool = True, bq: int = 128,
                                   bk: int = 256):
    """Plain form of :func:`flash_attention_backward`: ``(dq, dk, dv)`` by
    autograd through :func:`flash_attention_plain` (which it runs again)."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_plain(qq, kk, vv, causal=causal, bq=bq, bk=bk)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True):
    """B7b: ``(dq, dk, dv)`` of ``out = flash_attention(q, k, v)`` given
    ``dout``, in q's dtype and layout.  ``out`` and ``lse`` are the
    forward's (the ``_lse`` entry's).  A CUDA tensor launches the three
    kernels of ``csrc/flash_attention.cu`` (D = rowsum(dout * out), dK /
    dV, dQ; in bf16 the first also writes q * scale into ``dq``, which the
    dQ kernel then overwrites, and the other two run on the tensor cores),
    counted once a call in ``flash_attention_backward.launches``; a CPU
    tensor takes :func:`flash_attention_backward_plain`."""
    _check_backward(q, k, v, out, dout, lse)
    if not q.is_cuda:
        if q.is_cpu:
            return flash_attention_backward_plain(q, k, v, dout,
                                                  causal=causal)
        raise unsupported("flash_attention_backward", q)
    _launch_checks("flash_attention_backward", q, k, v, out, dout)
    BH, L, G, hd = q.shape
    S = k.shape[1]
    delta = torch.empty((BH, L, G), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fn = _FLASH_BWD[q.dtype]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), BH, L, G, S, hd, int(bool(causal)),
            hd ** -0.5, stream(q.get_device()))
    if rc:
        raise refused(fn, rc)
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
