"""Shared layer primitives and the ParamDef system (PyTorch).

Port of ``src/repro/models/layers.py``.  Each module declares its
parameters once as ``ParamDef``s (shape, initializer); the declaration
drives initialization, so the port draws every leaf with the reference's
rule: ``normal`` leaves get their declared ``scale``, else ``1 /
sqrt(shape[0])`` (for a stacked unit weight ``(n_units, ...)`` that is
``1 / sqrt(n_units)``, as the reference computes it), ``small_normal``
0.02, ``zeros`` and ``ones`` their value.
``jax.random`` keys become one ``torch.Generator`` drawn leaf by leaf in
the declaration order; the numbers differ from JAX's, the scales do not.

The numerics keep the reference's rounding points: normalisation and RoPE
in float32, cast back to the input dtype; divisions by a constant divide
by a 0-dim tensor, because PyTorch on CUDA multiplies by the reciprocal of
a Python-float divisor.  ``cross_entropy`` is the training loss;
``param_specs`` and ``abstract_params`` come with the dry-run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter's declaration (the reference's, less its tensor-
    parallel dim, which has no single-card counterpart)."""
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | small_normal
    scale: Optional[float] = None


ParamDefs = Dict[str, "ParamDefs | ParamDef"]  # nested


def _init_one(gen: torch.Generator, d: ParamDef, dtype) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=gen.device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=gen.device)
    scale = d.scale
    if scale is None:
        fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    if d.init == "small_normal":
        scale = 0.02
    return scale * torch.randn(d.shape, generator=gen, dtype=dtype,
                               device=gen.device)


def stack_defs(defs: ParamDefs, n: int) -> ParamDefs:
    """Prepend the scan-stack dim to every def (layer-stacked params)."""
    return _unflatten({path: ParamDef((n,) + tuple(d.shape), d.init, d.scale)
                       for path, d in _flatten(defs).items()})


def _flatten(defs, prefix=()):
    flat = {}
    for k, v in defs.items():
        if isinstance(v, ParamDef):
            flat[prefix + (k,)] = v
        else:
            flat.update(_flatten(v, prefix + (k,)))
    return flat


def _unflatten(flat):
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------

def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor on ``like``'s device (a tensor
    divisor divides; a Python-float one multiplies by its reciprocal)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def rms_norm(x, scale, eps: float):
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / _const(xf.shape[-1], xf)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def layer_norm(x, scale, bias, eps: float):
    dt = x.dtype
    xf = x.float()
    n = _const(xf.shape[-1], xf)
    mu = xf.sum(-1, keepdim=True) / n
    c = xf - mu
    var = (c * c).sum(-1, keepdim=True) / n
    out = c * torch.rsqrt(var + eps)
    out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dt)


def linear(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def rotary(x, positions, theta: float):
    """RoPE on the last dim of (..., L, H, hd) given positions (..., L)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freq / _const(half, freq))
    ang = positions.float()[..., None] * inv                # (..., L, half)
    sin = torch.sin(ang)[..., None, :]                      # (..., L, 1, half)
    cos = torch.cos(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def cast_floats(tree, dtype):
    """Cast float leaves of a nested dict to the compute dtype (a leaf
    already in ``dtype`` is returned as it is, not copied)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    return {k: cast_floats(v, dtype) for k, v in tree.items()}


def norm_defs(d_model: int, use_bias: bool) -> ParamDefs:
    d: ParamDefs = {"scale": ParamDef((d_model,), "ones")}
    if use_bias:
        d["bias"] = ParamDef((d_model,), "zeros")
    return d


def norm_fwd(p, x, eps: float):
    """RMSNorm, or LayerNorm when the arch uses biases (whisper/starcoder2)."""
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


# ---- MLP -------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, mlp_type: str,
             use_bias: bool) -> ParamDefs:
    defs: ParamDefs = {}
    if mlp_type == "swiglu":
        defs["w_gate"] = ParamDef((d_model, d_ff))
        defs["w_up"] = ParamDef((d_model, d_ff))
    else:
        defs["w_up"] = ParamDef((d_model, d_ff))
        if use_bias:
            defs["b_up"] = ParamDef((d_ff,), "zeros")
    defs["w_down"] = ParamDef((d_ff, d_model))
    if use_bias:
        defs["b_down"] = ParamDef((d_model,), "zeros")
    return defs


def mlp_fwd(p, x, mlp_type: str):
    if mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(x, p["w_up"], p.get("b_up")), approximate="tanh")
    return linear(h, p["w_down"], p.get("b_down"))


# ---- losses -----------------------------------------------------------------

def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """Token-mean CE with z-loss, in f32; labels < 0 are ignored (the
    reference's ``cross_entropy``; the divisor is a 0-dim f32 tensor)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    # one label a row: the backward's adds never meet
    ll = torch.gather(  # noqa: RT006
        lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask
    w = valid.float()
    return (nll * w).sum() / torch.maximum(w.sum(), _const(1.0, w))
