"""AdamW with global-norm clipping and the cosine schedule, on one card.

Port of ``src/repro/optim/adamw.py``.  Parameters, gradients and the
moments are dicts of tensors under the same keys (the port keeps the
LM's parameters by their ``named_parameters()`` names); the state is
``{"step": int32 0-dim, "m": {...} f32, "v": {...} f32}``, which
``convert.adamw_state_to_jax`` turns into the reference's stacked tree.

The arithmetic is the reference's, operation by operation: the clip
``min(1, clip_norm / (gnorm + 1e-9))``, the bias corrections
``1 - b ** step``, the decoupled weight decay and the cast back to the
parameter dtype.  ``lr``, ``b ** step`` and every divisor are float32
0-dim tensors on the parameters' device (a Python-float divisor would
multiply by its reciprocal), and nothing reads a value back to the host,
so :func:`update` never waits for the device.  Unlike the reference's
pure function, :func:`update` writes the parameters and the moments in
place (at qwen3-1.7b that saves three 8 GB copies) and returns them.
The update is elementwise; the reference has no Pallas kernel for it.
``zero1_specs`` (ZeRO sharding) waits for the multi-GPU work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.device import const


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return const(float(value), torch.float32, like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``; ``step`` an
    integer tensor, the result a float32 tensor of its shape."""
    s = step.to(torch.float32)
    warm = s / _f32(max(cfg.warmup_steps, 1), s)
    prog = torch.clamp((s - cfg.warmup_steps) /
                       _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * \
        torch.where(s < cfg.warmup_steps, 1.0, cos)


def init_state(params: Dict[str, torch.Tensor]) -> dict:
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                  for k, p in params.items()}}


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in order, of each leaf's sum of
    squares in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


@torch.no_grad()
def update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
           grads: Dict[str, torch.Tensor], state: dict):
    """One AdamW step, in place; returns ``(params, state, metrics)`` with
    metrics ``{"grad_norm", "lr"}`` (0-dim tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads[k] for k in params)
    scale = torch.minimum(_f32(1.0, gnorm),
                          _f32(cfg.clip_norm, gnorm) / (gnorm + 1e-9))
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.mul_(b1).add_(g * (1 - b1))              # b1 * m + (1 - b1) * g
        t = g * (1 - b2)
        v.mul_(b2).add_(t.mul_(g))                 # b2 * v + (1 - b2) * g * g
        den = v / bc2
        u = (m / bc1).div_(den.sqrt_().add_(cfg.eps))
        u.add_(p.float() * cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(u)
        else:
            p.copy_(p.float() - u)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
