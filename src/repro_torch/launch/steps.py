"""Training step builder for one card.

Port of the training part of ``src/repro/launch/steps.py``:
``param_count``, ``active_param_count``, ``auto_microbatches``,
``TrainProgram`` and ``make_train_step``.  The counts and the step cover
every config the port declares (dense, MoE, RWKV, the Mamba hybrid);
``expert_share=(index, count)`` builds every MoE layer as one card's share
of ``count``-way expert parallelism (``models.moe``), and the counts and
abstract trees follow it.  The step is the reference's:
gradients of ``LM.loss_fn`` over ``microbatches`` slices of the batch,
summed in float32 in microbatch order and divided by the count (one
microbatch: the gradients as they come), the loss the mean of the
microbatches', ``ce`` the last microbatch's, then one AdamW update.
Metrics: ``loss``, ``ce`` (with MoE also ``moe_lb`` and ``moe_z``, the
last microbatch's), ``grad_norm``, ``lr`` (0-dim tensors on the model's
device).

PyTorch runs eagerly, so there is no jit and no sharding: the program
holds its model, whose parameters the step updates in place (the
``params`` it takes and returns are ``program.params``, the model's
parameters by name).  ``abstract_params`` / ``abstract_opt`` are the
reference's stacked trees as ``meta`` tensors, the structure of a
training checkpoint.  The pod-compressed and ``zero2`` steps (a pod mesh
axis, ZeRO sharding) and the prefill / decode step builders wait for the
multi-GPU work (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.device import const
from repro_torch.models.layers import _flatten, _unflatten
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import LM, model_defs
from repro_torch.optim import adamw


def param_count(cfg: ArchConfig, expert_share=None) -> int:
    """Analytic parameter count (exact for the port's declarations)."""
    return sum(math.prod(d.shape)
               for d in _flatten(model_defs(cfg, expert_share)).values())


def active_param_count(cfg: ArchConfig) -> int:
    """Per-token active params (MoE: top_k of n_experts per MoE layer)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    moe_layers = sum(1 for s in cfg.pattern_unit if s.moe) * cfg.n_units
    per_expert = 3 * cfg.d_model * m.d_expert
    return total - moe_layers * per_expert * (m.n_experts - m.top_k)


def auto_microbatches(cfg: ArchConfig, shape: ShapeCfg,
                      budget_bytes: float = 4e9) -> int:
    """Grad-accumulation factor so saved layer inputs fit the budget (the
    reference's rule with one data-parallel rank)."""
    b_loc = max(shape.global_batch, 1)
    per_mb = b_loc * shape.seq_len * cfg.d_model * 2 * cfg.n_layers
    mb = 1
    while per_mb / mb > budget_bytes and mb < b_loc:
        mb *= 2
    while b_loc % mb:
        mb //= 2
    return max(mb, 1)


def abstract_params(cfg: ArchConfig, expert_share=None) -> dict:
    """The reference's stacked parameter tree as ``meta`` tensors."""
    dt = getattr(torch, cfg.param_dtype)
    return _unflatten({path: torch.empty(d.shape, dtype=dt, device="meta")
                       for path, d in
                       _flatten(model_defs(cfg, expert_share)).items()})


def abstract_opt(cfg: ArchConfig, expert_share=None) -> dict:
    """The reference's AdamW state tree as ``meta`` tensors."""
    f32 = {path: torch.empty(d.shape, dtype=torch.float32, device="meta")
           for path, d in _flatten(model_defs(cfg, expert_share)).items()}
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "m": _unflatten(f32), "v": _unflatten(dict(f32))}


@dataclasses.dataclass
class TrainProgram:
    step_fn: Callable[..., Any]  # (params, opt, batch) -> (params, opt, metrics)
    model: LM
    abstract_params: Any
    abstract_opt: Any
    microbatches: int

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def make_train_step(cfg: ArchConfig, shape: ShapeCfg,
                    ocfg: Optional[adamw.AdamWConfig] = None,
                    microbatches: Optional[int] = None,
                    pod_compress: Optional[str] = None,
                    zero2: bool = False,
                    device="cuda",
                    moe_dispatch: str = "fused",
                    expert_share=None) -> TrainProgram:
    """The training program of ``cfg`` on ``device`` (its model's
    parameters uninitialised: ``run_training``'s ``init_params_fn`` or a
    checkpoint fills them), MoE layers dispatching by ``moe_dispatch`` and
    holding ``expert_share``'s experts."""
    if pod_compress is not None or zero2:
        raise NotImplementedError(
            "pod-compressed and zero2 steps need a multi-GPU mesh "
            "(ROADMAP A13)")
    ocfg = ocfg or adamw.AdamWConfig()
    model = build_model(cfg, device=device, moe_dispatch=moe_dispatch,
                        expert_share=expert_share)
    mb = microbatches or auto_microbatches(cfg, shape)

    def train_step(params, opt_state, batch):
        names = list(params)
        leaves = [params[k] for k in names]
        tokens = batch["tokens"]
        if mb == 1:
            loss, metrics = model.loss_fn(batch)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            loss = loss.detach()
        else:
            split = tokens.reshape((mb, tokens.shape[0] // mb) +
                                   tuple(tokens.shape[1:]))
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(mb):
                l_i, metrics = model.loss_fn({"tokens": split[i]})
                for k, g in zip(names, torch.autograd.grad(l_i, leaves)):
                    grads[k].add_(g.to(torch.float32))
                lsum = lsum + l_i.detach()
            div = const(float(mb), torch.float32, tokens.device)
            for g in grads.values():
                g.div_(div)
            loss = lsum / div
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, om = adamw.update(ocfg, params, grads, opt_state)
        model.drop_cast()
        return params, opt_state, dict(metrics, loss=loss, **om)

    return TrainProgram(step_fn=train_step, model=model,
                        abstract_params=abstract_params(cfg, expert_share),
                        abstract_opt=abstract_opt(cfg, expert_share),
                        microbatches=mb)
