"""Step builders for one card: train, prefill and decode.

Port of ``src/repro/launch/steps.py``: ``param_count``,
``active_param_count``, ``auto_microbatches``, ``batch_shapes``,
``TrainProgram``, ``make_train_step``, ``make_prefill_step`` and
``make_decode_step``.  The counts and the steps cover every config the
port builds (dense, MoE, RWKV, the Mamba hybrid, the encoder-decoder);
``expert_share=(index, count)`` builds every MoE layer as one card's share
of ``count``-way expert parallelism (``models.moe``), and the counts and
abstract trees follow it.  The step is the reference's:
gradients of the model's ``loss_fn`` over ``microbatches`` slices of
every batch leaf (``tokens``, and ``frames`` for an encoder-decoder),
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
training checkpoint.

Serving: :func:`make_prefill_step` and :func:`make_decode_step` build the
model with ``param_dtype="bfloat16"``, as the reference does for
inference, and return ``(fn, model)``: ``fn(batch) -> logits`` (the last
position's, no cache) and ``fn(token, pos, cache) -> (logits, cache)``
(the cache written in place), both with grad off.  The two may share one
model (``model=``).  A VLM batch carries ``prefix_embeds`` (B, P, d)
beside ``tokens``: the train step splits it across microbatches with the
other leaves, the prefill passes it to the model, and decode goes on at
slot P + L.

Shapes without storage: :func:`make_ctx` gives the single-card stand-in
for the reference's ``ShardingCtx`` (:class:`CardCtx`: one device, no
batch, sequence or FSDP axes, ``dp`` 1); :func:`batch_specs` returns the
reference's ``(shapes, specs)`` with the device as every leaf's
placement, and :func:`input_specs` adds a decode step's cache, its model
built on the ``meta`` device.  The pod-compressed and ``zero2`` steps (a
pod mesh axis, ZeRO sharding), FSDP, and the builders' shardings and
donation wait for the multi-GPU work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.device import const, resolve_device
from repro_torch.models.attention import TensorSpec
from repro_torch.models.encdec import EncDec
from repro_torch.models.layers import _flatten, _unflatten
from repro_torch.models.registry import build_model, model_defs
from repro_torch.models.transformer import LM
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


@dataclasses.dataclass(frozen=True)
class CardCtx:
    """The single-card stand-in for the reference's ``ShardingCtx``: the
    device every tensor lies on, no batch, sequence or FSDP axes."""
    device: torch.device
    batch_axes: Tuple[str, ...] = ()
    seq_axes: Tuple[str, ...] = ()
    fsdp_axis: Optional[str] = None

    @property
    def dp(self) -> int:
        return 1


def make_ctx(cfg: ArchConfig, shape: ShapeCfg, device="cuda",
             fsdp: Optional[bool] = None) -> CardCtx:
    """The context of one (arch, shape) cell on ``device`` (``"meta"``
    for shapes alone).  FSDP shards over a data axis, which one card does
    not have: ``fsdp=True`` raises."""
    if fsdp:
        raise NotImplementedError(
            f"{cfg.name} x {shape.name}: FSDP shards parameters over a data "
            "axis, which needs a multi-GPU mesh")
    return CardCtx(device=resolve_device(device))


def batch_shapes(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Any]:
    """The batch of a ``shape.kind`` step as ``TensorSpec``s (the
    reference's): ``tokens`` (B, L + 1 to train, B, L to prefill; a
    prefix's positions taken from L), ``prefix_embeds`` for a VLM prefix,
    ``frames`` (B, encoder_seq, d) for an encoder-decoder; a decode step's
    ``tokens`` (B, 1) and ``pos``."""
    B, L = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": TensorSpec((B, 1), torch.int32),
                "pos": TensorSpec((), torch.int32)}
    text, out = L, {}
    if cfg.prefix_tokens:
        text = L - cfg.prefix_tokens
        out["prefix_embeds"] = TensorSpec((B, cfg.prefix_tokens,
                                           cfg.d_model), torch.bfloat16)
    if cfg.is_encdec:
        out["frames"] = TensorSpec((B, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16)
    out["tokens"] = TensorSpec((B, text + (shape.kind == "train")),
                               torch.int32)
    return out


def batch_specs(cfg: ArchConfig, shape: ShapeCfg, ctx: CardCtx):
    """``(shapes, specs)``: :func:`batch_shapes` and, for each leaf, its
    placement, which on one card is ``ctx.device``."""
    shapes = batch_shapes(cfg, shape)
    return shapes, {k: ctx.device for k in shapes}


def input_specs(cfg: ArchConfig, shape: ShapeCfg, ctx: CardCtx) -> dict:
    """Every abstract input of the cell's step: ``{"batch": (shapes,
    specs)}`` and, for a decode step, ``"cache": (shapes, specs)``, the
    model's cache for ``global_batch`` rows of ``seq_len`` slots (its
    model built on the ``meta`` device, so nothing is allocated)."""
    out = {"batch": batch_specs(cfg, shape, ctx)}
    if shape.kind == "decode":
        model = build_model(cfg, device="meta")
        cache = model.cache_shapes(shape.global_batch, shape.seq_len)
        out["cache"] = (cache, _placed(cache, ctx.device))
    return out


def _placed(tree, device):
    """``tree``'s structure with ``device`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _placed(v, device) for k, v in tree.items()}
    return device


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
    model: LM | EncDec
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
        if mb == 1:
            loss, metrics = model.loss_fn(batch)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            loss = loss.detach()
        else:
            split = {k: x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:]))
                     for k, x in batch.items()}
            dev = batch["tokens"].device
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                l_i, metrics = model.loss_fn({k: x[i]
                                              for k, x in split.items()})
                for k, g in zip(names, torch.autograd.grad(l_i, leaves)):
                    grads[k].add_(g.to(torch.float32))
                lsum = lsum + l_i.detach()
            div = const(float(mb), torch.float32, dev)
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


def _serving_model(cfg: ArchConfig, device, moe_dispatch: str, model):
    """``cfg``'s model with bfloat16 parameters (the reference serves bf16
    weights), or ``model`` when given, which must be that model."""
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if model is None:
        return build_model(cfg, device=device, moe_dispatch=moe_dispatch)
    if model.cfg != cfg:
        raise ValueError(f"a shared model must be {cfg.name} with bfloat16 "
                         f"parameters; got {model.cfg.name} with "
                         f"{model.cfg.param_dtype}")
    return model


def make_prefill_step(cfg: ArchConfig, device="cuda",
                      moe_dispatch: str = "fused", model=None):
    """``(fn, model)``: ``fn(batch)`` runs ``model.prefill(batch)`` with
    grad off and returns the last position's logits (B, Vp); ``model`` is
    ``cfg``'s with bfloat16 parameters, uninitialised (or the one given)."""
    model = _serving_model(cfg, device, moe_dispatch, model)

    @torch.no_grad()
    def prefill(batch):
        return model.prefill(batch)[0]

    return prefill, model


def make_decode_step(cfg: ArchConfig, device="cuda",
                     moe_dispatch: str = "fused", model=None):
    """``(fn, model)``: ``fn(token, pos, cache)`` runs
    ``model.decode_step`` with grad off and returns ``(logits (B, Vp),
    cache)``, the cache written in place; ``model`` as
    :func:`make_prefill_step`'s."""
    model = _serving_model(cfg, device, moe_dispatch, model)

    @torch.no_grad()
    def decode(token, pos, cache):
        return model.decode_step(token, pos, cache)

    return decode, model
