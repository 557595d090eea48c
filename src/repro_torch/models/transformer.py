"""Decoder-only LM assembly for one card: dense attention stacks.

Port of ``src/repro/models/transformer.py`` (``LM``) as an ``nn.Module``:
the embedding, a ``ModuleList`` of layers (layer ``u * len(pattern_unit)
+ i`` is the reference's stacked ``units/layer{i}`` slice ``u``),
``final_norm`` and ``lm_head``.  Initialization draws the reference's
stacked unit leaves ``(n_units, ...)`` and unstacks them, so every unit
weight gets the reference's scale ``1 / sqrt(n_units)``.

Mixed precision follows the reference: the unit parameters, norm scales
included, are cast to ``compute_dtype`` for the stack, the embedding is
cast after the gather, ``lm_head`` is cast and ``final_norm`` is not.
Serving (no grad) changes no weight, so its cast copies are made once and
kept (``compute_dtype`` bfloat16 over float32 parameters: 2 bytes a unit
and head parameter beside their 4; none when the two dtypes agree).  They
are dropped by ``init``, ``load_state_dict`` and ``.to()``; after editing
a weight in place (an optimizer step), call :meth:`LM.drop_cast`.  With
grad enabled nothing is cached: every call casts afresh, so gradients
reach the float32 parameters.

Training: :meth:`LM.loss_fn` (the reference's ``loss_fn``) runs the stack
unit by unit, each unit under ``torch.utils.checkpoint`` when
``cfg.remat`` (policy ``"nothing"``: only the unit's input is kept) with
the cast of its weights inside the checkpointed function, as the
reference's ``unit_fn``.  The embedding gather's gradient sums each
token's rows in a fixed order (:class:`_GatherRows`), so a training step
gives the same bits on every run.

Caches mirror the reference's per-unit stacks ``{"layer{i}": {"attn":
{"k", "v"}}}`` of shape ``(n_units, batch, max_len, n_kv_heads, hd)``; on
one card ``ShardingCtx.kv_repeat`` is 1, so the cache holds ``n_kv_heads``
heads (the reference's sharding, ``specs`` and ``_unit_gather_spec`` wait
for the multi-GPU work).  The port writes the cache in place and returns
the same dict.  MoE, Mamba, RWKV, VLM-prefix and encoder-decoder configs
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    ParamDef,
    ParamDefs,
    _flatten,
    _init_one,
    cast_floats,
    cross_entropy,
    mlp_defs,
    mlp_fwd,
    norm_defs,
    norm_fwd,
    stack_defs,
)


def _layer_defs(cfg: ArchConfig, spec: LayerSpec) -> ParamDefs:
    return {"ln1": norm_defs(cfg.d_model, cfg.use_bias),
            "attn": attn.attn_defs(cfg),
            "ln2": norm_defs(cfg.d_model, cfg.use_bias),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_type,
                            cfg.use_bias)}


def unit_defs(cfg: ArchConfig) -> ParamDefs:
    return {f"layer{i}": _layer_defs(cfg, s)
            for i, s in enumerate(cfg.pattern_unit)}


def model_defs(cfg: ArchConfig) -> ParamDefs:
    """The reference's stacked declaration of every parameter."""
    V, d = cfg.padded_vocab, cfg.d_model
    defs: ParamDefs = {
        "embed": ParamDef((V, d), "small_normal"),
        "units": stack_defs(unit_defs(cfg), cfg.n_units),
        "final_norm": norm_defs(d, cfg.use_bias),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), "small_normal")
    return defs


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` whose gradient sums each row's terms in a fixed
    order.  ``index_select``'s own backward on CUDA is an atomic
    ``index_add_``, whose float sums differ from run to run; here the CUDA
    gradient is ``index_put_(accumulate=True)``, PyTorch's sort-based
    segment sum (a stable radix sort of the ids, then each id's rows added
    in that order by one warp), and the CPU gradient ``index_add_``, which
    adds the rows in index order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows, grad.shape[1]))
        if grad.is_cuda:
            out.index_put_((idx,), grad, accumulate=True)
        else:
            out.index_add_(0, idx, grad)
        return out, None


def _unsupported(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet (None when it can)."""
    if cfg.is_encdec:
        return "encoder-decoder (ROADMAP A14: enc-dec)"
    kinds = {s.kind for s in cfg.pattern_unit}
    if kinds & {"mamba", "rwkv"}:
        return f"{'/'.join(sorted(kinds - {'attn'}))} layers (ROADMAP A14: SSM)"
    if cfg.moe is not None or any(s.moe for s in cfg.pattern_unit):
        return "MoE layers (ROADMAP A14: MoE)"
    if cfg.prefix_tokens:
        return "a VLM prefix (ROADMAP A14: VLM)"
    return None


def _params_module(defs: ParamDefs, dtype, device) -> nn.Module:
    """``defs`` as modules: a ``ParameterDict`` where every value is a
    ``ParamDef``, a ``ModuleDict`` above that (uninitialised storage)."""
    if all(isinstance(d, ParamDef) for d in defs.values()):
        return nn.ParameterDict({
            k: nn.Parameter(torch.empty(d.shape, dtype=dtype, device=device))
            for k, d in defs.items()})
    return nn.ModuleDict({k: _params_module(v, dtype, device)
                          for k, v in defs.items()})


def _tree(module: nn.Module) -> dict:
    """A ``ModuleDict`` / ``ParameterDict`` nest as plain nested dicts."""
    return {k: _tree(v) if isinstance(v, nn.Module) else v
            for k, v in module.items()}


def _leaf(root: nn.Module, path) -> torch.Tensor:
    node = root
    for k in path:
        node = node[k] if isinstance(node, (nn.ModuleDict, nn.ParameterDict)) \
            else getattr(node, k)
    return node


class LM(nn.Module):
    """Decoder-only language model over a pattern-unit stack."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        why = _unsupported(cfg)
        if why is not None:
            raise NotImplementedError(f"{cfg.name}: {why} is not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        self.cdt = getattr(torch, cfg.compute_dtype)
        self.pdt = getattr(torch, cfg.param_dtype)
        V, d = cfg.padded_vocab, cfg.d_model
        self.defs = model_defs(cfg)
        self.embed = nn.Parameter(torch.empty((V, d), dtype=self.pdt,
                                              device=dev))
        self.layers = nn.ModuleList(
            _params_module(_layer_defs(cfg, spec), self.pdt, dev)
            for _ in range(cfg.n_units) for spec in cfg.pattern_unit)
        self.final_norm = _params_module(self.defs["final_norm"], self.pdt,
                                         dev)
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = nn.Parameter(torch.empty((d, V), dtype=self.pdt,
                                                    device=dev))
        self._cast = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---- params ------------------------------------------------------------

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "LM":
        """Fill every parameter from ``gen`` (draws on ``gen.device``), one
        draw per leaf of the reference's stacked declaration, in its order."""
        P = len(self.cfg.pattern_unit)
        for path, d in _flatten(self.defs).items():
            value = _init_one(gen, d, self.pdt)
            if path[0] == "units":
                i = int(path[1][len("layer"):])
                for u in range(self.cfg.n_units):
                    _leaf(self.layers[u * P + i], path[2:]).copy_(value[u])
            else:
                _leaf(self, path).copy_(value)
        self.drop_cast()
        return self

    def drop_cast(self) -> None:
        """Forget the compute-dtype copies (made again at the next call)."""
        self._cast = None

    def load_state_dict(self, *args, **kwargs):
        out = super().load_state_dict(*args, **kwargs)
        self.drop_cast()
        return out

    def _apply(self, fn, *args, **kwargs):
        self.drop_cast()
        return super()._apply(fn, *args, **kwargs)

    def _cast_head(self):
        head = self.lm_head if self.lm_head is not None else self.embed.T
        return head.to(self.cdt)

    def _compute_params(self):
        """(per-layer params in compute dtype, lm_head in compute dtype):
        cast afresh while grad is enabled, else cast once and kept."""
        if torch.is_grad_enabled():
            return ([cast_floats(_tree(layer), self.cdt)
                     for layer in self.layers], self._cast_head())
        if self._cast is None:
            self._cast = ([cast_floats(_tree(layer), self.cdt)
                           for layer in self.layers], self._cast_head())
        return self._cast

    # ---- layers ------------------------------------------------------------

    def _layer(self, p, x, positions, cache=None, cache_index=None):
        cfg = self.cfg
        h = norm_fwd(p["ln1"], x, cfg.norm_eps)
        out, nc = attn.attention_fwd(
            p["attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["attn"],
            cache_index=cache_index)
        x = x + out
        h = norm_fwd(p["ln2"], x, cfg.norm_eps)
        x = x + mlp_fwd(p["mlp"], h, cfg.mlp_type)
        return x

    def _run_stack(self, x, positions, cache=None, cache_index=None):
        layers, _ = self._compute_params()
        P = len(self.cfg.pattern_unit)
        for n, p in enumerate(layers):
            u, i = divmod(n, P)
            c = None
            if cache is not None:
                c = {"attn": {k: t[u] for k, t in
                              cache[f"layer{i}"]["attn"].items()}}
            x = self._layer(p, x, positions, c, cache_index)
        return x

    def _train_stack(self, x, positions):
        """The stack with grad: each unit casts its own weights, under
        ``checkpoint`` when ``cfg.remat``."""
        cfg = self.cfg
        if cfg.remat and cfg.remat_policy != "nothing":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} (the port remats with "
                "policy 'nothing'; ROADMAP A14b)")
        P = len(cfg.pattern_unit)

        def unit_fn(x, *unit):
            for layer in unit:
                x = self._layer(cast_floats(_tree(layer), self.cdt), x,
                                positions)
            return x

        for u in range(cfg.n_units):
            unit = tuple(self.layers[u * P:(u + 1) * P])
            if cfg.remat:
                x = checkpoint(unit_fn, x, *unit, use_reentrant=False)
            else:
                x = unit_fn(x, *unit)
        return x

    # ---- public entry points -------------------------------------------------

    def _embed(self, tokens):
        flat = _GatherRows.apply(self.embed, tokens.reshape(-1).long())
        return flat.reshape(*tokens.shape, -1).to(self.cdt)

    def _logits(self, x):
        head = self._cast_head() if torch.is_grad_enabled() \
            else self._compute_params()[1]
        x = norm_fwd(self.final_norm, x, self.cfg.norm_eps)
        logits = x @ head
        V, Vp = self.cfg.vocab, self.cfg.padded_vocab
        if Vp != V:
            bias = torch.where(torch.arange(Vp, device=x.device) < V,
                               0.0, -1e30)
            logits = logits + bias.to(logits.dtype)
        return logits

    def loss_fn(self, batch):
        """Token-mean cross entropy (z-loss 1e-4) of ``batch["tokens"]``
        (B, L+1): inputs ``[:, :-1]``, labels ``[:, 1:]``.  Returns
        ``(loss, {"ce": loss})``; differentiable while grad is enabled."""
        if batch.get("prefix_embeds") is not None:
            raise NotImplementedError("prefix embeddings (ROADMAP A14: VLM)")
        if self.cfg.moe is not None:
            raise NotImplementedError("the MoE aux loss (ROADMAP A14: MoE)")
        tokens = batch["tokens"]
        x = self._embed(tokens[:, :-1])
        labels = tokens[:, 1:]
        B, L, _ = x.shape
        positions = torch.arange(L, device=x.device).expand(B, L)
        if torch.is_grad_enabled():
            x = self._train_stack(x, positions)
        else:
            x = self._run_stack(x, positions)
        loss = cross_entropy(self._logits(x), labels)
        return loss, {"ce": loss}

    @torch.no_grad()
    def prefill(self, batch, cache=None):
        """Prefill logits for the LAST position (optionally filling the
        cache from slot 0).  ``batch["tokens"]`` (B, L) int32 or int64 on
        the model's device.  Returns (logits (B, Vp), cache or None)."""
        if batch.get("prefix_embeds") is not None:
            raise NotImplementedError("prefix embeddings (ROADMAP A14: VLM)")
        x = self._embed(batch["tokens"])
        B, L, _ = x.shape
        positions = torch.arange(L, device=x.device).expand(B, L)
        if cache is None:
            x = self._run_stack(x, positions)
            return self._logits(x[:, -1:])[:, 0], None
        x = self._run_stack(x, positions, cache=cache, cache_index=0)
        return self._logits(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, token, pos: int, cache):
        """token (B, 1) int; ``pos`` the cache slot (and position) of this
        token.  Returns (logits (B, Vp), cache), the cache updated in
        place."""
        B = token.shape[0]
        x = self._embed(token)
        positions = torch.full((B, 1), int(pos), device=x.device)
        x = self._run_stack(x, positions, cache=cache, cache_index=int(pos))
        return self._logits(x)[:, 0], cache

    # ---- caches ----------------------------------------------------------------

    def cache_shapes(self, batch: int, max_len: int):
        """Abstract per-unit cache stack (stack dim 0 = units)."""
        return {f"layer{i}": {"attn": attn.init_cache_shapes(
                    self.cfg, batch, max_len, self.cfg.n_units, self.cdt)}
                for i, _ in enumerate(self.cfg.pattern_unit)}

    def init_cache(self, batch: int, max_len: int):
        return {layer: {kind: {name: torch.zeros(s.shape, dtype=s.dtype,
                                                 device=self.device)
                               for name, s in specs.items()}
                        for kind, specs in c.items()}
                for layer, c in self.cache_shapes(batch, max_len).items()}
