"""Decoder-only LM assembly for one card: dense / MoE / RWKV / Mamba-hybrid.

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
gives the same bits on every run.  Mamba and RWKV layers train through
their scans' own backwards (``mamba.SelectiveScan``, ``rwkv.WKVFunction``),
which keep one chunk or block of states; the checkpoint stays whole-unit
(the reference found per-layer remat no use for Jamba's units).

MoE layers (``spec.moe``) hold ``"moe"`` in place of ``"mlp"`` and run
:func:`repro_torch.models.moe.moe_fwd` with the model's ``moe_dispatch``
(``"fused"`` by default, as the reference's ``LM``); every layer returns
its aux losses beside ``x``, and the stack sums ``moe_lb`` / ``moe_z`` in
the reference's order (over a unit's layers, then over units), also
through ``checkpoint``.  ``loss_fn`` adds ``0.01 * moe_lb / n_layers +
1e-3 * moe_z / n_layers`` and reports both terms.  ``expert_share=(index,
count)`` makes every MoE layer one card's share of ``count``-way expert
parallelism (``moe.moe_fwd(..., share=)``): it holds ``E / count``
experts.

Layer kinds (``LayerSpec.kind``) are the reference's: ``attn``, ``mamba``
(:mod:`repro_torch.models.mamba`, Jamba's hybrid units) and ``rwkv``
(:mod:`repro_torch.models.rwkv`: the time mix in place of attention, the
channel mix in place of the FFN).  A layer's parameters are declared in
the reference's key order (``ln1``, the mixer, ``ln2``, the FFN), which is
the order ``init`` draws them in.

Caches mirror the reference's per-unit stacks, dim 0 the unit:
``{"layer{i}": {"attn": {"k", "v"}}}`` of shape ``(n_units, batch,
max_len, n_kv_heads, hd)`` (on one card ``ShardingCtx.kv_repeat`` is 1, so
the cache holds ``n_kv_heads`` heads); ``{"mamba": {"conv": (n, B, dc-1,
di), "ssm": (n, B, di, ds) float32}}``; ``{"rwkv_tm": {"shift_tm": (n, B,
1, d), "wkv": (n, B, H, hd, hd) float32}, "rwkv_cm": {"shift_cm": (n, B,
1, d)}}``, the rest in the compute dtype.  The port writes every cache and
state in place and returns the same dict (MoE layers hold no state); the
reference's sharding, ``specs`` and ``_unit_gather_spec`` wait for the
multi-GPU work.  Encoder-decoder configs build
:class:`repro_torch.models.encdec.EncDec` (``build_model``), which shares
this module's :class:`HeldWeights`.

VLM prefixes (``cfg.prefix_tokens``, the reference's stubbed vision
frontend): ``loss_fn`` and ``prefill`` take ``batch["prefix_embeds"]`` (B,
P, d), cast it to the compute dtype and put it before the token
embeddings, so positions run over ``P + L``; ``loss_fn`` drops the P
prefix rows before the logits, and ``prefill`` fills the cache from slot 0
over ``P + L``, so the first decode step's slot is ``P + L``.  The prefix
is an input: only parameters are differentiated.  A VLM config served or
trained without a prefix runs its text alone (the reference's
``BatchServer`` does so too; its ``run_training`` needs the prefix from
``batch_to_inputs``, since its step's shardings name it).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import const, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
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


def _layer_defs(cfg: ArchConfig, spec: LayerSpec,
                expert_share=None) -> ParamDefs:
    d: ParamDefs = {"ln1": norm_defs(cfg.d_model, cfg.use_bias)}
    if spec.kind == "attn":
        d["attn"] = attn.attn_defs(cfg)
    elif spec.kind == "mamba":
        d["mamba"] = mam.mamba_defs(cfg)
    elif spec.kind == "rwkv":
        d["rwkv"] = rwkv_mod.rwkv_defs(cfg)["tm"]
    else:
        raise ValueError(spec.kind)
    d["ln2"] = norm_defs(cfg.d_model, cfg.use_bias)
    if spec.kind == "rwkv":
        d["cm"] = rwkv_mod.rwkv_defs(cfg)["cm"]
    elif spec.moe:
        d["moe"] = moe_mod.moe_defs(cfg, expert_share)
    else:
        d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_type,
                            cfg.use_bias)
    return d


def unit_defs(cfg: ArchConfig, expert_share=None) -> ParamDefs:
    return {f"layer{i}": _layer_defs(cfg, s, expert_share)
            for i, s in enumerate(cfg.pattern_unit)}


def model_defs(cfg: ArchConfig, expert_share=None) -> ParamDefs:
    """The reference ``LM``'s stacked declaration of every parameter, MoE
    layers holding ``expert_share``'s experts (raises on a layer kind the
    port does not declare, and on an encoder-decoder config, which
    ``models.registry.model_defs`` sends to ``models.encdec``)."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: an encoder-decoder config is an "
                         "EncDec (models.encdec), not an LM")
    V, d = cfg.padded_vocab, cfg.d_model
    defs: ParamDefs = {
        "embed": ParamDef((V, d), "small_normal"),
        "units": stack_defs(unit_defs(cfg, expert_share), cfg.n_units),
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


def _add_aux(acc: dict, aux: dict) -> dict:
    """``acc + aux`` key by key, a key of one alone taken as it is (the
    reference adds to float32 zeros, and ``0 + v`` is ``v``)."""
    out = dict(acc)
    for k, v in aux.items():
        out[k] = out[k] + v if k in out else v
    return out


def _store(cache: Optional[dict], kind: str, new: Optional[dict]) -> None:
    """Write a layer's new state into its cache slice in place (cast to
    the cache's dtype, as the reference's ``n.astype(c.dtype)``)."""
    if cache is not None:
        for name, t in new.items():
            cache[kind][name].copy_(t)


class _ParamNode(nn.Module):
    """A node holding both parameters and sub-nodes by name (an MoE
    layer's experts beside its ``shared`` expert)."""

    def __init__(self, defs: ParamDefs, dtype, device):
        super().__init__()
        self._keys = list(defs)
        for k, d in defs.items():
            if isinstance(d, ParamDef):
                self.register_parameter(k, nn.Parameter(
                    torch.empty(d.shape, dtype=dtype, device=device)))
            else:
                self.add_module(k, _params_module(d, dtype, device))

    def __getitem__(self, k):
        return getattr(self, k)

    def items(self):
        return [(k, getattr(self, k)) for k in self._keys]


def _params_module(defs: ParamDefs, dtype, device) -> nn.Module:
    """``defs`` as modules: a ``ParameterDict`` where every value is a
    ``ParamDef``, a ``ModuleDict`` where none is, a ``_ParamNode`` where
    they mix (uninitialised storage)."""
    kinds = {isinstance(d, ParamDef) for d in defs.values()}
    if kinds == {True}:
        return nn.ParameterDict({
            k: nn.Parameter(torch.empty(d.shape, dtype=dtype, device=device))
            for k, d in defs.items()})
    if kinds == {False}:
        return nn.ModuleDict({k: _params_module(v, dtype, device)
                              for k, v in defs.items()})
    return _ParamNode(defs, dtype, device)


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


def head_logits(final_norm, x, head, cfg: ArchConfig):
    """The reference's ``_logits``: ``final_norm`` (uncast), ``@ head``,
    the padded vocabulary's columns at -1e30."""
    x = norm_fwd(final_norm, x, cfg.norm_eps)
    logits = x @ head
    V, Vp = cfg.vocab, cfg.padded_vocab
    if Vp != V:
        bias = torch.where(torch.arange(Vp, device=x.device) < V, 0.0, -1e30)
        logits = logits + bias.to(logits.dtype)
    return logits


class HeldWeights(nn.Module):
    """What the ``LM`` and the ``EncDec`` share: parameters held in
    ``param_dtype``, compute-dtype copies kept for serving in ``_cast``
    (dropped by ``init``, ``load_state_dict`` and ``.to()``; after editing
    a weight in place, call :meth:`drop_cast`), and the embedding
    gather."""

    _cast = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

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

    def _embed(self, tokens):
        flat = _GatherRows.apply(self.embed, tokens.reshape(-1).long())
        return flat.reshape(*tokens.shape, -1).to(self.cdt)


class LM(HeldWeights):
    """Decoder-only language model over a pattern-unit stack."""

    def __init__(self, cfg: ArchConfig, device="cuda",
                 moe_dispatch: str = "fused", expert_share=None):
        super().__init__()
        if moe_dispatch not in moe_mod.DISPATCHES:
            raise ValueError(f"moe_dispatch {moe_dispatch!r}: one of "
                             f"{moe_mod.DISPATCHES}")
        if expert_share is not None:
            if cfg.moe is None:
                raise ValueError(f"{cfg.name}: an expert share needs MoE "
                                 "layers")
            expert_share = tuple(expert_share)
            moe_mod.held_experts(cfg.moe, expert_share)
        dev = resolve_device(device)
        self.cfg = cfg
        self.moe_dispatch = moe_dispatch
        self.expert_share = expert_share
        self.cdt = getattr(torch, cfg.compute_dtype)
        self.pdt = getattr(torch, cfg.param_dtype)
        V, d = cfg.padded_vocab, cfg.d_model
        self.defs = model_defs(cfg, expert_share)
        self.embed = nn.Parameter(torch.empty((V, d), dtype=self.pdt,
                                              device=dev))
        self.layers = nn.ModuleList(
            _params_module(_layer_defs(cfg, spec, expert_share), self.pdt,
                           dev)
            for _ in range(cfg.n_units) for spec in cfg.pattern_unit)
        self.final_norm = _params_module(self.defs["final_norm"], self.pdt,
                                         dev)
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = nn.Parameter(torch.empty((d, V), dtype=self.pdt,
                                                    device=dev))

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

    def _layer(self, spec: LayerSpec, p, x, positions, cache=None,
               cache_index=None):
        """One layer of kind ``spec.kind``: ``(x, aux)``, aux the MoE
        losses (empty for a dense FFN or a channel mix).  With ``cache``
        (this layer's slice) its state is written in place."""
        cfg = self.cfg
        h = norm_fwd(p["ln1"], x, cfg.norm_eps)
        if spec.kind == "attn":
            out, _ = attn.attention_fwd(
                p["attn"], h, cfg, positions=positions,
                cache=None if cache is None else cache["attn"],
                cache_index=cache_index)
        elif spec.kind == "mamba":
            out, ns = mam.mamba_fwd(
                p["mamba"], h, cfg,
                state=None if cache is None else cache["mamba"])
            _store(cache, "mamba", ns)
        else:  # rwkv time mix
            out, ns = rwkv_mod.rwkv_time_mix(
                p["rwkv"], h, cfg,
                state=None if cache is None else cache["rwkv_tm"])
            _store(cache, "rwkv_tm", ns)
        x = x + out
        h = norm_fwd(p["ln2"], x, cfg.norm_eps)
        aux = {}
        if spec.kind == "rwkv":
            out, ns = rwkv_mod.rwkv_channel_mix(
                p["cm"], h, state=None if cache is None else cache["rwkv_cm"])
            _store(cache, "rwkv_cm", ns)
        elif spec.moe:
            out, aux = moe_mod.moe_fwd(p["moe"], h, cfg, self.moe_dispatch,
                                       self.expert_share)
        else:
            out = mlp_fwd(p["mlp"], h, cfg.mlp_type)
        return x + out, aux

    def _unit(self, unit, x, positions, caches=None, cache_index=None):
        """The layers of one unit: ``(x, aux)``, aux summed over its layers
        (the reference's ``_unit``)."""
        aux = {}
        for i, (spec, p) in enumerate(zip(self.cfg.pattern_unit, unit)):
            x, a = self._layer(spec, p, x, positions,
                               None if caches is None else caches[i],
                               cache_index)
            aux = _add_aux(aux, a)
        return x, aux

    def _run_stack(self, x, positions, cache=None, cache_index=None):
        """``(x, aux)``: aux the units' sums added up in unit order."""
        layers, _ = self._compute_params()
        P = len(self.cfg.pattern_unit)
        aux = {}
        for u in range(self.cfg.n_units):
            caches = None
            if cache is not None:
                caches = [{kind: {k: t[u] for k, t in leaves.items()}
                           for kind, leaves in cache[f"layer{i}"].items()}
                          for i in range(P)]
            x, a = self._unit(layers[u * P:(u + 1) * P], x, positions,
                              caches, cache_index)
            aux = _add_aux(aux, a)
        return x, aux

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
            return self._unit([cast_floats(_tree(layer), self.cdt)
                               for layer in unit], x, positions)

        aux = {}
        for u in range(cfg.n_units):
            unit = tuple(self.layers[u * P:(u + 1) * P])
            if cfg.remat:
                x, a = checkpoint(unit_fn, x, *unit, use_reentrant=False)
            else:
                x, a = unit_fn(x, *unit)
            aux = _add_aux(aux, a)
        return x, aux

    # ---- public entry points -------------------------------------------------

    def _logits(self, x):
        head = self._cast_head() if torch.is_grad_enabled() \
            else self._compute_params()[1]
        return head_logits(self.final_norm, x, head, self.cfg)

    def _inputs(self, tokens, prefix):
        """The stack's input: the tokens' embeddings after ``prefix`` (B,
        P, d) cast to the compute dtype, when given; and positions
        ``arange(P + L)``."""
        x = self._embed(tokens)
        if prefix is not None:
            x = torch.cat([prefix.to(self.cdt), x], dim=1)
        B, L, _ = x.shape
        return x, torch.arange(L, device=x.device).expand(B, L)

    def loss_fn(self, batch):
        """Token-mean cross entropy (z-loss 1e-4) of ``batch["tokens"]``
        (B, L+1): inputs ``[:, :-1]``, labels ``[:, 1:]``, after
        ``batch["prefix_embeds"]`` (B, P, d) when given, whose P rows the
        loss drops before the logits; with MoE plus ``0.01 * moe_lb /
        n_layers + 1e-3 * moe_z / n_layers``.  Returns ``(loss, {"ce", and
        with MoE "moe_lb", "moe_z"})``; differentiable while grad is
        enabled."""
        cfg = self.cfg
        tokens = batch["tokens"]
        prefix = batch.get("prefix_embeds")
        x, positions = self._inputs(tokens[:, :-1], prefix)
        labels = tokens[:, 1:]
        if torch.is_grad_enabled():
            x, aux = self._train_stack(x, positions)
        else:
            x, aux = self._run_stack(x, positions)
        if prefix is not None:
            x = x[:, prefix.shape[1]:]
        loss = cross_entropy(self._logits(x), labels)
        metrics = {"ce": loss}
        if cfg.moe is not None:
            n = const(float(cfg.n_layers), torch.float32, x.device)
            loss = loss + 0.01 * aux["moe_lb"] / n \
                + 1e-3 * aux["moe_z"] / n
            metrics.update(aux)
        return loss, metrics

    @torch.no_grad()
    def prefill(self, batch, cache=None):
        """Prefill logits for the LAST position (optionally filling the
        cache from slot 0).  ``batch["tokens"]`` (B, L) int32 or int64 on
        the model's device, after ``batch["prefix_embeds"]`` (B, P, d)
        when given (the cache's first P + L slots are then filled, and
        decode goes on at slot P + L).  Returns (logits (B, Vp), cache or
        None)."""
        x, positions = self._inputs(batch["tokens"],
                                    batch.get("prefix_embeds"))
        if cache is None:
            x, _ = self._run_stack(x, positions)
            return self._logits(x[:, -1:])[:, 0], None
        x, _ = self._run_stack(x, positions, cache=cache, cache_index=0)
        return self._logits(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, token, pos: int, cache):
        """token (B, 1) int; ``pos`` the cache slot (and position) of this
        token.  Returns (logits (B, Vp), cache), the cache updated in
        place."""
        B = token.shape[0]
        x = self._embed(token)
        positions = torch.full((B, 1), int(pos), device=x.device)
        x, _ = self._run_stack(x, positions, cache=cache,
                               cache_index=int(pos))
        return self._logits(x)[:, 0], cache

    # ---- caches ----------------------------------------------------------------

    def cache_shapes(self, batch: int, max_len: int):
        """Abstract per-unit cache stack (stack dim 0 = units)."""
        cfg, n = self.cfg, self.cfg.n_units
        out = {}
        for i, spec in enumerate(cfg.pattern_unit):
            if spec.kind == "attn":
                c = {"attn": attn.init_cache_shapes(cfg, batch, max_len, n,
                                                    self.cdt)}
            elif spec.kind == "mamba":
                c = {"mamba": mam.mamba_state_shapes(cfg, batch, n,
                                                     self.cdt)}
            else:
                s = rwkv_mod.rwkv_state_shapes(cfg, batch, n, self.cdt)
                c = {"rwkv_tm": {"shift_tm": s["shift_tm"], "wkv": s["wkv"]},
                     "rwkv_cm": {"shift_cm": s["shift_cm"]}}
            out[f"layer{i}"] = c
        return out

    def init_cache(self, batch: int, max_len: int):
        return {layer: {kind: {name: torch.zeros(s.shape, dtype=s.dtype,
                                                 device=self.device)
                               for name, s in specs.items()}
                        for kind, specs in c.items()}
                for layer, c in self.cache_shapes(batch, max_len).items()}
