"""Whisper-style encoder-decoder backbone for one card.

Port of ``src/repro/models/encdec.py`` (``EncDec``, ``sinusoid``) as an
``nn.Module`` in the idiom of the port's ``LM`` (``models/transformer.py``).
The audio frontend is the reference's stub: inputs are precomputed frame
embeddings ``(B, encoder_seq, d_model)``; sinusoidal positions on both
sides, no RoPE.

Parameters: ``embed``, ``enc_layers`` / ``dec_layers`` (layer ``u`` is the
reference's stacked ``enc_units`` / ``dec_units`` slice ``u``),
``enc_norm``, ``final_norm`` and ``lm_head``.  :meth:`EncDec.init` draws
the reference's stacked leaves ``(n, ...)`` in its declaration order and
unstacks them, so a stacked weight keeps the reference's scale ``1 /
sqrt(n)`` (the stack dim is its fan-in).

Mixed precision is the ``LM``'s (:class:`HeldWeights`): the layers'
parameters are cast to ``compute_dtype``, the embedding after the gather,
``lm_head`` cast and ``final_norm`` / ``enc_norm`` not; serving keeps the
cast copies, training casts each layer inside its checkpointed function
(``cfg.remat``: policy ``"nothing"``, one ``torch.utils.checkpoint`` a
layer, as the reference's scan over units), and the embedding gather's
gradient goes through ``_GatherRows``, so a step is bitwise repeatable.

Attention runs through :func:`repro_torch.models.attention.attention_fwd`
(``rope=False``): the encoder's full self-attention over the frames, the
decoder's causal self-attention and its cross attention over the encoder
output, each the flash kernel on CUDA tensors.  Decode reads the cross
K / V that :meth:`EncDec.build_cross_cache` projected once at prefill
(``decode_attention``, a plain einsum, as the reference leaves it to XLA).

Caches, dim 0 the decoder layer: ``{"attn": {"k", "v"}: (n, B, max_len,
n_kv_heads, hd), "xk", "xv": (n, B, encoder_seq, n_kv_heads, hd)}`` in the
compute dtype (on one card ``ShardingCtx.kv_heads_eff`` is
``n_kv_heads``).  The port writes them in place and returns the same dict.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import (
    ParamDef,
    ParamDefs,
    _flatten,
    _init_one,
    cast_floats,
    cross_entropy,
    linear,
    mlp_defs,
    mlp_fwd,
    norm_defs,
    norm_fwd,
    stack_defs,
)
from repro_torch.models.transformer import (HeldWeights, _leaf,
                                            _params_module, _tree,
                                            head_logits)

# the reference's stacked unit leaves and the port's layer lists
_UNITS = {"enc_units": "enc_layers", "dec_units": "dec_layers"}


def sinusoid(positions, d_model: int):
    """(..., L) -> (..., L, d) sinusoidal embedding, float32.  The exponent
    is the reference's as XLA compiles it under jit: ``arange(half)``
    times the constant ``-ln(10_000) / max(half - 1, 1)`` rounded once to
    float32 (the same bits; the reference's exp then differs from
    PyTorch's in the last bit of some frequencies)."""
    half = d_model // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(i * (-math.log(10_000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def enc_layer_defs(cfg: ArchConfig) -> ParamDefs:
    return {
        "ln1": norm_defs(cfg.d_model, cfg.use_bias),
        "attn": attn.attn_defs(cfg),
        "ln2": norm_defs(cfg.d_model, cfg.use_bias),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_type, cfg.use_bias),
    }


def dec_layer_defs(cfg: ArchConfig) -> ParamDefs:
    return {
        "ln1": norm_defs(cfg.d_model, cfg.use_bias),
        "attn": attn.attn_defs(cfg),
        "lnx": norm_defs(cfg.d_model, cfg.use_bias),
        "xattn": attn.attn_defs(cfg, cross=True),
        "ln2": norm_defs(cfg.d_model, cfg.use_bias),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_type, cfg.use_bias),
    }


def encdec_defs(cfg: ArchConfig) -> ParamDefs:
    """The reference ``EncDec``'s stacked declaration of every
    parameter."""
    V, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": ParamDef((V, d), "small_normal"),
        "enc_units": stack_defs(enc_layer_defs(cfg), cfg.encoder_layers),
        "dec_units": stack_defs(dec_layer_defs(cfg), cfg.n_layers),
        "enc_norm": norm_defs(d, cfg.use_bias),
        "final_norm": norm_defs(d, cfg.use_bias),
        "lm_head": ParamDef((d, V), "small_normal"),
    }


class EncDec(HeldWeights):
    """Encoder-decoder model: an encoder stack over frame embeddings and a
    decoder stack with cross attention to its output."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name}: not an encoder-decoder config")
        dev = resolve_device(device)
        self.cfg = cfg
        self.cdt = getattr(torch, cfg.compute_dtype)
        self.pdt = getattr(torch, cfg.param_dtype)
        self.defs = encdec_defs(cfg)
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(torch.empty((V, d), dtype=self.pdt,
                                              device=dev))
        self.enc_layers = nn.ModuleList(
            _params_module(enc_layer_defs(cfg), self.pdt, dev)
            for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(
            _params_module(dec_layer_defs(cfg), self.pdt, dev)
            for _ in range(cfg.n_layers))
        self.enc_norm = _params_module(self.defs["enc_norm"], self.pdt, dev)
        self.final_norm = _params_module(self.defs["final_norm"], self.pdt,
                                         dev)
        self.lm_head = nn.Parameter(torch.empty((d, V), dtype=self.pdt,
                                                device=dev))

    # ---- params ------------------------------------------------------------

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "EncDec":
        """Fill every parameter from ``gen`` (draws on ``gen.device``), one
        draw per leaf of the reference's stacked declaration, in its order."""
        for path, d in _flatten(self.defs).items():
            value = _init_one(gen, d, self.pdt)
            if path[0] in _UNITS:
                for u, layer in enumerate(getattr(self, _UNITS[path[0]])):
                    _leaf(layer, path[1:]).copy_(value[u])
            else:
                _leaf(self, path).copy_(value)
        self.drop_cast()
        return self

    def _compute_params(self) -> dict:
        """``{"enc", "dec"}``: per-layer params in the compute dtype, and
        ``"head"``: ``lm_head`` in it; cast afresh while grad is enabled,
        else cast once and kept."""
        def cast():
            return {"enc": [cast_floats(_tree(l), self.cdt)
                            for l in self.enc_layers],
                    "dec": [cast_floats(_tree(l), self.cdt)
                            for l in self.dec_layers],
                    "head": self.lm_head.to(self.cdt)}
        if torch.is_grad_enabled():
            return cast()
        if self._cast is None:
            self._cast = cast()
        return self._cast

    def _stack(self, kind: str, unit, x, *args, remat=None):
        """``x`` through the ``kind`` (``"enc"`` / ``"dec"``) layers by
        ``unit(p, x, *args)``.  With grad each layer casts its own weights,
        under ``checkpoint`` when ``remat`` (default ``cfg.remat``)."""
        if not torch.is_grad_enabled():
            for p in self._compute_params()[kind]:
                x = unit(p, x, *args)
            return x
        cfg = self.cfg
        remat = cfg.remat if remat is None else remat
        if remat and cfg.remat_policy != "nothing":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} (the port remats with "
                "policy 'nothing'; ROADMAP A14b)")

        def run(x, layer, *args):
            return unit(cast_floats(_tree(layer), self.cdt), x, *args)

        for layer in self.enc_layers if kind == "enc" else self.dec_layers:
            if remat:
                x = checkpoint(run, x, layer, *args, use_reentrant=False)
            else:
                x = run(x, layer, *args)
        return x

    # ---- encoder -----------------------------------------------------------

    def _enc_unit(self, p, x, positions):
        eps = self.cfg.norm_eps
        h = norm_fwd(p["ln1"], x, eps)
        o, _ = attn.attention_fwd(p["attn"], h, self.cfg,
                                  positions=positions, causal=False,
                                  rope=False)
        x = x + o
        h = norm_fwd(p["ln2"], x, eps)
        return x + mlp_fwd(p["mlp"], h, self.cfg.mlp_type)

    def encode(self, frames):
        """Frame embeddings (B, T, d) -> the encoder output (B, T, d) in
        the compute dtype."""
        cfg = self.cfg
        B, T, _ = frames.shape
        pos = torch.arange(T, device=frames.device).expand(B, T)
        x = frames.to(self.cdt) + sinusoid(pos, cfg.d_model).to(self.cdt)
        x = self._stack("enc", self._enc_unit, x, pos)
        return norm_fwd(self.enc_norm, x, cfg.norm_eps)

    # ---- decoder -----------------------------------------------------------

    def _dec_unit(self, p, x, positions, enc_out=None, cache=None,
                  cache_index=None):
        """One decoder layer: ``(x, cache or None)``.  Without a cache the
        cross attention projects K / V from ``enc_out``; with one (this
        layer's slice) it reads ``cache["xk"]`` / ``["xv"]`` and the self
        attention writes its K / V in place."""
        cfg = self.cfg
        h = norm_fwd(p["ln1"], x, cfg.norm_eps)
        o, _ = attn.attention_fwd(
            p["attn"], h, cfg, positions=positions, rope=False,
            cache=None if cache is None else cache["attn"],
            cache_index=cache_index)
        x = x + o
        h = norm_fwd(p["lnx"], x, cfg.norm_eps)
        if cache is None:
            o, _ = attn.attention_fwd(p["xattn"], h, cfg,
                                      positions=positions, causal=False,
                                      rope=False, kv_x=enc_out,
                                      kv_positions=torch.zeros_like(
                                          positions))
        else:
            B, L, _ = h.shape
            hq, hd = cfg.n_heads, cfg.head_dim
            q = linear(h, p["xattn"]["wq"], p["xattn"].get("bq")) \
                .reshape(B, L, hq, hd)
            xk, xv = cache["xk"], cache["xv"]
            if L == 1:
                o = attn.decode_attention(q, xk, xv, xk.shape[1])
            else:
                o = attn.blocked_attention(q, xk, xv, causal=False)
            o = linear(o.reshape(B, L, hq * hd), p["xattn"]["wo"],
                       p["xattn"].get("bo"))
        x = x + o
        h = norm_fwd(p["ln2"], x, cfg.norm_eps)
        return x + mlp_fwd(p["mlp"], h, cfg.mlp_type), cache

    def decode_stack(self, x, positions, enc_out=None, cache=None,
                     cache_index=None, remat=None):
        """The decoder layers: ``(x, cache or None)``.  Without a cache,
        over ``enc_out`` (with grad, remat as :meth:`_stack`); with one,
        each layer's slice written in place at ``cache_index``."""
        if cache is None:
            x = self._stack(
                "dec", lambda p, x, pos, e: self._dec_unit(p, x, pos, e)[0],
                x, positions, enc_out, remat=remat)
            return x, None
        for i, p in enumerate(self._compute_params()["dec"]):
            c = {"attn": {k: t[i] for k, t in cache["attn"].items()},
                 "xk": cache["xk"][i], "xv": cache["xv"][i]}
            x, _ = self._dec_unit(p, x, positions, cache=c,
                                  cache_index=cache_index)
        return x, cache

    # ---- entry points ------------------------------------------------------

    def _logits(self, x):
        head = self.lm_head.to(self.cdt) if torch.is_grad_enabled() \
            else self._compute_params()["head"]
        return head_logits(self.final_norm, x, head, self.cfg)

    def _embed_text(self, tokens, positions):
        return self._embed(tokens) + \
            sinusoid(positions, self.cfg.d_model).to(self.cdt)

    def loss_fn(self, batch):
        """Token-mean cross entropy (z-loss 1e-4) of ``batch["tokens"]``
        (B, L+1) given ``batch["frames"]`` (B, T, d): decoder inputs
        ``[:, :-1]``, labels ``[:, 1:]``.  Returns ``(loss, {"ce"})``;
        differentiable while grad is enabled."""
        enc_out = self.encode(batch["frames"])
        tokens = batch["tokens"]
        B, L = tokens.shape[0], tokens.shape[1] - 1
        pos = torch.arange(L, device=tokens.device).expand(B, L)
        x = self._embed_text(tokens[:, :-1], pos)
        x, _ = self.decode_stack(x, pos, enc_out)
        loss = cross_entropy(self._logits(x), tokens[:, 1:])
        return loss, {"ce": loss}

    def build_cross_cache(self, enc_out, out=None):
        """Every decoder layer's cross K / V of ``enc_out``, stacked ``(n,
        B, T, n_kv_heads, hd)`` in the compute dtype; written into ``out =
        (xk, xv)`` when given."""
        cfg = self.cfg
        B, T, _ = enc_out.shape
        hkv, hd = cfg.n_kv_heads, cfg.head_dim
        layers = self._compute_params()["dec"]
        if out is None:
            out = tuple(torch.empty((len(layers), B, T, hkv, hd),
                                    dtype=self.cdt, device=enc_out.device)
                        for _ in range(2))
        xk, xv = out
        for i, p in enumerate(layers):
            xk[i] = linear(enc_out, p["xattn"]["wk"], p["xattn"].get("bk")) \
                .reshape(B, T, hkv, hd)
            xv[i] = linear(enc_out, p["xattn"]["wv"], p["xattn"].get("bv")) \
                .reshape(B, T, hkv, hd)
        return xk, xv

    @torch.no_grad()
    def decode_step(self, token, pos: int, cache):
        """token (B, 1) int; ``pos`` the cache slot (and position) of this
        token.  Returns (logits (B, Vp), cache), the cache updated in
        place."""
        B = token.shape[0]
        positions = torch.full((B, 1), int(pos), device=token.device)
        x = self._embed_text(token, positions)
        x, cache = self.decode_stack(x, positions, cache=cache,
                                     cache_index=int(pos))
        return self._logits(x)[:, 0], cache

    @torch.no_grad()
    def prefill(self, batch, cache=None):
        """Encode ``batch["frames"]`` and run the teacher-forced prefix
        ``batch["tokens"]`` (B, L): logits for the LAST position (B, Vp),
        and with ``cache`` the cache filled (the cross K / V of every
        layer, self K / V from slot 0).  Returns (logits, cache or None)."""
        enc_out = self.encode(batch["frames"])
        tokens = batch["tokens"]
        B, L = tokens.shape
        pos = torch.arange(L, device=tokens.device).expand(B, L)
        x = self._embed_text(tokens, pos)
        if cache is None:
            x, _ = self.decode_stack(x, pos, enc_out, remat=False)
            return self._logits(x[:, -1:])[:, 0], None
        self.build_cross_cache(enc_out, out=(cache["xk"], cache["xv"]))
        x, cache = self.decode_stack(x, pos, cache=cache, cache_index=0)
        return self._logits(x[:, -1:])[:, 0], cache

    # ---- caches ------------------------------------------------------------

    def cache_shapes(self, batch: int, max_len: int):
        cfg = self.cfg
        n, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        shp = (n, batch, max_len, hk, hd)
        xshp = (n, batch, cfg.encoder_seq, hk, hd)
        return {"attn": {"k": TensorSpec(shp, self.cdt),
                         "v": TensorSpec(shp, self.cdt)},
                "xk": TensorSpec(xshp, self.cdt),
                "xv": TensorSpec(xshp, self.cdt)}

    def init_cache(self, batch: int, max_len: int):
        def zeros(s):
            return torch.zeros(s.shape, dtype=s.dtype, device=self.device)
        shapes = self.cache_shapes(batch, max_len)
        return {"attn": {k: zeros(s) for k, s in shapes["attn"].items()},
                "xk": zeros(shapes["xk"]), "xv": zeros(shapes["xv"])}
