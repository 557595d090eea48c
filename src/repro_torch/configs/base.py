"""Architecture configs: the 10 assigned LM-family archs + shape grid.

Every config is exact per the assignment table (public-literature values);
``reduce()`` derives the same-family smoke config (small layers/width/
experts/vocab) used by CPU tests.  The FULL configs are exercised only via
the dry-run (ShapeDtypeStruct lowering, no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int              # expert hidden dim
    shared_expert: bool = False
    capacity_factor: float = 1.25
    every: int = 1             # MoE FFN on layers where (i % every == every-1)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                  # "attn" | "mamba" | "rwkv"
    moe: bool = False          # MoE FFN instead of dense on this layer


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    use_bias: bool = False
    mlp_type: str = "swiglu"   # swiglu | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoECfg] = None
    pattern_unit: Tuple[LayerSpec, ...] = (LayerSpec("attn"),)

    # enc-dec (whisper): encoder layers with full attention + cross-attn decoder
    encoder_layers: int = 0
    encoder_seq: int = 1500    # precomputed frame embeddings (stub frontend)

    # vlm (internvl): prefix patch embeddings from the stubbed ViT
    prefix_tokens: int = 0     # e.g. 256 visual tokens per image

    # mamba (jamba) dims
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_scan_dtype: str = "float32"   # bf16 halves SSM chunk traffic
    # rwkv dims
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs:
                                    # no recompute psums in bwd, more memory)

    # ---- derived ---------------------------------------------------------

    @property
    def n_units(self) -> int:
        assert self.n_layers % len(self.pattern_unit) == 0, self.name
        return self.n_layers // len(self.pattern_unit)

    @property
    def padded_vocab(self) -> int:
        """Pad to a multiple of 128 (MXU lanes x TP=16 divisibility)."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def d_inner_mamba(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: token mixing without a full-attention
        KV-vs-seq quadratic prefill (SSM / linear-attention / hybrid)."""
        return any(s.kind in ("mamba", "rwkv") for s in self.pattern_unit)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def reduce(self) -> "ArchConfig":
        """Same-family smoke config: tiny dims, same layer pattern."""
        moe = None
        if self.moe is not None:
            # generous capacity so tiny-config tests see no routing drops
            moe = dataclasses.replace(self.moe, n_experts=4,
                                      top_k=min(2, self.moe.top_k),
                                      d_expert=64, capacity_factor=8.0)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * len(self.pattern_unit),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab=512,
            moe=moe,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=16 if self.encoder_layers else self.encoder_seq,
            prefix_tokens=8 if self.prefix_tokens else 0,
            rwkv_head_dim=16,
            rwkv_decay_lora=8,
            mamba_d_state=8,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic token mixing."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "skip(full-attn)"
    return True, ""
