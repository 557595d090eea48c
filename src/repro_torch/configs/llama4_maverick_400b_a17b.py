"""Llama-4-Maverick 400B-A17B: MoE 128e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4 family; unverified].

Maverick interleaves dense and MoE FFN layers (every=2) and adds a shared
expert on MoE layers; active params ~17B per token.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoECfg

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    qk_norm=True,
    mlp_type="swiglu",
    rope_theta=500_000.0,
    moe=MoECfg(n_experts=128, top_k=1, d_expert=8192, shared_expert=True,
               every=2),
    pattern_unit=(LayerSpec("attn", moe=False), LayerSpec("attn", moe=True)),
)
