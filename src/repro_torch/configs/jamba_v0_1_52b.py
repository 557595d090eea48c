"""Jamba-v0.1-52B: Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

Pattern unit = 8 layers with attention at position 4 (1:7 attn:mamba) and
MoE FFN on every second layer (odd positions), 4 units = 32 layers.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoECfg

_UNIT = tuple(
    LayerSpec("attn" if i == 4 else "mamba", moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    mlp_type="swiglu",
    moe=MoECfg(n_experts=16, top_k=2, d_expert=14336, every=2),
    pattern_unit=_UNIT,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)
