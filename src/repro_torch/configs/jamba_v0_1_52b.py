"""Jamba-v0.1-52B: Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

Pattern unit = 8 layers with attention at position 4 (1:7 attn:mamba) and
MoE FFN on every second layer (odd positions), 4 units = 32 layers.

One card trains it cut to one card's part of a deployment of 8 GPUs with
expert parallelism over them (``chip_smoke.py`` phase 22): one 8-layer
unit of the 4 (one period of the layer pattern is the whole unit, so no
cut in depth is smaller); every MoE layer as expert share 0/8 (2 of the 16
experts held, every token routed over all 16, no exchange:
``build_model(cfg, expert_share=(0, 8))``); every width as published; the
vocabulary whole.  That is 3,430,232,064 parameters, 54.9 GB of float32
parameters, gradients and AdamW moments; the whole unit is 13.3 B (213 GB).
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
