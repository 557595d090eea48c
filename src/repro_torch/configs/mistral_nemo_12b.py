"""Mistral-Nemo-12B, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

head_dim is 128 (q projection 4096-wide), decoupled from d_model/n_heads.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    pattern_unit=(LayerSpec("attn"),),
)
