"""RWKV6-3B "Finch": attention-free, data-dependent decay [arXiv:2404.05892].

The paper's halo-exchange technique is inapplicable to its token mixing
(O(1) recurrent state, no KV halo) — see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=8960,
    vocab=65536,
    head_dim=64,
    mlp_type="gelu",        # channel-mix uses squared-relu internally
    pattern_unit=(LayerSpec("rwkv"),),
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
)
