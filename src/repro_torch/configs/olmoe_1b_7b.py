"""OLMoE-1B-7B: 64 experts, top-8, expert ff=1024 [arXiv:2409.02060]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoECfg

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    qk_norm=True,
    mlp_type="swiglu",
    moe=MoECfg(n_experts=64, top_k=8, d_expert=1024, every=1),
    pattern_unit=(LayerSpec("attn", moe=True),),
)
