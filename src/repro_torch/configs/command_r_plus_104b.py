"""Command-R+ 104B: GQA, no biases [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    use_bias=False,
    mlp_type="swiglu",
    rope_theta=75_000_000.0,
    pattern_unit=(LayerSpec("attn"),),
)
