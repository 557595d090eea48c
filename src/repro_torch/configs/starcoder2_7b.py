"""StarCoder2-7B: GQA kv=4, RoPE, biased projections, GELU MLP
[arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    use_bias=True,
    mlp_type="gelu",
    rope_theta=1_000_000.0,
    pattern_unit=(LayerSpec("attn"),),
)
