"""Whisper-small enc-dec backbone [arXiv:2212.04356].

[audio]: the conv/mel frontend is a STUB — ``input_specs()`` provides
precomputed frame embeddings (1500 x d_model) to the encoder.  12 encoder +
12 decoder layers, MHA (kv == heads), GELU, biases, learned positions
(modeled as RoPE-free absolute embeddings).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,            # decoder layers
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    use_bias=True,
    mlp_type="gelu",
    pattern_unit=(LayerSpec("attn"),),
)
