"""InternVL2-26B LM backbone (InternLM2-20B) [arXiv:2404.16821; hf].

[vlm]: the InternViT-6B vision frontend is a STUB — the batch of
``launch.steps.input_specs()`` carries ``prefix_embeds``, precomputed patch
embeddings (256 visual tokens) that ``LM.loss_fn`` / ``LM.prefill`` put
before the text sequence; the transformer backbone below is modeled in
full.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    pattern_unit=(LayerSpec("attn"),),
    prefix_tokens=256,
)
