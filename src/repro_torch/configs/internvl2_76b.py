"""internvl2-76b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

The ViT frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch/token embeddings (B, S, d_model); only the 80-layer
InternLM2 transformer backbone is modelled.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    frontend="vit_stub",
    sub_quadratic=False,
)
