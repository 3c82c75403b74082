"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  54 Mamba2 layers; ONE shared attention block (single
param set) applied after every 6 SSM layers.  Sub-quadratic (the shared
attention runs a 4k sliding window for long contexts) -> long_500k RUNS.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                  head_dim=64, attn_every=6),
    sub_quadratic=True,
)
