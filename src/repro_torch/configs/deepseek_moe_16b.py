"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed top-6,
d_ff_expert=1408 [arXiv:2401.06066].  MoE dispatch = the paper's sort-based
distribution machinery (DESIGN.md §3)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared=2, d_ff_shared=2816),
    sub_quadratic=False,
)
