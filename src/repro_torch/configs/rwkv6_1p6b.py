"""rwkv6-1.6b [ssm] — "Finch", attention-free, data-dependent decay
[arXiv:2404.05892].  Sub-quadratic -> long_500k RUNS."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,        # derived: d_model / head_dim (time-mix heads)
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    sub_quadratic=True,
)
