"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  The EnCodec frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    frontend="encodec_stub",
    sub_quadratic=False,
)
