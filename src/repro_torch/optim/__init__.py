"""The optimizer of the port's trainer: AdamW with memory-tiered moments,
int8 gradient compression with error feedback, and the LR schedules
(counterparts of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import (
    compress_grads, decompress_grads, init_error_feedback,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "linear_warmup_cosine",
    "compress_grads",
    "decompress_grads",
    "init_error_feedback",
]
