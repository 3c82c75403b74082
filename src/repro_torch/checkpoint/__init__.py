"""repro_torch.checkpoint: atomic, sharded, restorable checkpoints of
per-rank state (``CheckpointManager``), the counterpart of
``repro.checkpoint``."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
