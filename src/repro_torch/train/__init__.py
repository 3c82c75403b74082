"""Training on one card: ``TrainConfig``, ``make_train_step`` and the
fault-tolerant ``Trainer`` (counterparts of ``repro.train``)."""
from repro_torch.train.trainer import TrainConfig, Trainer, make_train_step

__all__ = ["TrainConfig", "Trainer", "make_train_step"]
