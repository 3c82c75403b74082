"""LR schedules (pure functions of the step counter).

Counterpart of ``repro.optim.schedule``: ``step`` is a 0-d integer tensor
(the optimizer's counter) and the result a float32 0-d tensor on its
device, computed in float32 as the reference computes it.
"""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def cosine_schedule(step: torch.Tensor, total_steps: int, final_frac: float = 0.1
                    ) -> torch.Tensor:
    t = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
    return final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))


def linear_warmup_cosine(step: torch.Tensor, warmup: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    w = torch.clamp(step.to(torch.float32) / max(warmup, 1), 0.0, 1.0)
    return w * cosine_schedule(torch.clamp(step - warmup, min=0),
                               max(total_steps - warmup, 1), final_frac)
