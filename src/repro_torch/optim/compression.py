"""Gradient compression for the data-parallel reduction: int8 with error
feedback.

Counterpart of ``repro.optim.compression``: each leaf is quantized to int8
with a float32 scale (``max |x| / 127``), and the quantization residual is
carried to the next step, so the compression is unbiased over time.  The
trees are those of ``optim.adamw``: a dict from a leaf's name to a tensor
or to a tuple of tensors (a leaf the reference stacks over layers), and a
tuple takes one scale over all its tensors, as the reference's stacked
array does.  On one card there is no reduction to shrink; the trainer
applies it where the reference does, right before the optimizer, so a run
with it on is the same computation as the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.optim.adamw import Leaf, _like, _parts, _quantize

__all__ = ["init_error_feedback", "compress_grads", "decompress_grads"]


def init_error_feedback(grads: Mapping[str, Leaf]) -> Dict[str, Leaf]:
    """Float32 zeros congruent to ``grads``."""
    return {k: _like(g, [torch.zeros_like(t, dtype=torch.float32) for t in _parts(g)])
            for k, g in grads.items()}


@torch.no_grad()
def compress_grads(grads: Mapping[str, Leaf], err: Mapping[str, Leaf]
                   ) -> Tuple[Dict[str, Any], Dict[str, Leaf]]:
    """Returns (the compressed ``{"q", "scale"}`` tree, the new error
    feedback)."""
    comp, new_err = {}, {}
    for k, g in grads.items():
        xs = [t.to(torch.float32) + e for t, e in zip(_parts(g), _parts(err[k]))]
        qs, scale = _quantize(xs)
        comp[k] = {"q": _like(g, qs), "scale": scale}
        new_err[k] = _like(g, [x - q.to(torch.float32) * scale for x, q in zip(xs, qs)])
    return comp, new_err


def decompress_grads(comp: Mapping[str, Any], like: Mapping[str, Leaf]) -> Dict[str, Leaf]:
    """Float32 gradients from the compressed tree, in ``like``'s structure."""
    return {k: _like(g, [q.to(torch.float32) * comp[k]["scale"]
                         for q in _parts(comp[k]["q"])]) for k, g in like.items()}
