"""Compute policy: the ambient optimization knobs of the model code.

Counterpart of ``repro.models.policy``, with the same stack, fields and
defaults.
The policy is ambient (a module-level stack read when a layer runs), so a
caller flips a regime without threading arguments through every model
signature:

  * ``flash_block``: 0 = eager full-score SDPA (materializes (B,H,S,T)
    scores); >0 = KV-chunked online-softmax attention over chunks of that
    many keys, never materializing the score matrix;
  * ``explicit_ep``: expert parallelism over the ambient mesh's ``model``
    axis (``models.moe._routed_mesh``: each model column routes its dp shard's
    tokens to its E/TP local experts, K6 ranking the foreign ones into a
    trash bucket, and one sum all-reduce over ``model`` adds the columns);
    without a mesh (``layers.ambient_mesh``), or where ``model`` does not
    divide E, ``moe_ffn`` takes the baseline dispatch, as the reference
    does;
  * ``flash_decode``: decode on a linear cache through the K10 kernel
    (``kernels.flash_decode``), reading the cache in place.

Used with::

    with compute_policy(flash_decode=True):
        tokens = engine.generate(prompts, 32)
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Iterator, List

__all__ = ["ComputePolicy", "compute_policy", "current_policy"]


@dataclass(frozen=True)
class ComputePolicy:
    flash_block: int = 0
    explicit_ep: bool = False
    flash_decode: bool = False   # K10 fused decode kernel (linear cache)


_STACK: List[ComputePolicy] = [ComputePolicy()]


def current_policy() -> ComputePolicy:
    return _STACK[-1]


@contextmanager
def compute_policy(**kw) -> Iterator[ComputePolicy]:
    pol = replace(_STACK[-1], **kw)
    _STACK.append(pol)
    try:
        yield pol
    finally:
        _STACK.pop()
