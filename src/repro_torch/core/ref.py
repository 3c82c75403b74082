"""Plain torch oracles for the sorting library (counterpart of
``repro.core.ref``).  ``ref_sort`` is stable, so payload association is
deterministic."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["ref_sort", "ref_partition"]


def ref_sort(keys: torch.Tensor, values: Optional[torch.Tensor] = None):
    """Stable oracle sort.  Returns keys or (keys, values)."""
    out = torch.sort(keys, stable=True)
    if values is None:
        return out.values
    return out.values, values[out.indices]


def ref_partition(
    bucket: torch.Tensor, arrays: Dict[str, torch.Tensor], nb: int
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Stable bucket-grouping oracle (counting sort via stable argsort)."""
    order = torch.sort(bucket, stable=True).indices
    out = {name: a[order] for name, a in arrays.items()}
    hist = torch.bincount(bucket.to(torch.int64), minlength=nb)
    offsets = torch.zeros(nb + 1, dtype=torch.int32, device=bucket.device)
    offsets[1:] = torch.cumsum(hist, 0)
    return out, offsets
