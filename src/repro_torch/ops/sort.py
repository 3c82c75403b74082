"""NaN-safe full sort and argsort on top of the IPS4o engine.

Counterpart of ``repro.ops.sort``'s ``sort`` and ``argsort``: biject the
keys into the ordered keyspace (``ops.keyspace``), run ``ips4o_sort``
there, and decode.  NaNs sort last, -0.0 before +0.0, and equal keys keep
their input order.  ``classifier`` ("tree" | "radix") overrides
``cfg.classifier`` for one call.

Both take ``device=None``, which means ``"cuda"``: the kernels run on the
card.  ``device="cpu"`` runs the kernels' plain twins (the tests do).  With
no card and no ``device="cpu"`` they raise; they never carry on quietly on
the CPU.  The records entry points (``sort_records``, ``argsort_records``)
and ``with_engine`` are not ported yet (ROADMAP.md, queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch import obs
from repro_torch.core.ips4o import SortConfig, ips4o_sort
from repro_torch.ops import keyspace

__all__ = ["sort", "argsort"]

Device = Union[str, torch.device, None]


def _device(device: Device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' for the plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _keys(keys, dev: torch.device, dim: int = 1) -> torch.Tensor:
    keys = torch.as_tensor(keys, device=dev)
    if keys.dim() != dim:
        raise ValueError(
            "keys must be 1-D; (B, n) rows go to ops.batched_sort / "
            "batched_argsort / batched_topk / batched_bottomk"
            if dim == 1 else "keys must be 2-D (B, n)"
        )
    keyspace.encoded_dtype(keys.dtype)  # raises for dtypes with no order-preserving code
    return keys


def _with_classifier(cfg: SortConfig, classifier: Optional[str]) -> SortConfig:
    """``cfg`` with ``classifier`` in place of ``cfg.classifier`` (None
    keeps it): the classifier half of the reference's ``with_engine``; the
    port has no engine to pick."""
    return cfg if classifier is None else dataclasses.replace(cfg, classifier=classifier)


def sort(
    keys,
    values: Optional[torch.Tensor] = None,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
):
    """Sort ``keys`` ascending (NaNs last, -0.0 before +0.0), optionally
    moving a ``values`` tensor (leading dim n) alongside.

    >>> sort(torch.tensor([3.0, 1.0, 2.0]), device="cpu").tolist()
    [1.0, 2.0, 3.0]
    """
    dev = _device(device)
    keys = _keys(keys, dev)
    cfg = _with_classifier(cfg, classifier)
    with obs.trace("ops.sort", n=keys.shape[0], dtype=str(keys.dtype)):
        enc = keyspace.encode(keys)
        if values is None:
            return keyspace.decode(ips4o_sort(enc, cfg=cfg), keys.dtype)
        if not isinstance(values, torch.Tensor):
            raise NotImplementedError(
                "values must be one tensor with leading dim n (ROADMAP.md, "
                "queue 1 item 7)"
            )
        k, vs = ips4o_sort(enc, values.to(dev), cfg=cfg)
        return keyspace.decode(k, keys.dtype), vs


def argsort(
    keys,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
) -> torch.Tensor:
    """Indices (int32) that sort ``keys`` ascending, stably: equal keys keep
    their input order, so the result equals a stable argsort in the
    keyspace order.

    >>> argsort(torch.tensor([30.0, 10.0, 20.0]), device="cpu").tolist()
    [1, 2, 0]
    """
    dev = _device(device)
    keys = _keys(keys, dev)
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if n <= 1:
        return idx
    cfg = _with_classifier(cfg, classifier)
    with obs.trace("ops.argsort", n=n, dtype=str(keys.dtype)):
        _, order = ips4o_sort(keyspace.encode(keys), idx, cfg=cfg)
    return order
