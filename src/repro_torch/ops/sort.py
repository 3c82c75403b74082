"""NaN-safe full sort and argsort on top of the IPS4o engine.

Counterpart of ``repro.ops.sort``: biject the keys into the ordered
keyspace (``ops.keyspace``), run ``ips4o_sort`` there, and decode.  NaNs
sort last, -0.0 before +0.0, and equal keys keep their input order.
``classifier`` ("tree" | "radix" | "learned" | "auto") overrides
``cfg.classifier`` for one call; "auto" is resolved here, against the
caller's (n, dtype), by the plan cache's raced winners (``with_engine``).

``sort_records`` / ``argsort_records`` sort multi-word keys (strings and
composite records as ``keyspace.encode_words`` words, or any (n, W) matrix
of a keyspace dtype): each word column is encoded, word 0 is sorted and
the runs that tie are re-sorted word by word (``core.ips4o.tiebreak_passes``).

``sort`` and ``argsort`` encode and pad in one pass (the G5 kernel,
``kernels.codec``: the codes, the sentinel tail and the index payload) and
hand the padded arrays to ``core.ips4o.sort_padded``; the sorted codes come
back through G5's decode.

Every entry point takes ``device=None``, which means ``"cuda"``: the
kernels run on the card.  ``device="cpu"`` runs the kernels' plain twins
(the tests do).  With no card and no ``device="cpu"`` they raise; they
never carry on quietly on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch import obs
from repro_torch.classify import resolve_classifier
from repro_torch.core.ips4o import (
    SortConfig,
    _pad_to,
    _payload,
    padded_length,
    signed_payload,
    sort_padded,
    sort_padded_batched,
    tiebreak_passes,
)
from repro_torch.kernels import codec
from repro_torch.ops import keyspace

__all__ = ["sort", "argsort", "sort_records", "argsort_records", "with_engine"]

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


def _dtype_name(dtype: torch.dtype) -> str:
    """The reference's spelling of a dtype in span attributes ("float32")."""
    return str(dtype).removeprefix("torch.")


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


def padded_codes(keys: torch.Tensor, cfg: SortConfig, index: bool = False,
                 complement: bool = False):
    """(codes, index or None, n_pad): ``keys`` (n,) or (B, n) encoded and
    padded in one G5 launch to the pipeline's length (n itself when there
    is nothing to sort: n <= 1 or no row), with the int32 index payload
    when ``index`` and the complemented codes when ``complement``.  int32
    and int64 keys that need no pad, index or complement are their own
    codes: no launch, no copy (the pipeline never writes its input)."""
    n = keys.shape[-1]
    rows = keys.shape[0] if keys.dim() == 2 else 1
    n_pad = n if n <= 1 or rows == 0 else padded_length(n, max(cfg.base_case, cfg.tile))
    if (n_pad == n and not index and not complement
            and keys.dtype in (torch.int32, torch.int64)):
        return keys, None, n_pad
    codes, idx = codec.encode_padded(keys, n_pad, index, complement)
    return codes, idx, n_pad


def sorted_codes(keys: torch.Tensor, cfg: SortConfig, values: Any = None, index: bool = False):
    """The IPS4o pipeline on (n,) or (B, n) keys of any keyspace dtype from
    G5's padded codes: (the sorted padded codes, the sorted padded index or
    None, the rebuilt ``values`` or None).  The ``ops`` entry points' one
    path into ``core.ips4o``."""
    codes, idx, n_pad = padded_codes(keys, cfg, index)
    n = keys.shape[-1]
    if n <= 1 or keys.numel() == 0:  # nothing to sort: the values as they came
        return codes, idx, values
    arrays = {"k": codes}
    if idx is not None:
        arrays["idx"] = idx
    del codes, idx  # the passes free each array once they have moved it
    rebuild = None
    if values is not None:
        payload, rebuild = _payload(values, keys)
        arrays.update(_pad_to(payload, n_pad, keys.dim() - 1))
    arrays = (sort_padded if keys.dim() == 1 else sort_padded_batched)(arrays, n, cfg)
    return arrays["k"], arrays.get("idx"), None if rebuild is None else rebuild(arrays, n)


def _override(cfg: SortConfig, engine: Optional[str], classifier: Optional[str],
              n: Optional[int] = None, dtype=None, batch: Optional[int] = None) -> SortConfig:
    """``with_engine`` for 1-D and batched callers: ``classifier`` in place of
    the config's, and "auto" resolved against (n, dtype[, batch]) if given."""
    if engine is not None:
        raise ValueError(f"engine={engine!r}: the port has no engine switch; its kernels "
                         "always run on the card (pass engine=None)")
    if classifier is not None:
        cfg = dataclasses.replace(cfg, classifier=classifier)
    if n is not None and cfg.classifier == "auto":
        cfg = dataclasses.replace(cfg, classifier=resolve_classifier("auto", n, dtype, batch))
    resolve_classifier(cfg.classifier)  # raises for an unknown classifier
    return cfg


def with_engine(
    cfg: SortConfig,
    engine: Optional[str] = None,
    keys: Optional[torch.Tensor] = None,
    classifier: Optional[str] = None,
) -> SortConfig:
    """``cfg`` with ``classifier`` in place of ``cfg.classifier`` (None
    keeps it).  When ``keys`` is given, "auto" is resolved here, against
    the caller's (n, dtype), which is what the plan cache keys its raced
    winners under: deeper layers see the encoded dtype and the padded n.

    ``engine`` must be None: the port has no engine switch, its kernels
    always run on the card (ROADMAP.md, queue 3).

    >>> with_engine(SortConfig(), None, classifier="radix").classifier
    'radix'
    """
    if keys is None:
        return _override(cfg, engine, classifier)
    return _override(cfg, engine, classifier, keys.shape[-1], keys.dtype)


def sort(
    keys,
    values: Any = None,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
):
    """Sort ``keys`` ascending (NaNs last, -0.0 before +0.0), optionally
    moving a ``values`` pytree (leaves with leading dim n) alongside.

    >>> sort(torch.tensor([3.0, 1.0, 2.0]), device="cpu").tolist()
    [1.0, 2.0, 3.0]
    >>> k, v = sort(torch.tensor([2, 1]), {"tag": torch.tensor([20, 10])}, device="cpu")
    >>> (k.tolist(), v["tag"].tolist())
    ([1, 2], [10, 20])
    """
    dev = _device(device)
    keys = _keys(keys, dev)
    cfg = with_engine(cfg, None, keys, classifier)
    n = keys.shape[0]
    with obs.trace("ops.sort", n=n, dtype=_dtype_name(keys.dtype)):
        codes, _, vs = sorted_codes(keys, cfg, values)
        out = keyspace.decode(codes[:n], keys.dtype)
        if values is not None:
            out = (out, vs)
        obs.block(out)  # obs enabled: the span's host time covers the card's work
    return out


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
    if n <= 1:
        return torch.arange(n, dtype=torch.int32, device=dev)
    cfg = with_engine(cfg, None, keys, classifier)
    with obs.trace("ops.argsort", n=n, dtype=_dtype_name(keys.dtype)):
        _, order, _ = sorted_codes(keys, cfg, index=True)
        order = order[:n]
        obs.block(order)
    return order


def _words(words, dev: torch.device) -> torch.Tensor:
    words = torch.as_tensor(words, device=dev)
    if words.dim() != 2:
        raise ValueError("words must be 2-D (n, W)")
    if words.shape[1] == 0:
        raise ValueError("words must have at least one word column")
    keyspace.encoded_dtype(words.dtype)  # raises for dtypes with no order-preserving code
    return words


def _record_cols(words: torch.Tensor):
    return [keyspace.encode(words[:, j].contiguous()) for j in range(words.shape[1])]


def sort_records(
    words,
    values: Any = None,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
):
    """Sort multi-word records (n, W) into row-lexicographic order, stably.

    ``words`` is each record's fixed-width word decomposition, usually
    ``keyspace.encode_words`` output (uint32, word 0 most significant), or
    any keyspace dtype (each column is encoded, so float words order with
    NaNs last and -0.0 before +0.0; 64-bit columns run the 64-bit
    kernels).  The permutation is ``np.lexsort``'s over the columns.  A
    ``values`` pytree (leaves with leading dim n) moves alongside;
    ``classifier`` holds for every tie-break pass.

    >>> w = torch.tensor([[1, 9], [0, 5], [1, 2]], dtype=torch.int32)
    >>> sort_records(w, device="cpu").tolist()
    [[0, 5], [1, 2], [1, 9]]
    """
    dev = _device(device)
    words = _words(words, dev)
    if words.shape[0] <= 1:
        return words if values is None else (words, values)
    cfg = with_engine(cfg, None, words[:, 0], classifier)
    cols, vals = tiebreak_passes(_record_cols(words), values, cfg=cfg)
    # stacked as the signed dtype of the words' width: torch's unsigned
    # dtypes past 8 bits are not taken by every kernel
    out = torch.stack([signed_payload(keyspace.decode(c, words.dtype)) for c in cols],
                      dim=1).view(words.dtype)
    return out if values is None else (out, vals)


def argsort_records(
    words,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
) -> torch.Tensor:
    """Stable lexicographic argsort (int32) of multi-word records (n, W):
    ``words[argsort_records(words)]`` is row-sorted, ties keep their input
    order, and the permutation is ``np.lexsort``'s over the word columns
    (word 0 most significant).

    >>> w = torch.tensor([[1, 9], [0, 5], [1, 2]], dtype=torch.int32)
    >>> argsort_records(w, device="cpu").tolist()
    [1, 2, 0]
    """
    dev = _device(device)
    words = _words(words, dev)
    n = words.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if n <= 1:
        return idx
    cfg = with_engine(cfg, None, words[:, 0], classifier)
    _, order = tiebreak_passes(_record_cols(words), idx, cfg=cfg)
    return order
