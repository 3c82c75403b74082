"""G7: the one-device sort's robustness fallback on the card, with no host read.

The reference decides its fallback on the device (``bucket_violations``,
``src/repro/core/ips4o.py:499``, and the ``lax.cond`` at ``:540``, batched
``:836``) and sorts the whole array with XLA; these kernels are no TPU
kernel's counterpart.  The CUDA source is ``csrc/fallback.cu``, whose header
note gives their bound (bytes) and design.  The port sorts only what needs
it: every non-trivial bucket (even id, not the pad bucket, starting below
``limit``) of more than W/2 keys, stably by key and in place; nothing else
moves.

- :func:`oversized_list` (``fallback_list``, one launch): each row's list of
  oversized buckets, their count, the largest size and the verdict, on the
  device; :func:`verdict` views the verdict as a 0-d tensor, read by nobody
  unless obs is enabled.
- :func:`sort_listed` (``fallback_sort``, one launch for up to
  :data:`MAX_ARRAYS` = 128 arrays, one more a further 128): the
  listed buckets cut into chunks of :data:`CHUNK` keys sorted in shared
  memory, merged pairwise by merge path with a grid barrier between rounds
  (as many as the largest size needs, read on the device), then every array
  moved by the order through a scratch the host sizes from n (8 B a key).
  With the keys as the only array the keys themselves are merged (equal keys
  are equal bits), through a scratch of one key a position.  An empty list
  returns at once.
- :func:`sort_oversized`: both, the fallback of ``core.ips4o``; on a CPU
  tensor its plain twin, :func:`sort_oversized_plain` (the port's eager
  chain: a host read of the verdict, a gather of the bucket mask, ``nonzero``,
  an int64 sort and ``flat[pos] = flat[src]``).

Each wrapper launches its kernel on a CUDA tensor (or raises), and on the
dry run's fake tensors launches nothing and reports its bytes to
``_build.FAKE_HOOKS``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.glue import move_unit

__all__ = [
    "CHUNK",
    "MAX_ARRAYS",
    "capacity",
    "meta_words",
    "oversized_list",
    "oversized_list_plain",
    "verdict",
    "sort_listed",
    "sort_oversized",
    "sort_oversized_plain",
    "oversized_mask",
    "launch_info",
]

CHUNK = 2048  # keys a chunk and outputs a merge tile (csrc/fallback.cu's kChunk)
LIST_SPAN = 4096  # buckets a CTA of the list kernel takes (kListSpan)
MAX_ARRAYS = 128  # arrays one sort launch moves (kMaxArrays)
_SLICE_BYTES = 4  # the move's scratch: bytes a position

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "fallback_list": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "fallback_sort": (_P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P),
    "fallback_sort_keys": (_P, _I, _I, _I, _I, _P, _P, _P),
    "fallback_info": (_I, _P),
}
Arrays = Dict[str, torch.Tensor]


def _lib():
    return _build.library("fallback", _SIGNATURES)


def capacity(n: Optional[int], nb: int, W: int) -> int:
    """The most buckets a row of n positions can list: disjoint buckets of
    more than W/2 keys, at most every even id (all of them when n is None)."""
    even = (nb + 1) // 2
    return max(1, even if n is None else min(even, n // (W // 2 + 1) + 1))


def meta_words(rows: int, cap: int) -> int:
    """The int32 words of the list (``fallback_meta_words``): the summary
    (verdict, count, largest size, chunks), the rows' chunk prefix, count
    and largest size, then (start, size, first chunk) for ``cap`` buckets a
    row."""
    return 4 + (rows + 1) + 2 * rows + 3 * rows * cap


def oversized_mask(offsets: torch.Tensor, nb: int, W: int, pad_bucket: Optional[int],
                   limit: Optional[int] = None) -> torch.Tensor:
    """(..., nb) mask of the non-trivial buckets larger than W/2 (per row
    for (B, nb+1) offsets); odd ids are equality buckets (and the pad
    bucket holds sentinels), which never need sorting.  ``limit`` keeps
    only the buckets that start below it.  Eager torch on any device."""
    sizes = offsets[..., 1:] - offsets[..., :-1]
    ids = torch.arange(nb, device=offsets.device)
    nontrivial = (ids % 2) == 0
    if pad_bucket is not None:
        nontrivial &= ids != pad_bucket
    big = nontrivial & (sizes > W // 2)
    if limit is not None:
        big &= offsets[..., :-1] < limit
    return big


def oversized_list_plain(offsets: torch.Tensor, nb: int, W: int, pad_bucket: Optional[int],
                         limit: Optional[int], n: Optional[int]) -> torch.Tensor:
    """:func:`oversized_list`'s plain torch twin on any device: the same
    words, from :func:`oversized_mask` (its host reads are the CPU's)."""
    off = offsets.reshape(-1, nb + 1).to(torch.int64)
    rows = off.shape[0]
    cap = capacity(n, nb, W)
    big = oversized_mask(off, nb, W, pad_bucket, limit)
    meta = torch.zeros(meta_words(rows, cap), dtype=torch.int32, device=offsets.device)
    count = big.sum(1)
    chunks = torch.zeros(rows, dtype=torch.int64, device=offsets.device)
    largest = torch.zeros(rows, dtype=torch.int64, device=offsets.device)
    lists = meta[4 + (rows + 1) + 2 * rows:].view(3, rows, cap)
    for r in range(rows):
        ids = torch.nonzero(big[r]).squeeze(1)
        start, size = off[r, ids], off[r, ids + 1] - off[r, ids]
        per = (size + CHUNK - 1) // CHUNK
        c = len(ids)
        lists[0, r, :c] = start.to(torch.int32)
        lists[1, r, :c] = size.to(torch.int32)
        lists[2, r, :c] = (torch.cumsum(per, 0) - per).to(torch.int32)
        chunks[r] = per.sum()
        largest[r] = size.max() if c else 0
    total = int(count.sum())
    meta[0], meta[1] = int(total > 0), total
    meta[2], meta[3] = int(largest.max()), int(chunks.sum())
    meta[4] = 0
    meta[5:5 + rows] = torch.cumsum(chunks, 0).to(torch.int32)
    meta[5 + rows:5 + 2 * rows] = count.to(torch.int32)
    meta[5 + 2 * rows:5 + 3 * rows] = largest.to(torch.int32)
    return meta


def oversized_list(offsets: torch.Tensor, nb: int, W: int, pad_bucket: Optional[int],
                   limit: Optional[int], n: Optional[int]) -> torch.Tensor:
    """The list of the oversized buckets of (nb+1,) or (B, nb+1) int32
    ``offsets`` over rows of n positions (None: not known, room for every
    even bucket), an int32 tensor of :func:`meta_words` (see there).  The G7 list kernel on a CUDA tensor
    (one launch), :func:`oversized_list_plain` on a CPU tensor."""
    rows = offsets.numel() // (nb + 1)
    cap = capacity(n, nb, W)
    if _build.is_fake(offsets):
        _build.note_fake("fallback_list", 0.0, 4.0 * offsets.numel())
        return offsets.new_empty(meta_words(rows, cap))
    if offsets.device.type == "cpu":
        return oversized_list_plain(offsets, nb, W, pad_bucket, limit, n)
    if offsets.device.type != "cuda":
        raise ValueError(f"unsupported device {offsets.device}")
    offsets = offsets.contiguous()
    if offsets.dtype != torch.int32 or offsets.shape[-1] != nb + 1 or rows < 1:
        raise ValueError(f"oversized_list: offsets {tuple(offsets.shape)} {offsets.dtype}, "
                         f"expected (..., {nb + 1}) int32")
    meta = torch.empty(meta_words(rows, cap), dtype=torch.int32, device=offsets.device)
    part = torch.empty(rows * -(-nb // LIST_SPAN) * 3, dtype=torch.int32, device=offsets.device)
    lim = 2**31 - 1 if limit is None else min(int(limit), 2**31 - 1)
    err = _lib().fallback_list(offsets.data_ptr(), rows, nb, W // 2,
                               -1 if pad_bucket is None else pad_bucket, lim, cap,
                               part.data_ptr(), meta.data_ptr(),
                               _build.stream_handle(offsets.device))
    _build.check(_lib(), "fallback", err, "fallback_list kernel")
    _build.LAUNCHES["fallback_list"] += 1
    return meta


def verdict(meta: torch.Tensor) -> torch.Tensor:
    """The list's verdict, a 0-d bool tensor on its device: some listed
    bucket exists.  Nothing is read to the host here."""
    return meta[0] != 0


def _slices(a: torch.Tensor, lead: int):
    """(units a row, bytes a unit) of ``a``'s rows past its ``lead`` dims, a
    unit at most the scratch's 4 bytes a position."""
    row = a.element_size() * math.prod(a.shape[lead:])
    unit = min(move_unit(row, a.data_ptr()), _SLICE_BYTES)
    return row // unit, unit


def sort_listed(arrays: Arrays, meta: torch.Tensor, lead: int) -> Arrays:
    """Sort the listed buckets of every row of ``arrays["k"]`` (n,) or (B,
    n) int32/int64 stably by key, in place, and move every array's rows
    (any trailing dims and dtype) by the same order: the G7 sort kernel on
    CUDA tensors, one launch a :data:`MAX_ARRAYS` arrays (every launch
    after the first moves only).  Returns ``arrays``."""
    keys = arrays["k"]
    n = keys.shape[-1]
    rows = keys.numel() // n if n else 0
    nb_words = meta.numel()
    cap = (nb_words - 4 - (rows + 1) - 2 * rows) // (3 * rows)
    if meta_words(rows, cap) != nb_words:
        raise ValueError(f"sort_listed: a list of {nb_words} words does not fit {rows} rows")
    if keys.dtype not in (torch.int32, torch.int64) or not keys.is_contiguous():
        raise ValueError(f"sort_listed keys: expected contiguous int32 or int64, got {keys.dtype}")
    if rows * n >= 2**31:
        raise ValueError(f"sort_listed: {rows} x {n} positions exceed int32 positions")
    for name, a in arrays.items():
        if tuple(a.shape[:lead]) != tuple(keys.shape) or not a.is_contiguous() or \
                a.device != keys.device:
            raise ValueError(f"sort_listed {name}: {tuple(a.shape)} must be contiguous and lead "
                             f"with the keys' {tuple(keys.shape)} on {keys.device}")
    lib = _lib()
    wide = 64 if keys.dtype == torch.int64 else 32
    if list(arrays) == ["k"]:  # the keys alone: merged themselves, one key a position
        scratch = torch.empty(rows * n, dtype=keys.dtype, device=keys.device)
        err = lib.fallback_sort_keys(keys.data_ptr(), wide, n, rows, cap, meta.data_ptr(),
                                     scratch.data_ptr(), _build.stream_handle(keys.device))
        _build.check(lib, "fallback", err, "fallback_sort kernel")
        _build.LAUNCHES["fallback_sort"] += 1
        return arrays
    bufs = torch.empty((2, rows * n), dtype=torch.int32, device=keys.device)
    items = [a for a in arrays.values() if a.numel()]
    for first in range(0, max(len(items), 1), MAX_ARRAYS):
        group = items[first:first + MAX_ARRAYS]
        shapes = [_slices(a, lead) for a in group]
        ptrs = (ctypes.c_void_p * max(1, len(group)))(*[a.data_ptr() for a in group])
        units = (ctypes.c_int * max(1, len(group)))(*[w for w, _ in shapes])
        unit_bytes = (ctypes.c_int * max(1, len(group)))(*[u for _, u in shapes])
        err = lib.fallback_sort(keys.data_ptr(), wide, n,
                                rows, cap, meta.data_ptr(), bufs[0].data_ptr(),
                                bufs[1].data_ptr(), len(group), ptrs, units, unit_bytes,
                                int(first == 0), _build.stream_handle(keys.device))
        _build.check(lib, "fallback", err, "fallback_sort kernel")
        _build.LAUNCHES["fallback_sort"] += 1
    return arrays


def sort_oversized_plain(arrays: Arrays, fb: torch.Tensor, offsets: torch.Tensor, nb: int,
                         W: int, pad_bucket: Optional[int],
                         limit: Optional[int] = None) -> Arrays:
    """G7's plain torch twin on any device: stably sort, in place, the keys
    of every bucket larger than W/2 (that starts below ``limit``), in one
    row (n,) or in each of B rows (B, n), by the segment ids ``fb``.  The
    picked positions are sorted by (row, bucket, key): packed into one int64
    for int32 keys; for int64 keys, which leave no room beside them, by two
    stable sorts (key, then row and bucket)."""
    fb2 = fb if fb.dim() == 2 else fb[None]
    B, n = fb2.shape
    big_rows = oversized_mask(offsets.reshape(B, nb + 1), nb, W, pad_bucket, limit)
    pos = torch.nonzero(torch.gather(big_rows, 1, fb2.to(torch.int64)).reshape(-1)).squeeze(1)
    gid = fb2.reshape(-1)[pos].to(torch.int64)
    if B > 1:  # (row, bucket) < B * nb < B * n < 2^31: it fits above the key
        gid += (pos // n) * nb
    keys = arrays["k"].reshape(-1)
    if keys.dtype == torch.int64:
        by_key = torch.sort(keys[pos], stable=True).indices
        src = pos[by_key[torch.sort(gid[by_key], stable=True).indices]]
    else:
        packed = (gid << 32) + (keys[pos].to(torch.int64) + (1 << 31))
        src = pos[torch.sort(packed, stable=True).indices]
    for a in arrays.values():
        flat = a.view((B * n,) + tuple(a.shape[fb.dim():]))
        flat[pos] = flat[src]
    return arrays


def sort_oversized(arrays: Arrays, fb: torch.Tensor, offsets: torch.Tensor, nb: int, W: int,
                   pad_bucket: Optional[int], limit: Optional[int] = None,
                   meta: Optional[torch.Tensor] = None) -> Arrays:
    """The robustness fallback over one row (n,) or B rows (B, n) of
    ``arrays`` with segment ids ``fb`` and their (nb+1,) or (B, nb+1)
    ``offsets``: every oversized bucket sorted stably by key, in place.  On
    a CUDA tensor the G7 kernels, with no host read (``meta``, the
    :func:`oversized_list` of these offsets, spares its launch; ``fb`` is
    not read); on a CPU tensor :func:`sort_oversized_plain`, after a host
    read of the verdict."""
    keys = arrays["k"]
    if _build.is_fake(keys):
        _build.note_fake("fallback_sort", 0.0, 8.0 * keys.numel())
        return arrays
    if keys.device.type == "cpu":
        big = oversized_mask(offsets, nb, W, pad_bucket, limit)
        if bool(torch.any(big)):
            arrays = sort_oversized_plain(arrays, fb, offsets, nb, W, pad_bucket, limit)
        return arrays
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if meta is None:
        meta = oversized_list(offsets, nb, W, pad_bucket, limit, keys.shape[-1])
    return sort_listed(arrays, meta, keys.dim())


def launch_info(key_bits: int = 32) -> dict:
    """The G7 sort kernel's launch for 32- or 64-bit keys, from the CUDA
    runtime: registers, static shared memory, threads, CTAs an SM holds,
    local bytes (spills) and the cooperative grid.  Needs a card."""
    out = (ctypes.c_int * 6)()
    lib = _lib()
    _build.check(lib, "fallback", lib.fallback_info(key_bits, ctypes.addressof(out)),
                 "fallback_sort kernel")
    return dict(zip(("registers", "static_smem", "threads", "ctas_per_sm", "local_bytes",
                     "grid"), out))
