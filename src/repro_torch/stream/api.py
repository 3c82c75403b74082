"""Streaming entry points: out-of-core sorts over host-resident data.

Counterpart of ``repro.stream.api``.  The common shape:

  1. chunks stream host -> device under double buffering (``stream.runs``)
     and come back as sorted runs on the card;
  2. runs reduce through the pairwise merge tournament (``stream.merge``,
     kernel K5); between rounds the merged results **spill to host**, so the
     card holds one pair being merged at a time after the first round,
     never the whole dataset plus intermediates.

``streaming_topk`` and ``streaming_group_by`` never materialize the stream:
they carry a bounded candidate / distinct-key buffer and refine it per
chunk with ``ops.topk``/``bottomk`` or ``ops.unique`` and one 2-way merge.

The plan cache (``cache=``, by default ``ops.plan.default_cache``) gives
each chunk its sorter and each external sort its merge tile, from the
``stream:`` key family at (chunk size, fan-in, dtype); ``tune=True`` sweeps
and persists what is missing.  The reference's ``engine=`` has no
counterpart: the port has no engine switch.  The entry points run on the
card unless ``device="cpu"`` is passed, and raise without a card.
With ``repro_torch.obs`` enabled the tournament reports itself, with the
reference's names: ``stream.external_sort`` / ``stream.external_argsort``
spans with a ``stream.merge_round`` span per round, and the
``stream.spill_bytes``, ``stream.tournament_rounds`` and ``stream.chunks``
counters.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ops import keyspace, plan
from repro_torch.ops.groupby import unique
from repro_torch.ops.sort import Device, _device
from repro_torch.stream.merge import merge
from repro_torch.stream.runs import (Source, device_chunks, form_argsort_runs, form_runs,
                                     host_array)

__all__ = [
    "external_sort",
    "external_argsort",
    "streaming_topk",
    "streaming_group_by",
]


def _spill(x: torch.Tensor) -> np.ndarray:
    """Device -> host spill with the byte volume counted."""
    out = x.cpu().numpy()
    obs.count("stream.spill_bytes", out.nbytes)
    return out


def _to_host(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()


def _merge_pass(runs: List, dev: torch.device, tile: int, payloads: Optional[List] = None):
    """One tournament round over runs (device tensors in round 0, host arrays
    after): merge adjacent pairs on the card with K5 at ``tile``, spill each
    result to host."""
    out_k, out_v = [], []
    for i in range(0, len(runs) - 1, 2):
        a, b = (torch.as_tensor(r, device=dev) for r in runs[i : i + 2])
        if payloads is None:
            out_k.append(_spill(merge([a, b], tile=tile)))
        else:
            va, vb = (torch.as_tensor(v, device=dev) for v in payloads[i : i + 2])
            k, v = merge([a, b], values=[va, vb], tile=tile)
            out_k.append(_spill(k))
            out_v.append(_spill(v))
    if len(runs) % 2:
        # the odd run out rides along untouched: not a spill, no new bytes
        out_k.append(_to_host(runs[-1]))
        if payloads is not None:
            out_v.append(_to_host(payloads[-1]))
    return out_k, (out_v if payloads is not None else None)


def _peek(data: Source) -> Tuple[Source, Union[np.dtype, torch.dtype]]:
    """The source, none of it consumed, and its keys' host dtype (a numpy
    dtype, or a torch dtype for CPU tensors): the array's, or a
    generator's first chunk's (float32 for an empty one)."""
    if isinstance(data, (np.ndarray, torch.Tensor)):
        return data, data.dtype
    chunks = iter(data)
    first = next(chunks, None)
    if first is None:
        return iter(()), np.dtype(np.float32)
    if not isinstance(first, torch.Tensor):
        first = np.asarray(first)
    return itertools.chain([first], chunks), first.dtype


def _empty(dtype) -> Union[np.ndarray, torch.Tensor]:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype)
    return np.zeros((0,), dtype)


def external_sort(data: Source, *, chunk_size: int = 1 << 16,
                  cache: Optional[plan.PlanCache] = None, tune: bool = False,
                  device: Device = None) -> np.ndarray:
    """Sort a host-resident (or generator-fed) keyset larger than one device
    allocation: IPS4o run formation + merge tournament with host spill
    between rounds.  Keys of any keyspace dtype; the result has the
    source's numpy dtype.

    Equal to ``ops.sort`` of the concatenated stream: the keyspace total
    order, NaNs last, -0.0 strictly before +0.0.  ``tune=True`` autotunes
    (and persists) the chunk sorter's plan and the ``stream:`` merge tile
    for this chunk size x fan-in.

    >>> external_sort(np.asarray([5, 1, 4, 2, 3], np.int32), chunk_size=2,
    ...               device="cpu").tolist()
    [1, 2, 3, 4, 5]
    """
    dev = _device(device)
    cache = plan.default_cache if cache is None else cache
    data, host_dtype = _peek(data)
    runs = form_runs(data, chunk_size, cache=cache, tune=tune, device=dev)
    if not runs:
        return _empty(host_dtype)
    dtype = runs[0].dtype
    cfg = cache.stream_plan(chunk_size, len(runs), dtype, tune=tune, device=dev)
    with obs.trace("stream.external_sort", chunks=len(runs), chunk_size=chunk_size):
        # int32 or int64 codes: merge's own encode is then the identity
        level = [keyspace.encode(r) for r in runs]
        rounds = 0
        while len(level) > 1:
            with obs.trace("stream.merge_round", fanin=len(level)):
                level, _ = _merge_pass(level, dev, cfg.merge_tile)
            rounds += 1
        obs.count("stream.tournament_rounds", rounds)
        return host_array(keyspace.decode(torch.as_tensor(level[0]), dtype), host_dtype)


def external_argsort(data: Source, *, chunk_size: int = 1 << 16,
                     cache: Optional[plan.PlanCache] = None, tune: bool = False,
                     device: Device = None) -> np.ndarray:
    """Indices (int32, into the concatenated stream) that sort it, stably:
    ``keys[idx]`` equals ``external_sort(keys)`` and equal keys keep their
    stream order.  Raises for streams of 2^31 keys or more.  ``cache`` and
    ``tune`` as for :func:`external_sort`.

    >>> external_argsort(np.asarray([30, 10, 40, 20], np.int32), chunk_size=2,
    ...                  device="cpu").tolist()
    [1, 3, 0, 2]
    """
    dev = _device(device)
    cache = plan.default_cache if cache is None else cache
    pairs = form_argsort_runs(data, chunk_size, cache=cache, tune=tune, device=dev)
    if not pairs:
        return np.zeros((0,), np.int32)
    cfg = cache.stream_plan(chunk_size, len(pairs), pairs[0][0].dtype, tune=tune, device=dev)
    with obs.trace("stream.external_argsort", chunks=len(pairs), chunk_size=chunk_size):
        keys = [keyspace.encode(k) for k, _ in pairs]  # only indices come back out
        idxs = [i for _, i in pairs]
        rounds = 0
        while len(keys) > 1:
            with obs.trace("stream.merge_round", fanin=len(keys)):
                keys, idxs = _merge_pass(keys, dev, cfg.merge_tile, idxs)
            rounds += 1
        obs.count("stream.tournament_rounds", rounds)
        return _to_host(idxs[0])


def streaming_topk(data: Source, k: int, *, chunk_size: int = 1 << 16, largest: bool = True,
                   cache: Optional[plan.PlanCache] = None, tune: bool = False,
                   device: Device = None) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k (or bottom-k) of a stream with a bounded candidate buffer.

    Per chunk, the plan-cached ``ops.topk``/``bottomk`` (``tune=True``
    sweeps its plan once) yields that chunk's candidates; one
    stable 2-way merge against the k-entry running buffer refines it.  The
    buffer lives in the *ascending encoded* keyspace, complemented for
    ``largest=True`` (``~`` reverses the signed int32 order of the codes),
    so one merge serves both directions.  Device footprint: one chunk plus
    2k candidates.

    Returns (values in the source's numpy dtype, global int32 indices) in
    rank order (descending for ``largest=True``); ties prefer earlier
    positions.

    >>> v, i = streaming_topk(np.asarray([1.0, 9.0, 3.0, 7.0], np.float32), 2,
    ...                       chunk_size=2, device="cpu")
    >>> (v.tolist(), i.tolist())
    ([9.0, 7.0], [1, 3])
    """
    dev = _device(device)
    cache = plan.default_cache if cache is None else cache
    data, host_dtype = _peek(data)
    op = "topk" if largest else "bottomk"
    buf_u = buf_i = None  # encoded-ascending candidates + global indices
    key_dtype = None
    with obs.trace("stream.topk", k=k, chunk_size=chunk_size, largest=largest):
        for x, offset in device_chunks(data, chunk_size, dev):
            n = x.shape[0]
            if n == 0:
                continue
            obs.count("stream.chunks", op="topk")
            key_dtype = x.dtype
            vals, idx = cache.get_sorter(n, x.dtype, op, k=min(k, n), tune=tune,
                                         device=dev)(x)
            u = keyspace.encode(vals)
            u, gi = (~u if largest else u), idx + offset
            if buf_u is None:
                buf_u, buf_i = u[:k], gi[:k]
            else:
                mk, mi = merge([buf_u, u], values=[buf_i, gi])
                buf_u, buf_i = mk[:k], mi[:k]
        if buf_u is None:
            raise ValueError("streaming_topk over an empty stream")
        vals = keyspace.decode(~buf_u if largest else buf_u, key_dtype)
        return host_array(vals, host_dtype), buf_i.cpu().numpy()


def streaming_group_by(data: Source, *, chunk_size: int = 1 << 16,
                       cache: Optional[plan.PlanCache] = None, tune: bool = False,
                       device: Device = None) -> Tuple[np.ndarray, np.ndarray]:
    """Global (distinct keys ascending in the source's numpy dtype, int64
    counts) over a stream: per-chunk
    ``ops.unique`` runs (each sorting with the plan cache's "sort" config for
    the chunk, ``tune=True`` sweeping it once) merge-joined into a bounded
    distinct-key buffer.

    Each chunk contributes its sorted (unique values, counts) run; the
    buffer absorbs it with one stable 2-way merge on the card and a host
    join of equal adjacent codes (so NaN forms one class and -0.0 / +0.0
    stay distinct, as in ``ops.unique``).  The buffer is bounded by the
    number of distinct keys, not the stream length.

    >>> vals, counts = streaming_group_by(np.asarray([3, 1, 3, 1, 1, 3], np.int32),
    ...                                   chunk_size=2, device="cpu")
    >>> (vals.tolist(), counts.tolist())
    ([1, 3], [3, 3])
    """
    dev = _device(device)
    cache = plan.default_cache if cache is None else cache
    data, host_dtype = _peek(data)
    buf_u = buf_c = None  # host: encoded distinct keys (ascending) + int64 counts
    key_dtype = None
    for x, _ in device_chunks(data, chunk_size, dev):
        if x.shape[0] == 0:
            continue
        obs.count("stream.chunks", op="group_by")
        key_dtype = x.dtype
        cfg = cache.config_for("sort", x.shape[0], x.dtype, tune=tune, device=dev)
        vals, counts, num = unique(x, cfg=cfg, device=dev)
        nu = int(num)
        cu = keyspace.encode(vals[:nu])
        cc = counts[:nu].to(torch.int64)
        if buf_u is None:
            buf_u, buf_c = cu.cpu().numpy(), cc.cpu().numpy()
            continue
        mk, mc = merge([torch.as_tensor(buf_u, device=dev), cu],
                       values=[torch.as_tensor(buf_c, device=dev), cc])
        mk, mc = mk.cpu().numpy(), mc.cpu().numpy()
        head = np.concatenate([[True], mk[1:] != mk[:-1]])  # run starts
        gid = np.cumsum(head) - 1
        buf_u = mk[head]
        buf_c = np.bincount(gid, weights=mc).astype(np.int64)
    if buf_u is None:
        raise ValueError("streaming_group_by over an empty stream")
    return host_array(keyspace.decode(torch.as_tensor(buf_u), key_dtype), host_dtype), buf_c
