"""Deterministic synthetic-token data and length packing through the sort.

Counterpart of ``repro.data.pipeline``:

  * ``SyntheticLM`` is a copy of the reference's (numpy only): a batch is
    a function of (seed, step), bit for bit the reference's;
  * ``pack_by_length`` sorts documents by length with the port's engine,
    then packs them greedily, first fit and longest first, on the host
    (``_greedy_pack``, the reference's loop, quadratic in rows).  The
    length order comes from one of four forms:

      1-D              the plan-cached argsort (``ops.plan.get_sorter``);
      2-D (S, n)       one plan-cached batched argsort for the S shards;
      ``chunk_size=``  ``stream.external_argsort`` (only a chunk of
                       lengths on the device at a time);
      ``mesh=``        the per-rank ``dist.argsort`` over ``axes`` of a
                       ``DeviceMesh``: every rank calls it with all the
                       lengths, pads them to a multiple of d^2 with the
                       int32 sentinel, sorts its shard across the mesh and
                       all-gathers the ranks' valid prefixes into the
                       global order; on overflow (retries exhausted, the
                       same verdict on every rank) it takes the 1-D path.

The sorts run on ``device`` (the card by default, ``"cpu"`` for the plain
twins); with a mesh, on the mesh's device type.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.ops.sort import Device, _device

__all__ = ["SyntheticLM", "pack_by_length"]


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int = 0  # >0: emit embeddings (vlm/audio stub frontends)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        if self.embed_dim:
            inputs = rng.standard_normal((b, s, self.embed_dim), np.float32)
        else:
            inputs = rng.integers(0, self.vocab_size, (b, s), dtype=np.int32)
        labels = rng.integers(0, self.vocab_size, (b, s), dtype=np.int32)
        return {"inputs": inputs, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def _greedy_pack(lengths_np: np.ndarray, idx: np.ndarray, seq_len: int):
    """Greedy first fit over length-sorted docs; see :func:`pack_by_length`."""
    n = len(lengths_np)
    keys = lengths_np[idx]
    row_id = np.zeros(n, np.int32)
    offset = np.zeros(n, np.int32)
    # pack longest-first so fragmentation stays bounded
    rows: list[int] = []  # remaining space per row
    for j in range(n - 1, -1, -1):
        doc, ln = idx[j], keys[j]
        ln = min(int(ln), seq_len)
        placed = False
        for r, space in enumerate(rows):
            if space >= ln:
                row_id[doc] = r
                offset[doc] = seq_len - space
                rows[r] = space - ln
                placed = True
                break
        if not placed:
            rows.append(seq_len - ln)
            row_id[doc] = len(rows) - 1
            offset[doc] = 0
    return row_id, offset, len(rows)


def _dist_length_order(lengths_np: np.ndarray, mesh, axes) -> Optional[np.ndarray]:
    """The global length order by the per-rank ``dist.argsort``, or None on
    a mesh of one rank or on overflow (every rank agrees), where the caller
    takes the single-device path, which gives the same packing."""
    import torch.distributed as tdist

    from repro_torch import dist
    from repro_torch.dist.exchange import group_for
    from repro_torch.dist.levels import normalize_axes

    names = normalize_axes(axes)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    d = 1
    for a in names:
        d *= int(sizes[a])
    if d <= 1:
        return None
    n = len(lengths_np)
    unit = d * d  # the pre-exchange splits each shard into d chunks
    n_pad = max(unit, -(-n // unit) * unit)
    padded = np.full(n_pad, np.iinfo(np.int32).max, np.int32)
    padded[:n] = lengths_np
    grp = group_for(mesh, names)
    n_local = n_pad // d
    dev = torch.device(mesh.device_type)
    shard = torch.as_tensor(padded[grp.index * n_local:(grp.index + 1) * n_local], device=dev)
    order, counts, overflow = dist.argsort(shard, mesh, axes)
    flag = grp.all_reduce(overflow.to(torch.int32), tdist.ReduceOp.MAX)
    if int(flag[0]):
        return None  # last resort: retries exhausted
    order = grp.all_gather(order).cpu().numpy()
    counts = grp.all_gather(counts).cpu().numpy()
    cap = order.shape[0] // d
    idx = np.concatenate([order[i * cap:i * cap + counts[i]] for i in range(d)])
    return idx[idx < n]  # sentinel pads sort last; drop them


def pack_by_length(
    lengths: np.ndarray,
    seq_len: int,
    *,
    chunk_size: Optional[int] = None,
    mesh=None,
    axes="data",
    device: Device = None,
):
    """Greedy packing of documents into rows of ``seq_len`` after a length
    sort.  Returns (row_id, offset, num_rows) per document; 2-D ``lengths``
    (S, n) packs S shards at once and returns a list of S such tuples.
    ``chunk_size`` sorts 1-D lengths out of core; ``mesh`` sorts them
    across the mesh (every rank calls with the same lengths and gets the
    same packing).  The packing consumes lengths, not indices, so every
    form gives the same row count."""
    from repro_torch.ops import get_sorter

    lengths_np = np.asarray(lengths, np.int32)
    if mesh is not None and lengths_np.ndim == 1:
        idx = _dist_length_order(lengths_np, mesh, axes)
        if idx is not None:
            return _greedy_pack(lengths_np, idx, seq_len)
        device = torch.device(mesh.device_type)
    dev = _device(device)
    if lengths_np.ndim == 2:
        s, n = lengths_np.shape
        idx = get_sorter(n, torch.int32, op="argsort", batch=s, device=dev)(
            torch.as_tensor(lengths_np, device=dev)).cpu().numpy()
        return [_greedy_pack(lengths_np[i], idx[i], seq_len) for i in range(s)]
    n = len(lengths_np)
    if chunk_size is not None and n > chunk_size:
        from repro_torch.stream import external_argsort

        idx = external_argsort(lengths_np, chunk_size=chunk_size, device=dev)
        return _greedy_pack(lengths_np, idx, seq_len)
    idx = get_sorter(n, torch.int32, op="argsort", device=dev)(
        torch.as_tensor(lengths_np, device=dev)).cpu().numpy()
    return _greedy_pack(lengths_np, idx, seq_len)
