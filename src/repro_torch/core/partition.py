"""Stable block-structured distribution (paper §4.1–§4.3), plain torch.

Counterpart of ``repro.core.partition``'s "xla" engine: per-tile stable
grouping, per-tile histograms, exclusive prefix sums over tiles, and one
gather.  This is the oracle formula that the port's partition kernels K1
(``kernels.level_fused.level_fused``) and K2 (``kernels.level_fused.rank_hist``)
are held to: the stable counting placement, which does not depend on the
tiling.  :func:`batched_stable_partition` is the per-row form, the oracle of
K4 (``kernels.level_fused.level_fused_batched`` and ``rank_hist_batched``).

:func:`partition_ranks_kernel` is the counterpart of the reference's
``partition_ranks_pallas``: the stable counting destinations from given
bucket offsets, by kernel K6 (``kernels.dispatch_rank``).
:func:`partition_blocks` is the block-granular move (paper §4.2): whole
blocks grouped by bucket in place, by kernel K8
(``kernels.block_permute``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.sampling import signed_payload
from repro_torch.kernels import dispatch_rank
from repro_torch.kernels.block_permute import permute_blocks_by_dest, stable_block_dest

__all__ = [
    "tile_histogram",
    "partition_permutation",
    "stable_partition",
    "batched_stable_partition",
    "partition_ranks_kernel",
    "partition_blocks",
]

Arrays = Dict[str, torch.Tensor]


def tile_histogram(bucket_tiles: torch.Tensor, nb: int) -> torch.Tensor:
    """(T, tile) int bucket ids -> (T, nb) int32 histogram."""
    num_tiles = bucket_tiles.shape[0]
    hist = torch.zeros((num_tiles, nb), dtype=torch.int32, device=bucket_tiles.device)
    ones = torch.ones_like(bucket_tiles, dtype=torch.int32)
    return hist.scatter_add_(1, bucket_tiles.to(torch.int64), ones)


def partition_permutation(
    bucket: torch.Tensor, nb: int, tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stable partition permutation of ``bucket`` (n,) ids in [0, nb).

    Returns (perm, offsets): ``x[perm]`` groups any payload by bucket,
    stably; ``offsets`` (nb+1,) int32 are the bucket boundaries.  n must be
    a multiple of ``tile``.
    """
    n = bucket.shape[0]
    if n % tile:
        raise ValueError(f"n={n} not a multiple of tile={tile}")
    dev = bucket.device
    num_tiles = n // tile
    bt = bucket.reshape(num_tiles, tile).to(torch.int64)

    # local classification: stable grouping within each tile
    order = torch.sort(bt, dim=1, stable=True).indices
    bt_g = torch.gather(bt, 1, order)

    # prefix sums (paper: over stripes)
    hist = tile_histogram(bt, nb)
    offsets = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(hist.sum(dim=0, dtype=torch.int32), 0, dtype=torch.int32)
    tile_off = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    run_start = torch.cumsum(hist, 1, dtype=torch.int32) - hist

    # block permutation: destination of each grouped element
    pos = torch.arange(tile, dtype=torch.int32, device=dev)[None, :]
    dest = (
        offsets[:-1][bt_g]
        + torch.gather(tile_off, 1, bt_g)
        + (pos - torch.gather(run_start, 1, bt_g))
    )
    src = order + (torch.arange(num_tiles, device=dev) * tile)[:, None]
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    perm[dest.reshape(-1).to(torch.int64)] = src.reshape(-1)
    return perm, offsets


def stable_partition(
    bucket: torch.Tensor, arrays: Arrays, nb: int, tile: int
) -> Tuple[Arrays, torch.Tensor]:
    """Stably reorder every tensor of ``arrays`` so buckets are contiguous.
    Returns (reordered arrays, offsets (nb+1,) int32)."""
    perm, offsets = partition_permutation(bucket, nb, tile)
    return {name: a[perm] for name, a in arrays.items()}, offsets


def batched_stable_partition(
    bucket: torch.Tensor, arrays: Arrays, nb: int, tile: int
) -> Tuple[Arrays, torch.Tensor]:
    """Per-row stable partition of (B, n) ``bucket`` ids in [0, nb); every
    tensor of ``arrays`` is (B, n, ...).  Rows never exchange elements.
    Returns (reordered arrays, offsets (B, nb+1) int32).

    The rows, flattened, are one array whose ids ``row * nb + bucket`` rise
    with the row; n is a multiple of ``tile``, so no tile straddles a row,
    and the stable partition of that array is each row's, shifted by the
    row's start.
    """
    B, n = bucket.shape
    dev = bucket.device
    row = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    perm, flat_off = partition_permutation(
        (bucket.to(torch.int64) + row * nb).reshape(-1), B * nb, tile
    )
    offsets = torch.cat(
        [flat_off[:-1].reshape(B, nb) - (row * n).to(torch.int32),
         torch.full((B, 1), n, dtype=torch.int32, device=dev)], 1)
    out = {name: a.reshape((B * n,) + a.shape[2:])[perm].reshape(a.shape)
           for name, a in arrays.items()}
    return out, offsets


def partition_ranks_kernel(
    bucket: torch.Tensor, offsets: torch.Tensor, nb: int, *, tile: int = dispatch_rank.TILE
) -> torch.Tensor:
    """Per-element stable counting destination through kernel K6: the
    counterpart of ``repro.core.partition.partition_ranks_pallas``.

    ``offsets`` is the (nb+1,) bucket-boundary array (only the exclusive
    prefix ``offsets[:-1]`` is read).  Returns dest (n,) int32 such that
    scattering ``a[i] -> dest[i]`` gives the stable partition.  For (B, n)
    ``bucket`` with (B, nb+1) ``offsets`` each row is placed on its own
    (``partition_ranks_batched``), returning (B, n) row-local destinations.
    Ids outside [0, nb) get -1.  On a CUDA tensor K6 runs, on a CPU tensor
    its plain twin.  One row takes nb up to 2^24: above K6's ``MAX_NB``
    counters it is placed by two K6 passes (:func:`_two_pass_ranks`); rows
    take nb up to ``MAX_NB``.
    """
    bucket = bucket.to(torch.int32).contiguous()
    start = offsets[..., :-1].to(torch.int32).contiguous()
    if bucket.dim() == 2:
        return dispatch_rank.partition_ranks_batched(bucket, start, nb=nb, tile=tile)
    if nb > dispatch_rank.MAX_NB:
        return _two_pass_ranks(bucket, start, nb, tile)
    return dispatch_rank.partition_ranks(bucket, start, nb=nb, tile=tile)


def _two_pass_ranks(bucket: torch.Tensor, start: torch.Tensor, nb: int,
                    tile: int) -> torch.Tensor:
    """The stable counting destinations of (n,) ids in [0, nb), nb up to
    2^24, by two stable K6 passes, least significant digit first: the low
    12 bits, then the high bits of the ids in the first pass's order.  The
    composed placement is the stable argsort of the ids, which gives each id
    its rank among the equal ids before it; id b's destination is start[b]
    plus that rank, as in one pass.  Ids outside [0, nb) get -1."""
    digits = dispatch_rank.MAX_NB.bit_length() - 1
    if nb > dispatch_rank.MAX_NB << digits:
        raise ValueError(f"nb={nb} exceeds the two K6 passes' {dispatch_rank.MAX_NB << digits}")
    n, dev = bucket.shape[0], bucket.device
    valid = (bucket >= 0) & (bucket < nb)
    b = torch.where(valid, bucket, 0)

    def place(ids, nb_pass):
        """One stable K6 pass over ids in [0, nb_pass) (-1: none), against
        the exclusive prefix of their counts."""
        counts = torch.bincount(torch.where(ids >= 0, ids, nb_pass), minlength=nb_pass + 1)
        first = torch.cumsum(counts[:nb_pass], 0, dtype=torch.int32) - counts[:nb_pass]
        return dispatch_rank.partition_ranks(ids, first.to(torch.int32), nb=nb_pass, tile=tile)

    none = torch.full_like(b, -1)
    dest_lo = place(torch.where(valid, b & (dispatch_rank.MAX_NB - 1), none),
                    dispatch_rank.MAX_NB)
    # the high digits in the first pass's order; the invalid ids take no
    # place there, so the last n - n_valid places keep -1 (one spare slot
    # takes the invalid ids' writes)
    high = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    high[torch.where(valid, dest_lo, n).to(torch.int64)] = torch.where(valid, b >> digits, none)
    dest_hi = place(high[:n].contiguous(), -(-nb >> digits))
    pos = dest_hi[torch.where(valid, dest_lo, 0).to(torch.int64)]  # place in the stable argsort
    counts = torch.bincount(torch.where(valid, b, nb), minlength=nb + 1)[:nb]
    first = torch.cumsum(counts, 0) - counts  # the argsort's first place of each id
    b64 = b.to(torch.int64)
    return torch.where(valid, start[b64] + (pos - first[b64]).to(torch.int32), none)


def partition_blocks(
    arrays: Arrays, block_bucket: torch.Tensor, nb: int, block_elems: int
) -> Tuple[Arrays, torch.Tensor]:
    """Group *block-homogeneous* data by bucket: the counterpart of
    ``repro.core.partition.partition_blocks``.

    Each run of ``block_elems`` elements shares one bucket, ``block_bucket``
    (N,) int32 in [0, nb) giving it per block.  When every tensor of
    ``arrays`` is 1-D with a length that is a multiple of ``block_elems``
    and ``block_elems`` is a multiple of 128 (the reference's rule), the
    blocks move **in place** in the caller's tensors by K8 with one stable
    destination per block (:func:`~repro_torch.kernels.block_permute.stable_block_dest`),
    and the returned dict holds the same tensors.  Otherwise every tensor
    is gathered into a new one by the stable block order, as the reference
    does; both branches give the same stable grouping.

    Returns (grouped arrays, (nb+1,) int32 block-boundary offsets d, the
    exclusive prefix of the block counts).  The tensors may hold any
    element type: K8 moves bytes (a block of 128 one-byte elements is eight
    of its 16-byte words), and the gather moves the bits of unsigned ints
    as the signed int of their width.
    """
    hist = torch.bincount(block_bucket.to(torch.int64), minlength=nb)
    d = torch.zeros(nb + 1, dtype=torch.int32, device=block_bucket.device)
    d[1:] = torch.cumsum(hist, 0)
    kernel_ok = block_elems % 128 == 0 and all(
        a.dim() == 1 and a.shape[0] % block_elems == 0 for a in arrays.values()
    )
    if kernel_ok:
        dst = stable_block_dest(block_bucket)
        return {name: permute_blocks_by_dest(a, dst, block_elems=block_elems)
                for name, a in arrays.items()}, d
    order = torch.sort(block_bucket, stable=True).indices
    nblocks = block_bucket.shape[0]

    def move(a):  # the gather on the signed view (no unsigned gather on a card)
        blocks = signed_payload(a).reshape((nblocks, block_elems) + a.shape[1:])
        return blocks[order].reshape(a.shape).view(a.dtype)

    return {name: move(a) for name, a in arrays.items()}, d
