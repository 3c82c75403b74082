"""K9 ``permute_blocks_inplace``: the paper's in-place block permutation
(§4.2, Fig. 3) with per-bucket write/read pointers.

Counterpart of ``repro.kernels.permute_inplace`` (the Pallas TPU kernel
``permute_blocks_inplace`` at ``permute_inplace.py:148``, kernel ``:46``).
The CUDA kernel is in ``csrc/permute_inplace.cu``, whose header note gives
its bound (bytes: 2 x N x block bytes, 0.64 ms for 1 GiB on the H100), what
the first design lost (it replayed the TPU kernel's one-core move order,
one chain of dependent steps, 219x the bound) and what this one does: the
paper's parallel form, many CTAs each a paper thread with its own swap
buffers, the (w, r) pair of every bucket in one 64-bit word updated by
atomics, and a per-slot read flag that a writer into an emptied slot waits
for.  The wrapper launches it on a CUDA tensor (key
``permute_blocks_inplace`` of ``_build.LAUNCHES``) and runs the plain twin
only on a CPU tensor; there is no fallback from one to the other.

The permutation is not stable, as the reference's docstring says: which
block of a bucket lands in which of its slots follows the order of the
moves.  The plain twin replays the reference's one-core order and equals it
bit for bit; the kernel's order depends on how its CTAs interleave.  All of
them put every block, intact, into its bucket's range, so their outputs
agree block multiset by block multiset per bucket, which is the reference's
own test.  The move happens in the caller's tensor, which the wrapper
returns (same ``data_ptr``).
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import signed_payload
from repro_torch.kernels import _build
from repro_torch.kernels.block_permute import LANES
from repro_torch.kernels.level_fused import _device_kind

__all__ = ["permute_blocks_inplace", "permute_blocks_inplace_plain", "replay_moves"]

_P, _I = _build.P, _build.I
_SIGNATURES = {"permute_inplace": (_P, _P, _P, _P, _I, _I, _I, _P)}


def _check(a, block_bucket, d, k, block_elems) -> int:
    if block_elems <= 0 or block_elems % LANES:
        raise ValueError("block_elems must be a multiple of 128")
    if a.dim() != 1 or not a.is_contiguous():
        raise ValueError(f"a: expected a contiguous 1-D tensor, got {tuple(a.shape)}")
    n = a.shape[0]
    nblocks = n // block_elems
    if n != nblocks * block_elems:
        raise ValueError("array size must be a multiple of block_elems")
    if block_bucket.shape != (nblocks,) or block_bucket.dtype != torch.int32:
        raise ValueError(f"block_bucket: expected ({nblocks},) int32")
    if d.shape != (k + 1,) or d.dtype != torch.int32:
        raise ValueError(f"d: expected ({k + 1},) int32")
    if block_bucket.device != a.device or d.device != a.device:
        raise ValueError("a, block_bucket and d must share a device")
    return nblocks


def replay_moves(block_bucket, d, k: int) -> list:
    """The source block of every slot after the reference's move order, as
    a list over the N slots (a slot never written keeps its own block).
    ``block_bucket`` and ``d`` are sequences of ints: the control of the
    permutation depends on them alone, never on the data."""
    bb = [int(b) for b in block_bucket]
    w = [int(x) for x in d[:k]]
    r = [int(x) for x in d[1:k + 1]]
    src_of = list(range(len(bb)))
    filled, primary, held, held_bucket = False, 0, 0, 0
    for _ in range(len(bb) + 1):
        if not filled:  # cyclic primary-bucket scan, then read at r - 1
            p, cnt = primary, 0
            while cnt < k and w[p] >= r[p]:
                p, cnt = (p + 1) % k, cnt + 1
            primary = p
            if w[p] >= r[p]:
                break
            r[p] -= 1
            held, held_bucket, filled = r[p], bb[r[p]], True
        wd = w[held_bucket]
        exchange = wd < r[held_bucket]
        src_of[wd] = held
        w[held_bucket] = wd + 1
        if exchange:  # slot wd still held its own block: hold it next
            held, held_bucket = wd, bb[wd]
        else:
            filled = False
    return src_of


def _move_plain(a, block_bucket, d, k, nblocks, block_elems) -> None:
    src = torch.as_tensor(replay_moves(block_bucket.tolist(), d.tolist(), k),
                          dtype=torch.int64, device=a.device)
    blocks = signed_payload(a).view(nblocks, block_elems)  # no unsigned gather on a card
    blocks.copy_(blocks[src])


def _move_kernel(a, block_bucket, d, k, nblocks, block_elems) -> None:
    if a.data_ptr() % 16:
        raise ValueError("a: the kernel moves 16-byte words; data_ptr must be 16-byte aligned")
    # the kernel's scratch: a (w, r) word per bucket, then a read flag per slot
    scratch = torch.empty(k + -(-nblocks // 2), dtype=torch.int64, device=a.device)
    lib = _build.library("permute_inplace", _SIGNATURES)
    err = lib.permute_inplace(a.data_ptr(), block_bucket.contiguous().data_ptr(),
                              d.contiguous().data_ptr(), scratch.data_ptr(), k, nblocks,
                              block_elems * a.element_size() // 16,
                              _build.stream_handle(a.device))
    _build.check(lib, "permute_inplace", err, "permute_blocks_inplace kernel")
    _build.LAUNCHES["permute_blocks_inplace"] += 1


def _permute(a, block_bucket, d, k, block_elems, plain):
    nblocks = _check(a, block_bucket, d, k, block_elems)
    if nblocks:
        (_move_plain if plain else _move_kernel)(a, block_bucket, d, k, nblocks, block_elems)
    return a


def permute_blocks_inplace(a: torch.Tensor, block_bucket: torch.Tensor, d: torch.Tensor, *,
                           k: int, block_elems: int = 1024) -> torch.Tensor:
    """Group the blocks of ``a`` (N * block_elems,) by bucket, in place: the
    K9 kernel on a CUDA tensor, its plain twin on a CPU tensor.

    ``block_bucket`` (N,) int32 in [0, k) is each block's bucket and ``d``
    (k+1,) int32 the buckets' block boundaries (the histogram's exclusive
    prefix, d[k] == N).  Not stable: the kernel's order within a bucket
    differs from the twin's.  Returns ``a`` itself, permuted.
    """
    return _permute(a, block_bucket, d, k, block_elems, _device_kind(a) == "cpu")


def permute_blocks_inplace_plain(a: torch.Tensor, block_bucket: torch.Tensor, d: torch.Tensor,
                                 *, k: int, block_elems: int = 1024) -> torch.Tensor:
    """K9's plain twin on any device: the reference's moves replayed on the
    host (:func:`replay_moves`), then one gather of the blocks written back
    into ``a``.  Returns ``a``."""
    return _permute(a, block_bucket, d, k, block_elems, True)
