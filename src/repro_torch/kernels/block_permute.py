"""K8 ``permute_blocks_by_dest``: the stable in-place block permutation by
explicit destinations, and ``stable_block_dest``.

Counterpart of ``repro.kernels.block_permute`` (the Pallas TPU kernel
``permute_blocks_by_dest`` at ``block_permute.py:145``, kernel ``:64``).
The CUDA kernel is in ``csrc/block_permute.cu``, whose header note gives its
bound and design.  The wrapper launches it on a CUDA tensor (key
``permute_blocks_by_dest`` of ``_build.LAUNCHES``) and runs the plain twin
only on a CPU tensor; there is no fallback from one to the other.

The move happens in the caller's tensor: the wrapper returns the tensor it
was given (same ``data_ptr``), as the reference's output aliases its input.
Block i of ``block_elems`` elements goes to slot ``dst[i]``; a trailing
partial block of ``n % block_elems`` elements (the overflow block) stays
where it is, and with at most one full block nothing moves.  The kernel
moves bytes, so any element type of the tensor works; besides the data it
needs N + 1 ints of scratch (the slots' states and a cursor), 4 B per block.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.level_fused import _device_kind

__all__ = [
    "permute_blocks_by_dest",
    "permute_blocks_by_dest_plain",
    "stable_block_dest",
    "LANES",
]

LANES = 128
_SMEM_BYTES = 232_448  # shared memory one CTA may use on the H100

_P, _I = _build.P, _build.I
_SIGNATURES = {"block_permute_by_dest": (_P, _P, _P, _I, _I, _P)}


def stable_block_dest(block_bucket: torch.Tensor) -> torch.Tensor:
    """Destination slot of every block under the *stable* bucket grouping:
    dst[i] = #blocks of a smaller bucket + #earlier blocks of the same
    bucket.  The scatter form of ``argsort(block_bucket, stable=True)``;
    plain torch, as the reference computes it in XLA.

    >>> stable_block_dest(torch.tensor([3, 1, 3, 0])).tolist()
    [2, 1, 3, 0]
    """
    n = block_bucket.shape[0]
    order = torch.sort(block_bucket, stable=True).indices
    dst = torch.empty(n, dtype=torch.int32, device=block_bucket.device)
    dst[order] = torch.arange(n, dtype=torch.int32, device=block_bucket.device)
    return dst


def _check(a: torch.Tensor, dst: torch.Tensor, block_elems: int) -> int:
    """Validate and return N, the number of full blocks."""
    if block_elems <= 0 or block_elems % LANES:
        raise ValueError("block_elems must be a multiple of 128")
    if a.dim() != 1 or not a.is_contiguous():
        raise ValueError(f"a: expected a contiguous 1-D tensor, got {tuple(a.shape)}")
    nblocks = a.shape[0] // block_elems
    if dst.shape != (nblocks,) or dst.dtype != torch.int32:
        raise ValueError(f"dst: expected ({nblocks},) int32, got {tuple(dst.shape)} {dst.dtype}")
    if dst.device != a.device:
        raise ValueError("a and dst must share a device")
    return nblocks


def _move_plain(a: torch.Tensor, dst: torch.Tensor, nblocks: int, block_elems: int) -> None:
    """Gather the N full blocks by the inverse of dst, written back into a."""
    src = torch.empty(nblocks, dtype=torch.int64, device=a.device)
    src[dst.to(torch.int64)] = torch.arange(nblocks, device=a.device)
    body = a[: nblocks * block_elems].view(nblocks, block_elems)
    body.copy_(body[src])


def _move_kernel(a: torch.Tensor, dst: torch.Tensor, nblocks: int, block_elems: int) -> None:
    block_bytes = block_elems * a.element_size()
    if a.data_ptr() % 16:
        raise ValueError("a: the kernel moves 16-byte words; data_ptr must be 16-byte aligned")
    if 2 * block_bytes > _SMEM_BYTES:
        raise ValueError(f"two blocks of {block_bytes} B exceed one CTA's shared memory")
    scratch = torch.zeros(nblocks + 1, dtype=torch.int32, device=a.device)  # states, cursor
    lib = _build.library("block_permute", _SIGNATURES)
    err = lib.block_permute_by_dest(a.data_ptr(), dst.contiguous().data_ptr(),
                                    scratch.data_ptr(), nblocks, block_bytes // 16,
                                    _build.stream_handle(a.device))
    _build.check(lib, "block_permute", err, "permute_blocks_by_dest kernel")
    _build.LAUNCHES["permute_blocks_by_dest"] += 1


def _permute(a, dst, block_elems, plain):
    nblocks = _check(a, dst, block_elems)
    if nblocks <= 1:
        return a
    if plain:
        _move_plain(a, dst, nblocks, block_elems)
    else:
        _move_kernel(a, dst, nblocks, block_elems)
    return a


def permute_blocks_by_dest(a: torch.Tensor, dst: torch.Tensor, *,
                           block_elems: int = 1024) -> torch.Tensor:
    """Move block i of ``a`` (n,) to slot ``dst[i]``, in place: the K8 kernel
    on a CUDA tensor, its plain twin on a CPU tensor.

    ``dst`` (N,) int32 is a permutation of [0, N), N = n // block_elems
    (:func:`stable_block_dest` gives the stable bucket grouping).  The
    trailing n % block_elems elements stay untouched; ``block_elems`` must
    be a multiple of 128.  Returns ``a`` itself, permuted.
    """
    return _permute(a, dst, block_elems, _device_kind(a) == "cpu")


def permute_blocks_by_dest_plain(a: torch.Tensor, dst: torch.Tensor, *,
                                 block_elems: int = 1024) -> torch.Tensor:
    """K8's plain torch twin on any device: the gather by the inverse of
    ``dst``, written back into ``a`` (it allocates a copy of the blocks).
    Returns ``a``."""
    return _permute(a, dst, block_elems, True)
