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

The kernel cuts the cycles of ``dst`` into chains that teams of threads
follow at once: one warp holding its block in registers for a block of up
to 4 KB, a CTA of up to 29 warps holding it in shared memory above that.
:func:`team_shape` picks the team for a block size; blocks of 128 B to
``MAX_BLOCK_BYTES`` are taken, and the wrapper raises on any other size.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sampling import signed_payload
from repro_torch.kernels import _build
from repro_torch.kernels.level_fused import _device_kind

__all__ = [
    "permute_blocks_by_dest",
    "permute_blocks_by_dest_plain",
    "stable_block_dest",
    "team_shape",
    "launch_info",
    "LANES",
    "MAX_BLOCK_BYTES",
]

LANES = 128
# the largest block the kernel takes: half the shared memory one H100 CTA
# may use (232,448 B), the limit of the design that held two blocks there;
# the teams keep it: at most 29 warps of 8 words a lane
MAX_BLOCK_BYTES = 116_224
_WARP_WORDS = 32 * 8  # 16-byte words a warp holds at 8 a lane: 4 KB

_P, _I = _build.P, _build.I
_SIGNATURES = {"block_permute_by_dest": (_P, _P, _P, _I, _I, _I, _I, _P),
               "block_permute_info": (_I, _I, _I, _I, _P)}


def team_shape(block_bytes: int) -> tuple:
    """(warps, words per lane) of the team that moves one block of
    ``block_bytes``, as 16-byte words: one warp with 1, 2, 4
    or 8 words a lane up to 4 KB, else ceil(words / 256) warps with 8 a
    lane.  Raises for a size the kernel does not take (not a multiple of
    128 B, or outside [128, MAX_BLOCK_BYTES]).

    >>> team_shape(4096), team_shape(128), team_shape(16384)
    ((1, 8), (1, 1), (4, 8))
    """
    if block_bytes % 128 or not 128 <= block_bytes <= MAX_BLOCK_BYTES:
        raise ValueError(f"permute_blocks_by_dest kernel: blocks of {block_bytes} B; it takes "
                         f"multiples of 128 B up to {MAX_BLOCK_BYTES} B")
    words = block_bytes // 16
    if words <= _WARP_WORDS:
        return 1, next(w for w in (1, 2, 4, 8) if 32 * w >= words)
    return -(-words // _WARP_WORDS), 8


def launch_info(nblocks: int, block_bytes: int) -> dict:
    """The kernel's launch for N blocks of that size, from the CUDA runtime:
    registers and local memory (spills) per thread, threads per CTA, CTAs,
    teams (the chains in flight) and dynamic shared memory per CTA.  Builds
    and loads the library; needs a card."""
    out = (ctypes.c_int * 6)()
    lib = _build.library("block_permute", _SIGNATURES)
    err = lib.block_permute_info(nblocks, block_bytes // 16, *team_shape(block_bytes),
                                 ctypes.addressof(out))
    _build.check(lib, "block_permute", err, "permute_blocks_by_dest kernel")
    return dict(zip(("registers", "local_bytes", "threads", "ctas", "teams", "dynamic_smem"),
                    out))


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
    # the signed view: torch's unsigned dtypes have no gather on a card
    body = signed_payload(a)[: nblocks * block_elems].view(nblocks, block_elems)
    body.copy_(body[src])


def _move_kernel(a: torch.Tensor, dst: torch.Tensor, nblocks: int, block_elems: int) -> None:
    block_bytes = block_elems * a.element_size()
    if a.data_ptr() % 16:
        raise ValueError("a: the kernel moves 16-byte words; data_ptr must be 16-byte aligned")
    warps, wpl = team_shape(block_bytes)
    scratch = torch.zeros(nblocks + 1, dtype=torch.int32, device=a.device)  # states, cursor
    lib = _build.library("block_permute", _SIGNATURES)
    err = lib.block_permute_by_dest(a.data_ptr(), dst.contiguous().data_ptr(),
                                    scratch.data_ptr(), nblocks, block_bytes // 16, warps,
                                    wpl, _build.stream_handle(a.device))
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
