"""K6: the stable counting placement, dest = start[b] + #earlier equal ids.

Counterpart of ``repro.kernels.dispatch_rank`` (the Pallas TPU kernels
``dispatch_ranks`` at ``dispatch_rank.py:87``, ``partition_ranks`` at
``:154`` and ``partition_ranks_batched`` at ``:224``).  The three share one
contract and are one CUDA kernel with a row dimension here, in
``csrc/dispatch_rank.cu``, whose header note gives its bound and design.
Each wrapper launches it on a CUDA tensor, under its own key of
``_build.LAUNCHES``, and runs the plain twin only on a CPU tensor; there is
no fallback from one to the other.

For each row, an id b in [0, nb) at position i gets ``start[b]`` plus the
number of earlier positions of the row with id b; any other id (the trash
id nb that the reference pads with) is ignored, touches no counter and gets
-1.  The plain twin is that formula (``kernels/ref.py::partition_ranks_ref``
lifted over rows); with the starts the exclusive prefix of the counts it is
``dispatch_ranks_ref``, the inverse of the stable argsort of the ids.

The kernel is one pass with a look-back over the earlier tiles' counts:
:func:`schedule` gives its CTA shape and the scratch it needs, which the
wrapper allocates (a ticket and rows x tiles x nb 4-byte status words) and
the kernel's C entry point zeroes with one memset before its one launch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.level_fused import _slot_rank_hist

__all__ = [
    "dispatch_ranks",
    "dispatch_ranks_plain",
    "partition_ranks",
    "partition_ranks_plain",
    "partition_ranks_batched",
    "partition_ranks_batched_plain",
    "schedule",
    "launch_info",
    "TILE",
    "MAX_NB",
]

TILE = 8192  # ids per ticket (a CTA ranks one tile at a time)
MAX_NB = 4096  # counters per CTA: 6 warps at MAX_NB (``_smem_bytes``)
_SMEM_BYTES = 232_448  # shared memory one CTA may use on the H100
_HEADER = 16  # the ticket's bytes at the head of the scratch (and of shared memory)
_SPAN = 512  # positions a warp ranks: 16 chunks of 32, in registers
_MAX_WARPS = 32
_P, _I = _build.P, _build.I
_SIGNATURES = {"dispatch_rank_place": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
               "dispatch_rank_info": (_I, _I, _P)}


def _smem_bytes(nb: int, warps: int) -> int:
    """The CTA's shared memory: per id the counts of the last two tiles and
    a base (4 B each), per warp and id a peer mask (4 B) and a 16-bit
    counter, two tiles of packed ranks (4 B a position), the look-back's
    rounds (16 B a thread) and the tickets."""
    return (_HEADER + nb * (12 + 6 * warps) + (warps * nb & 1) * 2 + 2 * warps * _SPAN * 4
            + 4 * 4 * 32 * warps)


def schedule(nb: int, tile: int) -> Tuple[int, int]:
    """(warps, tile) of the kernel's CTA for ``tile`` ids a ticket at
    ``nb`` counters: a warp per 512 ids, as many as shared memory holds (6
    at nb = 4096, at most 32); a tile above warps x 512 is cut to that.
    The placement never depends on the tile."""
    warps = max(1, min(-(-tile // _SPAN), _MAX_WARPS))
    while warps > 1 and _smem_bytes(nb, warps) > _SMEM_BYTES:
        warps -= 1
    return warps, min(tile, warps * _SPAN)


def _check(ids: torch.Tensor, start: torch.Tensor, nb: int, tile: int, dim: int) -> None:
    if ids.dim() != dim or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"expected contiguous {dim}-D int32 ids, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    want = ids.shape[:-1] + (nb,)
    if start.shape != want or start.dtype != torch.int32:
        raise ValueError(f"start: expected {want} int32, got {tuple(start.shape)} {start.dtype}")
    if start.device != ids.device:
        raise ValueError("ids and start must share a device")
    if ids.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {ids.device}")
    if ids.numel() >= 2**31:
        raise ValueError(f"{ids.numel()} ids exceed int32 positions")
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"nb={nb} must be in [1, {MAX_NB}] (the counters of one CTA)")
    if tile < 1:  # any larger tile fits: ``schedule`` cuts it to what a CTA holds
        raise ValueError(f"tile={tile} must be positive")


def _place_plain(ids: torch.Tensor, start: torch.Tensor, nb: int) -> torch.Tensor:
    """The counting placement of (rows, n) ids against (rows, nb) starts."""
    rows, n = ids.shape
    valid = (ids >= 0) & (ids < nb)
    row = torch.arange(rows, dtype=torch.int32, device=ids.device)[:, None]
    slot = torch.where(valid, row * nb + ids, rows * nb)  # one slot takes the rest
    rank, _ = _slot_rank_hist(slot.reshape(-1), rows * nb + 1)
    base = torch.cat([start.reshape(-1), start.new_zeros(1)])[slot.reshape(-1).to(torch.int64)]
    return torch.where(valid.reshape(-1), base + rank, -1).reshape(rows, n)


def _place_kernel(ids: torch.Tensor, start: torch.Tensor, nb: int, tile: int,
                  name: str) -> torch.Tensor:
    rows, n = ids.shape
    warps, tile = schedule(nb, tile)
    dest = torch.empty_like(ids)
    scratch = torch.empty(_HEADER + rows * -(-n // tile) * nb * 4, dtype=torch.uint8,
                          device=ids.device)
    lib = _build.library("dispatch_rank", _SIGNATURES)
    err = lib.dispatch_rank_place(ids.data_ptr(), start.contiguous().data_ptr(), rows, n, nb,
                                  tile, warps, scratch.data_ptr(), dest.data_ptr(),
                                  _build.stream_handle(ids.device))
    _build.check(lib, "dispatch_rank", err, f"{name} kernel")
    _build.LAUNCHES[name] += 1
    return dest


def _place(ids, start, nb, tile, name, plain):
    dim = 2 if name == "partition_ranks_batched" else 1
    _check(ids, start, nb, tile, dim)
    if _build.is_fake(ids):
        # the dry run: a dest of the right shape, and the bytes the kernel
        # moves (an id read and a dest written, 8 B an id, plus the starts)
        _build.note_fake(name, 0.0, 8.0 * ids.numel() + 4.0 * start.numel())
        return torch.empty_like(ids)
    ids2, start2 = (ids, start) if dim == 2 else (ids[None], start[None])
    if plain or ids.device.type == "cpu":
        dest = _place_plain(ids2, start2, nb)
    else:
        dest = _place_kernel(ids2, start2, nb, tile, name)
    return dest if dim == 2 else dest[0]


def dispatch_ranks(expert_id: torch.Tensor, expert_start: torch.Tensor, *, num_experts: int,
                   tile: int = TILE) -> torch.Tensor:
    """Destination slot per token for expert-major grouping: ``expert_id``
    (n,) int32 in [0, num_experts), ``expert_start`` (num_experts,) int32
    (the exclusive prefix of the expert counts, for a permutation).  The K6
    kernel on a CUDA tensor, its plain twin on a CPU tensor.  Any n."""
    return _place(expert_id, expert_start, num_experts, tile, "dispatch_ranks", False)


def dispatch_ranks_plain(expert_id: torch.Tensor, expert_start: torch.Tensor, *,
                         num_experts: int, tile: int = TILE) -> torch.Tensor:
    """``dispatch_ranks``'s plain torch twin on any device."""
    return _place(expert_id, expert_start, num_experts, tile, "dispatch_ranks", True)


def partition_ranks(bucket: torch.Tensor, start: torch.Tensor, *, nb: int,
                    tile: int = TILE) -> torch.Tensor:
    """Stable counting destination per element of ``bucket`` (n,) int32
    against ``start`` (nb,) int32 (any starts, not only a prefix); ids
    outside [0, nb) are ignored and get -1.  The K6 kernel on a CUDA tensor,
    its plain twin on a CPU tensor."""
    return _place(bucket, start, nb, tile, "partition_ranks", False)


def partition_ranks_plain(bucket: torch.Tensor, start: torch.Tensor, *, nb: int,
                          tile: int = TILE) -> torch.Tensor:
    """``partition_ranks``'s plain torch twin on any device."""
    return _place(bucket, start, nb, tile, "partition_ranks", True)


def partition_ranks_batched(bucket: torch.Tensor, start: torch.Tensor, *, nb: int,
                            tile: int = TILE) -> torch.Tensor:
    """Per-row stable counting destinations: ``bucket`` (B, n) int32 against
    ``start`` (B, nb) int32; row b's element goes to ``start[b, id]`` plus
    the earlier row-b elements with that id.  The K6 kernel with B rows on a
    CUDA tensor, its plain twin on a CPU tensor.  Returns (B, n) int32."""
    return _place(bucket, start, nb, tile, "partition_ranks_batched", False)


def partition_ranks_batched_plain(bucket: torch.Tensor, start: torch.Tensor, *, nb: int,
                                  tile: int = TILE) -> torch.Tensor:
    """``partition_ranks_batched``'s plain torch twin on any device."""
    return _place(bucket, start, nb, tile, "partition_ranks_batched", True)


def launch_info(nb: int, tile: int = TILE) -> dict:
    """The kernel's launch at ``nb`` and ``tile``, from the CUDA runtime
    (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``):
    registers per thread, static and dynamic shared memory per CTA in
    bytes, threads per CTA, CTAs an SM holds at once (the persistent grid
    is that times the SMs) and local memory per thread in bytes (spills).
    Builds and loads the library; needs a card."""
    if not 1 <= nb <= MAX_NB or tile < 1:
        raise ValueError(f"nb={nb} must be in [1, {MAX_NB}] and tile={tile} positive")
    out = (ctypes.c_int * 6)()
    lib = _build.library("dispatch_rank", _SIGNATURES)
    _build.check(lib, "dispatch_rank",
                 lib.dispatch_rank_info(nb, schedule(nb, tile)[0], ctypes.addressof(out)),
                 "dispatch_rank kernel")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads", "ctas_per_sm",
                     "local_bytes"), out))
