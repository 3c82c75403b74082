"""K5 ``merge_path_perm``: the stable 2-way merge permutation.

Counterpart of ``repro.kernels.merge_path`` (the Pallas TPU kernel at
``merge_path.py:157`` and its XLA diagonal search ``merge_path_partition``
at ``:76``).  The CUDA kernel is in ``csrc/merge_path.cu``, whose header
note gives its bound and design.  The wrapper launches the kernel on a CUDA
tensor (key ``merge_path`` of ``_build.LAUNCHES`` for int32 codes,
``merge_path64`` for int64 codes; one device kernel a call) and runs the
plain twin ``merge_path_perm_plain`` only on a CPU tensor; there is no
fallback from one to the other.

The plain twin is the rank formula of the reference's
``kernels/ref.py::merge_path_perm_ref`` (its "xla" merge engine): a[i]
lands at i + #{b < a[i]} and b[j] at j + #{a <= b[j]}, two
``torch.searchsorted`` calls and one scatter.

Keys are the port's encoded codes (``ops.keyspace``), compared as signed
ints: int32 for keys of 32 bits or fewer, int64 for the 64-bit key dtypes.
The reference merges its unsigned codes of any width; the stream layer
encodes before it merges.  A step of the int64 kernel is half as long (two
stages of eight-byte keys must fit a CTA's shared memory), so it takes
tiles up to ``MAX_TILE64``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = [
    "launch_info",
    "merge_path_partition",
    "merge_path_perm",
    "merge_path_perm_plain",
    "max_tile",
    "TILE",
    "MAX_TILE",
    "MAX_TILE64",
    "MAX_OUTPUTS",
]

TILE = 2048  # outputs a CTA merges at a step of its persistent loop: 256 threads x 8
MAX_TILE = 16384  # the largest tile taken; the kernel runs one above 8192 as steps of 8192
MAX_TILE64 = 8192  # the same for int64 codes, whose steps are at most 4096
MAX_OUTPUTS = 1 << 30  # the reference's int32 source encoding (_PAD_SRC)

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "merge_path_perm": (_P, _I, _P, _I, _I, _P, _P),
    "merge_path_perm64": (_P, _I, _P, _I, _I, _P, _P),
    "merge_path_info": (_I, _I, _P),
}
_KEY_BYTES = {torch.int32: 4, torch.int64: 8}


def max_tile(key_bytes: int) -> int:
    """The largest tile K5 takes for codes of ``key_bytes`` (4 or 8).

    >>> max_tile(4), max_tile(8)
    (16384, 8192)
    """
    return MAX_TILE64 if key_bytes == 8 else MAX_TILE


def _check_tile(tile: int, key_bytes: int) -> None:
    top = max_tile(key_bytes)
    if tile < 1 or tile & (tile - 1) or tile > top:
        raise ValueError(f"tile={tile} must be a power of two in [1, {top}] for "
                         f"{8 * key_bytes}-bit codes")


def _check(a: torch.Tensor, b: torch.Tensor, tile: int) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.dim() != 1 or x.dtype not in _KEY_BYTES or not x.is_contiguous():
            raise ValueError(f"merge_path_perm {name}: expected a contiguous 1-D int32 or "
                             f"int64 tensor of encoded keys, got {tuple(x.shape)} {x.dtype}")
    if a.dtype != b.dtype:
        raise ValueError(f"merge_path_perm: a is {a.dtype}, b is {b.dtype}")
    if a.shape[0] + b.shape[0] >= MAX_OUTPUTS:
        raise ValueError("runs too long for the int32 source encoding "
                         f"({a.shape[0]} + {b.shape[0]} >= 2^30)")
    _check_tile(tile, _KEY_BYTES[a.dtype])
    if a.device != b.device:
        raise ValueError("merge_path_perm: a and b must share a device")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {a.device}")


def merge_path_partition(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The number of ``a`` keys among the first ``d`` outputs of the stable
    merge (ties to ``a``), for every diagonal in ``d``: the largest i in
    [max(0, d-nB), min(d, nA)] with ``a[i-1] <= b[d-i]``, by a binary search
    over all diagonals at once.  The plain form of what K5's cut kernel
    finds at a CTA's first tile boundary, and then in shared memory at
    every later one."""
    nA, nB = a.shape[0], b.shape[0]
    d = d.to(torch.int64)
    lo = torch.clamp(d - nB, min=0)
    hi = torch.clamp(d, max=nA)
    for _ in range(nA.bit_length() + 1):
        active = lo < hi
        mid = (lo + hi + 1) // 2
        am = a[torch.clamp(mid - 1, 0, max(nA - 1, 0))] if nA else torch.zeros_like(mid)
        bj = b[torch.clamp(d - mid, 0, max(nB - 1, 0))] if nB else torch.zeros_like(mid)
        q = am <= bj
        lo2 = torch.where(q, mid, lo)
        hi2 = torch.where(q, hi, mid - 1)
        lo, hi = torch.where(active, lo2, lo), torch.where(active, hi2, hi)
    return lo.to(torch.int32)


def merge_path_perm_plain(a: torch.Tensor, b: torch.Tensor, *, tile: int = TILE) -> torch.Tensor:
    """K5's plain torch twin on any device: the rank formula (``tile`` is
    checked, never used)."""
    _check(a, b, tile)
    nA, nB = a.shape[0], b.shape[0]
    if nA == 0 or nB == 0:
        return torch.arange(nA + nB, dtype=torch.int32, device=a.device)
    ai = torch.arange(nA, dtype=torch.int64, device=a.device)
    bi = torch.arange(nB, dtype=torch.int64, device=a.device)
    perm = torch.empty(nA + nB, dtype=torch.int32, device=a.device)
    perm[ai + torch.searchsorted(b, a, side="left")] = ai.to(torch.int32)
    perm[bi + torch.searchsorted(a, b, side="right")] = (nA + bi).to(torch.int32)
    return perm


def merge_path_perm(a: torch.Tensor, b: torch.Tensor, *, tile: int = TILE) -> torch.Tensor:
    """Stable-merge permutation of two sorted runs of encoded int32 or int64
    keys (one dtype): the K5 kernel on a CUDA tensor, its plain twin on a
    CPU tensor.

    ``tile`` is the outputs a CTA merges at a time, a power of two up to
    :func:`max_tile` of the codes' width; it never changes the result.  Returns ``perm`` (nA+nB,) int32 with ``cat(a, b)[perm]`` the
    stable merge: ties keep all of ``a`` before ``b``, each run in its own
    order.  Raises for nA + nB >= 2^30, as the reference does.
    """
    if a.device.type == "cpu":
        return merge_path_perm_plain(a, b, tile=tile)
    _check(a, b, tile)
    nA, nB = a.shape[0], b.shape[0]
    if nA == 0 or nB == 0:  # nothing to interleave
        return torch.arange(nA + nB, dtype=torch.int32, device=a.device)
    perm = torch.empty(nA + nB, dtype=torch.int32, device=a.device)
    lib = _build.library("merge_path", _SIGNATURES)
    wide = a.dtype == torch.int64
    launch = lib.merge_path_perm64 if wide else lib.merge_path_perm
    err = launch(a.data_ptr(), nA, b.data_ptr(), nB, tile, perm.data_ptr(),
                 _build.stream_handle(a.device))
    _build.check(lib, "merge_path", err, "merge_path kernel")
    _build.LAUNCHES["merge_path64" if wide else "merge_path"] += 1
    return perm


def launch_info(tile: int = TILE, key_bytes: int = 4) -> dict:
    """The kernel's launch at ``tile`` for codes of ``key_bytes`` (4 or 8),
    from the CUDA runtime (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): registers per
    thread, static and dynamic shared memory per CTA in bytes, threads per
    CTA, CTAs an SM holds at once and local memory per thread in bytes
    (spills).  Builds and loads the library; needs a card."""
    if key_bytes not in (4, 8):
        raise ValueError(f"key_bytes={key_bytes}: K5 takes 4- or 8-byte codes")
    _check_tile(tile, key_bytes)
    out = (ctypes.c_int * 6)()
    lib = _build.library("merge_path", _SIGNATURES)
    _build.check(lib, "merge_path", lib.merge_path_info(tile, key_bytes, ctypes.addressof(out)),
                 "merge_path kernel")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads", "ctas_per_sm",
                     "local_bytes"), out))
