"""K3 ``sort_windows``: the stable base-case window sort.

Counterpart of ``repro.kernels.bitonic.bitonic_sort_windows`` (the Pallas
TPU kernel at ``bitonic.py:72``).  The CUDA kernel is in
``csrc/bitonic.cu``, whose header note gives its bound (bytes: 16 B an
element, ~0.08 ms for 2^24) and design: each element a 64-bit word
(bucket, key, window index), a bitonic network whose steps run in
registers, E = 16 words a thread (32 at W = 16384), with the window going
through shared memory only to re-map which index bits a thread's registers
span (24 exchanges at W = 8192 where the first design made 91 block-wide
passes).  The TPU network compares (bucket, key) only and is not stable;
this one orders by (bucket, key, idx), so it equals the stable
``_window_perm`` that the reference's main path computes in XLA, which is
its plain twin here.  int64 keys (64-bit key dtypes) take the kernel's
64-bit form, counted under ``sort_windows64``: each element 12 B, the
96-bit number (bucket, key, idx) as a high and a low word, sorted from W =
16 by a stable merge sort inside the CTA (E = 8 elements a thread up to W
= 128, 16 up to 1024 and 32 above, sorted in registers by an odd-even
network, then log2(W / E) merge rounds through the window in shared
memory, each thread finding its diagonal by a binary search and merging
its E outputs serially), and by one thread a window below.

The wrapper launches the kernel on a CUDA tensor and runs the plain twin
only on a CPU tensor; there is no fallback from one to the other.  The
kernel reads 16 bytes at a time, so an input whose pointer is not 16-byte
aligned is copied once.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["sort_windows", "sort_windows_plain", "window_perm_plain", "launch_info",
           "MAX_W"]

MAX_W = 16384  # W 8-byte words in shared memory
_P, _I = _build.P, _build.I
_SIGNATURES = {"bitonic_sort_windows": (_P, _P, _I, _I, _I, _P, _P, _P),
               "bitonic_sort_windows64": (_P, _P, _I, _I, _I, _P, _P, _P),
               "bitonic_sort_windows64_info": (_I, _P)}


def window_perm_plain(bucket_w: torch.Tensor, keys_w: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic (bucket, key) sort permutation per window
    (num_w, W) as int64: the reference's ``_window_perm``, two stable
    argsorts."""
    o1 = torch.sort(keys_w, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(bucket_w, 1, o1), dim=1, stable=True).indices
    return torch.gather(o1, 1, o2)


def _check(bucket: torch.Tensor, keys: torch.Tensor, nb: int) -> None:
    for name, x, dtypes in (("bucket", bucket, (torch.int32,)),
                            ("keys", keys, (torch.int32, torch.int64))):
        if x.dim() != 2 or x.dtype not in dtypes or not x.is_contiguous():
            raise ValueError(f"sort_windows {name}: expected a contiguous (num_w, W) "
                             f"{' or '.join(map(str, dtypes))} tensor, got {tuple(x.shape)} "
                             f"{x.dtype}")
    if bucket.shape != keys.shape or bucket.device != keys.device:
        raise ValueError("sort_windows: bucket and keys must share shape and device")
    W = keys.shape[1]
    if W < 2 or W & (W - 1) or W > MAX_W:
        raise ValueError(f"W={W} must be a power of two in [2, {MAX_W}]")
    # the kernel packs (bucket, idx) into 32 bits (with a 32-bit key, all
    # three into one 64-bit word)
    bucket_bits = 32 - (W.bit_length() - 1)
    if nb > 1 << bucket_bits:
        raise ValueError(f"nb={nb} buckets do not fit {bucket_bits} bits at W={W}")


def launch_info(W: int, key_bits: int = 64) -> dict:
    """K3's launch at window size W for 64-bit keys, from the CUDA runtime
    (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``):
    registers per thread, static and dynamic shared memory per CTA in
    bytes, threads per CTA, CTAs an SM holds at once and local memory per
    thread in bytes (spills).  Builds and loads the library; needs a card."""
    if key_bits != 64:
        raise ValueError(f"key_bits={key_bits}: only the 64-bit form reports its launch")
    if W < 2 or W & (W - 1) or W > MAX_W:
        raise ValueError(f"W={W} must be a power of two in [2, {MAX_W}]")
    out = (ctypes.c_int * 6)()
    lib = _build.library("bitonic", _SIGNATURES)
    _build.check(lib, "bitonic", lib.bitonic_sort_windows64_info(W.bit_length() - 1,
                                                                  ctypes.addressof(out)),
                 "sort_windows64 kernel")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads", "ctas_per_sm",
                     "local_bytes"), out))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when its pointer is not 16-byte aligned."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def sort_windows_plain(
    bucket: torch.Tensor, keys: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's plain torch twin on any device: (window-local permutation,
    sorted bucket ids), both (num_w, W) int32."""
    _check(bucket, keys, nb)
    perm = window_perm_plain(bucket, keys)
    return perm.to(torch.int32), torch.gather(bucket, 1, perm)


def sort_windows(
    bucket: torch.Tensor, keys: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stably sort each window (row) of (num_w, W) int32 ``bucket`` ids in
    [0, nb) and encoded int32 or int64 ``keys`` by (bucket, key): the K3
    kernel (its 64-bit form for int64 keys) on a CUDA tensor, its plain
    twin on a CPU tensor.

    Returns (perm, sorted bucket), both (num_w, W) int32; ``perm`` holds
    window-local indices.
    """
    if bucket.device.type == "cpu":
        return sort_windows_plain(bucket, keys, nb)
    if bucket.device.type != "cuda":
        raise ValueError(f"unsupported device {bucket.device}")
    _check(bucket, keys, nb)
    num_w, W = keys.shape
    bucket, keys = _aligned(bucket), _aligned(keys)
    perm = torch.empty_like(bucket)
    bucket_out = torch.empty_like(bucket)
    wide = "64" if keys.dtype == torch.int64 else ""
    lib = _build.library("bitonic", _SIGNATURES)
    err = getattr(lib, "bitonic_sort_windows" + wide)(
        bucket.data_ptr(), keys.data_ptr(), num_w, W, W.bit_length() - 1,
        perm.data_ptr(), bucket_out.data_ptr(), _build.stream_handle(keys.device),
    )
    _build.check(lib, "bitonic", err, f"sort_windows{wide} kernel")
    _build.LAUNCHES["sort_windows" + wide] += 1
    return perm, bucket_out
