"""K10 ``flash_decode``: one new token's attention over a KV cache.

Counterpart of ``repro.kernels.flash_decode.flash_decode`` (the Pallas TPU
kernel at ``flash_decode.py:70``).  The CUDA kernel is in
``csrc/flash_decode.cu``, whose header note gives its bound and design:
one launch per call, a thread-block cluster of 8 (or 16) CTAs per
(request, KV head), each CTA taking a share of the valid prefix through
``cp.async`` rings, in bf16 on the tensor cores (``mma.sync``; group <= 16
and hd in {16, 32, 64, 128}, every config) and otherwise with FMAs, the
shares' partial softmax states combined through distributed shared
memory.  It reads the cache through strides with a GQA ``group`` (query
head h reads KV head h // group), so the decode step hands it the cache in
its own (B, T, KVH, hd) layout (``flash_decode_cache``), with no copy; the
reference's (B, H, T, hd) contract is ``flash_decode``.  Each request b
attends to its cache rows [0, length[b]) in an f32 online softmax, with
the TPU kernel's edges: masked scores are -1e30 with a weight of exactly
0, the scale 1/sqrt(hd) is applied to q, and length 0 gives 0 (the
``max(l, 1e-30)`` divisor).  The output has q's dtype (float32 or
bfloat16).

The wrappers launch the kernel on CUDA tensors and run the plain twin
(``kernels.ref.flash_decode_ref``) only on CPU tensors; there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_ref

__all__ = ["flash_decode", "flash_decode_cache", "launch_info", "MAX_GROUP_HD"]

MAX_GROUP_HD = 4096  # group * hd accumulators: 16 per thread of 256
_P, _I, _L, _F = _build.P, _build.I, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {"flash_decode_launch": (_P, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _P, _I, _I,
                                       _I, _I, _I, _F, _I, _P, _P),
               "flash_decode_info": (_I, _I, _I, _I, _I, _P)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: expected q (B, H, hd) and k, v (B, KVH, T, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k.shape)} (the KV heads must divide the query heads)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if length.shape != (b,) or length.dtype.is_floating_point:
        raise ValueError(f"flash_decode: length must be (B,) integers, got "
                         f"{tuple(length.shape)} {length.dtype}")
    if len({q.device, k.device, v.device, length.device}) != 1:
        raise ValueError("flash_decode: q, k, v and length must be on one device")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            length: torch.Tensor) -> torch.Tensor:
    b, h, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    esize = q.element_size()
    if hd * esize % 16 or h // kvh * hd > MAX_GROUP_HD:
        raise ValueError(f"flash_decode kernel: hd={hd} must fill whole 16-byte loads and "
                         f"group * hd <= {MAX_GROUP_HD}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"flash_decode kernel: {name}'s head dim must be contiguous")
    for name, x in (("k", k), ("v", v)):
        if x.data_ptr() % 16 or any(s * esize % 16 for s in x.stride()[:3]):
            raise ValueError(f"flash_decode kernel: {name} rows must be 16-byte aligned")
    length = length.to(torch.int32).contiguous()
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    lib = _build.library("flash_decode", _SIGNATURES)
    err = lib.flash_decode_launch(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(2), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(2), v.stride(1),
        length.data_ptr(), b, t, kvh, h // kvh, hd, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
        out.data_ptr(), _build.stream_handle(q.device),
    )
    _build.check(lib, "flash_decode", err, "flash_decode kernel")
    _build.LAUNCHES["flash_decode"] += 1
    return out


def launch_info(b: int, kvh: int, group: int, hd: int, dtype: torch.dtype) -> dict:
    """The kernel's launch for a call of that shape, from the CUDA runtime
    (``cudaFuncGetAttributes``): registers per thread, static and dynamic
    shared memory per CTA in bytes, CTAs per cluster (the split of T),
    local memory per thread in bytes (spills), threads per CTA, the
    clusters the card holds at once, and whether the tensor-core kernel
    (bf16, group <= 16, hd in {16, 32, 64, 128}) or the FMA one runs.
    Builds and loads the library; needs a card."""
    out = (ctypes.c_int * 8)()
    lib = _build.library("flash_decode", _SIGNATURES)
    err = lib.flash_decode_info(b, kvh, group, hd, _DTYPES[dtype], ctypes.addressof(out))
    _build.check(lib, "flash_decode", err, "flash_decode kernel")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "cluster", "local_bytes",
                     "threads", "resident_clusters", "tensor_cores"), out))


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            length: torch.Tensor) -> torch.Tensor:
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return flash_decode_ref(q[:, :, None], k, v, length)[:, :, 0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, length)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """The reference's contract: q (B, H, 1, hd), k and v (B, H, T, hd)
    (GQA pre-expanded; KV heads that divide H are read as groups), length
    (B,) int32 -> (B, H, 1, hd) in q's dtype.  The K10 kernel on CUDA
    tensors, its plain twin on CPU tensors."""
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"flash_decode: expected q (B, H, 1, hd), got {tuple(q.shape)}")
    return _decode(q[:, :, 0], k, v, length)[:, :, None]


def flash_decode_cache(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       length: torch.Tensor) -> torch.Tensor:
    """The decode step's form: q (B, H, hd) against the cache in its own
    (B, T, KVH, hd) layout, read in place -> (B, H, hd) in q's dtype."""
    if k_cache.dim() != 4:
        raise ValueError(f"flash_decode: expected a (B, T, KVH, hd) cache, got "
                         f"{tuple(k_cache.shape)}")
    return _decode(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), length)
