"""K11 ``flash_attention``: fused forward attention, causal and/or windowed.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the
Pallas TPU kernel at ``flash_attention.py:102``), which lies on no model
path of the reference: only its tests call it, and here ``chip_smoke.py``
drives it at the served model's prefill shape.  The CUDA kernels are in
``csrc/flash_attention.cu``, whose header note gives their bound (flops:
~0.14 ms for a causal (1, 32, 4096, 128) call on the H100's bf16 tensor
cores, ~0.83 ms for the float32 kernel's three TF32 products) and design.
Both run on the tensor cores.  bfloat16: TMA loads of q and of a 2-stage
ring of K and V tiles, ``wgmma`` for both products, the online softmax in
registers (the first design ran both products in f32 FMA on the CUDA
cores, 48x the bound).  float32: 3xTF32 ``wgmma``, each operand split into
a big and a small tf32 term and each product taken as small x big + big x
small + big x big, which keeps the float32 limit (2e-5 + 2e-5 |want|) that
plain TF32 would miss; the threads stage q, K and V (transposed) into their
split copies themselves (the first float32 design ran both products in
f32 FMA on the CUDA cores).

Query row i attends key j iff (not causal or j <= i) and (no window or
j > i - window); the window also applies when ``causal=False``, as in the
reference.  The scale 1/sqrt(hd) is applied to q (the bf16 kernel scales
the f32 scores, the same up to f32 rounding), masked scores are -1e30 with
a weight of exactly 0, the softmax is f32 and the output has q's dtype
(float32 or bfloat16).  KV heads that divide the query heads are read as
groups (head h reads KV head h // group), through strides.

The wrapper launches a kernel on CUDA tensors (launch keys
``flash_attention`` for bfloat16 and ``flash_attention_f32``) and runs the
plain twin (``kernels.ref.flash_attention_ref``) only on CPU tensors; there
is no fallback from one to the other.  Both kernels read 16-byte pieces
(TMA for bfloat16, 16-byte loads for float32) and need 16-byte aligned
pointers and strides; a tensor without them is copied once to a contiguous
layout, counted in :data:`LAYOUT_COPIES`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "launch_info", "HEAD_DIMS", "LAYOUT_COPIES"]

HEAD_DIMS = (64, 128)  # the kernel's compiled head dims
_P, _I, _L, _F = _build.P, _build.I, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {"flash_attention_launch": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _I,
                                          _I, _I, _I, _I, _I, _I, _F, _I, _P, _P),
               "flash_attention_f32_info": (_I, _I, _I, _I, _P)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH_KEYS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention"}
# inputs copied to a contiguous layout for 16-byte reads (the count of copies)
LAYOUT_COPIES = {"flash_attention": 0}


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it in 16-byte pieces (16-byte
    aligned pointer and batch, head and seq strides, a unit inner stride),
    else one contiguous copy, counted in ``LAYOUT_COPIES``."""
    aligned = x.data_ptr() % 16 == 0 and all(
        (st * x.element_size()) % 16 == 0 for st in x.stride()[:3])
    if aligned and x.stride(-1) == 1:
        return x
    LAYOUT_COPIES["flash_attention"] += 1
    return x.contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q (B, H, S, hd) and k, v (B, KVH, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, hd) or h % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match k, v "
                         f"{tuple(k.shape)} (the KV heads must divide the query heads)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Fused attention of q (B, H, S, hd) over k, v (B, KVH, S, hd), KVH
    dividing H (the reference's pre-expanded KVH = H included) -> (B, H, S,
    hd) in q's dtype: the K11 kernel on CUDA tensors, its plain twin on CPU
    tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, s, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: hd={hd} is not one of {HEAD_DIMS}")
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name}'s head dim must be contiguous")
    out = torch.empty((b, h, s, hd), dtype=q.dtype, device=q.device)
    lib = _build.library("flash_attention", _SIGNATURES)
    err = lib.flash_attention_launch(
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], b, h, s, hd, h // k.shape[1], int(causal), int(window),
        1.0 / math.sqrt(hd), _DTYPES[q.dtype], out.data_ptr(), _build.stream_handle(q.device),
    )
    _build.check(lib, "flash_attention", err, "flash_attention kernel")
    _build.LAUNCHES[_LAUNCH_KEYS[q.dtype]] += 1
    return out


def launch_info(b: int, h: int, s: int, hd: int) -> dict:
    """The float32 kernel's launch for a (b, h, s, hd) call, from the CUDA
    runtime: registers per thread, static and dynamic shared memory per CTA
    in bytes, threads per CTA, the CTAs an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), local memory per
    thread in bytes (spills) and the CTAs of the grid.  Builds and loads the
    library; needs a card."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: hd={hd} is not one of {HEAD_DIMS}")
    out = (ctypes.c_int * 7)()
    lib = _build.library("flash_attention", _SIGNATURES)
    err = lib.flash_attention_f32_info(b, h, s, hd, ctypes.addressof(out))
    _build.check(lib, "flash_attention", err, "flash_attention kernel")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads", "ctas_per_sm",
                     "local_bytes", "ctas"), out))
