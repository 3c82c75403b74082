"""G5: the keyspace codec and the sort's pad as kernels of their own.

The reference maps keys into its ordered keyspace and back, and pads them,
with XLA (``src/repro/ops/keyspace.py:94`` ``encode``, ``:118`` ``decode``,
``src/repro/core/ips4o.py:289``), which fuses on the TPU; these kernels are
no TPU kernel's counterpart.  The CUDA source is ``csrc/codec.cu``, whose
header note gives their bound (bytes) and design.  Each wrapper launches its
kernel on a CUDA tensor, runs its plain torch twin (``*_plain``: the eager
chain of ``ops.keyspace`` and the pad, the same outputs bit for bit) only on
a CPU tensor, and on the dry run's fake tensors launches nothing and reports
its bytes to ``_build.FAKE_HOOKS``.  They count under ``codec_encode``
and ``codec_decode`` in ``_build.LAUNCHES``.

- :func:`encode_padded`: keys (n,) or (B, n) of any of the twelve key
  dtypes to their int32/int64 codes in a buffer padded to ``n_pad`` with the
  sentinel, optionally complemented (the top-k's order reversal) and with
  the int32 index payload (``arange``, zeros in the pads).  One launch.
- :func:`decode`: the first n codes of each row back to the key dtype.  One
  launch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["encode_padded", "encode_padded_plain", "decode", "decode_plain", "kind_of"]

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "codec_encode": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "codec_decode": (_P, _I, _I, _I, _I, _I, _I, _P, _P),
}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def kind_of(dtype: torch.dtype) -> int:
    """The kernel's kind of a key dtype: 0 signed int, 1 unsigned int, 2
    IEEE float, 3 bfloat16."""
    if dtype == torch.bfloat16:
        return 3
    if dtype.is_floating_point:
        return 2
    return 1 if dtype in _UNSIGNED else 0


def _lib():
    return _build.library("codec", _SIGNATURES)


def _rows(x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() not in (1, 2):
        raise ValueError(f"codec: expected (n,) or (B, n), got {tuple(x.shape)}")
    return (1, x.shape[0]) if x.dim() == 1 else tuple(x.shape)


def encode_padded_plain(keys: torch.Tensor, n_pad: Optional[int] = None, index: bool = False,
                        complement: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`encode_padded`'s plain torch twin on any device: the eager
    ``ops.keyspace`` encode, ``~``, then zeros, a copy and the sentinel fill
    (``core.ips4o._pad``'s chain) for the codes and the index."""
    from repro_torch.ops import keyspace  # lazy: ops layers on the kernels

    n = keys.shape[-1]
    n_pad = n if n_pad is None else n_pad
    enc = keyspace.encode_plain(keys)
    if complement:
        enc = ~enc
    idx = None
    if index:
        idx = torch.arange(n, dtype=torch.int32, device=keys.device).expand(keys.shape)
    if n_pad == n:
        return enc, None if idx is None else idx.contiguous()
    codes = torch.zeros(keys.shape[:-1] + (n_pad,), dtype=enc.dtype, device=keys.device)
    codes[..., :n] = enc
    codes[..., n:] = torch.iinfo(enc.dtype).max
    if idx is not None:
        padded = torch.zeros(codes.shape, dtype=torch.int32, device=keys.device)
        padded[..., :n] = idx
        idx = padded
    return codes, idx


def encode_padded(keys: torch.Tensor, n_pad: Optional[int] = None, index: bool = False,
                  complement: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Codes (..., n_pad) of ``keys`` (n,) or (B, n) of any ``ops.keyspace``
    dtype: ``keyspace.encode``'s int32 or int64 codes (``~`` of them with
    ``complement``) below n, the code dtype's max from n on; with ``index``
    also the int32 payload (..., n_pad), each row's positions below n and 0
    in the pads (``ops.argsort``'s, padded as ``core.ips4o._pad`` pads).
    ``n_pad`` defaults to n.  The G5 encode kernel on a CUDA tensor (one
    launch), :func:`encode_padded_plain` on a CPU tensor."""
    from repro_torch.ops import keyspace  # lazy: ops layers on the kernels

    bits = keyspace.key_bits(keys.dtype)
    code_dtype = keyspace.encoded_dtype(keys.dtype)
    rows, n = _rows(keys)
    n_pad = n if n_pad is None else n_pad
    if n_pad < n:
        raise ValueError(f"codec: n_pad={n_pad} < n={n}")
    shape = keys.shape[:-1] + (n_pad,)
    if _build.is_fake(keys):
        _build.note_fake("codec_encode", 0.0, keys.numel() * keys.element_size()
                         + rows * n_pad * (code_dtype.itemsize + 4.0 * index))
        return (keys.new_empty(shape, dtype=code_dtype),
                keys.new_empty(shape, dtype=torch.int32) if index else None)
    if keys.device.type == "cpu":
        return encode_padded_plain(keys, n_pad, index, complement)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if rows * n_pad >= 2**31:
        raise ValueError(f"codec: {rows} x {n_pad} positions exceed int32 positions")
    keys = keys.contiguous()
    codes = torch.empty(shape, dtype=code_dtype, device=keys.device)
    idx = torch.empty(shape, dtype=torch.int32, device=keys.device) if index else None
    err = _lib().codec_encode(keys.data_ptr(), bits, kind_of(keys.dtype), rows, n, n_pad,
                              int(complement), codes.data_ptr(),
                              None if idx is None else idx.data_ptr(),
                              _build.stream_handle(keys.device))
    _build.check(_lib(), "codec", err, "codec_encode kernel")
    _build.LAUNCHES["codec_encode"] += 1
    return codes, idx


def decode_plain(codes: torch.Tensor, dtype: torch.dtype, n: Optional[int] = None,
                 complement: bool = False) -> torch.Tensor:
    """:func:`decode`'s plain torch twin on any device: the first n codes,
    ``~``, then the eager ``ops.keyspace`` decode."""
    from repro_torch.ops import keyspace  # lazy: ops layers on the kernels

    n = codes.shape[-1] if n is None else n
    enc = codes[..., :n]
    return keyspace.decode_plain(~enc if complement else enc, dtype)


def decode(codes: torch.Tensor, dtype: torch.dtype, n: Optional[int] = None,
           complement: bool = False) -> torch.Tensor:
    """Keys (..., n) of ``dtype`` from the first n codes of each row of
    ``codes`` (n_pad,) or (B, n_pad), int32 or int64 as
    ``keyspace.encoded_dtype(dtype)`` (``~`` undone first with
    ``complement``).  NaN comes back as the reference's canonical NaN.
    The G5 decode kernel on a CUDA tensor (one launch), :func:`decode_plain`
    on a CPU tensor."""
    from repro_torch.ops import keyspace  # lazy: ops layers on the kernels

    bits = keyspace.key_bits(dtype)
    if codes.dtype != keyspace.encoded_dtype(dtype):
        raise TypeError(f"keyspace: encoded dtype {codes.dtype} != "
                        f"{keyspace.encoded_dtype(dtype)}")
    rows, width = _rows(codes)
    n = width if n is None else n
    if not 0 <= n <= width:
        raise ValueError(f"codec: n={n} outside [0, {width}]")
    shape = codes.shape[:-1] + (n,)
    if _build.is_fake(codes):
        _build.note_fake("codec_decode", 0.0, rows * n * (codes.element_size() + bits / 8))
        return codes.new_empty(shape, dtype=dtype)
    if codes.device.type == "cpu":
        return decode_plain(codes, dtype, n, complement)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if codes.stride(-1) != 1 or (codes.dim() == 2 and rows > 1 and codes.stride(0) < width):
        codes = codes.contiguous()
    stride = codes.stride(0) if codes.dim() == 2 else width
    out = torch.empty(shape, dtype=dtype, device=codes.device)
    err = _lib().codec_decode(codes.data_ptr(), bits, kind_of(dtype), rows, n, stride,
                              int(complement), out.data_ptr(), _build.stream_handle(codes.device))
    _build.check(_lib(), "codec", err, "codec_decode kernel")
    _build.LAUNCHES["codec_decode"] += 1
    return out

