"""Order-preserving bijections from sortable dtypes into signed-int keys.

Counterpart of ``repro.ops.keyspace``.  The reference maps every key into
the same-width *unsigned* space; PyTorch's unsigned dtypes lack ``>``,
``>>``, ``max``, ``searchsorted`` and ``bincount``, so the port keeps the
same codes with the sign bit flipped and stores them as *signed* ints.
Signed ``<`` on those equals the reference's unsigned ``<``:

  * signed ints: the identity (the reference's offset binary, flipped back);
  * floats: negative values have their 31 magnitude bits complemented,
    non-negative values keep their bits.  This orders
    -inf < ... < -0.0 < +0.0 < ... < +inf with -0.0 and +0.0 distinct;
  * NaNs (any sign, any payload) map to the signed max, the pad sentinel,
    so they sort last as one class; ``decode`` returns the canonical NaN
    the reference returns.

``encode_np``/``decode_np`` are numpy copies of the reference's unsigned
mirror, kept for the tests and ``chip_smoke.py``, which must not import
``repro``.  Keys other than float32 and int32 are not ported yet
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "encode",
    "decode",
    "encoded_dtype",
    "ordered_uint_dtype",
    "supported",
    "encode_np",
    "decode_np",
]

# key dtype -> (signed encoded dtype, the reference's unsigned dtype)
_PORTED = {
    torch.float32: (torch.int32, torch.uint32),
    torch.int32: (torch.int32, torch.uint32),
}
_MAGNITUDE32 = 0x7FFFFFFF


def _check(dtype: torch.dtype) -> None:
    if dtype not in _PORTED:
        raise NotImplementedError(
            f"repro_torch keyspace: key dtype {dtype} is not ported yet; "
            "only float32 and int32 are (see ROADMAP.md, queue 1)"
        )


def supported(dtype: torch.dtype) -> bool:
    """Whether :func:`encode` accepts keys of ``dtype`` in this port."""
    return dtype in _PORTED


def encoded_dtype(dtype: torch.dtype) -> torch.dtype:
    """The signed dtype that :func:`encode` maps ``dtype`` into."""
    _check(dtype)
    return _PORTED[dtype][0]


def ordered_uint_dtype(dtype: torch.dtype) -> torch.dtype:
    """The unsigned dtype the reference encodes ``dtype`` into; the port's
    code XOR the sign bit, viewed as this dtype, is the reference's code."""
    _check(dtype)
    return _PORTED[dtype][1]


def encode(keys: torch.Tensor) -> torch.Tensor:
    """Biject ``keys`` into int32 such that signed ``<`` is the key order."""
    _check(keys.dtype)
    if keys.dtype == torch.int32:
        return keys
    bits = keys.view(torch.int32)
    enc = torch.where(bits < 0, bits ^ _MAGNITUDE32, bits)
    return torch.where(torch.isnan(keys), torch.iinfo(torch.int32).max, enc)


def decode(enc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`encode` (NaNs come back as the canonical NaN)."""
    _check(dtype)
    if enc.dtype != encoded_dtype(dtype):
        raise TypeError(f"keyspace: encoded dtype {enc.dtype} != {encoded_dtype(dtype)}")
    if dtype == torch.int32:
        return enc
    return torch.where(enc < 0, enc ^ _MAGNITUDE32, enc).view(dtype)


# ---------------------------------------------------------------------------
# numpy copy of the reference's unsigned mirror (bit-identical to
# ``repro.ops.keyspace.encode_np``/``decode_np``)

_UINT_FOR_BITS = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}


def encode_np(x: np.ndarray) -> np.ndarray:
    """Numpy mirror of the reference encoding into unsigned ints."""
    x = np.asarray(x)
    dtype = x.dtype
    udtype = np.dtype(_UINT_FOR_BITS[dtype.itemsize * 8])
    sign = udtype.type(1) << udtype.type(dtype.itemsize * 8 - 1)
    if np.issubdtype(dtype, np.unsignedinteger):
        return x
    if np.issubdtype(dtype, np.signedinteger):
        return x.view(udtype) ^ sign
    bits = x.view(udtype)
    neg = (bits & sign) != 0
    u = np.where(neg, ~bits, bits | sign)
    return np.where(np.isnan(x), np.iinfo(udtype).max, u).astype(udtype)


def decode_np(u: np.ndarray, dtype) -> np.ndarray:
    """Numpy mirror of the reference decoding (NaNs come back canonical)."""
    u = np.asarray(u)
    dtype = np.dtype(dtype)
    udtype = u.dtype
    sign = udtype.type(1) << udtype.type(dtype.itemsize * 8 - 1)
    if np.issubdtype(dtype, np.unsignedinteger):
        return u
    if np.issubdtype(dtype, np.signedinteger):
        return (u ^ sign).view(dtype)
    was_neg = (u & sign) == 0
    bits = np.where(was_neg, ~u, u ^ sign).astype(udtype)
    return bits.view(dtype)
