"""Order-preserving bijections from sortable dtypes into signed-int keys.

Counterpart of ``repro.ops.keyspace``.  The reference maps every key into
the same-width *unsigned* space; PyTorch's unsigned dtypes lack ``>``,
``>>``, ``max``, ``searchsorted`` and ``bincount``, so the port keeps the
same codes with the sign bit flipped and stores them as *signed* ints.
Signed ``<`` on those equals the reference's unsigned ``<``:

  * signed ints: the identity (the reference's offset binary, flipped back);
  * unsigned ints: the bits with the sign bit flipped;
  * floats: negative values have their magnitude bits complemented,
    non-negative values keep their bits.  This orders
    -inf < ... < -0.0 < +0.0 < ... < +inf with -0.0 and +0.0 distinct;
  * NaNs (any sign, any payload) map to the signed max, so they sort last
    as one class; ``decode`` returns the canonical NaN the reference
    returns.

Twelve key dtypes, as in the reference: int8/16/32/64, uint8/16/32/64,
float16, bfloat16, float32 and float64.  Keys of 32 bits or fewer encode
into int32, 64-bit keys into int64 (:func:`encoded_dtype`); the sort and
its kernels take those two code dtypes only.

**Narrow keys.**  An 8- or 16-bit key's reference code ``u`` (``bits``
wide) is left-aligned in the int32 code, its low ``s = 32 - bits`` bits
zero, except that the all-ones code (the narrow dtype's max, or its NaN
class) fills them with ones:

    code = (u - 2^(bits-1)) * 2^s + (u == 2^bits - 1) * (2^s - 1)

So the order is kept, the top bits of the code are the reference's digits
(the radix classifier's level-1 ids equal the reference's for log2(k) <=
bits), and the reference's sentinel class (all ones, the code its radix
classifier sends to an equality bucket) is the port's int32 max, as for
32-bit keys.  :func:`reference_code_np` is the documented map from a port
code to the reference's code for every dtype.

``encode_np``/``decode_np`` are numpy copies of the reference's unsigned
mirror, kept for the tests and ``chip_smoke.py``, which must not import
``repro``.
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
    "key_bits",
    "reference_code_np",
    "encode_np",
    "decode_np",
]

# key dtype -> (its width in bits, the reference's unsigned dtype)
_DTYPES = {
    torch.int8: (8, torch.uint8), torch.uint8: (8, torch.uint8),
    torch.int16: (16, torch.uint16), torch.uint16: (16, torch.uint16),
    torch.float16: (16, torch.uint16), torch.bfloat16: (16, torch.uint16),
    torch.int32: (32, torch.uint32), torch.uint32: (32, torch.uint32),
    torch.float32: (32, torch.uint32),
    torch.int64: (64, torch.uint64), torch.uint64: (64, torch.uint64),
    torch.float64: (64, torch.uint64),
}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
_SIGNED_OF = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}


def _check(dtype: torch.dtype) -> None:
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"repro_torch keyspace: key dtype {dtype} has no order-preserving code; "
            "the keyspace takes 8-, 16-, 32- and 64-bit ints and uints and float16, "
            "bfloat16, float32 and float64, as the reference's does (ROADMAP.md, "
            "queue 1 item 1)"
        )


def supported(dtype: torch.dtype) -> bool:
    """Whether :func:`encode` accepts keys of ``dtype`` (the reference's
    ``supported``: every 8/16/32/64-bit int, uint and float)."""
    return dtype in _DTYPES


def key_bits(dtype: torch.dtype) -> int:
    """The width of a key of ``dtype`` in bits."""
    _check(dtype)
    return _DTYPES[dtype][0]


def encoded_dtype(dtype: torch.dtype) -> torch.dtype:
    """The signed dtype that :func:`encode` maps ``dtype`` into: int32 for
    keys of 32 bits or fewer, int64 for 64-bit keys."""
    return torch.int64 if key_bits(dtype) == 64 else torch.int32


def ordered_uint_dtype(dtype: torch.dtype) -> torch.dtype:
    """The unsigned dtype the reference encodes ``dtype`` into
    (:func:`reference_code_np` maps the port's code onto it)."""
    _check(dtype)
    return _DTYPES[dtype][1]


def _narrow_ucode(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """The reference's ``bits``-wide unsigned code of 8/16-bit ``keys``, as
    int32 in [0, 2^bits)."""
    mask, sign = (1 << bits) - 1, 1 << (bits - 1)
    dtype = keys.dtype
    raw = keys.view(_SIGNED_OF[bits]).to(torch.int32) & mask
    if dtype in _UNSIGNED:
        return raw
    if not dtype.is_floating_point:
        return raw ^ sign
    u = torch.where(raw & sign != 0, raw ^ mask, raw | sign)
    return torch.where(torch.isnan(keys), mask, u)


def encode(keys: torch.Tensor) -> torch.Tensor:
    """Biject ``keys`` into int32 (keys of <= 32 bits) or int64 (64-bit
    keys) such that signed ``<`` is the key order."""
    dtype = keys.dtype
    bits = key_bits(dtype)
    if bits < 32:
        s = 32 - bits
        u = _narrow_ucode(keys, bits)
        return (u - (1 << (bits - 1))) * (1 << s) + (u == (1 << bits) - 1).to(torch.int32) * (
            (1 << s) - 1)
    signed = _SIGNED_OF[bits]
    smin = torch.iinfo(signed).min
    if dtype == signed:
        return keys
    if dtype in _UNSIGNED:
        return keys.view(signed) ^ smin
    b = keys.view(signed)
    enc = torch.where(b < 0, b ^ torch.iinfo(signed).max, b)
    return torch.where(torch.isnan(keys), torch.iinfo(signed).max, enc)


def decode(enc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`encode` (NaNs come back as the reference's
    canonical NaN).  Narrow floats are decoded from their codes' bits in
    the 16-bit domain, never through a float conversion, which would give
    other NaN bits."""
    bits = key_bits(dtype)
    if enc.dtype != encoded_dtype(dtype):
        raise TypeError(f"keyspace: encoded dtype {enc.dtype} != {encoded_dtype(dtype)}")
    if bits < 32:
        mask, sign = (1 << bits) - 1, 1 << (bits - 1)
        u = (enc >> (32 - bits)) + sign  # the reference's code, in [0, 2^bits)
        if dtype in _UNSIGNED:
            raw = u
        elif not dtype.is_floating_point:
            raw = u ^ sign
        else:
            raw = torch.where(u & sign == 0, u ^ mask, u ^ sign)
        return raw.to(_SIGNED_OF[bits]).view(dtype)
    signed = _SIGNED_OF[bits]
    if dtype == signed:
        return enc
    if dtype in _UNSIGNED:
        return (enc ^ torch.iinfo(signed).min).view(dtype)
    return torch.where(enc < 0, enc ^ torch.iinfo(signed).max, enc).view(dtype)


def reference_code_np(code: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The reference's unsigned code (``repro.ops.keyspace.encode``) of the
    port's ``code`` for keys of ``dtype``: the code XOR the sign bit viewed
    unsigned for 32- and 64-bit keys, its top ``bits`` bits for narrower
    ones.

    >>> reference_code_np(np.asarray([-2**31, 2**31 - 1], np.int32), torch.uint8).tolist()
    [0, 255]
    """
    bits = key_bits(dtype)
    code = np.asarray(code)
    udtype = np.dtype(_UINT_FOR_BITS[bits])
    if bits < 32:
        return ((code.astype(np.int64) >> (32 - bits)) + (1 << (bits - 1))).astype(udtype)
    return code.view(udtype) ^ udtype.type(1 << (bits - 1))


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
