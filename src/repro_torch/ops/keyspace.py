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

**Multi-word keys** (DESIGN.md §11).  :func:`encode_words` decomposes
strings and composite records into a fixed-width (n, W) uint32 matrix,
each record's bytes big-endian across the words, such that
row-lexicographic order on the words is the record order;
:func:`decode_words` inverts it.  Both run on the host in numpy, copies of
the reference's, as the words are what goes to the card
(``ops.sort_records``, which encodes each word column into int32 codes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "encode",
    "decode",
    "encode_plain",
    "decode_plain",
    "encoded_dtype",
    "ordered_uint_dtype",
    "supported",
    "key_bits",
    "reference_code_np",
    "encode_np",
    "decode_np",
    "WordSpec",
    "encode_words",
    "decode_words",
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
_IDENTITY = (torch.int32, torch.int64)  # key dtypes that are their own codes


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
    keys) such that signed ``<`` is the key order.  int32 and int64 keys
    are their own codes (returned as they are); other keys go through the
    G5 encode kernel (``kernels.codec.encode_padded``) on a CUDA tensor of
    any shape, seen as one row, and through :func:`encode_plain` on the
    CPU."""
    if keys.device.type == "cuda" and keys.dtype not in _IDENTITY:
        from repro_torch.kernels import codec  # lazy: the kernels build nothing at import

        key_bits(keys.dtype)  # raises for dtypes with no order-preserving code
        return codec.encode_padded(keys.reshape(1, -1))[0].view(keys.shape)
    return encode_plain(keys)


def encode_plain(keys: torch.Tensor) -> torch.Tensor:
    """:func:`encode` in eager torch ops on any device: G5's plain twin."""
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
    other NaN bits.  int32 and int64 keys are their codes; other keys come
    from the G5 decode kernel (``kernels.codec.decode``) on a CUDA tensor of
    any shape (one row of up to two dims as it lies, any other shape seen as
    one row), from :func:`decode_plain` on the CPU."""
    if enc.device.type == "cuda" and dtype not in _IDENTITY:
        from repro_torch.kernels import codec  # lazy: the kernels build nothing at import

        if enc.dim() in (1, 2):
            return codec.decode(enc, dtype)
        return codec.decode(enc.reshape(1, -1), dtype).view(enc.shape)
    return decode_plain(enc, dtype)


def decode_plain(enc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`decode` in eager torch ops on any device: G5's plain twin."""
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


# ---------------------------------------------------------------------------
# multi-word keys: a copy of the reference's host-side word codec

_WORD_BYTES = 4  # uint32 words


def _np_supported(dtype: np.dtype) -> bool:
    """The reference's ``supported`` for a numpy column dtype: 8/16/32/64-bit
    ints, uints and floats."""
    return (dtype.kind in "iuf" or dtype.name == "bfloat16") and \
        dtype.itemsize * 8 in _UINT_FOR_BITS


@dataclass(frozen=True)
class WordSpec:
    """Layout of :func:`encode_words`' output, read by :func:`decode_words`:
    ``kind`` "bytes" (strings padded with 0x00 to ``row_bytes``) or
    "columns" (numeric columns of ``dtypes``, big-endian in order);
    ``words`` is W, the uint32 words a row."""

    kind: str
    row_bytes: int
    words: int
    dtypes: Tuple[str, ...] = ()


def _pack_rows(b: np.ndarray) -> np.ndarray:
    """(n, L) uint8 byte rows -> (n, ceil(L/4)) big-endian uint32 words."""
    n, L = b.shape
    W = max(1, -(-L // _WORD_BYTES))
    padded = np.zeros((n, W * _WORD_BYTES), np.uint8)
    padded[:, :L] = b
    q = padded.reshape(n, W, _WORD_BYTES).astype(np.uint32)
    return (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]


def _unpack_rows(words: np.ndarray, row_bytes: int) -> np.ndarray:
    """(n, W) uint32 words -> (n, row_bytes) uint8 byte rows."""
    w = np.asarray(words, np.uint32)
    n, W = w.shape
    b = np.empty((n, W, _WORD_BYTES), np.uint8)
    b[..., 0] = w >> 24
    b[..., 1] = (w >> 16) & 0xFF
    b[..., 2] = (w >> 8) & 0xFF
    b[..., 3] = w & 0xFF
    return b.reshape(n, W * _WORD_BYTES)[:, :row_bytes]


def _is_strings(records: Any) -> bool:
    if isinstance(records, np.ndarray):
        return records.dtype.kind in "SU"
    if isinstance(records, (list, tuple)):
        return len(records) == 0 or isinstance(records[0], (bytes, bytearray, str))
    return False


def encode_words(
    records: Union[Sequence[Union[bytes, str]], Sequence[np.ndarray]],
    *,
    width: int = None,
) -> Tuple[np.ndarray, WordSpec]:
    """Fixed-width big-endian word decomposition of records, on the host.

    ``records`` is a sequence of strings / byte strings, or a tuple of
    equal-length numeric column arrays (a composite record per row).
    Returns ``(words, spec)``: ``words`` is (n, W) uint32, word 0 most
    significant, and row-lexicographic order on the words is the record
    order: bytes order for strings (a proper prefix first), tuple order for
    columns (each in its keyspace order: NaNs last, -0.0 < +0.0).  Strings
    must hold no NUL byte (the pad); ``width`` fixes their byte length.

    >>> w, spec = encode_words([b"ab", b"abc", b""])
    >>> w.shape, spec.words
    ((3, 1), 1)
    >>> bool(w[2, 0] < w[0, 0] < w[1, 0])  # "" < "ab" < "abc"
    True
    """
    if _is_strings(records):
        if isinstance(records, np.ndarray):
            records = records.tolist()
        bs: List[bytes] = [r.encode("utf-8") if isinstance(r, str) else bytes(r)
                           for r in records]
        n = len(bs)
        maxlen = max((len(b) for b in bs), default=0)
        if width is None:
            width = maxlen
        elif maxlen > width:
            raise ValueError(f"encode_words: record of {maxlen} bytes exceeds width={width}")
        mat = np.zeros((n, max(1, width)), np.uint8)
        for i, b in enumerate(bs):
            if b"\x00" in b:
                raise ValueError("encode_words: NUL byte in record (0x00 is the pad code)")
            mat[i, : len(b)] = np.frombuffer(b, np.uint8)
        return _pack_rows(mat), WordSpec(
            kind="bytes", row_bytes=width, words=max(1, -(-width // _WORD_BYTES)))
    cols = [np.asarray(c) for c in records]
    if not cols:
        raise ValueError("encode_words: no columns")
    n = cols[0].shape[0]
    parts = []
    for c in cols:
        if c.shape != (n,):
            raise ValueError("encode_words: columns must be equal-length 1-D")
        if not _np_supported(c.dtype):
            raise TypeError(f"encode_words: unsupported column dtype {c.dtype}")
        u = encode_np(c)
        be = np.ascontiguousarray(u.astype(u.dtype.newbyteorder(">")))
        parts.append(be.view(np.uint8).reshape(n, c.dtype.itemsize))
    row_bytes = sum(c.dtype.itemsize for c in cols)
    rows = np.concatenate(parts, axis=1) if n else np.zeros((0, row_bytes), np.uint8)
    return _pack_rows(rows), WordSpec(
        kind="columns", row_bytes=row_bytes, words=max(1, -(-row_bytes // _WORD_BYTES)),
        dtypes=tuple(str(c.dtype) for c in cols))


def decode_words(words: np.ndarray, spec: WordSpec
                 ) -> Union[List[bytes], Tuple[np.ndarray, ...]]:
    """Inverse of :func:`encode_words`, on the host: byte strings with the
    0x00 padding stripped, or the columns in their dtypes (bit-exact but
    for NaN payloads).

    >>> w, spec = encode_words([b"hi", b"there"])
    >>> decode_words(w, spec)
    [b'hi', b'there']
    """
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    b = _unpack_rows(np.asarray(words), spec.row_bytes)
    if spec.kind == "bytes":
        return [bytes(row).rstrip(b"\x00") for row in b]
    if spec.kind != "columns":
        raise ValueError(f"decode_words: unknown spec kind {spec.kind!r}")
    out = []
    off = 0
    for name in spec.dtypes:
        dtype = np.dtype(name)
        sz = dtype.itemsize
        u = (np.ascontiguousarray(b[:, off: off + sz]).view(np.dtype(f">u{sz}"))
             .reshape(-1).astype(np.dtype(f"u{sz}")))
        out.append(decode_np(u, dtype))
        off += sz
    return tuple(out)
