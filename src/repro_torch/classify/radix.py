"""The radix bit-extractor classifier (IPS2Ra, arXiv 2009.13569 §5).

Counterpart of ``repro.classify.radix``.  The bucket is the next
``log2(k)`` bits of the keyspace-encoded key; there is no sample and no
splitter:

    j     = (key >> shift) & (k - 1),   shift = bits - consumed - log2(k)
    local = 2j + (key == sentinel)

The reference shifts unsigned codes.  The port's codes are the same bits
with the sign bit flipped, stored as int32 or int64 (``ops.keyspace``;
bits = 32 or 64), so the extractor flips the sign bit back first (``enc ^
SIGN`` is the reference's code) and masks after the shift, which on signed
ints is arithmetic: the mask keeps only bits that came from the key.  The
sentinel is the code dtype's max, which stands for the reference's
all-ones code (pads and NaNs), so they land in an odd equality bucket as
in the reference.  8- and 16-bit keys ride the int32 codes left-aligned,
so level 1 takes the reference's digits.  Level 2 shifts past the
``consumed = log2(k1)`` bits that level 1 fixed; the shift clamps at 0.
Inside kernel K1 the same bits are taken in CUDA (``csrc/level_fused.cu``),
held to :func:`radix_bucket_ids`.
"""
from __future__ import annotations

import torch

__all__ = ["radix_shift", "radix_bucket_ids", "SIGN"]

SIGN = -(1 << 31)  # 0x80000000 as int32: flips the port's code to the reference's
_BITS = {torch.int32: 32, torch.int64: 64}


def radix_shift(k: int, consumed_bits: int = 0, bits: int = 32) -> int:
    """Right shift that puts the next log2(k) bits of a ``bits``-wide code at
    the bottom, past ``consumed_bits`` fixed by earlier levels; at least 0."""
    if k < 2 or k & (k - 1):
        raise ValueError(f"k={k} must be a power of two >= 2")
    return max(bits - consumed_bits - (k.bit_length() - 1), 0)


def radix_bucket_ids(keys: torch.Tensor, k: int, consumed_bits: int = 0) -> torch.Tensor:
    """Local bucket ids in [0, 2k), int32, for encoded int32 or int64
    ``keys`` of any shape: ``2 * bits + (key == sentinel)``, elementwise."""
    if keys.dtype not in _BITS:
        raise ValueError(f"radix classifier takes encoded int32 or int64 keys, got {keys.dtype}")
    bits = _BITS[keys.dtype]
    shift = radix_shift(k, consumed_bits, bits)
    j = ((keys ^ torch.iinfo(keys.dtype).min) >> shift) & (k - 1)
    eq = keys == torch.iinfo(keys.dtype).max
    return 2 * j.to(torch.int32) + eq.to(torch.int32)
