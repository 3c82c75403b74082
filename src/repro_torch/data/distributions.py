"""The paper's nine benchmark input distributions (§5) + element types.

Uniform, Exponential, AlmostSorted (Shun et al.), RootDup, TwoDup, EightDup
(Edelkamp et al.), Sorted, ReverseSorted, Ones — generated deterministically
from a seed, as numpy arrays (host-side data pipeline).

(A copy of ``repro.data.distributions``, numpy only, so that the port and
``chip_smoke.py`` draw the same inputs without importing ``repro``.)
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["DISTRIBUTIONS", "make_input", "make_payload", "ELEMENT_TYPES"]


def _clamp_to_int(x: np.ndarray, dtype) -> np.ndarray:
    """Clamp a float array into an integer dtype's range, in integer space.

    ``np.minimum(x, iinfo(int64).max)`` is wrong for 64-bit targets: the
    bound is not exactly representable in float64, rounds *up* to 2^63, and
    the later cast wraps negative.  Compare against the rounded-up float
    bound instead and substitute the exact integer max for everything at or
    above it; values strictly below 2^63 cast safely.
    """
    info = np.iinfo(dtype)
    fmax = np.float64(info.max)  # may round up (int64: 2^63 exactly)
    over = x >= fmax
    under = x <= np.float64(info.min)
    safe = np.where(over | under, 0.0, x).astype(dtype)
    return np.where(over, info.max, np.where(under, info.min, safe)).astype(dtype)


def _fit_int(vals: np.ndarray, n: int, dtype) -> np.ndarray:
    """Cast values in [0, n) to ``dtype``, folding into the dtype's range
    first when n exceeds it (instead of silently wrapping, e.g. negative
    for int16 keys with n = 10^6)."""
    if np.issubdtype(dtype, np.floating):
        return vals.astype(dtype)
    info = np.iinfo(dtype)
    if n - 1 > int(info.max):
        vals = vals % np.uint64(int(info.max) + 1)
    return vals.astype(dtype)


def _uniform(rng, n, dtype):
    if np.issubdtype(dtype, np.floating):
        return rng.random(n).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, n, dtype=dtype)


def _exponential(rng, n, dtype):
    x = rng.exponential(size=n)
    if np.issubdtype(dtype, np.floating):
        return x.astype(dtype)
    # a fixed 2^20 scale saturates narrow dtypes — for int8 nearly every
    # draw clamps to info.max, degenerating the "Exponential" input to a
    # constant array; scale so the bulk of the mass (x < 8 covers all but
    # ~3e-4 of it) stays in range, leaving int32/int64 behavior unchanged
    info = np.iinfo(dtype)
    scale = min(1 << 20, max(1, int(info.max) // 8))
    return _clamp_to_int(x * scale, dtype)


def _almost_sorted(rng, n, dtype):
    x = np.sort(_uniform(rng, n, dtype))
    if n < 2:  # nothing to perturb (rng.integers rejects high=0)
        return x
    num_swaps = max(1, int(np.sqrt(n)))
    i = rng.integers(0, n, num_swaps)
    j = rng.integers(0, n, num_swaps)
    x[i], x[j] = x[j].copy(), x[i].copy()
    return x


def _root_dup(rng, n, dtype):
    vals = np.arange(n, dtype=np.uint64) % max(1, int(np.floor(np.sqrt(n))))
    return _fit_int(vals, n, dtype)


def _two_dup(rng, n, dtype):
    i = np.arange(n, dtype=np.uint64)
    return _fit_int((i * i + n // 2) % n, n, dtype)


def _eight_dup(rng, n, dtype):
    i = np.arange(n, dtype=np.uint64)
    return _fit_int(((i**8) + n // 2) % n, n, dtype)


def _sorted(rng, n, dtype):
    return np.sort(_uniform(rng, n, dtype))


def _reverse_sorted(rng, n, dtype):
    return np.sort(_uniform(rng, n, dtype))[::-1].copy()


def _ones(rng, n, dtype):
    return np.ones(n, dtype)


DISTRIBUTIONS = {
    "Uniform": _uniform,
    "Exponential": _exponential,
    "AlmostSorted": _almost_sorted,
    "RootDup": _root_dup,
    "TwoDup": _two_dup,
    "EightDup": _eight_dup,
    "Sorted": _sorted,
    "ReverseSorted": _reverse_sorted,
    "Ones": _ones,
}

# Paper §5 element types: double / Pair / Quartet / 100Bytes.  Payload is a
# (n, payload_words) uint64 block permuted alongside the key.
ELEMENT_TYPES: Dict[str, Tuple[np.dtype, int]] = {
    "double": (np.dtype(np.float64), 0),
    "Pair": (np.dtype(np.float64), 1),
    "Quartet": (np.dtype(np.float64), 3),
    "100Bytes": (np.dtype(np.uint64), 12),  # 10B key -> u64 key + 90B payload
}


def make_input(name: str, n: int, dtype=np.float32, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return DISTRIBUTIONS[name](rng, n, np.dtype(dtype))


def make_payload(n: int, words: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 62, (n, words), dtype=np.uint64)
