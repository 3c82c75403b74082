"""Parity of the port's K7 entry points with the reference, on the CPU.

``repro_torch.kernels.classify`` (``classify_histogram``,
``classify_histogram_batched``, ``radix_histogram``,
``radix_histogram_batched``, ``default_rows``) on CPU tensors, which run
the plain twins, against ``repro.kernels.classify``'s Pallas kernels in
interpret mode and the reference's oracle ``classify_histogram_ref``: the
reference's own matrix (k x dtype x tiles, ``tests/test_kernels.py:15``),
raw-key edge cases (NaN, signed zeros, infinities, the dtype's max, NaN
splitters), ``rows=None``, batched rows against one row at a time, and the
radix mode on encoded keys.  Inputs come from numpy seeds.  Every output
is ids or counts: the tolerance is exact equality.
"""
import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import classify as ref_classify
from repro.kernels import ref as ref_oracles
from repro.ops.keyspace import encode_np
from repro_torch.kernels import classify, ref
from torch_one_thread import one_torch_thread  # noqa: F401

SIGN = np.uint32(0x80000000)


def to_ref(x, bf16):
    x = jnp.asarray(x)
    return x.astype(jnp.bfloat16) if bf16 else x


def to_port(x, bf16):
    x = torch.as_tensor(np.ascontiguousarray(x))
    return x.to(torch.bfloat16) if bf16 else x


def check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def keys_and_splitters(k, dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        keys = rng.integers(-1000, 1000, n).astype(np.int32)
    else:
        keys = rng.standard_normal(n).astype(np.float32)
    spl = np.sort(rng.choice(keys, k - 1, replace=False))
    return keys, spl


@pytest.mark.parametrize("k", [1, 2, 3, 4, 32, 100, 128])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("tiles,rows", [(1, 8), (3, 32)])
def test_classify_histogram_matches_reference(k, dtype, tiles, rows):
    keys, spl = keys_and_splitters(k, dtype, tiles * rows * 128, k * 7 + tiles)
    bf16 = dtype == "bfloat16"
    got = classify.classify_histogram(to_port(keys, bf16), to_port(spl, bf16), k=k, rows=rows)
    check(got, ref_classify.classify_histogram(to_ref(keys, bf16), to_ref(spl, bf16), k=k,
                                               rows=rows))
    if k >= 2 and k & (k - 1) == 0:  # the oracles' tree classifier takes powers of two
        check(got, ref_oracles.classify_histogram_ref(to_ref(keys, bf16), to_ref(spl, bf16),
                                                      k=k, rows=rows))
        check(ref.classify_histogram_ref(to_port(keys, bf16), to_port(spl, bf16), k=k,
                                         rows=rows), got)


def special_keys(n, seed, dtype):
    """NaN, -0.0/+0.0, +-inf and the dtype's max sprinkled over normals."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    big = float(torch.finfo(torch.bfloat16 if dtype == "bfloat16" else torch.float32).max)
    x[::9] = np.nan
    x[1::9] = -0.0
    x[2::9] = 0.0
    x[3::9] = np.inf
    x[4::9] = -np.inf
    x[5::9] = big
    return x, big


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 16, 128])
def test_classify_histogram_special_keys(dtype, k):
    n = 2 * 8 * 128
    x, big = special_keys(n, k, dtype)
    spl = np.sort(np.random.default_rng(k).standard_normal(k - 1).astype(np.float32))
    spl[(k - 1) // 2] = 0.0  # -0.0 keys must equal a +0.0 splitter
    spl = np.sort(spl)
    bf16 = dtype == "bfloat16"
    b, h = classify.classify_histogram(to_port(x, bf16), to_port(spl, bf16), k=k, rows=8)
    check((b, h), ref_classify.classify_histogram(to_ref(x, bf16), to_ref(spl, bf16), k=k,
                                                  rows=8))
    b = b.numpy()
    assert (b[::9] == 0).all()  # NaN: j = 0, eq = 0
    assert (b[1::9] == b[2::9]).all() and (b[1::9] % 2 == 1).all()  # -0.0 == the 0.0 splitter
    assert (b[3::9] == 2 * (k - 1)).all()  # +inf: the last range bucket
    assert (b[5::9] == 2 * k - 1).all()  # the dtype's max: the last equality bucket


def test_classify_histogram_nan_and_duplicate_splitters():
    """Splitters as a sorted sample of NaN-heavy keys leaves them: equal
    runs and NaN last (the case where any(key == upper) and the search
    differ unless the dtype's max is checked apart)."""
    n, k = 8 * 128, 8
    x, _ = special_keys(n, 3, "float32")
    spl = np.asarray([-1.0, 0.0, 0.0, 1.0, np.nan, np.nan, np.nan], np.float32)
    got = classify.classify_histogram(torch.as_tensor(x), torch.as_tensor(spl), k=k, rows=8)
    check(got, ref_classify.classify_histogram(jnp.asarray(x), jnp.asarray(spl), k=k, rows=8))


@pytest.mark.parametrize("dtype,k,n", [("float32", 128, 3 * 32 * 128), ("float32", 256, 16 * 128),
                                       ("int32", 4, 5 * 128), ("bfloat16", 32, 64 * 128)])
def test_classify_histogram_rows_none(dtype, k, n):
    keys, spl = keys_and_splitters(k, dtype, n, k + n)
    bf16 = dtype == "bfloat16"
    got = classify.classify_histogram(to_port(keys, bf16), to_port(spl, bf16), k=k)
    check(got, ref_classify.classify_histogram(to_ref(keys, bf16), to_ref(spl, bf16), k=k))


@pytest.mark.parametrize("n,key_bytes,k", [(1 << 24, 4, 128), (1 << 24, 4, 256), (1 << 20, 2, 32),
                                           (4096, 4, 2), (1000, 4, 128), (3 * 128, 4, 8)])
def test_default_rows_matches_reference(n, key_bytes, k):
    assert classify.default_rows(n, key_bytes, k) == ref_classify.default_rows(n, key_bytes, k)


def test_classify_histogram_refuses_untiled_n():
    with pytest.raises(ValueError):
        classify.classify_histogram(torch.zeros(1000), torch.zeros(127), k=128)
    with pytest.raises(ValueError):
        classify.classify_histogram(torch.zeros(1024), torch.zeros(7), k=8, rows=3)


@pytest.mark.parametrize("k", [3, 16, 100])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_classify_histogram_batched_matches_unbatched(dtype, k):
    rng = np.random.default_rng(0)
    B, n = 3, 2048
    if dtype == "int32":
        keys = rng.integers(-500, 500, (B, n)).astype(np.int32)
        spl = np.sort(rng.integers(-500, 500, (B, k - 1)).astype(np.int32), axis=1)
    else:
        keys = rng.standard_normal((B, n)).astype(np.float32)
        keys[:, ::31] = np.nan
        spl = np.sort(rng.standard_normal((B, k - 1)).astype(np.float32), axis=1)
    bf16 = dtype == "bfloat16"
    b, h = classify.classify_histogram_batched(to_port(keys, bf16), to_port(spl, bf16), k=k,
                                               rows=8)
    check((b, h), ref_classify.classify_histogram_batched(to_ref(keys, bf16), to_ref(spl, bf16),
                                                          k=k, rows=8))
    for i in range(B):
        bi, hi = classify.classify_histogram(to_port(keys[i], bf16), to_port(spl[i], bf16), k=k,
                                             rows=8)
        assert torch.equal(b[i], bi) and torch.equal(h[i], hi)


def codes(n, seed, shape=None):
    """Reference uint32 codes of full-range int32 keys (+ sentinels) and
    the port's signed codes of the same keys."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    x[::97] = np.iinfo(np.int32).max  # encodes to the sentinel
    u = encode_np(x)
    port = torch.as_tensor((u ^ SIGN).view(np.int32).copy())
    if shape is not None:
        u, port = u.reshape(shape), port.reshape(shape)
    return u, port


@pytest.mark.parametrize("consumed", [0, 5])
@pytest.mark.parametrize("k", [2, 32, 256])
def test_radix_histogram_matches_reference(consumed, k):
    u, port = codes(4096, k + consumed)
    got = classify.radix_histogram(port, k=k, consumed_bits=consumed, rows=2)
    check(got, ref_classify.radix_histogram(jnp.asarray(u), k=k, consumed_bits=consumed, rows=2))
    # rows=None
    check(classify.radix_histogram(port, k=k, consumed_bits=consumed),
          ref_classify.radix_histogram(jnp.asarray(u), k=k, consumed_bits=consumed))


@pytest.mark.parametrize("consumed", [0, 5])
def test_radix_histogram_batched_matches_reference(consumed):
    B, n, k = 3, 4096, 32
    u, port = codes(B * n, 7, (B, n))
    got = classify.radix_histogram_batched(port, k=k, consumed_bits=consumed, rows=2)
    check(got, ref_classify.radix_histogram_batched(jnp.asarray(u), k=k,
                                                    consumed_bits=consumed, rows=2))
    for i in range(B):
        bi, hi = classify.radix_histogram(port[i].contiguous(), k=k, consumed_bits=consumed,
                                          rows=2)
        assert torch.equal(got[0][i], bi) and torch.equal(got[1][i], hi)


def test_radix_histogram_refuses_raw_keys():
    with pytest.raises(ValueError):
        classify.radix_histogram(torch.zeros(256), k=4, rows=2)


def test_plain_twins_are_the_cpu_path():
    keys, spl = keys_and_splitters(8, "float32", 1024, 1)
    x, s = torch.as_tensor(keys), torch.as_tensor(spl)
    check(classify.classify_histogram_plain(x, s, k=8, rows=8),
          classify.classify_histogram(x, s, k=8, rows=8))
    _, port = codes(1024, 2)
    check(classify.radix_histogram_plain(port, k=8, rows=8),
          classify.radix_histogram(port, k=8, rows=8))


def test_classify_doctests():
    result = doctest.testmod(classify, verbose=False)
    assert result.failed == 0 and result.attempted > 0
