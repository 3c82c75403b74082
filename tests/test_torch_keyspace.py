"""Parity of the port's keyspace (``repro_torch.ops.keyspace``) with the
reference's (``repro.ops.keyspace``): for 32-bit keys the port's signed
code XOR the sign bit, viewed as uint32, is the reference's unsigned code,
bit for bit; for every one of the twelve key dtypes
``keyspace.reference_code_np`` maps the port's code onto the reference's,
signed order on the codes is the reference's unsigned order, decoding
round-trips bit for bit and NaN decodes to the reference's bits (compared
through integer views).  ``repro.ops.keyspace.encode`` (jax) is held on
the dtypes of 32 bits or fewer here; its 64-bit codes need x64, which
``tests/test_torch_dtypes.py`` runs in a child process."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ops import keyspace as ref_keyspace
from repro_torch.ops import keyspace
from torch_one_thread import one_torch_thread  # noqa: F401

SIGN = np.uint32(0x80000000)
# name -> (numpy dtype, torch dtype, the unsigned numpy dtype of its width)
ALL = {
    "int8": (np.int8, torch.int8, np.uint8), "uint8": (np.uint8, torch.uint8, np.uint8),
    "int16": (np.int16, torch.int16, np.uint16), "uint16": (np.uint16, torch.uint16, np.uint16),
    "float16": (np.float16, torch.float16, np.uint16),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, np.uint16),
    "int32": (np.int32, torch.int32, np.uint32), "uint32": (np.uint32, torch.uint32, np.uint32),
    "float32": (np.float32, torch.float32, np.uint32),
    "int64": (np.int64, torch.int64, np.uint64), "uint64": (np.uint64, torch.uint64, np.uint64),
    "float64": (np.float64, torch.float64, np.uint64),
}
_SIGNED = {np.uint8: torch.uint8, np.uint16: torch.int16, np.uint32: torch.int32,
           np.uint64: torch.int64}


def _all_inputs(name, seed):
    """Random bit patterns of every kind (NaNs of any payload among the
    floats), the extremes, and for floats the specials."""
    np_dtype, _, udtype = ALL[name]
    bits = np.dtype(udtype).itemsize * 8
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**63, 4096, dtype=np.uint64) * np.uint64(2) + rng.integers(
        0, 2, 4096, dtype=np.uint64)
    raw = (raw >> np.uint64(64 - bits)).astype(udtype)
    edges = np.array([0, 1, (1 << (bits - 1)) - 1, 1 << (bits - 1), (1 << (bits - 1)) + 1,
                      (1 << bits) - 2, (1 << bits) - 1], np.uint64).astype(udtype)
    x = np.concatenate([raw, edges]).view(np_dtype)
    if name.startswith(("float", "bfloat")):
        sp = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0], np.float64)
        x = np.concatenate([x, sp.astype(np_dtype)])
    return x


def _port(x, name):
    """The port's keys for numpy ``x`` (bit for bit)."""
    udtype = ALL[name][2]
    return torch.from_numpy(x.view(udtype).copy()).view(ALL[name][1])


def _bits(t, name):
    udtype = ALL[name][2]
    return t.view(_SIGNED[udtype]).numpy().view(udtype)


def _specials(dtype):
    if dtype == np.float32:
        return np.array(
            [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0,
             np.finfo(np.float32).max, -np.finfo(np.float32).max,
             np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny, 1e-45, -1e-45],
            np.float32,
        )
    info = np.iinfo(np.int32)
    return np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max], np.int32)


def _inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(dtype)
        payload_nan = np.array([0x7FC00001, 0xFFC00000, 0x7F800001], np.uint32).view(dtype)
        x = np.concatenate([x, payload_nan])
    else:
        x = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, 4096, dtype=dtype)
    return np.concatenate([x, _specials(dtype)])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_matches_reference(dtype, seed):
    x = _inputs(dtype, seed)
    enc = keyspace.encode(torch.as_tensor(x))
    assert enc.dtype == torch.int32
    got = enc.numpy().view(np.uint32) ^ SIGN
    np.testing.assert_array_equal(got, ref_keyspace.encode_np(x))
    np.testing.assert_array_equal(got, keyspace.encode_np(x))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_decode_round_trips(dtype):
    x = _inputs(dtype, 2)
    back = keyspace.decode(keyspace.encode(torch.as_tensor(x)), torch.as_tensor(x).dtype)
    want = ref_keyspace.decode_np(ref_keyspace.encode_np(x), dtype)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        keyspace.decode_np(keyspace.encode_np(x), dtype).view(np.uint32),
        want.view(np.uint32),
    )


def test_float_order_nan_last_and_signed_zeros():
    x = np.array([np.nan, 1.0, -0.0, 0.0, -np.inf, np.inf, -np.nan, -1.0], np.float32)
    enc = keyspace.encode(torch.as_tensor(x))
    order = torch.sort(enc, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, [4, 7, 2, 3, 1, 5, 0, 6])
    assert int(enc[0]) == int(enc[6]) == torch.iinfo(torch.int32).max  # the sentinel
    assert int(enc[2]) < int(enc[3])  # -0.0 < +0.0


def test_unported_dtypes_raise():
    """The dtypes the reference refuses too (no order-preserving code)."""
    for dtype in (torch.complex64, torch.bool, torch.complex128):
        assert not keyspace.supported(dtype)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            keyspace.encode(torch.zeros(3, dtype=dtype))
    assert keyspace.supported(torch.float32) and keyspace.supported(torch.int32)
    assert keyspace.ordered_uint_dtype(torch.float32) == torch.uint32
    assert keyspace.encoded_dtype(torch.int32) == torch.int32


@pytest.mark.parametrize("name", sorted(ALL))
def test_every_dtype_maps_to_the_reference_codes(name):
    """``reference_code_np`` of the port's code is the reference's code
    (its numpy mirror for every width, and ``keyspace.encode`` itself where
    jax runs without x64), signed order on the codes is the reference's
    unsigned order, and the code dtype is int32 up to 32 bits, else int64."""
    np_dtype, torch_dtype, udtype = ALL[name]
    x = _all_inputs(name, seed=len(name))
    assert keyspace.supported(torch_dtype)
    enc = keyspace.encode(_port(x, name))
    assert enc.dtype == keyspace.encoded_dtype(torch_dtype)
    assert enc.dtype == (torch.int64 if np.dtype(udtype).itemsize == 8 else torch.int32)
    assert keyspace.ordered_uint_dtype(torch_dtype) == {
        np.uint8: torch.uint8, np.uint16: torch.uint16, np.uint32: torch.uint32,
        np.uint64: torch.uint64}[udtype]
    want = ref_keyspace.encode_np(x)
    got = keyspace.reference_code_np(enc.numpy(), torch_dtype)
    assert got.dtype == want.dtype == np.dtype(udtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(keyspace.encode_np(x), want)
    if np.dtype(udtype).itemsize < 8:
        np.testing.assert_array_equal(got, np.asarray(ref_keyspace.encode(jnp.asarray(x))))
    np.testing.assert_array_equal(np.argsort(enc.numpy(), kind="stable"),
                                  np.argsort(want, kind="stable"))


@pytest.mark.parametrize("name", sorted(ALL))
def test_every_dtype_round_trips_with_the_reference_nan(name):
    """decode(encode(x)) is x bit for bit, except that every NaN comes back
    as the reference's canonical NaN bits, checked through integer views;
    the code of the reference's zero code (the code dtype's min: the
    padding of ``unique``) decodes as the reference's does."""
    np_dtype, torch_dtype, udtype = ALL[name]
    x = _all_inputs(name, seed=1 + len(name))
    back = keyspace.decode(keyspace.encode(_port(x, name)), torch_dtype)
    assert back.dtype == torch_dtype
    want = ref_keyspace.decode_np(ref_keyspace.encode_np(x), np_dtype)
    np.testing.assert_array_equal(_bits(back, name), want.view(udtype))
    if name.startswith(("float", "bfloat")):
        nan = np.isnan(x.astype(np.float64))
        assert nan.any()
        canonical = np.uint64((1 << (np.dtype(udtype).itemsize * 8 - 1)) - 1).astype(udtype)
        assert (_bits(back, name)[nan] == canonical).all()
        keep = ~nan
        np.testing.assert_array_equal(_bits(back, name)[keep], x.view(udtype)[keep])
    else:
        np.testing.assert_array_equal(_bits(back, name), x.view(udtype))
    code_dtype = keyspace.encoded_dtype(torch_dtype)
    zero = torch.full((1,), torch.iinfo(code_dtype).min, dtype=code_dtype)
    np.testing.assert_array_equal(_bits(keyspace.decode(zero, torch_dtype), name),
                                  ref_keyspace.decode_np(np.zeros(1, udtype), np_dtype)
                                  .view(udtype))


@pytest.mark.parametrize("name", ["int8", "uint8", "int16", "uint16", "float16", "bfloat16"])
def test_narrow_codes_are_left_aligned_below_the_sentinel(name):
    """8- and 16-bit codes keep the reference's code in their top bits; the
    all-ones code (the dtype's max or its NaN class) is the int32 max, the
    pad sentinel, and every other code lies below it."""
    np_dtype, torch_dtype, udtype = ALL[name]
    bits = np.dtype(udtype).itemsize * 8
    u = np.arange(1 << bits, dtype=np.uint64).astype(udtype)
    u = u[ref_keyspace.encode_np(ref_keyspace.decode_np(u, np_dtype)) == u]  # NaN: one code
    x = ref_keyspace.decode_np(u, np_dtype)
    enc = keyspace.encode(_port(x, name)).numpy().astype(np.int64)
    top = u.astype(np.int64) == (1 << bits) - 1
    np.testing.assert_array_equal(enc[~top], (u[~top].astype(np.int64) - (1 << (bits - 1)))
                                  << (32 - bits))
    assert (enc[top] == np.iinfo(np.int32).max).all()
    assert (np.diff(enc) > 0).all()
