"""Parity of the port's keyspace (``repro_torch.ops.keyspace``) with the
reference's (``repro.ops.keyspace``): the port's signed code XOR the sign
bit, viewed as uint32, is the reference's unsigned code, bit for bit."""
import numpy as np
import pytest
import torch

from repro.ops import keyspace as ref_keyspace
from repro_torch.ops import keyspace

SIGN = np.uint32(0x80000000)


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
    for dtype in (torch.float64, torch.int64, torch.int16, torch.bfloat16):
        assert not keyspace.supported(dtype)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            keyspace.encode(torch.zeros(3, dtype=dtype))
    assert keyspace.supported(torch.float32) and keyspace.supported(torch.int32)
    assert keyspace.ordered_uint_dtype(torch.float32) == torch.uint32
    assert keyspace.encoded_dtype(torch.int32) == torch.int32
