"""Parity of K7, ``s3_sort`` and the block path with the reference on the
key dtypes of 32 bits or fewer beside float32 and int32: int8, uint8,
int16, uint16, float16, bfloat16 and uint32.

K7's plain twins (``classify_histogram``, ``classify_histogram_batched``
on raw keys, ``radix_histogram`` and its batched form on the port's int32
codes) on CPU tensors against the reference's Pallas kernels in interpret
mode: raw keys compare in their own dtype (unsigned ones as unsigned), so
NaN takes id 0 and the dtype's max 2k-1; the radix digits of the port's
left-aligned codes equal the reference's on its narrow codes.  The port's
oracle ``kernels.ref.classify_histogram_ref`` against the reference's on
keys without NaN.  ``s3_sort`` against the reference's on keys without NaN
or infinities (ROADMAP.md queue 3: the reference's classification breaks
its order there) and against a stable sort of the raw keys with them;
``sort_blocks`` and ``partition_blocks`` (K8's twin and the gather) against
the reference's.  Inputs come from numpy seeds; every comparison is exact,
through integer views of the bits.  The 64-bit dtypes run in the x64 child
of ``tests/test_torch_dtypes.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.partition import partition_blocks as ref_partition_blocks
from repro.core.s3sort import s3_sort as ref_s3_sort
from repro.kernels import classify as ref_classify
from repro.kernels import ops as ref_kernel_ops
from repro.kernels import ref as ref_oracles
from repro.ops.keyspace import encode_np
from repro_torch.core.partition import partition_blocks
from repro_torch.core.s3sort import s3_sort
from repro_torch.kernels import classify, ref
from repro_torch.kernels.ops import sort_blocks
from repro_torch.ops import keyspace
from torch_one_thread import one_torch_thread  # noqa: F401

# numpy dtype (bfloat16 from ml_dtypes), torch dtype, the unsigned view of its bits
DTYPES = {
    "int8": (np.int8, torch.int8, np.uint8),
    "uint8": (np.uint8, torch.uint8, np.uint8),
    "int16": (np.int16, torch.int16, np.uint16),
    "uint16": (np.uint16, torch.uint16, np.uint16),
    "float16": (np.float16, torch.float16, np.uint16),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, np.uint16),
    "uint32": (np.uint32, torch.uint32, np.uint32),
}
NAMES = sorted(DTYPES)
ROWS = 8  # tiles of 1024 keys
TINY = {"float16": float(np.finfo(np.float16).tiny),
        "bfloat16": float(ml_dtypes.finfo(ml_dtypes.bfloat16).tiny)}
# each dtype's max: the last upper
TOP = {name: float(ml_dtypes.finfo(d[0]).max) if name in TINY else int(np.iinfo(d[0]).max)
       for name, d in DTYPES.items()}


def is_float(name):
    return name in ("float16", "bfloat16")


def make_keys(name, n, seed, specials=True):
    """Keys of dtype ``name``: a heavy duplicate, the extremes (the dtype's
    max among them), and with ``specials`` NaN of both signs, signed zeros
    and infinities for floats; without them, floats are finite."""
    np_dtype, _, udtype = DTYPES[name]
    rng = np.random.default_rng(seed)
    nbits = np.dtype(udtype).itemsize * 8
    raw = rng.integers(0, 1 << nbits, n, dtype=np.uint64).astype(udtype)
    raw[rng.random(n) < 0.3] = raw[0]
    x = raw.view(np_dtype).copy()
    if is_float(name):
        # finite and normal: the reference's float compares on the CPU
        # flush subnormals to zero (test_k7_compares_subnormals_exactly)
        f = x.astype(np.float32)
        odd = ~np.isfinite(f) | ((f != 0) & (np.abs(f) < TINY[name]))
        x[odd] = rng.standard_normal(int(odd.sum())).astype(np_dtype)
        x[6::67] = np.array(TOP[name], np_dtype)
        if specials:
            x[::97] = np.nan
            x[1::89] = -np.array(np.nan, np_dtype)
            x[2::83] = 0.0
            x[3::79] = -np.array(0.0, np_dtype)
            x[4::73] = np.inf
            x[5::71] = -np.inf
    else:
        info = np.iinfo(np_dtype)
        x[::97] = info.max
        x[1::89] = info.min
    return x


def to_torch(x, name):
    _, torch_dtype, udtype = DTYPES[name]
    return torch.from_numpy(x.view(f"int{8 * np.dtype(udtype).itemsize}").copy()
                            ).view(torch_dtype)


def bits(x, name):
    udtype = DTYPES[name][2]
    if isinstance(x, torch.Tensor):
        x = x.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    return np.asarray(x).view(udtype)


def splitters_of(x, k, seed):
    """k-1 keys drawn from x, sorted in the keyspace order (NaN last, as
    the kernel wants them)."""
    s = np.random.default_rng(seed).choice(x, k - 1, replace=False)
    return s[np.argsort(encode_np(s), kind="stable")]


def check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 2, 3, 16, 100, 128])
@pytest.mark.parametrize("name", NAMES)
def test_classify_histogram_matches_reference(name, k):
    x = make_keys(name, 3 * ROWS * 128, k)
    spl = splitters_of(x, k, k + 1)
    got = classify.classify_histogram(to_torch(x, name), to_torch(spl, name), k=k, rows=ROWS)
    check(got, ref_classify.classify_histogram(jnp.asarray(x), jnp.asarray(spl), k=k, rows=ROWS,
                                               interpret=True))
    ids = got[0].numpy()
    if is_float(name):  # NaN below every upper
        assert (ids[np.isnan(x.astype(np.float32))] == 0).all()
    top = x == np.array(TOP[name], x.dtype)  # the dtype's max: an equality bucket,
    assert top.any() and (ids[top] % 2 == 1).all()  # the last unless it is a splitter
    if not (spl == np.array(TOP[name], x.dtype)).any():
        assert (ids[top] == 2 * k - 1).all()


@pytest.mark.parametrize("name", ["float16", "bfloat16"])
def test_k7_compares_subnormals_exactly(name):
    """Subnormal keys and splitters compare as IEEE numbers, as numpy's
    dense compare does (and ``torch.sort`` orders them).  The reference's
    Pallas kernel in interpret mode, run by XLA on the CPU, flushes float32
    subnormals to zero in its compares, so it puts a bfloat16 subnormal in
    the equality bucket of a 0.0 splitter (ROADMAP.md queue 3)."""
    k = 8
    np_dtype = DTYPES[name][0]
    tiny = np.array(TINY[name], np_dtype)
    x = np.random.default_rng(14).standard_normal(ROWS * 128).astype(np_dtype)
    x[::3] = tiny * np.array(np.random.default_rng(15).uniform(-0.9, 0.9, x[::3].shape), np_dtype)
    x[1::7] = 0.0
    spl = np.sort(np.concatenate([x[:3], np.array([0.0, tiny, -tiny], np_dtype),
                                  x[3:4]]).astype(np.float32)).astype(np_dtype)
    ids, _ = classify.classify_histogram(to_torch(x, name), to_torch(spl, name), k=k, rows=ROWS)
    xf, upper = x.astype(np.float32), np.append(spl.astype(np.float32), np.float32(TOP[name]))
    j = (xf[:, None] > upper[None, :k - 1]).sum(1)
    eq = (xf[:, None] == upper[None, :]).any(1)
    np.testing.assert_array_equal(ids.numpy(), 2 * j + eq)


@pytest.mark.parametrize("name", NAMES)
def test_classify_histogram_oracle_and_rows_none(name):
    """The port's oracle equals the reference's on keys without NaN, and
    ``rows=None`` takes the reference's tile for the key's width."""
    k, n = 16, 1 << 14
    x = make_keys(name, n, 3, specials=False)
    spl = splitters_of(x, k, 4)
    t, s = to_torch(x, name), to_torch(spl, name)
    want = ref_oracles.classify_histogram_ref(jnp.asarray(x), jnp.asarray(spl), k=k, rows=ROWS)
    check(ref.classify_histogram_ref(t, s, k=k, rows=ROWS), want)
    check(classify.classify_histogram(t, s, k=k, rows=ROWS), want)
    assert classify.default_rows(n, x.dtype.itemsize, k) == ref_classify.default_rows(
        n, x.dtype.itemsize, k)
    check(classify.classify_histogram(t, s, k=k),
          ref_classify.classify_histogram(jnp.asarray(x), jnp.asarray(spl), k=k, interpret=True))


@pytest.mark.parametrize("name", NAMES)
def test_classify_histogram_batched_matches_reference(name):
    B, n, k = 3, 2 * ROWS * 128, 16
    x = make_keys(name, B * n, 5).reshape(B, n)
    spl = np.stack([splitters_of(row, k, 6 + i) for i, row in enumerate(x)])
    t, s = to_torch(x, name), to_torch(spl, name)
    got = classify.classify_histogram_batched(t, s, k=k, rows=ROWS)
    check(got, ref_classify.classify_histogram_batched(jnp.asarray(x), jnp.asarray(spl), k=k,
                                                       rows=ROWS, interpret=True))
    for i in range(B):
        one = classify.classify_histogram(t[i].contiguous(), s[i].contiguous(), k=k, rows=ROWS)
        assert torch.equal(got[0][i], one[0]) and torch.equal(got[1][i], one[1])


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_radix_histogram_of_narrow_codes(name, level):
    """The port's left-aligned int32 codes give the reference's radix ids on
    its own narrow codes, at level 1 and at the next digit (consumed bits
    within the key's width), in the batched form too."""
    k = 16
    nbits = 8 * np.dtype(DTYPES[name][2]).itemsize
    consumed = 0 if level == 0 else nbits - 4
    x = make_keys(name, 2 * ROWS * 128, 7 + level)
    port = keyspace.encode(to_torch(x, name))
    u = jnp.asarray(encode_np(x))
    check(classify.radix_histogram(port, k=k, consumed_bits=consumed, rows=ROWS),
          ref_classify.radix_histogram(u, k=k, consumed_bits=consumed, rows=ROWS,
                                       interpret=True))
    check(classify.radix_histogram_batched(port.reshape(2, -1), k=k, consumed_bits=consumed,
                                           rows=ROWS),
          ref_classify.radix_histogram_batched(u.reshape(2, -1), k=k, consumed_bits=consumed,
                                               rows=ROWS, interpret=True))


@pytest.mark.parametrize("name", NAMES)
def test_s3_sort_matches_reference(name):
    n = 30_000
    x = make_keys(name, n, 9, specials=False)
    v = np.arange(n, dtype=np.int32)
    ks, vs = s3_sort(to_torch(x, name), torch.from_numpy(v))
    rk, rv = ref_s3_sort(jnp.asarray(x), jnp.asarray(v))
    assert ks.dtype == DTYPES[name][1]
    np.testing.assert_array_equal(bits(ks, name), bits(rk, name))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(rv))


@pytest.mark.parametrize("name", [n for n in NAMES if is_float(n)])
def test_s3_sort_nan_last_and_infinities(name):
    """With NaN and infinities: the stable sort of the raw keys (NaN last,
    -0.0 and +0.0 tied in input order), as ``torch.sort(stable=True)``."""
    n = 30_000
    x = make_keys(name, n, 10)
    ks, idx = s3_sort(to_torch(x, name), torch.arange(n))
    want = np.argsort(x.astype(np.float32), kind="stable")
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(bits(ks, name), bits(x[want], name))


@pytest.mark.parametrize("name", NAMES)
def test_block_path_matches_reference(name):
    """``sort_blocks`` in place by K8's twin (blocks of 128 elements: 128
    B for one-byte keys) and ``partition_blocks`` with a 1-D key tensor and
    a 2-D payload of another dtype (the gather), against the reference."""
    k, nblocks, be = 4, 24, 128
    x = make_keys(name, nblocks * be, 11)
    bb = np.random.default_rng(12).integers(0, k, nblocks).astype(np.int32)
    t = to_torch(x, name)
    got, d = sort_blocks(t, torch.from_numpy(bb), k=k, block_elems=be)
    want, want_d = ref_kernel_ops.sort_blocks(jnp.asarray(x), jnp.asarray(bb), k=k,
                                              block_elems=be)
    assert got.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(bits(got, name), bits(want, name))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    pay = np.random.default_rng(13).integers(0, 1 << 16, (nblocks * be, 2)).astype(np.uint16)
    arrays = {"k": to_torch(x, name), "v": torch.from_numpy(pay.view(np.int16)).view(torch.uint16)}
    got, d = partition_blocks(arrays, torch.from_numpy(bb), k, be)
    want, want_d = ref_partition_blocks({"k": jnp.asarray(x), "v": jnp.asarray(pay)},
                                        jnp.asarray(bb), k, be)
    np.testing.assert_array_equal(bits(got["k"], name), bits(want["k"], name))
    np.testing.assert_array_equal(got["v"].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(want["v"]))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.bool])
def test_k7_and_s3_sort_refuse_complex_and_bool(dtype):
    """Keys with no order in the keyspace, which the reference does not
    take either."""
    keys = torch.zeros(1024, dtype=dtype)
    with pytest.raises(NotImplementedError, match="reference refuses"):
        classify.classify_histogram(keys, torch.zeros(7, dtype=dtype), k=8)
    with pytest.raises(NotImplementedError, match="reference"):
        s3_sort(keys)
