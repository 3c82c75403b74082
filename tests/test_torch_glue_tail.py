"""The one-device sort's last glue on the CPU: the plain twins of G5 (the
keyspace codec with the pad), G6 (the levels' samples) and G7 (the
robustness fallback's list) against the reference's XLA code.

``sampling.select_splitters`` and ``sampling.build_tree`` build their
indices on the tensor's device, with no copy from numpy; the G6 twin maps
drawn uniforms to positions as ``repro.core.sampling.sample_indices`` does
(its ``jax.random.uniform`` replaced by the same draw); the G5 twin's codes,
sentinel tail, complement, index payload and decode equal
``repro.ops.keyspace`` on the nine key dtypes of 32 bits or fewer here (NaN
of any payload, +-0.0, +-inf and subnormals among them) and on the three
64-bit ones in a child process with x64 enabled from startup; G7's list
agrees with the reference's ``bucket_violations``.  The kernels themselves
run only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); their
schedules are replayed in ``tests/test_torch_kernel_schedules.py``."""
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import ips4o as ref_ips4o
from repro.core import sampling as ref_sampling
from repro.ops import keyspace as ref_keyspace
from repro_torch.core import ips4o, sampling
from repro_torch.kernels import codec, fallback, glue
from repro_torch.ops import keyspace
from torch_children import Child
from torch_one_thread import one_torch_thread  # noqa: F401

# name -> (numpy dtype, torch dtype, the unsigned numpy dtype of its width)
NARROW = {
    "int8": (np.int8, torch.int8, np.uint8), "uint8": (np.uint8, torch.uint8, np.uint8),
    "int16": (np.int16, torch.int16, np.uint16), "uint16": (np.uint16, torch.uint16, np.uint16),
    "float16": (np.float16, torch.float16, np.uint16),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, np.uint16),
    "int32": (np.int32, torch.int32, np.uint32), "uint32": (np.uint32, torch.uint32, np.uint32),
    "float32": (np.float32, torch.float32, np.uint32),
}
_VIEW = {np.uint8: torch.uint8, np.uint16: torch.int16, np.uint32: torch.int32,
         np.uint64: torch.int64}


def _keys(name, n, seed, table=NARROW):
    """Random bit patterns of the dtype (NaNs of any payload among the
    floats), its extremes and, for floats, NaN, +-0.0, +-inf and the
    smallest subnormals."""
    np_dtype, _, udtype = table[name]
    bits = np.dtype(udtype).itemsize * 8
    rng = np.random.default_rng(seed)
    raw = (rng.integers(0, 2**63, n, dtype=np.uint64) >> np.uint64(63 - bits)).astype(udtype)
    edges = np.array([0, 1, (1 << (bits - 1)) - 1, 1 << (bits - 1), (1 << bits) - 1],
                     np.uint64).astype(udtype)
    raw[:len(edges)] = edges
    if name.startswith(("float", "bfloat")):
        sub = np.array([1, (1 << (bits - 1)) + 1], np.uint64).astype(udtype)  # +-smallest subnormal
        sp = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0], np.float64).astype(np_dtype)
        raw[len(edges):len(edges) + 8] = np.concatenate([sub, sp.view(udtype)])
    return raw.view(np_dtype)


def _port(x, name, table=NARROW):
    udtype = table[name][2]
    return torch.from_numpy(x.view(udtype).copy()).view(table[name][1])


def _bits(t, name, table=NARROW):
    udtype = table[name][2]
    return t.view(_VIEW[udtype]).numpy().view(udtype)


@pytest.mark.parametrize("k", [2, 4, 16, 128, 256])
def test_select_splitters_and_build_tree_make_no_host_copy(k):
    """Both build their index on the tensor's device (``torch.as_tensor`` and
    ``torch.tensor`` are never called) and equal the reference's."""
    rng = np.random.default_rng(k)
    s = np.sort(rng.integers(-2**31, 2**31, (3, 5 * k + 3), dtype=np.int64).astype(np.int32))
    spl = np.sort(rng.integers(-1000, 1000, (2, k - 1)).astype(np.int32))
    with mock.patch("torch.as_tensor", side_effect=AssertionError("a host copy")), \
            mock.patch("torch.tensor", side_effect=AssertionError("a host copy")):
        got_sel = sampling.select_splitters(torch.from_numpy(s), k)
        got_tree = sampling.build_tree(torch.from_numpy(spl), k)
    np.testing.assert_array_equal(got_sel.numpy(),
                                  np.asarray(ref_sampling.select_splitters(jnp.asarray(s), k)))
    np.testing.assert_array_equal(got_tree.numpy(),
                                  np.asarray(ref_sampling.build_tree(jnp.asarray(spl), k)))
    np.testing.assert_array_equal(sampling.tree_permutation_on(k, "cpu").numpy(),
                                  ref_sampling.tree_permutation(k))


def _ref_positions(u, lo, hi):
    """The reference's ``sample_indices`` of each (lo, hi) with its uniform
    draw replaced by the rows of ``u``."""
    out = []
    for row, a, b in zip(u, lo, hi):
        with mock.patch.object(ref_sampling.jax.random, "uniform",
                               lambda rng, shape, row=row: jnp.asarray(row)):
            out.append(np.asarray(ref_sampling.sample_indices(jax.random.PRNGKey(0), len(row),
                                                              jnp.int32(a), jnp.int32(b))))
    return np.stack(out)


def test_positions_from_uniform_match_the_reference():
    """float32 ``floor(u * size)`` from the same draw, with the uniforms'
    extremes (0, the largest float32 below 1) and empty segments."""
    rng = np.random.default_rng(3)
    cuts = np.sort(rng.integers(0, 70000, 40))
    cuts[5:9] = cuts[5]  # empty segments
    lo, hi = cuts[:-1].astype(np.int32), cuts[1:].astype(np.int32)
    u = rng.random((len(lo), 64), dtype=np.float32)
    u[:, 0], u[:, 1] = 0.0, np.nextafter(np.float32(1), np.float32(0))
    got = sampling.positions_from_uniform(torch.from_numpy(u), torch.from_numpy(lo),
                                          torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), _ref_positions(u, lo, hi))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sample_splitters_plain_equals_the_reference(dtype):
    """G6's twin at level 1 (drawn positions, the upper form with the
    sentinel) and level 2 (drawn uniforms over the segments) gives the
    reference's splitters from the same draw."""
    rng = np.random.default_rng(7)
    B, n, k, m = 2, 50000, 16, 100
    keys = rng.integers(-2**31, 2**31, (B, n)).astype(np.int64) // 3
    keys = keys.astype(np.int64 if dtype == torch.int64 else np.int32)
    pos = rng.integers(0, n, (B, m))
    spl, upper = glue.sample_splitters_plain(torch.from_numpy(keys), torch.from_numpy(pos), k,
                                             upper=True)
    for r in range(B):
        want = ref_sampling.select_splitters(jnp.sort(jnp.take(jnp.asarray(keys[r]),
                                                               jnp.asarray(pos[r]))), k)
        np.testing.assert_array_equal(spl[r].numpy(), np.asarray(want))
    np.testing.assert_array_equal(upper[:, :-1].numpy(), spl.numpy())
    assert (upper[:, -1] == sampling.sentinel_for(spl.dtype)).all()
    S = 9
    cuts = np.sort(rng.integers(0, n, (B, S - 1)), axis=1)
    cuts[:, 2:4] = cuts[:, 2:3]  # empty segments
    off = np.concatenate([np.zeros((B, 1), np.int64), cuts, np.full((B, 1), n)], 1)
    u = rng.random((B, S, m), dtype=np.float32)
    spl2 = glue.sample_splitters_plain(torch.from_numpy(keys), torch.from_numpy(u), k,
                                       seg_offsets=torch.from_numpy(off.astype(np.int32)))
    for r in range(B):
        p = _ref_positions(u[r], off[r, :-1], off[r, 1:])
        svals = jnp.sort(jnp.take(jnp.asarray(keys[r]), jnp.asarray(p.reshape(-1))).reshape(S, m),
                         axis=-1)
        np.testing.assert_array_equal(spl2[r].numpy(),
                                      np.asarray(ref_sampling.select_splitters(svals, k)))


@pytest.mark.parametrize("name", list(NARROW))
def test_encode_padded_and_decode_equal_the_reference(name):
    """G5's twin: the reference's codes below n (complemented: the
    reference's ``~``), the code dtype's max in the pads, the index payload
    (positions, zeros in the pads), and the decode back to the reference's
    bits (NaN canonical), for one row and for (B, n) rows."""
    np_dtype, tdtype, _ = NARROW[name]
    x = _keys(name, 3001, seed=len(name))
    want = np.asarray(ref_keyspace.encode(jnp.asarray(x)))
    for n_pad, index, complement in ((None, False, False), (3001 + 7, True, False),
                                     (8192, True, True)):
        codes, idx = codec.encode_padded(_port(x, name), n_pad, index, complement)
        n_pad = n_pad or 3001
        assert codes.shape == (n_pad,) and codes.dtype == keyspace.encoded_dtype(tdtype)
        got = keyspace.reference_code_np((~codes if complement else codes)[:3001].numpy(),
                                         tdtype)
        np.testing.assert_array_equal(got, want)
        assert (codes[3001:] == torch.iinfo(codes.dtype).max).all()
        if index:
            np.testing.assert_array_equal(idx.numpy(), np.r_[np.arange(3001), np.zeros(
                n_pad - 3001)].astype(np.int32))
        else:
            assert idx is None
        back = codec.decode(codes, tdtype, 3001, complement)
        np.testing.assert_array_equal(
            _bits(back, name), np.asarray(ref_keyspace.decode(jnp.asarray(want), np_dtype)).view(
                NARROW[name][2]))
    rows = np.stack([x[:1000], x[1000:2000]])
    codes, idx = codec.encode_padded(_port(rows, name), 1024, True, False)
    for r in range(2):
        np.testing.assert_array_equal(keyspace.reference_code_np(codes[r, :1000].numpy(), tdtype),
                                      want[1000 * r:1000 * (r + 1)])
        np.testing.assert_array_equal(idx[r].numpy(), np.r_[np.arange(1000), [0] * 24])


X64_CHILD = r"""
import jax.numpy as jnp, numpy as np, torch
import jax
assert jax.config.jax_enable_x64
from repro.ops import keyspace as ref_keyspace
from repro_torch.kernels import codec
from repro_torch.ops import keyspace
T = {"int64": (np.int64, torch.int64), "uint64": (np.uint64, torch.uint64),
     "float64": (np.float64, torch.float64)}
rng = np.random.default_rng(64)
for name, (np_dtype, tdtype) in T.items():
    raw = rng.integers(0, 2**63, 3001, dtype=np.uint64) * np.uint64(2) + rng.integers(
        0, 2, 3001, dtype=np.uint64)
    raw[:5] = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)
    if name == "float64":
        raw[5:13] = np.concatenate([np.array([1, 2**63 + 1], np.uint64), np.array(
            [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0]).view(np.uint64)])
    x = raw.view(np_dtype)
    want = np.asarray(ref_keyspace.encode(jnp.asarray(x)))
    t = torch.from_numpy(raw.view(np.int64).copy()).view(tdtype)
    for n_pad, complement in ((None, False), (8192, True)):
        codes, idx = codec.encode_padded(t, n_pad, True, complement)
        c = (~codes if complement else codes)[:3001].numpy()
        assert (keyspace.reference_code_np(c, tdtype) == want).all(), name
        assert (codes[3001:] == torch.iinfo(torch.int64).max).all(), name
        assert (idx[:3001].numpy() == np.arange(3001)).all() and not idx[3001:].any(), name
        back = codec.decode(codes, tdtype, 3001, complement).view(torch.int64).numpy()
        ref = np.asarray(ref_keyspace.decode(jnp.asarray(want), np_dtype)).view(np.int64)
        assert (back == ref).all(), name
print("x64 codec OK")
"""


@pytest.fixture(scope="module", autouse=True)
def x64_child():
    """The x64 child, started with the module so that it runs beside the
    module's other tests."""
    child = Child(X64_CHILD)
    yield child
    child.stop()


def test_64bit_codec_in_an_x64_child(x64_child):
    """G5's twin on int64, uint64 and float64 keys (NaN of any payload, +-0.0,
    +-inf, subnormals) against the reference's keyspace, which needs x64 from
    startup, in a child process."""
    out = x64_child.result(timeout=300)
    assert "x64 codec OK" in out.stdout, out.stdout + out.stderr[-5000:]


def _offsets(sizes, n):
    off = np.concatenate([[0], np.cumsum(sizes)])
    assert off[-1] <= n
    return np.append(off, n).astype(np.int32)


@pytest.mark.parametrize("limit", [None, 5000])
def test_oversized_list_agrees_with_the_reference(limit):
    """G7's list (its plain twin) over B rows with other counts: the
    verdict is the reference's ``batched_bucket_violations``, the count,
    sizes and chunks those of the mask."""
    W = 256
    rows = [_offsets([129, 1, 2047, 3, 2048, 0, 2049, 1], 20000),
            _offsets([100, 300, 50, 10, 5], 20000),
            _offsets([20000 - 2 * 4, 1, 1, 1, 1, 1, 1, 1, 1], 20000)]
    nb = max(len(r) for r in rows) - 1
    off = np.stack([np.append(r, [20000] * (nb + 1 - len(r))) for r in rows])
    meta = fallback.oversized_list(torch.from_numpy(off), nb, W, None, limit, 20000)
    lim = None if limit is None else jnp.int32(limit)
    want = bool(ref_ips4o.batched_bucket_violations(jnp.asarray(off), nb, W, None, lim))
    assert bool(fallback.verdict(meta)) == want
    assert bool(ips4o.bucket_violations(torch.from_numpy(off), nb, W, None, limit)) == want
    big = fallback.oversized_mask(torch.from_numpy(off), nb, W, None, limit)
    sizes = np.diff(off, axis=1)[big.numpy()]
    assert int(meta[1]) == int(big.sum()) and int(meta[2]) == sizes.max()
    assert int(meta[3]) == sum(-(-s // fallback.CHUNK) for s in sizes)


def test_sort_padded_equals_ips4o_sort():
    """The ``ops`` entry points' internal entry: arrays handed over padded
    (G5's codes and index) sort as ``ips4o_sort`` sorts them; unpadded
    arrays are refused."""
    cfg = ips4o.SortConfig(base_case=256, kmax=64, tile=256)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(20000).astype(np.float32))
    codes, idx = codec.encode_padded(x, ips4o.padded_length(20000, 256), True)
    out = ips4o.sort_padded({"k": codes, "v": idx}, 20000, cfg)
    want_k, want_v = ips4o.ips4o_sort(keyspace.encode(x), torch.arange(20000, dtype=torch.int32),
                                      cfg=cfg)
    assert torch.equal(out["k"][:20000], want_k) and torch.equal(out["v"][:20000], want_v)
    with pytest.raises(ValueError):
        ips4o.sort_padded({"k": keyspace.encode(x)}, 20000, cfg)
