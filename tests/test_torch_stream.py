"""Parity of the port's out-of-core stream layer with the reference, on the CPU.

``repro_torch.stream`` (``external_sort``, ``external_argsort``,
``streaming_topk`` both ways, ``streaming_group_by``, ``merge``) against
``repro.stream`` on the same inputs: the nine generators x {float32, int32}
over several chunks, ragged and generator-fed streams, NaN and signed
zeros, duplicates across run boundaries, ragged / empty / k = 1 runs with
payloads.  The plain K5 twin (``merge_path_perm`` on a CPU tensor) against
the reference's Pallas kernel in interpret mode and its jnp oracle, and the
plain diagonal search against ``merge_path_partition``.  The reference gets
a plan cache in the test's own directory, shared by the module so its
sorters compile once per shape.  Every output is keys, indices or counts:
the tolerance is exact equality (float keys compared by their bits).
"""
import doctest
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import stream as ref_stream
from repro.data.distributions import DISTRIBUTIONS, make_input
from repro.kernels.merge_path import merge_path_partition as ref_partition
from repro.kernels.merge_path import merge_path_perm as ref_merge_path_perm
from repro.kernels.ref import merge_path_perm_ref
from repro.ops import PlanCache
from repro.ops.keyspace import encode_np
from repro_torch import stream
from repro_torch.kernels import merge_path
from repro_torch.stream import runs
from torch_one_thread import one_torch_thread  # noqa: F401

SIGN = np.uint32(0x80000000)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return PlanCache(path=str(tmp_path_factory.mktemp("plans") / "p.json"))


def bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def to_port(u):
    """Reference uint32 codes -> the port's signed int32 codes."""
    return torch.as_tensor((np.asarray(u, np.uint32) ^ SIGN).view(np.int32).copy())


def specials(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[::7] = np.nan
    x[1::11] = -0.0
    x[2::13] = 0.0
    x[3::17] = np.float32(np.nan) * -1
    return x


# ---------------------------------------------------------------------------
# external_sort / external_argsort
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_external_sort_distributions(cache, dist, dtype):
    x = make_input(dist, 4096, dtype, seed=5)  # 4 chunks, 2 rounds
    got = stream.external_sort(x, chunk_size=1024, **CPU)
    want = ref_stream.external_sort(x, chunk_size=1024, cache=cache)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_external_argsort_distributions(cache, dist, dtype):
    x = make_input(dist, 3 * 1024, dtype, seed=6)  # 3 chunks: an odd run rides a round
    got = stream.external_argsort(x, chunk_size=1024, **CPU)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref_stream.external_argsort(x, chunk_size=1024,
                                                                   cache=cache))


def test_external_sort_specials_ragged_and_generator(cache):
    x = specials(5000, seed=1)  # NaN of both signs, -0.0 and +0.0; ragged tail chunk
    want = ref_stream.external_sort(x, chunk_size=1024, cache=cache)
    np.testing.assert_array_equal(bits(stream.external_sort(x, chunk_size=1024, **CPU)),
                                  bits(want))
    chunks = [x[:1024], x[1024:3000], x[3000:]]  # generator-fed, uneven chunks
    np.testing.assert_array_equal(bits(stream.external_sort(iter(chunks), chunk_size=1024,
                                                            **CPU)), bits(want))
    np.testing.assert_array_equal(
        stream.external_argsort(x, chunk_size=1024, **CPU),
        ref_stream.external_argsort(x, chunk_size=1024, cache=cache))


def test_external_sort_one_chunk_and_empty(cache):
    x = make_input("TwoDup", 1000, np.int32, seed=2)
    np.testing.assert_array_equal(stream.external_sort(x, chunk_size=1024, **CPU),
                                  ref_stream.external_sort(x, chunk_size=1024, cache=cache))
    empty = np.zeros(0, np.float32)
    assert stream.external_sort(empty, **CPU).dtype == np.float32
    assert stream.external_sort(empty, **CPU).shape == (0,)
    assert stream.external_argsort(empty, **CPU).dtype == np.int32


def test_argsort_index_limit(monkeypatch):
    monkeypatch.setattr(runs, "MAX_INDEX", 3000)
    x = np.arange(4096, dtype=np.int32)
    with pytest.raises(ValueError, match="int32"):
        stream.external_argsort(x, chunk_size=1024, **CPU)


# ---------------------------------------------------------------------------
# streaming top-k and group-by
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 7, 1500])
def test_streaming_topk(cache, k, largest):
    x = specials(4000, seed=9)  # NaN and +-0.0 in both directions
    got_v, got_i = stream.streaming_topk(x, k, chunk_size=1024, largest=largest, **CPU)
    want_v, want_i = ref_stream.streaming_topk(x, k, chunk_size=1024, largest=largest,
                                               cache=cache)
    np.testing.assert_array_equal(bits(got_v), bits(want_v))
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_streaming_topk_k_exceeds_stream(cache, dtype):
    x = make_input("RootDup", 2500, dtype, seed=4)
    for largest in (True, False):
        got = stream.streaming_topk(x, 3000, chunk_size=1024, largest=largest, **CPU)
        want = ref_stream.streaming_topk(x, 3000, chunk_size=1024, largest=largest,
                                         cache=cache)
        np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dist", ["EightDup", "RootDup", "TwoDup", "Uniform"])
def test_streaming_group_by(cache, dist, dtype):
    x = make_input(dist, 4096, dtype, seed=6)
    got_v, got_c = stream.streaming_group_by(x, chunk_size=1024, **CPU)
    want_v, want_c = ref_stream.streaming_group_by(x, chunk_size=1024, cache=cache)
    np.testing.assert_array_equal(bits(got_v), bits(want_v))
    np.testing.assert_array_equal(got_c, want_c)
    assert got_c.dtype == np.int64 and got_c.sum() == 4096


def test_streaming_group_by_nan_classes(cache):
    x = np.asarray([1.0, np.nan, 1.0, -np.nan, -0.0, 0.0, -0.0], np.float32)
    got_v, got_c = stream.streaming_group_by(x, chunk_size=2, **CPU)
    want_v, want_c = ref_stream.streaming_group_by(x, chunk_size=2, cache=cache)
    np.testing.assert_array_equal(bits(got_v), bits(want_v))
    np.testing.assert_array_equal(got_c, [2, 1, 2, 2])
    np.testing.assert_array_equal(got_c, want_c)


def test_streaming_empty_stream_raises():
    with pytest.raises(ValueError):
        stream.streaming_topk(np.zeros(0, np.float32), 3, **CPU)
    with pytest.raises(ValueError):
        stream.streaming_group_by(iter([]), **CPU)


# ---------------------------------------------------------------------------
# merge
def _stable_runs(x, bounds):
    """Each run stably sorted (NaN-safe), with its source indices."""
    rs, vs = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        order = np.argsort(encode_np(x[lo:hi]), kind="stable")
        rs.append(x[lo:hi][order])
        vs.append((lo + order).astype(np.int32))
    return rs, vs


def _check_merge(rs, vs, tile):
    want_k, want_v = ref_stream.merge([jnp.asarray(r) for r in rs],
                                      values=[jnp.asarray(v) for v in vs], engine="xla")
    got_k, got_v = stream.merge([torch.as_tensor(r) for r in rs],
                                values=[torch.as_tensor(v) for v in vs], tile=tile)
    np.testing.assert_array_equal(bits(got_k.numpy()), bits(np.asarray(want_k)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_merge_duplicates_across_boundaries():
    x = np.random.default_rng(7).integers(0, 5, 700).astype(np.int32)
    _check_merge(*_stable_runs(x, [0, 200, 450, 700]), tile=64)


def test_merge_nan_negzero_payload():
    pool = np.asarray([np.nan, -0.0, 0.0, -np.inf, np.inf, 1.5, -1.5, 1.5], np.float32)
    x = np.random.default_rng(3).choice(pool, 300)
    _check_merge(*_stable_runs(x, [0, 80, 150, 300]), tile=32)


@pytest.mark.parametrize("seed", range(4))
def test_merge_ragged_empty_runs(seed):
    pool = np.asarray([np.nan, -0.0, 0.0, -np.inf, np.inf, 1.0, -1.0, 2.5, 2.5], np.float32)
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(0, 26)) for _ in range(int(rng.integers(1, 6)))]
    lens[0] = max(lens[0], 1)
    x = rng.choice(pool, sum(lens))
    _check_merge(*_stable_runs(x, np.cumsum([0] + lens).tolist()), tile=int(rng.choice([8, 64])))


def test_merge_k1_and_empty():
    a = np.sort(np.asarray([3.0, 1.0, 2.0], np.float32))
    empty = np.zeros(0, np.float32)
    runs_ = [empty, a, empty, np.asarray([1.5], np.float32), empty]
    got = stream.merge([torch.as_tensor(r) for r in runs_])
    want = ref_stream.merge([jnp.asarray(r) for r in runs_])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(stream.merge([torch.as_tensor(a)]).numpy(), a)  # k = 1
    _, v = stream.merge([torch.as_tensor(a)] * 2,  # 2-D payload rows ride along
                        values=[torch.zeros(3, 2, dtype=torch.int32),
                                torch.ones(3, 2, dtype=torch.int32)])
    assert v.shape == (6, 2) and int(v.sum()) == 6


def test_merge_rejects_bad_input():
    with pytest.raises(ValueError):
        stream.merge([])
    with pytest.raises(ValueError):
        stream.merge([torch.zeros(2, 2)])
    with pytest.raises(ValueError):
        stream.merge([torch.zeros(2), torch.zeros(2, dtype=torch.int32)])
    with pytest.raises(ValueError):
        stream.merge([torch.zeros(2)], values=[])
    with pytest.raises(ValueError):
        stream.merge([torch.zeros(2), torch.zeros(2)], tile=3)


# ---------------------------------------------------------------------------
# K5's plain twin
@pytest.mark.parametrize("na,nb", [(1, 399), (257, 130)])
def test_merge_path_plain_matches_reference_kernel(na, nb):
    rng = np.random.default_rng(na)
    for _ in range(4):  # one shape per case: the reference compiles per shape and tile
        a = np.sort(rng.integers(0, 30, na).astype(np.uint32) * np.uint32(0x0F0F0F0F))
        b = np.sort(rng.integers(0, 30, nb).astype(np.uint32) * np.uint32(0x0F0F0F0F))
        got = merge_path.merge_path_perm(to_port(a), to_port(b)).numpy()
        np.testing.assert_array_equal(got, np.asarray(merge_path_perm_ref(jnp.asarray(a),
                                                                          jnp.asarray(b))))
        for tile in (16, 128):
            np.testing.assert_array_equal(
                got, np.asarray(ref_merge_path_perm(jnp.asarray(a), jnp.asarray(b), tile=tile,
                                                    interpret=True)))


def test_merge_path_partition_matches_reference():
    rng = np.random.default_rng(4)
    a = np.sort(rng.integers(0, 10, 130).astype(np.uint32) << np.uint32(28))
    b = np.sort(rng.integers(0, 10, 70).astype(np.uint32) << np.uint32(28))
    d = np.arange(0, 201, 16, dtype=np.int32)
    got = merge_path.merge_path_partition(to_port(a), to_port(b), torch.as_tensor(d))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_partition(jnp.asarray(a), jnp.asarray(b), jnp.asarray(d))))


def test_merge_path_limits():
    big = torch.empty(1 << 29, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^30"):
        merge_path.merge_path_perm_plain(big, big)
    for a, b in ((torch.zeros(2, dtype=torch.int16), torch.zeros(2, dtype=torch.int16)),
                 (torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int32))):
        with pytest.raises(ValueError):  # codes are int32 or int64, one dtype
            merge_path.merge_path_perm(a, b)
    wide = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="8192"):  # int64 steps are half as long
        merge_path.merge_path_perm(wide, wide, tile=merge_path.MAX_TILE)
    empty = torch.zeros(0, dtype=torch.int32)
    np.testing.assert_array_equal(merge_path.merge_path_perm(empty, torch.arange(
        3, dtype=torch.int32)).numpy(), [0, 1, 2])


def test_stream_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    x = np.arange(10, dtype=np.int32)
    for call in (lambda: stream.external_sort(x), lambda: stream.external_argsort(x),
                 lambda: stream.streaming_topk(x, 2), lambda: stream.streaming_group_by(x),
                 lambda: runs.form_runs(x, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("name", ["repro_torch.stream.api", "repro_torch.stream.merge",
                                  "repro_torch.stream.runs"])
def test_stream_doctests(name):
    result = doctest.testmod(importlib.import_module(name), verbose=False)
    assert result.attempted > 0 and result.failed == 0
