"""Parity of the port's out-of-core stream with the reference's on the key
dtypes of 32 bits or fewer beside float32 and int32 (which
``tests/test_torch_stream.py`` holds): int8, uint8, int16, uint16, float16,
bfloat16 and uint32.

``external_sort``, ``external_argsort``, ``streaming_topk`` both ways,
``streaming_group_by`` (generator-fed, ragged chunks) and ``stream.merge``
with a payload, against ``repro.stream`` on the same numpy inputs from a
seed: heavy duplicates across chunk boundaries, the integer extremes, and
for floats NaN of both signs, signed zeros and infinities.  The port merges
these keys as left-aligned int32 codes through K5's plain twin; the
reference merges its own narrow codes.  Every output keeps the source's
numpy dtype (an ml_dtypes bfloat16 too), and every comparison is exact,
through integer views of the bits.  The 64-bit dtypes run in the x64 child
of ``tests/test_torch_dtypes.py``.
"""
import ml_dtypes
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import stream as ref_stream
from repro.ops import PlanCache
from repro.ops import keyspace as ref_keyspace
from repro_torch import stream
from repro_torch.ops import keyspace
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")
N, CHUNK = 4096, 1024
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
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The reference's plan cache in the test's own directory, shared by the
    module so its sorters compile once per shape."""
    return PlanCache(path=str(tmp_path_factory.mktemp("plans") / "p.json"))


def make_keys(name: str, n: int = N, seed: int = 0) -> np.ndarray:
    """Keys of dtype ``name`` from a seed: a heavy duplicate, the extremes,
    and for floats NaN of both signs, signed zeros and infinities."""
    np_dtype, _, udtype = DTYPES[name]
    rng = np.random.default_rng(seed)
    bits = np.dtype(udtype).itemsize * 8
    raw = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(udtype)
    raw[rng.random(n) < 0.3] = raw[0]
    x = raw.view(np_dtype).copy()
    if np.dtype(np_dtype).kind == "f" or np_dtype is ml_dtypes.bfloat16:
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


def bits(x, name: str) -> np.ndarray:
    """The bits of a host array, or of a port tensor, as unsigned ints."""
    udtype = DTYPES[name][2]
    if isinstance(x, torch.Tensor):
        x = x.view(_SIGNED[x.element_size()]).numpy()
    return np.asarray(x).view(udtype)


def to_torch(x: np.ndarray, name: str) -> torch.Tensor:
    _, torch_dtype, udtype = DTYPES[name]
    return torch.from_numpy(x.view(f"int{8 * np.dtype(udtype).itemsize}").copy()
                            ).view(torch_dtype)


@pytest.mark.parametrize("name", NAMES)
def test_external_sort_and_argsort(cache, name):
    """Four chunks (two tournament rounds), then three ragged ones (an odd
    run rides a round)."""
    x = make_keys(name, seed=1)
    got = stream.external_sort(x, chunk_size=CHUNK, **CPU)
    want = ref_stream.external_sort(x, chunk_size=CHUNK, cache=cache)
    assert got.dtype == x.dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(bits(got, name), bits(want, name))
    y = x[:3000]
    got = stream.external_argsort(y, chunk_size=CHUNK, **CPU)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ref_stream.external_argsort(
        y, chunk_size=CHUNK, cache=cache)))
    np.testing.assert_array_equal(got, np.argsort(keyspace.encode_np(y), kind="stable"))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_streaming_topk(cache, name, largest):
    """k = 300 across four chunks: the candidate buffer merges every chunk."""
    x = make_keys(name, seed=2)
    got_v, got_i = stream.streaming_topk(x, 300, chunk_size=CHUNK, largest=largest, **CPU)
    want_v, want_i = ref_stream.streaming_topk(x, 300, chunk_size=CHUNK, largest=largest,
                                               cache=cache)
    assert got_v.dtype == x.dtype
    np.testing.assert_array_equal(bits(got_v, name), bits(want_v, name))
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("name", NAMES)
def test_streaming_group_by(cache, name):
    """Generator-fed ragged chunks; NaN is one class, -0.0 and +0.0 two."""
    x = make_keys(name, seed=3)
    bounds = [0, 1000, 2500, N]

    def chunks():
        return (x[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:]))

    got_v, got_c = stream.streaming_group_by(chunks(), chunk_size=CHUNK, **CPU)
    want_v, want_c = ref_stream.streaming_group_by(chunks(), chunk_size=CHUNK, cache=cache)
    assert got_v.dtype == x.dtype
    np.testing.assert_array_equal(bits(got_v, name), bits(want_v, name))
    np.testing.assert_array_equal(got_c, np.asarray(want_c))


@pytest.mark.parametrize("name", NAMES)
def test_merge_with_payload(name):
    """Ragged runs, an empty one among them, each stably sorted in the
    keyspace order, with their source positions as the payload."""
    x = make_keys(name, n=900, seed=4)
    bounds = [0, 300, 300, 650, 900]
    runs, vals = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        order = np.argsort(keyspace.encode_np(x[lo:hi]), kind="stable")
        runs.append(x[lo:hi][order])
        vals.append((lo + order).astype(np.int32))
    got_k, got_v = stream.merge([to_torch(r, name) for r in runs],
                                values=[torch.as_tensor(v) for v in vals], tile=64)
    want_k, want_v = ref_stream.merge([jnp.asarray(r) for r in runs],
                                      values=[jnp.asarray(v) for v in vals], engine="xla")
    assert got_k.dtype == DTYPES[name][1]
    np.testing.assert_array_equal(bits(got_k, name), bits(want_k, name))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_v.numpy(), np.argsort(keyspace.encode_np(x), kind="stable"))


@pytest.mark.parametrize("dtype", [np.complex64, np.bool_])
def test_stream_refuses_complex_and_bool(dtype):
    """The keys the keyspace has no order for are refused by every entry
    point before any kernel sees them; the reference's keyspace does not
    take them either (``supported`` is false, and its stream raises a
    ``TypeError`` in the bit cast)."""
    x = np.zeros(10, dtype)
    for call in (lambda: stream.external_sort(x, chunk_size=4, **CPU),
                 lambda: stream.external_argsort(x, chunk_size=4, **CPU),
                 lambda: stream.streaming_topk(x, 3, chunk_size=4, **CPU),
                 lambda: stream.streaming_group_by(x, chunk_size=4, **CPU),
                 lambda: stream.merge([torch.from_numpy(x)] * 2)):
        with pytest.raises(NotImplementedError, match="reference refuses"):
            call()
    assert not ref_keyspace.supported(np.dtype(dtype))
    with pytest.raises(TypeError):
        ref_stream.external_sort(x, chunk_size=4)


@pytest.mark.parametrize("name", ["bfloat16", "uint16", "int8"])
def test_cpu_tensor_sources(name):
    """A CPU tensor, or generator-fed CPU tensors, stream as the numpy array
    of the same bits does (a tensor is the only host form of bfloat16 keys
    without ml_dtypes), and the results come back as CPU tensors of the
    source's dtype."""
    x = make_keys(name, seed=5)
    t = to_torch(x, name)
    got = stream.external_sort(t, chunk_size=CHUNK, **CPU)
    assert isinstance(got, torch.Tensor) and got.dtype == t.dtype
    np.testing.assert_array_equal(bits(got, name),
                                  bits(stream.external_sort(x, chunk_size=CHUNK, **CPU), name))
    np.testing.assert_array_equal(stream.external_argsort(iter(t.split(1000)), chunk_size=CHUNK,
                                                          **CPU),
                                  stream.external_argsort(x, chunk_size=CHUNK, **CPU))
    v, i = stream.streaming_topk(iter(t.split(1000)), 50, chunk_size=CHUNK, **CPU)
    wv, wi = stream.streaming_topk(x, 50, chunk_size=CHUNK, **CPU)
    assert v.dtype == t.dtype
    np.testing.assert_array_equal(bits(v, name), bits(wv, name))
    np.testing.assert_array_equal(i, wi)
    gv, gc = stream.streaming_group_by(t, chunk_size=CHUNK, **CPU)
    wv, wc = stream.streaming_group_by(x, chunk_size=CHUNK, **CPU)
    np.testing.assert_array_equal(bits(gv, name), bits(wv, name))
    np.testing.assert_array_equal(gc, wc)
