"""Multi-word records in the port against the reference, on the CPU.

  * the word codec: ``encode_words`` / ``decode_words`` / ``WordSpec``
    equal to ``repro.ops.keyspace``'s for strings (empty, non-ASCII,
    prefixes, a fixed width) and mixed-dtype columns (NaN, -0.0, the
    integer extremes), and the same refusals;
  * ``data.datasets``: the four families' records and words equal to
    ``repro.data.datasets``';
  * ``argsort_records`` / ``sort_records`` with a payload equal to the
    dataset oracle (``oracle_argsort``: byte-string argsort, or
    ``np.lexsort`` of the raw columns) for every family and the tree,
    radix, learned and auto classifiers, and to the reference's
    ``sort_records``; ``tiebreak_passes`` equal to the reference's;
  * float words with NaN and -0.0 against the reference, and 64-bit word
    columns (int64, uint64, float64) against ``np.lexsort`` of their codes,
    which needs no x64 child.

n = 4096 at the reference's records geometry (W = 1024, kmax = 32, tile
256), strings clipped to 8 bytes.  Tolerance: zero; words, keys and
permutations are compared as integers.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.core.ips4o import SortConfig as RefConfig
from repro.core.ips4o import tiebreak_passes as ref_tiebreak_passes
from repro.data import datasets as ref_datasets
from repro_torch import ops
from repro_torch.core import ips4o
from repro_torch.data import datasets
from torch_one_thread import one_torch_thread  # noqa: F401

REF_CFG = RefConfig(base_case=1024, kmax=32, tile=256, max_sample=512)
CFG = ips4o.config_from_reference(dataclasses.asdict(REF_CFG))
N, WIDTH = 4096, 8
CPU = dict(device="cpu")
CLASSIFIERS = ("tree", "radix", "learned", "auto")


def _dataset(pkg, name):
    width = WIDTH if name in ("RnaSequences", "UrlPaths") else None
    return pkg.make_dataset(name, N, seed=11, width=width)


def _words(ds) -> torch.Tensor:
    return torch.from_numpy(ds.words.view(np.int32).copy()).view(torch.uint32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


STRINGS = [b"", b"a", b"ab", b"abc", b"b", "zoë".encode(), b"\xff\xfe", b"ab", b"a" * 11]
COLUMNS = (
    np.array([1.5, -0.0, 0.0, np.nan, -np.inf, 3.0, -2.5, np.inf, 1.5], np.float32),
    np.array([-32768, 7, 32767, 0, -1, 7, 3, 2, 7], np.int16),
    np.array([255, 0, 1, 2, 3, 4, 5, 6, 7], np.uint8),
    np.array([np.nan, -0.0, 1e300, -1e-300, 2.0, 0.0, 5.0, 6.0, 7.0], np.float64),
    np.array([-2**63, 2**63 - 1, 0, -1, 1, 2, 3, 4, 5], np.int64),
    np.array([2**64 - 1, 0, 1, 2**63, 4, 5, 6, 7, 8], np.uint64),
)


@pytest.mark.parametrize("records,width", [(STRINGS, None), (STRINGS, 16),
                                           (COLUMNS, None), (COLUMNS[:3], None)],
                         ids=["strings", "strings width 16", "six columns", "three columns"])
def test_word_codec_matches_the_reference(records, width):
    kw = {} if width is None else {"width": width}
    got, spec = ops.keyspace.encode_words(records, **kw)
    want, ref_spec = ref_ops.keyspace.encode_words(records, **kw)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    back, ref_back = ops.keyspace.decode_words(got, spec), ref_ops.keyspace.decode_words(want,
                                                                                        ref_spec)
    if spec.kind == "bytes":
        assert back == ref_back == [bytes(r) for r in records]
    else:
        for b, rb, col in zip(back, ref_back, records):
            assert b.dtype == rb.dtype == col.dtype
            np.testing.assert_array_equal(b.view(f"u{b.itemsize}"), rb.view(f"u{rb.itemsize}"))
            np.testing.assert_array_equal(ops.keyspace.encode_np(b), ops.keyspace.encode_np(col))


def test_word_codec_refuses_what_the_reference_refuses():
    for bad, err in (([b"a\x00b"], ValueError), ((np.zeros(3, np.complex64),), TypeError),
                     ((np.zeros(3), np.zeros(4)), ValueError), (None, ValueError)):
        for pkg in (ops.keyspace, ref_ops.keyspace):
            with pytest.raises(err):  # None: an iterable of no columns
                pkg.encode_words(iter(()) if bad is None else bad)
    for pkg in (ops.keyspace, ref_ops.keyspace):
        with pytest.raises(ValueError, match="width"):
            pkg.encode_words([b"abcdef"], width=4)


@pytest.mark.parametrize("name", sorted(datasets.DATASETS))
def test_datasets_match_the_reference(name):
    ds, ref = _dataset(datasets, name), _dataset(ref_datasets, name)
    np.testing.assert_array_equal(ds.words, ref.words)
    assert dataclasses.asdict(ds.spec) == dataclasses.asdict(ref.spec)
    np.testing.assert_array_equal(ds.payload, ref.payload)
    if ds.spec.kind == "bytes":
        assert ds.records == ref.records
    else:
        for a, b in zip(ds.records, ref.records):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(datasets.oracle_argsort(ds), ref_datasets.oracle_argsort(ref))


@pytest.mark.parametrize("classifier", CLASSIFIERS)
@pytest.mark.parametrize("name", sorted(datasets.DATASETS))
def test_argsort_records_equals_the_reference_and_the_oracle(name, classifier):
    ds = _dataset(datasets, name)
    got = ops.argsort_records(_words(ds), cfg=CFG, classifier=classifier, **CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), datasets.oracle_argsort(ds))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_ops.argsort_records(
        jnp.asarray(ds.words), cfg=REF_CFG, classifier=classifier)))


@pytest.mark.parametrize("name", sorted(datasets.DATASETS))
def test_sort_records_with_a_payload_matches_the_reference(name):
    """A pytree payload (row ids, a (n, 2) float column and a None leaf)
    through every tie-break pass, against the reference's ``sort_records``
    with the learned classifier."""
    ds = _dataset(datasets, name)
    rows = np.random.default_rng(3).standard_normal((N, 2)).astype(np.float32)
    out, vals = ops.sort_records(_words(ds), {"id": torch.from_numpy(ds.payload),
                                              "rows": torch.from_numpy(rows), "none": None},
                                 cfg=CFG, classifier="learned", **CPU)
    ref_out, ref_vals = ref_ops.sort_records(jnp.asarray(ds.words),
                                             {"id": jnp.asarray(ds.payload),
                                              "rows": jnp.asarray(rows)},
                                             cfg=REF_CFG, classifier="learned")
    np.testing.assert_array_equal(_u32(out), np.asarray(ref_out))
    np.testing.assert_array_equal(_u32(out), ds.words[datasets.oracle_argsort(ds)])
    np.testing.assert_array_equal(vals["id"].numpy(), np.asarray(ref_vals["id"]))
    np.testing.assert_array_equal(vals["rows"].numpy(), np.asarray(ref_vals["rows"]))
    assert vals["none"] is None and set(vals) == {"id", "rows", "none"}


def test_tiebreak_passes_match_the_reference():
    """Duplicate-heavy three-word keys: the sorted columns and the payload
    permutation of both packages' schedule, and ``np.lexsort``."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 4, (N, 3)).astype(np.uint32)
    idx = np.arange(N, dtype=np.int32)
    ref_cols, ref_idx = ref_tiebreak_passes([jnp.asarray(words[:, j]) for j in range(3)],
                                            jnp.asarray(idx), cfg=REF_CFG)
    enc = ops.keyspace.encode(torch.from_numpy(words.view(np.int32).copy()).view(torch.uint32))
    cols, got_idx = ips4o.tiebreak_passes([enc[:, j].contiguous() for j in range(3)],
                                          torch.from_numpy(idx), cfg=CFG)
    for c, rc in zip(cols, ref_cols):
        np.testing.assert_array_equal(ops.keyspace.reference_code_np(c.numpy(), torch.uint32),
                                      np.asarray(rc))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(got_idx.numpy(), np.lexsort(words.T[::-1]))


def test_float_words_nan_and_negative_zero():
    rng = np.random.default_rng(6)
    words = rng.choice(np.array([np.nan, -0.0, 0.0, -np.inf, 1.0, -1.0], np.float32), (N, 2))
    out = ops.sort_records(torch.from_numpy(words.copy()), cfg=CFG, **CPU)
    ref_out = ref_ops.sort_records(jnp.asarray(words), cfg=REF_CFG)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(ref_out).view(np.uint32))
    order = ops.argsort_records(torch.from_numpy(words.copy()), cfg=CFG, **CPU).numpy()
    codes = ops.keyspace.encode_np(words)
    np.testing.assert_array_equal(order, np.lexsort(codes.T[::-1]))


@pytest.mark.parametrize("np_dtype,torch_dtype", [(np.int64, torch.int64),
                                                  (np.uint64, torch.uint64),
                                                  (np.float64, torch.float64)])
def test_64bit_word_columns_against_lexsort(np_dtype, torch_dtype):
    """64-bit words run the 64-bit kernels' twins; np.lexsort of their
    reference codes is the oracle, so no x64 child is needed."""
    rng = np.random.default_rng(7)
    raw = rng.integers(-3, 3, (N, 2)).astype(np.int64) * (1 << 40)
    raw[::13, 0] = np.iinfo(np.int64).max
    raw[1::17, 1] = np.iinfo(np.int64).min
    words = raw.view(np_dtype)
    t = torch.from_numpy(raw.copy()).view(torch_dtype)
    order = ops.argsort_records(t, cfg=CFG, classifier="radix", **CPU).numpy()
    np.testing.assert_array_equal(order, np.lexsort(ops.keyspace.encode_np(words).T[::-1]))
    out = ops.sort_records(t, cfg=CFG, **CPU).view(torch.int64).numpy().view(np_dtype)
    # by codes: the float64 bit patterns hold NaNs, which come back canonical
    np.testing.assert_array_equal(ops.keyspace.encode_np(out),
                                  ops.keyspace.encode_np(words[order]))


def test_records_small_and_checked():
    w = torch.tensor([[1, 9], [0, 5], [1, 2]], dtype=torch.int32)
    assert ops.argsort_records(w, **CPU).tolist() == [1, 2, 0]
    assert ops.sort_records(w[:1], **CPU).tolist() == [[1, 9]]
    assert ops.argsort_records(w[:0], **CPU).tolist() == []
    with pytest.raises(ValueError, match="2-D"):
        ops.sort_records(torch.zeros(3, dtype=torch.int32), **CPU)
    with pytest.raises(ValueError, match="word column"):
        ops.sort_records(torch.zeros((3, 0), dtype=torch.int32), **CPU)
    with pytest.raises(ValueError, match="engine"):
        ops.with_engine(ips4o.SortConfig(), "xla", w[:, 0])
