"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's, on the CPU.

``SyntheticLM`` batches bit-identical to the reference's (tokens and
embeddings, several steps, the iterator); ``pack_by_length`` 1-D and 2-D
(S shards through one batched argsort) equal to the reference's packing
(row ids, offsets, row counts), with documents longer than a row and
heavy ties; ``chunk_size=`` (the out-of-core argsort) equal to the
reference's chunked packing and with the in-memory row count.  The mesh
form runs on spawned ``gloo`` ranks in ``tests/test_torch_scheduler.py``,
whose ranks serve both mesh tests.  Every output is integers: exact.
"""
import itertools

import numpy as np
import pytest

from repro.data import pipeline as ref_pipeline
from repro_torch.data import pipeline
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _plans(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_OPS_PLAN_CACHE", str(tmp_path / "port_plans.json"))
    monkeypatch.setenv("REPRO_OPS_PLAN_CACHE", str(tmp_path / "ref_plans.json"))


@pytest.mark.parametrize("embed_dim", [0, 24])
def test_synthetic_lm_bit_identical(embed_dim):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=5, seed=7, embed_dim=embed_dim)
    port, ref = pipeline.SyntheticLM(**kw), ref_pipeline.SyntheticLM(**kw)
    for step in (0, 1, 17):
        got, want = port.batch(step), ref.batch(step)
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
    for got, want in itertools.islice(zip(port, ref), 3):
        np.testing.assert_array_equal(got["labels"], want["labels"])


def _check_pack(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("n,high,seq", [(777, 512, 1024), (2000, 40, 128), (300, 3000, 1024)])
def test_pack_by_length_1d_equals_the_reference(n, high, seq):
    lengths = np.random.default_rng(n).integers(1, high, n).astype(np.int32)
    _check_pack(pipeline.pack_by_length(lengths, seq, **CPU),
                ref_pipeline.pack_by_length(lengths, seq))


def test_pack_by_length_2d_equals_the_reference():
    lengths = np.random.default_rng(4).integers(1, 300, (4, 500)).astype(np.int32)
    got = pipeline.pack_by_length(lengths, 512, **CPU)
    want = ref_pipeline.pack_by_length(lengths, 512)
    assert len(got) == len(want) == 4
    for g, w, row in zip(got, want, lengths):
        _check_pack(g, w)
        _check_pack(g, pipeline.pack_by_length(row, 512, **CPU))


def test_pack_by_length_chunked_equals_the_reference():
    lengths = np.random.default_rng(5).integers(1, 512, 3000).astype(np.int32)
    got = pipeline.pack_by_length(lengths, 1024, chunk_size=512, **CPU)
    _check_pack(got, ref_pipeline.pack_by_length(lengths, 1024, chunk_size=512))
    assert got[2] == pipeline.pack_by_length(lengths, 1024, **CPU)[2]
