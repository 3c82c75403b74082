"""Parity of the port's grouping ops and kernel K6 with the reference, on the CPU.

``repro_torch.ops.group_by`` (every method), ``unique`` and ``run_length``
against ``repro.ops`` over the nine generators x {float32, int32} and the
edge cases (NaN classes, signed zeros, empty, one key), with every field
of the result compared, padding included; ``segmented_sort`` against
``repro.ops.segmented_sort``; the plain K6 twins (``dispatch_ranks``,
``partition_ranks``, ``partition_ranks_batched`` on CPU tensors) against
the reference's Pallas kernels in interpret mode, over the in-range
positions (the trash id's destination is unspecified); and
``partition_ranks_kernel`` / ``moe_group_tokens`` against their reference
counterparts.  Every output is keys, indices or counts: the tolerance is
exact equality (float keys compared by their bits).
"""
import dataclasses
import doctest
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.core import ips4o as ref_ips4o
from repro.core.partition import partition_ranks_pallas
from repro.data.distributions import DISTRIBUTIONS, make_input
from repro.kernels import dispatch_rank as ref_dispatch_rank
from repro.kernels import ops as ref_kernel_ops
from repro_torch import ops
from repro_torch.core import ips4o
from repro_torch.core.partition import partition_ranks_kernel
from repro_torch.kernels import dispatch_rank
from repro_torch.kernels.ops import moe_group_tokens
from torch_one_thread import one_torch_thread  # noqa: F401

# two levels at n = 2048 (W = 256, kmax = 8), so K1/K2/K3's plain twins run
TINY = dict(base_case=256, kmax=8, tile=128, max_sample=64, slack=4)
REF_CFG = ref_ips4o.SortConfig(**TINY)
CFG = ips4o.config_from_reference(dataclasses.asdict(REF_CFG))
CPU = dict(device="cpu")
N = 2048


def bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_groups(got, want):
    """Every field of a port ``Groups`` equals the reference's."""
    for name in ("keys", "group_ids", "counts", "perm"):
        np.testing.assert_array_equal(bits(np_of(getattr(got, name))),
                                      bits(np_of(getattr(want, name))), err_msg=name)
    assert int(got.num_groups) == int(want.num_groups)
    if want.values is None:
        assert got.values is None
    else:
        np.testing.assert_array_equal(np_of(got.values), np_of(want.values))


def specials(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[::7] = np.nan
    x[1::11] = -0.0
    x[2::13] = 0.0
    x[3::17] = np.float32(np.nan) * -1
    return x


# ---------------------------------------------------------------------------
# group_by
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_group_by_sort(dist, dtype):
    x = make_input(dist, N, dtype, seed=3)
    v = np.random.default_rng(1).standard_normal((N, 2)).astype(np.float32)
    got = ops.group_by(x, torch.as_tensor(v), cfg=CFG, **CPU)
    want = ref_ops.group_by(jnp.asarray(x), jnp.asarray(v), cfg=REF_CFG)
    check_groups(got, want)


@pytest.mark.parametrize("method,G", [("auto", 1), ("partition", 3), ("partition", 257),
                                      ("auto", 64), ("pallas", 1), ("pallas", 3),
                                      ("pallas", 64)])
def test_group_by_int(method, G):
    rng = np.random.default_rng(G)
    ids = rng.integers(0, G, N).astype(np.int32)
    v = rng.standard_normal((N, 3)).astype(np.float32)
    got = ops.group_by(torch.as_tensor(ids), torch.as_tensor(v), num_groups=G, method=method,
                       **CPU)
    want = ref_ops.group_by(jnp.asarray(ids), jnp.asarray(v), num_groups=G, method=method)
    check_groups(got, want)
    assert got.num_groups == G


@pytest.mark.parametrize("method", ["auto", "partition", "pallas"])
def test_group_by_above_k6_counters(method):
    """More groups than K6's 4096 counters (``MAX_NB``): two K6 passes, bit
    for bit the reference's "auto" (its XLA partition at any num_groups);
    "pallas" also equals the stable argsort of the ids."""
    G, n = 10_000, 4096
    assert G > dispatch_rank.MAX_NB
    rng = np.random.default_rng(7)
    ids = rng.integers(0, G, n).astype(np.int32)
    v = rng.standard_normal((n, 2)).astype(np.float32)
    got = ops.group_by(torch.as_tensor(ids), torch.as_tensor(v), num_groups=G, method=method,
                       **CPU)
    check_groups(got, ref_ops.group_by(jnp.asarray(ids), jnp.asarray(v), num_groups=G))
    np.testing.assert_array_equal(got.perm.numpy(), np.argsort(ids, kind="stable"))
    assert got.num_groups == G


def test_group_by_edges():
    x = specials(300, seed=2)  # NaN of both signs and signed zeros: three classes of "zero"
    check_groups(ops.group_by(x, **CPU), ref_ops.group_by(jnp.asarray(x)))
    empty = np.zeros(0, np.int32)
    for kw in (dict(), dict(num_groups=4), dict(num_groups=4, method="pallas")):
        got = ops.group_by(empty, **kw, **CPU)
        want = ref_ops.group_by(jnp.asarray(empty), **kw)
        check_groups(got, want)
    with pytest.raises(ValueError):
        ops.group_by(empty, method="partition", **CPU)
    with pytest.raises(ValueError):
        ops.group_by(empty, method="segment", **CPU)


# ---------------------------------------------------------------------------
# unique / run_length
def _check_triple(got, want):
    np.testing.assert_array_equal(bits(got[0].numpy()), bits(np.asarray(want[0])))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_unique_and_run_length(dist, dtype):
    x = make_input(dist, N, dtype, seed=4)
    _check_triple(ops.unique(x, cfg=CFG, **CPU), ref_ops.unique(jnp.asarray(x), cfg=REF_CFG))
    _check_triple(ops.run_length(x, **CPU), ref_ops.run_length(jnp.asarray(x)))


def test_unique_and_run_length_edges():
    x = specials(N, seed=5)
    _check_triple(ops.unique(x, cfg=CFG, **CPU), ref_ops.unique(jnp.asarray(x), cfg=REF_CFG))
    _check_triple(ops.run_length(x, **CPU), ref_ops.run_length(jnp.asarray(x)))
    for y in (np.zeros(0, np.float32), np.asarray([-0.0], np.float32),
              np.full(N, 7, np.int32)):
        _check_triple(ops.unique(y, **CPU), ref_ops.unique(jnp.asarray(y)))
        _check_triple(ops.run_length(y, **CPU), ref_ops.run_length(jnp.asarray(y)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_run_length_takes_cfg(dtype):
    """``run_length`` takes the reference's ``cfg`` and ignores it: nothing
    is sorted.  Float keys carry NaN of both signs and signed zeros."""
    x = specials(N, seed=8) if dtype == np.float32 else make_input("TwoDup", N, dtype, seed=8)
    for ref_cfg in (REF_CFG, ref_ips4o.SortConfig(classifier="radix")):
        cfg = ips4o.config_from_reference(dataclasses.asdict(ref_cfg))
        _check_triple(ops.run_length(x, cfg=cfg, **CPU),
                      ref_ops.run_length(jnp.asarray(x), cfg=ref_cfg))


# ---------------------------------------------------------------------------
# segmented_sort
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("bounds", [[0, 5, 5, 900, 2048], [0, 2048],
                                    [0, 1, 300, 301, 1200, 1201, 2000, 2048]])
def test_segmented_sort(bounds, dtype):
    x = specials(N, seed=6) if dtype == np.float32 else make_input("TwoDup", N, dtype, seed=6)
    v = np.arange(N, dtype=np.int32)
    off = np.asarray(bounds, np.int32)
    got_k, got_v = ops.segmented_sort(x, torch.as_tensor(off), len(bounds) - 1,
                                      torch.as_tensor(v), cfg=CFG, **CPU)
    want_k, want_v = ref_ops.segmented_sort(jnp.asarray(x), jnp.asarray(off), len(bounds) - 1,
                                            jnp.asarray(v), cfg=REF_CFG)
    np.testing.assert_array_equal(bits(got_k.numpy()), bits(np.asarray(want_k)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("classifier", [None, "tree", "radix", "learned"])
def test_segmented_sort_classifier(classifier):
    """``segmented_sort`` takes the reference's ``classifier``; every value
    runs the per-segment tree, so the result is the reference's bit for bit."""
    x = specials(N, seed=9)
    v = np.arange(N, dtype=np.int32)
    off = np.asarray([0, 7, 7, 1000, 2048], np.int32)
    got_k, got_v = ops.segmented_sort(x, torch.as_tensor(off), 4, torch.as_tensor(v), cfg=CFG,
                                      classifier=classifier, **CPU)
    want_k, want_v = ref_ops.segmented_sort(jnp.asarray(x), jnp.asarray(off), 4, jnp.asarray(v),
                                            cfg=REF_CFG, classifier=classifier)
    np.testing.assert_array_equal(bits(got_k.numpy()), bits(np.asarray(want_k)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_segmented_sort_above_k3_bucket_field():
    """(num_segments + 1) * 2k composite ids beyond K3's bucket field of
    2^(32 - log2 W) = 2^19 at the default W = 8192: at k = 128 the smallest
    such input is 2048 segments, over n = 8192 (one window pair).  The base
    case hands K3 window-local run indices, so the sort still returns, bit
    for bit the reference's."""
    n, segs, k = 8192, 2048, 128
    assert (segs + 1) * 2 * k > 1 << 19
    rng = np.random.default_rng(11)
    x = specials(n, seed=11)
    off = np.concatenate([[0], np.sort(rng.integers(0, n, segs - 1)), [n]]).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    got_k, got_v = ops.segmented_sort(x, torch.as_tensor(off), segs, torch.as_tensor(v), k=k,
                                      **CPU)
    want_k, want_v = ref_ops.segmented_sort(jnp.asarray(x), jnp.asarray(off), segs,
                                            jnp.asarray(v), k=k)
    np.testing.assert_array_equal(bits(got_k.numpy()), bits(np.asarray(want_k)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_segmented_sort_small_and_checks():
    x = torch.tensor([3.0, 1.0, 2.0, 2.0, 0.0])
    radix = ips4o.SortConfig(classifier="radix")  # segments always take the tree
    assert ops.segmented_sort(x, [0, 3, 5], 2, cfg=radix, **CPU).tolist() == [
        1.0, 2.0, 3.0, 0.0, 2.0]
    assert ops.segmented_sort(x[:1], [0, 1], 1, **CPU).tolist() == [3.0]
    with pytest.raises(ValueError):
        ops.segmented_sort(x, [0, 5], 2, **CPU)


# ---------------------------------------------------------------------------
# K6's plain twins against the reference kernels (interpret mode)
def _starts(counts, rng, prefix):
    """The exclusive prefix of the counts, or arbitrary non-prefix starts."""
    if prefix:
        return (np.cumsum(counts, -1) - counts).astype(np.int32)
    return rng.integers(0, 10_000, counts.shape).astype(np.int32)


@pytest.mark.parametrize("E,tiles", [(4, 1), (8, 4), (64, 1), (64, 4)])
def test_dispatch_ranks_plain(E, tiles):
    n = tiles * 8 * 128
    rng = np.random.default_rng(E)
    eid = rng.integers(0, E, n).astype(np.int32)
    start = _starts(np.bincount(eid, minlength=E), rng, prefix=tiles == 1)
    got = dispatch_rank.dispatch_ranks(torch.as_tensor(eid), torch.as_tensor(start),
                                       num_experts=E)
    want = ref_dispatch_rank.dispatch_ranks(jnp.asarray(eid), jnp.asarray(start), num_experts=E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nb,prefix", [(1, True), (5, False), (21, True), (257, False)])
def test_partition_ranks_plain(nb, prefix):
    rng = np.random.default_rng(nb)
    n = 3000  # not a tile multiple: the reference pads with the trash id
    bkt = rng.integers(0, nb + 1, n).astype(np.int32)  # trash ids (nb) sprinkled in
    start = _starts(np.bincount(bkt, minlength=nb + 1)[:nb], rng, prefix)
    got = dispatch_rank.partition_ranks(torch.as_tensor(bkt), torch.as_tensor(start), nb=nb)
    want = np.asarray(ref_dispatch_rank.partition_ranks(jnp.asarray(bkt), jnp.asarray(start),
                                                        nb=nb))
    live = bkt < nb
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    assert (got.numpy()[~live] == -1).all()
    off = np.concatenate([start, [n]]).astype(np.int32)
    np.testing.assert_array_equal(
        partition_ranks_kernel(torch.as_tensor(bkt), torch.as_tensor(off), nb).numpy()[live],
        np.asarray(partition_ranks_pallas(jnp.asarray(bkt), jnp.asarray(off), nb))[live])


@pytest.mark.parametrize("prefix", [True, False])
def test_partition_ranks_batched_plain(prefix):
    rng = np.random.default_rng(1)
    B, n, nb = 4, 3000, 21
    bkt = rng.integers(0, nb + 1, (B, n)).astype(np.int32)
    counts = np.stack([np.bincount(r, minlength=nb + 1)[:nb] for r in bkt])
    start = _starts(counts, rng, prefix)
    got = dispatch_rank.partition_ranks_batched(torch.as_tensor(bkt), torch.as_tensor(start),
                                                nb=nb).numpy()
    want = np.asarray(ref_dispatch_rank.partition_ranks_batched(jnp.asarray(bkt),
                                                                jnp.asarray(start), nb=nb))
    live = bkt < nb
    np.testing.assert_array_equal(got[live], want[live])
    off = np.concatenate([start, np.full((B, 1), n)], 1).astype(np.int32)
    np.testing.assert_array_equal(
        partition_ranks_kernel(torch.as_tensor(bkt), torch.as_tensor(off), nb).numpy(), got)
    for r in range(B):  # each row is the 1-D placement of that row
        np.testing.assert_array_equal(
            got[r], dispatch_rank.partition_ranks(torch.as_tensor(bkt[r]),
                                                  torch.as_tensor(start[r]), nb=nb).numpy())


def test_dispatch_rank_checks():
    ids = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        dispatch_rank.partition_ranks(ids, torch.zeros(4097, dtype=torch.int32), nb=4097)
    with pytest.raises(ValueError):
        dispatch_rank.partition_ranks(ids, torch.zeros(3, dtype=torch.int32), nb=4)
    with pytest.raises(ValueError):
        dispatch_rank.partition_ranks(ids.to(torch.int64), torch.zeros(4, dtype=torch.int32),
                                      nb=4)
    with pytest.raises(ValueError):
        dispatch_rank.partition_ranks_batched(ids, torch.zeros(4, dtype=torch.int32), nb=4)


def test_moe_group_tokens():
    E, n, dm = 8, 2048, 16
    rng = np.random.default_rng(0)
    eid = rng.integers(0, E, n).astype(np.int32)
    tok = rng.standard_normal((n, dm)).astype(np.float32)
    got = moe_group_tokens(torch.as_tensor(eid), torch.as_tensor(tok), E)
    want = ref_kernel_ops.moe_group_tokens(jnp.asarray(eid), jnp.asarray(tok), E)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grouping_ops_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    x = np.arange(10, dtype=np.int32)
    for call in (lambda: ops.group_by(x), lambda: ops.group_by(x, num_groups=10),
                 lambda: ops.unique(x), lambda: ops.run_length(x),
                 lambda: ops.segmented_sort(x, [0, 10], 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("name", ["repro_torch.ops.groupby", "repro_torch.ops.segmented"])
def test_grouping_doctests(name):
    result = doctest.testmod(importlib.import_module(name), verbose=False)
    assert result.attempted > 0 and result.failed == 0
