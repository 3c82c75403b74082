"""Parity of the port's radix classifier with the reference, on the CPU.

``radix_bucket_ids`` through the sign-bit bijection, the plain K1r (K1's
radix mode) against the reference's Pallas ``level_fused`` in interpret
mode, whole radix partition passes (keys *and* offsets, with no splitters
fed in: the radix classifier samples nothing), the 1-D radix
``sort``/``argsort`` over the nine generators, and the 1-D
``topk``/``bottomk`` with either classifier.  All outputs are integers or
permutations: the tolerance is exact equality everywhere.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.classify import radix_bucket_ids as ref_radix_bucket_ids
from repro.classify import radix_shift as ref_radix_shift
from repro.core import ips4o as ref_ips4o
from repro.data.distributions import DISTRIBUTIONS, make_input
from repro.kernels.level_fused import level_fused as ref_level_fused
from repro.ops import keyspace as ref_keyspace
from repro_torch import ops
from repro_torch.classify import radix_bucket_ids, radix_shift, resolve_classifier
from repro_torch.core import ips4o
from repro_torch.kernels.level_fused import level_fused
from test_torch_level import to_port, to_ref
from test_torch_sort import bits
from torch_one_thread import one_torch_thread  # noqa: F401

# one level up to n = 512, two levels up to n = 4096 (W = 256, kmax = 8)
TINY = dict(base_case=256, kmax=8, tile=128, max_sample=64, slack=4)
UMAX = np.iinfo(np.uint32).max


def _configs(classifier):
    ref_cfg = ref_ips4o.SortConfig(**TINY, classifier=classifier)
    return ref_cfg, ips4o.config_from_reference(dataclasses.asdict(ref_cfg))


def _codes(n, seed):
    """Full-range uint32 codes with sentinels and the extremes."""
    u = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[::13] = UMAX
    u[1::17] = 0
    u[2::19] = 0x80000000
    return u


@pytest.mark.parametrize("consumed", [0, 3, 30, 40])
@pytest.mark.parametrize("k", [2, 8, 128])
def test_radix_bucket_ids_match_reference(k, consumed):
    u = _codes(3000, k + consumed)
    assert radix_shift(k, consumed) == ref_radix_shift(jnp.uint32, k, consumed)
    want = ref_radix_bucket_ids(jnp.asarray(u), k, consumed)
    got = radix_bucket_ids(to_port(u), k, consumed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # any shape, elementwise
    got2 = radix_bucket_ids(to_port(u).reshape(3, 1000), k, consumed)
    np.testing.assert_array_equal(got2.reshape(-1).numpy(), np.asarray(want))


@pytest.mark.parametrize("consumed", [0, 3])
@pytest.mark.parametrize("n_real", [4096, 4000])
@pytest.mark.parametrize("k", [4, 32])
def test_level_fused_radix_matches_reference(k, n_real, consumed):
    u = _codes(4096, k)
    u[n_real:] = UMAX  # pads hold the sentinel
    want_dest, want_off = ref_level_fused(
        jnp.asarray(u), None, k=k, n_real=n_real, classifier="radix",
        consumed_bits=consumed, interpret=True,
    )
    for tile in (256, 4096):  # the placement does not depend on the tiling
        dest, off = level_fused(to_port(u), k=k, n_real=n_real, tile=tile,
                                classifier="radix", consumed_bits=consumed)
        np.testing.assert_array_equal(dest.numpy(), np.asarray(want_dest))
        np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))


@pytest.mark.parametrize("dist,dtype,n", [  # one level at n = 500, two at 3000
    ("Uniform", np.int32, 500), ("Uniform", np.int32, 3000),
    ("Exponential", np.float32, 500), ("RootDup", np.int32, 3000),
])
def test_radix_partition_passes_match_reference(dist, dtype, n):
    ref_cfg, cfg = _configs("radix")
    u = ref_keyspace.encode_np(make_input(dist, n, dtype, seed=4))
    n_pad = -(-n // 256) * 256
    u_pad = np.concatenate([u, np.full(n_pad - n, UMAX, np.uint32)])
    levels = ips4o.plan_levels(n_pad, cfg)
    assert levels == ref_ips4o.plan_levels(n_pad, ref_cfg) and len(levels) == (
        1 if n == 500 else 2)
    want, want_off, want_nb, want_pad = ref_ips4o.partition_passes(
        {"k": jnp.asarray(u_pad)}, n, ref_cfg, levels)
    arrays = ips4o.pad_with_sentinel({"k": to_port(u)}, 256)
    out, off, nb, pad_bucket = ips4o.partition_passes(arrays, n, cfg, levels)
    assert (nb, pad_bucket) == (want_nb, want_pad)
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    np.testing.assert_array_equal(to_ref(out["k"]), np.asarray(want["k"]))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_radix_sort_matches_reference(dist, dtype):
    ref_cfg, cfg = _configs("radix")
    x = make_input(dist, 4000, dtype, seed=9)  # two levels
    want_order = np.asarray(ref_ops.argsort(jnp.asarray(x), cfg=ref_cfg))
    want_keys = x[want_order]  # the reference's sort is its argsort's gather
    got_keys = ops.sort(torch.as_tensor(x), cfg=cfg, device="cpu").numpy()
    got_order = ops.argsort(torch.as_tensor(x), cfg=cfg, device="cpu").numpy()
    np.testing.assert_array_equal(bits(got_keys), bits(want_keys))
    np.testing.assert_array_equal(got_order, want_order)
    # the classifier keyword overrides the config's, as in the reference
    tree_cfg = dataclasses.replace(cfg, classifier="tree")
    np.testing.assert_array_equal(
        ops.argsort(torch.as_tensor(x), cfg=tree_cfg, classifier="radix",
                    device="cpu").numpy(), want_order)


def _specials(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[::7] = np.nan
    x[1::11] = -0.0
    x[2::13] = 0.0
    x[3::5] = x[3]  # ties, which keep their input order
    return x


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("n,k", [(200, 1), (200, 205), (3000, 37)])  # no level, k >= n, 2
def test_topk_bottomk_match_reference(classifier, n, k):
    ref_cfg, cfg = _configs(classifier)
    for x in (_specials(n, n), make_input("TwoDup", n, np.int32, seed=n)):
        for op, ref_op in ((ops.topk, ref_ops.topk), (ops.bottomk, ref_ops.bottomk)):
            want_v, want_i = ref_op(jnp.asarray(x), k, cfg=ref_cfg)
            got_v, got_i = op(torch.as_tensor(x), k, cfg=cfg, device="cpu")
            np.testing.assert_array_equal(bits(got_v.numpy()), bits(want_v))
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            assert got_i.dtype == torch.int32


def test_topk_bottomk_edges():
    x = torch.tensor([3.0, 1.0, 2.0])
    v, i = ops.topk(x, 0, device="cpu")
    assert v.shape == (0,) and i.shape == (0,) and i.dtype == torch.int32
    v, i = ops.bottomk(torch.zeros(0), 4, device="cpu")
    assert v.shape == (0,) and i.shape == (0,)
    v, i = ops.bottomk(torch.tensor([5], dtype=torch.int32), 3, device="cpu")
    assert v.tolist() == [5] and i.tolist() == [0]
    with pytest.raises(ValueError, match="batched"):
        ops.topk(torch.zeros((2, 3)), 1, device="cpu")


def test_resolve_classifier():
    assert resolve_classifier("tree") == "tree" and resolve_classifier("radix") == "radix"
    # "learned" passes through; "auto" with nothing raced is the tree, as in
    # the reference
    assert resolve_classifier("learned") == "learned" and resolve_classifier("auto") == "tree"
    with pytest.raises(ValueError, match="unknown"):
        resolve_classifier("bogus")
    with pytest.raises(ValueError, match="splitters"):
        level_fused(torch.zeros(256, dtype=torch.int32), torch.zeros(7, dtype=torch.int32),
                    k=8, classifier="radix")
