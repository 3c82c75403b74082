"""Payload pytrees through the port's ops against the reference's, on the CPU.

One payload with every kind of node and leaf the reference's ``jax.tree``
carries: a dict holding a tuple of a dict and a list, a NamedTuple, and
``None`` leaves (an empty subtree in ``jax.tree``, which torch's pytree
would take for a leaf); leaves of int32, bool, uint32, bfloat16, int16
and (n, 3) float32 (float64, which jax truncates without x64, is held to
the gather by the argsort).  It goes through ``ops.sort`` (tree and learned),
``ops.batched_sort``, ``ops.segmented_sort`` and ``ops.group_by`` (by sort
and by partition) in both packages at n = 3000 and a small config (two
levels and the fallback run).  The outputs must have the same structure
(the same containers, NamedTuple class and keys, ``None`` where it was)
and bit-identical leaves.  Tolerance: zero, leaves compared as bits.
"""
import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.core.ips4o import SortConfig as RefConfig
from repro_torch import ops
from repro_torch.core import ips4o
from repro_torch.data.distributions import make_input
from torch_one_thread import one_torch_thread  # noqa: F401

N = 3000
REF_CFG = RefConfig(base_case=512, kmax=8, tile=256)
CFG = ips4o.config_from_reference(dataclasses.asdict(REF_CFG))
CPU = dict(device="cpu")


class Pair(NamedTuple):
    rows: object
    spare: Optional[object]


def _payload(lead, seed=0):
    """The payload as numpy leaves (leading dims ``lead``), one tree."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(lead))
    return {
        "id": np.arange(size, dtype=np.int32).reshape(lead),
        "nested": ({"flag": rng.random(lead) < 0.5,
                    "u": rng.integers(0, 2**32, lead, dtype=np.uint64).astype(np.uint32)},
                   [rng.standard_normal(lead).astype(ml_dtypes.bfloat16), None,
                    rng.integers(-2**15, 2**15, lead).astype(np.int16)]),
        "pair": Pair(rows=rng.standard_normal(lead + (3,)).astype(np.float32), spare=None),
        "none": None,
    }


_TORCH = {np.dtype(ml_dtypes.bfloat16): torch.bfloat16, np.dtype(np.uint32): torch.uint32}


def _to_torch(leaf):
    dtype = _TORCH.get(leaf.dtype)
    if dtype is None:
        return torch.from_numpy(leaf.copy())
    return torch.from_numpy(leaf.view(f"i{leaf.itemsize}").copy()).view(dtype)


def _map(tree, fn):
    """``fn`` over the array leaves of a payload tree, containers kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_map(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _bits(leaf):
    """A leaf's bits as numpy, from torch or jax."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in (torch.bfloat16, torch.uint32):
            leaf = leaf.view({torch.bfloat16: torch.int16, torch.uint32: torch.int32}[leaf.dtype])
        a = leaf.numpy()
    else:
        a = np.asarray(leaf)
    return a.view(f"u{a.itemsize}") if a.dtype != np.bool_ else a


def _same(got, want, where="payload"):
    """Same containers (type, keys, length, None) and bit-identical leaves."""
    if want is None or got is None:
        assert got is None and want is None, where
    elif isinstance(want, dict):
        # jax.tree rebuilds a dict with its keys sorted, torch's pytree keeps
        # their order: the same keys either way
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        g, w = _bits(got), _bits(want)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        np.testing.assert_array_equal(g, w, err_msg=where)


def _keys(seed=1, lead=(N,)):
    x = make_input("TwoDup", int(np.prod(lead)), np.float32, seed=seed).reshape(lead)
    x.reshape(-1)[::101] = np.nan
    return x


@pytest.mark.parametrize("clf", ["tree", "learned"])
def test_sort(clf):
    x, p = _keys(), _payload((N,))
    k, v = ops.sort(torch.from_numpy(x), _map(p, _to_torch), cfg=CFG, classifier=clf, **CPU)
    rk, rv = ref_ops.sort(jnp.asarray(x), _map(p, jnp.asarray), cfg=REF_CFG, classifier=clf)
    np.testing.assert_array_equal(k.numpy().view(np.uint32), np.asarray(rk).view(np.uint32))
    _same(v, rv)
    assert v["nested"][1][1] is None and v["pair"].spare is None and v["none"] is None


def test_batched_sort():
    lead = (2, N)
    x, p = _keys(seed=2, lead=lead), _payload(lead, seed=2)
    k, v = ops.batched_sort(torch.from_numpy(x), _map(p, _to_torch), cfg=CFG, **CPU)
    rk, rv = ref_ops.batched_sort(jnp.asarray(x), _map(p, jnp.asarray), cfg=REF_CFG)
    np.testing.assert_array_equal(k.numpy().view(np.uint32), np.asarray(rk).view(np.uint32))
    _same(v, rv)


def test_segmented_sort():
    x, p = _keys(seed=3), _payload((N,), seed=3)
    offsets = np.array([0, 5, 5, 900, 1700, 2999, N], np.int32)
    k, v = ops.segmented_sort(torch.from_numpy(x), torch.from_numpy(offsets), 6,
                              _map(p, _to_torch), cfg=CFG, **CPU)
    rk, rv = ref_ops.segmented_sort(jnp.asarray(x), jnp.asarray(offsets), 6,
                                    _map(p, jnp.asarray), cfg=REF_CFG)
    np.testing.assert_array_equal(k.numpy().view(np.uint32), np.asarray(rk).view(np.uint32))
    _same(v, rv)


@pytest.mark.parametrize("method", ["sort", "partition"])
def test_group_by(method):
    p = _payload((N,), seed=4)
    if method == "sort":
        x = _keys(seed=4)
        kw = {}
    else:
        x = np.random.default_rng(4).integers(0, 37, N).astype(np.int32)
        kw = {"num_groups": 37}
    g = ops.group_by(torch.from_numpy(x), _map(p, _to_torch), method=method, cfg=CFG, **kw,
                     **CPU)
    rg = ref_ops.group_by(jnp.asarray(x), _map(p, jnp.asarray), method=method, cfg=REF_CFG,
                          **kw)
    np.testing.assert_array_equal(g.perm.numpy(), np.asarray(rg.perm))
    _same(g.values, rg.values)


def test_payload_leaves_are_checked():
    x = torch.zeros(10)
    with pytest.raises(ValueError, match="leading dims"):
        ops.sort(x, {"a": torch.zeros(10), "b": torch.zeros(9)}, **CPU)
    with pytest.raises(ValueError, match="leading dims"):
        ops.batched_sort(torch.zeros(2, 10), [torch.zeros(10)], **CPU)
    # float64 and uint64 leaves ride bit for bit: the gather by the argsort
    keys = torch.from_numpy(_keys(seed=5))
    wide = {"f": torch.randn(N, dtype=torch.float64),
            "u": torch.randint(-2**62, 2**62, (N,)).view(torch.uint64)}
    _, v = ops.sort(keys, wide, cfg=CFG, classifier="learned", **CPU)
    order = ops.argsort(keys, cfg=CFG, **CPU).to(torch.int64)
    assert torch.equal(v["f"], wide["f"][order]) and v["u"].dtype == torch.uint64
    assert torch.equal(v["u"].view(torch.int64), wide["u"].view(torch.int64)[order])
    # an empty tree and a bare tensor come back as they went in
    assert ops.sort(x, {}, **CPU)[1] == {}
    assert isinstance(ops.sort(x, torch.arange(10), **CPU)[1], torch.Tensor)
    assert jax.tree.structure(ref_ops.sort(jnp.zeros(10), {})[1]) == jax.tree.structure({})
