"""End-to-end parity of ``repro_torch.ops.sort``/``argsort`` with
``repro.ops.sort``/``argsort`` on the CPU: the nine paper distributions x
{float32, int32} at a small config (one level and two levels) and the
default config at two levels.  ``check_sort`` is shared with
``test_torch_sort_edges.py``.

Sorted keys and the stable argsort are unique, so the two packages agree
bit for bit although their samples come from different generators.
Tolerance: exact equality (float keys compared as bit patterns).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.core.ips4o import SortConfig as RefConfig
from repro.data import distributions as ref_distributions
from repro_torch import ops
from repro_torch.core.ips4o import SortConfig, config_from_reference, plan_levels
from torch_one_thread import one_torch_thread  # noqa: F401

SMALL = dict(base_case=1024, kmax=32, tile=256, max_sample=256, slack=4)
REF_SMALL = RefConfig(**SMALL)
PORT_SMALL = config_from_reference(dataclasses.asdict(REF_SMALL))


def bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def check_sort(x, ref_cfg, cfg, payload=False):
    """The port's sort and argsort equal the reference's, and the stable
    keyspace oracle."""
    want_keys = np.asarray(ref_ops.sort(jnp.asarray(x), cfg=ref_cfg))
    want_order = np.asarray(ref_ops.argsort(jnp.asarray(x), cfg=ref_cfg))
    got_keys = ops.sort(torch.as_tensor(x), cfg=cfg, device="cpu").numpy()
    got_order = ops.argsort(torch.as_tensor(x), cfg=cfg, device="cpu").numpy()
    np.testing.assert_array_equal(bits(got_keys), bits(want_keys))
    np.testing.assert_array_equal(got_order, want_order)
    oracle = np.argsort(ops.keyspace.encode_np(x), kind="stable")
    np.testing.assert_array_equal(got_order, oracle)
    assert got_order.dtype == np.int32
    if payload:
        vals = torch.arange(len(x), dtype=torch.int64) * 3
        k, v = ops.sort(torch.as_tensor(x), vals, cfg=cfg, device="cpu")
        np.testing.assert_array_equal(v.numpy(), oracle * 3)
        np.testing.assert_array_equal(bits(k.numpy()), bits(want_keys))


@pytest.mark.parametrize("n", [5000, 20000])  # one level / two levels
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dist", sorted(ref_distributions.DISTRIBUTIONS))
def test_sort_matches_reference(dist, dtype, n):
    n_pad = -(-n // 1024) * 1024
    assert len(plan_levels(n_pad, PORT_SMALL)) == (1 if n == 5000 else 2)
    x = ref_distributions.make_input(dist, n, dtype, seed=7)
    check_sort(x, REF_SMALL, PORT_SMALL)


@pytest.mark.parametrize("dist,dtype", [("Uniform", np.float32), ("TwoDup", np.int32)])
def test_default_config_two_levels(dist, dtype):
    n = 200_000
    assert plan_levels(-(-n // 8192) * 8192, SortConfig()) == [128, 2]
    x = ref_distributions.make_input(dist, n, dtype, seed=2)
    check_sort(x, RefConfig(), SortConfig())
