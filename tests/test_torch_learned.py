"""The port's learned-CDF classifier against the reference's
(``repro.classify.learned``), on the CPU.

The model's pieces (``fit_cdf_knots``, ``eval_cdf_buckets``,
``sample_imbalance``, ``learned_bucket_ids`` and its batched form) take the
same sample in both packages: the reference's unsigned codes there, the
port's signed codes here, for int32 codes, the left-aligned codes of 8- and
16-bit keys (with the dtype's max, the all-ones code, among them) and, in
an x64 child process, int64 codes.  The fallback flag must agree, also on
an all-equal sample.  Then ``ops.sort``/``argsort`` and ``batched_sort``
with ``classifier="learned"`` against the reference's, at n = 3000 and a
small config so that two levels run, and the level passes' picks counted
in ``learned.ROUTES``.

Tolerance: zero everywhere; knots and imbalances are compared as float32
bits, ids and permutations as integers.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.classify import learned as ref_learned
from repro.core.ips4o import SortConfig as RefConfig
from repro_torch import ops
from repro_torch.classify import learned
from repro_torch.core import ips4o
from repro_torch.data.distributions import make_input
from torch_children import Child
from torch_one_thread import one_torch_thread  # noqa: F401

N, M, K = 4096, 512, 32
SMALL = dict(base_case=512, kmax=8, tile=256)
REF_CFG = RefConfig(**SMALL, classifier="learned")
CFG = ips4o.config_from_reference(dataclasses.asdict(REF_CFG))
CPU = dict(device="cpu")

# (distribution, numpy dtype, torch dtype): int32 codes (float32, int32,
# uint32 keys) and left-aligned narrow codes (uint8, int16, float16)
CASES = [("Uniform", np.float32, torch.float32), ("Exponential", np.float32, torch.float32),
         ("TwoDup", np.int32, torch.int32), ("Uniform", np.uint32, torch.uint32),
         ("Uniform", np.uint8, torch.uint8), ("RootDup", np.int16, torch.int16),
         ("Uniform", np.float16, torch.float16)]


def _keys(dist, np_dtype, torch_dtype, n=N, seed=3):
    """Keys from a seed, with the dtype's max (the all-ones code) sprinkled
    into the integer ones."""
    x = make_input(dist, n, np_dtype, seed=seed)
    if np.dtype(np_dtype).kind in "iu":
        x[::97] = np.iinfo(np_dtype).max
    signed = {np.uint32: (np.int32, torch.int32)}.get(np_dtype)
    t = (torch.from_numpy(x.view(signed[0]).copy()).view(torch_dtype) if signed
         else torch.from_numpy(x.copy()))
    return x, t


def _f32_bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dist,np_dtype,torch_dtype", CASES,
                         ids=[f"{d}-{np.dtype(t).name}" for d, t, _ in CASES])
def test_model_pieces_match_the_reference(dist, np_dtype, torch_dtype):
    x, t = _keys(dist, np_dtype, torch_dtype)
    bits = ops.keyspace.key_bits(torch_dtype)
    ref_codes = ref_ops.keyspace.encode(jnp.asarray(x))
    codes = ops.keyspace.encode(t)
    ref_sample = jnp.sort(ref_codes[:M])
    sample = torch.sort(codes[:M]).values
    ref_knots = ref_learned.fit_cdf_knots(ref_sample)
    knots = learned.fit_cdf_knots(sample, bits=bits)
    np.testing.assert_array_equal(_f32_bits(knots.numpy()), _f32_bits(ref_knots))
    np.testing.assert_array_equal(learned.eval_cdf_buckets(codes, knots, K, bits=bits).numpy(),
                                  np.asarray(ref_learned.eval_cdf_buckets(ref_codes, ref_knots,
                                                                          K)))
    np.testing.assert_array_equal(
        _f32_bits(learned.sample_imbalance(sample, knots, K, bits=bits).numpy()),
        _f32_bits(ref_learned.sample_imbalance(ref_sample, ref_knots, K)))
    ref_ids, ref_fell = ref_learned.learned_bucket_ids(ref_codes, ref_sample,
                                                       ref_sample[16::16][:K - 1], K)
    ids, fell = learned.learned_bucket_ids(codes, sample, sample[16::16][:K - 1], K, bits=bits)
    assert fell == bool(ref_fell)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


def test_the_narrow_max_code_needs_bits():
    """The all-ones code of an 8-bit key is the int32 max: at the 32-bit
    scale it lands on 2^32, not on the reference's 255 * 2^24."""
    code = ops.keyspace.encode(torch.tensor([255, 0], dtype=torch.uint8))
    assert learned._to_float(code, bits=8).tolist() == [255.0, 0.0]
    assert learned._to_float(code).tolist() == [2.0 ** 32, 0.0]


def test_fallback_flag_all_equal():
    """An all-equal sample trips the threshold; the ids are then the tree's,
    in both packages."""
    keys = jnp.full((1024,), 7, jnp.uint32)
    ref_ids, ref_fell = ref_learned.learned_bucket_ids(keys, jnp.sort(keys[:64]),
                                                       jnp.full((31,), 7, jnp.uint32), 32)
    codes = ops.keyspace.encode(torch.full((1024,), 7, dtype=torch.int32).view(torch.uint32))
    ids, fell = learned.learned_bucket_ids(codes, codes[:64], codes[:31], 32)
    assert fell and bool(ref_fell)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


def test_batched_fallback_is_batch_wide():
    """Three rows, one of them all equal: every row falls back to its tree,
    as in the reference; without it every row keeps its model."""
    rows = np.stack([make_input("Uniform", N, np.float32, seed=s) for s in range(3)])
    for bad in (False, True):
        if bad:
            rows[1] = 0.5
        ref_codes = ref_ops.keyspace.encode(jnp.asarray(rows))
        codes = ops.keyspace.encode(torch.from_numpy(rows.copy()))
        ref_sample = jnp.sort(ref_codes[:, :M], axis=1)
        sample = torch.sort(codes[:, :M], dim=1).values
        ref_ids, ref_fell = ref_learned.learned_bucket_ids_batched(
            ref_codes, ref_sample, ref_sample[:, 16::16][:, :K - 1], K)
        ids, fell = learned.learned_bucket_ids_batched(codes, sample,
                                                       sample[:, 16::16][:, :K - 1], K)
        assert fell == bool(ref_fell) == bad
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


@pytest.mark.parametrize("dist", ["Uniform", "TwoDup", "Ones"])
def test_learned_sort_matches_the_reference(dist):
    x = make_input(dist, 3000, np.float32, seed=5)
    x[::101] = np.nan
    t, j = torch.from_numpy(x.copy()), jnp.asarray(x)
    learned.ROUTES.clear()
    got = ops.sort(t, cfg=CFG, **CPU)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref_ops.sort(j, cfg=REF_CFG)).view(np.uint32))
    np.testing.assert_array_equal(ops.argsort(t, cfg=CFG, **CPU).numpy(),
                                  np.asarray(ref_ops.argsort(j, cfg=REF_CFG)))
    # level 1 ran the model on the spread inputs, the tree on all-equal keys
    want = {"Ones": "fallback"}.get(dist, "model")
    assert learned.ROUTES[want] == 2 and sum(learned.ROUTES.values()) == 2


def test_batched_learned_sort_matches_the_reference():
    x = np.stack([make_input(d, 3000, np.float32, seed=6) for d in ("Uniform", "Exponential")])
    t, j = torch.from_numpy(x.copy()), jnp.asarray(x)
    learned.ROUTES.clear()
    got = ops.batched_sort(t, cfg=CFG, **CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_ops.batched_sort(j, cfg=REF_CFG)))
    np.testing.assert_array_equal(ops.batched_argsort(t, cfg=CFG, **CPU).numpy(),
                                  np.asarray(ref_ops.batched_argsort(j, cfg=REF_CFG)))
    assert learned.ROUTES["model"] == 2


X64_CHILD = r"""
import jax.numpy as jnp, numpy as np, torch
from repro import ops as ref_ops
from repro.classify import learned as ref_learned
from repro_torch import ops
from repro_torch.classify import learned
rng = np.random.default_rng(7)
N, M, K = 4096, 512, 32
raw = rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64, endpoint=True)
raw[::97] = np.iinfo(np.int64).max
raw[1::89] = np.iinfo(np.int64).min
cases = {"int64": raw, "uint64": raw.view(np.uint64),
         "float64": rng.standard_normal(N) * 1e6,
         "int64 dup": rng.integers(0, 5, N).astype(np.int64)}
for name, x in cases.items():
    t = torch.from_numpy(x.view(np.int64).copy()).view(
        {"uint64": torch.uint64, "float64": torch.float64}.get(name, torch.int64))
    ref_codes = ref_ops.keyspace.encode(jnp.asarray(x))
    codes = ops.keyspace.encode(t)
    rs, s = jnp.sort(ref_codes[:M]), torch.sort(codes[:M]).values
    rk, kn = ref_learned.fit_cdf_knots(rs), learned.fit_cdf_knots(s)
    assert np.array_equal(np.asarray(rk).view(np.uint32), kn.numpy().view(np.uint32)), name
    assert np.array_equal(np.asarray(ref_learned.eval_cdf_buckets(ref_codes, rk, K)),
                          learned.eval_cdf_buckets(codes, kn, K).numpy()), name
    ri, rf = ref_learned.learned_bucket_ids(ref_codes, rs, rs[16::16][:K - 1], K)
    i, f = learned.learned_bucket_ids(codes, s, s[16::16][:K - 1], K)
    assert bool(rf) == f and np.array_equal(np.asarray(ri), i.numpy()), name
    print(name, "fell back" if f else "model", "OK")
# the boundary codes of the uint64 -> float32 cast: round to nearest even
u = np.array([0, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1, 2**40 + 2**16, 2**40 + 3 * 2**16,
              2**24 + 1, 2**24 + 3], np.uint64)
got = learned._to_float(torch.from_numpy(u.view(np.int64).copy()) ^ torch.iinfo(torch.int64).min)
assert np.array_equal(got.numpy().view(np.uint32),
                      np.asarray(jnp.asarray(u).astype(jnp.float32)).view(np.uint32))
print("x64 learned OK")
"""


@pytest.fixture(scope="module", autouse=True)
def x64_child():
    """The x64 child, started with the module so that it runs beside the
    module's other tests."""
    child = Child(X64_CHILD)
    yield child
    child.stop()


def test_64bit_codes_in_an_x64_child(x64_child):
    """int64 codes (int64, uint64 and float64 keys, and a duplicate-heavy
    input that falls back) against the reference in x64 mode, and the
    uint64 -> float32 cast at the boundary codes."""
    proc = x64_child.result(timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-5000:]
    assert "x64 learned OK" in proc.stdout and "int64 dup fell back OK" in proc.stdout
