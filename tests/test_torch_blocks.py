"""Parity of the port's block path with the reference, on the CPU.

K8 (``kernels.block_permute.permute_blocks_by_dest`` on CPU tensors, which
runs its plain twin) and ``stable_block_dest`` against the reference's
Pallas kernel in interpret mode over the adversarial layouts of
``tests/test_inplace.py`` (identity, alternating buckets, partial tails,
one full cycle, random fuzz, one block), and the choice of K8's team
(``team_shape``) over every block size the kernel's wrapper takes; K9
(``kernels.permute_inplace.permute_blocks_inplace``, the host replay of the
reference's moves) against the reference's interpret-mode kernel bit for
bit on ``tests/test_kernels.py``'s cases, and against the multiset oracle
``permute_blocks_ref``; ``core.partition.partition_blocks`` on its kernel
branch and its gather branch (``tests/test_engines.py:131``);
``kernels.ops.sort_blocks``; and ``core.s3sort.s3_sort``
(``tests/test_sort_core.py:133``) with NaN and signed zeros.  The moves
happen in the caller's tensor, which every wrapper returns.  Data is
compared by its bits (uint32 data rides as an int32 view: the CPU's torch
cannot compute on uint32): the tolerance is exact equality.
"""
import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import partition_blocks as ref_partition_blocks
from repro.core.s3sort import s3_sort as ref_s3_sort
from repro.data.distributions import make_input
from repro.kernels import ops as ref_kernel_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.block_permute import permute_blocks_by_dest as ref_by_dest
from repro.kernels.block_permute import stable_block_dest as ref_stable_block_dest
from repro.kernels.permute_inplace import permute_blocks_inplace as ref_inplace
from repro_torch.core.partition import partition_blocks
from repro_torch.core.s3sort import s3_sort
from repro_torch.kernels import block_permute, ops, permute_inplace, ref
from torch_one_thread import one_torch_thread  # noqa: F401

BLOCK = 1024


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def port_of(a):
    """A fresh torch tensor of the same bits (uint32 as an int32 view)."""
    a = np.asarray(a)
    return torch.as_tensor((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def rand_perm(nblocks, seed):
    return np.random.default_rng(seed).permutation(nblocks).astype(np.int32)


# ---------------------------------------------------------------------------
# K8 and stable_block_dest


def roundtrip(dst, nblocks, n_extra=0, seed=0, block_elems=BLOCK):
    n = nblocks * block_elems + n_extra
    a = np.random.default_rng(seed).integers(0, 1 << 31, n, dtype=np.uint32)
    want = np.asarray(ref_by_dest(jnp.asarray(a), jnp.asarray(dst), block_elems=block_elems,
                                  interpret=True))
    t = port_of(a)
    got = block_permute.permute_blocks_by_dest(t, torch.as_tensor(dst), block_elems=block_elems)
    assert got is t  # in place: the caller's tensor comes back
    np.testing.assert_array_equal(got.numpy(), bits(want))


def test_identity_dest():
    bb = np.zeros(16, np.int32)  # every block in bucket 0
    dst = block_permute.stable_block_dest(torch.as_tensor(bb)).numpy()
    np.testing.assert_array_equal(dst, np.arange(16))
    roundtrip(dst, 16, seed=10)


def test_alternating_buckets_long_cycles():
    bb = (np.arange(16) % 2).astype(np.int32)
    dst = block_permute.stable_block_dest(torch.as_tensor(bb)).numpy()
    np.testing.assert_array_equal(dst, np.asarray(ref_stable_block_dest(jnp.asarray(bb))))
    roundtrip(dst, 16, seed=11)


@pytest.mark.parametrize("extra", [1, 127, 128, BLOCK - 1])
def test_partial_tail_stays(extra):
    roundtrip(rand_perm(8, 12), 8, n_extra=extra, seed=extra)


def test_single_full_cycle():
    roundtrip(((np.arange(12) + 1) % 12).astype(np.int32), 12, seed=13)


@pytest.mark.parametrize("seed", range(5))
def test_random_permutation_fuzz(seed):
    roundtrip(rand_perm(24, 100 + seed), 24, seed=seed)


@pytest.mark.parametrize("block_elems", [128, 256])
def test_small_blocks(block_elems):
    roundtrip(rand_perm(40, 7), 40, n_extra=5, seed=7, block_elems=block_elems)


def test_single_block_noop():
    a = torch.arange(BLOCK, dtype=torch.int32)
    got = block_permute.permute_blocks_by_dest(a, torch.zeros(1, dtype=torch.int32))
    assert got is a and torch.equal(got, torch.arange(BLOCK, dtype=torch.int32))


@pytest.mark.parametrize("seed", range(3))
def test_stable_block_dest_matches_reference(seed):
    bb = np.random.default_rng(seed).integers(0, 5, 37).astype(np.int32)
    np.testing.assert_array_equal(block_permute.stable_block_dest(torch.as_tensor(bb)).numpy(),
                                  np.asarray(ref_stable_block_dest(jnp.asarray(bb))))


def test_by_dest_refuses_bad_blocks():
    with pytest.raises(ValueError):
        block_permute.permute_blocks_by_dest(torch.zeros(1000), torch.zeros(7, dtype=torch.int32),
                                             block_elems=100)
    with pytest.raises(ValueError):  # dst must cover the full blocks
        block_permute.permute_blocks_by_dest(torch.zeros(4 * 128),
                                             torch.zeros(3, dtype=torch.int32), block_elems=128)


ACCEPTED_BLOCK_BYTES = range(128, block_permute.MAX_BLOCK_BYTES + 1, 128)


def test_team_shape_covers_every_accepted_block():
    """Every block size the wrapper takes (multiples of 128 B up to
    MAX_BLOCK_BYTES) gets a team that holds the whole block, at most 8
    words a lane and 32 warps, one warp up to 4 KB, and no whole warp or
    words-per-lane step to spare."""
    for block_bytes in ACCEPTED_BLOCK_BYTES:
        warps, wpl = block_permute.team_shape(block_bytes)
        words = block_bytes // 16
        assert wpl in (1, 2, 4, 8) and 1 <= warps <= 32
        assert warps * 32 * wpl >= words
        if block_bytes <= 4096:
            assert warps == 1 and (wpl == 1 or 32 * wpl // 2 < words)
        else:
            assert wpl == 8 and (warps - 1) * 32 * wpl < words


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (1, 8), (2, 8), (29, 8)])
def test_team_shape_reaches_every_variant(shape):
    """The kernel's five variants (one-warp teams with 1, 2, 4 and 8 words a
    lane; CTA teams of 2 to 29 warps) are each some accepted size's team;
    29 warps is the largest block's."""
    assert shape in {block_permute.team_shape(n) for n in ACCEPTED_BLOCK_BYTES}
    assert block_permute.team_shape(block_permute.MAX_BLOCK_BYTES) == (29, 8)


@pytest.mark.parametrize("block_bytes", [0, 64, 200, 4000, block_permute.MAX_BLOCK_BYTES + 128,
                                         1 << 17])
def test_team_shape_refuses_sizes_the_kernel_does_not_take(block_bytes):
    with pytest.raises(ValueError, match="takes multiples of 128 B"):
        block_permute.team_shape(block_bytes)


# ---------------------------------------------------------------------------
# K9


@pytest.mark.parametrize("k,N,be", [(2, 8, 128), (4, 32, 256), (16, 64, 128), (8, 1, 128),
                                    (64, 160, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_permute_inplace_matches_reference(k, N, be, dtype):
    rng = np.random.default_rng(k * N)
    bb = rng.integers(0, k, N).astype(np.int32)
    d = np.concatenate([[0], np.cumsum(np.bincount(bb, minlength=k))]).astype(np.int32)
    a = (bb[:, None] * 100000 + np.arange(N)[:, None] * be
         + np.arange(be)[None, :]).astype(dtype).reshape(-1)
    want = np.asarray(ref_inplace(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(d), k=k,
                                  block_elems=be))
    t = torch.as_tensor(a.copy())
    got = permute_inplace.permute_blocks_inplace(t, torch.as_tensor(bb), torch.as_tensor(d),
                                                 k=k, block_elems=be)
    assert got is t
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    # the multiset oracle: per-bucket block sets, every block intact
    canon = ref.permute_blocks_ref(torch.as_tensor(a), torch.as_tensor(bb), k=k, block_elems=be)
    np.testing.assert_array_equal(
        canon.numpy(), np.asarray(ref_oracles.permute_blocks_ref(jnp.asarray(a), jnp.asarray(bb),
                                                                 k=k, block_elems=be)))
    outb, canb = got.numpy().reshape(N, be), canon.numpy().reshape(N, be)
    for b in range(k):
        assert sorted(outb[d[b]:d[b + 1], 0].tolist()) == sorted(canb[d[b]:d[b + 1], 0].tolist())
    starts = {row[0].item(): i for i, row in enumerate(a.reshape(N, be))}
    for j in range(N):
        np.testing.assert_array_equal(outb[j], a.reshape(N, be)[starts[outb[j, 0].item()]])


def test_replay_moves_is_a_permutation_grouped_by_bucket():
    rng = np.random.default_rng(9)
    k, N = 7, 500
    bb = rng.integers(0, k, N)
    d = np.concatenate([[0], np.cumsum(np.bincount(bb, minlength=k))])
    src = np.asarray(permute_inplace.replay_moves(bb, d, k))
    assert sorted(src.tolist()) == list(range(N))
    np.testing.assert_array_equal(bb[src], np.sort(bb))


def test_permute_inplace_refuses_ragged_n():
    with pytest.raises(ValueError):
        permute_inplace.permute_blocks_inplace(torch.zeros(1000), torch.zeros(7, dtype=torch.int32),
                                               torch.zeros(3, dtype=torch.int32), k=2,
                                               block_elems=128)


# ---------------------------------------------------------------------------
# partition_blocks and sort_blocks


def test_partition_blocks_kernel_branch_matches_reference():
    """One permutation for every leaf, in place, equal to the reference."""
    rng = np.random.default_rng(4)
    nb, nblocks, be = 5, 24, 128
    bb = rng.integers(0, nb, nblocks).astype(np.int32)
    k = rng.standard_normal(nblocks * be).astype(np.float32)
    v = np.arange(nblocks * be, dtype=np.int32)
    want, want_d = ref_partition_blocks({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                        jnp.asarray(bb), nb, be)
    arrays = {"k": torch.as_tensor(k.copy()), "v": torch.as_tensor(v.copy())}
    got, d = partition_blocks(arrays, torch.as_tensor(bb), nb, be)
    assert got["k"] is arrays["k"] and got["v"] is arrays["v"]
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    for name in ("k", "v"):
        np.testing.assert_array_equal(bits(got[name].numpy()), bits(want[name]))
    np.testing.assert_array_equal(k[got["v"].numpy()], got["k"].numpy())


def test_partition_blocks_gather_branch_matches_reference():
    """A 2-D leaf sends every leaf through the gather by the stable block
    order; the inputs are left as they were."""
    rng = np.random.default_rng(4)
    nb, nblocks, be = 5, 24, 128
    bb = rng.integers(0, nb, nblocks).astype(np.int32)
    k = rng.standard_normal(nblocks * be).astype(np.float32)
    v2 = np.stack([np.arange(nblocks * be, dtype=np.int32)] * 2, axis=1)
    want, want_d = ref_partition_blocks({"k": jnp.asarray(k), "v2": jnp.asarray(v2)},
                                        jnp.asarray(bb), nb, be)
    arrays = {"k": torch.as_tensor(k.copy()), "v2": torch.as_tensor(v2.copy())}
    got, d = partition_blocks(arrays, torch.as_tensor(bb), nb, be)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    for name in ("k", "v2"):
        np.testing.assert_array_equal(bits(got[name].numpy()), bits(want[name]))
    np.testing.assert_array_equal(arrays["k"].numpy(), k)  # gathered into new tensors
    order = np.argsort(bb, kind="stable")
    np.testing.assert_array_equal(got["v2"].numpy()[::be, 0] // be, order)


@pytest.mark.parametrize("be", [100, 128])
def test_partition_blocks_unaligned_block_takes_the_gather(be):
    rng = np.random.default_rng(be)
    nb, nblocks = 3, 10
    bb = rng.integers(0, nb, nblocks).astype(np.int32)
    x = rng.standard_normal(nblocks * be).astype(np.float32)
    want, want_d = ref_partition_blocks({"x": jnp.asarray(x)}, jnp.asarray(bb), nb, be)
    got, d = partition_blocks({"x": torch.as_tensor(x.copy())}, torch.as_tensor(bb), nb, be)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(bits(got["x"].numpy()), bits(want["x"]))


def test_sort_blocks_matches_reference():
    rng = np.random.default_rng(5)
    k, N, be = 8, 48, 128
    bb = rng.integers(0, k, N).astype(np.int32)
    a = (np.repeat(bb.astype(np.float32), be) * 10
         + np.tile(np.arange(be) * 0.01, N)).astype(np.float32)
    want, want_d = ref_kernel_ops.sort_blocks(jnp.asarray(a), jnp.asarray(bb), k=k, block_elems=be)
    got, d = ops.sort_blocks(torch.as_tensor(a.copy()), torch.as_tensor(bb), k=k, block_elems=be)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    seg = np.repeat(np.arange(k), np.diff(d.numpy()))
    np.testing.assert_array_equal(np.repeat(seg, be), (got.numpy() // 10).astype(np.int64))


# ---------------------------------------------------------------------------
# s3_sort


@pytest.mark.parametrize("dist", ["Uniform", "RootDup", "Ones", "TwoDup"])
def test_s3_sort_matches_reference(dist):
    n = 80_000
    x = make_input(dist, n, np.float32, seed=23)
    x[1::1013] = -0.0  # ties with +0.0, kept in input order
    x[2::1019] = 0.0
    got = s3_sort(torch.as_tensor(x))
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref_s3_sort(jnp.asarray(x))))


def test_s3_sort_payload_matches_reference():
    n = 40_000
    x = make_input("TwoDup", n, np.float32, seed=29)
    v = np.arange(n, dtype=np.int32)
    ks, vs = s3_sort(torch.as_tensor(x), torch.as_tensor(v))
    rk, rv = ref_s3_sort(jnp.asarray(x), jnp.asarray(v))
    np.testing.assert_array_equal(bits(ks.numpy()), bits(rk))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(rv))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n", [0, 1, 5000, 30_000])
def test_s3_sort_small_and_int(dtype, n):
    x = make_input("Exponential", n, dtype, seed=31)
    got = s3_sort(torch.as_tensor(x), torch.arange(n))
    want = torch.sort(torch.as_tensor(x), stable=True)
    assert torch.equal(got[0], want.values) and torch.equal(got[1], want.indices)
    if n > 1:
        np.testing.assert_array_equal(bits(got[0].numpy()), bits(ref_s3_sort(jnp.asarray(x))))


def test_s3_sort_nan_last_and_infinities():
    """NaN last and +inf before it, as torch.sort(stable=True) orders raw
    floats (the reference's classification breaks this order: ROADMAP.md
    queue 3)."""
    x = make_input("Uniform", 50_000, np.float32, seed=2)
    x[::1009] = np.nan
    x[1::1013] = -0.0
    x[2::1019] = 0.0
    x[5::777] = np.inf
    x[6::771] = np.finfo(np.float32).max
    x[7::773] = -np.inf
    ks, idx = s3_sort(torch.as_tensor(x), torch.arange(x.shape[0]))
    want = torch.sort(torch.as_tensor(x), stable=True)
    assert torch.equal(ks.view(torch.int32), want.values.view(torch.int32))
    assert torch.equal(idx, want.indices)


def test_block_doctests():
    result = doctest.testmod(block_permute, verbose=False)
    assert result.failed == 0 and result.attempted > 0
