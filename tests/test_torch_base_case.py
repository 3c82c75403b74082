"""Parity of the port's base case (K3's plain twin and the overlapped
window passes) with the reference, on the CPU.

The port's window sort is stable: it orders by (bucket, key, idx).  It is
held, idx included, to the stable oracles ``bitonic_sort_windows_ref`` and
``_window_perm`` on duplicate-heavy windows; the reference's Pallas
``bitonic_sort_windows`` is not stable on ties, so it is compared only on
tie-free windows.  Tolerance: exact equality (integer outputs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ips4o as ref_ips4o
from repro.kernels.bitonic import bitonic_sort_windows
from repro.kernels.ref import bitonic_sort_windows_ref
from repro_torch.core import ips4o
from repro_torch.kernels import fallback
from repro_torch.kernels.bitonic import sort_windows
from repro_torch.kernels.ops import base_case_windows
from torch_one_thread import one_torch_thread  # noqa: F401


def _dup_windows(num_w, W, seed, buckets=9, keys=7):
    rng = np.random.default_rng(seed)
    b = np.sort(rng.integers(0, buckets, (num_w, W)), axis=1).astype(np.int32)
    k = rng.integers(-keys, keys, (num_w, W)).astype(np.int32)
    return b, k


@pytest.mark.parametrize("W", [128, 1024, 8192])
@pytest.mark.parametrize("num_w", [1, 3])
def test_window_sort_stable_matches_oracles(W, num_w):
    b, k = _dup_windows(num_w, W, W + num_w)
    idx = np.tile(np.arange(W, dtype=np.int32), (num_w, 1))
    perm, b_sorted = sort_windows(torch.as_tensor(b), torch.as_tensor(k), nb=9)
    want_b, want_k, want_idx = bitonic_sort_windows_ref(
        jnp.asarray(b), jnp.asarray(k), jnp.asarray(idx)
    )
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(b_sorted.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(np.take_along_axis(k, perm.numpy(), 1), np.asarray(want_k))
    np.testing.assert_array_equal(
        ips4o._window_perm(torch.as_tensor(k), torch.as_tensor(b)).numpy(),
        np.asarray(ref_ips4o._window_perm(jnp.asarray(k), jnp.asarray(b))),
    )


@pytest.mark.parametrize("W", [256, 2048])
def test_window_sort_matches_pallas_on_tie_free_windows(W):
    rng = np.random.default_rng(W)
    num_w = 2
    b = np.sort(rng.integers(0, 5, (num_w, W)), axis=1).astype(np.int32)
    k = np.stack([rng.permutation(W) for _ in range(num_w)]).astype(np.int32) - W // 2
    idx = np.tile(np.arange(W, dtype=np.int32), (num_w, 1))
    want_b, _, want_idx = bitonic_sort_windows(
        jnp.asarray(b), jnp.asarray(k), jnp.asarray(idx), interpret=True
    )
    perm, b_sorted = sort_windows(torch.as_tensor(b), torch.as_tensor(k), nb=5)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(b_sorted.numpy(), np.asarray(want_b))


def _bucketed(n, W, seed, max_bucket):
    """Keys partitioned into buckets of at most ``max_bucket`` (bucket ids
    nondecreasing, bucket ranges in key order, odd ids equality buckets of
    one key), as after the level passes."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.integers(1, max_bucket + 1)))
    sizes[-1] -= sum(sizes) - n
    fb = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    spread = np.where(fb % 2 == 0, rng.integers(0, 16, n), 0)
    keys = (fb.astype(np.int64) * 64 + spread).astype(np.int32)
    return fb, keys, len(sizes)


@pytest.mark.parametrize("W,n", [(256, 2048), (1024, 8192), (8192, 16384)])
def test_base_case_matches_reference(W, n):
    fb, keys, nb = _bucketed(n, W, W, W // 2)
    vals = np.arange(n, dtype=np.int32)
    want = ref_ips4o.base_case(
        {"k": jnp.asarray(keys), "v": jnp.asarray(vals)}, jnp.asarray(fb), W
    )
    arrays = {"k": torch.as_tensor(keys), "v": torch.as_tensor(vals)}
    got = ips4o.base_case(arrays, torch.as_tensor(fb), W, nb)
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))
    np.testing.assert_array_equal(got["v"].numpy(), np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(arrays["k"].numpy(), keys)  # inputs untouched


def test_base_case_windows_moves_wide_payloads():
    W, n = 128, 1024
    fb, keys, nb = _bucketed(n, W, 3, W // 2)
    payload = torch.arange(2 * n, dtype=torch.float32).reshape(n, 2)
    out = base_case_windows({"k": torch.as_tensor(keys), "p": payload},
                            torch.as_tensor(fb), W, nb)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(out["p"].numpy(), payload.numpy()[order])


@pytest.mark.parametrize("rows,limit", [(1, None), (1, 512), (3, None), (3, 256)])
def test_base_case_windows_above_k3_bucket_field(rows, limit):
    """With more buckets than K3's bucket field holds (2^25 at W = 128), K3
    is handed each window's run index instead of the bucket id: the same
    order, so the same output as with the ids themselves, for one row or B
    rows, over all of each row or a prefix of it."""
    W, n = 128, 1024
    cases = [_bucketed(n, W, seed, W // 2) for seed in range(rows)]
    fb = torch.as_tensor(np.stack([c[0] for c in cases]))
    keys = torch.as_tensor(np.stack([c[1] for c in cases]))
    nb = max(c[2] for c in cases)
    arrays = {"k": keys, "v": torch.arange(rows * n, dtype=torch.int32).reshape(rows, n)}
    if rows == 1:
        fb, arrays = fb[0], {name: a[0] for name, a in arrays.items()}
    want = base_case_windows(arrays, fb, W, nb, limit)
    spread = 1 << 21  # the same order, ids beyond 2^25
    big = base_case_windows(arrays, fb * spread, W, spread * nb, limit)
    assert spread * nb > 1 << 25
    for name in arrays:
        assert torch.equal(big[name], want[name])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oversized_buckets_are_sorted_before_the_windows(seed):
    """The port's robustness fallback: buckets above W/2 are stably sorted in
    place, then the window passes finish the rest; the result is the full
    stable sort, as the reference's fallback gives."""
    W, n = 256, 4096
    fb, keys, nb = _bucketed(n, W, seed, 3 * W)  # many buckets exceed W/2
    offsets = torch.as_tensor(
        np.concatenate([[0], np.cumsum(np.bincount(fb, minlength=nb))]).astype(np.int32))
    fb_t = torch.as_tensor(fb)
    assert bool(ips4o.bucket_violations(offsets, nb, W))
    arrays = {"k": torch.tensor(keys), "v": torch.arange(n, dtype=torch.int32)}
    arrays = fallback.sort_oversized_plain(arrays, fb_t, offsets, nb, W, None)
    out = ips4o.base_case(arrays, fb_t, W, nb)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(out["v"].numpy(), order)
    np.testing.assert_array_equal(out["k"].numpy(), keys[order])


def test_sort_windows_validates_its_inputs():
    b = torch.zeros((2, 8192), dtype=torch.int32)
    with pytest.raises(ValueError, match="bits"):
        sort_windows(b, b, nb=1 << 20)
    with pytest.raises(ValueError, match="power of two"):
        sort_windows(b[:, :100].contiguous(), b[:, :100].contiguous(), nb=4)
    with pytest.raises(ValueError, match="int32"):
        sort_windows(b.to(torch.int64), b, nb=4)
