"""Parity of the glue kernels' plain twins (``repro_torch.kernels.glue``,
G1-G4) with the reference's XLA code, on the CPU.

On a card these functions launch the kernels of ``csrc/glue.cu``; here they
run their plain twins, which the card holds the kernels to bit for bit
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Each twin is held here,
bit for bit, to the function the reference runs in XLA:

- G1 ``close_placement``: the reference's ``_close_placement`` (one row,
  and per row of B);
- G2 ``segment_ids``: ``repro.core.ips4o.segment_ids`` and
  ``batched_segment_ids``, with empty, leading and trailing empty buckets,
  one bucket and B > 1;
- G3 ``composite_ids``: ``seg * 2k + classify_segmented(...)`` and the
  radix ids, with k in {2, 4, 16, 128}, keys equal to splitters and to the
  sentinel, 1 to 300 segments and an empty last segment;
- G4: the scatter against ``.at[dest].set`` with payload rows of 1, 2, 4,
  8 and 12 bytes (one row and B rows), and the window gathers through the
  base case with ``limit`` against the reference's ``base_case``.

Tolerance: exact equality (integer ids and moved bits).  The int64 forms
run in the x64 child of ``tests/test_torch_dtypes.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.classify.radix import radix_bucket_ids as ref_radix_bucket_ids
from repro.classify.tree import classify_segmented as ref_classify_segmented
from repro.core import ips4o as ref_ips4o
from repro.kernels.level_fused import _close_placement as ref_close_placement
from repro_torch.core import ips4o
from repro_torch.kernels import glue
from torch_one_thread import one_torch_thread  # noqa: F401

SIGN = np.uint32(0x80000000)
INT_MAX = np.iinfo(np.int32).max


def to_port(u):
    """Reference uint32 codes -> the port's signed int32 codes."""
    return torch.as_tensor((np.asarray(u, np.uint32) ^ SIGN).view(np.int32).copy())


def _offsets(rng, n, nb, case):
    """(nb+1,) nondecreasing int32 offsets from 0 to n shaped by ``case``."""
    cuts = np.sort(rng.integers(0, n + 1, nb - 1))
    if case == "empty buckets":
        cuts[1::3] = cuts[0::3][: len(cuts[1::3])]
    elif case == "leading empty":
        cuts[: nb // 3] = 0
    elif case == "trailing empty":
        cuts[-(nb // 3):] = n
    elif case == "one bucket":
        cuts = cuts[:0]
    return np.concatenate([[0], cuts, [n]]).astype(np.int32)


SEGMENT_CASES = [("random", 17), ("empty buckets", 40), ("leading empty", 30),
                 ("trailing empty", 30), ("one bucket", 1)]


@pytest.mark.parametrize("case,nb", SEGMENT_CASES)
def test_segment_ids_match_the_reference(case, nb):
    rng = np.random.default_rng(nb)
    n = 3000
    off = _offsets(rng, n, nb, case)
    want = np.asarray(ref_ips4o.segment_ids(jnp.asarray(off), n))
    got = ips4o.segment_ids(torch.as_tensor(off), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(glue.segment_ids_plain(torch.as_tensor(off), n).numpy(), want)


def test_batched_segment_ids_match_the_reference():
    rng = np.random.default_rng(5)
    n, nb = 2000, 12
    off = np.stack([_offsets(rng, n, nb, case) for case in
                    ("random", "empty buckets", "leading empty", "trailing empty")])
    want = np.asarray(ref_ips4o.batched_segment_ids(jnp.asarray(off), n))
    got = ips4o.batched_segment_ids(torch.as_tensor(off), n)
    np.testing.assert_array_equal(got.numpy(), want)


def _segmented_case(rng, n, num_seg, k):
    """Reference codes, segment offsets with an empty last segment, sorted
    per-segment splitters, keys equal to splitters and to the sentinel."""
    off = _offsets(rng, n, num_seg, "random")
    if num_seg > 1:
        off[-2] = n  # the last segment is empty
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[::5] = u[0]
    spl = np.sort(rng.choice(u, (num_seg, k - 1)).astype(np.uint32), axis=1)
    flat = spl.reshape(-1)
    u[1::7] = flat[np.arange(len(u[1::7])) % flat.size]  # keys on the splitters
    u[2::11] = np.uint32(0xFFFFFFFF)  # the sentinel
    return u, off, spl


@pytest.mark.parametrize("k,num_seg", [(2, 1), (4, 300), (16, 7), (128, 33)])
def test_composite_ids_match_the_reference(k, num_seg):
    rng = np.random.default_rng(k * 1000 + num_seg)
    n = 4000
    u, off, spl = _segmented_case(rng, n, num_seg, k)
    seg = np.asarray(ref_ips4o.segment_ids(jnp.asarray(off), n))
    local = np.asarray(ref_classify_segmented(jnp.asarray(u), jnp.asarray(seg),
                                              jnp.asarray(spl), k))
    want = seg * (2 * k) + local
    got = glue.composite_ids(to_port(u)[None], torch.as_tensor(off)[None], num_seg, k,
                             to_port(spl)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("k,consumed", [(2, 0), (16, 3), (128, 0), (128, 7)])
def test_radix_composite_ids_match_the_reference(k, consumed):
    rng = np.random.default_rng(k + consumed)
    n, num_seg = 3000, 9
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[::13] = np.uint32(0xFFFFFFFF)
    off = _offsets(rng, n, num_seg, "empty buckets")
    seg = np.asarray(ref_ips4o.segment_ids(jnp.asarray(off), n))
    want = seg * (2 * k) + np.asarray(ref_radix_bucket_ids(jnp.asarray(u), k, consumed))
    got = glue.composite_ids(to_port(u)[None], torch.as_tensor(off)[None], num_seg, k, None,
                             consumed)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_batched_composite_ids_per_row_match_the_reference():
    """(B, n) keys with given per-row splitters: each row's ids are the
    reference's for that row alone (row-local segments)."""
    rng = np.random.default_rng(11)
    B, n, num_seg, k = 3, 1500, 6, 8
    cases = [_segmented_case(rng, n, num_seg, k) for _ in range(B)]
    keys = torch.stack([to_port(c[0]) for c in cases])
    off = torch.as_tensor(np.stack([c[1] for c in cases]))
    spl = torch.stack([to_port(c[2]) for c in cases])
    got = ips4o.batched_composite_ids(keys, off, num_seg, n, k, torch.Generator(),
                                      splitters=spl)
    for r, (u, o, s) in enumerate(cases):
        seg = np.asarray(ref_ips4o.segment_ids(jnp.asarray(o), n))
        want = seg * (2 * k) + np.asarray(ref_classify_segmented(
            jnp.asarray(u), jnp.asarray(seg), jnp.asarray(s), k))
        np.testing.assert_array_equal(got[r].numpy(), want)


def _leaf(kind, shape, rng):
    """A payload leaf of ``kind`` bytes a row (numpy, and its torch twin)."""
    if kind == 1:
        x = rng.random(shape) < 0.5
    elif kind == 2:
        x = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        return x, torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    elif kind == 4:
        x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    elif kind == 8:
        x = rng.integers(-2**31, 2**31, shape + (2,), dtype=np.int64).astype(np.int32)
    else:  # 12
        x = rng.standard_normal(shape + (3,)).astype(np.float32)
    return x, torch.from_numpy(x.copy())


@pytest.mark.parametrize("kind", [1, 2, 4, 8, 12])
def test_scatter_matches_the_reference(kind):
    """One row and B rows (row-local destinations), against ``.at[dest].set``
    as the reference's level passes scatter."""
    rng = np.random.default_rng(kind)
    n = 2500
    for lead in ((n,), (3, n)):
        x, t = _leaf(kind, lead, rng)
        dest = np.argsort(rng.random(lead), axis=-1).astype(np.int32)
        got = ips4o._scatter({"v": t}, torch.as_tensor(dest))["v"]
        if len(lead) == 1:
            want = jnp.zeros_like(x).at[dest].set(jnp.asarray(x))
        else:
            want = jax.vmap(lambda a, d: jnp.zeros_like(a).at[d].set(a))(jnp.asarray(x),
                                                                          jnp.asarray(dest))
        want = np.asarray(want)
        if kind == 2:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def _bucketed_rows(rng, B, n, W):
    """Nondecreasing bucket ids (no bucket above W/2 among the even ones)
    and keys, one row per B."""
    fb = np.zeros((B, n), np.int32)
    for r in range(B):
        cuts = np.sort(rng.choice(np.arange(1, n), n // (W // 4), replace=False))
        fb[r] = np.searchsorted(cuts, np.arange(n), side="right")
    u = rng.integers(0, 50, (B, n), dtype=np.uint64).astype(np.uint32)
    return fb, u


@pytest.mark.parametrize("B,limit", [(1, 1024), (1, None), (2, 512)])
def test_base_case_with_limit_matches_the_reference(B, limit):
    """The window gathers (the G4 gather in place for pass two) through the
    base case over a prefix of each row, payload rows of 3 bytes and the
    row index, against the reference's base case."""
    rng = np.random.default_rng(B + (limit or 0))
    n, W = 2048, 128
    fb, u = _bucketed_rows(rng, B, n, W)
    pay = rng.integers(0, 255, (B, n, 3)).astype(np.uint8)
    idx = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    nb = int(fb.max()) + 1
    arrays = {"k": to_port(u.reshape(-1)).reshape(B, n), "p": torch.from_numpy(pay.copy()),
              "i": torch.from_numpy(idx.copy())}
    ref_arrays = {"k": jnp.asarray(u), "p": jnp.asarray(pay), "i": jnp.asarray(idx)}
    if B == 1:
        got = ips4o.base_case({k_: a[0] for k_, a in arrays.items()}, torch.as_tensor(fb[0]), W,
                              nb, limit)
        want = ref_ips4o.base_case({k_: a[0] for k_, a in ref_arrays.items()},
                                   jnp.asarray(fb[0]), W, limit)
        got = {k_: a[None] for k_, a in got.items()}
        want = {k_: np.asarray(a)[None] for k_, a in want.items()}
    else:
        got = ips4o.batched_base_case(arrays, torch.as_tensor(fb), W, nb, limit)
        want = {k_: np.asarray(a) for k_, a in ref_ips4o.batched_base_case(
            ref_arrays, jnp.asarray(fb), W, limit).items()}
    np.testing.assert_array_equal(got["k"].numpy().view(np.uint32) ^ SIGN, want["k"])
    np.testing.assert_array_equal(got["p"].numpy(), want["p"])
    np.testing.assert_array_equal(got["i"].numpy(), want["i"])


@pytest.mark.parametrize("B,tile", [(1, 256), (3, 100)])
def test_close_placement_matches_the_reference(B, tile):
    """G1's twin against the reference's XLA epilogue, per row, on tile
    histograms with empty buckets and a ragged last tile."""
    rng = np.random.default_rng(tile)
    n, nb = 1000, 9
    bucket = rng.integers(0, nb, (B, n)).astype(np.int32)
    bucket[:, 100:300] = 4
    tiles = -(-n // tile)
    rank = np.zeros((B, n), np.int32)
    hist = np.zeros((B, tiles, nb), np.int32)
    for r in range(B):
        for t in range(tiles):
            seg = bucket[r, t * tile:(t + 1) * tile]
            for b in range(nb):
                sel = np.nonzero(seg == b)[0]
                rank[r, t * tile + sel] = np.arange(len(sel))
                hist[r, t, b] = len(sel)
    dest, off = glue.close_placement(torch.as_tensor(bucket), torch.as_tensor(rank),
                                     torch.as_tensor(hist), nb, tile)
    for r in range(B):
        want_dest, want_off = ref_close_placement(jnp.asarray(bucket[r]), jnp.asarray(rank[r]),
                                                  jnp.asarray(hist[r]), nb, tile)
        np.testing.assert_array_equal(dest[r].numpy(), np.asarray(want_dest))
        np.testing.assert_array_equal(off[r].numpy(), np.asarray(want_off))
