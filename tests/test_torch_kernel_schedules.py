"""The arithmetic of seven of the port's CUDA kernels, replayed on the CPU
and held to the reference's oracles.

The kernels run only on a card; their plain twins compute the same
functions by other means.  These tests replay what the kernels do step for
step, so that their schedules are checked where there is no card:

- K3 ``sort_windows`` (``csrc/bitonic.cu``): the 64-bit words (bucket, key
  with its sign bit flipped, window index), the bitonic stages run e index
  bits at a time in registers, the window re-mapped through the padded
  shared buffer between chunks (an exchange whose words stay within a warp
  under a warp barrier), each thread's sort direction one flag a stage.
  The replay is held to the reference's stable oracle
  ``bitonic_sort_windows_ref`` bit for bit; every layout's padded slots
  are checked to be a bijection that puts the 16 threads of a half-warp on
  16 distinct 8-byte bank pairs.  Its 64-bit form (64-bit keys): each
  element 12 B in two words compared as (bucket, key, idx) -- the key and
  (bucket << log2 W | idx) up to W = 8192, the 96-bit number as a high and
  a low word at 16384 -- at E = 8 (16 from W = 8192), held to the same
  oracle on the keys' dense ranks (the order is all the oracle sees).
- K11 ``flash_attention`` in float32 (``csrc/flash_attention.cu``): every
  operand split into big = tf32(x) and small = tf32(x - big) (round to
  nearest, ties away: ``cvt.rna.tf32.f32``), each product taken as small x
  big + big x small + big x big in f32, held to the reference's oracle
  ``flash_attention_ref`` within the float32 limit 2e-5 + 2e-5 |want|,
  which one TF32 product alone misses.
- K1 ``level_fused`` (``csrc/level_fused.cu``): one warp per 512 positions
  of a tile, the splitters in Eytzinger order and each key's bucket found
  by the branchless descent j = 2j + (key > tree[j]), eq against the
  uppers, pads routed to 2k, the ranks taken chunk by chunk in each warp's
  span (the lanes holding the same id, OR-ed into a mask per id, the
  warp's counter) and offset by
  the exclusive scan over the warps.  Held bit for bit to the reference's
  ``_classify_tile`` and ``_rank_and_hist`` per tile, and through the
  placement to its ``level_fused`` in interpret mode.  Its 64-bit form (a
  warp per 256 positions, K1r's digit taken from the 64-bit code at a
  shift in [0, 64), the sentinel LLONG_MAX) is held to the reference's
  uint64 classification in a child process with jax's x64 mode.
- K5 ``merge_path_perm`` (``csrc/merge_path.cu``): a persistent grid of
  CTAs, each a contiguous run of steps; a CTA's first cut by a warp search
  in device memory (32 probes a step, the first steps on multiples of the
  step), every later cut by a warp search in the stage of the next T keys
  of both runs; the stage's 16-byte bulk copies from the rounded-down
  starts (at every alignment of the runs), each thread's sub-diagonal
  search and serial merge of its outputs, and the padded transpose (a
  bijection with no bank conflict on the write and on the 16-byte read).
  The cuts are held to the reference's ``merge_path_partition`` and the
  permutation to ``merge_path_perm_ref``, bit for bit.
- K2 ``rank_hist`` and K4 ``rank_hist_batched`` (``csrc/level_fused.cu``):
  the items kernel's binary search, the count, the per-segment scan and
  the rank, against the reference's ``rank_hist``/``rank_hist_batched`` and
  the plain twins.
- K6 ``dispatch_ranks``, ``partition_ranks`` and
  ``partition_ranks_batched`` (``csrc/dispatch_rank.cu``): persistent CTAs
  taking tiles by ticket, each tile's ranks by K1's peer masks and
  per-warp counters, its count published as a 32-bit status word, and the
  look-back (deferred by one tile, the whole CTA reading 8 words a thread
  a round) under seeded interleavings of the CTAs, so that tiles publish
  in shuffled orders.  Held bit for bit to the reference's three Pallas
  kernels in interpret mode and to the plain twins; the status word is
  shown to keep counts past 2^30.
- K7 ``classify_histogram``, ``classify_histogram_batched`` and
  ``radix_histogram`` (``csrc/classify.cu``): CTAs over runs of whole
  tiles of one row, each warp its own steps of 16-byte loads, the shuffle
  transpose of 8- and 16-bit pieces (so that id stores are 16 bytes,
  consecutive lanes on consecutive pieces), the splitters in a padded
  Eytzinger tree per compare type (the max for the ints, NaN for the
  floats), descents of 8 keys interleaved with eq against the uppers, the
  8-bit id table, the exact division by the tile and a shared atomic a
  key.  Held bit for bit to the reference's Pallas kernels in interpret
  mode for all twelve key kinds at k = 1 .. 256 (the 64-bit kinds in an x64
  child), batched and in radix mode; the walk is shown to take every tile
  and key once, and the shared bytes to fit a CTA.
- The sort's glue G1-G4 (``csrc/glue.cu``) and G6 and G7: G6's positions
  from the drawn uniforms in float32 and its bitonic network over the
  padded sample, against the plain twin and the reference's
  ``select_splitters``; G7's list, its chunks sorted by (key, position),
  its merge rounds (each tile's two cuts by the warp's 32 probes a step,
  each thread's search and serial merge) and its move through the 4-byte
  scratch, on crafted offsets (one bucket a whole row; buckets of W/2+1,
  C-1, C, C+1 and 3C+5 keys; equal keys; rows of other counts; ``limit``;
  int32 and int64 codes), against the reference's ``stable_full_sort`` of
  each listed bucket and the plain twin.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.classify.radix import radix_bucket_ids as ref_radix_bucket_ids
from repro.kernels import classify as ref_classify
from repro.kernels.level_fused import _classify_tile as ref_classify_tile
from repro.kernels.level_fused import _rank_and_hist as ref_rank_and_hist
from repro.kernels.level_fused import level_fused as ref_level_fused
from repro.kernels.level_fused import rank_hist as ref_rank_hist
from repro.kernels.level_fused import rank_hist_batched as ref_rank_hist_batched
from repro.kernels.merge_path import merge_path_partition as ref_merge_path_partition
from repro.kernels.ref import bitonic_sort_windows_ref, merge_path_perm_ref
from repro.kernels.ref import flash_attention_ref as ref_attention_oracle
from repro.ops.keyspace import encode_np
from repro_torch.classify import radix_shift
from repro_torch.kernels import classify
from repro_torch.kernels.glue import close_placement
from repro_torch.kernels.level_fused import MAX_NB, MAX_TILE, _items
from repro_torch.kernels.level_fused import rank_hist_batched_plain, rank_hist_plain
from repro_torch.kernels.level_fused import segment_schedule
from torch_children import Child
from torch_one_thread import one_torch_thread  # noqa: F401

# ---- K3 -------------------------------------------------------------------


def _layout(T: int, log_e: int, b: int) -> np.ndarray:
    """(T, E) window index of thread t's register r in the layout of base b:
    t's low b bits, then r, then t's other bits."""
    t = np.arange(T)[:, None]
    r = np.arange(1 << log_e)[None, :]
    return (t & ((1 << b) - 1)) | (r << b) | ((t >> b) << (b + log_e))


def _check_slots(idx: np.ndarray, log_e: int, W: int, banks: bool = True) -> None:
    """The padded slots idx + idx >> log_e: distinct, below W + T, and
    (``banks``) within each half-warp of one register on 16 distinct bank
    pairs."""
    slots = idx + (idx >> log_e)
    T = idx.shape[0]
    assert len(np.unique(slots)) == W and slots.max() < W + T
    if banks and T >= 16:
        pairs = (slots % 16).reshape(T // 16, 16, -1)
        assert all(len(np.unique(pairs[h, :, r])) == 16
                   for h in range(T // 16) for r in range(pairs.shape[2]))


def _exchange(x: np.ndarray, r0: int, r1: int, up) -> None:
    """Registers r0 < r1 of every thread in order: ascending where ``up``
    (a bool or one per thread)."""
    a, c = x[:, r0].copy(), x[:, r1].copy()
    lo, hi = np.minimum(a, c), np.maximum(a, c)
    x[:, r0], x[:, r1] = np.where(up, lo, hi), np.where(up, hi, lo)


def _exchange_by(x: np.ndarray, r0: int, r1: int, up, gt) -> None:
    """``_exchange`` by the comparison ``gt`` over the elements' ids: swap
    where gt(r0, r1) == up, as the kernel's templated compare-exchange."""
    a, c = x[:, r0].copy(), x[:, r1].copy()
    swap = gt(a, c) == up
    x[:, r0], x[:, r1] = np.where(swap, c, a), np.where(swap, a, c)


def _replay_k3(words: np.ndarray, log_e: int, gt=None) -> np.ndarray:
    """K3's network over one window of uint64 words, as the kernel runs it;
    with ``gt``, over element ids compared by ``gt`` (the 64-bit form)."""
    if gt is None:
        exchange = _exchange
    else:
        def exchange(x, r0, r1, up):
            _exchange_by(x, r0, r1, up, gt)
    W = words.shape[0]
    L = W.bit_length() - 1
    E = 1 << log_e
    T = W // E
    t = np.arange(T)
    x = words[_layout(T, log_e, 0)].copy()
    for s in range(log_e):  # in registers; index bit s+1 is r's, then t's bit 0
        for j in range(s, -1, -1):
            for r in range(E):
                if not r & (1 << j):
                    up = (t & 1) == 0 if s + 1 == log_e else not (r >> (s + 1)) & 1
                    exchange(x, r, r | 1 << j, up)
    b_cur = 0
    for s in range(log_e, L):
        up = ((t >> (s + 1 - log_e)) & 1) == 0  # index bit s+1: t's bit s+1-e
        k_top = s // log_e
        for k in range(k_top, -1, -1):
            b = s - log_e + 1 if k == k_top else k * log_e
            window = np.empty(W, words.dtype)  # the exchange through shared memory
            src, dst = _layout(T, log_e, b_cur), _layout(T, log_e, b)
            _check_slots(dst, log_e, W, banks=gt is None)
            if max(b_cur, b) <= 5:  # the kernel's warp barrier: words stay in a warp
                owner = np.empty(W, np.int64)
                owner[src] = np.arange(T)[:, None]
                assert (owner[dst] // 32 == np.arange(T)[:, None] // 32).all()
            window[src] = x
            x = window[dst]
            b_cur = b
            for lj in range(log_e - 1, (k * log_e - b if k == k_top else 0) - 1, -1):
                for r in range(E):
                    if not r & (1 << lj):
                        exchange(x, r, r | 1 << lj, up)
    out = np.empty(W, words.dtype)
    out[_layout(T, log_e, 0)] = x
    return out


@pytest.mark.parametrize("W,log_e", [(16, 4), (32, 4), (256, 4), (1024, 4), (8192, 4),
                                     (16384, 5), (8, 3), (2, 1)])
def test_k3_register_schedule_matches_the_reference(W, log_e):
    """The replayed network sorts (bucket, key, idx) words into the stable
    (bucket, key) order of the reference's oracle, bit for bit, with bucket
    ids in any order and heavy duplicates."""
    rng = np.random.default_rng(W)
    num_w = 2
    L = W.bit_length() - 1
    b = rng.integers(0, 9, (num_w, W)).astype(np.int32)
    k = rng.integers(-3, 4, (num_w, W)).astype(np.int32)
    k[0, : W // 2] = np.iinfo(np.int32).min  # the key field's extremes
    k[0, W // 2:] = np.iinfo(np.int32).max
    idx = np.tile(np.arange(W, dtype=np.int32), (num_w, 1))
    want_b, _, want_idx = bitonic_sort_windows_ref(jnp.asarray(b), jnp.asarray(k),
                                                   jnp.asarray(idx))
    for w in range(num_w):
        words = ((b[w].astype(np.uint64) << np.uint64(32 + L))
                 | ((k[w].view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
                    << np.uint64(L))
                 | np.arange(W, dtype=np.uint64))
        out = _replay_k3(words, log_e)
        np.testing.assert_array_equal((out & np.uint64(W - 1)).astype(np.int32),
                                      np.asarray(want_idx[w]))
        np.testing.assert_array_equal((out >> np.uint64(32 + L)).astype(np.int32),
                                      np.asarray(want_b[w]))


def _odd_even_network(n: int) -> list:
    """Batcher's odd-even merge sort on n = 2^m inputs as (a, b) pairs, a < b,
    in the order of ``network_sort``'s unrolled loops: step (2^lp, 2^lk)
    pairs a with a + 2^lk."""
    pairs = []
    lp = 0
    while 1 << lp < n:
        for lk in range(lp, -1, -1):
            p, k = 1 << lp, 1 << lk
            j0 = k % p
            pairs += [(a, a + k) for a in range(n - k)
                      if a >= j0 and (a - j0) & (2 * k - 1) < k
                      and a // (2 * p) == (a + k) // (2 * p)]
        lp += 1
    return pairs


def _k3_merge_log_e(L: int) -> int:
    """log2 E of the 64-bit form's merge sort at W = 2^L (``merge_config``
    in csrc/bitonic.cu): E = 8 up to W = 128, 16 up to 1024, then 32."""
    return 3 if L <= 7 else 4 if L <= 10 else 5


def _replay_k3_merge(W: int, gt) -> np.ndarray:
    """K3's 64-bit form over one window, as the kernel runs it: the window's
    element ids in their sorted order, the elements compared by ``gt`` over
    ids.  W <= 8: one thread's bitonic network (``sort_small_windows_kernel``).
    From W = 16: E elements a thread (its E consecutive positions at E = 8,
    positions t + T r from E = 16) sorted by the odd-even network in
    registers, then log2(W / E) merge rounds through the padded window,
    each thread finding its diagonal on its pair of runs by a binary search
    and merging its E outputs serially, taking the right run's head only
    when it is the smaller; from E = 16 the outputs go back through the
    window and out at positions t + T r.  Checks that every slot the merge
    uses was written in its round, and that the writes and the striped
    reads of the high words fall on distinct bank pairs."""
    L = W.bit_length() - 1
    if W <= 8:
        return _replay_k3(np.arange(W, dtype=np.int64), L, gt)
    log_e = _k3_merge_log_e(L)
    E = 1 << log_e
    T = W // E
    t = np.arange(T)
    layout = _layout(T, log_e, 0)  # thread t's register r: position t * E + r
    _check_slots(layout, log_e, W)
    striped = (t[:, None] + T * np.arange(E)[None, :]) if log_e >= 4 else layout
    x = striped.astype(np.int64).copy()  # the element ids it loads
    for i, j in _odd_even_network(E):
        _exchange_by(x, i, j, True, gt)

    def padded(i):
        return i + (i >> log_e)

    for k in range(T.bit_length() - 1):
        window = np.full(W + T + 1, -1, np.int64)  # -1: a slot not written
        window[padded(layout)] = x
        R = E << k
        a0 = (t & ~((2 << k) - 1)) * E
        d = t * E - a0
        lo, hi = np.maximum(0, d - R), np.minimum(d, R)
        while (lo < hi).any():
            live = lo < hi
            mid = (lo + hi) >> 1
            av = window[padded(a0 + mid)]
            bv = window[padded(a0 + R + d - 1 - mid)]
            assert (av[live] >= 0).all() and (bv[live] >= 0).all()
            g = gt(av, bv)
            hi = np.where(live & g, mid, hi)
            lo = np.where(live & ~g, mid + 1, lo)
        ia, ib = a0 + lo, a0 + R + d - lo
        a_end, b_end = a0 + R, a0 + 2 * R
        av, bv = window[padded(ia)], window[padded(ib)]
        for r in range(E):
            a_in, b_in = ia < a_end, ib < b_end
            assert (a_in | b_in).all()  # both runs are never spent
            assert (av[a_in] >= 0).all() and (bv[b_in] >= 0).all()
            take_b = b_in & (~a_in | gt(np.where(a_in, av, 0), np.where(b_in, bv, 0)))
            x[:, r] = np.where(take_b, bv, av)
            ia, ib = ia + ~take_b, ib + take_b
            nv = window[padded(np.where(take_b, ib, ia))]
            av, bv = np.where(take_b, av, nv), np.where(take_b, nv, bv)
    out = np.empty(W, np.int64)
    out[layout] = x
    if log_e >= 4:  # the striped store's reads: a half-warp's high words on
        # distinct bank pairs (16 consecutive positions lie in one run of E)
        slots = padded(striped)
        assert len(np.unique(slots)) == W
        if T >= 16:
            lanes = slots.reshape(T // 16, 16, E)
            assert all(len(np.unique(lanes[g, :, r] % 16)) == 16
                       for g in range(T // 16) for r in range(E))
    return out


def _k3_merge_input(case: str, W: int, rng):
    """(bucket, key) of one window: heavy duplicates over the int64 range
    with its extremes, the full range, all equal, descending, and equal
    elements that span the runs of every merge round."""
    b = rng.integers(0, 9, W).astype(np.int32)  # any order
    if case == "full range":
        key = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, W,
                           dtype=np.int64, endpoint=True)
    elif case == "all equal":
        b, key = np.full(W, 5, np.int32), np.full(W, -5, np.int64)
    elif case == "descending":
        b = np.sort(b)[::-1].copy()
        key = np.sort(rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, W,
                                   dtype=np.int64))[::-1].copy()
        key[W // 2:] = key[W // 2]  # and a run of equals
    elif case == "ties across runs":  # a left run's tail equal to its right run's head
        b = np.zeros(W, np.int32)
        key = (np.arange(W, dtype=np.int64) % 4) - 2
        key[(np.arange(W) // 8) % 2 == 1] = -2
    else:  # duplicates
        key = rng.integers(-3, 4, W).astype(np.int64)
        key[: W // 4] += np.iinfo(np.int64).max - 3  # above every 32-bit value
        key[W // 4: W // 2] = np.iinfo(np.int64).min + (key[W // 4: W // 2] + 3)
    return b, key


@pytest.mark.parametrize("case", ["duplicates", "full range", "all equal", "descending",
                                  "ties across runs"])
@pytest.mark.parametrize("W", [2, 8, 16, 128, 256, 1024, 4096, 8192, 16384])
def test_k3_64bit_merge_schedule_matches_the_reference(W, case):
    """The 64-bit form (``merge_sort_windows_kernel``; one thread a window up
    to W = 8): each element the 96-bit number (bucket, key ^ sign bit, idx)
    as a high and a low word, compared as ``Packed96::gt`` does (the index
    makes the words distinct, so the search and the merge never meet a
    tie), sorted by the replayed schedule and held bit for bit to the
    reference's stable oracle on the keys' dense ranks, which order the
    window alike."""
    rng = np.random.default_rng(W + 64)
    L = W.bit_length() - 1
    mask32 = np.uint64(0xFFFFFFFF)
    b, key = _k3_merge_input(case, W, rng)
    u = key.view(np.uint64) ^ np.uint64(1 << 63)
    hi = (b.astype(np.uint64) << np.uint64(32 + L)) | (u >> np.uint64(32 - L))
    lo = (((u & mask32) << np.uint64(L)) & mask32) | np.arange(W, dtype=np.uint64)

    def gt(ia, ib):
        return (hi[ia] > hi[ib]) | ((hi[ia] == hi[ib]) & (lo[ia] > lo[ib]))

    out = _replay_k3_merge(W, gt)
    rank = np.unique(key, return_inverse=True)[1].astype(np.int32)
    want_b, _, want_idx = bitonic_sort_windows_ref(
        jnp.asarray(b[None]), jnp.asarray(rank[None]),
        jnp.asarray(np.arange(W, dtype=np.int32)[None]))
    np.testing.assert_array_equal((lo[out] & np.uint64(W - 1)).astype(np.int32),
                                  np.asarray(want_idx[0]))
    np.testing.assert_array_equal((hi[out] >> np.uint64(32 + L)).astype(np.int32),
                                  np.asarray(want_b[0]))


# ---- K11 float32 ------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), to nearest, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x - big)


def _replay_k11_f32(q, k, v, causal, window, terms):
    """Attention with both products on tf32 operands: ``terms`` 3 is the
    kernel's small x big + big x small + big x big, 1 is plain TF32."""
    s_len, hd = q.shape[-2], q.shape[-1]

    def product(a, b):  # tf32 products are exact in f32; the sums are f32
        (ab, as_), (bb, bs) = _split(a), _split(b)
        if terms == 1:
            return ab @ bb
        return as_ @ bb + ab @ bs + ab @ bb

    sc = product(q * (1.0 / math.sqrt(hd)), k.transpose(-1, -2))
    rows = torch.arange(s_len)[:, None]
    cols = torch.arange(s_len)[None, :]
    valid = torch.ones((s_len, s_len), dtype=torch.bool)
    if causal:
        valid = cols <= rows
    if window:
        valid = valid & (cols > rows - window)
    sc = torch.where(valid, sc, -1e30)
    p = torch.where(valid, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    return product(p, v) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("s,hd,causal,window", [(256, 64, True, 0), (300, 128, False, 100),
                                                (200, 128, True, 64), (128, 64, False, 0)])
def test_k11_three_tf32_terms_keep_the_f32_limit(s, hd, causal, window):
    """The 3xTF32 products meet the float32 limit against the reference's
    oracle; plain TF32 products do not."""
    rng = np.random.default_rng(s + hd)
    q, k, v = (rng.standard_normal((1, 2, s, hd)).astype(np.float32) for _ in range(3))
    want = np.asarray(ref_attention_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, window=window))
    limit = 2e-5 + 2e-5 * np.abs(want)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = _replay_k11_f32(tq, tk, tv, causal, window, 3).numpy()
    assert (np.abs(got - want) <= limit).all()
    plain = _replay_k11_f32(tq, tk, tv, causal, window, 1).numpy()
    assert (np.abs(plain - want) > limit).any()


def test_tf32_rounding_is_to_nearest_ties_away():
    """The replay's rounding, as ``cvt.rna.tf32.f32``: 13 low bits dropped,
    half an ulp rounded away from zero, and big + small within 2^-22 |x|."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23, 3.0],
                     dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big, small = _split(y)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((big + small - y).abs() <= 2.0 ** -22 * y.abs()).all()


# ---- K1 -------------------------------------------------------------------

INT_MAX = np.iinfo(np.int32).max
SIGN = np.uint32(0x80000000)


def _eytzinger(upper: np.ndarray, k: int) -> np.ndarray:
    """The kernel's s_tree: node i at depth h, p-th of its depth, holds the
    sorted splitter (2p + 1) k / 2^(h+1) - 1 (node 0 unused)."""
    tree = np.zeros(k, np.int64)
    for i in range(1, k):
        h = i.bit_length() - 1
        tree[i] = upper[(2 * (i - (1 << h)) + 1) * (k >> (h + 1)) - 1]
    return tree


def _replay_k1_tile(keys, upper, k, pad_from, shift):
    """K1's CTA over one tile of signed keys: (bucket, rank, hist).  Tree
    mode when ``upper`` is given, else radix at ``shift``; positions >=
    ``pad_from`` are pads.  int64 keys take the 64-bit form: a warp per 256
    positions, the digit of the 64-bit code, the sentinel LLONG_MAX."""
    length = keys.shape[0]
    span = 256 if keys.dtype == np.int64 else 512
    warps = max(1, -(-length // span)) if length else 1
    nb = 2 * k + 1
    key = keys.astype(np.int64)
    if upper is None and keys.dtype == np.int64:
        code = keys.view(np.uint64) ^ np.uint64(1 << 63)
        bits = ((code >> np.uint64(shift)).astype(np.uint32) & np.uint32(k - 1)).astype(np.int64)
        ids = 2 * bits + (key == np.iinfo(np.int64).max)
    elif upper is None:
        bits = ((keys.view(np.uint32) ^ SIGN).astype(np.int64) >> shift) & (k - 1)
        ids = 2 * bits + (key == INT_MAX)
    else:
        tree = _eytzinger(upper, k)
        j = np.ones(length, np.int64)
        for _ in range(k.bit_length() - 1):  # the interleaved descent, all keys at once
            j = 2 * j + (key > tree[j])
        j -= k
        ids = 2 * j + (key == upper[j])
    ids[np.arange(length) >= pad_from] = 2 * k
    return ids, *_replay_k1_ranks(ids, nb, warps, span)


def _replay_k1_ranks(ids, nb, warps, max_span=512):
    """The warps' spans of 32-wide chunks, the ranks in registers, the scan."""
    length = ids.shape[0]
    span = ((-(-length // warps)) + 31) // 32 * 32
    assert span <= max_span
    cnt = np.zeros((warps, nb), np.int64)
    rank = np.zeros(length, np.int64)
    warp_of = np.zeros(length, np.int64)
    for w in range(warps):
        lo, hi = w * span, min(w * span + span, length)
        for base in range(lo, hi, 32):
            chunk = ids[base:min(base + 32, hi)]
            same = chunk[:, None] == chunk[None, :]  # the lanes' bits OR-ed into a mask per id
            below = np.tril(same, -1).sum(1)  # popc(same & below)
            rank[base:base + chunk.shape[0]] = cnt[w, chunk] + below
            np.add.at(cnt[w], chunk, 1)  # the group's lowest lane bumps the counter
        warp_of[lo:hi] = w
    excl = np.cumsum(cnt, 0) - cnt
    return rank + excl[warp_of, ids], cnt.sum(0)


def _k1_keys(n, k, seed):
    """Keys with heavy duplicates, many equal to a splitter, some equal to
    the sentinel; sorted splitters with duplicates."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-40, 40, n).astype(np.int32)
    keys[rng.random(n) < 0.05] = INT_MAX
    keys[rng.random(n) < 0.02] = np.iinfo(np.int32).min
    spl = np.sort(rng.choice(keys[keys != INT_MAX], k - 1)).astype(np.int32)
    on_splitter = rng.random(n) < 0.3
    keys[on_splitter] = rng.choice(spl, int(on_splitter.sum()))
    return keys, spl


def _ref_tile_ids(keys, spl, k, classifier, consumed):
    """The reference's classification of the whole row (uint32 codes)."""
    u = keys.view(np.uint32) ^ SIGN
    rows = -(-u.shape[0] // 128)
    padded = np.full(rows * 128, np.iinfo(np.uint32).max, np.uint32)
    padded[: u.shape[0]] = u
    if classifier == "radix":
        ids = ref_radix_bucket_ids(jnp.asarray(padded), k, consumed)
    else:
        upper = np.append(spl.view(np.uint32) ^ SIGN, np.uint32(np.iinfo(np.uint32).max))
        ids = ref_classify_tile(jnp.asarray(padded.reshape(rows, 128)),
                                jnp.asarray(upper.reshape(1, k)), k=k, classifier="tree",
                                consumed=0)
    return np.asarray(ids).reshape(-1)[: u.shape[0]]


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("k,n,n_real,tile", [(2, 5000, 4900, 4096), (16, 9000, 9000, 1024),
                                             (128, 20000, 19000, 4096), (16, 1000, 990, 33),
                                             (128, 17000, 16500, 16384), (2, 600, 0, 512)])
def test_k1_descent_and_register_ranks_match_the_reference(classifier, k, n, n_real, tile):
    """Per tile, the replayed bucket, rank and histogram equal the
    reference's ``_classify_tile`` (or radix ids) with its pad routing and
    ``_rank_and_hist``; a ragged last tile is held to the reference's
    trash-id padding (rank -1, out of the histogram)."""
    keys, spl = _k1_keys(n, k, seed=k + n + tile)
    consumed = 3 if classifier == "radix" else 0
    shift = radix_shift(k, consumed)
    want_ids = _ref_tile_ids(keys, spl, k, classifier, consumed)
    want_ids = np.where(np.arange(n) >= n_real, 2 * k, want_ids)
    nb = 2 * k + 1
    upper = None if classifier == "radix" else np.append(spl, INT_MAX).astype(np.int64)
    for col in range(0, n, tile):
        length = min(tile, n - col)
        ids, rank, hist = _replay_k1_tile(keys[col:col + length], upper, k, n_real - col, shift)
        np.testing.assert_array_equal(ids, want_ids[col:col + length])
        rows = -(-length // 128)
        padded = np.full(rows * 128, nb, np.int32)  # the reference's trash id
        padded[:length] = want_ids[col:col + length]
        ref_rank, ref_hist = ref_rank_and_hist(jnp.asarray(padded.reshape(rows, 128)), nb, rows)
        np.testing.assert_array_equal(rank, np.asarray(ref_rank).reshape(-1)[:length])
        np.testing.assert_array_equal(hist, np.asarray(ref_hist).reshape(-1))


@pytest.mark.parametrize("classifier", ["tree", "radix"])
def test_k1_replay_places_like_the_reference_kernel(classifier):
    """The replay's outputs through the port's epilogue give the reference
    kernel's (dest, offsets) in interpret mode, pads included."""
    n, n_real, k, tile = 4096, 4000, 16, 1024
    keys, spl = _k1_keys(n, k, seed=5)
    u = keys.view(np.uint32) ^ SIGN
    upper = None if classifier == "radix" else np.append(spl, INT_MAX).astype(np.int64)
    outs = [_replay_k1_tile(keys[c:c + tile], upper, k, n_real - c, radix_shift(k, 0))
            for c in range(0, n, tile)]
    bucket = torch.as_tensor(np.concatenate([o[0] for o in outs]).astype(np.int32))[None]
    rank = torch.as_tensor(np.concatenate([o[1] for o in outs]).astype(np.int32))[None]
    hist = torch.as_tensor(np.stack([o[2] for o in outs]).astype(np.int32))[None]
    dest, offsets = close_placement(bucket, rank, hist, 2 * k + 1, tile)
    ref_spl = None if classifier == "radix" else jnp.asarray(spl.view(np.uint32) ^ SIGN)
    want_dest, want_off = ref_level_fused(jnp.asarray(u), ref_spl, k=k, n_real=n_real,
                                          classifier=classifier, rows=tile // 128,
                                          interpret=True)
    np.testing.assert_array_equal(dest[0].numpy(), np.asarray(want_dest))
    np.testing.assert_array_equal(offsets[0].numpy(), np.asarray(want_off))


K1_64_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
import test_torch_kernel_schedules as S
from repro_torch.classify import radix_shift

assert jax.config.jax_enable_x64
I64 = np.iinfo(np.int64)
U64_SIGN = np.uint64(1 << 63)
for classifier in ("tree", "radix"):
    for k, n, n_real, tile in ((128, 20000, 19000, 4096), (16, 9000, 8990, 8192),
                               (2, 600, 0, 512), (16, 1000, 990, 33)):
        rng = np.random.default_rng(k + n + tile)
        keys = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
        keys[rng.random(n) < 0.3] = keys[0]
        keys[rng.random(n) < 0.05] = I64.max
        keys[rng.random(n) < 0.02] = I64.min
        spl = np.sort(rng.choice(keys[keys != I64.max], k - 1))
        on_splitter = rng.random(n) < 0.3
        keys[on_splitter] = rng.choice(spl, int(on_splitter.sum()))
        u = keys.view(np.uint64) ^ U64_SIGN
        rows = -(-n // 128)
        padded = np.full(rows * 128, np.iinfo(np.uint64).max, np.uint64)
        padded[:n] = u
        for consumed in ((0, 5, 60) if classifier == "radix" else (0,)):
            if classifier == "radix":
                want = S.ref_radix_bucket_ids(jnp.asarray(padded), k, consumed)
                upper = None
            else:
                ref_upper = np.append(spl.view(np.uint64) ^ U64_SIGN, np.iinfo(np.uint64).max)
                want = S.ref_classify_tile(jnp.asarray(padded.reshape(rows, 128)),
                                           jnp.asarray(ref_upper.reshape(1, k)), k=k,
                                           classifier="tree", consumed=0)
                upper = np.append(spl, I64.max)
            want = np.where(np.arange(n) >= n_real, 2 * k, np.asarray(want).reshape(-1)[:n])
            nb = 2 * k + 1
            for col in range(0, n, tile):
                length = min(tile, n - col)
                ids, rank, hist = S._replay_k1_tile(keys[col:col + length], upper, k,
                                                    n_real - col, radix_shift(k, consumed, 64))
                np.testing.assert_array_equal(ids, want[col:col + length])
                r = -(-length // 128)
                pad_ids = np.full(r * 128, nb, np.int32)
                pad_ids[:length] = want[col:col + length]
                ref_rank, ref_hist = S.ref_rank_and_hist(jnp.asarray(pad_ids.reshape(r, 128)),
                                                         nb, r)
                np.testing.assert_array_equal(rank, np.asarray(ref_rank).reshape(-1)[:length])
                np.testing.assert_array_equal(hist, np.asarray(ref_hist).reshape(-1))
print("K1 64 replay OK")
"""


@pytest.fixture(scope="module", autouse=True)
def x64_children():
    """The x64 children of K1's and K7's 64-bit replays, started with the
    module so that they run beside its other tests."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    children = {"K1": Child(K1_64_CHILD, here), "K7": Child(K7_64_CHILD, here)}
    yield children
    for child in children.values():
        child.stop()


def test_k1_64bit_replay_matches_the_reference_in_x64(x64_children):
    """K1's and K1r's 64-bit form replayed per tile (a warp per 256
    positions; the digit of the 64-bit code at shifts in [0, 64), level 2's
    clamped one included; the sentinel LLONG_MAX), against the reference's
    classification of the uint64 codes and its ``_rank_and_hist``, in a
    child process with x64 enabled from startup."""
    proc = x64_children["K1"].result(timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-5000:]
    assert "K1 64 replay OK" in proc.stdout


def test_k1_eytzinger_descent_counts_the_splitters_below():
    """The descent equals the sorted-array search for every key around every
    splitter, with duplicate splitters and the sentinel upper."""
    for k in (2, 4, 16, 128, 512):
        rng = np.random.default_rng(k)
        upper = np.append(np.sort(rng.integers(-20, 20, k - 1)), INT_MAX).astype(np.int64)
        tree = _eytzinger(upper, k)
        keys = np.concatenate([upper, upper - 1, upper + 1, [np.iinfo(np.int32).min]])
        j = np.ones(keys.shape[0], np.int64)
        for _ in range(k.bit_length() - 1):
            j = 2 * j + (keys > tree[j])
        np.testing.assert_array_equal(j - k, np.searchsorted(upper[:-1], keys, side="left"))


# ---- K5 -------------------------------------------------------------------


def _warp_search(lo, hi, pred):
    """The cut kernel's warp search over many diagonals at once: the largest
    c in [lo, hi] with pred(c) (pred(lo) taken to hold), 32 probes a step."""
    lo, hi = lo.astype(np.int64).copy(), hi.astype(np.int64).copy()
    lanes = np.arange(32)
    steps = 0
    while (hi > lo).any():
        act = hi > lo
        span = hi - lo
        probe = np.where(span[:, None] >= 32, lo[:, None] + (((lanes + 1) * span[:, None]) >> 5),
                         lo[:, None] + lanes + 1)
        valid = probe <= hi[:, None]
        q = valid & pred(np.where(valid, probe, lo[:, None] + 1))
        c = q.sum(1)
        assert (q == (lanes[None, :] < c[:, None])).all()  # the ballot is a prefix
        first_false = probe[np.arange(probe.shape[0]), np.minimum(c, 31)]
        new_lo = np.where(c > 0, probe[np.arange(probe.shape[0]), np.maximum(c - 1, 0)], lo)
        new_hi = np.where((c < 32) & (first_false <= hi), first_false - 1, hi)
        lo, hi = np.where(act, new_lo, lo), np.where(act, new_hi, hi)
        steps += 1
    return lo, steps


def _replay_warp_cut(a, b, d, s):
    """A CTA's first cut, as its first warp finds it in device memory: the
    first steps on the multiples of s (which divides d), then the span left."""
    na, nb = a.shape[0], b.shape[0]
    lo, hi = np.array([max(0, d - nb)]), np.array([min(d, na)])
    a64, b64 = a.astype(np.int64), b.astype(np.int64)

    def q(i):
        return a64[np.clip(i - 1, 0, na - 1)] <= b64[np.clip(d - i, 0, nb - 1)]

    m, coarse = _warp_search(lo // s, hi // s, lambda m: q(m * s))
    cut, fine = _warp_search(np.maximum(lo, m * s), np.minimum(hi, m * s + s - 1), q)
    return int(cut[0]), coarse, fine


def _window(x_off, start, length, kb=4):
    """The 16-byte pieces of a window of keys of ``kb`` bytes at element
    offset ``start`` of a run whose first key sits x_off bytes past a
    16-byte boundary: (first piece's byte address, pieces, keys skipped)."""
    lo = x_off + kb * start
    first = lo & ~15
    pieces = ((lo + kb * length + 15) & ~15) - first >> 4 if length > 0 else 0
    return first, pieces, (lo - first) // kb


def _copy_window(x, x_off, start, length, kb=4):
    """What the bulk copy brings, as keys of ``kb`` bytes (16 // kb a
    piece): memory keys around the run are -1 (never read as keys); each
    piece must hold at least one key of the run."""
    first, pieces, skip = _window(x_off, start, length, kb)
    per_piece = 16 // kb
    words = np.full(per_piece * pieces, -1, np.int64)
    for w in range(per_piece * pieces):
        e = (first + kb * w - x_off) // kb  # element index of this key slot
        if 0 <= e < x.shape[0]:
            words[w] = x[e]
    for c in range(pieces):  # inside the allocation: a key of the run in every piece
        e0 = (first + 16 * c - x_off) // kb
        assert e0 + per_piece - 1 >= 0 and e0 < x.shape[0]
    return words, pieces, skip


def _replay_k5(a, b, tile, grid, a_off=0, b_off=0):
    """The merge kernel over ``grid`` CTAs, each a contiguous run of steps,
    for int32 or int64 keys (a's dtype; steps of at most 8192 or 4096
    outputs): (perm, {step: cut at its start}, the most warp-search steps
    a cut took in shared memory)."""
    na, nb = a.shape[0], b.shape[0]
    n = na + nb
    key_bytes = a.dtype.itemsize
    step = min(tile, 8192 if key_bytes == 4 else 4096)
    per_piece = 16 // key_bytes
    per = step // 256 if step >= 2048 else min(step, 8)
    threads = max(32, step // per)  # a whole warp at least: the cut searches are a warp's
    stage_bytes = 2 * ((step * key_bytes + 15) & ~15) + 64
    num_tiles = -(-n // step)
    grid = min(grid, num_tiles)
    share, extra = divmod(num_tiles, grid)
    perm = np.full(n, -1, np.int64)
    cuts, stage_steps = {}, 0
    for cta in range(grid):
        t0 = cta * share + min(cta, extra)
        t1 = t0 + share + (cta < extra)
        ia = _replay_warp_cut(a, b, t0 * step, step)[0]
        ja = t0 * step - ia
        for t in range(t0, t1):
            cuts[t] = ia
            d0 = t * step
            length = min(step, n - d0)
            la, lb = min(step, na - ia), min(step, nb - ja)  # the stage's keys
            wa, ca, sa_skip = _copy_window(a, a_off, ia, la, key_bytes)
            wb, cb, sb_skip = _copy_window(b, b_off, ja, lb, key_bytes)
            assert 16 * (ca + cb) <= stage_bytes
            stage = np.concatenate([wa, wb])
            sb0 = per_piece * ca + sb_skip
            sa, sb = stage[sa_skip:sa_skip + la], stage[sb0:sb0 + lb]
            np.testing.assert_array_equal(sa, a[ia:ia + la])
            np.testing.assert_array_equal(sb, b[ja:ja + lb])
            # the step's end cut, by one warp in the stage
            end, steps = _warp_search(np.array([max(0, length - lb)]), np.array([min(length, la)]),
                                      lambda i: sa[np.clip(i - 1, 0, max(la - 1, 0))]
                                      <= sb[np.clip(length - i, 0, max(lb - 1, 0))])
            stage_steps = max(stage_steps, steps)
            lo = np.minimum(np.arange(threads) * per, length)
            # each thread's sub-diagonal: a binary search in the stage
            slo, shi = np.maximum(0, lo - lb), np.minimum(lo, la)
            while (slo < shi).any():
                act = slo < shi
                mid = (slo + shi + 1) >> 1
                q = (sa[np.clip(mid - 1, 0, max(la - 1, 0))]
                     <= sb[np.clip(lo - mid, 0, max(lb - 1, 0))]) if la and lb else act
                slo = np.where(act & q, mid, slo)
                shi = np.where(act & ~q, mid - 1, shi)
            i, j = slo.copy(), lo - slo
            s_out = np.full(step + step // 32 + 1, -1, np.int64)
            for r in range(per):
                ka = sa[np.minimum(i, max(la - 1, 0))] if la else np.zeros_like(i)
                kb = sb[np.minimum(j, max(lb - 1, 0))] if lb else np.zeros_like(j)
                take_a = (i < la) & ((j >= lb) | (ka <= kb))
                src = np.where(take_a, ia + i, na + ja + j)
                o = np.arange(threads) * per + r
                keep = o < length
                s_out[(o + (o >> 5))[keep]] = src[keep]
                i, j = i + take_a, j + ~take_a
            o = np.arange(length)
            perm[d0:d0 + length] = s_out[o + (o >> 5)]
            ia, ja = ia + int(end[0]), ja + length - int(end[0])
    return perm, cuts, stage_steps


@pytest.mark.parametrize("na,nb,lo_hi,tile", [
    (50_000, 30_000, (-5, 5), 2048),  # duplicate-heavy runs, a partial last step
    (3000, 9000, None, 2048),  # a exhausted inside the first step
    (100, 70_000, (-50, 50), 4096),  # nA smaller than a step
    (70_000, 5, (-50, 50), 16384),  # nB smaller than a step; steps of 8192, 32 outputs a thread
    (20_000, 20_001, (-3, 3), 512),  # 64 threads of 8
    (300, 211, (-2, 2), 8),  # one warp, its first thread's 8 outputs
    (40, 33, (-2, 2), 1),  # a step of one output
])
def test_k5_cuts_and_thread_merge_match_the_reference(na, nb, lo_hi, tile):
    """The replayed cuts (a CTA's first in device memory, every later one in
    its stage) equal ``merge_path_partition`` at every step boundary, and
    the replayed merge equals ``merge_path_perm_ref``, on grids of one CTA,
    of three and of one CTA a step, with NaN codes (INT_MAX) at the runs'
    ends and at every alignment of the runs' first keys."""
    rng = np.random.default_rng(na + nb + tile)
    if lo_hi is None:  # every a below every b
        a = np.sort(rng.integers(-100, 0, na)).astype(np.int32)
        b = np.sort(rng.integers(0, 100, nb)).astype(np.int32)
    else:
        a = np.sort(rng.integers(*lo_hi, na)).astype(np.int32)
        b = np.sort(rng.integers(*lo_hi, nb)).astype(np.int32)
        a[-2:] = INT_MAX
        b[-1:] = INT_MAX
    n = na + nb
    step = min(tile, 8192)
    d = np.arange(-(-n // step), dtype=np.int64) * step
    want_cuts = np.asarray(ref_merge_path_partition(jnp.asarray(a), jnp.asarray(b),
                                                    jnp.asarray(d.astype(np.int32))))
    want = np.asarray(merge_path_perm_ref(jnp.asarray(a), jnp.asarray(b)))
    for grid, (a_off, b_off) in ((1, (0, 0)), (3, (4, 12)), (n, (8, 4)), (2, (12, 8))):
        perm, cuts, stage_steps = _replay_k5(a, b, tile, grid, a_off, b_off)
        np.testing.assert_array_equal(np.array([cuts[t] for t in range(d.shape[0])]), want_cuts)
        np.testing.assert_array_equal(perm, want)
        assert stage_steps <= 3  # a span of at most 8193 closes in 3 steps of 32 probes
    for t in range(0, d.shape[0], max(1, d.shape[0] // 5)):  # a CTA's first cut
        cut, coarse, fine = _replay_warp_cut(a, b, int(d[t]), step)
        assert cut == want_cuts[t] and fine <= (3 if step > 32 else 1)


@pytest.mark.parametrize("na,nb,tile", [
    (50_000, 30_000, 2048),  # a partial last step
    (100, 30_000, 8192),  # steps of 4096 (the 64-bit form's largest), 16 outputs a thread
    (20_001, 20_000, 512),  # 64 threads of 8
    (300, 211, 8),  # one warp
])
def test_k5_64bit_cuts_and_thread_merge(na, nb, tile):
    """K5's int64 form: two keys a 16-byte piece, steps of at most 4096 and
    stages of 2 x roundup16(8 T) + 64 bytes; the replayed cuts equal the
    plain diagonal search and the replayed merge the stable argsort, with
    LLONG_MAX (the code of NaN) at the runs' ends and duplicates at the
    int64 extremes, at every 8-byte alignment of the runs' first keys.
    (The plain twins are held to the reference's kernel on uint64 codes in
    the x64 child of ``tests/test_torch_dtypes.py``.)"""
    from repro_torch.kernels import merge_path

    rng = np.random.default_rng(na + nb + tile)
    top = np.iinfo(np.int64).max
    a = np.sort(rng.integers(-3, 4, na).astype(np.int64) * (top // 4))
    b = np.sort(rng.integers(-3, 4, nb).astype(np.int64) * (top // 4))
    a[-2:], b[-1:] = top, top
    n = na + nb
    step = min(tile, 4096)
    d = np.arange(-(-n // step), dtype=np.int64) * step
    want_cuts = merge_path.merge_path_partition(torch.as_tensor(a), torch.as_tensor(b),
                                                torch.as_tensor(d)).numpy()
    want = np.argsort(np.concatenate([a, b]), kind="stable")
    np.testing.assert_array_equal(
        merge_path.merge_path_perm_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy(), want)
    for grid, (a_off, b_off) in ((1, (0, 0)), (3, (8, 0)), (2, (0, 8))):
        perm, cuts, stage_steps = _replay_k5(a, b, tile, grid, a_off, b_off)
        np.testing.assert_array_equal(np.array([cuts[t] for t in range(d.shape[0])]), want_cuts)
        np.testing.assert_array_equal(perm, want)
        assert stage_steps <= 3


@pytest.mark.parametrize("per", [8, 16, 32])
def test_k5_padded_transpose_has_no_bank_conflict(per):
    """Slot o + o/32 of output o = t * per + r: a bijection into the
    buffer; the 32 threads of a warp hit 32 banks when they write their
    r-th output, and when each reads the four slots of its 16-byte store."""
    threads = 256
    tile = threads * per
    o = np.arange(tile)
    slots = o + (o >> 5)
    assert len(np.unique(slots)) == tile and slots.max() < tile + tile // 32 + 1
    t = np.arange(threads)
    for r in range(per):
        banks = (slots[t * per + r] % 32).reshape(-1, 32)
        assert all(len(np.unique(w)) == 32 for w in banks)
    v = np.arange(tile // 4)
    for q in range(4):
        read = 4 * v + q + (v >> 3)
        np.testing.assert_array_equal(read, slots[4 * v + q])
        assert all(len(np.unique(w)) == 32 for w in (read % 32).reshape(-1, 32))


# ---- K2 and K4 rank_hist_batched -----------------------------------------

ITEMS_THREADS = 1024  # segment_items_kernel's CTA
GARBAGE = -7777  # what torch.empty may hold: a slot the count kernel skips


def _replay_k2_items(off, n, num_seg, width, tile, slots, row):
    """segment_items_kernel for one row: the slots' (position, length, id
    base) and first (num_seg + 1): each thread a contiguous run of
    segments, the scan over the threads, a binary search per slot."""
    lo = np.zeros(1, np.int64) if off is None else off[:num_seg].astype(np.int64)
    hi = np.append(lo[1:], n)
    length = hi - lo
    count = np.where(length > 0, length // tile + (length % tile != 0), 0)
    per = -(-num_seg // ITEMS_THREADS)
    starts = np.minimum(np.arange(ITEMS_THREADS) * per, num_seg)
    mine = np.array([count[s:min(s + per, num_seg)].sum() for s in starts])
    part = np.append(np.cumsum(mine) - mine, mine.sum())
    first = np.append(np.cumsum(count) - count, count.sum())
    live = int(part[-1])
    items = np.zeros((slots, 3), np.int64)
    for i in range(live):
        a, b = 0, ITEMS_THREADS
        while b - a > 1:
            m = (a + b) >> 1
            a, b = (m, b) if part[m] <= i else (a, m)
        s = a * per
        while first[s + 1] <= i:
            s += 1
        start = lo[s] + (i - first[s]) * tile
        items[i] = row * n + start, min(tile, hi[s] - start), s * width
    return items, first, live


def _ballot(pred):
    """(warps, 32) bools -> each warp's ballot word."""
    return (pred.astype(np.int64) << np.arange(32)).sum(-1)


def _small_groups(local, valid, id_bits):
    """segment_small_kernel's ballots over one chunk of 32 lanes: each
    lane's peers (the lanes holding its id) and of_lane (the lanes holding
    id == lane), from the valid ballot and one ballot per id bit."""
    lane = np.arange(32)
    vm = _ballot(valid[None])[0]
    peers = np.full(32, vm, np.int64)
    of_lane = np.full(32, vm, np.int64)
    for bit in range(id_bits):
        m = _ballot((((local >> bit) & 1) == 1)[None])[0]
        peers &= np.where((local >> bit) & 1, m, ~m)
        of_lane &= np.where((lane >> bit) & 1, m, ~m)
    return peers, of_lane


def _popc(x):
    return ((np.asarray(x)[..., None] >> np.arange(32)) & 1).sum(-1)


def _chunk(flat_ids, item, width, at, length):
    """Lanes of the 32-wide chunk at ``at``: local ids, -1 past the item."""
    pos, _, id_base = item
    p = at + np.arange(32)
    local = np.where(p < length, flat_ids[pos + np.minimum(p, length - 1)] - id_base, -1)
    return local, (local >= 0) & (local < width)


def _replay_k2_count(flat_ids, item, width, sch):
    """One slot's counts.  W2 <= 4 (segment_tiny_count_kernel): each lane
    counts its ids as 8-bit fields of one word a batch; W2 <= 32
    (segment_small_kernel): one warp walks the item, lane b adding
    popc(of_lane) a chunk.  Else
    (segment_count_kernel): batches of 16 loads a thread, one atomicAdd
    an id."""
    _, length, _ = item
    cnt = np.zeros(width, np.int64)
    if width <= 4:  # segment_tiny_count_kernel: a lane's ids as 8-bit fields, a batch at a time
        lanes = np.zeros((32, 4), np.int64)
        for frm in range(0, length, 32 * 16):
            packed = np.zeros(32, np.int64)
            for c in range(16):
                local, valid = _chunk(flat_ids, item, width, frm + 32 * c, length)
                packed += np.where(valid, 1 << (8 * np.where(valid, local, 0)), 0)
            fields = (packed[:, None] >> (8 * np.arange(4))) & 255
            assert fields.sum() == sum(
                _chunk(flat_ids, item, width, frm + 32 * c, length)[1].sum() for c in range(16))
            lanes += fields
        return lanes.sum(0)[:width]
    if sch["small"]:
        run = np.zeros(32, np.int64)
        for at in range(0, length, 32):
            local, valid = _chunk(flat_ids, item, width, at, length)
            run += _popc(_small_groups(local, valid, sch["id_bits"])[1])
        return run[:width]
    threads = 32 * sch["warps"]
    for frm in range(0, length, threads * 16):
        for c in range(16):
            for w in range(sch["warps"]):
                local, valid = _chunk(flat_ids, item, width, frm + c * threads + 32 * w, length)
                np.add.at(cnt, local[valid], 1)
    return cnt


def _replay_k2_scan(off, first, hist, n, num_seg, width, team, scan_ids):
    """segment_scan_kernel over one row (the items kernel wrote the last
    offset, n): per segment, thread t = (x, y) of the team takes id b0 + x
    and run y of the slots; the exclusive scan in thread order; each run's
    walk writes base in place; run 0 writes the offsets.  Only the
    segment's live slots are read."""
    runs = team // scan_ids
    base = hist.copy()
    offsets = np.full(num_seg * width + 1, GARBAGE, np.int64)
    offsets[-1] = n
    t = np.arange(team)
    x, y = t // runs, t % runs
    for s in range(num_seg):
        f, c = int(first[s]), int(first[s + 1] - first[s])
        lo = 0 if off is None else int(off[s])
        seg = hist[f:f + c]
        assert (seg != GARBAGE).all()
        cs = np.concatenate([np.zeros((1, width), np.int64), np.cumsum(seg, 0)])
        carry = lo
        per = -(-c // runs)
        i0 = np.minimum(y * per, c)
        i1 = np.minimum(i0 + per, c)
        for b0 in range(0, width, scan_ids):
            b = b0 + x
            act = (x < scan_ids) & (b < width)
            bb = np.minimum(b, width - 1)
            v = np.where(act, cs[i1, bb] - cs[i0, bb], 0)
            excl = np.cumsum(v) - v
            for tt in np.nonzero(act)[0]:
                run = carry + excl[tt]
                if y[tt] == 0:
                    offsets[s * width + b[tt]] = run
                items = np.arange(i0[tt], i1[tt])
                base[f + items, b[tt]] = run + cs[items, b[tt]] - cs[i0[tt], b[tt]]
            carry += v.sum()
    return base, offsets


def _replay_k2_rank(flat_ids, item, base_row, width, sch, dest):
    """One slot's destinations.  W2 <= 32 (segment_small_kernel): one warp
    walks the item, lane b holding id b's next destination (base + the
    count so far); a lane's is lane v's (a shuffle) + popc(peers & below).
    Else (segment_rank_kernel): each warp's span in batches of 16 chunks,
    peers OR-ed into a mask per id, 16-bit per-warp counters, the scan over
    the warps, dest = base + the warp's start + rank (kMulti: a counting
    walk, then ranks again from the start)."""
    pos, length, id_base = item
    below = (1 << np.arange(32)) - 1
    if sch["small"]:
        run = np.zeros(32, np.int64)
        run[:width] = base_row
        for at in range(0, length, 32):
            local, valid = _chunk(flat_ids, item, width, at, length)
            peers, of_lane = _small_groups(local, valid, sch["id_bits"])
            got = run[local & 31] + _popc(peers & below)
            n_at = min(32, length - at)
            dest[pos + at:pos + at + n_at] = np.where(valid, got, -1)[:n_at]
            run += _popc(of_lane)
        return
    warps, multi = sch["warps"], sch["multi"]
    span = ((-(-length // warps)) + 31) // 32 * 32
    assert multi or span <= 16 * 32  # one batch in registers
    cnt = np.zeros((warps, width), np.int64)
    local = flat_ids[pos:pos + length].astype(np.int64) - id_base
    valid = (local >= 0) & (local < width)

    def rank_chunk(w, at):
        ids_, ok = local[at], valid[at]
        same = ids_[:, None] == ids_[None, :]  # the lanes' bits OR-ed into a mask per id
        lower = np.tril(same & ok[None, :] & ok[:, None], -1).sum(1)
        r = cnt[w, np.where(ok, ids_, 0)] + lower
        np.add.at(cnt[w], ids_[ok], 1)  # the group's lowest lane bumps the counter
        assert cnt[w].max() < 1 << 16
        return r

    r = np.zeros(length, np.int64)
    for w in range(warps):
        lo, hi = w * span, min(w * span + span, length)
        for frm in range(lo, hi, 16 * 32):  # a batch: 16 chunks in flight
            for c in range(16):
                if frm + 32 * c < hi:
                    at = np.arange(frm + 32 * c, min(frm + 32 * c + 32, hi))
                    r[at] = rank_chunk(w, at)
    cnt = np.cumsum(cnt, 0) - cnt  # the exclusive scan over the warps
    assert cnt.max(initial=0) < 1 << 16
    warp_of = np.minimum(np.arange(length) // max(span, 1), warps - 1)
    if multi:
        for w in range(warps):
            lo, hi = w * span, min(w * span + span, length)
            for frm in range(lo, hi, 16 * 32):
                for c in range(16):
                    if frm + 32 * c < hi:
                        at = np.arange(frm + 32 * c, min(frm + 32 * c + 32, hi))
                        r[at] = rank_chunk(w, at)  # from the warp's start
        got = base_row[np.where(valid, local, 0)] + r
    else:
        got = base_row[np.where(valid, local, 0)] + cnt[warp_of, np.where(valid, local, 0)] + r
    dest[pos:pos + length] = np.where(valid, got, -1)


def _replay_k2(ids, off, num_seg, width, tile):
    """The four kernels over (rows, n) ids: (dest, offsets), row-local."""
    rows, n = ids.shape
    sch = segment_schedule(n, num_seg, width, tile)
    flat = ids.reshape(-1).astype(np.int64)
    dest = np.full(rows * n, GARBAGE, np.int64)
    offsets = np.zeros((rows, num_seg * width + 1), np.int64)
    for row in range(rows):
        o = None if off is None else off[row]
        items, first, live = _replay_k2_items(o, n, num_seg, width, tile, sch["slots"], row)
        assert (items[live:, 1] == 0).all()
        hist = np.full((sch["slots"], width), GARBAGE, np.int64)
        for i in range(live):
            hist[i] = _replay_k2_count(flat, items[i], width, sch)
        base, offsets[row] = _replay_k2_scan(o, first, hist, n, num_seg, width,
                                             sch["scan_threads"], sch["scan_ids"])
        for i in range(live):
            _replay_k2_rank(flat, items[i], base[i], width, sch, dest)
    return dest.reshape(rows, n), offsets


def _k2_segments(rng, B, n, num_seg, width, empty_tail=False):
    """Row-local composite ids over sorted segment boundaries with a run of
    empty segments (and, with ``empty_tail``, empty last segments)."""
    cuts = np.sort(rng.integers(0, n + 1, (B, num_seg - 1)), axis=1)
    cuts[:, : num_seg // 4] = cuts[:, :1]
    if empty_tail:
        cuts[:, -2:] = n
    off = np.concatenate([np.zeros((B, 1)), cuts, np.full((B, 1), n)], 1).astype(np.int32)
    seg = np.stack([np.searchsorted(o, np.arange(n), side="right") - 1 for o in off])
    return (seg * width + rng.integers(0, width, (B, n))).astype(np.int32), off


@pytest.mark.parametrize("nb", [3, 65, 520])
def test_k2_replay_matches_the_reference_kernels(nb):
    """One segment of width nb: the replay equals the reference's
    ``rank_hist`` and ``rank_hist_batched`` in interpret mode, n not a
    multiple of the tile."""
    rng = np.random.default_rng(nb)
    ids = rng.integers(0, nb, 5000).astype(np.int32)
    want_dest, want_off = ref_rank_hist(jnp.asarray(ids), nb=nb, interpret=True)
    dest, off = _replay_k2(ids[None], None, 1, nb, 512)
    np.testing.assert_array_equal(dest[0], np.asarray(want_dest))
    np.testing.assert_array_equal(off[0], np.asarray(want_off))
    rows = rng.integers(0, nb, (4, 1500)).astype(np.int32)
    rows[1] = nb - 1  # a row of one id
    want_dest, want_off = ref_rank_hist_batched(jnp.asarray(rows), nb=nb, interpret=True)
    dest, off = _replay_k2(rows, None, 1, nb, 256)
    np.testing.assert_array_equal(dest, np.asarray(want_dest))
    np.testing.assert_array_equal(off, np.asarray(want_off))


@pytest.mark.parametrize("B,n,num_seg,width,tile", [
    (1, 5000, 33, 64, 256),       # atomics count, several items a segment
    (1, 4096, 9, 8, 4096),        # ballot count, n a multiple of the tile
    (3, 2048, 257, 4, 512),       # K4's shape in miniature: W2 = 4, most slots short or empty
    (2, 3000, 17, 32, 128),       # five ballots; warp teams
    (1, 3001, 5, 33, 64),         # the first atomics width; one warp a CTA
    (1, 40000, 3, 2048, 16384),   # W2 = MAX_NB at MAX_TILE: batches of 16 chunks, twice
    (2, 20000, 2, 300, 8192),     # two batches a warp; a width that is no power of two
])
def test_k2_replay_matches_the_plain_twins_on_segments(B, n, num_seg, width, tile):
    """Composite ids over segments with empty ones: the replay equals the
    port's plain ``rank_hist`` (B = 1) and ``rank_hist_batched`` bit for
    bit, dest and the row-local offsets."""
    rng = np.random.default_rng(n + num_seg + width)
    comp, off = _k2_segments(rng, B, n, num_seg, width, empty_tail=B > 1)
    nb = num_seg * width
    dest, offsets = _replay_k2(comp, off, num_seg, width, tile)
    if B == 1:
        want = rank_hist_plain(torch.as_tensor(comp[0]), nb=nb, seg_offsets=torch.as_tensor(off[0]),
                               seg_width=width, tile=tile)
        want = (want[0][None], want[1][None])
    else:
        want = rank_hist_batched_plain(torch.as_tensor(comp), nb=nb,
                                       seg_offsets=torch.as_tensor(off), seg_width=width,
                                       tile=tile)
    np.testing.assert_array_equal(dest, want[0].numpy())
    np.testing.assert_array_equal(offsets, want[1].numpy())


@pytest.mark.parametrize("n,num_seg,tile", [(5000, 33, 256), (4096, 1, 4096), (100, 2000, 64),
                                            (0, 3, 512), (70000, 1500, 128)])
def test_k2_items_kernel_cuts_the_plain_items(n, num_seg, tile):
    """The items kernel's slots, found by a binary search over its threads'
    first slots (several segments a thread above 1024), are the plain
    twin's ``_items``: the same live items in position order, then empty
    slots up to the static bound."""
    rng = np.random.default_rng(num_seg)
    _, off = _k2_segments(rng, 1, n, num_seg, 2)
    width = 2
    slots = segment_schedule(n, num_seg, width, tile)["slots"]
    items, first, live = _replay_k2_items(off[0], n, num_seg, width, tile, slots, 0)
    start, length, seg, want_first, per_seg = _items(torch.as_tensor(off[0]), n, tile)
    assert slots == start.shape[0] and live == int(per_seg.sum())
    np.testing.assert_array_equal(items[:live, 0], start[:live].numpy())
    np.testing.assert_array_equal(items[:live, 1], length[:live].numpy())
    np.testing.assert_array_equal(items[:live, 2], seg[:live].numpy() * width)
    np.testing.assert_array_equal(first[:-1], want_first.numpy())
    assert (items[live:, 1] == 0).all() and (length[live:] == 0).all()


def test_k2_schedule_at_the_main_path_shapes():
    """The launch shapes the sorts give K2 (level 2 of 2^24 keys: 257
    segments of 256 ids) and K4 (64 rows of 2^18: 257 segments of 4 ids),
    and the largest: W2 = MAX_NB at MAX_TILE fits a CTA's shared memory."""
    assert segment_schedule(1 << 24, 257, 256, 4096) == {
        "slots": 4353, "small": False, "warps": 8, "multi": False, "id_bits": 8,
        "scan_threads": 512, "scan_ids": 256, "scan_runs": 2}
    assert segment_schedule(1 << 18, 257, 4, 4096) == {
        "slots": 321, "small": True, "warps": 8, "multi": False, "id_bits": 2,
        "scan_threads": 32, "scan_ids": 4, "scan_runs": 8}
    big = segment_schedule(1 << 20, 4, MAX_NB, MAX_TILE)
    assert big["multi"] and big["warps"] == 8 and big["scan_ids"] == 1024
    assert MAX_NB * (4 + 6 * big["warps"]) <= 232448  # base row; masks and counters


# ---- K6 -------------------------------------------------------------------

K6_WINDOW = 8  # status words a thread of the look-back reads a round
K6_PREFIX = 1 << 31
K6_ID_BITS = 13  # a packed position: id | rank in the tile << 13


def _k6_aggregate(count):
    """A tile's own count as its status word: at most the tile, < 2^15."""
    assert 0 <= count < 1 << 15
    return 1 + count


def _k6_prefix(count):
    """The count of the row's tiles up to and including this one."""
    assert 0 <= count < K6_PREFIX
    return K6_PREFIX | count


def _k6_unpack(word):
    """(state, count) of a 32-bit status word: 0 is not yet published."""
    word = int(word)
    if word == 0:
        return "none", 0
    if word & K6_PREFIX:
        return "prefix", word & (K6_PREFIX - 1)
    return "aggregate", word - 1


def _k6_tile_ranks(seg, nb, warps):
    """One tile's rank per position (-1 outside [0, nb)) and count per id:
    warp spans of 32-wide chunks, the lanes of one id by OR-ed peer masks,
    16-bit per-warp counters, the exclusive scan over the warps."""
    length = seg.shape[0]
    span = ((-(-length // warps)) + 31) // 32 * 32
    assert span <= 512
    ids = seg.astype(np.int64)
    valid = (ids >= 0) & (ids < nb)
    safe = np.where(valid, ids, 0)
    cnt = np.zeros((warps, nb), np.int64)
    r = np.zeros(length, np.int64)
    for w in range(warps):
        lo, hi = w * span, min(w * span + span, length)
        for base in range(lo, hi, 32):
            at = np.arange(base, min(base + 32, hi))
            same = (ids[at][:, None] == ids[at][None, :]) & valid[at][None, :]
            r[at] = cnt[w, safe[at]] + np.tril(same, -1).sum(1)
            np.add.at(cnt[w], ids[at][valid[at]], 1)  # the group's lowest lane
            assert cnt[w].max(initial=0) < 1 << 16
    warp_of = np.minimum(np.arange(length) // max(span, 1), warps - 1)
    rank = r + (np.cumsum(cnt, 0) - cnt)[warp_of, safe]
    assert rank.max(initial=0) < 1 << (31 - K6_ID_BITS)  # fits the packed position
    return np.where(valid, rank, -1), cnt.sum(0)


def _k6_look_back(status, g, first, nb, threads):
    """Tile g's look-back by a CTA of ``threads``: per round each thread
    reads the 8 words of its (id, window); an id's windows are taken in
    order until a prefix, or a word not yet published, where the next round
    starts.  A generator: it yields after each round (a round trip, while
    other CTAs go on), and returns the count over the row's earlier tiles
    per id."""
    excl = np.zeros(nb, np.int64)
    for b0 in range(0, nb, threads):
        C = min(nb - b0, threads)
        k = np.full(C, g - 1)
        done = np.zeros(C, bool)
        while not done.all():
            for b in np.nonzero(~done)[0]:
                windows = (threads - b + C - 1) // C
                taken = 0
                for m in range(windows):
                    top = k[b] - K6_WINDOW * m
                    ready = 0
                    for i in range(K6_WINDOW):
                        t = top - i
                        state, count = _k6_unpack(status[t, b0 + b]) if t >= first else ("none", 0)
                        if state == "none":
                            break
                        excl[b0 + b] += count
                        if state == "prefix":
                            done[b] = True
                            break
                        ready += 1
                    if done[b]:
                        break
                    taken += ready
                    if ready < K6_WINDOW:
                        break
                k[b] -= taken
            yield
    return excl


def _replay_k6(ids, start, nb, tile, grid, seed):
    """The kernel over (rows, n) ids: ``grid`` persistent CTAs take tickets
    in order (two ahead), rank each tile, publish its count, and look back
    for the tile before only after ranking the next one; a seeded scheduler
    interleaves the CTAs' steps, so tiles publish in a shuffled order.
    Returns (dest, the order in which tiles published their counts)."""
    from repro_torch.kernels.dispatch_rank import schedule

    rows, n = ids.shape
    warps, tile = schedule(nb, tile)
    tiles = -(-n // tile)
    total = rows * tiles
    status = np.zeros((total, nb), np.uint32)  # the memset
    dest = np.full((rows, n), GARBAGE, np.int64)
    ticket = [0]
    published = []

    def take():
        ticket[0] += 1
        return ticket[0] - 1

    def finish(g, rank, count):
        row, j = divmod(g, tiles)
        if j == 0:
            excl = np.zeros(nb, np.int64)
        else:
            excl = yield from _k6_look_back(status, g, g - j, nb, 32 * warps)
            for b in range(nb):
                status[g, b] = _k6_prefix(int(excl[b] + count[b]))
        seg = ids[row, j * tile:(j + 1) * tile]
        safe = np.where(rank >= 0, seg, 0)
        dest[row, j * tile:j * tile + seg.shape[0]] = np.where(
            rank >= 0, start[row, safe].astype(np.int64) + excl[safe] + rank, -1)

    def cta():
        cur, nxt = take(), take()
        pending = None
        while cur < total:
            after = take()
            row, j = divmod(cur, tiles)
            rank, count = _k6_tile_ranks(ids[row, j * tile:(j + 1) * tile], nb, warps)
            for b in range(nb):
                status[cur, b] = _k6_prefix(int(count[b])) if j == 0 else _k6_aggregate(int(count[b]))
            published.append(cur)
            yield
            if pending is not None:
                yield from finish(*pending)
            pending = (cur, rank, count)
            cur, nxt = nxt, after
        if pending is not None:
            yield from finish(*pending)

    rng = np.random.default_rng(seed)
    live = [cta() for _ in range(grid)]
    steps = 0
    while live:
        i = int(rng.integers(len(live)))
        try:
            next(live[i])
        except StopIteration:
            live.pop(i)
        steps += 1
        assert steps < 100 * (total + grid) * (total + 2), "the CTAs wait on each other"
    assert sorted(published) == list(range(total))
    return dest, published


def _k6_case(kind, nb, rows, n, seed):
    """(ids, starts) of one case: trash ids (nb), prefix or other starts,
    or every id in one bucket."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, nb + 1, (rows, n)).astype(np.int32)
    if kind == "one bucket":
        ids[:] = nb // 2
    counts = np.stack([np.bincount(r, minlength=nb + 1)[:nb] for r in ids])
    if kind == "prefix":
        start = (np.cumsum(counts, 1) - counts).astype(np.int32)
    else:
        start = rng.integers(0, 1 << 20, (rows, nb)).astype(np.int32)
    return ids, start


@pytest.mark.parametrize("kind,nb,rows,n,tile,grid", [
    ("starts", 257, 1, 3000, 256, 5),       # trash ids, ragged last tile, W2-wide walks
    ("prefix", 64, 1, 8192, 512, 7),        # the MoE shape in miniature; n a tile multiple
    ("starts", 257, 1, 500, 4096, 3),       # one tile: nothing to look back on
    ("one bucket", 5, 1, 2000, 128, 4),     # every id the same; 16 tiles
    ("starts", 4096, 1, 5000, 1024, 3),     # nb = 4096: ids in chunks of the CTA's threads
    ("prefix", 21, 3, 2000, 256, 6),        # rows: each row's first tile publishes a prefix
    ("starts", 64, 2, 20000, 8192, 2),      # 16 warps, eight windows an id
])
def test_k6_replay_matches_the_plain_twins(kind, nb, rows, n, tile, grid):
    """The replayed kernel equals the port's plain twins bit for bit,
    trash ids (-1) included, under three seeded interleavings of its CTAs,
    which publish the tiles' counts in three different orders."""
    from repro_torch.kernels import dispatch_rank as dr

    ids, start = _k6_case(kind, nb, rows, n, seed=nb + n)
    want = dr.partition_ranks_batched_plain(torch.as_tensor(ids), torch.as_tensor(start),
                                            nb=nb).numpy()
    orders = []
    for seed in range(3):
        dest, order = _replay_k6(ids, start, nb, tile, grid, seed)
        np.testing.assert_array_equal(dest, want)
        orders.append(tuple(order))
    if len(order) > grid + 2:
        assert len(set(orders)) > 1 and any(o != tuple(sorted(o)) for o in orders)


@pytest.mark.parametrize("entry", ["dispatch_ranks", "partition_ranks",
                                   "partition_ranks_batched"])
def test_k6_replay_matches_the_reference_kernels(entry):
    """The replay equals the reference's Pallas kernels in interpret mode:
    ``dispatch_ranks`` at 64 experts with prefix starts, ``partition_ranks``
    and ``partition_ranks_batched`` at nb = 257 with trash ids (whose
    destination the reference leaves unspecified) and other starts."""
    from repro.kernels import dispatch_rank as ref

    if entry == "dispatch_ranks":
        ids, start = _k6_case("prefix", 64, 1, 4096, seed=1)
        ids = np.minimum(ids, 63)  # no trash: the reference asks ids in [0, E)
        counts = np.bincount(ids[0], minlength=64)
        start = (np.cumsum(counts) - counts).astype(np.int32)[None]
        want = np.asarray(ref.dispatch_ranks(jnp.asarray(ids[0]), jnp.asarray(start[0]),
                                             num_experts=64, interpret=True))[None]
        nb = 64
    elif entry == "partition_ranks":
        ids, start = _k6_case("starts", 257, 1, 3000, seed=2)
        want = np.asarray(ref.partition_ranks(jnp.asarray(ids[0]), jnp.asarray(start[0]),
                                              nb=257, interpret=True))[None]
        nb = 257
    else:
        ids, start = _k6_case("starts", 257, 3, 1500, seed=3)
        want = np.asarray(ref.partition_ranks_batched(jnp.asarray(ids), jnp.asarray(start),
                                                      nb=257, interpret=True))
        nb = 257
    dest, _ = _replay_k6(ids, start, nb, 256, 4, seed=11)
    live = ids < nb
    np.testing.assert_array_equal(dest[live], want[live])
    assert (dest[~live] == -1).all()


def test_k6_status_word_holds_any_count_the_contract_allows():
    """A prefix may count up to rows * n - 1 < 2^31 - 1 ids: the status
    word keeps it beside its flag (an aggregate is at most one tile, below
    2^15), where 2 flag bits beside a 30-bit count would wrap.  The
    look-back sums words past 2^30 exactly, over three synthetic tiles."""
    for count in (0, 1, (1 << 30) - 1, 1 << 30, (1 << 30) + 5, (1 << 31) - 2):
        assert _k6_unpack(_k6_prefix(count)) == ("prefix", count)
        assert (count & ((1 << 30) - 1)) == count or count >= 1 << 30  # what 30 bits keep
    assert ((1 << 30) + 5) & ((1 << 30) - 1) != (1 << 30) + 5
    for count in (0, 1, 8192, 16384):
        assert _k6_unpack(_k6_aggregate(count)) == ("aggregate", count)
    status = np.zeros((4, 1), np.uint32)
    status[0, 0] = _k6_prefix((1 << 30) + 3)
    status[1, 0] = _k6_aggregate(16384)
    status[2, 0] = _k6_aggregate(7)
    walk = _k6_look_back(status, 3, 0, 1, 32)
    with pytest.raises(StopIteration) as stop:
        while True:
            next(walk)
    assert int(stop.value.value[0]) == (1 << 30) + 3 + 16384 + 7
    assert _k6_unpack(_k6_prefix(int(stop.value.value[0]) + 11)) == (
        "prefix", (1 << 30) + 3 + 16384 + 7 + 11)


def test_k6_schedule_and_shared_memory():
    """The CTA shapes the main path gives K6 (tiles of 8192: 16 warps) and
    the largest nb: 6 warps, tiles of 3072; every shape fits a CTA's
    shared memory, and a tile above its warps' 512 ids each is cut."""
    from repro_torch.kernels import dispatch_rank as dr

    assert dr.schedule(64, dr.TILE) == (16, 8192)
    assert dr.schedule(257, dr.TILE) == (16, 8192)
    assert dr.schedule(dr.MAX_NB, 16384) == (6, 3072)
    assert dr.schedule(1, 1 << 20) == (32, 16384)
    assert dr.schedule(5, 33) == (1, 33)
    for nb in (1, 64, 257, 1000, dr.MAX_NB):
        for tile in (1, 256, 4096, 8192, 16384, 60000):
            warps, t = dr.schedule(nb, tile)
            assert dr._smem_bytes(nb, warps) <= 232_448 and 1 <= t <= min(tile, warps * 512)


# ---- K7 -------------------------------------------------------------------

K7_WARPS = 8  # warps of K7's CTA (classify.THREADS / 32)
# kind -> (stored numpy dtype, compare numpy dtype): 8- and 16-bit ints
# widened to int, bfloat16 and float16 to float, the rest as they are
K7_KINDS = {
    "int8": (np.int8, np.int32), "uint8": (np.uint8, np.int32),
    "int16": (np.int16, np.int32), "uint16": (np.uint16, np.int32),
    "float16": (np.float16, np.float32), "bfloat16": (ml_dtypes.bfloat16, np.float32),
    "int32": (np.int32, np.int32), "uint32": (np.uint32, np.uint32),
    "float32": (np.float32, np.float32), "int64": (np.int64, np.int64),
    "uint64": (np.uint64, np.uint64), "float64": (np.float64, np.float64),
}
K7_KS = (1, 2, 3, 16, 100, 128, 256)


def _k7_compare(raw: np.ndarray, name: str) -> np.ndarray:
    """Stored keys in the kernel's compare type (bfloat16 by its bits)."""
    if name == "bfloat16":
        return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return raw.astype(K7_KINDS[name][1])


def _k7_pad(ctype) -> np.ndarray:
    """The tree's pad: NaN for the floats, the compare type's max else."""
    ctype = np.dtype(ctype)
    return ctype.type(np.nan) if ctype.kind == "f" else ctype.type(np.iinfo(ctype).max)


def _k7_tree(upper: np.ndarray, k: int) -> np.ndarray:
    """The padded Eytzinger tree of K7's CTA: node i at depth h, p-th of its
    depth, holds sorted index (2p + 1) k' / 2^(h+1) - 1 of the k-1
    splitters, the pad past them (node 0 unused)."""
    kp = 1 << (k - 1).bit_length()
    tree = np.full(kp, _k7_pad(upper.dtype), upper.dtype)
    for i in range(1, kp):
        h = i.bit_length() - 1
        at = (2 * (i - (1 << h)) + 1) * (kp >> (h + 1)) - 1
        if at < k - 1:
            tree[i] = upper[at]
    return tree


def _k7_grid(rows: int, tiles_per_row: int, cap: int, wave: int):
    """The launch's CTAs as (row, first tile, end tile): one wave of
    ``wave`` CTAs where ``cap`` tiles' histograms allow, each a run of tiles
    of one row."""
    per_cta = min(-(-(rows * tiles_per_row) // wave), cap, tiles_per_row)
    ctas_per_row = -(-tiles_per_row // per_cta)
    return [(r, c * per_cta, min(c * per_cta + per_cta, tiles_per_row))
            for r in range(rows) for c in range(ctas_per_row)]


def _k7_tile_div(tile: int):
    """(magic, shift) of the kernel's division by the tile (``TileDiv``):
    x // tile == (x * magic >> 32) >> shift for every x < 2^31."""
    lg = (tile - 1).bit_length()
    return -(-(1 << (31 + lg)) // tile), lg - 1


def _k7_warp_steps(keys: int, warp_step: int):
    """The first keys of each warp's steps over a CTA's ``keys``: warp w
    takes steps w, w + 8, ... (as (warps, steps) with -1 past the end)."""
    rounds = -(-keys // (K7_WARPS * warp_step))
    at0 = (np.arange(rounds)[None, :] * K7_WARPS + np.arange(K7_WARPS)[:, None]) * warp_step
    return np.where(at0 < keys, at0, -1)


def _k7_rotate(w: np.ndarray, by: np.ndarray, P: int) -> np.ndarray:
    """``rotate_pieces``: the P pieces of 4 / P words along the last axis,
    piece i <- piece (i - by) mod P, by selects per bit of ``by``."""
    PW = 4 // P
    bit = 1
    while bit < P:
        take = (by & bit) != 0
        w = np.where(take[..., None], w[..., [(i + 4 - bit * PW) & 3 for i in range(4)]], w)
        bit <<= 1
    return w


def _k7_to_pieces(words: np.ndarray, P: int) -> np.ndarray:
    """``to_pieces`` for every warp: (warps, 32 lanes, 4 words) of the
    lanes' 16-byte loads -> each lane's pieces 32q + lane of its warp's
    block, by the rotations and P shuffle rounds."""
    if P == 1:
        return words
    PW, span = 4 // P, 32 // P
    lane = np.arange(32)
    w = _k7_rotate(words, np.broadcast_to(lane // span, words.shape[:2]), P)
    s = lane & (P - 1)
    out = np.empty_like(w)
    for r in range(P):
        src = ((r - s) & (P - 1)) * span + lane // P
        out[..., r * PW:(r + 1) * PW] = w[:, src, r * PW:(r + 1) * PW]
    return _k7_rotate(out, np.broadcast_to((P - s) & (P - 1), words.shape[:2]), P)


def _replay_k7(raw: np.ndarray, name: str, upper, k: int, tile: int, wave: int = 7,
               shift: int = 0):
    """K7 over (B, n) stored keys of kind ``name``: tree mode against (B, k)
    uppers in the compare type, or radix mode at ``shift`` (``upper`` None,
    int32 or int64 codes).  Returns (ids, hist, stats): stats counts the
    shared atomics, each position's stores and each tile's flushes."""
    B, n = raw.shape
    KB = raw.dtype.itemsize
    KP = 2 if KB == 8 else 4  # keys a piece of ids
    PW = 4 if KB == 8 else KB  # words a piece
    P, KV = 4 // PW, 16 // KB  # pieces and keys a 16-byte load
    U = 4 // P  # loads a lane a warp step
    GP = 4 if KB == 8 else 2  # pieces a group of interleaved descents
    nb, kp = 2 * k, 1 << (k - 1).bit_length()
    depth = kp.bit_length() - 1
    sch = classify.schedule(KB, k, radix=upper is None)
    assert sch.warp_step == 32 * U * KV
    magic, dshift = _k7_tile_div(tile)
    lane = np.arange(32)
    load_at = (np.arange(U)[:, None] * 32 + lane) * KV  # (U, lanes), from the step's start
    piece_at = np.array([(i // P * 32 * P + 32 * (i % P) + lane) * KP for i in range(4)])
    ids = np.full((B, n), -1, np.int64)
    hist = np.full((B, n // tile, nb), -1, np.int64)
    stats = {"atomics": 0, "stores": np.zeros((B, n), np.int64),
             "flushes": np.zeros((B, n // tile), np.int64)}
    sentinel = np.iinfo(raw.dtype).max if upper is None else None

    def descend(key):  # Tree::classify: levels 0 and 1 from registers, then byte offsets
        j = np.ones(key.shape, np.int64)
        if depth >= 1:
            j = np.where(key > tree[1], 3, 2)
        if depth >= 2:
            j = 2 * j + (key > np.where(j == 3, tree[3], tree[2]))
        at = j * key.dtype.itemsize
        for _ in range(2, depth):
            node = tree.view(np.uint8)[at[..., None] + np.arange(key.dtype.itemsize)]
            at = 2 * at + (key > np.ascontiguousarray(node).view(key.dtype)[..., 0]) \
                * key.dtype.itemsize
        j = at // key.dtype.itemsize - kp
        return 2 * j + ((key == upper_row[j]) | (key == upper_row[-1]))

    def classify_keys(keys):
        if upper is None:
            ucode = keys.view(f"uint{8 * KB}")
            code = ucode ^ ucode.dtype.type(1 << (8 * KB - 1))
            bits = (code >> code.dtype.type(shift)) & code.dtype.type(k - 1)
            return 2 * bits.astype(np.int64) + (keys == sentinel)
        if KB == 1:  # the CTA's table of the 256 key values' ids
            return table[keys.view(np.uint8)]
        return descend(_k7_compare(keys, name))

    for row, t_begin, t_end in _k7_grid(B, n // tile, sch.tiles, wave):
        assert 0 <= t_begin < t_end <= n // tile  # the CTA's tiles lie in its row
        assert t_end - t_begin <= sch.tiles
        first = t_begin * tile
        size = (t_end - t_begin) * tile
        cta_bytes = raw[row, first:first + size].view(np.uint8)
        if upper is not None:
            tree, upper_row = _k7_tree(upper[row], k), upper[row]
            if KB == 1:
                values = np.arange(256, dtype=np.uint8).view(raw.dtype)
                table = descend(_k7_compare(values, name))
        s_hist = np.zeros((t_end - t_begin) * nb, np.int64)
        run = np.full((K7_WARPS, 32), -1, np.int64)
        count = np.zeros((K7_WARPS, 32), np.int64)
        for w, steps in enumerate(_k7_warp_steps(size, sch.warp_step)):
            for at0 in steps[steps >= 0]:  # the next step's loads are issued first
                at = at0 + load_at
                byte = at[..., None] * KB + np.arange(16)
                got = cta_bytes[np.minimum(byte, size * KB - 1)] * (at < size)[..., None]
                words = np.ascontiguousarray(got.astype(np.uint8)).view(np.uint32)
                pieces = np.concatenate([_k7_to_pieces(words[u][None], P)[0] for u in range(U)],
                                        -1)  # (lanes, 16 words)
                for g in range(4 // GP):
                    group = np.ascontiguousarray(pieces[:, g * GP * PW:(g + 1) * GP * PW])
                    bid = classify_keys(group.view(raw.dtype))  # (lanes, GP * KP)
                    for i in range(GP):
                        pos = at0 + piece_at[g * GP + i]  # (lanes,)
                        valid = pos < size
                        for e in range(KP):
                            ids[row, first + pos[valid] + e] = bid[valid, i * KP + e]
                            stats["stores"][row, first + pos[valid] + e] += 1
                        base = ((pos.astype(np.uint64) * np.uint64(magic)) >> np.uint64(32)
                                ) >> np.uint64(dshift)
                        assert (base[valid] == pos[valid] // tile).all()
                        for e in range(KP):
                            slot = base.astype(np.int64) * nb + bid[:, i * KP + e]
                            change = valid & (slot != run[w])
                            flush = change & (count[w] > 0)
                            np.add.at(s_hist, run[w][flush], count[w][flush])
                            stats["atomics"] += int(flush.sum())
                            run[w] = np.where(change, slot, run[w])
                            count[w] = np.where(change, 0, count[w]) + valid
        for w in range(K7_WARPS):  # the end of the warp's walk
            if (run[w] == run[w, 0]).all():  # one slot for the warp
                if count[w].sum():
                    s_hist[run[w, 0]] += count[w].sum()
                    stats["atomics"] += 1
            else:
                has = count[w] > 0
                np.add.at(s_hist, run[w][has], count[w][has])
                stats["atomics"] += int(has.sum())
        hist[row, t_begin:t_end] = s_hist.reshape(t_end - t_begin, nb)
        stats["flushes"][row, t_begin:t_end] += 1
    assert (stats["stores"] == 1).all() and (stats["flushes"] == 1).all()
    return ids.astype(np.int32), hist.astype(np.int32), stats


def _k7_keys(name: str, n: int, seed: int) -> np.ndarray:
    """Keys of kind ``name``: random bits with a heavy duplicate and the
    extremes; floats normal (the reference's CPU compares flush subnormals)
    with NaN, +-0.0, +-inf and the dtype's max."""
    np_dtype = np.dtype(K7_KINDS[name][0])
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 63, n, dtype=np.uint64, endpoint=True).astype(
        f"uint{8 * np_dtype.itemsize}")
    raw[rng.random(n) < 0.3] = raw[0]
    x = raw.view(np_dtype).copy()
    if np_dtype.kind == "f" or name == "bfloat16":
        with np.errstate(invalid="ignore"):  # NaN payloads
            f = x.astype(np.float64)
        tiny = float(ml_dtypes.finfo(np_dtype).tiny)
        odd = ~np.isfinite(f) | ((f != 0) & (np.abs(f) < tiny))
        x[odd] = rng.standard_normal(int(odd.sum())).astype(np_dtype)
        top = ml_dtypes.finfo(np_dtype).max
        x[::97], x[1::89], x[2::83] = np.nan, 0.0, -np.array(0.0, np_dtype)
        x[3::79], x[4::73], x[5::71] = np.inf, -np.inf, top
    else:
        info = np.iinfo(np_dtype)
        x[::97], x[1::89] = info.max, info.min
    return x


def _k7_splitters(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k-1 keys of x in the keyspace order (NaN last), some repeated."""
    s = np.random.default_rng(seed).choice(x, k - 1)
    return s[np.argsort(encode_np(s), kind="stable")]


def _k7_upper(spl: np.ndarray, name: str) -> np.ndarray:
    """(B, k-1) splitters -> (B, k) uppers in the compare type."""
    np_dtype = np.dtype(K7_KINDS[name][0])
    top = ml_dtypes.finfo(np_dtype).max if (np_dtype.kind == "f" or name == "bfloat16") \
        else np.iinfo(np_dtype).max
    full = np.concatenate([spl, np.full(spl.shape[:-1] + (1,), top, np_dtype)], -1)
    return _k7_compare(full, name)


# k -> (rows of 128 keys a tile, tiles a row, CTAs a wave): tiles below,
# at and above a step, a masked last step (rows = 48), one and many tiles a CTA
K7_CASES = {1: (3, 5, 2), 2: (1, 9, 3), 3: (128, 2, 5), 16: (32, 3, 1), 100: (5, 7, 4),
            128: (48, 2, 3), 256: (8, 6, 2)}


def _k7_check_tree(name: str, k: int, batched: bool = False) -> None:
    """The replay against the reference's ``classify_histogram`` (or its
    batched form over 3 rows) in interpret mode, bit for bit."""
    rows, tiles, wave = K7_CASES[k]
    tile = rows * 128
    B = 3 if batched else 1
    x = np.stack([_k7_keys(name, tiles * tile, 31 * k + b) for b in range(B)])
    spl = np.stack([_k7_splitters(x[b], k, k + b) for b in range(B)])
    ids, hist, _ = _replay_k7(x, name, _k7_upper(spl, name), k, tile, wave=wave)
    if batched:
        want = ref_classify.classify_histogram_batched(jnp.asarray(x), jnp.asarray(spl), k=k,
                                                       rows=rows, interpret=True)
    else:
        want = ref_classify.classify_histogram(jnp.asarray(x[0]), jnp.asarray(spl[0]), k=k,
                                               rows=rows, interpret=True)
        ids, hist = ids[0], hist[0]
    np.testing.assert_array_equal(ids, np.asarray(want[0]), err_msg=f"{name} k={k}")
    np.testing.assert_array_equal(hist, np.asarray(want[1]), err_msg=f"{name} k={k}")


def _k7_check_radix(bits: int, k: int, consumed: int, tile: int) -> None:
    """The replay in radix mode on the port's signed codes against the
    reference's ``radix_histogram`` on its unsigned ones."""
    rng = np.random.default_rng(k + consumed)
    signed, unsigned = np.dtype(f"int{bits}"), np.dtype(f"uint{bits}")
    code = rng.integers(np.iinfo(signed).min, np.iinfo(signed).max, 3 * tile, dtype=signed,
                        endpoint=True)
    code[::13] = np.iinfo(signed).max
    code[rng.random(code.shape[0]) < 0.3] = code[1]
    ids, hist, _ = _replay_k7(code[None], f"int{bits}", None, k, tile,
                              shift=radix_shift(k, consumed, bits))
    ref_code = code.view(unsigned) ^ unsigned.type(1 << (bits - 1))
    want = ref_classify.radix_histogram(jnp.asarray(ref_code), k=k, consumed_bits=consumed,
                                        rows=tile // 128, interpret=True)
    np.testing.assert_array_equal(ids[0], np.asarray(want[0]))
    np.testing.assert_array_equal(hist[0], np.asarray(want[1]))


@pytest.mark.parametrize("k", K7_KS)
@pytest.mark.parametrize("name", [n for n in K7_KINDS if np.dtype(K7_KINDS[n][0]).itemsize < 8])
def test_k7_replay_matches_the_reference(name, k):
    """K7's schedule replayed (16-byte loads, the shuffle transpose of 8-
    and 16-bit pieces, the padded Eytzinger tree and the interleaved
    descent keeping c, the run-merged histogram, the tile walk) on raw keys
    of the nine kinds of 32 bits or fewer, bit for bit the reference's
    ``classify_histogram`` in interpret mode at k = 1 .. 256, tiles of 128
    to 16384 keys; the 64-bit kinds in the x64 child below."""
    _k7_check_tree(name, k)


@pytest.mark.parametrize("name", ["uint8", "bfloat16", "uint32", "float32"])
def test_k7_batched_replay_matches_the_reference(name):
    """Three rows, each against its own splitters, every CTA in one row."""
    for k in (3, 100):
        _k7_check_tree(name, k, batched=True)


@pytest.mark.parametrize("k,consumed,tile", [(2, 0, 128), (16, 3, 6144), (128, 0, 4096),
                                             (256, 8, 16384)])
def test_k7_radix_replay_matches_the_reference(k, consumed, tile):
    _k7_check_radix(32, k, consumed, tile)


K7_64_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import jax
import test_torch_kernel_schedules as S

assert jax.config.jax_enable_x64
for name in ("int64", "uint64", "float64"):
    for k in S.K7_KS:
        S._k7_check_tree(name, k)
    S._k7_check_tree(name, 100, batched=True)
for k, consumed, tile in ((2, 0, 128), (16, 60, 6144), (128, 0, 4096), (256, 8, 16384)):
    S._k7_check_radix(64, k, consumed, tile)
print("K7 64 replay OK")
"""


def test_k7_64bit_replay_matches_the_reference_in_x64(x64_children):
    """K7's 64-bit form replayed (2 keys a 16-byte load and a piece, 8-byte
    id stores, 8-byte tree nodes): int64, uint64 and float64 keys at every
    k of the tree tests, batched, and radix mode on int64 codes, against
    the reference's kernels on the raw keys and uint64 codes in a child
    process with x64 enabled from startup."""
    proc = x64_children["K7"].result(timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-5000:]
    assert "K7 64 replay OK" in proc.stdout


@pytest.mark.parametrize("ctype", [np.int32, np.uint32, np.int64, np.uint64, np.float32,
                                   np.float64])
def test_k7_padded_tree_counts_the_splitters_below(ctype):
    """The padded descent's j, and eq against upper[j] and the last upper,
    give the dense compare's id for every key around every splitter at
    every k, padded or not: unsigned compared as unsigned, NaN splitters
    last, -0.0 against +0.0, +-inf, the max."""
    rng = np.random.default_rng(3)
    ctype = np.dtype(ctype)
    if ctype.kind == "f":
        pool = np.array([-np.inf, -1.5, -0.0, 0.0, 2.0, 7.0, np.finfo(ctype).max, np.inf, np.nan],
                        ctype)
        top = np.finfo(ctype).max
    else:
        info = np.iinfo(ctype)
        pool = np.array([info.min, info.min + 1, 0, 1, 5, info.max - 1, info.max], ctype)
        top = info.max
    for k in K7_KS:
        spl = np.sort(rng.choice(pool, k - 1))  # numpy sorts NaN last
        upper = np.append(spl, top).astype(ctype)
        tree, kp = _k7_tree(upper, k), 1 << (k - 1).bit_length()
        keys = np.concatenate([pool, upper])
        j = np.ones(keys.shape, np.int64)
        for _ in range(kp.bit_length() - 1):
            j = 2 * j + (keys > tree[j])
        dense_j = (keys[:, None] > upper[None, :-1]).sum(1)
        dense_eq = (keys[:, None] == upper[None, :]).any(1)
        np.testing.assert_array_equal(j - kp, dense_j)
        np.testing.assert_array_equal((keys == upper[j - kp]) | (keys == upper[-1]), dense_eq)


def test_k7_shuffle_transpose_puts_consecutive_pieces_on_consecutive_lanes():
    """After ``to_pieces`` lane l of a warp holds pieces l, 32 + l, ... of
    its block: the warp's stores of piece q cover 32 consecutive pieces."""
    for P in (1, 2, 4):
        words = np.arange(8 * 32 * 4, dtype=np.uint32).reshape(8, 32, 4)  # word = its index
        got = _k7_to_pieces(words, P)
        PW = 4 // P
        for q in range(P):
            piece = 32 * q + np.arange(32)  # of the warp's block
            first_word = (np.arange(8)[:, None] * 128 + piece[None, :] * PW)
            for e in range(PW):
                np.testing.assert_array_equal(got[..., q * PW + e], first_word + e)


@pytest.mark.parametrize("B", [1, 3, 64])
def test_k7_tile_walk_takes_every_tile_once(B):
    """Every tile of every row is taken by exactly one CTA, in one row, and
    its keys by exactly one warp step, at every key width, k = 3 and 256
    (4096 and 32 tiles' histograms a CTA), tiles of 128 to 16384 keys and
    waves of 1 to 396 CTAs; a CTA never holds more tiles than its
    histograms, and the division by the tile is exact."""
    for key_bytes in (1, 2, 4, 8):
        for k in (3, 256):
            sch = classify.schedule(key_bytes, k)
            for tile in (128, 384, 4096, 6144, 16384):
                magic, shift = _k7_tile_div(tile)
                tiles = 5
                for wave in (1, 7, 132 * 3):
                    seen = np.zeros((B, tiles * tile), np.int64)
                    ctas = np.zeros((B, tiles), np.int64)
                    for row, t_begin, t_end in _k7_grid(B, tiles, sch.tiles, wave):
                        assert 0 <= t_begin < t_end <= tiles and t_end - t_begin <= sch.tiles
                        ctas[row, t_begin:t_end] += 1
                        size = (t_end - t_begin) * tile
                        for at0 in _k7_warp_steps(size, sch.warp_step).ravel():
                            if at0 >= 0:
                                end = min(at0 + sch.warp_step, size)
                                seen[row, t_begin * tile + at0:t_begin * tile + end] += 1
                        x = np.arange(0, size, 4, dtype=np.uint64)
                        np.testing.assert_array_equal(
                            ((x * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift),
                            x // np.uint64(tile))
                    assert (seen == 1).all() and (ctas == 1).all()


def test_k7_tile_division_is_exact():
    """The kernel's division by the tile (a multiple of 128 keys) is exact
    for every position of a row: at the tiles' edges and up to 2^31 - 1."""
    rng = np.random.default_rng(1)
    for rows in list(range(1, 300)) + [1000, 4096, (1 << 16) - 1, (1 << 24) - 1]:
        tile = rows * 128
        magic, shift = _k7_tile_div(tile)
        assert 0 < magic < 1 << 32
        edges = np.arange(1, (2**31 - 1) // tile + 1, max(1, (2**31 // tile) // 64)) * tile
        x = np.concatenate([edges - 1, edges, [0, 1, 2**31 - 1],
                            rng.integers(0, 2**31, 256)]).astype(np.uint64)
        got = ((x * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)
        np.testing.assert_array_equal(got, x // np.uint64(tile))


@pytest.mark.parametrize("case", ["all equal", "sorted", "one splitter", "random"])
def test_k7_histogram_merges_runs(case):
    """The histogram's atomics: runs of one (tile, id) merge in each lane's
    registers from step to step, so all-equal keys, or keys equal to one
    splitter, take one atomic a tile a lane (a run ends where the tile
    does) and one a warp at its end (its one slot); sorted keys at most one
    a piece of 4, random keys about one a key.  The counts stay the
    reference's."""
    k, tile, n = 128, 4096, 3 * 4096
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n).astype(np.float32)
    spl = np.sort(rng.choice(x, k - 1))
    if case == "all equal":
        x[:] = 0.25
    elif case == "sorted":
        x = np.sort(x)
    elif case == "one splitter":
        x[:] = spl[k // 2]
    ids, hist, stats = _replay_k7(x[None], "float32", _k7_upper(spl[None], "float32"), k, tile)
    want = ref_classify.classify_histogram(jnp.asarray(x), jnp.asarray(spl), k=k,
                                           rows=tile // 128, interpret=True)
    np.testing.assert_array_equal(ids[0], np.asarray(want[0]))
    np.testing.assert_array_equal(hist[0], np.asarray(want[1]))
    if case == "random":
        assert stats["atomics"] > n // 2
    elif case == "sorted":  # at most one a piece of 4 keys, and one a bucket's edge
        assert stats["atomics"] <= n // 4 + 2 * k
    else:  # 3 tiles, 1 CTA: runs end at the tiles' edges, one warp atomic at the end
        assert stats["atomics"] <= 2 * K7_WARPS * 32 + K7_WARPS


def test_k7_schedule_and_shared_memory():
    """K7's CTA at every key width and k: 256 threads, a warp step of 512
    keys (256 of 64 bits), the histograms of as many tiles as 32 KB hold
    (one at least) beside the padded tree, the k uppers and, for 8-bit
    keys, the table of the 256 key values' ids; within a CTA's 227 KB up
    to k = 8192."""
    assert classify.schedule(4, 128) == (256, 512, 32, (128 + 128) * 4 + 32 * 256 * 4)
    assert classify.schedule(8, 3) == (256, 256, 1365, (4 + 3) * 8 + 1365 * 6 * 4)
    assert classify.schedule(1, 3).smem_bytes == (4 + 3) * 4 + 1024 + 1365 * 6 * 4
    assert classify.schedule(1, 8192).tiles == 1
    assert classify.schedule(4, 100, radix=True).smem_bytes == 40 * 200 * 4
    for key_bytes in (1, 2, 4, 8):
        for k in (1, 2, 3, 16, 100, 128, 256, 1000, 4096, 8192):
            sch = classify.schedule(key_bytes, k)
            assert sch.threads == classify.THREADS == 32 * K7_WARPS
            assert sch.warp_step == 32 * 4 * (2 if key_bytes == 8 else 4)
            assert sch.tiles == max(1, 32 * 1024 // (8 * k))
            kp = 1 << (k - 1).bit_length()
            want = ((kp + k) * (8 if key_bytes == 8 else 4) + (1024 if key_bytes == 1 else 0)
                    + sch.tiles * 2 * k * 4)
            assert sch.smem_bytes == want <= 232_448


# ---- G1-G4, the sort's glue (csrc/glue.cu) ----------------------------------

G_THREADS, G_PER = 256, 16  # a CTA of G2/G3: 256 threads of 16 positions
G_SPAN = G_THREADS * G_PER
G_STAGE_OFFSETS, G_STAGE_SPLIT_BYTES, G_GROUPS = 2048, 16384, 1024


def _g_warp_count_le(off, p):
    """The glue kernels' warp search: the count of the nondecreasing off
    that are <= p, 32 probes a step, the gap between the last true and the
    first false probe kept (4 steps at 65,793 offsets).  Returns (count,
    steps)."""
    lo, hi, steps = 0, off.shape[0], 0
    lanes = np.arange(32)
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        idx = lo + lanes * step
        le = (idx < hi) & (off[np.minimum(idx, off.shape[0] - 1)] <= p)
        c = int(le.sum())
        assert (le == (lanes < c)).all()  # the ballot is a prefix
        steps += 1
        if c == 0:
            return lo, steps
        lo, hi = lo + (c - 1) * step + 1, min(hi, lo + c * step)
    idx = lo + lanes
    le = (idx < hi) & (off[np.minimum(idx, off.shape[0] - 1)] <= p)
    return lo + int(le.sum()), steps + 1


def _g_counts(slice_, targets):
    """Each target's count of the nondecreasing slice that are <= it, by the
    kernels' branchless search from the largest power of two down."""
    n_ = slice_.shape[0]
    c = np.zeros(targets.shape, np.int64)
    step = 1 << (n_.bit_length() - 1) if n_ else 0
    while step:
        q = c + step
        ok = q <= n_
        c = np.where(ok & (slice_[np.clip(q - 1, 0, max(n_ - 1, 0))] <= targets), q, c)
        step >>= 1
    return c


def _replay_g_span(off, n, p0):
    """A G2/G3 CTA's view of its span [p0, p1) of a row: the row's offsets
    staged whole when they fit (two searches there), else the two warps'
    counts; the slice between; each position's segment."""
    p1 = min(p0 + G_SPAN, n)
    if off.shape[0] <= G_STAGE_OFFSETS:
        c_lo, c_hi, s1, s2 = int(np.sum(off <= p0)), int(np.sum(off <= p1 - 1)), 0, 0
    else:
        c_lo, s1 = _g_warp_count_le(off, p0)
        c_hi, s2 = _g_warp_count_le(off, p1 - 1)
    slice_ = off[c_lo:c_hi]  # staged up to G_STAGE_OFFSETS; else read in place, the same values
    p = np.arange(p0, p1)
    return p, c_lo + _g_counts(slice_, p) - 1, c_lo, len(slice_), max(s1, s2)


def _replay_g2(off, n):
    out, longest, most = np.empty(n, np.int64), 0, 0
    for p0 in range(0, n, G_SPAN):
        p, seg, _, len_, steps = _replay_g_span(off, n, p0)
        out[p] = seg
        longest, most = max(longest, len_), max(most, steps)
    return out, longest, most


def _g_offsets(rng, n, nb, case):
    cuts = np.sort(rng.integers(0, n + 1, nb - 1))
    if case == "span edges":  # buckets ending exactly on the spans' edges
        cuts[: min(nb - 1, n // G_SPAN)] = np.arange(1, min(nb - 1, n // G_SPAN) + 1) * G_SPAN
        cuts = np.sort(cuts)
    elif case == "many empty":  # more starts in one span than the stage holds
        cuts[: 3000] = G_SPAN + 7
        cuts = np.sort(cuts)
    elif case == "empty ends":
        cuts[: nb // 4] = 0
        cuts[-(nb // 4):] = n
    return np.concatenate([[0], cuts, [n]]).astype(np.int32)


@pytest.mark.parametrize("n,nb,case", [(3 * G_SPAN + 77, 257, "random"),
                                       (5 * G_SPAN, 65_792, "random"),
                                       (4 * G_SPAN, 9, "span edges"),
                                       (3 * G_SPAN, 5000, "many empty"),
                                       (2 * G_SPAN + 1, 40, "empty ends"),
                                       (100, 1, "random")])
def test_g2_span_search_matches_the_reference(n, nb, case):
    """G2's spans: the warp's counts (at most 4 steps at level 2's 65,793
    offsets), the slice between them (staged up to 2048, past it read in
    place) and each position's branchless count, against the reference's
    ``segment_ids``: spans crossing bucket edges, ending on them, and
    holding more bucket starts than the stage."""
    from repro.core.ips4o import segment_ids as ref_segment_ids

    off = _g_offsets(np.random.default_rng(nb), n, nb, case)
    got, longest, steps = _replay_g2(off, n)
    np.testing.assert_array_equal(got, np.asarray(ref_segment_ids(jnp.asarray(off), n)))
    assert steps <= (4 if nb + 1 <= 65_793 else 5)
    if case == "many empty":
        assert longest > G_STAGE_OFFSETS  # the span that searches in device memory


def _replay_g3(keys, off, spl, k, shift=None, bits=32):
    """G3 over one row: the span's segments, their splitters staged when they
    fit 16 KB, each key's branchless count below its segment's sorted
    splitters, eq against the upper (the sentinel last); or the radix bits
    at ``shift``.  Returns (ids, whether every span staged its splitters)."""
    n = keys.shape[0]
    num_seg = off.shape[0] - 1
    per = k - 1
    out = np.empty(n, np.int64)
    all_staged = True
    kmax = np.iinfo(keys.dtype).max
    for p0 in range(0, n, G_SPAN):
        p, seg, c_lo, len_, _ = _replay_g_span(off, n, p0)
        key = keys[p]
        if shift is not None:
            code = key.astype(np.int64).view(np.uint64) ^ np.uint64(1 << (bits - 1)) \
                if bits == 64 else (key.view(np.uint32) ^ np.uint32(1 << 31)).astype(np.uint64)
            local = 2 * ((code >> np.uint64(shift)) & np.uint64(k - 1)).astype(np.int64) + \
                (key == kmax)
        else:
            g_lo = min(max(c_lo - 1, 0), num_seg - 1)
            g_hi = min(max(c_lo + len_ - 1, 0), num_seg - 1)
            staged = (g_hi - g_lo + 1) * per * keys.itemsize <= G_STAGE_SPLIT_BYTES
            all_staged &= staged
            flat = spl.reshape(-1)
            at = (np.clip(seg, 0, num_seg - 1)) * per  # staged: the same entries, rebased
            j = np.zeros(len(p), np.int64)
            step = k >> 1
            while step:
                j += np.where(flat[at + j + step - 1] < key, step, 0)
                step >>= 1
            up = np.where(j < per, flat[np.minimum(at + j, flat.shape[0] - 1)], kmax)
            local = 2 * j + (key == up)
        out[p] = seg * 2 * k + local
    return out, all_staged


@pytest.mark.parametrize("k,num_seg,n,staged", [(2, 3, 9000, True),
                                                (16, 300, 3 * G_SPAN + 5, True),
                                                (128, 33, 2 * G_SPAN, True),
                                                (128, 400, G_SPAN, False)])
def test_g3_replay_matches_the_reference(k, num_seg, n, staged):
    """G3's descent per segment, the splitters staged per span (or read in
    place where a span's segments hold more than 16 KB of them), keys on
    the splitters and the sentinel, an empty last segment, against
    ``seg * 2k + classify_segmented``."""
    from repro.classify.tree import classify_segmented as ref_classify_segmented
    from repro.core.ips4o import segment_ids as ref_segment_ids

    rng = np.random.default_rng(k + num_seg)
    off = _g_offsets(rng, n, num_seg, "random")
    off[-2] = n
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    spl = np.sort(rng.choice(u, (num_seg, k - 1)).astype(np.uint32), axis=1)
    u[1::7] = spl.reshape(-1)[np.arange(len(u[1::7])) % spl.size]
    u[2::11] = np.uint32(0xFFFFFFFF)
    keys = (u ^ SIGN).view(np.int32)
    got, all_staged = _replay_g3(keys, off, (spl ^ SIGN).view(np.int32), k)
    seg = np.asarray(ref_segment_ids(jnp.asarray(off), n))
    want = seg * 2 * k + np.asarray(ref_classify_segmented(jnp.asarray(u), jnp.asarray(seg),
                                                           jnp.asarray(spl), k))
    np.testing.assert_array_equal(got, want)
    assert all_staged == staged  # 400 segments of 127 splitters in one span: read in place


@pytest.mark.parametrize("k,consumed", [(2, 0), (128, 7)])
def test_g3_radix_replay_matches_the_reference(k, consumed):
    rng = np.random.default_rng(k)
    n = 2 * G_SPAN + 3
    off = _g_offsets(rng, n, 9, "random")
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[::13] = np.uint32(0xFFFFFFFF)
    keys = (u ^ SIGN).view(np.int32)
    got, _ = _replay_g3(keys, off, None, k, shift=radix_shift(k, consumed))
    seg = (np.searchsorted(off, np.arange(n), side="right") - 1)
    want = seg * 2 * k + np.asarray(ref_radix_bucket_ids(jnp.asarray(u), k, consumed))
    np.testing.assert_array_equal(got, want)


def _replay_g1(bucket, rank, hist, nb, tile, run_tiles=16):
    """G1's three kernels over (B, n): each run's column sums (its block of
    the histogram read flat, a bucket by f % nb), the scan down the runs by
    (32 buckets, 32 stretches) teams, and the place per tile (the offsets by
    a scan of the totals in passes of 256, the base row from the run's
    prefix and the run's earlier tiles)."""
    B, n = bucket.shape
    tiles = -(-n // tile)
    runs = -(-tiles // run_tiles)
    part = np.zeros((B, runs, nb), np.int64)
    for r in range(runs):
        block = hist[:, r * run_tiles:(r + 1) * run_tiles].reshape(B, -1)
        f = np.arange(block.shape[1])
        for row in range(B):
            np.add.at(part[row, r], f % nb, block[row])
    totals = np.zeros((B, nb), np.int64)
    per = -(-runs // 32)
    for row in range(B):
        for b in range(nb):
            acc = [part[row, y * per:(y + 1) * per, b].sum() for y in range(32)]
            pre = np.concatenate([[0], np.cumsum(acc)[:-1]])
            totals[row, b] = sum(acc)
            for y in range(32):
                run = pre[y]
                for r in range(y * per, min((y + 1) * per, runs)):
                    part[row, r, b], run = run, run + part[row, r, b]
    dest = np.empty((B, n), np.int64)
    offsets = np.empty((B, nb + 1), np.int64)
    for row in range(B):
        off = np.empty(nb + 1, np.int64)
        carry = 0
        for b0 in range(0, nb, G_THREADS):
            t_ = totals[row, b0:b0 + G_THREADS]
            off[b0:b0 + len(t_)] = carry + np.cumsum(t_) - t_
            carry += t_.sum()
        off[nb] = carry
        offsets[row] = off
        for t in range(tiles):
            r = t // run_tiles
            base = off[:nb] + part[row, r] + hist[row, r * run_tiles:t].sum(0)
            sl = slice(t * tile, min((t + 1) * tile, n))
            dest[row, sl] = base[bucket[row, sl]] + rank[row, sl]
    return dest, offsets


@pytest.mark.parametrize("B,n,tile,nb", [(1, 70 * 64, 64, 9), (2, 40 * 33 + 5, 33, 300),
                                         (3, 1000, 1000, 3)])
def test_g1_replay_matches_the_reference(B, n, tile, nb):
    """G1 on tile histograms with runs past 32 stretches (70 tiles), nb above
    a pass of the scan (300 buckets), a ragged last tile and one tile,
    against the reference's ``_close_placement`` per row."""
    from repro.kernels.level_fused import _close_placement as ref_close_placement

    rng = np.random.default_rng(n)
    bucket = rng.integers(0, nb, (B, n))
    bucket[:, : n // 3] = nb // 2
    tiles = -(-n // tile)
    rank = np.zeros((B, n), np.int64)
    hist = np.zeros((B, tiles, nb), np.int64)
    for row in range(B):
        for t in range(tiles):
            seg = bucket[row, t * tile:(t + 1) * tile]
            for b in np.unique(seg):
                sel = np.nonzero(seg == b)[0]
                rank[row, t * tile + sel] = np.arange(len(sel))
                hist[row, t, b] = len(sel)
    dest, offsets = _replay_g1(bucket, rank, hist, nb, tile)
    for row in range(B):
        want_dest, want_off = ref_close_placement(
            jnp.asarray(bucket[row], jnp.int32), jnp.asarray(rank[row], jnp.int32),
            jnp.asarray(hist[row], jnp.int32), nb, tile)
        np.testing.assert_array_equal(dest[row], np.asarray(want_dest))
        np.testing.assert_array_equal(offsets[row], np.asarray(want_off))


G_MOVE_THREADS = 512  # a CTA of G4's scatter and gather


def _g4_quad_rows(span):
    """A scatter CTA's rows: thread t holds R = span / 512 rows, quads of four
    consecutive rows, quad j at 4 (j 512 + t) (csrc/glue.cu ``span_quad``)."""
    R = span // G_MOVE_THREADS
    t, i = np.arange(G_MOVE_THREADS)[:, None], np.arange(R)[None, :]
    return 4 * ((i >> 2) * G_MOVE_THREADS + t) + (i & 3)


def _g4_units(a, unit):
    """A (B, n, row bytes) uint8 tensor as (B, n, w) units of ``unit`` bytes."""
    return a.view(np.dtype(f"V{unit}"))


G4_TABLE_LOG = 11  # the scatter's lookup table: 2^11 cells (kTableLog)


def _g4_table_groups(slice_, d, lo, cells):
    """Each destination's group, the count of the span's offsets ``slice_``
    that are <= it, by the kernel's lookup table over [lo, lo + cells): cells
    of 2^shift positions, tab[c] the offsets below cell c's first position
    (a histogram of the offsets' cells + 1 and its inclusive scan), then a
    search of the offsets in the destination's cell alone."""
    n_cells = 1 << G4_TABLE_LOG
    shift = max(0, int(cells - 1).bit_length() - G4_TABLE_LOG) if cells > n_cells else 0
    v = slice_.astype(np.int64)
    where = np.where(v < lo, 0, np.minimum(((v - lo) >> shift) + 1, n_cells + 1))
    tab = np.cumsum(np.bincount(where, minlength=n_cells + 2))[: n_cells + 1]
    c = np.clip((d - lo) >> shift, 0, n_cells - 1)
    g, more = tab[c], tab[c + 1] - tab[c]
    assert (((d - lo) >> shift) < n_cells).all() and more.max(initial=0) <= max(1, v.shape[0])
    return g + np.array([int((slice_[a:a + k] <= x).sum()) if k else 0
                         for a, k, x in zip(g, more, d)], np.int64)


def _replay_g4_scatter(arrays, dest, offsets, rng):
    """G4's scatter over (B, n) row-local ``dest`` and every (B, n, row
    bytes) uint8 tensor of ``arrays`` in one launch (one table), span by
    span of :data:`glue.SCATTER_SPAN` source rows: the span's destinations and the check that they lie in [0, n); its groups
    (the row's offsets whole up to G_GROUPS, else between the two warp
    counts of its least and greatest destination, after the check that
    those lie ``glue.ROW_WINDOW_BYTES`` of the widest row apart or more);
    each row's group by the
    lookup table (:func:`_g4_table_groups`, held to the branchless search of
    all the offsets) and its place in the group by a shared atomic count,
    in an order of the atomics' own (drawn from ``rng``); a scan of the
    counts, each group's first slot; each slot's row (16 bits) and
    destination; every tensor's rows staged as they are, in chunks of units
    (an item each), and written out slot by slot, the slot's row to the
    slot's destination.  A span whose destinations leave [0, n), that
    spans G_GROUPS buckets or more, or whose destinations lie closer than
    that window moves row by row.  Returns (outputs,
    spans staged, spans row by row, and for each staged span the breaks in
    the runs of destinations that its groups' slots hold: none for a stable
    placement, whose group's slots hold one run, so that a warp's 32 slots
    store into one or two runs)."""
    from repro_torch.kernels import glue

    B, n = dest.shape
    rb = {name: a.shape[2] for name, a in arrays.items()}
    span = glue.SCATTER_SPAN
    assert sorted(_g4_quad_rows(span).ravel()) == list(range(span))  # the threads' rows
    plans = {name: glue.stage_plan(rb[name], span, 0, 0) for name in arrays}
    stage_bytes = max(span * u * c for u, c in plans.values())
    assert stage_bytes <= glue.STAGE_BYTES
    src = {name: _g4_units(a, plans[name][0]) for name, a in arrays.items()}
    out = {name: np.zeros_like(a) for name, a in arrays.items()}
    dst = {name: _g4_units(o, plans[name][0]) for name, o in out.items()}
    staged_spans, rowwise, runs = 0, 0, []
    for row in range(B):
        for p0 in range(0, n, span):
            d = dest[row, p0:p0 + span].astype(np.int64)
            here = d.shape[0]
            staged = offsets is not None and bool(((d >= 0) & (d < n)).all())
            if staged:
                off = offsets[row].astype(np.int64)
                if off.shape[0] > G_GROUPS:
                    window = glue.ROW_WINDOW_BYTES // max(rb.values())
                    c_lo, _ = _g_warp_count_le(off, int(d.min()))
                    c_hi, _ = _g_warp_count_le(off, int(d.max()))
                    staged = int(d.max() - d.min()) >= window and c_hi - c_lo < G_GROUPS
                else:
                    c_lo, c_hi = 0, off.shape[0] - 1
                    staged = c_hi - c_lo < G_GROUPS
            if not staged:
                ok = (d >= 0) & (d < n)
                for name in arrays:
                    dst[name][row, d[ok]] = src[name][row, p0 + np.nonzero(ok)[0]]
                rowwise += 1
                continue
            whole = off.shape[0] <= G_GROUPS  # the table over [0, n), else the span's range
            g = _g4_table_groups(off[c_lo:c_hi], d, 0 if whole else int(d.min()),
                                 n if whole else int(d.max() - d.min()) + 1)
            np.testing.assert_array_equal(g, _g_counts(off[c_lo:c_hi], d))
            cnt = np.bincount(g, minlength=c_hi - c_lo + 1)
            place = np.empty(here, np.int64)
            for grp in np.unique(g):  # the atomics hand out 0 .. count-1 in some order
                rows_g = np.nonzero(g == grp)[0]
                place[rows_g] = rng.permutation(rows_g.shape[0])
            first = np.cumsum(cnt) - cnt
            slot = first[g] + place
            assert sorted(slot) == list(range(here)) and place.max() < 1 << 16
            row_of = np.empty(here, np.int64)  # the slot's row, 16 bits in the kernel
            row_of[slot] = np.arange(here)
            to = np.empty(here, np.int64)
            to[slot] = d
            for name in arrays:
                unit, chunk = plans[name]
                w = src[name].shape[2]
                for c0 in range(0, w, chunk):  # an item: the span's rows as they are
                    cw = min(chunk, w - c0)
                    stage = src[name][row, p0:p0 + here, c0:c0 + cw].copy()
                    assert stage.nbytes <= stage_bytes
                    dst[name][row, to, c0:c0 + cw] = stage[row_of]
            staged_spans += 1
            breaks = 0  # in the destinations a group's slots hold, past one run
            for grp in np.nonzero(cnt)[0]:
                breaks += int((np.diff(np.sort(to[first[grp]:first[grp] + cnt[grp]])) != 1).sum())
            runs.append(breaks)
    return out, staged_spans, rowwise, runs


def _g4_placement(ids, nb):
    """The stable placement of each row's bucket ids: (dest, offsets)."""
    B, n = ids.shape
    dest = np.empty((B, n), np.int32)
    off = np.zeros((B, nb + 1), np.int32)
    for r in range(B):
        order = np.argsort(ids[r], kind="stable")
        dest[r, order] = np.arange(n)
        off[r, 1:] = np.cumsum(np.bincount(ids[r], minlength=nb))
    return dest, off


def _g4_case(case, rng):
    """(dest (B, n), offsets or None, row widths in bytes) of a scatter case."""
    from repro_torch.kernels.level_fused import level_fused_plain

    n = 1 << 16
    if case.startswith("level 1") or case == "not a placement":
        k = 16
        u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        keys = torch.as_tensor((u ^ SIGN).view(np.int32))
        spl = torch.sort(keys[torch.as_tensor(rng.integers(0, n, 256))]).values[
            torch.arange(1, k) * 256 // k]
        d1, off1 = (x.numpy()[None] for x in level_fused_plain(keys, spl, k=k))
        if case == "not a placement":  # a permutation: every span fails the runs check
            return rng.permutation(n).astype(np.int32)[None], off1, (4, 8)
        return d1, off1, (4, 4) if case == "level 1, 4-byte rows" else (4, 4, 12)
    if case == "level 2":  # 1280 buckets within 4 segments of ~32K rows: the groups searched
        seg = np.sort(rng.integers(0, 4, 2 * n))
        ids = (seg * 320 + rng.integers(0, 320, 2 * n))[None]
        return (*_g4_placement(ids, 4 * 320), (8, 4))
    if case == "sorted keys":  # 257 buckets of sorted ids: a span's rows in one or two groups
        ids = np.sort(rng.integers(0, 257, n))[None]
        return (*_g4_placement(ids, 257), (4, 4))
    if case == "short windows":  # 2112 buckets within 33 segments of ~2000 rows
        seg = np.sort(rng.integers(0, 33, n))
        ids = (seg * 64 + rng.integers(0, 64, n))[None]
        return (*_g4_placement(ids, 33 * 64), (8, 4))
    if case == "many groups":  # 5000 buckets over n / 2: more than G_GROUPS a span
        ids = rng.integers(0, 5000, (1, n // 2))
        return (*_g4_placement(ids, 5000), (1, 2, 16))
    if case == "rows":  # B rows, unit widths 1-16 and a 20-byte row in two chunks
        ids = rng.integers(0, 257, (3, (1 << 14) + 40))
        return (*_g4_placement(ids, 257), (1, 2, 4, 8, 16, 20))
    assert case == "no offsets"
    return np.stack([rng.permutation(5000) for _ in range(2)]).astype(np.int32), None, (4, 12)


@pytest.mark.parametrize("case", ["level 1", "level 1, 4-byte rows", "level 2", "short windows",
                                  "sorted keys", "not a placement", "many groups", "rows",
                                  "no offsets"])
def test_g4_scatter_replay_matches_the_reference(case):
    """The scatter's span and slot arithmetic over a table of tensors, on
    K1's level-1 placement (one run a bucket of a span), a level-2 placement
    of 1280 buckets in segments of ~32K rows (groups between two warp
    searches), one of 2112 buckets
    in segments of ~2000 rows (destinations closer than the window: row by
    row), one of 257 buckets over sorted ids (a span's rows in one or two
    groups, planned: a row of 258 offsets is not searched for a window),
    a permutation that
    is no placement of the offsets (staged all the same: each slot carries
    its row's destination), 5000 buckets (more than kScatterGroups a span:
    row by row), three rows with unit widths 1-16 and a 20-byte row staged
    in two chunks, and no offsets (row by row), against ``.at[dest].set``
    of every tensor, whatever order the atomics hand out places in."""
    from repro_torch.kernels import glue

    rng = np.random.default_rng(3)
    dest, offsets, widths = _g4_case(case, rng)
    B, n = dest.shape
    arrays = {f"{w}B #{i}": rng.integers(0, 256, (B, n, w), dtype=np.uint8)
              for i, w in enumerate(widths)}
    got, staged, rowwise, runs = _replay_g4_scatter(arrays, dest, offsets, rng)
    flat = (dest.astype(np.int64) + np.arange(B)[:, None] * n).reshape(-1)
    for name, a in arrays.items():
        want = jnp.zeros((B * n, a.shape[2]), jnp.uint8).at[flat].set(a.reshape(B * n, -1))
        np.testing.assert_array_equal(got[name].reshape(B * n, -1), np.asarray(want))
    span = glue.SCATTER_SPAN
    spans = B * -(-n // span)
    if case in ("many groups", "no offsets", "short windows"):
        assert staged == 0 and rowwise == spans
    else:
        assert staged == spans and rowwise == 0
    if case.startswith("level") or case in ("rows", "sorted keys"):  # one run a group
        assert max(runs) == 0
    if case == "not a placement":
        assert min(runs) > span // 2


def _replay_g4_gather(arrays, perm, lo, out, ctas, rng):
    """G4's gather over (B, n, row bytes) uint8 tensors (``out`` the arrays
    themselves for pass two in place): each of ``ctas`` persistent CTAs
    walks its items (its windows q = cta + i ctas, every tensor and chunk of
    :func:`glue.gather_plan` of each) with two stages: item i+1 is loaded
    (into the other stage) before item i is stored; the CTAs' steps
    interleave at random.  A load copies the item's units of
    the window's rows into the stage, a store writes them out by the
    window's permutation; a stage is never loaded over before it was
    written out, and never holds more than STAGE_BYTES."""
    from repro_torch.kernels import glue

    names = list(arrays)
    B, n = arrays[names[0]].shape[:2]
    num_w, W = perm.shape
    per_row = num_w // B
    plans = {name: glue.gather_plan(a.shape[2], W, 0, 0) for name, a in arrays.items()}
    src = {name: _g4_units(a, plans[name][0]) for name, a in arrays.items()}
    res = {name: (arrays[name].copy() if out is None else out[name]) for name in names}
    dst = {name: _g4_units(res[name], plans[name][0]) for name in names}

    def items(cta):
        for q in range(cta, num_w, ctas):
            for name in names:
                w, chunk = src[name].shape[2], plans[name][1]
                for c0 in range(0, w, chunk):
                    yield q, name, c0, min(chunk, w - c0)

    def program(cta):
        its = list(items(cta))
        if not its:
            return
        yield "load", its[0], 0
        for i, it in enumerate(its):
            if i + 1 < len(its):
                yield "load", its[i + 1], (i + 1) & 1
            yield "store", it, i & 1

    progs = [program(c) for c in range(ctas)]
    bufs = [[None, None] for _ in range(ctas)]
    while progs:
        c = int(rng.integers(len(progs)))
        step = next(progs[c], None)
        if step is None:
            progs.pop(c)
            bufs.pop(c)
            continue
        op, (q, name, c0, cw), b = step
        row = q // per_row
        first = lo + (q - row * per_row) * W
        if op == "load":
            assert bufs[c][b] is None  # its last item written out
            stage = src[name][row, first:first + W, c0:c0 + cw].copy()
            assert stage.nbytes <= glue.STAGE_BYTES
            bufs[c][b] = ((q, name, c0), stage)
        else:
            held, stage = bufs[c][b]
            assert held == (q, name, c0)
            dst[name][row, first:first + W, c0:c0 + cw] = stage[perm[q]]
            bufs[c][b] = None
    return res


@pytest.mark.parametrize("widths,W,B,limit", [((4,), 8192, 1, None), ((4, 4, 12), 8192, 1, None),
                                              ((16, 8), 16384, 1, None),
                                              ((1, 2, 100), 256, 1, None),
                                              ((8,), 8192, 2, None),
                                              ((4, 12), 256, 2, 3 * 256)])
def test_g4_gather_replay_matches_the_reference(widths, W, B, limit):
    """The window gather's items over a table of tensors (rows of 1 to 100
    bytes, the plan's units and chunks), B rows and a ``limit``, both
    passes (pass two in place) with two stages a CTA and 1 or 3 CTAs whose
    steps interleave at random, against the reference's
    ``_apply_window_perm`` of every tensor."""
    from repro.core.ips4o import _apply_window_perm as ref_apply_window_perm

    rng = np.random.default_rng(sum(widths) + W + B)
    n = 4 * W
    m_all = n if limit is None else limit
    arrays = {f"{w}B #{i}": rng.integers(0, 256, (B, n, w), dtype=np.uint8)
              for i, w in enumerate(widths)}

    def reference(a, perm, lo, per):
        want = a.copy()
        for r in range(B):
            win = want[r, lo:lo + per * W].reshape(per, W, -1)
            want[r, lo:lo + per * W] = np.asarray(ref_apply_window_perm(
                jnp.asarray(perm[r * per:(r + 1) * per]), jnp.asarray(win))).reshape(per * W, -1)
        return want

    for ctas in (3, 1):
        # pass one: windows at 0 (into new tensors, or into copies up to limit)
        per = m_all // W
        perm = np.stack([rng.permutation(W) for _ in range(B * per)]).astype(np.int32)
        outs = None if limit is None else {k: a.copy() for k, a in arrays.items()}
        one = _replay_g4_gather(arrays, perm, 0, outs, ctas, rng)
        for name, a in arrays.items():
            np.testing.assert_array_equal(one[name], reference(a, perm, 0, per))
        # pass two: windows at W/2, in place
        per = (m_all - W) // W
        perm = np.stack([rng.permutation(W) for _ in range(B * per)]).astype(np.int32)
        want = {name: reference(a, perm, W // 2, per) for name, a in one.items()}
        two = _replay_g4_gather(one, perm, W // 2, one, ctas, rng)
        for name in arrays:
            assert two[name] is one[name]
            np.testing.assert_array_equal(two[name], want[name])


# ---- G6: the levels' samples -----------------------------------------------


def _g6_bitonic(vals: np.ndarray) -> np.ndarray:
    """The kernel's network over P (a power of two) values in shared memory:
    stage (size, stride), pair t's lower index 2t - (t & (stride - 1)), the
    direction ascending where (i & size) == 0, a swap when (a > b) equals it."""
    s = vals.copy()
    P = s.shape[0]
    t = np.arange(P // 2)
    size = 2
    while size <= P:
        stride = size >> 1
        while stride:
            i = 2 * t - (t & (stride - 1))
            j = i + stride
            a, b = s[i], s[j]
            swap = (a > b) == ((i & size) == 0)
            s[i], s[j] = np.where(swap, b, a), np.where(swap, a, b)
            stride >>= 1
        size <<= 1
    return s


def _replay_g6(keys: np.ndarray, draw: np.ndarray, k: int, seg_off=None):
    """G6, one CTA a (row, segment): the positions (level 1 the drawn ones;
    level 2 lo + floor(u * float32(max(hi - lo, 1))) in float32, clamped to
    [lo, max(hi - 1, lo)] and to the row), the keys there padded to P with
    the max, the network, and the picks clip(j m // k, 0, m - 1), with the
    upper form's sentinel last."""
    B, n = keys.shape
    S = 1 if seg_off is None else draw.shape[1]
    m = draw.shape[-1]
    P = 1 << (m - 1).bit_length()
    top = np.iinfo(keys.dtype).max
    spl = np.empty((B, S, k - 1), keys.dtype)
    for r in range(B):
        for s in range(S):
            if seg_off is None:
                p = draw[r].astype(np.int64)
            else:
                lo, hi = int(seg_off[r, s]), int(seg_off[r, s + 1])
                f = draw[r, s].astype(np.float32) * np.float32(max(hi - lo, 1))
                assert f.dtype == np.float32
                p = lo + np.floor(f).astype(np.int64)
                p = np.minimum(np.minimum(np.maximum(p, lo), max(hi - 1, lo)), n - 1)
            stage = np.full(P, top, keys.dtype)
            stage[:m] = keys[r, p]
            at = np.minimum(np.arange(1, k, dtype=np.int64) * m // k, m - 1)
            spl[r, s] = _g6_bitonic(stage)[at]
    upper = np.concatenate([spl[:, 0], np.full((B, 1), top, keys.dtype)], 1)
    return (spl[:, 0], upper) if seg_off is None else (spl, None)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("m,k", [(512, 128), (7, 4), (1, 2), (100, 16)])
def test_g6_replay_matches_the_plain_twin_and_the_reference(dtype, m, k):
    """Level 1 (the upper form too) and level 2 over segments that are
    empty, the last one at the row's end (its lo is n), with the uniforms'
    extremes, against ``glue.sample_splitters_plain`` and the reference's
    ``select_splitters`` of the sorted sample."""
    from repro.core.sampling import select_splitters as ref_select_splitters
    from repro_torch.kernels.glue import sample_splitters_plain

    rng = np.random.default_rng(m + k)
    B, n = 2, 6000
    keys = (rng.integers(-2**31, 2**31, (B, n)) // 7).astype(dtype)
    keys[:, ::5] = 3  # duplicates
    pos = rng.integers(0, n, (B, m))
    spl, upper = _replay_g6(keys, pos, k)
    want, want_up = sample_splitters_plain(torch.from_numpy(keys), torch.from_numpy(pos), k,
                                           upper=True)
    np.testing.assert_array_equal(spl, want.numpy())
    np.testing.assert_array_equal(upper, want_up.numpy())
    for r in range(B):
        np.testing.assert_array_equal(spl[r], np.asarray(ref_select_splitters(
            jnp.sort(jnp.asarray(keys[r, pos[r]].astype(np.int64))), k)))
    S = 6
    off = np.array([[0, 0, 1000, 1000, 4000, n, n], [0, 10, 20, 3000, 5999, n, n]], np.int32)
    u = rng.random((B, S, m), dtype=np.float32)
    u[..., 0] = np.nextafter(np.float32(1), np.float32(0))
    got, _ = _replay_g6(keys, u, k, off)
    want = sample_splitters_plain(torch.from_numpy(keys), torch.from_numpy(u), k,
                                  seg_offsets=torch.from_numpy(off))
    np.testing.assert_array_equal(got, want.numpy())


# ---- G7: the robustness fallback ------------------------------------------

G7_PER = 8  # outputs a thread of a merge tile


def _g7_list(off, nb, W, limit, C, span=4096, per=4):
    """G7's list kernel: a CTA a (row, part of ``span`` buckets), thread t of
    ``span // per`` taking buckets t, t + span // per, ...; phase one each
    part's count, chunks and largest; phase two each part's entries in
    bucket order from its row's prefix of the earlier parts (the last part
    writing the row's totals); phase three the chunk prefix over the rows and
    the summary (verdict, count, largest size, chunks)."""
    threads = span // per
    parts = -(-nb // span)

    def listed(row, b):
        start, size = int(row[b]), int(row[b + 1] - row[b])
        return start, size, b % 2 == 0 and size > W // 2 and start < limit

    stats = []
    for row in off:  # phase one
        for p in range(parts):
            bs = [p * span + j * threads + t for j in range(per) for t in range(threads)]
            big = [listed(row, b)[1] for b in bs if b < nb and listed(row, b)[2]]
            stats.append((len(big), sum(-(-s // C) for s in big), max(big, default=0)))
    lists, per_row, largest = [], [], []
    for r, row in enumerate(off):  # phase two
        entries = []
        for p in range(parts):
            slot = sum(stats[r * parts + q][0] for q in range(p))
            chunk = sum(stats[r * parts + q][1] for q in range(p))
            assert slot == len(entries)
            for j in range(per):  # a block scan a stretch, in bucket order
                for t in range(threads):
                    b = p * span + j * threads + t
                    if b < nb and listed(row, b)[2]:
                        start, size, _ = listed(row, b)
                        entries.append((start, size, chunk))
                        chunk += -(-size // C)
        lists.append(entries)
        per_row.append(sum(stats[r * parts + q][1] for q in range(parts)))
        largest.append(max(stats[r * parts + q][2] for q in range(parts)))
    prefix = np.concatenate([[0], np.cumsum(per_row)]).astype(np.int64)  # phase three
    count = sum(len(e) for e in lists)
    return lists, prefix, (int(count > 0), count, max(largest, default=0), int(prefix[-1]))


def _g7_locate(lists, prefix, c):
    """Chunk c of the sequence: the row by a search of the row prefix, the
    bucket by a search of the row's first chunks."""
    row = int(np.searchsorted(prefix, c, side="right")) - 1
    lc = c - int(prefix[row])
    firsts = [e[2] for e in lists[row]]
    j = int(np.searchsorted(firsts, lc, side="right")) - 1
    start, size, first = lists[row][j]
    return row, start, size, lc - first


def _g7_warp_cut(before, na, nb, d):
    """The warp's merge-path cut: 32 probes a step, the gap between the last
    true and the first false probe kept; ``before(i, j)`` compares the left
    run's i-th with the right run's j-th."""
    lo, hi = max(0, d - nb), min(d, na)
    steps = 0
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        c = sum(1 for lane in range(32) if lo + lane * step < hi
                and before(lo + lane * step, d - 1 - lo - lane * step))
        steps += 1
        if c == 0:
            return lo, steps
        lo, hi = lo + (c - 1) * step + 1, min(hi, lo + c * step)
    return lo + sum(1 for lane in range(32) if lo + lane < hi
                    and before(lo + lane, d - 1 - lo - lane)), steps + 1


def _g7_chunk_sort(key, pos):
    """The chunk's bitonic network on (key, position), padded with (max,
    INT_MAX): a total order, so the stable order."""
    C = key.shape[0]
    k, p = key.copy(), pos.copy()
    t = np.arange(C // 2)
    size = 2
    while size <= C:
        stride = size >> 1
        while stride:
            i = 2 * t - (t & (stride - 1))
            j = i + stride
            b_first = (k[j] < k[i]) | ((k[j] == k[i]) & (p[j] < p[i]))
            swap = b_first == ((i & size) == 0)
            k[i], k[j] = np.where(swap, k[j], k[i]), np.where(swap, k[i], k[j])
            p[i], p[j] = np.where(swap, p[j], p[i]), np.where(swap, p[i], p[j])
            stride >>= 1
        size <<= 1
    return k, p


def _replay_g7(arrays, off, nb, W, limit, C, span=4096, per=4):
    """G7 over (B, n) ``arrays`` (keys "k" int32 or int64; other arrays any
    row width): the list, the chunks sorted into buffer 0, the merge rounds
    (width C, 2C, ... below the largest size) through tiles of C outputs,
    each with its two cuts and its threads' searches and serial merges, and
    the move through a scratch of 4 bytes a position, one slice of a row's
    units at a time.  Returns (arrays, summary, rounds, largest cut steps)."""
    keys = arrays["k"]
    B, n = keys.shape
    lists, prefix, summary = _g7_list(off, nb, W, n if limit is None else limit, C,
                                      span=span, per=per)
    chunks, largest = summary[3], summary[2]
    bufs = np.zeros((2, B, n), np.int64)
    threads = C // G7_PER
    top = np.iinfo(keys.dtype).max
    for c in range(chunks):
        row, start, size, q = _g7_locate(lists, prefix, c)
        p0, ln = start + q * C, min(C, size - q * C)
        kk = np.full(C, top, keys.dtype)
        pp = np.full(C, 2**31 - 1, np.int64)
        kk[:ln], pp[:ln] = keys[row, p0:p0 + ln], np.arange(p0, p0 + ln)
        _, sp = _g7_chunk_sort(kk, pp)
        bufs[0, row, p0:p0 + ln] = sp[:ln]
    rounds, w, cur, most_steps = 0, C, 0, 0
    while w < largest:
        for c in range(chunks):
            row, start, size, q = _g7_locate(lists, prefix, c)
            rk = keys[row]
            o0, o1 = q * C, min(q * C + C, size)
            ps = (o0 // (2 * w)) * (2 * w)
            na = min(w, size - ps)
            nb_ = min(2 * w, size - ps) - na
            src = bufs[cur, row, start + ps:start + ps + na + nb_]
            dst = bufs[1 - cur, row, start + ps:]
            d0, d1 = o0 - ps, o1 - ps
            if nb_ == 0:
                dst[d0:d1] = src[d0:d1]
                continue

            def before(i, j):
                a, b = src[i], src[na + j]
                return (rk[a], a) < (rk[b], b)

            (a0, s0), (a1, s1) = _g7_warp_cut(before, na, nb_, d0), _g7_warp_cut(before, na, nb_, d1)
            most_steps = max(most_steps, s0, s1)
            want0 = sum(1 for i in range(max(0, d0 - nb_), min(d0, na)) if before(i, d0 - 1 - i))
            assert a0 == max(0, d0 - nb_) + want0  # the cut is the merge path's
            la, lb, b0 = a1 - a0, (d1 - a1) - (d0 - a0), d0 - a0
            sp = np.concatenate([src[a0:a1], src[na + b0:na + b0 + lb]])
            sk = rk[sp]

            def lt(i, j):
                return (sk[i], sp[i]) < (sk[j], sp[j])

            for t in range(threads):
                dd = t * G7_PER
                if dd >= la + lb:
                    continue
                lo, hi = max(0, dd - lb), min(dd, la)
                while lo < hi:
                    mid = (lo + hi) >> 1
                    if lt(mid, la + dd - 1 - mid):
                        lo = mid + 1
                    else:
                        hi = mid
                i, j = lo, dd - lo
                for r in range(G7_PER):
                    if dd + r < la + lb:
                        if j >= lb or (i < la and lt(i, la + j)):
                            dst[d0 + dd + r], i = sp[i], i + 1
                        else:
                            dst[d0 + dd + r], j = sp[la + j], j + 1
        cur, w, rounds = 1 - cur, 2 * w, rounds + 1
    order, scratch = bufs[cur], np.zeros((B, n, 4), np.uint8)
    for name, a in arrays.items():
        rows = np.ascontiguousarray(a).view(np.uint8).reshape(B, n, -1)
        unit = min(4, 1 << ((rows.shape[2] & -rows.shape[2]).bit_length() - 1))
        units = rows.shape[2] // unit
        g = 4 // unit
        for u0 in range(0, units, g):
            cu = min(g, units - u0)
            lo_b, hi_b = u0 * unit, (u0 + cu) * unit
            for phase in (0, 1):
                for c in range(chunks):
                    row, start, size, q = _g7_locate(lists, prefix, c)
                    p = np.arange(start + q * C, start + min(q * C + C, size))
                    if phase == 0:
                        scratch[row, p, :hi_b - lo_b] = rows[row, order[row, p], lo_b:hi_b]
                    else:
                        rows[row, p, lo_b:hi_b] = scratch[row, p, :hi_b - lo_b]
        arrays[name] = rows.view(a.dtype).reshape(a.shape)
    return arrays, summary, rounds, most_steps


def _g7_case(name, dtype):
    """(B, n, W, per-row bucket sizes) of the crafted offsets."""
    C = 2048
    return {
        "whole row": (1, 6 * C + 5, 256, [[6 * C + 5]]),
        "W/2+1, C-1, C, C+1, 3C+5": (1, 16000, 256, [[129, 3, C - 1, 1, C, 0, C + 1, 2,
                                                       3 * C + 5]]),
        "rows of other counts": (3, 9000, 256, [[4000, 1, 130], [10, 20, 30], [9000]]),
        "all equal": (2, 7000, 256, [[5000, 1, 200], [300]]),
    }[name]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["whole row", "W/2+1, C-1, C, C+1, 3C+5",
                                  "rows of other counts", "all equal"])
@pytest.mark.parametrize("limit", [None, 3000])
def test_g7_replay_matches_the_reference_and_the_plain_twin(dtype, case, limit):
    """G7's schedule at the kernel's C = 2048 on crafted offsets: the list's
    summary, the chunks, the merge rounds with their cuts and the move give
    what the plain twin gives, and every listed bucket is the reference's
    ``stable_full_sort`` of its keys (index and payload with them); the
    other positions never move."""
    from repro.core.ips4o import stable_full_sort as ref_stable_full_sort
    from repro_torch.kernels import fallback
    from repro_torch.kernels.glue import segment_ids_plain

    C = fallback.CHUNK
    B, n, W, sizes = _g7_case(case, dtype)
    rng = np.random.default_rng(len(case) + (limit or 0))
    offs = []
    for s in sizes:
        o = np.concatenate([[0], np.cumsum(s)])
        offs.append(np.append(o, n) if o[-1] < n else o)
    nb = max(len(o) for o in offs) - 1
    off = np.stack([np.append(o, [n] * (nb + 1 - len(o))) for o in offs]).astype(np.int32)
    keys = rng.integers(-2**31, 2**31, (B, n)).astype(dtype) // 3
    if case == "all equal":
        keys[:] = 11
    elif case == "whole row":
        keys[0, :1000] = keys[0, 0]  # a run of equal keys across chunks
    arrays = {"k": keys.copy(), "v": np.tile(np.arange(n, dtype=np.int32), (B, 1)),
              "w": (rng.integers(0, 2, (B, n, 3)) > 0), "x": rng.standard_normal((B, n, 3))}
    got, summary, rounds, steps = _replay_g7({k_: v.copy() for k_, v in arrays.items()}, off,
                                             nb, W, limit, C)
    meta = fallback.oversized_list_plain(torch.from_numpy(off), nb, W, None, limit, n)
    assert tuple(meta[:4].tolist()) == summary
    assert rounds == max(0, math.ceil(math.log2(max(summary[2], 1) / C)))
    tarr = {k_: torch.from_numpy(v.copy()) for k_, v in arrays.items()}
    fb = segment_ids_plain(torch.from_numpy(off), n)
    want = fallback.sort_oversized_plain(tarr, fb, torch.from_numpy(off), nb, W, None, limit)
    for k_ in arrays:
        np.testing.assert_array_equal(got[k_], want[k_].numpy(), err_msg=k_)
    big = fallback.oversized_mask(torch.from_numpy(off), nb, W, None, limit).numpy()
    moved = np.zeros((B, n), bool)
    for r in range(B):
        for b in np.nonzero(big[r])[0]:
            lo, hi = off[r, b], off[r, b + 1]
            moved[r, lo:hi] = True
            ref = ref_stable_full_sort({"k": jnp.asarray(keys[r, lo:hi].astype(np.int64)),
                                        "v": jnp.asarray(np.arange(lo, hi, dtype=np.int32))})
            np.testing.assert_array_equal(got["k"][r, lo:hi], np.asarray(ref["k"]))
            np.testing.assert_array_equal(got["v"][r, lo:hi], np.asarray(ref["v"]))
    for k_ in arrays:
        np.testing.assert_array_equal(got[k_][~moved], arrays[k_][~moved])


@pytest.mark.parametrize("C,sizes", [(16, [37, 1, 16, 2, 33, 0, 200]), (32, [1000]),
                                     (64, [65, 1, 128, 1, 129, 1, 64 * 5 + 3])])
def test_g7_merge_rounds_at_small_chunks(C, sizes):
    """The schedule with chunks of C keys (many rounds: a bucket of 1000 in
    chunks of 32 takes five) and the list over parts of 4 buckets (two a
    thread) stays the stable sort of every listed bucket, and the warp cuts
    stay within their bound of steps."""
    rng = np.random.default_rng(C)
    n = sum(sizes) + 10
    off = np.concatenate([[0], np.cumsum(sizes), [n]]).astype(np.int32)[None]
    nb = off.shape[1] - 1
    keys = rng.integers(0, 50, (1, n)).astype(np.int32)  # many ties
    arrays = {"k": keys.copy(), "v": np.arange(n, dtype=np.int32)[None]}
    got, summary, rounds, steps = _replay_g7(arrays, off, nb, 8, None, C, span=4, per=2)
    assert rounds == math.ceil(math.log2(summary[2] / C)) and steps <= 3
    for b in range(0, nb, 2):
        lo, hi = off[0, b], off[0, b + 1]
        if hi - lo > 4:
            order = np.argsort(keys[0, lo:hi], kind="stable")
            np.testing.assert_array_equal(got["v"][0, lo:hi], lo + order)


def _replay_g7_keys(keys, off, nb, W, limit, C, span=4096, per=4):
    """G7's sort of the keys alone (no payload): each chunk sorted in place
    (a network on the keys, the max as the pad), then rounds ping-ponging
    between the keys and a scratch, each tile's cuts by the warp's probes of
    A[i] <= B[d-1-i] (ties to the left run) and each thread's serial merge,
    and the copy back after an odd number of rounds.  Returns (keys,
    summary, rounds)."""
    B, n = keys.shape
    lists, prefix, summary = _g7_list(off, nb, W, n if limit is None else limit, C, span, per)
    chunks, largest = summary[3], summary[2]
    bufs = [keys.copy(), np.zeros_like(keys)]
    top = np.iinfo(keys.dtype).max
    threads = C // G7_PER
    for c in range(chunks):
        row, start, size, q = _g7_locate(lists, prefix, c)
        p0, ln = start + q * C, min(C, size - q * C)
        stage = np.full(C, top, keys.dtype)
        stage[:ln] = bufs[0][row, p0:p0 + ln]
        bufs[0][row, p0:p0 + ln] = _g6_bitonic(stage)[:ln]
    cur, w, rounds = 0, C, 0
    while w < largest:
        for c in range(chunks):
            row, start, size, q = _g7_locate(lists, prefix, c)
            o0, o1 = q * C, min(q * C + C, size)
            ps = (o0 // (2 * w)) * (2 * w)
            na = min(w, size - ps)
            nb_ = min(2 * w, size - ps) - na
            src = bufs[cur][row, start + ps:start + ps + na + nb_]
            dst = bufs[1 - cur][row, start + ps:]
            d0, d1 = o0 - ps, o1 - ps
            if nb_ == 0:
                dst[d0:d1] = src[d0:d1]
                continue

            def before(i, j):
                return src[i] <= src[na + j]

            a0, a1 = _g7_warp_cut(before, na, nb_, d0)[0], _g7_warp_cut(before, na, nb_, d1)[0]
            la, lb = a1 - a0, (d1 - a1) - (d0 - a0)
            sk = np.concatenate([src[a0:a1], src[na + d0 - a0:na + d0 - a0 + lb]])
            for t in range(threads):
                dd = t * G7_PER
                if dd >= la + lb:
                    continue
                lo, hi = max(0, dd - lb), min(dd, la)
                while lo < hi:
                    mid = (lo + hi) >> 1
                    if sk[mid] <= sk[la + dd - 1 - mid]:
                        lo = mid + 1
                    else:
                        hi = mid
                i, j = lo, dd - lo
                for r in range(G7_PER):
                    if dd + r < la + lb:
                        if j >= lb or (i < la and sk[i] <= sk[la + j]):
                            dst[d0 + dd + r], i = sk[i], i + 1
                        else:
                            dst[d0 + dd + r], j = sk[la + j], j + 1
        cur, w, rounds = 1 - cur, 2 * w, rounds + 1
    out = bufs[0]
    if cur:  # an odd number of rounds: the listed positions copied back
        for c in range(chunks):
            row, start, size, q = _g7_locate(lists, prefix, c)
            p = slice(start + q * C, start + min(q * C + C, size))
            out[row, p] = bufs[1][row, p]
    return out, summary, rounds


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("C,sizes,limit", [(2048, [129, 1, 2047, 1, 2048, 1, 2049, 1, 6149], None),
                                           (16, [37, 1, 16, 2, 33, 0, 200], 100),
                                           (32, [1000], None), (64, [130, 1, 129], None)])
def test_g7_keys_alone_replay_matches_the_plain_twin(dtype, C, sizes, limit):
    """The keys-alone kernel (ops.sort's: no payload) over even and odd
    numbers of rounds, the list over parts of 4 buckets: every listed bucket
    sorted, everything else as it was, as the plain twin leaves it."""
    from repro_torch.kernels import fallback
    from repro_torch.kernels.glue import segment_ids_plain

    rng = np.random.default_rng(C + len(sizes))
    n = sum(sizes) + 10
    off = np.concatenate([[0], np.cumsum(sizes), [n]]).astype(np.int32)[None]
    nb = off.shape[1] - 1
    keys = (rng.integers(-2**31, 2**31, (1, n)) // 1000).astype(dtype)
    got, summary, rounds = _replay_g7_keys(keys.copy(), off, nb, 128 if C == 2048 else 8, limit,
                                           C, span=4, per=2)
    arr = {"k": torch.from_numpy(keys.copy())}
    want = fallback.sort_oversized_plain(arr, segment_ids_plain(torch.from_numpy(off), n),
                                         torch.from_numpy(off), nb, 128 if C == 2048 else 8,
                                         None, limit)
    np.testing.assert_array_equal(got, want["k"].numpy())
    assert rounds == (math.ceil(math.log2(summary[2] / C)) if summary[2] > C else 0)
