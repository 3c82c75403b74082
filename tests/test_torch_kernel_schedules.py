"""The arithmetic of two of the port's CUDA kernels, replayed on the CPU and
held to the reference's oracles.

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
  16 distinct 8-byte bank pairs.
- K11 ``flash_attention`` in float32 (``csrc/flash_attention.cu``): every
  operand split into big = tf32(x) and small = tf32(x - big) (round to
  nearest, ties away: ``cvt.rna.tf32.f32``), each product taken as small x
  big + big x small + big x big in f32, held to the reference's oracle
  ``flash_attention_ref`` within the float32 limit 2e-5 + 2e-5 |want|,
  which one TF32 product alone misses.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import bitonic_sort_windows_ref
from repro.kernels.ref import flash_attention_ref as ref_attention_oracle

# ---- K3 -------------------------------------------------------------------


def _layout(T: int, log_e: int, b: int) -> np.ndarray:
    """(T, E) window index of thread t's register r in the layout of base b:
    t's low b bits, then r, then t's other bits."""
    t = np.arange(T)[:, None]
    r = np.arange(1 << log_e)[None, :]
    return (t & ((1 << b) - 1)) | (r << b) | ((t >> b) << (b + log_e))


def _check_slots(idx: np.ndarray, log_e: int, W: int) -> None:
    """The padded slots idx + idx >> log_e: distinct, below W + T, and
    within each half-warp of one register on 16 distinct bank pairs."""
    slots = idx + (idx >> log_e)
    T = idx.shape[0]
    assert len(np.unique(slots)) == W and slots.max() < W + T
    if T >= 16:
        pairs = (slots % 16).reshape(T // 16, 16, -1)
        assert all(len(np.unique(pairs[h, :, r])) == 16
                   for h in range(T // 16) for r in range(pairs.shape[2]))


def _exchange(x: np.ndarray, r0: int, r1: int, up) -> None:
    """Registers r0 < r1 of every thread in order: ascending where ``up``
    (a bool or one per thread)."""
    a, c = x[:, r0].copy(), x[:, r1].copy()
    lo, hi = np.minimum(a, c), np.maximum(a, c)
    x[:, r0], x[:, r1] = np.where(up, lo, hi), np.where(up, hi, lo)


def _replay_k3(words: np.ndarray, log_e: int) -> np.ndarray:
    """K3's network over one window of uint64 words, as the kernel runs it."""
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
                    _exchange(x, r, r | 1 << j, up)
    b_cur = 0
    for s in range(log_e, L):
        up = ((t >> (s + 1 - log_e)) & 1) == 0  # index bit s+1: t's bit s+1-e
        k_top = s // log_e
        for k in range(k_top, -1, -1):
            b = s - log_e + 1 if k == k_top else k * log_e
            window = np.empty(W, np.uint64)  # the exchange through shared memory
            src, dst = _layout(T, log_e, b_cur), _layout(T, log_e, b)
            _check_slots(dst, log_e, W)
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
                        _exchange(x, r, r | 1 << lj, up)
    out = np.empty(W, np.uint64)
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
