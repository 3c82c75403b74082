"""Parity of the port's attention kernels K10 and K11 with the reference,
on the CPU.

K10 (``kernels.flash_decode.flash_decode`` and ``flash_decode_cache`` on CPU
tensors, which run the plain twin ``kernels.ref.flash_decode_ref``) against
the reference's Pallas kernel in interpret mode and its oracle
``flash_decode_ref``, at ``tests/test_perf_paths.py``'s shapes, on a
GQA cache read in its own (B, T, KVH, hd) layout, and at the edges
(length 0 gives 0 as in the Pallas kernel; length T).  K10's
split-and-combine algebra (``kernels.ref.flash_decode_split_ref``: the
valid prefix cut into 1, 3, 8 or 16 shares, combined by their m and l)
against the same reference kernel and oracle, with empty shares and
length 0.  K11
(``kernels.flash_attention.flash_attention``, whose CPU route is the plain
twin ``kernels.ref.flash_attention_ref``) against the reference's oracle
``flash_attention_ref``, causal, windowed and non-causal: the
reference's own Pallas K11 does not run in interpret mode under this
container's jax 0.9.0 (``pl.load`` is missing), so its oracle is the
yardstick.  The port's twins are held to the reference's oracles also
when called directly.  Inputs are made with numpy from a seed and rounded to
bfloat16 once, so both sides see the same values.  Tolerances: 2e-5 in
float32 (the same math in another summation order) and 2e-2 in bfloat16
(the output's rounding), absolute and relative, as the reference's tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as ref_flash_decode
from repro.kernels.ref import flash_attention_ref as ref_attention_oracle
from repro.kernels.ref import flash_decode_ref as ref_decode_oracle
from repro.models.attention import _expand_kv as ref_expand_kv
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref
from repro_torch.models.convert import to_torch
from torch_one_thread import one_torch_thread  # noqa: F401

DTYPES = [(jnp.float32, 2e-5), (jnp.bfloat16, 2e-2)]


def pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor."""
    x = jnp.asarray(rng.standard_normal(shape), dtype)
    return x, to_torch(np.asarray(x))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.to(torch.float32)),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,h,t,hd,bt", [
    (2, 4, 2048, 64, 512),
    (1, 2, 1024, 128, 256),
    (3, 2, 512, 64, 512),   # single T block
])
def test_flash_decode_matches_reference(b, h, t, hd, bt, dtype, tol):
    rng = np.random.default_rng(4)
    jq, q = pair(rng, (b, h, 1, hd), dtype)
    jk, k = pair(rng, (b, h, t, hd), dtype)
    jv, v = pair(rng, (b, h, t, hd), dtype)
    lengths = rng.integers(1, t + 1, (b,)).astype(np.int32)
    got = fd.flash_decode(q, k, v, torch.as_tensor(lengths))
    assert got.shape == (b, h, 1, hd) and got.dtype == q.dtype
    jl = jnp.asarray(lengths)
    close(got, ref_flash_decode(jq, jk, jv, jl, bt=bt, interpret=True), tol)
    close(got, ref_decode_oracle(jq, jk, jv, jl), tol)
    close(ref.flash_decode_ref(q, k, v, torch.as_tensor(lengths)),
          ref_decode_oracle(jq, jk, jv, jl), tol)
    assert torch.equal(ops.flash_decode(q, k, v, torch.as_tensor(lengths)), got)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,h,kvh,t,hd", [(3, 8, 2, 512, 64), (2, 4, 1, 256, 32)])
def test_flash_decode_cache_layout_gqa(b, h, kvh, t, hd, dtype, tol):
    """The decode step's form: q (B, H, hd) against the (B, T, KVH, hd)
    cache, equal to the reference kernel on the expanded, transposed copy
    (what the reference's decode step hands it)."""
    rng = np.random.default_rng(5)
    jq, q = pair(rng, (b, h, hd), dtype)
    jk, k = pair(rng, (b, t, kvh, hd), dtype)
    jv, v = pair(rng, (b, t, kvh, hd), dtype)
    lengths = np.array([1, t, 77][:b], np.int32)
    got = fd.flash_decode_cache(q, k, v, torch.as_tensor(lengths))
    kx = ref_expand_kv(jk, h // kvh).transpose(0, 2, 1, 3)
    vx = ref_expand_kv(jv, h // kvh).transpose(0, 2, 1, 3)
    want = ref_flash_decode(jq[:, :, None], kx, vx, jnp.asarray(lengths), bt=t,
                            interpret=True)[:, :, 0]
    close(got, want, tol)


def test_flash_decode_edges():
    """length 0 gives 0 (the kernel's max(l, 1e-30) divisor), where the
    reference's oracle gives NaN; length T reads the whole cache; lengths
    past T clamp."""
    rng = np.random.default_rng(6)
    b, h, t, hd = 4, 2, 256, 64
    jq, q = pair(rng, (b, h, 1, hd), jnp.float32)
    jk, k = pair(rng, (b, h, t, hd), jnp.float32)
    jv, v = pair(rng, (b, h, t, hd), jnp.float32)
    lengths = np.array([0, t, 1, 0], np.int32)
    got = fd.flash_decode(q, k, v, torch.as_tensor(lengths))
    want = ref_flash_decode(jq, jk, jv, jnp.asarray(lengths), bt=128, interpret=True)
    close(got, want, 2e-5)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(ref.flash_decode_ref(q, k, v, torch.as_tensor(lengths)), got)
    assert bool(np.isnan(np.asarray(ref_decode_oracle(jq, jk, jv, jnp.asarray(lengths))[0])).all())
    past = fd.flash_decode(q, k, v, torch.as_tensor([t + 5, t, t, t], dtype=torch.int32))
    assert torch.equal(past[0], fd.flash_decode(q, k, v, torch.full((b,), t))[0])


def test_flash_decode_rejects_bad_inputs():
    q = torch.zeros(2, 4, 1, 32)
    k = torch.zeros(2, 3, 64, 32)
    with pytest.raises(ValueError, match="divide"):
        fd.flash_decode(q, k, k, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fd.flash_decode(q.double(), k[:, :2].double(), k[:, :2].double(),
                        torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="length"):
        fd.flash_decode(q, k[:, :2], k[:, :2], torch.ones(3, dtype=torch.int32))


SPLITS = [1, 3, 8, 16]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_decode_split_matches_reference(splits, dtype, tol):
    """The split algebra on the reference's (B, H, T, hd) layout, with
    lengths below one unit per share (most shares empty), ragged and
    whole, against the reference's Pallas K10 in interpret mode and its
    oracle."""
    rng = np.random.default_rng(7)
    b, h, t, hd = 4, 2, 512, 64
    jq, q = pair(rng, (b, h, 1, hd), dtype)
    jk, k = pair(rng, (b, h, t, hd), dtype)
    jv, v = pair(rng, (b, h, t, hd), dtype)
    lengths = np.array([5, 1, 301, t], np.int32)
    got = ref.flash_decode_split_ref(q, k, v, torch.as_tensor(lengths), splits)
    assert got.shape == (b, h, 1, hd) and got.dtype == q.dtype
    jl = jnp.asarray(lengths)
    close(got, ref_flash_decode(jq, jk, jv, jl, bt=128, interpret=True), tol)
    close(got, ref_decode_oracle(jq, jk, jv, jl), tol)


@pytest.mark.parametrize("splits", SPLITS)
def test_flash_decode_split_gqa_cache(splits):
    """The split algebra on a GQA cache (KV heads read as groups) against
    the reference kernel on the expanded copy, in float32."""
    rng = np.random.default_rng(8)
    b, h, kvh, t, hd = 3, 8, 2, 256, 32
    jq, q = pair(rng, (b, h, 1, hd), jnp.float32)
    jk, k = pair(rng, (b, kvh, t, hd), jnp.float32)
    jv, v = pair(rng, (b, kvh, t, hd), jnp.float32)
    lengths = np.array([17, t, 130], np.int32)
    got = ref.flash_decode_split_ref(q, k, v, torch.as_tensor(lengths), splits)
    want = ref_flash_decode(jq, jnp.repeat(jk, h // kvh, axis=1), jnp.repeat(jv, h // kvh, axis=1),
                            jnp.asarray(lengths), bt=t, interpret=True)
    close(got, want, 2e-5)


@pytest.mark.parametrize("splits", SPLITS)
def test_flash_decode_split_edges(splits):
    """Length 0 gives exactly 0 (every share empty: M = -1e30, l = 0), as
    the kernel's twin and the Pallas kernel give; lengths past T clamp; the
    split equals the unsplit twin within float32's summation order."""
    rng = np.random.default_rng(9)
    b, h, t, hd = 5, 2, 128, 32
    jq, q = pair(rng, (b, h, 1, hd), jnp.float32)
    jk, k = pair(rng, (b, h, t, hd), jnp.float32)
    jv, v = pair(rng, (b, h, t, hd), jnp.float32)
    lengths = torch.tensor([0, 3, t, t + 40, 0], dtype=torch.int32)
    got = ref.flash_decode_split_ref(q, k, v, lengths, splits)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    torch.testing.assert_close(got, ref.flash_decode_ref(q, k, v, lengths), atol=2e-5, rtol=2e-5)
    whole = ref.flash_decode_split_ref(q, k, v, torch.full((b,), t, dtype=torch.int32), splits)
    assert torch.equal(got[3], whole[3])
    want = ref_flash_decode(jq, jk, jv, jnp.asarray(lengths.clamp(max=t).numpy()), bt=t,
                            interpret=True)
    close(got, want, 2e-5)
    zero = ref.flash_decode_split_ref(q, k, v, torch.zeros(b, dtype=torch.int32), splits)
    assert not bool(zero.any())


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,h,s,hd,causal,window", [
    (2, 4, 512, 64, True, 0),
    (1, 2, 1024, 128, True, 0),
    (1, 2, 512, 64, True, 200),
    (1, 2, 256, 64, False, 0),
    (1, 2, 300, 64, False, 100),   # the window without causality; S not a block multiple
])
def test_flash_attention_matches_reference(b, h, s, hd, causal, window, dtype, tol):
    rng = np.random.default_rng(1)
    jq, q = pair(rng, (b, h, s, hd), dtype)
    jk, k = pair(rng, (b, h, s, hd), dtype)
    jv, v = pair(rng, (b, h, s, hd), dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == q.dtype
    want = ref_attention_oracle(jq, jk, jv, causal=causal, window=window)
    close(got, want, tol)
    close(ref.flash_attention_ref(q, k, v, causal=causal, window=window), want, tol)
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal, window=window), got)


def test_flash_attention_gqa_equals_expanded():
    """KV heads that divide the query heads are read as groups: the same as
    the pre-expanded call (the reference's contract)."""
    rng = np.random.default_rng(2)
    _, q = pair(rng, (2, 8, 128, 64), jnp.float32)
    _, k = pair(rng, (2, 2, 128, 64), jnp.float32)
    _, v = pair(rng, (2, 2, 128, 64), jnp.float32)
    got = fa.flash_attention(q, k, v, causal=True, window=50)
    want = fa.flash_attention(q, k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1),
                              causal=True, window=50)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
