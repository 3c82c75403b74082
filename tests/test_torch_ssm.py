"""Parity of the port's Mamba2 mixer (``repro_torch.models.ssm``) with the
reference, on the CPU.

The projection split and the causal conv (with and without a conv state);
the chunked SSD scan on given inputs (one chunk, several chunks, a
non-zero incoming state); the whole layer without a state (training), its
prefill from a fresh state and decode steps (the closed form), each step
fed the reference's incoming state, with the new states (``conv`` in
bfloat16, ``ssm`` in float32, updated in place) against the reference's;
the refusal of a sequence that is not a multiple of the chunk; the layer
in bfloat16.  Parameters come from the reference's ``init_mamba2``
(float32, ``A_log`` and ``dt_bias`` drawn so that the decays vary),
inputs from numpy.

Tolerances: float32 1e-5 on the pieces and on a decode step.  The chunked
scan over a sequence is held at 1e-4: its cumulative log-decay reaches
|cum| ~ 10^2 in float32, where the two frameworks' cumsum and the
in-projection's dot product associate differently, so each weight
exp(cum_i - cum_j) carries a relative error of ~|cum| * 2^-24 * log2(chunk)
~ 1e-5 (seen: 2.1e-5 at outputs of ~4).  The bfloat16 conv state within
one bfloat16 step (it is the in-projection's output, whose last float32
bits differ between the two frameworks' dot products, rounded to bfloat16:
1 of 768 entries was seen one step apart); bfloat16 outputs within
0.02 + 2^-6 * |want| (four bfloat16 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.models import ssm
from repro_torch.models.convert import to_torch
from repro_torch.models.layers import Dense
from torch_one_thread import one_torch_thread  # noqa: F401

D, N, CONV, EXPAND, HD = 64, 16, 4, 2, 16
KW = dict(d_state=N, expand=EXPAND, head_dim=HD)
TOL32, TOL_SCAN = 1e-5, 1e-4


def _layer(dtype):
    p = ref_ssm.init_mamba2(jax.random.PRNGKey(0), D, d_state=N, d_conv=CONV, expand=EXPAND,
                            head_dim=HD, dtype=dtype)
    heads = D * EXPAND // HD
    rng = np.random.default_rng(5)
    p = {**jax.tree.map(np.asarray, p),
         "A_log": rng.uniform(-1.0, 0.5, heads).astype(np.float32),
         "dt_bias": rng.uniform(-1.0, 1.0, heads).astype(np.float32),
         "conv_b": np.asarray(jnp.asarray(rng.standard_normal(D * EXPAND) * 0.1, dtype))}
    port = ssm.Mamba2(Dense(to_torch(p["in_proj"]["w"])), to_torch(p["conv_w"]),
                      to_torch(p["conv_b"]), to_torch(p["A_log"]), to_torch(p["dt_bias"]),
                      to_torch(p["D"]), to_torch(p["norm_z"]), Dense(to_torch(p["out_proj"]["w"])))
    return jax.tree.map(jnp.asarray, p), port


def _x(s, seed, b=2):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


def close(got, want, tol=TOL32):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_split_and_conv(with_state):
    p, port = _layer(jnp.float32)
    x = _x(10, 1)
    d_in = D * EXPAND
    want = ref_ssm._split_proj(p, jnp.asarray(x), d_in, N, d_in // HD)
    got = ssm._split_proj(port, torch.as_tensor(x), d_in, N)
    for g, w in zip(got, want):
        close(g, w)
    conv = None
    if with_state:
        conv = jnp.asarray(np.random.default_rng(2).standard_normal((2, CONV - 1, d_in)),
                           jnp.bfloat16)
    w_out, w_state = ref_ssm._conv1d(p, want[0], conv)
    g_out, g_state = ssm._conv1d(port, to_torch(np.asarray(want[0])),
                                 None if conv is None else to_torch(np.asarray(conv)))
    close(g_out, w_out)
    close(g_state, w_state)


@pytest.mark.parametrize("s,chunk,state", [(64, 64, False), (256, 64, True), (128, 128, True)])
def test_ssd_chunked_matches_reference(s, chunk, state):
    rng = np.random.default_rng(s + chunk)
    b, h = 2, 4
    xh = rng.standard_normal((b, s, h, HD)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(-1.0, 0.5, h)).astype(np.float32)
    B_, C_ = (rng.standard_normal((b, s, N)).astype(np.float32) for _ in range(2))
    st0 = (rng.standard_normal((b, h, HD, N)) if state
           else np.zeros((b, h, HD, N))).astype(np.float32)
    args = (xh, dt, A, B_, C_, st0)
    want_y, want_st = ref_ssm._ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    got_y, got_st = ssm._ssd_chunked(*(torch.as_tensor(a) for a in args), chunk)
    close(got_y, want_y, TOL_SCAN)
    close(got_st, want_st, TOL_SCAN)


@pytest.mark.parametrize("s", [1, 64, 256])
def test_layer_without_state(s):
    p, port = _layer(jnp.float32)
    x = _x(s, s)
    want, _ = ref_ssm.mamba2(p, jnp.asarray(x), **KW)
    close(ssm.mamba2(port, torch.as_tensor(x), **KW), want, TOL32 if s == 1 else TOL_SCAN)


@pytest.mark.parametrize("prompt", [1, 64])
def test_prefill_then_decode_with_state(prompt):
    """Prefill from a fresh state (the chunked scan), then 5 decode steps
    (the closed form); each step starts from the reference's incoming
    state, and the port's state dict is updated in place."""
    p, port = _layer(jnp.float32)
    x = _x(prompt + 5, 8)
    ref_state = ref_ssm.init_ssm_state(2, D, d_state=N, d_conv=CONV, expand=EXPAND, head_dim=HD)
    spans = [(0, prompt)] + [(i, i + 1) for i in range(prompt, prompt + 5)]
    for lo, hi in spans:
        state = {name: to_torch(np.asarray(a)) for name, a in ref_state.items()}
        bufs = dict(state)
        want, ref_state = ref_ssm.mamba2(p, jnp.asarray(x[:, lo:hi]), state=ref_state,
                                         update_state=True, **KW)
        got = ssm.mamba2(port, torch.as_tensor(x[:, lo:hi]), state=state, **KW)
        tol = TOL_SCAN if hi - lo > 1 else TOL32
        close(got, want, tol)
        close(state["ssm"], ref_state["ssm"], tol)
        steps = (state["conv"].view(torch.int16).numpy().astype(np.int32)
                 - np.asarray(ref_state["conv"]).view(np.int16).astype(np.int32))
        assert np.abs(steps).max() <= 1  # same sign, so a bit pattern step is one bf16 step
        assert all(state[name] is bufs[name] for name in state)  # in place
        assert state["conv"].dtype == torch.bfloat16 and state["ssm"].dtype == torch.float32


def test_sequence_not_a_multiple_of_the_chunk_raises():
    p, port = _layer(jnp.float32)
    x = _x(130, 3)
    with pytest.raises(ValueError, match="chunk"):
        ref_ssm.mamba2(p, jnp.asarray(x), **KW)
    with pytest.raises(ValueError, match="chunk"):
        ssm.mamba2(port, torch.as_tensor(x), **KW)


def test_layer_bfloat16_matches_reference():
    p, port = _layer(jnp.bfloat16)
    port = port.to(torch.bfloat16)
    for name in ("A_log", "dt_bias", "D"):  # the reference keeps these float32
        setattr(port, name, torch.nn.Parameter(to_torch(np.asarray(p[name])),
                                               requires_grad=False))
    xb = jnp.asarray(_x(64, 4), jnp.bfloat16)
    want, _ = ref_ssm.mamba2(p, xb, **KW)
    got = ssm.mamba2(port, to_torch(np.asarray(xb)), **KW)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.02,
                               rtol=2 ** -6)


def test_init_ssm_state_and_mamba2_distributions():
    ref = ref_ssm.init_ssm_state(3, D, d_state=N, d_conv=CONV, expand=EXPAND, head_dim=HD)
    got = ssm.init_ssm_state(3, D, d_state=N, d_conv=CONV, expand=EXPAND, head_dim=HD,
                             device="cpu")
    for name, a in ref.items():
        assert tuple(got[name].shape) == a.shape
        assert str(got[name].dtype).split(".")[-1] == str(a.dtype)
    layer = ssm.init_mamba2(torch.Generator().manual_seed(0), 128, d_state=64, d_conv=4,
                            expand=2, head_dim=64, device="cpu")
    refp = jax.tree.map(np.asarray, ref_ssm.init_mamba2(jax.random.PRNGKey(0), 128, d_state=64,
                                                         d_conv=4, expand=2, head_dim=64))
    assert sum(t.numel() for t in layer.parameters()) == sum(
        a.size for a in jax.tree.leaves(refp))
    np.testing.assert_array_equal(layer.dt_bias.numpy(), refp["dt_bias"])
    assert layer.conv_w.dtype == torch.bfloat16 and layer.A_log.dtype == torch.float32
