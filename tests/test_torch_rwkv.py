"""Parity of the port's RWKV-6 mixer (``repro_torch.models.rwkv``) with the
reference, on the CPU.

Time-mix and channel-mix without a state (training), then prefill from a
fresh state and decode steps, each step fed the reference's incoming state
(so that both sides start every step from the same numbers): the outputs
and the new states (``tm_shift``, ``cm_shift`` in bfloat16, ``wkv`` in
float32, updated in place in the port) against the reference's; the
state's dtypes and shapes; and the layer in bfloat16.  Parameters come
from the reference's ``init_rwkv6`` (float32), inputs from numpy.
Tolerances: float32 1e-5 (the same math in another summation order); the
bfloat16 shifts exact (both round the same float32 input); bfloat16
outputs within 0.02 + 2^-6 * |want| (four bfloat16 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rwkv
from repro_torch.models import rwkv
from repro_torch.models.convert import to_torch
from repro_torch.models.layers import Dense
from torch_one_thread import one_torch_thread  # noqa: F401

D, HD, DFF = 64, 16, 128
TOL32 = 1e-5


def _mix(dtype):
    p = jax.tree.map(np.asarray, ref_rwkv.init_rwkv6(jax.random.PRNGKey(1), D, head_dim=HD,
                                                      d_ff=DFF, dtype=dtype))
    tm, cm = p["tm"], p["cm"]

    def dn(q):
        return Dense(to_torch(q["w"]))

    port = rwkv.RWKV6(
        rwkv.TimeMix(to_torch(tm["mu"]), *(dn(tm[n]) for n in
                                           ("wr", "wk", "wv", "wg", "wo", "w_lora_a", "w_lora_b")),
                     to_torch(tm["w_bias"]), to_torch(tm["bonus"]), to_torch(tm["ln_x"])),
        rwkv.ChannelMix(to_torch(cm["mu"]), dn(cm["wk"]), dn(cm["wv"]), dn(cm["wr"])))
    return p, port


def _x(s, seed, b=2):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


def close(got, want, tol=TOL32):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _state_of(ref_state):
    return {name: to_torch(np.asarray(a)) for name, a in ref_state.items()}


@pytest.mark.parametrize("s", [1, 9, 40])
def test_mixers_without_state(s):
    p, port = _mix(jnp.float32)
    x = _x(s, s)
    want, _ = ref_rwkv.rwkv6_timemix(p, jnp.asarray(x), head_dim=HD)
    close(rwkv.rwkv6_timemix(port, torch.as_tensor(x), head_dim=HD), want)
    want, _ = ref_rwkv.rwkv6_channelmix(p, jnp.asarray(x))
    close(rwkv.rwkv6_channelmix(port, torch.as_tensor(x)), want)


def test_init_rwkv_state_matches_reference():
    ref = ref_rwkv.init_rwkv_state(3, D, head_dim=HD)
    got = rwkv.init_rwkv_state(3, D, head_dim=HD, device="cpu")
    assert set(got) == set(ref)
    for name, a in ref.items():
        assert tuple(got[name].shape) == a.shape
        assert str(got[name].dtype).split(".")[-1] == str(a.dtype)
        assert not got[name].any()


@pytest.mark.parametrize("prompt", [1, 12])
def test_prefill_then_decode_with_state(prompt):
    """Prefill from a fresh state, then 5 decode steps (the closed form);
    each step starts from the reference's incoming state, and the port's
    state dict is updated in place."""
    p, port = _mix(jnp.float32)
    x = _x(prompt + 5, 7)
    ref_state = ref_rwkv.init_rwkv_state(2, D, head_dim=HD)
    spans = [(0, prompt)] + [(i, i + 1) for i in range(prompt, prompt + 5)]
    for lo, hi in spans:
        state = _state_of(ref_state)
        bufs = dict(state)
        xs = x[:, lo:hi]
        want_t, st_t = ref_rwkv.rwkv6_timemix(p, jnp.asarray(xs), head_dim=HD,
                                              state=ref_state, update_state=True)
        want_c, st_c = ref_rwkv.rwkv6_channelmix(p, jnp.asarray(xs), state=ref_state,
                                                 update_state=True)
        got_t = rwkv.rwkv6_timemix(port, torch.as_tensor(xs), head_dim=HD, state=state)
        got_c = rwkv.rwkv6_channelmix(port, torch.as_tensor(xs), state=state)
        close(got_t, want_t)
        close(got_c, want_c)
        ref_state = {**st_t, **st_c}
        for name, a in ref_state.items():
            assert state[name] is bufs[name]  # in place
            if name == "wkv":
                close(state[name], a)
            else:
                np.testing.assert_array_equal(state[name].view(torch.int16).numpy(),
                                              np.asarray(a).view(np.int16))


def test_timemix_bfloat16_matches_reference():
    p, port = _mix(jnp.bfloat16)
    xb = jnp.asarray(_x(16, 3), jnp.bfloat16)
    want, _ = ref_rwkv.rwkv6_timemix(p, xb, head_dim=HD)
    got = rwkv.rwkv6_timemix(port, to_torch(np.asarray(xb)), head_dim=HD)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.02,
                               rtol=2 ** -6)


def test_init_rwkv6_distributions():
    gen = torch.Generator().manual_seed(0)
    mix = rwkv.init_rwkv6(gen, 128, head_dim=32, d_ff=256, device="cpu")
    ref = jax.tree.map(np.asarray, ref_rwkv.init_rwkv6(jax.random.PRNGKey(0), 128, head_dim=32,
                                                        d_ff=256))
    assert sum(t.numel() for t in mix.parameters()) == sum(a.size for a in jax.tree.leaves(ref))
    assert mix.tm.w_bias.dtype == torch.float32 and mix.tm.mu.dtype == torch.bfloat16
    assert torch.equal(mix.tm.w_bias, torch.full((128,), -2.0))
    assert abs(float(mix.tm.bonus.std()) / 0.1 - 1) < 0.2
    assert tuple(mix.cm.wk.w.shape) == ref["cm"]["wk"]["w"].shape
