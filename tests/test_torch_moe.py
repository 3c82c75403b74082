"""Parity of the port's MoE layer (``repro_torch.models.moe``) with the
reference, on the CPU.

``expert_capacity`` over a grid; ``sort_dispatch`` in its 1-D and (L, n*k)
forms bit-identical to the reference's (slot, kept, counts), with
capacities that drop entries, skewed routing, one expert and a ragged
tile; ``moe_ffn``'s output and aux (``lb_loss``, ``dropped``,
``max_load``) with and without shared experts, with drops, against the
reference's on the same parameters and float32 inputs, and in bfloat16.
Tolerances: exact for slots, kept flags, counts, dropped and max_load;
float32 1e-5 on the layer's output and ``lb_loss`` (the same math in
another summation order); bfloat16 outputs within 0.02 + 2^-6 * |want|
of the reference (four bfloat16 steps of 2^-8 relative above a floor for
outputs near zero: the two frameworks round the expert products and the
silu at other places; 3 steps were seen at an output of 1.7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.models import moe
from repro_torch.models.convert import to_torch
from repro_torch.models.layers import Dense, SwiGLU
from torch_one_thread import one_torch_thread  # noqa: F401

TOL32 = 1e-5


@pytest.mark.parametrize("tokens", [1, 7, 8, 100, 4096])
@pytest.mark.parametrize("experts,top_k", [(8, 2), (64, 6), (128, 8)])
@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
def test_expert_capacity_matches_reference(tokens, experts, top_k, factor):
    assert moe.expert_capacity(tokens, experts, top_k, factor) == \
        ref_moe.expert_capacity(tokens, experts, top_k, factor)


def _routing(kind, shape, experts, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, experts, shape).astype(np.int32)
    if kind == "skewed":  # half of the entries on expert 3
        e = rng.integers(0, experts, shape).astype(np.int32)
        return np.where(rng.random(shape) < 0.5, 3, e).astype(np.int32)
    return np.full(shape, experts - 1, np.int32)  # one expert takes all


def _check_dispatch(got, want):
    for name, g, w in zip(("slot", "kept", "counts"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "one"])
@pytest.mark.parametrize("m,experts,cap,tile", [
    (4096, 8, 512, 2048),    # lossless for uniform
    (4096, 8, 400, 2048),    # drops
    (6000, 64, 88, 2048),    # m not a multiple of the tile: one tile of m
    (96, 64, 8, 2048),       # a decode step's routing (16 tokens x top-6)
])
def test_sort_dispatch_1d_bit_identical(kind, m, experts, cap, tile):
    e = _routing(kind, (m,), experts, seed=m + cap)
    want = ref_moe.sort_dispatch(jnp.asarray(e), experts, cap, tile=tile)
    got = moe.sort_dispatch(torch.as_tensor(e), experts, cap, tile=tile)
    _check_dispatch(got, want)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    if kind != "uniform" or cap < m // experts:
        assert int((~got[1]).sum()) > 0  # the case drops entries


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
@pytest.mark.parametrize("L,m,experts,cap", [(4, 2048, 16, 96), (3, 768, 64, 16)])
def test_sort_dispatch_2d_bit_identical(kind, L, m, experts, cap):
    e = _routing(kind, (L, m), experts, seed=L * m)
    want = ref_moe.sort_dispatch(jnp.asarray(e), experts, cap)
    got = moe.sort_dispatch(torch.as_tensor(e), experts, cap)
    _check_dispatch(got, want)
    for row in range(L):  # each row is the 1-D dispatch of that row
        _check_dispatch(moe.sort_dispatch(torch.as_tensor(e[row]), experts, cap),
                        [np.asarray(w)[row] for w in want])


def _layer(num_shared, dtype, seed=0, d=64, experts=8, top_k=2, dff=32):
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), d, num_experts=experts, d_ff_expert=dff,
                         top_k=top_k, num_shared=num_shared,
                         d_ff_shared=2 * dff if num_shared else 0, dtype=dtype)
    p = jax.tree.map(np.asarray, p)

    def dn(q):
        return Dense(to_torch(q["w"]))

    ex = p["experts"]
    shared = None
    if num_shared:
        sh = p["shared"]
        shared = SwiGLU(dn(sh["gate"]), dn(sh["up"]), dn(sh["down"]))
    port = moe.MoE(dn(p["router"]), moe.Experts(to_torch(ex["gate"]), to_torch(ex["up"]),
                                                 to_torch(ex["down"])), shared)
    return p, port


@pytest.mark.parametrize("num_shared", [0, 2])
@pytest.mark.parametrize("factor", [8.0, 1.25, 0.5])
def test_moe_ffn_matches_reference(num_shared, factor):
    p, port = _layer(num_shared, jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 48, 64)).astype(np.float32)
    kw = dict(num_experts=8, top_k=2, capacity_factor=factor)
    want, waux = ref_moe.moe_ffn(p, jnp.asarray(x), **kw)
    got, aux = moe.moe_ffn(port, torch.as_tensor(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL32, rtol=TOL32)
    np.testing.assert_allclose(float(aux["lb_loss"]), float(waux["lb_loss"]), rtol=TOL32)
    assert int(aux["dropped"]) == int(waux["dropped"])
    assert int(aux["max_load"]) == int(waux["max_load"])
    assert aux["dropped"].dtype == torch.int32
    if factor < 1:
        assert int(aux["dropped"]) > 0


def test_moe_ffn_bfloat16_matches_reference():
    p, port = _layer(2, jnp.bfloat16, seed=3)
    x = np.random.default_rng(2).standard_normal((2, 32, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    kw = dict(num_experts=8, top_k=2, capacity_factor=1.25)
    want, waux = ref_moe.moe_ffn(p, xb, **kw)
    got, aux = moe.moe_ffn(port, to_torch(np.asarray(xb)), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.02,
                               rtol=2 ** -6)
    assert int(aux["dropped"]) == int(waux["dropped"])


def test_init_moe_distributions():
    """A seeded generator gives one layer; shapes and dtypes are the
    reference's, the router float32, experts ~ N(0, 1/D) and down ~
    N(0, 1/F)."""
    gen = torch.Generator().manual_seed(0)
    layer = moe.init_moe(gen, 128, num_experts=16, d_ff_expert=256, top_k=2, num_shared=2,
                         d_ff_shared=512, device="cpu")
    ref = jax.tree.map(np.asarray, ref_moe.init_moe(
        jax.random.PRNGKey(0), 128, num_experts=16, d_ff_expert=256, top_k=2, num_shared=2,
        d_ff_shared=512))
    assert layer.router.w.dtype == torch.float32 and layer.experts.gate.dtype == torch.bfloat16
    assert tuple(layer.experts.down.shape) == ref["experts"]["down"].shape
    assert tuple(layer.shared.gate.w.shape) == ref["shared"]["gate"]["w"].shape
    assert sum(t.numel() for t in layer.parameters()) == sum(
        a.size for a in jax.tree.leaves(ref))
    assert abs(float(layer.experts.up.float().std()) * 128 ** 0.5 - 1) < 0.05
    assert abs(float(layer.experts.down.float().std()) * 256 ** 0.5 - 1) < 0.05
