"""Parity of the port's optimizer (``repro_torch.optim``) with the
reference's (``repro.optim``) on the CPU.

The same leaves, made with numpy from a seed, go through both packages:
a reference tree with a leaf stacked over layers (``layers/...``, the
port's tuple of per-layer tensors by ``models.convert.leaves_from_jax``)
beside unstacked matrices and vectors, so that the stacked leaf's one int8
scale and its decay by the stacked ndim are held too.  Tolerances: the
LR schedules to 1e-6 relative (``cos`` in float32 differs in its last bit
between the two libraries); AdamW's float32 results to 1e-6 relative plus
1e-7 absolute over three steps (the same elementwise formula; the global
norm sums in another order), its bfloat16 moments to one bfloat16 step;
the int8 codes ``q`` and the compression's ``q`` equal exactly, their
scales to 1e-6 relative; and a training state of the reference carried
across by ``models.convert.train_state_from_jax`` (reduced deepseek-moe-16b
on a (1, 1) mesh with Auto axes) resumes with the reference's losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.registry import get_reduced as ref_get_reduced
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.transformer import init_model as ref_init_model
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim import schedule as ref_schedule
from repro_torch.configs import get_reduced
from repro_torch.models.convert import leaves_from_jax, train_state_from_jax
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, compress_grads, cosine_schedule,
    decompress_grads, init_error_feedback, linear_warmup_cosine,
)
from repro_torch.train import TrainConfig, make_train_step

TIERS = ["float32", "bfloat16", "int8"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small models: with several test
    workers on one machine, each running as many threads as it has cores,
    their many small ops ran up to 100x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    """A reference-shaped tree: stacked layers (L = 3) with a matrix and a
    vector, an unstacked matrix and an unstacked vector."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"embed": f(16, 8), "final_norm": {"scale": f(8)},
            "layers": {"attn": {"wq": {"w": f(3, 8, 8)}}, "ln1": {"scale": f(3, 8)}}}


def _port(tree):
    return leaves_from_jax(tree, "cpu")


def _flat(leaves):
    return [t for v in leaves.values() for t in (v if isinstance(v, tuple) else (v,))]


def _ref_flat(tree):
    return [t for v in _port(jax.tree.map(np.asarray, tree)).values()
            for t in (v if isinstance(v, tuple) else (v,))]


def _moment_flat(tree, tier):
    """A moment tree's tensors (int8: the codes) and its scales."""
    out, scales = [], []
    for v in tree.values():
        if tier == "int8":
            out += list(v["q"]) if isinstance(v["q"], tuple) else [v["q"]]
            scales.append(v["scale"])
        else:
            out += list(v) if isinstance(v, tuple) else [v]
    return out, scales


@pytest.mark.parametrize("total,final", [(10, 0.1), (1, 0.0), (250, 0.3)])
def test_cosine_schedule_matches_reference(total, final):
    for s in range(0, total + 20, 3):
        got = cosine_schedule(torch.tensor(s, dtype=torch.int32), total, final)
        want = ref_schedule.cosine_schedule(jnp.int32(s), total, final)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("warmup,total", [(100, 1000), (2, 6), (0, 5), (7, 3)])
def test_linear_warmup_cosine_matches_reference(warmup, total):
    for s in range(0, max(total, warmup) + 12):
        got = linear_warmup_cosine(torch.tensor(s, dtype=torch.int32), warmup, total)
        want = ref_schedule.linear_warmup_cosine(jnp.int32(s), warmup, total)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("m_dtype,v_dtype", [("float32", "float32"), ("bfloat16", "float32"),
                                             ("int8", "int8"), ("bfloat16", "int8"),
                                             ("int8", "bfloat16")])
def test_adamw_init_matches_reference(m_dtype, v_dtype):
    cfg = AdamWConfig(m_dtype=m_dtype, v_dtype=v_dtype)
    tree = _tree(0)
    want = ref_adamw.adamw_init(jax.tree.map(jnp.asarray, tree), ref_adamw.AdamWConfig(
        m_dtype=m_dtype, v_dtype=v_dtype))
    got = adamw_init(_port(tree), cfg)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    for which, tier in (("m", m_dtype), ("v", v_dtype)):
        conv = _port(jax.tree.map(np.asarray, want[which]))
        assert list(conv) == list(got[which])
        g, gs = _moment_flat(got[which], tier)
        w, ws = _moment_flat(conv, tier)
        assert [(t.shape, t.dtype) for t in g] == [(t.shape, t.dtype) for t in w]
        assert all(int(t.count_nonzero()) == 0 for t in g + gs)


@pytest.mark.parametrize("lr_scale", [1.0, 0.25])
@pytest.mark.parametrize("m_dtype,v_dtype", [(a, b) for a in TIERS for b in TIERS])
def test_adamw_update_matches_reference(m_dtype, v_dtype, lr_scale):
    """Three steps on the same leaves and gradients: parameters, moments
    (int8 codes exactly), the step counter and the metrics."""
    rcfg = ref_adamw.AdamWConfig(lr=1e-2, m_dtype=m_dtype, v_dtype=v_dtype)
    cfg = AdamWConfig(lr=1e-2, m_dtype=m_dtype, v_dtype=v_dtype)
    tree = _tree(1)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_adamw.adamw_init(rp, rcfg)
    params = _port(tree)
    state = adamw_init(params, cfg)
    for step in range(3):
        grads_np = _tree(10 + step, scale=0.3 if step else 3.0)  # step 0 clips
        rp, rs, rm = ref_adamw.adamw_update(rp, jax.tree.map(jnp.asarray, grads_np), rs, rcfg,
                                            lr_scale)
        params, state, metrics = adamw_update(params, _port(grads_np), state, cfg, lr_scale)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(metrics["lr"]), float(rm["lr"]), rtol=1e-7)
        assert int(state["step"]) == int(rs["step"]) == step + 1
        for got, want in zip(_flat(params), _ref_flat(rp)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
        for which, tier in (("m", m_dtype), ("v", v_dtype)):
            g, gs = _moment_flat(state[which], tier)
            w, ws = _moment_flat(_port(jax.tree.map(np.asarray, rs[which])), tier)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                if tier == "int8":
                    assert torch.equal(a, b)
                elif tier == "bfloat16":
                    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                               rtol=2 ** -8, atol=1e-30)
                else:
                    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)
            for a, b in zip(gs, ws):
                np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_adamw_decays_by_the_stacked_ndim():
    """The reference decays leaves of ndim >= 2: a layer's vector stacked over
    layers decays, an unstacked vector does not; a zero gradient isolates
    the decay."""
    tree = _tree(2)
    params = _port(tree)
    zeros = {k: tuple(torch.zeros_like(t) for t in v) if isinstance(v, tuple)
             else torch.zeros_like(v) for k, v in params.items()}
    before = {k: [t.clone() for t in (v if isinstance(v, tuple) else (v,))]
              for k, v in params.items()}
    cfg = AdamWConfig(lr=0.5, weight_decay=0.1)
    adamw_update(params, zeros, adamw_init(params, cfg), cfg)
    for name, shrink in (("embed", True), ("layers/attn/wq/w", True), ("layers/ln1/scale", True),
                         ("final_norm/scale", False)):
        now = params[name] if isinstance(params[name], tuple) else (params[name],)
        for a, b in zip(now, before[name]):
            if shrink:
                np.testing.assert_allclose(a.numpy(), b.numpy() * (1 - 0.5 * 0.1), rtol=1e-6)
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_matches_reference(seed):
    """Three rounds of compress -> decompress with error feedback: ``q``
    equal exactly, scales and the feedback to 1e-6 relative."""
    tree = _tree(20 + seed)
    rerr = ref_comp.init_error_feedback(jax.tree.map(jnp.asarray, tree))
    err = init_error_feedback(_port(tree))
    assert all(t.dtype == torch.float32 and int(t.count_nonzero()) == 0 for t in _flat(err))
    for r in range(3):
        g = _tree(30 + 3 * seed + r, scale=10.0 ** (r - 1))
        rc, rerr = ref_comp.compress_grads(jax.tree.map(jnp.asarray, g), rerr)
        comp, err = compress_grads(_port(g), err)
        want_q, want_s = _moment_flat(_port(jax.tree.map(np.asarray, rc)), "int8")
        got_q, got_s = _moment_flat(comp, "int8")
        assert len(got_s) == 4  # one scale per reference leaf, stacked or not
        for a, b in zip(got_q, want_q):
            assert a.dtype == torch.int8 and torch.equal(a, b)
        for a, b in zip(got_s, want_s):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        for a, b in zip(_flat(err), _ref_flat(rerr)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)
        dec = decompress_grads(comp, _port(g))
        want = ref_comp.decompress_grads(rc, jax.tree.map(jnp.asarray, g))
        for a, b in zip(_flat(dec), _ref_flat(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


@pytest.mark.parametrize("m_dtype,v_dtype", [("float32", "float32"), ("int8", "bfloat16")])
def test_resume_from_reference_state(m_dtype, v_dtype):
    """Three reference steps, then its state carried across
    (``train_state_from_jax``: moments in their tiers, int8 codes split per
    layer under one scale, the step counter) and three more steps in each
    package: the carried state equals the reference's leaf for leaf, and the
    next losses agree (1e-5 relative: float32, one code of an int8 moment
    may round the other way)."""
    from repro.optim.adamw import AdamWConfig as RefAdamWConfig
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.train.trainer import TrainConfig as RefTrainConfig
    from repro.train.trainer import make_train_step as ref_make_train_step

    ref_cfg, cfg = ref_get_reduced("deepseek-moe-16b"), get_reduced("deepseek-moe-16b")
    kw = dict(microbatch=2, warmup_steps=2, total_steps=6)
    radam = RefAdamWConfig(lr=1e-3, m_dtype=m_dtype, v_dtype=v_dtype)
    params = ref_init_model(jax.random.PRNGKey(4), ref_cfg, dtype=jnp.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    stepf, _, _ = ref_make_train_step(ref_cfg, RefTrainConfig(adamw=radam, **kw), mesh,
                                      params_like=jax.eval_shape(lambda: params))
    data = RefSyntheticLM(cfg.vocab_size, 32, 4, seed=9)
    state = {"params": params, "opt": ref_adamw_init(params, radam)}
    want = []
    with mesh:
        for i in range(6):
            state, m = stepf(state, jax.tree.map(jnp.asarray, data.batch(i)))
            want.append(float(m["loss"]))
            if i == 2:
                carried = jax.tree.map(np.asarray, state)
    port = train_state_from_jax(carried, cfg, device="cpu")
    assert int(port["opt"]["step"]) == 3 and port["opt"]["step"].dtype == torch.int32
    for which, tier in (("m", m_dtype), ("v", v_dtype)):
        ref_leaves = leaves_from_jax(carried["opt"][which], "cpu")
        for name, leaf in port["opt"][which].items():
            if tier == "int8":
                assert torch.equal(leaf["scale"], ref_leaves[name]["scale"])
                leaf, ref_leaf = leaf["q"], ref_leaves[name]["q"]
            else:
                ref_leaf = ref_leaves[name]
            for a, b in zip(leaf if isinstance(leaf, tuple) else (leaf,),
                            ref_leaf if isinstance(ref_leaf, tuple) else (ref_leaf,)):
                assert a.dtype == {"int8": torch.int8, "bfloat16": torch.bfloat16,
                                   "float32": torch.float32}[tier]
                assert torch.equal(a, b)
        stacked = carried["opt"][which]["layers"]["attn"]["wq"]["w"]
        stacked = np.asarray(stacked["q"] if tier == "int8" else stacked)
        got = port["opt"][which]["layers/attn/wq/w"]
        got = got["q"] if tier == "int8" else got
        assert len(got) == cfg.num_layers and np.array_equal(
            torch.stack(got).float().numpy(), stacked.astype(np.float32))
    step = make_train_step(cfg, TrainConfig(adamw=AdamWConfig(lr=1e-3, m_dtype=m_dtype,
                                                              v_dtype=v_dtype), **kw),
                           device="cpu")
    for i in range(3, 6):
        port, m = step(port, data.batch(i))
        np.testing.assert_allclose(float(m["loss"]), want[i], rtol=1e-5)
