"""Parity of the port's training (``models.transformer.train_loss``,
``layers.cross_entropy``, ``train.make_train_step`` and ``train.Trainer``)
with the reference's, on the CPU.

Both packages compute with the same parameters (``models.convert``), and
the batches come from numpy with a seed (``data.pipeline.SyntheticLM``).
The reference's step and trainer run on a (1, 1) mesh with Auto axes: with
the default Explicit axes its ``lax.scan`` over microbatches refuses the
batch sharded over ``data`` under this container's jax 0.9.0, which is why
the reference's own ``tests/test_trainer_restart.py`` fails here.

Tolerances:
  * ``cross_entropy`` and the loss to 1e-6 relative (float32 sums);
  * every parameter's gradient, per leaf, within ``tol * max |want|``: 2e-5
    for the attention families (2.4e-6 seen) and 5e-4 for rwkv6 and zamba2
    (3.4e-5 and 9.1e-5 seen: their recurrences and chunked cumulative sums
    add in another order); musicgen runs in bfloat16 only (the reference
    refuses float32 for audio), at 0.05 (a bfloat16 gradient through two
    layers rounded at other places);
  * the train step, float32: the metrics of the first two steps (loss,
    the MoE's, gradient norm, learning rate) to 1e-5 relative and the
    parameters after them (the first step's learning rate is 0) to 1e-5
    absolute; zamba2 to 1e-4 (a gradient norm of 114 clipped to 1: 1.3e-5
    relative seen at the first step), and the losses of all six steps to
    1e-4 relative (zamba2's parameters drift by 7.8e-4 by the sixth step,
    its losses by 2.6e-5).  With int8 gradient
    compression the codes are a step function of the gradients, which the
    two packages compute to the last bit only: the decompressed gradients
    of the first step differ by at most one code (one scale) in at most
    1e-4 of their elements (9 of 756,352 seen), such an element moves its
    parameter by up to ~2 lr under AdamW, so the parameters are held to
    1e-5 in all but 1e-3 of their elements and to 4 lr in all, the error
    feedback (a difference of near-equal numbers, x - q * scale, with x
    up to 127 codes) to 2e-3 of a code in all but 1e-3 of its elements,
    and the metrics of the first two steps to 1e-4 relative;
  * the port's own restart and remat are bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import get_reduced as ref_get_reduced
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import layers as ref_layers
from repro.models.transformer import init_model as ref_init_model
from repro.models.transformer import train_loss as ref_train_loss
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.convert import leaves_from_jax, params_from_jax, train_state_from_jax
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer, make_train_step
from repro_torch.train.trainer import _accumulate_grads

HEADS = {"yi-9b": dict(num_heads=8, num_kv_heads=2)}  # GQA; get_reduced alone gives MHA
GRAD_CASES = [("yi-9b", jnp.float32, 2e-5), ("deepseek-moe-16b", jnp.float32, 2e-5),
              ("rwkv6-1.6b", jnp.float32, 5e-4), ("zamba2-2.7b", jnp.float32, 5e-4),
              ("musicgen-medium", jnp.bfloat16, 0.05)]
BATCH, SEQ = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small models: with several test
    workers on one machine, each running as many threads as it has cores,
    their many small ops ran up to 100x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    kw = HEADS.get(arch, {})
    return ref_get_reduced(arch, **kw), get_reduced(arch, **kw)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _batch(cfg, seed, step=0, batch=BATCH):
    return SyntheticLM(cfg.vocab_size, SEQ, batch, seed=seed,
                       embed_dim=cfg.d_model if cfg.takes_embeds else 0).batch(step)


def _parts(leaves):
    return [t for v in leaves.values() for t in (v if isinstance(v, tuple) else (v,))]


def _ref_parts(tree):
    return _parts(leaves_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _tensors(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("shape,dtype", [((2, 5, 17), np.float32), ((3, 11), np.float32),
                                         ((4, 7, 64), "bfloat16")])
def test_cross_entropy_matches_reference(shape, dtype):
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal(shape)).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = ref_layers.cross_entropy(jnp.asarray(logits, dtype), jnp.asarray(labels))
    t = torch.as_tensor(logits)
    got = cross_entropy(t.to(torch.bfloat16) if dtype == "bfloat16" else t,
                        torch.as_tensor(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch,dtype,tol", GRAD_CASES)
def test_train_loss_and_grads_match_reference(arch, dtype, tol):
    """The loss, its metrics and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's ``train_loss``."""
    ref_cfg, cfg = _cfgs(arch)
    params = ref_init_model(jax.random.PRNGKey(5), ref_cfg, dtype=dtype)
    b = _batch(cfg, seed=11, batch=2)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_train_loss(p, ref_cfg, jax.tree.map(jnp.asarray, b)), has_aux=True))(params)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    model.requires_grad_(True)
    leaves = transformer.param_leaves(model)
    loss, metrics = transformer.train_loss(model, cfg, _tensors(b))
    grads = torch.autograd.grad(loss, _parts(leaves))
    assert sorted(metrics) == sorted(want_m)
    rtol = 1e-6 if dtype == jnp.float32 else 2e-3
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]), rtol=rtol,
                                   atol=1e-7)
    want_leaves = leaves_from_jax(jax.tree.map(np.asarray, want_g), "cpu")
    assert list(want_leaves) == list(leaves)
    for got, w in zip(grads, _parts(want_leaves)):
        assert got.dtype == w.dtype and got.shape == w.shape
        w = w.float()
        np.testing.assert_allclose(got.float().numpy(), w.numpy(), rtol=0,
                                   atol=tol * float(w.abs().max()) + 1e-30)


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_remat_on_and_off_equal(arch, monkeypatch):
    """Per-layer remat changes nothing, bit for bit, and really recomputes:
    the MoE dispatches each layer twice, in the forward and the recompute."""
    _, cfg = _cfgs(arch)
    b = _tensors(_batch(cfg, seed=2, batch=2))
    calls = []
    plain = moe_mod.sort_dispatch
    monkeypatch.setattr(moe_mod, "sort_dispatch", lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = transformer.init_model(torch.Generator().manual_seed(1), c, dtype=torch.float32,
                                       device="cpu").requires_grad_(True)
        calls.clear()
        loss, _ = transformer.train_loss(model, c, b)
        grads = torch.autograd.grad(loss, _parts(transformer.param_leaves(model)))
        out.append((loss, grads, len(calls)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b_) for a, b_ in zip(out[0][1], out[1][1]))
    if cfg.family == "moe":
        assert (out[0][2], out[1][2]) == (cfg.num_layers, 2 * cfg.num_layers)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_param_leaves_are_the_reference_tree(arch):
    """Names and order of ``param_leaves`` equal the reference's flattened
    parameter tree, stacked leaves as tuples of one tensor per layer."""
    ref_cfg, cfg = _cfgs(arch)
    tree = jax.eval_shape(lambda: ref_init_model(jax.random.PRNGKey(0), ref_cfg))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    names = ["/".join(str(p.key) for p in path) for path, _ in flat]
    model = transformer.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = transformer.param_leaves(model)
    assert list(leaves) == names
    for (path, leaf), (name, got) in zip(flat, leaves.items()):
        if name.startswith("layers/"):
            assert isinstance(got, tuple) and len(got) == leaf.shape[0]
            assert all(tuple(t.shape) == leaf.shape[1:] for t in got)
        else:
            assert tuple(got.shape) == leaf.shape


def test_accumulation_dtypes():
    """A single shot keeps the parameters' dtypes (bf16 weights, f32 norm
    scales); microbatches
    sum in float32 and equal the mean of the microbatches' gradients."""
    _, cfg = _cfgs("yi-9b")
    model = transformer.init_model(torch.Generator().manual_seed(0), cfg,
                                   device="cpu").requires_grad_(True)
    b = _tensors(_batch(cfg, seed=4))
    _, _, one = _accumulate_grads(cfg, TrainConfig(), model, b)
    loss2, _, two = _accumulate_grads(cfg, TrainConfig(microbatch=2), model, b)
    params = _parts(transformer.param_leaves(model))
    assert any(p.dtype == torch.bfloat16 for p in params)
    assert all(t.dtype == p.dtype for t, p in zip(_parts(one), params))
    assert all(t.dtype == torch.float32 for t in _parts(two))
    halves = [_accumulate_grads(cfg, TrainConfig(), model, {k: v[i:i + 2] for k, v in b.items()})
              for i in (0, 2)]
    for t, a, c in zip(_parts(two), _parts(halves[0][2]), _parts(halves[1][2])):
        assert torch.equal(t, (torch.zeros_like(t) + a.float() + c.float()) / 2)
    assert torch.equal(loss2, (torch.zeros(()) + halves[0][0] + halves[1][0]) / 2)


def _ref_step_run(ref_cfg, tcfg_kw, params, data, steps, compress):
    from repro.optim.adamw import AdamWConfig as RefAdamWConfig
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.optim.compression import init_error_feedback as ref_init_eff
    from repro.train.trainer import TrainConfig as RefTrainConfig
    from repro.train.trainer import make_train_step as ref_make_train_step

    rt = RefTrainConfig(compress_grads=compress, adamw=RefAdamWConfig(lr=1e-3), **tcfg_kw)
    mesh = _mesh()
    stepf, _, _ = ref_make_train_step(ref_cfg, rt, mesh,
                                      params_like=jax.eval_shape(lambda: params))
    state = {"params": params, "opt": ref_adamw_init(params, rt.adamw)}
    if compress:
        state["eff"] = ref_init_eff(params)
    states, metrics = [jax.tree.map(np.asarray, state)], []
    with mesh:
        for i in range(steps):
            state, m = stepf(state, jax.tree.map(jnp.asarray, data.batch(i)))
            states.append(jax.tree.map(np.asarray, state))
            metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


@pytest.mark.parametrize("arch,compress,tol", [("yi-9b", False, 1e-5),
                                               ("deepseek-moe-16b", False, 1e-5),
                                               ("deepseek-moe-16b", True, 1e-5),
                                               ("zamba2-2.7b", False, 1e-4)])
def test_train_step_matches_reference(arch, compress, tol):
    """Six steps of ``make_train_step`` (microbatch 2 of 4, float32) from the
    same state and batches as the reference's."""
    ref_cfg, cfg = _cfgs(arch)
    kw = dict(microbatch=2, warmup_steps=2, total_steps=6)
    params = ref_init_model(jax.random.PRNGKey(3), ref_cfg, dtype=jnp.float32)
    data = RefSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=7)
    states, want = _ref_step_run(ref_cfg, kw, params, data, 6, compress)
    state = train_state_from_jax(states[0], cfg, device="cpu")
    step = make_train_step(cfg, TrainConfig(compress_grads=compress,
                                            adamw=AdamWConfig(lr=1e-3), **kw), device="cpu")
    lr = 1e-3
    for i in range(6):
        state, m = step(state, data.batch(i))
        assert sorted(m) == sorted(want[i])
        np.testing.assert_allclose(float(m["loss"]), want[i]["loss"], rtol=1e-4)
        for k in m if i < 2 else ():
            np.testing.assert_allclose(float(m[k]), want[i][k], atol=1e-7,
                                       rtol=1e-4 if compress else tol)
        if i != 1:
            continue
        got = _parts(transformer.param_leaves(state["params"]))
        ref = _ref_parts(states[2]["params"])
        diff = torch.cat([(a.detach() - b).abs().flatten() for a, b in zip(got, ref)])
        if compress:
            assert float((diff > tol).float().mean()) <= 1e-3
            assert float(diff.max()) <= 4 * lr
        else:
            assert float(diff.max()) <= tol
        if compress:  # the error feedback x - q * scale, |x - q * scale| <= scale / 2
            ref_eff = leaves_from_jax(states[2]["eff"], "cpu")
            for name, leaf in state["eff"].items():
                for t, w in zip(_parts({name: leaf}), _parts({name: ref_eff[name]})):
                    code = 2 * float(w.abs().max()) + 1e-30  # ~ one code's scale
                    assert float(((t - w).abs() > 2e-3 * code).float().mean()) <= 1e-3


def test_train_step_refuses_a_mesh():
    """A mesh whose axes are not the reference's (pod, data and model, model
    among them) is refused; a mesh of any size is taken (the sharded step,
    tests/test_torch_sharded.py), and no mesh gives the one-device step."""
    class Mesh:  # a DeviceMesh of four devices, as far as the step asks
        mesh_dim_names = ("rows", "cols")
        shape = (2, 2)
        device_type = "cpu"

        def size(self):
            return 4

    with pytest.raises(ValueError, match="pod, data and model"):
        make_train_step(get_reduced("yi-9b"), TrainConfig(), Mesh(), device="cpu")
    Mesh.mesh_dim_names = ("data", "expert")
    with pytest.raises(ValueError, match="model included"):
        make_train_step(get_reduced("yi-9b"), TrainConfig(), Mesh(), device="cpu")
    assert callable(make_train_step(get_reduced("yi-9b"), TrainConfig(), None, device="cpu"))


@pytest.mark.parametrize("arch,compress", [("yi-9b", False), ("deepseek-moe-16b", True),
                                           ("zamba2-2.7b", False)])
def test_trainer_restart_bitwise_identical(tmp_path, arch, compress):
    """The reference's restart test on the port: 6 steps straight equal 3
    steps, a checkpoint, a restore in a fresh ``Trainer`` and 3 more, bit
    for bit in every parameter, moment, error feedback and the counter."""
    _, cfg = _cfgs(arch)
    tcfg = TrainConfig(microbatch=2, warmup_steps=2, total_steps=6, compress_grads=compress,
                       adamw=AdamWConfig(lr=1e-3, m_dtype="int8" if compress else "float32"))
    data = lambda: iter(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=4,
                                    seed=7))
    quiet = dict(log_every=100, log=lambda *_: None)

    t0 = Trainer(cfg, tcfg, ckpt_dir=None, seed=0, device="cpu")
    t0.init_state()
    t0.run(data(), 6, ckpt_every=100, **quiet)

    ck = str(tmp_path / "ck")
    t1 = Trainer(cfg, tcfg, ckpt_dir=ck, seed=0, device="cpu")
    t1.init_state()
    t1.run(data(), 3, ckpt_every=3, **quiet)
    del t1  # "crash"

    t2 = Trainer(cfg, tcfg, ckpt_dir=ck, seed=0, device="cpu")
    t2.init_state()
    assert t2.maybe_restore(), "no checkpoint found"
    assert t2.step_num == 3
    it = data()
    for _ in range(t2.step_num):  # deterministic fast-forward
        next(it)
    t2.run(it, 3, ckpt_every=100, **quiet)

    want, got = t0._tree(), t2._tree()
    flat_w, spec_w = torch.utils._pytree.tree_flatten(want)
    flat_g, spec_g = torch.utils._pytree.tree_flatten(got)
    assert spec_w == spec_g and len(flat_w) > 0
    assert all(torch.equal(a, b) for a, b in zip(flat_w, flat_g))
    assert int(got["opt"]["step"]) == 6


def test_trainer_matches_reference_trainer():
    """The reference's ``Trainer`` (bfloat16 as it initialises, Auto mesh) and
    the port's from the same initial state: six steps of the same stream,
    the metrics of the last step and the parameters close (bfloat16
    weights rounded at other places: 1e-2 relative on the loss)."""
    from repro.optim.adamw import AdamWConfig as RefAdamWConfig
    from repro.train.trainer import TrainConfig as RefTrainConfig
    from repro.train.trainer import Trainer as RefTrainer

    ref_cfg, cfg = _cfgs("yi-9b")
    kw = dict(microbatch=2, warmup_steps=2, total_steps=6)
    mesh = _mesh()
    ref = RefTrainer(ref_cfg, RefTrainConfig(adamw=RefAdamWConfig(lr=1e-3), **kw), mesh, seed=0)
    with mesh:
        ref.init_state()
        init = jax.tree.map(np.asarray, ref.state)
        want = ref.run(iter(RefSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=7)), 6,
                       log_every=100, log=lambda *_: None)
    port = Trainer(cfg, TrainConfig(adamw=AdamWConfig(lr=1e-3), **kw), seed=0, device="cpu")
    port.state = train_state_from_jax(init, cfg, device="cpu")
    assert port.state["params"].dtype == torch.bfloat16
    got = port.run(iter(SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=7)), 6,
                   log_every=100, log=lambda *_: None)
    assert sorted(got) == sorted(want) and port.step_num == 6 and len(port.step_times) == 6
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-2)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)


def test_trainer_init_state_and_device(monkeypatch):
    """Seeded parameters with gradients on, zero moments; the trainer and
    the step default to the card and raise without one."""
    cfg = get_reduced("deepseek-moe-16b")
    tcfg = TrainConfig(compress_grads=True)
    a = Trainer(cfg, tcfg, seed=3, device="cpu").init_state()
    b = Trainer(cfg, tcfg, seed=3, device="cpu").init_state()
    c = Trainer(cfg, tcfg, seed=4, device="cpu").init_state()
    pa, pb, pc = (list(s["params"].parameters()) for s in (a, b, c))
    assert all(p.requires_grad for p in pa)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not all(torch.equal(x, y) for x, y in zip(pa, pc))
    assert int(a["opt"]["step"]) == 0 and "eff" in a
    assert all(int(t.count_nonzero()) == 0 for t in _parts(a["eff"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, tcfg)
