"""The port's serving engine (``repro_torch.serve.Engine``) on the CPU.

Greedy ``generate`` tokens equal the reference engine's, token for token,
in float32 with the same parameters (``models.convert.params_from_jax``),
for reduced yi-9b with GQA and codeqwen1.5-7b, under both
``flash_decode`` settings, and for reduced deepseek-moe-16b, qwen3-moe,
rwkv6 and zamba2 under ``flash_decode`` (K10's twin where the model has
attention; zamba2 also with ``max_seq`` above the hybrid's window, where
its shared attention decodes on rings without K10).  The reference engine runs on a one-device mesh
with Auto axes (with Explicit ones its ``shard_hint`` raises under this
container's jax 0.9.0, which is why the reference's own
``tests/test_serve_engine.py`` fails here).  Then the port's copies of
that file's two invariants: back-to-back ``generate`` calls equal fresh
engines (a shorter second prompt must not attend over the first call's
keys), and temperature sampling is deterministic per seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.registry import get_reduced as ref_get_reduced
from repro.models.policy import compute_policy as ref_policy
from repro.models.transformer import init_model as ref_init_model
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs import get_reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.policy import compute_policy
from repro_torch.models.transformer import init_model
from repro_torch.serve import Engine, ServeConfig
from torch_one_thread import one_torch_thread  # noqa: F401

HEADS = {"yi-9b": dict(num_heads=8, num_kv_heads=2),
         "codeqwen1.5-7b": dict(num_heads=8, num_kv_heads=8)}
FAMILIES = [("deepseek-moe-16b", 32), ("qwen3-moe-235b-a22b", 32), ("rwkv6-1.6b", 32),
            ("zamba2-2.7b", 32), ("zamba2-2.7b", 4100)]


def _prompts(cfg, b, plen, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, plen)).astype(np.int32)


@pytest.mark.parametrize("flash_decode", [False, True])
@pytest.mark.parametrize("arch", list(HEADS))
def test_greedy_tokens_match_reference_engine(arch, flash_decode):
    ref_cfg = ref_get_reduced(arch, **HEADS[arch])
    cfg = get_reduced(arch, **HEADS[arch])
    params = ref_init_model(jax.random.PRNGKey(0), ref_cfg, dtype=jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    prompts = _prompts(cfg, 2, 12, seed=1)
    ref_engine = RefEngine(ref_cfg, RefServeConfig(max_seq=32, batch_size=2), mesh, params)
    engine = Engine(cfg, ServeConfig(max_seq=32, batch_size=2), model, device="cpu")
    with ref_policy(flash_decode=flash_decode), compute_policy(flash_decode=flash_decode):
        with mesh:
            want = np.asarray(ref_engine.generate(jnp.asarray(prompts), 8))
        got = engine.generate(prompts, 8)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,max_seq", FAMILIES)
def test_family_greedy_tokens_match_reference_engine(arch, max_seq):
    ref_cfg, cfg = ref_get_reduced(arch), get_reduced(arch)
    params = ref_init_model(jax.random.PRNGKey(1), ref_cfg, dtype=jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    prompts = _prompts(cfg, 2, 12, seed=2)
    ref_engine = RefEngine(ref_cfg, RefServeConfig(max_seq=max_seq, batch_size=2), mesh, params)
    engine = Engine(cfg, ServeConfig(max_seq=max_seq, batch_size=2), model, device="cpu")
    with ref_policy(flash_decode=True), compute_policy(flash_decode=True):
        with mesh:
            want = np.asarray(ref_engine.generate(jnp.asarray(prompts), 8))
        got = engine.generate(prompts, 8)
        again = engine.generate(prompts, 8)  # the recurrent states start afresh
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, again)


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced("yi-9b", num_layers=1)
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, model


@pytest.mark.parametrize("flash_decode", [False, True])
def test_double_generate_matches_fresh_engines(setup, flash_decode):
    """Two back-to-back generate() calls == two fresh engines; the second
    prompt is shorter than the first, and the cache buffer is the same."""
    cfg, model = setup
    scfg = ServeConfig(max_seq=32, batch_size=2)
    p_long = _prompts(cfg, 2, 12, seed=1)
    p_short = _prompts(cfg, 2, 4, seed=2)
    with compute_policy(flash_decode=flash_decode):
        engine = Engine(cfg, scfg, model, device="cpu")
        out1 = engine.generate(p_long, 6)
        buf = engine.cache["layers"][0]["k"]
        out2 = engine.generate(p_short, 6)
        assert engine.cache["layers"][0]["k"] is buf
        ref1 = Engine(cfg, scfg, model, device="cpu").generate(p_long, 6)
        ref2 = Engine(cfg, scfg, model, device="cpu").generate(p_short, 6)
    assert torch.equal(out1, ref1)
    assert torch.equal(out2, ref2)


def test_sampled_generate_deterministic_per_seed(setup):
    """Temperature sampling: same seed -> same stream, different seed ->
    different stream."""
    cfg, model = setup
    scfg = ServeConfig(max_seq=32, batch_size=2, temperature=1.0)
    p = _prompts(cfg, 2, 8, seed=3)
    engine = Engine(cfg, scfg, model, device="cpu")
    a = engine.generate(p, 8, seed=0)
    b = engine.generate(p, 8, seed=0)
    c = engine.generate(p, 8, seed=1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_engine_checks(setup, monkeypatch):
    cfg, model = setup
    engine = Engine(cfg, ServeConfig(max_seq=32, batch_size=2), model, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        engine.generate(_prompts(cfg, 3, 4, seed=4), 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, ServeConfig(max_seq=32, batch_size=2), model)


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_trainable_model_serves_without_a_graph(arch):
    """A model whose gradients a trainer turned on gives the tokens it gave
    frozen, and ``generate`` records no graph: no output or cache tensor
    requires grad or hangs on a backward node."""
    cfg = get_reduced(arch)
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    scfg = ServeConfig(max_seq=32, batch_size=2)
    prompts = _prompts(cfg, 2, 8, seed=5)
    want = Engine(cfg, scfg, model, device="cpu").generate(prompts, 6)
    model.requires_grad_(True)
    engine = Engine(cfg, scfg, model, device="cpu")
    got = engine.generate(prompts, 6)
    assert torch.equal(got, want)
    assert not got.requires_grad
    cached = [t for group in engine.cache.values() for c in group for t in c.values()
              if isinstance(t, torch.Tensor)]
    assert cached and all(not t.requires_grad and t.grad_fn is None for t in cached)
