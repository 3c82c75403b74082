"""Parity of the port's LM substrate with the reference, on the CPU.

``models.layers`` (``rms_norm``, ``rope``, ``swiglu``, ``gelu_mlp``),
``models.attention.attention`` in its five modes (training, prefill,
decode on a linear cache, decode on a windowed ring buffer, and the
KV-chunked ``flash_block`` policy), and the whole ``models.transformer``
(``forward``, then prefill + decode) of reduced yi-9b with GQA
(``num_heads=8, num_kv_heads=2``: ``get_reduced`` alone gives MHA),
codeqwen1.5-7b (qkv bias) and musicgen-medium (embeddings in, GELU MLP),
under both ``flash_decode`` settings (the port's K10 twin beside the
reference's Pallas kernel in interpret mode).  Both packages compute with
the same parameters (``models.convert.params_from_jax``) and inputs made
with numpy from a seed.  Tolerances: float32 1e-5 on the layers and on
attention, 1e-4 on the logits (the same math in another summation order
over a few layers); bfloat16 logits within 0.1 absolute of the reference
(logits up to ~4.6, where a bfloat16 step is 2^-5 = 0.031: a few steps,
since bfloat16 rounds the activations at other places in the two
frameworks, e.g. silu and the einsum outputs; 0.047 was the largest
difference seen).

The other families: reduced deepseek-moe-16b (shared experts) and
qwen3-moe (GQA, 128 -> 8 experts) with the MoE aux, rwkv6 (the RWKV-6
state per layer) and zamba2 (Mamba2 groups with the shared attention,
once with ``max_seq`` above ``HYBRID_ATTN_WINDOW``: a ring of 4096 slots
per group), forward and prefill + decode in float32 (and rwkv6 in
bfloat16), and their ``params_from_jax`` trees.  The MoE and hybrid models
are not compared in bfloat16: the MoE router's top-k is a discrete
function of the bfloat16 activations, which the two frameworks round at
other places, so a near tie routes a token to another expert (2% of the
logits moved by up to 1.07 in a try); Mamba2's dt is the in-projection's
bfloat16 output, and one bfloat16 step there (2^-8 relative) moves the
cumulative log-decay, ~10^2 over a chunk, by ~0.4 (13% of the logits moved
by up to 1.34 in a try).  Those layers are held in bfloat16 on identical
inputs (``tests/test_torch_moe.py``, ``tests/test_torch_ssm.py``).  rwkv6's bfloat16 logits are held
at 0.25: the per-head group norm (eps 64e-5 over 16 channels here)
divides by a head's spread, so a one-step bfloat16 difference in r, k or
v grows where a head's variance is small (0.156 seen).  In float32 the
logits of rwkv6's and
zamba2's decode steps are held at 2e-3 absolute: the reference keeps the
token-shift and conv states in bfloat16 whatever the model's dtype, so a
last-bit difference in a float32 activation can round a state entry to
the neighbouring bfloat16 value (2^-8 relative) and move the next step's
logits (up to 5.6e-4 seen); their forward and prefill stay at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as ref_get_reduced
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.policy import compute_policy as ref_policy
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_decode_cache as ref_init_decode_cache
from repro.models.transformer import init_model as ref_init_model
from repro_torch.configs import get_reduced
from repro_torch.models import attention, layers, transformer
from repro_torch.models.convert import params_from_jax, to_torch
from repro_torch.models.policy import compute_policy
from torch_one_thread import one_torch_thread  # noqa: F401

TOL32 = 1e-5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol, rtol=None):
    np.testing.assert_allclose(np.asarray(got.to(torch.float32)),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol if rtol is None else rtol)


def close_logits(got, want, dtype, tol):
    """float32: atol = rtol = tol; bfloat16: |got - want| <= tol absolute."""
    close(got, want, tol, rtol=tol if dtype == jnp.float32 else 0.0)


def dense_of(p):
    return layers.Dense(to_torch(p["w"]), to_torch(p["b"]) if "b" in p else None)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    want = ref_layers.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = layers.rms_norm(layers.RMSNorm(torch.as_tensor(scale)), torch.as_tensor(x), 1e-6)
    close(got, want, TOL32)
    # bfloat16 in, bfloat16 out, computed in float32
    xb = jnp.asarray(x, jnp.bfloat16)
    got_b = layers.rms_norm(layers.RMSNorm(torch.as_tensor(scale)), to_torch(np.asarray(xb)))
    assert got_b.dtype == torch.bfloat16
    close(got_b, ref_layers.rms_norm({"scale": jnp.asarray(scale)}, xb), 1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    # angles up to ~4000 rad: cos/sin of a float32 angle, two libms
    close(got, want, 1e-4)
    small = rng.integers(0, 64, (2, 9)).astype(np.int32)
    close(layers.rope(torch.as_tensor(x), torch.as_tensor(small), theta),
          ref_layers.rope(jnp.asarray(x), jnp.asarray(small), theta), TOL32)


def test_mlps_match_reference():
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    p = {name: ref_layers.init_dense(k, *shape, dtype=jnp.float32)
         for name, k, shape in zip(("gate", "up", "down"), keys,
                                   ((64, 96), (64, 96), (96, 64)))}
    x = np.random.default_rng(2).standard_normal((2, 7, 64)).astype(np.float32)
    sw = layers.SwiGLU(dense_of(p["gate"]), dense_of(p["up"]), dense_of(p["down"]))
    close(layers.swiglu(sw, torch.as_tensor(x)), ref_layers.swiglu(p, jnp.asarray(x)), TOL32)
    gm = layers.GeluMLP(dense_of(p["up"]), dense_of(p["down"]))
    close(layers.gelu_mlp(gm, torch.as_tensor(x)), ref_layers.gelu_mlp(p, jnp.asarray(x)),
          TOL32)


# --------------------------------------------------------------------------
# attention, five modes
# --------------------------------------------------------------------------

B, D, H, KVH, HD = 2, 64, 8, 2, 16
KW = dict(num_heads=H, num_kv_heads=KVH, head_dim=HD, rope_theta=1e4)


@pytest.fixture(scope="module")
def attn_params():
    p = ref_attn.init_attention(jax.random.PRNGKey(3), D, H, KVH, HD, bias=True,
                                dtype=jnp.float32)
    # non-zero biases, so the qkv bias is exercised
    p = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, p)
    port = attention.Attention(*(dense_of(p[n]) for n in ("wq", "wk", "wv", "wo")))
    return p, port


def _x(seed, s):
    return np.random.default_rng(seed).standard_normal((B, s, D)).astype(np.float32)


def _pos(start, s):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None], (B, s)).copy()


@pytest.mark.parametrize("window,flash_block", [(0, 0), (5, 0), (0, 8), (6, 8)])
def test_attention_training_matches_reference(attn_params, window, flash_block):
    p, port = attn_params
    x, pos = _x(4, 24), _pos(0, 24)
    with ref_policy(flash_block=flash_block), compute_policy(flash_block=flash_block):
        want, _ = ref_attn.attention(p, jnp.asarray(x), jnp.asarray(pos), window=window, **KW)
        got, none = attention.attention(port, torch.as_tensor(x), torch.as_tensor(pos),
                                        window=window, **KW)
    assert none is None
    close(got, want, TOL32)


@pytest.mark.parametrize("flash_block", [0, 8])
@pytest.mark.parametrize("flash_decode", [False, True])
def test_attention_prefill_then_decode_linear(attn_params, flash_block, flash_decode):
    """Prefill of 10 tokens into a 32-slot cache, then 4 decode steps; the
    cache is updated in place and matches the reference's."""
    p, port = attn_params
    x = _x(5, 14)
    ref_cache = ref_attn.init_cache(B, 32, KVH, HD, dtype=jnp.float32)
    cache = attention.init_cache(B, 32, KVH, HD, dtype=torch.float32, device="cpu")
    k_buf = cache["k"]
    with ref_policy(flash_block=flash_block, flash_decode=flash_decode), \
            compute_policy(flash_block=flash_block, flash_decode=flash_decode):
        want, ref_cache = ref_attn.attention(p, jnp.asarray(x[:, :10]), jnp.asarray(_pos(0, 10)),
                                             cache=ref_cache, update_cache=True, **KW)
        got, cache = attention.attention(port, torch.as_tensor(x[:, :10]),
                                         torch.as_tensor(_pos(0, 10)), cache=cache, **KW)
        close(got, want, TOL32)
        for i in range(10, 14):
            want, ref_cache = ref_attn.attention(
                p, jnp.asarray(x[:, i:i + 1]), jnp.asarray(_pos(i, 1)), cache=ref_cache,
                update_cache=True, **KW)
            got, cache = attention.attention(port, torch.as_tensor(x[:, i:i + 1]),
                                             torch.as_tensor(_pos(i, 1)), cache=cache, **KW)
            close(got, want, TOL32)
    assert cache["k"] is k_buf and cache["pos"] == int(ref_cache["pos"]) == 14
    close(cache["k"], ref_cache["k"], TOL32)
    close(cache["v"], ref_cache["v"], TOL32)


@pytest.mark.parametrize("prompt", [4, 11])
def test_attention_decode_windowed_ring(attn_params, prompt):
    """A ring of 6 slots (window 6): a prompt shorter and one longer than
    the ring (rolled into ring order), then decode steps that wrap it."""
    p, port = attn_params
    window, steps = 6, 9
    x = _x(6, prompt + steps)
    ref_cache = ref_attn.init_cache(B, 64, KVH, HD, window=window, dtype=jnp.float32)
    cache = attention.init_cache(B, 64, KVH, HD, window=window, dtype=torch.float32,
                                 device="cpu")
    assert cache["k"].shape[1] == window
    want, ref_cache = ref_attn.attention(p, jnp.asarray(x[:, :prompt]),
                                         jnp.asarray(_pos(0, prompt)), window=window,
                                         cache=ref_cache, update_cache=True, **KW)
    got, cache = attention.attention(port, torch.as_tensor(x[:, :prompt]),
                                     torch.as_tensor(_pos(0, prompt)), window=window,
                                     cache=cache, **KW)
    close(got, want, TOL32)
    close(cache["k"], ref_cache["k"], TOL32)
    # K10 takes no ring: the policy leaves windowed decode on the eager path
    with ref_policy(flash_decode=True), compute_policy(flash_decode=True):
        for i in range(prompt, prompt + steps):
            want, ref_cache = ref_attn.attention(
                p, jnp.asarray(x[:, i:i + 1]), jnp.asarray(_pos(i, 1)), window=window,
                cache=ref_cache, update_cache=True, **KW)
            got, cache = attention.attention(port, torch.as_tensor(x[:, i:i + 1]),
                                             torch.as_tensor(_pos(i, 1)), window=window,
                                             cache=cache, **KW)
            close(got, want, TOL32)
    close(cache["v"], ref_cache["v"], TOL32)


def test_prefill_rewrites_a_used_cache(attn_params):
    """A prefill into a cache that holds an earlier, longer sequence leaves
    no stale slot: the reference builds a new cache, the port rewrites every
    slot of its buffer."""
    _, port = attn_params
    cache = attention.init_cache(B, 16, KVH, HD, dtype=torch.float32, device="cpu")
    attention.attention(port, torch.as_tensor(_x(7, 12)), torch.as_tensor(_pos(0, 12)),
                        cache=cache, **KW)
    fresh = attention.init_cache(B, 16, KVH, HD, dtype=torch.float32, device="cpu")
    x = torch.as_tensor(_x(8, 5))
    attention.attention(port, x, torch.as_tensor(_pos(0, 5)), cache=cache, **KW)
    attention.attention(port, x, torch.as_tensor(_pos(0, 5)), cache=fresh, **KW)
    assert torch.equal(cache["k"], fresh["k"]) and torch.equal(cache["v"], fresh["v"])
    assert cache["pos"] == 5


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

MODELS = {
    "yi-9b": dict(num_heads=8, num_kv_heads=2),
    "codeqwen1.5-7b": dict(num_heads=8, num_kv_heads=8),
    "musicgen-medium": dict(num_heads=8, num_kv_heads=4),
}
# (arch, dtype, logits tolerance).  The reference runs musicgen (embeddings
# cast to bfloat16 in) only with bfloat16 weights: with float32 ones its
# layer scan's carry turns float32 and jax refuses the scan.
CASES = [("yi-9b", jnp.float32, 1e-4), ("codeqwen1.5-7b", jnp.float32, 1e-4),
         ("yi-9b", jnp.bfloat16, 0.1), ("codeqwen1.5-7b", jnp.bfloat16, 0.1),
         ("musicgen-medium", jnp.bfloat16, 0.1)]
PROMPT, STEPS, MAX_SEQ, BATCH = 12, 5, 32, 2


def _models(arch, dtype):
    ref_cfg = ref_get_reduced(arch, **MODELS[arch])
    cfg = get_reduced(arch, **MODELS[arch])
    params = ref_init_model(jax.random.PRNGKey(7), ref_cfg, dtype=dtype)
    return ref_cfg, cfg, params, params_from_jax(np_tree(params), cfg, device="cpu")


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.takes_embeds:
        return rng.standard_normal((BATCH, PROMPT + STEPS, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)


def test_configs_are_the_reference_configs():
    from repro.configs.registry import ARCHS as REF_ARCHS
    from repro.configs.registry import get_config as ref_get_config
    from repro_torch.configs import ARCHS, get_config

    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        assert repr(get_config(arch)) == repr(ref_get_config(arch))
        assert repr(get_reduced(arch, num_heads=8)) == repr(ref_get_reduced(arch, num_heads=8))


def test_params_from_jax_copies_every_weight():
    ref_cfg, cfg, params, model = _models("codeqwen1.5-7b", jnp.float32)
    flat = jax.tree_util.tree_flatten_with_path(np_tree(params))[0]
    n_ref = sum(leaf.size for _, leaf in flat)
    assert n_ref == sum(t.numel() for t in model.parameters())
    assert len(model.layers) == cfg.num_layers
    blk = model.layers[1]
    lp = params["layers"]
    np.testing.assert_array_equal(blk.attn.wq.w.numpy(), np.asarray(lp["attn"]["wq"]["w"][1]))
    np.testing.assert_array_equal(blk.attn.wk.b.numpy(), np.asarray(lp["attn"]["wk"]["b"][1]))
    np.testing.assert_array_equal(blk.mlp.down.w.numpy(), np.asarray(lp["mlp"]["down"]["w"][1]))
    np.testing.assert_array_equal(model.embed.numpy(), np.asarray(params["embed"]))
    np.testing.assert_array_equal(model.lm_head.w.numpy(), np.asarray(params["lm_head"]["w"]))
    # bfloat16 leaves keep their bits; norm scales stay float32
    _, _, params_b, model_b = _models("yi-9b", jnp.bfloat16)
    assert model_b.dtype == torch.bfloat16 and model_b.final_norm.scale.dtype == torch.float32
    np.testing.assert_array_equal(
        model_b.layers[0].mlp.gate.w.view(torch.int16).numpy(),
        np.asarray(params_b["layers"]["mlp"]["gate"]["w"][0]).view(np.int16))


@pytest.mark.parametrize("arch,dtype,tol", CASES)
def test_forward_matches_reference(arch, dtype, tol):
    ref_cfg, cfg, params, model = _models(arch, dtype)
    x = _inputs(cfg, 9)
    want, _, _ = ref_forward(params, ref_cfg, jnp.asarray(x))
    got, none, aux = transformer.forward(model, cfg, torch.as_tensor(x))
    assert none is None and aux is None
    assert got.shape == (BATCH, PROMPT + STEPS, cfg.vocab_size)
    close_logits(got, want, dtype, tol)


@pytest.mark.parametrize("flash_decode", [False, True])
@pytest.mark.parametrize("arch,dtype,tol", CASES)
def test_prefill_decode_matches_reference(arch, dtype, tol, flash_decode):
    ref_cfg, cfg, params, model = _models(arch, dtype)
    x = _inputs(cfg, 10)
    tdt = model.dtype
    ref_cache = ref_init_decode_cache(ref_cfg, BATCH, MAX_SEQ, dtype=dtype)
    cache = transformer.init_decode_cache(cfg, BATCH, MAX_SEQ, dtype=tdt, device="cpu")
    with ref_policy(flash_decode=flash_decode), compute_policy(flash_decode=flash_decode):
        want, ref_cache, _ = ref_forward(params, ref_cfg, jnp.asarray(x[:, :PROMPT]),
                                         cache=ref_cache, update_cache=True)
        got, cache, _ = transformer.forward(model, cfg, torch.as_tensor(x[:, :PROMPT]),
                                            cache=cache)
        close_logits(got, want, dtype, tol)
        for i in range(PROMPT, PROMPT + STEPS):
            pos = np.full((BATCH, 1), i, np.int32)
            want, ref_cache, _ = ref_forward(params, ref_cfg, jnp.asarray(x[:, i:i + 1]),
                                             positions=jnp.asarray(pos), cache=ref_cache,
                                             update_cache=True)
            got, cache, _ = transformer.forward(model, cfg, torch.as_tensor(x[:, i:i + 1]),
                                                positions=torch.as_tensor(pos), cache=cache)
            close_logits(got, want, dtype, tol)
    assert [c["pos"] for c in cache["layers"]] == [PROMPT + STEPS] * cfg.num_layers
    close_logits(cache["layers"][-1]["k"], ref_cache["layers"]["k"][-1], dtype, tol)


def test_decode_matches_full_forward():
    """Teacher forcing: prefill + decode logits equal the full forward's at
    the same positions, with K10's twin and with the eager path."""
    _, cfg, _, model = _models("yi-9b", jnp.float32)
    x = torch.as_tensor(_inputs(cfg, 11))
    full, _, _ = transformer.forward(model, cfg, x)
    for flash_decode in (False, True):
        cache = transformer.init_decode_cache(cfg, BATCH, MAX_SEQ, dtype=torch.float32,
                                              device="cpu")
        with compute_policy(flash_decode=flash_decode):
            transformer.forward(model, cfg, x[:, :PROMPT], cache=cache)
            for i in range(PROMPT, PROMPT + STEPS):
                got, cache, _ = transformer.forward(
                    model, cfg, x[:, i:i + 1], positions=torch.full((BATCH, 1), i),
                    cache=cache)
                close(got[:, 0], full[:, i].numpy(), 1e-4)


@pytest.mark.parametrize("arch,dtype,tol", CASES)
def test_train_loss_matches_reference(arch, dtype, tol):
    """The training loss and its metrics against the reference's
    ``train_loss`` (gradients: ``tests/test_torch_train.py``); float32 to
    1e-6 relative, bfloat16 to 1e-2 (its logits within ``tol``)."""
    from repro.models.transformer import train_loss as ref_train_loss

    ref_cfg, cfg, params, model = _models(arch, dtype)
    x = _inputs(cfg, 13)
    labels = np.random.default_rng(14).integers(0, cfg.vocab_size, x.shape[:2]).astype(np.int32)
    want, want_m = ref_train_loss(params, ref_cfg, {"inputs": jnp.asarray(x),
                                                    "labels": jnp.asarray(labels)})
    got, metrics = transformer.train_loss(model, cfg, {"inputs": torch.as_tensor(x),
                                                       "labels": torch.as_tensor(labels)})
    assert sorted(metrics) == sorted(want_m) == ["ce", "loss"]
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want),
                               rtol=1e-6 if dtype == jnp.float32 else 1e-2)


# --------------------------------------------------------------------------
# the moe, ssm and hybrid families
# --------------------------------------------------------------------------

FAMILIES = ("deepseek-moe-16b", "qwen3-moe-235b-a22b", "rwkv6-1.6b", "zamba2-2.7b")
FAMILY_CASES = ([(arch, jnp.float32, 1e-4) for arch in FAMILIES]
                + [("rwkv6-1.6b", jnp.bfloat16, 0.25)])
STATE_TOL32 = 2e-3  # float32 decode logits of the families with bfloat16 states


def _family(arch, dtype):
    ref_cfg, cfg = ref_get_reduced(arch), get_reduced(arch)
    params = ref_init_model(jax.random.PRNGKey(8), ref_cfg, dtype=dtype)
    return ref_cfg, cfg, params, params_from_jax(np_tree(params), cfg, device="cpu")


@pytest.mark.parametrize("arch,dtype,tol", FAMILY_CASES)
def test_family_forward_matches_reference(arch, dtype, tol):
    ref_cfg, cfg, params, model = _family(arch, dtype)
    x = _inputs(cfg, 12)
    want, _, want_aux = ref_forward(params, ref_cfg, jnp.asarray(x))
    got, none, aux = transformer.forward(model, cfg, torch.as_tensor(x))
    assert none is None and got.shape == (BATCH, PROMPT + STEPS, cfg.vocab_size)
    close_logits(got, want, dtype, tol)
    assert (aux is None) == (want_aux is None) == (cfg.family != "moe")
    if aux is not None:
        assert int(aux["dropped"]) == int(want_aux["dropped"]) == 0  # lossless capacity
        assert int(aux["max_load"]) == int(want_aux["max_load"])
        np.testing.assert_allclose(float(aux["lb_loss"]), float(want_aux["lb_loss"]),
                                   rtol=1e-4 if dtype == jnp.float32 else 0.05)


# the hybrid once above the window: its shared attention's caches are rings
@pytest.mark.parametrize("arch,dtype,tol,max_seq",
                         [case + (MAX_SEQ,) for case in FAMILY_CASES]
                         + [("zamba2-2.7b", jnp.float32, 1e-4, 4100)])
def test_family_prefill_decode_matches_reference(arch, dtype, tol, max_seq):
    ref_cfg, cfg, params, model = _family(arch, dtype)
    x = _inputs(cfg, 13)
    ref_cache = ref_init_decode_cache(ref_cfg, BATCH, max_seq, dtype=dtype)
    cache = transformer.init_decode_cache(cfg, BATCH, max_seq, dtype=model.dtype, device="cpu")
    if arch == "zamba2-2.7b":
        slots = transformer.HYBRID_ATTN_WINDOW if max_seq > transformer.HYBRID_ATTN_WINDOW \
            else max_seq
        assert [c["k"].shape[1] for c in cache["attn"]] == [slots] * 2
    step_tol = STATE_TOL32 if dtype == jnp.float32 and cfg.family in ("ssm", "hybrid") else tol
    with ref_policy(flash_decode=True), compute_policy(flash_decode=True):
        want, ref_cache, _ = ref_forward(params, ref_cfg, jnp.asarray(x[:, :PROMPT]),
                                         cache=ref_cache, update_cache=True)
        got, cache, _ = transformer.forward(model, cfg, torch.as_tensor(x[:, :PROMPT]),
                                            cache=cache)
        close_logits(got, want, dtype, tol)
        for i in range(PROMPT, PROMPT + STEPS):
            pos = np.full((BATCH, 1), i, np.int32)
            want, ref_cache, _ = ref_forward(params, ref_cfg, jnp.asarray(x[:, i:i + 1]),
                                             positions=jnp.asarray(pos), cache=ref_cache,
                                             update_cache=True)
            got, cache, _ = transformer.forward(model, cfg, torch.as_tensor(x[:, i:i + 1]),
                                                positions=torch.as_tensor(pos), cache=cache)
            close(got, want, step_tol, rtol=tol if dtype == jnp.float32 else 0.0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_matches_full_forward(arch):
    """Teacher forcing in float32: prefill + decode logits equal the full
    forward's at the same positions.  For rwkv6 and zamba2 within 5e-2: a
    decode step reads the bfloat16-rounded shift and conv states where the
    full forward reads the float32 activations (a relative change of up to
    2^-9 in those inputs; 8.4e-3 seen for rwkv6, 3.1e-2 for zamba2, whose
    conv feeds the scan), as in the reference."""
    _, cfg, _, model = _family(arch, jnp.float32)
    x = torch.as_tensor(_inputs(cfg, 14))
    full, _, _ = transformer.forward(model, cfg, x)
    cache = transformer.init_decode_cache(cfg, BATCH, MAX_SEQ, dtype=torch.float32,
                                          device="cpu")
    transformer.forward(model, cfg, x[:, :PROMPT], cache=cache)
    tol = 5e-2 if cfg.family in ("ssm", "hybrid") else 1e-4
    for i in range(PROMPT, PROMPT + STEPS):
        got, cache, _ = transformer.forward(
            model, cfg, x[:, i:i + 1], positions=torch.full((BATCH, 1), i), cache=cache)
        close(got[:, 0], full[:, i].numpy(), tol, rtol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_params_from_jax_copies_every_weight(arch):
    _, cfg, params, model = _family(arch, jnp.bfloat16)
    assert sum(a.size for a in jax.tree.leaves(np_tree(params))) == sum(
        t.numel() for t in model.parameters())
    lp = params["layers"]
    blk = model.layers[1]
    if cfg.family == "moe":
        np.testing.assert_array_equal(blk.mlp.experts.down.view(torch.int16).numpy(),
                                      np.asarray(lp["mlp"]["experts"]["down"][1]).view(np.int16))
        assert blk.mlp.router.w.dtype == torch.float32
    elif cfg.family == "ssm":
        np.testing.assert_array_equal(blk.mix.tm.bonus.numpy(),
                                      np.asarray(lp["mix"]["tm"]["bonus"][1]))
        np.testing.assert_array_equal(blk.mix.cm.wr.w.view(torch.int16).numpy(),
                                      np.asarray(lp["mix"]["cm"]["wr"]["w"][1]).view(np.int16))
    else:
        np.testing.assert_array_equal(blk.mamba.A_log.numpy(),
                                      np.asarray(lp["mamba"]["A_log"][1]))
        np.testing.assert_array_equal(
            model.shared_attn.attn.wq.w.view(torch.int16).numpy(),
            np.asarray(params["shared_attn"]["attn"]["wq"]["w"]).view(np.int16))
        assert len(model.layers) == cfg.num_layers


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_model_matches_reference_shapes(arch):
    cfg = get_reduced(arch)
    m = transformer.init_model(torch.Generator().manual_seed(1), cfg, device="cpu")
    ref = jax.eval_shape(lambda: ref_init_model(jax.random.PRNGKey(0), ref_get_reduced(arch)))
    assert sum(t.numel() for t in m.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert m.dtype == torch.bfloat16


BUILDERS = {
    "init_model": lambda gen, **kw: transformer.init_model(gen, get_reduced("yi-9b"), **kw),
    "init_attention": lambda gen, **kw: attention.init_attention(gen, D, H, KVH, HD, **kw),
    "init_dense": lambda gen, **kw: layers.init_dense(gen, D, HD, **kw),
    "init_norm": lambda gen, **kw: layers.init_norm(D, **kw),
    "init_cache": lambda gen, **kw: attention.init_cache(B, 16, KVH, HD, **kw),
    "init_decode_cache": lambda gen, **kw: transformer.init_decode_cache(
        get_reduced("yi-9b"), B, 16, **kw),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builders_default_to_the_card(name, monkeypatch):
    """Every builder puts its tensors on the card unless asked for the CPU,
    raises where there is no card, and draws from a generator on the device
    it builds on."""
    build = BUILDERS[name]
    gen = torch.Generator().manual_seed(0)
    built = build(gen, device="cpu")
    tensors = (list(built.parameters()) if isinstance(built, torch.nn.Module)
               else [t for c in built.get("layers", [built]) for t in (c["k"], c["v"])])
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(gen)
    if name not in ("init_norm", "init_cache", "init_decode_cache"):  # these draw nothing
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="generator on cpu"):
            build(gen, device="cuda")


def test_init_model_distributions():
    """The reference's distributions from a seeded torch.Generator: same
    shapes and dtypes as the reference's pytree, weights ~ N(0, 1/d_in),
    the embedding ~ N(0, 0.02^2), unit norms, zero biases; one seed gives
    one model."""
    cfg = get_reduced("codeqwen1.5-7b")
    m1 = transformer.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    m2 = transformer.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m1.parameters(), m2.parameters()))
    ref = np_tree(ref_init_model(jax.random.PRNGKey(0), ref_get_reduced("codeqwen1.5-7b")))
    assert sum(t.numel() for t in m1.parameters()) == sum(
        a.size for a in jax.tree.leaves(ref))
    w = m1.layers[0].mlp.up.w.float()
    assert w.dtype == torch.float32 and m1.layers[0].mlp.up.w.dtype == torch.bfloat16
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(m1.embed.float().std()) / 0.02 - 1) < 0.05
    assert torch.equal(m1.layers[0].attn.wq.b, torch.zeros_like(m1.layers[0].attn.wq.b))
    assert torch.equal(m1.final_norm.scale, torch.ones(cfg.d_model))


def test_policy_stack():
    from repro_torch.models.policy import current_policy

    assert current_policy().flash_block == 0 and not current_policy().flash_decode
    with compute_policy(flash_block=1024):
        assert current_policy().flash_block == 1024
        with compute_policy(flash_decode=True):
            assert current_policy().flash_block == 1024
            assert current_policy().flash_decode
        assert not current_policy().flash_decode
    assert current_policy().flash_block == 0
