"""The port's sharded steps over a ``DeviceMesh`` against one device and the
reference, on the CPU: the MoE over a mesh (expert parallelism and the
baseline), the sharded train step, the trainer's restart from each rank's
shards, and the sharded prefill and decode steps.

Four ``gloo`` ranks are spawned once for the module (``torch.multiprocessing``,
spawn, a ``file://`` rendezvous under a temporary directory) and run every
case; the reference runs in one child process with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on meshes with Auto
axes (jax 0.9.0 makes Explicit axes by default, under which the reference's
own expert-parallel test fails); the one-device references of the port run
in this process, all three at once.

Tolerances:
  * expert parallelism on (1, 4), float32, E = 8, k = 2, d = 32: outputs
    and gradients within 2e-5 absolute plus 2e-5 relative of the port's
    baseline and of the reference's expert-parallel column (the reference's
    own bound, ``tests/test_perf_paths.py:104``); ``dropped`` and
    ``max_load`` exact.  With a capacity that drops entries, ``dropped``
    is held to the baseline's only: the reference's column returns one
    column's count as if replicated, the port sums the columns';
  * the sharded train step on (2, 2), float32, two steps of microbatch 2 of
    4: the metrics to 1e-5 relative and the parameters to 1e-5 absolute of
    the one-device step and of the reference's (the bounds of
    ``tests/test_torch_train.py``); with int8
    first moments the scales to 1e-6 relative and every code equal to the
    reference's but where x / scale lies within 1e-3 of a half-integer (a
    code is a step function of float sums the two sides add in other
    orders), a code that so differed at step 1 carried into step 2 (see
    ``_int8_codes_match``), and the parameters as under that file's compression
    bound (1e-5 in all but 1e-3, 4 lr in all);
  * the baseline MoE (no ``explicit_ep``) over (1, 4) and (2, 2): as
    expert parallelism against the port's baseline on one device;
  * ``Trainer`` over (2, 2) with a checkpoint of each rank's shards: a
    restart bit for bit the run straight through;
  * the sharded prefill and decode steps on (1, 4), float32: logits within
    1e-4 absolute plus 1e-4 relative of the one-device steps; yi-9b's
    ``Engine(mesh=)`` greedy tokens equal to the one-device engine's.
"""
import os
import pickle
import queue as queue_mod
import subprocess
import sys
import tempfile
import textwrap
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as ref_get_reduced
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.moe import init_moe as ref_init_moe
from repro.models.transformer import init_model as ref_init_model
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
HEADS = {"yi-9b": dict(num_heads=8, num_kv_heads=2)}  # GQA: 2 KV heads over 4 ranks
EP = dict(E=8, k=2, d=32, dff=16)
TRAIN = [("yi-9b", "float32"), ("deepseek-moe-16b", "float32"), ("yi-9b", "int8")]
SERVE = ["yi-9b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b"]
BATCH, SEQ, PROMPT, NEW = 4, 32, 8, 2
HALF = 1e-3  # how far from a half-integer an int8 moment's x / scale may round apart


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    rng = np.random.default_rng(0)
    moe = _np(ref_init_moe(jax.random.PRNGKey(0), EP["d"], num_experts=EP["E"],
                           d_ff_expert=EP["dff"], top_k=EP["k"], dtype=jnp.float32))
    out = {"moe": moe, "x": rng.standard_normal((2, 16, EP["d"])).astype(np.float32),
           "train": {}, "serve": {}}
    for arch, mdt in TRAIN:
        cfg = ref_get_reduced(arch, **HEADS.get(arch, {}))
        params = ref_init_model(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
        state = {"params": params,
                 "opt": ref_adamw_init(params, RefAdamWConfig(lr=1e-3, m_dtype=mdt))}
        data = RefSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=7)
        out["train"][arch, mdt] = {"state": _np(state),
                                   "batches": [data.batch(i) for i in range(2)]}
    for arch in SERVE:
        cfg = ref_get_reduced(arch, **HEADS.get(arch, {}))
        params = ref_init_model(jax.random.PRNGKey(4), cfg, dtype=jnp.float32)
        toks = rng.integers(0, cfg.vocab_size, (2, PROMPT + NEW)).astype(np.int32)
        out["serve"][arch] = {"params": _np(params), "tokens": toks}
    return out


# --------------------------------------------------------------------------
# the port, on one device and on the ranks

def _moe(moe_np, device="cpu"):
    from repro_torch.models.convert import to_torch
    from repro_torch.models.layers import Dense
    from repro_torch.models.moe import MoE, Experts

    e = moe_np["experts"]
    return MoE(Dense(to_torch(moe_np["router"]["w"], device)),
               Experts(*(to_torch(e[k], device) for k in ("gate", "up", "down"))))


def _moe_run(p, x, cf):
    from repro_torch.models.moe import moe_ffn

    for t in p.parameters():
        t.requires_grad_(True)
        t.grad = None
    y, aux = moe_ffn(p, x, num_experts=EP["E"], top_k=EP["k"], capacity_factor=cf)
    (y * y).sum().backward()
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    out = {"y": whole(y).detach().numpy(), "dropped": int(whole(aux["dropped"])),
           "max_load": int(whole(aux["max_load"]))}
    for name, t in p.named_parameters():
        out["grad/" + name] = whole(t.grad).detach().numpy()
    return out


def _train(case, mesh=None):
    from repro_torch.configs import get_reduced
    from repro_torch.models.convert import train_state_from_jax
    from repro_torch.models.transformer import param_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step

    (arch, mdt), data = case
    cfg = get_reduced(arch, **HEADS.get(arch, {}))
    tcfg = TrainConfig(microbatch=2, warmup_steps=2, total_steps=6,
                       adamw=AdamWConfig(lr=1e-3, m_dtype=mdt))
    state = train_state_from_jax(data["state"], cfg, device="cpu")
    out = {}
    if mesh is None:
        step = make_train_step(cfg, tcfg, device="cpu")
    else:
        from repro_torch.launch.shardings import distribute_model

        step, state_sh, _ = make_train_step(cfg, tcfg, mesh)
        distribute_model(state["params"], cfg, mesh)
        state["params"].requires_grad_(True)
        state["opt"] = adamw_init(param_leaves(state["params"]), tcfg.adamw)
        out["placements_ok"] = _placements_ok(state, state_sh)
    whole = lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()  # noqa: E731
    from repro_torch.optim import adamw as adamw_mod

    real, ratios = adamw_mod._quantize, []

    def spy(xs):  # each int8 leaf's x / scale, the value its codes round
        qs, scale = real(xs)
        ratios.append([whole(x / scale) for x in xs])
        return qs, scale

    metrics, moments = [], []
    adamw_mod._quantize = spy
    try:
        for b in data["batches"]:
            ratios.clear()
            state, m = step(state, b)
            metrics.append({k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
                            for k, v in m.items()})
            if mdt == "int8":  # per leaf: codes (copies: the state changes in place),
                # scale, and x / scale (the leaves are quantised in the tree's order)
                moments.append({k: ([whole(t).copy() for t in (v["q"] if isinstance(v["q"], tuple)
                                                               else (v["q"],))],
                                    float(whole(v["scale"])), r)
                                for (k, v), r in zip(state["opt"]["m"].items(), ratios)})
    finally:
        adamw_mod._quantize = real
    leaves = param_leaves(state["params"])
    out["metrics"] = metrics
    out["params"] = {k: [whole(t) for t in (v if isinstance(v, tuple) else (v,))]
                     for k, v in leaves.items()}
    if mdt == "int8":
        out["m"] = moments
    return out


def _placements_ok(state, state_sh):
    """Every state tensor placed as ``named(param_specs(...))`` says."""
    from repro_torch.models.transformer import param_leaves

    params = param_leaves(state["params"])
    bad = []
    for k, leaf in params.items():
        for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
            if tuple(t.placements) != state_sh["params"][k]:
                bad.append(("params", k))
        for mom in ("m", "v"):
            s, want = state["opt"][mom][k], state_sh["opt"][mom][k]
            if isinstance(s, dict):
                q = s["q"] if isinstance(s["q"], tuple) else (s["q"],)
                if any(tuple(t.placements) != want["q"] for t in q) or \
                        tuple(s["scale"].placements) != want["scale"]:
                    bad.append((mom, k))
            elif any(tuple(t.placements) != want for t in (s if isinstance(s, tuple) else (s,))):
                bad.append((mom, k))
    if tuple(state["opt"]["step"].placements) != state_sh["opt"]["step"]:
        bad.append(("step",))
    return bad


def _serve(arch, data, mesh=None):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.shardings import cache_specs, distribute, distribute_model
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.transformer import init_decode_cache
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = get_reduced(arch, **HEADS.get(arch, {}))
    model = params_from_jax(data["params"], cfg, device="cpu")
    cache = init_decode_cache(cfg, 2, PROMPT + NEW, dtype=torch.float32, device="cpu")
    if mesh is not None:
        distribute_model(model, cfg, mesh)
        cache = distribute(cache, cache_specs(cfg, mesh, cache), mesh)
    prefill, _ = make_prefill_step(cfg, mesh, params_like=model)
    decode, _ = make_decode_step(cfg, mesh, params_like=model)
    toks = torch.as_tensor(data["tokens"])
    whole = lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()  # noqa: E731
    logits, cache = prefill(model, toks[:, :PROMPT], cache)
    out = [whole(logits)]
    for i in range(NEW):
        pos = torch.full((2, 1), PROMPT + i, dtype=torch.int32)
        logits, cache = decode(model, toks[:, PROMPT + i:PROMPT + i + 1], pos, cache)
        out.append(whole(logits))
    if arch == "yi-9b":  # the engine over the mesh: greedy tokens
        from repro_torch.serve import Engine, ServeConfig

        fresh = params_from_jax(data["params"], cfg, device="cpu")
        engine = Engine(cfg, ServeConfig(max_seq=PROMPT + NEW, batch_size=2), fresh,
                        device="cpu" if mesh is None else None, mesh=mesh)
        out.append(engine.generate(toks[:, :PROMPT], NEW).numpy())
    return out


def _moe_on(moe_np, mesh):
    """The MoE layer placed as ``launch.shardings`` places it: the expert
    banks E-sharded over ``model``, the router replicated."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    p = _moe(moe_np)
    for name, t in list(p.named_parameters()):
        *owner, attr = name.split(".")
        pl = [Shard(0) if "experts" in name and a == "model" else Replicate()
              for a in mesh.mesh_dim_names]
        setattr(p.get_submodule(".".join(owner)), attr, torch.nn.Parameter(
            distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)))
    return p


def _restart(mesh, tmp):
    """The trainer over a mesh, the reference's restart test: two steps
    straight against one step, a checkpoint of each rank's shards, a
    restore into a fresh ``Trainer`` and one more step.  Returns the
    number of state tensors that differ, summed over the ranks."""
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_reduced("yi-9b", **HEADS["yi-9b"])
    tcfg = TrainConfig(microbatch=2, warmup_steps=2, total_steps=6,
                       adamw=AdamWConfig(lr=1e-3, m_dtype="int8"))
    data = lambda: iter(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ,  # noqa: E731
                                    global_batch=BATCH, seed=7))
    quiet = dict(ckpt_every=100, log_every=100, log=lambda *_: None)
    t0 = Trainer(cfg, tcfg, mesh=mesh, seed=0)
    t0.init_state()
    t0.run(data(), 2, **quiet)
    ck = os.path.join(tmp, "ck")
    t1 = Trainer(cfg, tcfg, mesh=mesh, ckpt_dir=ck, seed=0)
    t1.init_state()
    t1.run(data(), 1, **quiet)
    del t1  # "crash"
    t2 = Trainer(cfg, tcfg, mesh=mesh, ckpt_dir=ck, seed=0)
    t2.init_state()
    restored = t2.maybe_restore()
    it = data()
    next(it)
    t2.run(it, 1, **quiet)
    want, got = pytree.tree_leaves(t0._tree()), pytree.tree_leaves(t2._tree())
    differ = torch.tensor([sum(not torch.equal(a, b) for a, b in zip(want, got))])
    dist.all_reduce(differ)
    return {"restored": restored, "step": t2.step_num, "differ": int(differ),
            "leaves": len(want)}


def _rank_main(rank, rdv, path, q):
    try:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.models.layers import ambient_mesh
        from repro_torch.models.policy import compute_policy

        torch.set_num_threads(1)
        with open(path, "rb") as f:
            inp = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                                world_size=WORLD)
        m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {"ep": {}, "base": {}, "train": {}, "serve": {}}
        for cf in (float(EP["E"]), 1.0):
            x = DTensor.from_local(torch.as_tensor(inp["x"]), m14, [Replicate(), Replicate()])
            with ambient_mesh(m14), implicit_replication(), compute_policy(explicit_ep=True):
                res["ep"][cf] = _moe_run(_moe_on(inp["moe"], m14), x, cf)
            # the baseline over a mesh: the tokens batch-sharded over data
            for name, mesh in (("1x4", m14), ("2x2", m22)):
                x = distribute_tensor(torch.as_tensor(inp["x"]), mesh,
                                      [Shard(0), Replicate()], src_data_rank=None)
                with ambient_mesh(mesh), implicit_replication():
                    res["base"][name, cf] = _moe_run(_moe_on(inp["moe"], mesh), x, cf)
        for case in inp["train"].items():
            res["train"][case[0]] = _train(case, m22)
        for arch, data in inp["serve"].items():
            res["serve"][arch] = _serve(arch, data, m14)
        res["restart"] = _restart(m22, os.path.dirname(rdv))
        q.put((rank, res if rank == 0 else {}))
        dist.destroy_process_group()
    except BaseException:
        q.put((rank, {"__error__": traceback.format_exc()}))


# --------------------------------------------------------------------------
# the reference, in one child process with four host devices

_REFERENCE = textwrap.dedent(r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from functools import partial
    from jax.sharding import AxisType
    from repro.configs.registry import get_reduced
    from repro.models.moe import moe_ffn
    from repro.models.policy import compute_policy
    from repro.optim.adamw import AdamWConfig
    from repro.train.trainer import TrainConfig, make_train_step

    inp = pickle.load(open(sys.argv[1], "rb"))
    heads = {"yi-9b": dict(num_heads=8, num_kv_heads=2)}
    out = {"train": {}}
    mesh = jax.make_mesh((1, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    p = jax.tree.map(jnp.asarray, inp["moe"])
    x = jnp.asarray(inp["x"])
    f = partial(moe_ffn, num_experts=8, top_k=2, capacity_factor=8.0)

    def g(p, x):
        with compute_policy(explicit_ep=True):
            return f(p, x)

    with mesh:
        y, aux = jax.jit(g)(p, x)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(g(p, x)[0] ** 2)))(p)
    out["ep"] = {"y": np.asarray(y), "dropped": int(aux["dropped"]),
                 "max_load": int(aux["max_load"]), "grads": jax.tree.map(np.asarray, grads)}

    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for (arch, mdt), data in inp["train"].items():
        cfg = get_reduced(arch, **heads.get(arch, {}))
        tcfg = TrainConfig(microbatch=2, warmup_steps=2, total_steps=6,
                           adamw=AdamWConfig(lr=1e-3, m_dtype=mdt))
        state = jax.tree.map(jnp.asarray, data["state"])
        stepf, _, _ = make_train_step(cfg, tcfg, mesh,
                                      params_like=jax.eval_shape(lambda: state["params"]))
        metrics, moments = [], []
        with mesh:
            for b in data["batches"]:
                state, m = stepf(state, jax.tree.map(jnp.asarray, b))
                metrics.append({k: float(v) for k, v in m.items()})
                moments.append(jax.tree.map(np.asarray, state["opt"]["m"]))
        out["train"][arch, mdt] = {"metrics": metrics, "state": jax.tree.map(np.asarray, state),
                                   "m": moments}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module")
def results():
    import torch.multiprocessing as mp

    inp = _inputs()
    tmp = tempfile.mkdtemp(prefix="repro_torch_sharded_")
    path, ref_out = os.path.join(tmp, "inputs.pkl"), os.path.join(tmp, "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, os.path.join(tmp, "rdv"), path, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, path, ref_out], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the port on one device, meanwhile
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {"ep": {cf: _moe_run(_moe(inp["moe"]), torch.as_tensor(inp["x"]), cf)
                      for cf in (float(EP["E"]), 1.0)},
               "train": {case[0]: _train(case) for case in inp["train"].items()},
               "serve": {arch: _serve(arch, d) for arch, d in inp["serve"].items()}}
    finally:
        torch.set_num_threads(n)
    ranks = {}
    try:
        for _ in procs:
            rank, res = q.get(timeout=900)
            if "__error__" in res:
                raise AssertionError(f"rank {rank} failed:\n{res['__error__']}")
            ranks[rank] = res
    except queue_mod.Empty:
        raise AssertionError("the ranks gave no result within 900 s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    _, err = ref.communicate(timeout=900)
    assert ref.returncode == 0, err[-4000:]
    with open(ref_out, "rb") as f:
        want = pickle.load(f)
    return {"one": one, "sharded": ranks[0], "ref": want}


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# --------------------------------------------------------------------------
# (e) expert parallelism

@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_explicit_ep_matches_baseline(results, cf):
    got, base = results["sharded"]["ep"][cf], results["one"]["ep"][cf]
    assert got["dropped"] == base["dropped"] and got["max_load"] == base["max_load"]
    if cf == 1.0:
        assert base["dropped"] > 0  # the capacity drops entries here
    for k in base:
        if k.startswith("grad/") or k == "y":
            _close(got[k], base[k], 2e-5, 2e-5)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_baseline_moe_over_a_mesh_matches_one_device(results, mesh, cf):
    """The baseline (no ``explicit_ep``) over a mesh: per-rank columns of
    E/TP experts over ``model`` with the global capacity, the tokens
    gathered over ``data``."""
    got, base = results["sharded"]["base"][mesh, cf], results["one"]["ep"][cf]
    assert got["dropped"] == base["dropped"] and got["max_load"] == base["max_load"]
    for k in base:
        if k.startswith("grad/") or k == "y":
            _close(got[k], base[k], 2e-5, 2e-5)


def test_explicit_ep_matches_reference(results):
    got, want = results["sharded"]["ep"][8.0], results["ref"]["ep"]
    assert got["dropped"] == want["dropped"] == 0
    assert got["max_load"] == want["max_load"]
    _close(got["y"], want["y"], 2e-5, 2e-5)
    g = want["grads"]
    pairs = {"grad/router.w": g["router"]["w"], "grad/experts.gate": g["experts"]["gate"],
             "grad/experts.up": g["experts"]["up"], "grad/experts.down": g["experts"]["down"]}
    for k, w in pairs.items():
        _close(got[k], w, 2e-5, 2e-5)


# --------------------------------------------------------------------------
# (f) the sharded train step

def _ref_leaves(tree):
    from repro_torch.models.convert import leaves_from_jax

    leaves = leaves_from_jax(tree, "cpu")
    return {k: [t.numpy() for t in (v if isinstance(v, tuple) else (v,))]
            for k, v in leaves.items()}


@pytest.mark.parametrize("arch,mdt", TRAIN)
def test_sharded_train_step(results, arch, mdt):
    got = results["sharded"]["train"][arch, mdt]
    one = results["one"]["train"][arch, mdt]
    ref = results["ref"]["train"][arch, mdt]
    assert got["placements_ok"] == []
    for i in range(2):
        assert sorted(got["metrics"][i]) == sorted(ref["metrics"][i])
        for k, v in ref["metrics"][i].items():
            for other in (v, one["metrics"][i][k]):
                np.testing.assert_allclose(got["metrics"][i][k], other, rtol=1e-5, atol=1e-7)
    ref_params = _ref_leaves(ref["state"]["params"])
    lr = 1e-3
    for want in (one["params"], ref_params):
        assert sorted(want) == sorted(got["params"])
        diff = np.concatenate([np.abs(a - b).ravel() for k in want
                               for a, b in zip(got["params"][k], want[k])])
        if mdt == "int8":
            assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 4 * lr
        else:
            assert diff.max() <= 1e-5
    if mdt == "int8":
        _int8_codes_match(got["m"], ref["m"])


def _int8_codes_match(got, ref):
    """Each step's int8 first-moment codes equal the reference's, but where
    the two round x / scale apart at a half-integer: the float moments are
    sums the two sides add in other orders, so a code whose value lies
    within ``HALF`` of a half-integer may round either way.  A code that
    differed at step 1 carries into step 2 as b1 * (its difference) *
    scale_1 / scale_2 in x / scale, so step 2's codes are held to the
    reference's step 1 codes carried forward."""
    from repro_torch.models.convert import leaves_from_jax
    from repro_torch.optim import AdamWConfig

    b1 = AdamWConfig().b1
    ref = [leaves_from_jax(m, "cpu") for m in ref]
    prev = None
    for step, (mine, want) in enumerate(zip(got, ref)):
        for k, (codes, scale, ratios) in mine.items():
            w = want[k]
            np.testing.assert_allclose(scale, float(w["scale"]), rtol=1e-6)
            wq = [t.numpy() for t in (w["q"] if isinstance(w["q"], tuple) else (w["q"],))]
            for i, (a, b, r) in enumerate(zip(codes, wq, ratios)):
                if prev is not None:  # the reference's x / scale, from its own step 1 codes
                    pa, pb, ps = prev[k][0][i], prev[k][1][i], prev[k][2]
                    r = r + b1 * (pb.astype(np.float32) - pa) * ps / scale
                tie = np.abs(np.abs(r - np.floor(r)) - 0.5) <= HALF
                off = (a != b) & ~tie
                if prev is not None:
                    off = (np.clip(np.round(r), -127, 127) != b) & ~tie
                assert not off.any(), (step, k, r[off], a[off], b[off])
        prev = {k: (codes, [t.numpy() for t in (want[k]["q"] if isinstance(want[k]["q"], tuple)
                                                else (want[k]["q"],))], scale)
                for k, (codes, scale, _) in mine.items()}


def test_sharded_trainer_restarts_bit_for_bit(results):
    """``Trainer(mesh=, ckpt_dir=)`` on (2, 2): each rank checkpoints its own
    shards, and a fresh trainer restored from them goes on bit for bit."""
    got = results["sharded"]["restart"]
    assert got["restored"] and got["step"] == 2 and got["leaves"] > 0
    assert got["differ"] == 0


# --------------------------------------------------------------------------
# (g) the sharded serving steps

@pytest.mark.parametrize("arch", SERVE)
def test_sharded_prefill_and_decode_match_one_device(results, arch):
    """The steps' logits; for yi-9b also ``Engine(mesh=)``'s greedy tokens,
    equal to the one-device engine's."""
    got, want = results["sharded"]["serve"][arch], results["one"]["serve"][arch]
    steps = NEW + 1
    assert len(got) == len(want) == steps + (arch == "yi-9b")
    for a, b in zip(got[:steps], want[:steps]):
        assert a.shape == b.shape
        _close(a, b, 1e-4, 1e-4)
    if arch == "yi-9b":
        assert got[-1].shape == (2, NEW)
        np.testing.assert_array_equal(got[-1], want[-1])
