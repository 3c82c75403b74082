"""Parity of the port's launch and cost tooling with the reference's, on the
CPU: the registry's shapes and input specs, the sharding rules, the
roofline's counts, the op-level cost counter and the dry run.

The reference's sharding rules read only ``mesh.axis_names`` and
``mesh.shape``, and the port's only ``mesh_dim_names`` and ``shape``, so
stand-ins for the production meshes (16, 16) and (2, 16, 16) serve both,
with nothing allocated (``jax.eval_shape`` and the meta device).  The fake
process group is global to its process, so everything that needs one (the
extrapolated traces, a tensor-parallel pair's collectives and the dry-run
rows) runs in one child process for the module.

Tolerances: the specs, counts, shapes and the extrapolated traces are
exact.  The counter's matmul flops of a reduced forward equal the closed
form exactly; its total flops lie within 10% of the reference's
``analyze_hlo(...).flops`` of the same forward (XLA counts its fused
elementwise work by other rules: 2.4% seen for yi-9b and 5.3% for
rwkv6-1.6b at the reduced size).
"""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import roofline as ref_roofline
from repro.launch import shardings as ref_sh
from repro.models.transformer import init_decode_cache as ref_init_decode_cache
from repro.models.transformer import init_model as ref_init_model
from repro_torch.configs import registry
from repro_torch.launch import roofline, shardings
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1pod": ((16, 16), ("data", "model")), "2pod": ((2, 16, 16), ("pod", "data", "model"))}
STRATS = [dict(), dict(fsdp_params=False), dict(shard_moe_router=True),
          dict(embed_vocab_axis="none")]
CACHE_STRATS = [None, True, False]


def _meshes(which):
    shape, axes = MESHES[which]
    return (types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape))),
            types.SimpleNamespace(mesh_dim_names=axes, shape=shape))


def _flat(tree):
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_p)
    return {ref_sh._path_str(p): v for p, v in leaves}


def _dtype(d):
    return str(np.dtype(d)) if not isinstance(d, torch.dtype) else str(d).replace("torch.", "")


# --------------------------------------------------------------------------
# (a) the registry and the sharding rules

def test_shapes_cells_and_input_specs_match_reference():
    assert registry.ARCHS == ref_registry.ARCHS
    assert {k: vars(v) for k, v in registry.SHAPES.items()} == \
        {k: vars(v) for k, v in ref_registry.SHAPES.items()}
    for flag in (False, True):
        assert registry.cells(flag) == ref_registry.cells(flag)
    assert len(registry.cells(True)) == 40
    for arch, shape in registry.cells(True):
        cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
        s, rs = registry.SHAPES[shape], ref_registry.SHAPES[shape]
        assert registry.shape_applicable(cfg, s) == ref_registry.shape_applicable(ref_cfg, rs)
        got, want = registry.input_specs(cfg, s), ref_registry.input_specs(ref_cfg, rs)
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "cache":
                continue
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert _dtype(got[k].dtype) == _dtype(want[k].dtype)
        if "cache" in want:  # per-layer tensors where the reference stacks them
            for group, leaves in want["cache"].items():
                for name, leaf in leaves.items():
                    layers = got["cache"][group]
                    assert len(layers) == leaf.shape[0]
                    for c in layers:
                        if name == "pos":
                            assert c[name] == 0
                        else:
                            assert tuple(c[name].shape) == leaf.shape[1:]
                            assert _dtype(c[name].dtype) == _dtype(leaf.dtype)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_sharding_specs_match_reference(arch):
    """param_specs (all four strategy switches), cache_specs (its three
    sequence-sharding settings), batch_specs and logits_spec, leaf for leaf,
    on both production meshes; a stacked leaf's spec is the reference's
    without the layer dimension."""
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    like = jax.eval_shape(lambda: ref_init_model(jax.random.PRNGKey(0), ref_cfg))
    model = transformer.init_model(torch.Generator(), cfg, device="meta")
    shape = registry.SHAPES["decode_32k"]
    ref_cache = jax.eval_shape(lambda: ref_init_decode_cache(ref_cfg, shape.global_batch,
                                                             shape.seq_len))
    cache = transformer.init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                          device="meta")
    for which in MESHES:
        rm, pm = _meshes(which)
        for kw in STRATS:
            want = _flat(ref_sh.param_specs(like, ref_cfg, rm, ref_sh.ShardingStrategy(**kw)))
            got = shardings.param_specs(model, cfg, pm, shardings.ShardingStrategy(**kw))
            assert sorted(got) == sorted(want)
            for path, spec in want.items():
                assert got[path] == (spec[1:] if path.startswith("layers/") else spec), path
        for seq in CACHE_STRATS:
            want = ref_sh.cache_specs(ref_cfg, rm, ref_cache,
                                      ref_sh.ShardingStrategy(seq_shard_cache=seq))
            got = shardings.cache_specs(cfg, pm, cache,
                                        shardings.ShardingStrategy(seq_shard_cache=seq))
            assert sorted(got) == sorted(want)
            for group, leaves in want.items():
                for name, spec in leaves.items():
                    for c in got[group]:
                        assert c[name] == spec[1:], (group, name)
        for s in registry.SHAPES.values():
            specs = ref_registry.input_specs(ref_cfg, ref_registry.SHAPES[s.name])
            specs.pop("cache", None)
            want = ref_sh.batch_specs(ref_cfg, rm, specs)
            got = shardings.batch_specs(cfg, pm, {k: torch.empty(v.shape, device="meta")
                                                  for k, v in specs.items()})
            assert got == want
        assert shardings.logits_spec(pm) == ref_sh.logits_spec(rm)


def test_placements_of_specs():
    """A spec's DTensor placements: ("pod", "data") is Shard on both mesh
    dimensions; an axis of size 1 or one the mesh lacks replicates; two
    dimensions on one axis are refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 4, 1))
    assert shardings.placements(mesh, shardings.Spec(("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Replicate())
    assert shardings.placements(mesh, shardings.Spec(None, ("data", "expert"))) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="shards two"):
        shardings.placements(mesh, shardings.Spec("data", "data"))
    assert shardings.local_shape((9, 8), mesh, shardings.Spec("data", None)) == (3, 8)


# --------------------------------------------------------------------------
# (b) the roofline's counts

def test_counts_match_reference():
    for arch, shape in registry.cells(True):
        cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
        s, rs = registry.SHAPES[shape], ref_registry.SHAPES[shape]
        assert roofline._param_count(cfg) == ref_roofline._param_count(ref_cfg)
        assert roofline._active_param_count(cfg) == ref_roofline._active_param_count(ref_cfg)
        assert roofline.model_flops(cfg, s) == ref_roofline.model_flops(ref_cfg, rs)


def test_hw_is_the_h100():
    hw = roofline.HW
    assert hw["peak_flops"] == 989e12 and hw["hbm_bw"] == 3.35e12
    assert hw["nvlink_bw"] == 450e9 and hw["node_gpus"] == 8 and hw["sms"] == 132
    assert hw["smem_per_block"] == 232_448
    # the production meshes' axes span nodes: the network's assumed rate
    assert roofline.axis_link_bw(16, 1) == hw["inter_node_bw"]
    assert roofline.axis_link_bw(16, 16) == hw["inter_node_bw"]
    assert roofline.axis_link_bw(8, 1) == hw["nvlink_bw"]


def test_launch_spec_follows_the_kernels_schedules():
    from repro_torch.kernels import dispatch_rank

    spec = roofline.launch_spec("rank", 4, 64)
    warps, tile = dispatch_rank.schedule(64, spec.tile)
    assert spec.threads == 32 * warps and tile == spec.tile
    assert spec.smem_bytes == dispatch_rank._smem_bytes(64, warps) <= roofline.HW["smem_per_block"]
    assert roofline.launch_spec("level_fused", 4, 128, n=1000).rows == 0
    assert roofline.launch_spec("merge", 4).threads == 256
    from repro_torch.kernels import classify

    for key_bytes, k, n in ((4, 128, 1 << 24), (1, 3, 1 << 20), (8, 256, 1 << 18)):
        spec = roofline.launch_spec("classify", key_bytes, k, n=n)
        sch = classify.schedule(key_bytes, k)
        assert spec.rows == classify.default_rows(n, key_bytes, k)
        assert spec.threads == sch.threads and spec.smem_bytes == sch.smem_bytes
        assert spec.smem_bytes <= roofline.HW["smem_per_block"]
    assert roofline.classify_tile_rows(4, 128) == (128, 64, 32, 16, 8, 4, 2, 1)


# --------------------------------------------------------------------------
# (c) the op-level counter on one device

def _yi():
    return registry.get_reduced("yi-9b", num_heads=8, num_kv_heads=2)


def test_counter_matmul_flops_closed_form():
    cfg = _yi()
    model = transformer.init_model(torch.Generator().manual_seed(0), cfg,
                                   dtype=torch.float32, device="cpu")
    b, s = 2, 16
    x = torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32)
    counter = OpCost()
    with torch.no_grad(), counter:
        transformer.forward(model, cfg, x)
    t, d, hd = b * s, cfg.d_model, cfg.hd
    per_layer = (2 * t * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd    # q, k, v
                 + 2 * t * cfg.num_heads * hd * d                          # o
                 + 2 * 2 * b * cfg.num_heads * s * s * hd                  # scores, PV
                 + 3 * 2 * t * d * cfg.d_ff)                               # swiglu
    want = cfg.num_layers * per_layer + 2 * t * d * cfg.vocab_size         # lm_head
    got = sum(v for k, v in counter.cost.flops_by_op.items() if k in ("mm", "bmm"))
    assert got == want
    assert counter.cost.coll == {} and counter.peak > 0


@pytest.mark.parametrize("arch", ["yi-9b", "rwkv6-1.6b"])
def test_counter_flops_near_reference_hlo(arch):
    from repro.launch.hlo_cost import analyze_hlo
    from repro.models.transformer import forward as ref_forward

    kw = dict(num_heads=8, num_kv_heads=2) if arch == "yi-9b" else {}
    ref_cfg, cfg = ref_registry.get_reduced(arch, **kw), registry.get_reduced(arch, **kw)
    params = ref_init_model(jax.random.PRNGKey(1), ref_cfg, dtype=jnp.float32)
    x = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    text = jax.jit(lambda p, x: ref_forward(p, ref_cfg, x)[0]).lower(
        params, jnp.asarray(x)).compile().as_text()
    want = analyze_hlo(text).flops
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    counter = OpCost()
    with torch.no_grad(), counter:
        transformer.forward(model, cfg, torch.as_tensor(x))
    assert abs(counter.cost.flops - want) <= 0.10 * want, (counter.cost.flops, want)


# --------------------------------------------------------------------------
# (c, d) what needs the fake process group: one child process

_CHILD = textwrap.dedent(r"""
    import json, sys, dataclasses
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import SHAPES, get_reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.launch.shardings import ShardingStrategy
    from repro_torch.models.layers import ambient_mesh, linear
    from repro_torch.train.trainer import TrainConfig

    out = {}
    def cost(c):
        return {"flops": c.flops, "bytes": c.bytes, "bytes_min": c.bytes_min,
                "coll": c.coll, "coll_by_axis": c.coll_by_axis}

    # the extrapolation over trips against full traces at a reduced size
    with fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        strat = ShardingStrategy()
        cases = [("yi-9b", "train_4k", dict(num_heads=8, num_kv_heads=2, num_layers=3), 4,
                  dict(seq_len=32, global_batch=16)),
                 ("rwkv6-1.6b", "prefill_32k", dict(num_layers=3), 1,
                  dict(seq_len=24, global_batch=4)),
                 ("zamba2-2.7b", "decode_32k", dict(num_layers=6), 1,
                  dict(seq_len=64, global_batch=4))]
        for arch, shp, kw, k, skw in cases:
            cfg = get_reduced(arch, **kw)
            if arch == "zamba2-2.7b":
                cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, attn_every=3))
            shape = dataclasses.replace(SHAPES[shp], **skw)
            tcfg = TrainConfig(microbatch=shape.global_batch // k)
            full, _ = dryrun._trace_once(shape.kind, cfg, shape, mesh, strat, tcfg, k, "cpu")
            ext, _, _, trips = dryrun.trace_cost(shape.kind, cfg, shape, mesh, strat, tcfg,
                                                 "cpu", steps=k)
            out[arch] = {"full": cost(full), "ext": cost(ext), "trips": trips}

    # a tensor-parallel pair: one all-reduce of the output, 2x its bytes
    with fake_group(4):
        mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.randn(8, 32), mesh, [Replicate(), Replicate()])
        w1 = DTensor.from_local(torch.randn(32, 16), mesh, [Replicate(), Shard(1)])
        w2 = DTensor.from_local(torch.randn(16, 32), mesh, [Replicate(), Shard(0)])
        c = OpCost(mesh)
        with torch.no_grad(), ambient_mesh(mesh), c:
            y = linear(linear(x, w1), w2).redistribute(mesh, [Replicate(), Replicate()])
        out["tp"] = cost(c.cost)

    # dry-run rows, through the command line
    import os, tempfile
    d = tempfile.mkdtemp()
    rc = []
    for args in (["--arch", "yi-9b", "--shape", "long_500k"],
                 ["--arch", "yi-9b", "--shape", "prefill_32k"],
                 ["--arch", "rwkv6-1.6b", "--shape", "decode_32k", "--multi-pod"],
                 ["--arch", "deepseek-moe-16b", "--shape", "decode_32k", "--explicit-ep",
                  "--tag", "ep", "--save-hlo", d]):
        rc.append(dryrun.main(args + ["--out", d]))
    rows = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            rows[f] = json.load(open(os.path.join(d, f)))
    out["rows"], out["rc"] = rows, rc
    out["ops"] = [f for f in os.listdir(d) if f.endswith(".ops.txt")]
    from repro_torch.launch import report
    out["table"] = report.table(list(rows.values()))
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def child():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    assert p.returncode == 0 and lines, p.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.mark.parametrize("arch", ["yi-9b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_trip_extrapolation_equals_full_trace(child, arch):
    """Traces at one and two layers (groups), two and three microbatches and
    8 and 16 tokens, extrapolated, equal one full trace: train (3 layers,
    4 microbatches), RWKV-6 prefill (24 tokens), the hybrid's decode (two
    groups of three)."""
    got = child[arch]
    for k in ("flops", "bytes", "bytes_min"):
        assert got["ext"][k] == pytest.approx(got["full"][k], rel=1e-9, abs=1e-3), k
    for k in ("coll", "coll_by_axis"):
        assert got["ext"][k].keys() == got["full"][k].keys()
        for name, v in got["full"][k].items():
            assert got["ext"][k][name] == pytest.approx(v, rel=1e-9), (k, name)
    assert got["full"]["flops"] > 0


def test_tensor_parallel_pair_collectives(child):
    """Column- then row-parallel on (1, 4): the one all-reduce of the (8, 32)
    float32 output counts twice its bytes, on the model axis."""
    assert child["tp"]["coll"] == {"all-reduce": 2.0 * 8 * 32 * 4}
    assert child["tp"]["coll_by_axis"] == {"model": 2.0 * 8 * 32 * 4}


def test_dryrun_rows(child):
    """Rows with the reference's keys (an ok row's roofline with the
    reference's RooflineReport fields), the skip reason of a full-attention
    long_500k cell, the two-pod mesh, the expert-parallel column's
    all-reduce over ``model``, the op table in place of HLO text, and the
    report.  (The smoke on the card traces the other cells it names; all
    40 run with ``--all``.)"""
    from dataclasses import fields

    rows, rc = child["rows"], child["rc"]
    assert rc == [0, 0, 0, 0]
    assert len(rows) == 4
    skip = rows["yi-9b__long_500k__1pod.json"]
    assert skip == {"arch": "yi-9b", "shape": "long_500k", "status": "skipped",
                    "reason": "full-attention arch: long_500k needs sub-quadratic"}
    keys = {"arch", "shape", "mesh", "chips", "status", "t_lower_s", "t_compile_s",
            "memory", "roofline"}
    ref_fields = {f.name for f in fields(ref_roofline.RooflineReport)}
    for name in ("yi-9b__prefill_32k__1pod.json", "rwkv6-1.6b__decode_32k__2pod.json",
                 "deepseek-moe-16b__decode_32k__1pod__ep.json"):
        row = rows[name]
        assert set(row) == keys and row["status"] == "ok"
        assert ref_fields <= set(row["roofline"])
        assert row["roofline"]["flops_per_dev"] > 0 and row["roofline"]["t_compute"] > 0
        assert row["memory"]["argument_size_in_bytes"] > 0
    assert rows["rwkv6-1.6b__decode_32k__2pod.json"]["chips"] == 512
    assert rows["rwkv6-1.6b__decode_32k__2pod.json"]["mesh"] == "2x16x16"
    assert child["ops"] == ["deepseek-moe-16b__decode_32k__1pod__ep.ops.txt"]
    ep = rows["deepseek-moe-16b__decode_32k__1pod__ep.json"]["roofline"]
    assert ep["coll_by_axis"]["model"] > 0
    assert "skip:full-attn" in child["table"] and "ERROR" not in child["table"]
