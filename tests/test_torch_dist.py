"""``repro_torch.dist`` against ``repro.dist`` on the CPU.  Tolerance 0:
every result is a key (compared as bit patterns), a count, a flag or a
permutation.

  * **pure functions**, equal to the reference's over a grid:
    ``plan_schedule``, ``order_axes``, ``schedule_cost``,
    ``axis_bandwidths``, ``default_oversample``,
    ``sampling.splitters_from_histogram`` (with skew), the ``dist:`` plan's
    capacity simulation (``_autotune_dist``) and its JSON round trip with
    an entry the reference wrote (its ``engine`` dropped);
  * **many ranks**: ``gloo`` ranks spawned once per module (4 ranks, on the
    meshes (4,), (2, 2) and (4, 1), and 8 ranks on (2, 4)), each with a
    ``file://`` rendezvous under a temporary directory (never a fixed TCP
    port: several test workers run at once).  Each rank passes its shard
    and keeps its own outputs; the parent puts them together.  Cases: the
    multilevel sort of the reference's nine distributions x {float32,
    int32} on (4,) and (2, 2), bit-identical to the keyspace-order stable
    sort and to the reference's sort; a payload pytree riding two axes; the
    argsort's global order; rank-k; ``group_by``'s per-rank runs; the
    truncation contract; the re-split rounds converging, with the obs
    metrics of every rank together equal to the reference's; overlap
    bit-identical to the synchronous exchange; ``order="auto"`` recording
    its order; d = 1 equal to ``ops.sort``; float64, int64, uint8 and
    bfloat16 keys by both classifiers with a payload;
  * **against the reference**: the reference runs in one child process
    with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
    ``tests/test_distributed_sort.py`` runs it), its outputs cached by a
    module fixture.  Where per-rank outputs are compared (each rank's
    sorted range, payload, count and flag), the port's ranks draw the
    reference's sample positions: ``dist.exchange.sample_positions`` is
    replaced in the ranks by the reference's ``fold_in`` chain and
    ``sampling.sample_indices``.  The valid prefixes concatenated are
    compared in every case.

On one H100 NCCL reaches world size 1 only (NCCL wants one card per
rank); several ranks on one card run with ``gloo``, as here.
"""
import json
import os
import pickle
import queue as queue_mod
import tempfile
import textwrap
import time
import traceback

import numpy as np
import pytest
import torch
from torch_children import Child

N4 = 1 << 15     # keys in all on the 4-rank meshes (n_local = 8192)
N8 = 1 << 16     # keys in all on the 8-rank mesh (n_local = 8192)
CFG = dict(base_case=2048, kmax=32, tile=512, max_sample=2048)
DISTS = ("AlmostSorted", "EightDup", "Exponential", "Ones", "ReverseSorted", "RootDup",
         "Sorted", "TwoDup", "Uniform")
AXES = {"4": "data", "2x2": ("pod", "data"), "4x1": "data", "2x4": ("pod", "data")}


# --------------------------------------------------------------------------
# the port's ranks (spawned; this module imports neither jax nor repro at
# its top, so a rank imports torch and the port only)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _ref_positions(seed, level_idx, round_, rank, num, m):
    """The reference's sample positions for (seed, level, round, rank)."""
    import jax
    import jax.numpy as jnp
    from repro.core import sampling as ref_sampling

    rng = jax.random.PRNGKey(seed)
    for part in (level_idx, round_, rank):
        rng = jax.random.fold_in(rng, part)
    pos = ref_sampling.sample_indices(rng, num, 0, jnp.int32(int(m)))
    return torch.as_tensor(np.asarray(pos).astype(np.int64), device=m.device)


def _shard(x, pos, world):
    n_local = x.shape[0] // world
    return x[pos * n_local:(pos + 1) * n_local]


def _position(meshes, mesh_name, axes=None):
    from repro_torch.dist.exchange import group_for
    from repro_torch.dist.levels import normalize_axes

    return group_for(meshes[mesh_name], normalize_axes(axes or AXES[mesh_name])).index


def _full(res):
    """A rank's full sort outputs as host data."""
    keys, counts, ovf = res[0], res[-2], res[-1]
    out = {"keys": _bits(keys.numpy()), "count": int(counts[0]), "ovf": bool(ovf[0])}
    if len(res) == 4:
        out["values"] = {name: leaf.numpy() for name, leaf in res[1].items()}
    return out


def _cases4(rank, meshes, tmp):
    """Every 4-rank case; returns this rank's results by case name."""
    from repro_torch import dist, obs, ops
    from repro_torch.core.ips4o import SortConfig
    from repro_torch.data.distributions import make_input
    from repro_torch.dist import exchange

    cfg = SortConfig(**CFG)
    out = {}
    own_draw = exchange.sample_positions

    def sort(mesh_name, x, axes=None, **kw):
        pos = _position(meshes, mesh_name, axes)
        xs = torch.as_tensor(_shard(x, pos, 4))
        return pos, dist.sort(xs, meshes[mesh_name], axes or AXES[mesh_name], cfg=cfg, **kw)

    # the multilevel sort of every distribution; overlap against sync on (2, 2)
    for mesh_name in ("4", "2x2"):
        for dtype in (np.float32, np.int32):
            for name in DISTS:
                x = make_input(name, N4, dtype, seed=42)
                pos, res = sort(mesh_name, x)
                out[("A", mesh_name, name, dtype.__name__)] = (pos, _full(res))
                if mesh_name == "2x2":
                    _, res = sort(mesh_name, x, overlap=True)
                    out[("B", name, dtype.__name__)] = (pos, _full(res))
    # rank-k and group_by with the port's own draws
    x = make_input("Exponential", N4, np.float32, seed=17)
    for mesh_name in ("4", "2x2"):
        xs = torch.as_tensor(_shard(x, _position(meshes, mesh_name), 4))
        got = [dist.bottomk(xs, 100, meshes[mesh_name], AXES[mesh_name], cfg=cfg),
               dist.topk(xs, 100, meshes[mesh_name], AXES[mesh_name], cfg=cfg)]
        out[("rank_k", mesh_name)] = [(v.numpy(), i.numpy()) for v, i in got]
    x = make_input("RootDup", N4, np.int32, seed=3)
    pos = _position(meshes, "4")
    ks, starts, counts, ovf = dist.group_by(torch.as_tensor(_shard(x, pos, 4)), meshes["4"],
                                            "data", cfg=cfg)
    out["group_by"] = (pos, ks.numpy(), starts.numpy(), int(counts[0]), bool(ovf[0]))
    # order="auto" on a mis-declared axis tuple (the fast axis first): the
    # cost model puts the slow axis first and records that in the dist: plan;
    # the ranges (and the input shards) follow the chosen order
    from repro_torch.ops import plan

    x = make_input("Uniform", N4, np.float32, seed=42)
    pos = _position(meshes, "2x2", ("pod", "data"))
    xs = torch.as_tensor(_shard(x, pos, 4))
    declared = dist.sort(xs, meshes["2x2"], ("data", "pod"), cfg=cfg, order="auto")
    recorded = plan.default_cache.dist_plan(N4 // 4, 4, torch.float32).axis_order
    again = dist.sort(xs, meshes["2x2"], ("data", "pod"), cfg=cfg, order="auto")
    out["auto"] = (pos, _full(declared), _full(again), recorded)
    # other key dtypes: 64-bit codes through the exchange, narrow and bf16
    # keys on the left-aligned int32 codes; a payload rides along
    for name, x in _other_dtype_inputs().items():
        pos = _position(meshes, "2x2")
        xs = torch.as_tensor(_shard(x, pos, 4))
        if name == "bfloat16":
            xs = xs.to(torch.bfloat16)
        idx = torch.arange(pos * (N4 // 4), (pos + 1) * (N4 // 4))
        for clf in ("tree", "radix"):
            ks, vs, counts, ovf = dist.sort(xs, meshes["2x2"], AXES["2x2"], cfg=cfg,
                                            classifier=clf, values={"i": idx})
            c = int(counts[0])
            out[("dtype", name, clf)] = (pos, ops.keyspace.encode(ks[:c]).numpy(),
                                         vs["i"][:c].numpy(), bool(ovf[0]))
    # d = 1: each rank sorts its own shard on a (4, 1) mesh's "data" axis
    x = make_input("Exponential", N4, np.float32, seed=9)
    xs = torch.as_tensor(_shard(x, rank, 4))
    k1, c1, o1 = dist.sort(xs, meshes["4x1"], "data", cfg=cfg)
    want = ops.sort(xs, cfg=cfg, device="cpu")
    a1, _, _ = dist.argsort(xs, meshes["4x1"], "data", cfg=cfg)
    v1, i1 = dist.topk(xs, 50, meshes["4x1"], "data", cfg=cfg)
    wv, wi = ops.topk(xs, 50, cfg=cfg, device="cpu")
    out["d1"] = (torch.equal(k1[:int(c1)].view(torch.int32), want.view(torch.int32))
                 and int(c1) == xs.shape[0] and not bool(o1)
                 and torch.equal(a1[:int(c1)], ops.argsort(xs, cfg=cfg, device="cpu"))
                 and torch.equal(v1, wv) and torch.equal(i1, wi))

    # the reference's sample positions from here on: per-rank outputs compared
    exchange.sample_positions = _ref_positions
    try:
        for key, mesh_name, name, dtype, kw in _SAME_POSITIONS4:
            x = make_input(name, N4, dtype, seed=42)
            values = None
            if key == "payload":
                idx = np.arange(N4, dtype=np.int32)
                values = {"idx": torch.as_tensor(_shard(idx, _position(meshes, mesh_name), 4)),
                          "w": torch.as_tensor(_shard(
                              idx[:, None] * np.asarray([1, 2, 3], np.float32), _position(
                                  meshes, mesh_name), 4))}
            pos, res = sort(mesh_name, x, values=values, **kw)
            out[("L", key)] = (pos, _full(res))
        # the order of equal keys depends on the splitters (equal keys stripe
        # over the groups their splitter run spans): the argsort is compared
        # with the reference's on its positions
        x = make_input("TwoDup", N4, np.int32, seed=5)
        pos = _position(meshes, "4")
        order, counts, ovf = dist.argsort(torch.as_tensor(_shard(x, pos, 4)), meshes["4"],
                                          "data", cfg=cfg)
        out["argsort"] = (pos, order[:int(counts[0])].numpy(), bool(ovf[0]))
        x = make_input("Uniform", N4, np.float32, seed=21)
        runs = [sort("4", x, slack=0.05)[1] for _ in range(2)]
        out["trunc"] = (_position(meshes, "4"), [_full(r) for r in runs])
        x = make_input("Exponential", N4, np.float32, seed=42)
        kw = dict(slack=1.25, oversample=8)
        for retries in (0, 2):
            obs.enabled(True)
            obs.reset()
            pos, res = sort("4", x, retries=retries, **kw)
            out[("resplit", retries)] = (pos, _full(res), {
                "rounds": obs.hist_values("dist.resplit_rounds"),
                "bytes": obs.hist_values("dist.collective_bytes"),
                "events": [e["attrs"] for e in obs.events("dist.exchange_overflow")]})
            obs.enabled(False)
            obs.reset()
        _, res = sort("4", x, overlap=True, **kw)
        out["resplit_overlap"] = (pos, _full(res))
    finally:
        exchange.sample_positions = own_draw
    return out


def _other_dtype_inputs():
    rng = np.random.default_rng(5)
    return {"float64": rng.standard_normal(N4), "int64": rng.integers(-2**62, 2**62, N4),
            "uint8": rng.integers(0, 256, N4).astype(np.uint8),
            "bfloat16": rng.standard_normal(N4).astype(np.float32)}


# (case, mesh, distribution, dtype, keywords): per-rank outputs held to the
# reference's when both draw the same sample positions
_SAME_POSITIONS4 = [
    ("uniform_2x2", "2x2", "Uniform", np.float32, {}),
    ("twodup_4", "4", "TwoDup", np.int32, {}),
    ("radix_4", "4", "Uniform", np.float32, {"classifier": "radix"}),
    ("overlap_2x2", "2x2", "Exponential", np.float32, {"overlap": True}),
    ("payload", "2x2", "Uniform", np.float32, {}),
]


def _cases8(rank, meshes, tmp):
    from repro_torch import dist
    from repro_torch.core.ips4o import SortConfig
    from repro_torch.data.distributions import make_input
    from repro_torch.dist import exchange

    cfg = SortConfig(**CFG)
    pos = _position(meshes, "2x4")
    mesh = meshes["2x4"]
    out = {}
    x = make_input("Exponential", N8, np.float32, seed=42)
    out["own"] = (pos, _full(dist.sort(torch.as_tensor(_shard(x, pos, 8)), mesh,
                                       ("pod", "data"), cfg=cfg)))
    exchange.sample_positions = _ref_positions
    x = make_input("Uniform", N8, np.float32, seed=11)
    idx = np.arange(N8, dtype=np.int32)
    res = dist.sort(torch.as_tensor(_shard(x, pos, 8)), mesh, ("pod", "data"), cfg=cfg,
                    values={"idx": torch.as_tensor(_shard(idx, pos, 8))})
    out["same"] = (pos, _full(res))
    return out


def _rank_main(rank, world, rdv, tmp, which, q):
    try:
        torch.set_num_threads(1)
        os.environ["REPRO_TORCH_OPS_PLAN_CACHE"] = os.path.join(tmp, f"plans{rank}.json")
        import torch.distributed as tdist
        from torch.distributed.device_mesh import init_device_mesh

        tdist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                                 world_size=world)
        if which == "4":
            meshes = {"4": init_device_mesh("cpu", (4,), mesh_dim_names=("data",)),
                      "2x2": init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data")),
                      "4x1": init_device_mesh("cpu", (4, 1), mesh_dim_names=("pod", "data"))}
            res = _cases4(rank, meshes, tmp)
        else:
            meshes = {"2x4": init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))}
            res = _cases8(rank, meshes, tmp)
        q.put((rank, res))
        tdist.destroy_process_group()
    except BaseException:
        q.put((rank, {"__error__": traceback.format_exc()}))


def _spawn(world, which, timeout=600):
    """Run ``_rank_main`` on ``world`` spawned ranks; their results by rank."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_dist_")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "rendezvous"), tmp, which, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = q.get(timeout=timeout)
            if "__error__" in res:
                raise AssertionError(f"rank {rank} failed:\n{res['__error__']}")
            got[rank] = res
    except queue_mod.Empty:
        raise AssertionError(f"the ranks gave no result within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return got, tmp


# --------------------------------------------------------------------------
# the reference, in one child process with 8 host devices

_REFERENCE = textwrap.dedent(r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import dist, obs
    from repro.core.ips4o import SortConfig
    from repro.data.distributions import make_input

    spec = pickle.loads(bytes.fromhex(sys.argv[2]))
    cfg = SortConfig(**spec["cfg"])
    devs = np.array(jax.devices())
    meshes = {"4": Mesh(devs[:4], ("data",)), "2x2": Mesh(devs[:4].reshape(2, 2), ("pod", "data")),
              "2x4": Mesh(devs.reshape(2, 4), ("pod", "data"))}
    AX = spec["axes"]
    fns = {}

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint32) if a.dtype == np.float32 else a

    def run(mesh_name, x, values=None, fresh=False, **kw):
        mesh, axes = meshes[mesh_name], AX[mesh_name]
        key = (mesh_name, values is not None, tuple(sorted(kw.items())))
        if fresh or key not in fns:
            fns[key] = jax.jit(lambda a, v: dist.sort(a, mesh, axes, values=v, cfg=cfg, **kw))
        sh = NamedSharding(mesh, P(axes))
        v = None if values is None else jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(a), NamedSharding(
                mesh, P(axes, *([None] * (a.ndim - 1))))), values)
        res = fns[key](jax.device_put(jnp.asarray(x), sh), v)
        d = int(np.prod([mesh.shape[a] for a in ((axes,) if isinstance(axes, str) else axes)]))
        out = {"keys": bits(res[0]), "counts": np.asarray(res[-2]), "ovf": np.asarray(res[-1]), "d": d}
        if values is not None:
            out["values"] = jax.tree.map(np.asarray, res[1])
        return out

    out = {}
    N4, N8 = spec["n4"], spec["n8"]
    for mesh_name in ("4", "2x2"):
        for dtype in (np.float32, np.int32):
            for name in spec["dists"]:
                out[("A", mesh_name, name, dtype.__name__)] = run(
                    mesh_name, make_input(name, N4, dtype, seed=42))
    for key, mesh_name, name, dtype, kw in spec["same4"]:
        x = make_input(name, N4, dtype, seed=42)
        values = None
        if key == "payload":
            idx = np.arange(N4, dtype=np.int32)
            values = {"idx": idx, "w": idx[:, None] * np.asarray([1, 2, 3], np.float32)}
        out[("L", key)] = run(mesh_name, x, values=values, **kw)
    out["trunc"] = run("4", make_input("Uniform", N4, np.float32, seed=21), slack=0.05)
    x = make_input("Exponential", N4, np.float32, seed=42)
    for retries in (0, 2):
        obs.enabled(True)
        obs.reset()
        r = run("4", x, fresh=True, slack=1.25, oversample=8, retries=retries)
        jax.effects_barrier()
        r["obs"] = {"rounds": obs.hist_values("dist.resplit_rounds"),
                    "bytes": obs.hist_values("dist.collective_bytes"),
                    "events": [e["attrs"] for e in obs.events("dist.exchange_overflow")]}
        obs.enabled(False)
        out[("resplit", retries)] = r
    x = make_input("TwoDup", N4, np.int32, seed=5)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(meshes["4"], P("data")))
    order, counts, _ = jax.jit(lambda a: dist.argsort(a, meshes["4"], "data", cfg=cfg))(xs)
    out["argsort"] = {"order": np.asarray(order), "counts": np.asarray(counts)}
    x = make_input("Exponential", N4, np.float32, seed=17)
    for mesh_name in ("4", "2x2"):
        xs = jax.device_put(jnp.asarray(x), NamedSharding(meshes[mesh_name], P(AX[mesh_name])))
        out[("rank_k", mesh_name)] = [
            tuple(np.asarray(a) for a in f(xs, 100, meshes[mesh_name], AX[mesh_name], cfg=cfg))
            for f in (dist.bottomk, dist.topk)]
    x = make_input("RootDup", N4, np.int32, seed=3)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(meshes["4"], P("data")))
    ks, starts, counts, _ = jax.jit(lambda a: dist.group_by(a, meshes["4"], "data", cfg=cfg))(xs)
    out["group_by"] = {"keys": np.asarray(ks), "starts": np.asarray(starts),
                       "counts": np.asarray(counts)}
    out["8own"] = run("2x4", make_input("Exponential", N8, np.float32, seed=42))
    out["8same"] = run("2x4", make_input("Uniform", N8, np.float32, seed=11),
                       values={"idx": np.arange(N8, dtype=np.int32)})
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    print("REFERENCE-OK")
""")


@pytest.fixture(scope="module", autouse=True)
def reference_started(tmp_path_factory):
    """The reference's child, started with the module so that it runs beside
    the ranks."""
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    spec = {"cfg": CFG, "axes": AXES, "n4": N4, "n8": N8, "dists": DISTS,
            "same4": _SAME_POSITIONS4}
    child = Child(_REFERENCE, str(path), pickle.dumps(spec).hex(), x64=False)
    yield path, child
    child.stop()


@pytest.fixture(scope="module")
def reference(reference_started):
    path, child = reference_started
    r = child.result(timeout=900)
    assert r.returncode == 0 and "REFERENCE-OK" in r.stdout, r.stdout[-3000:] + r.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks4():
    t0 = time.time()
    got = _spawn(4, "4")
    print(f"4 ranks: {time.time() - t0:.1f} s")
    return got


@pytest.fixture(scope="module")
def ranks8():
    return _spawn(8, "8")[0]


def _by_position(results, key):
    """The ranks' entries for ``key``, in position order."""
    entries = sorted((res[key] for res in results.values()), key=lambda e: e[0])
    assert [e[0] for e in entries] == list(range(len(entries)))
    return [e[1:] if len(e) > 2 else e[1] for e in entries]


def _valid_concat(shards):
    return np.concatenate([s["keys"][:s["count"]] for s in shards])


def _ref_shards(ref):
    """The reference's global outputs as per-rank shards."""
    d = ref["d"]
    cap = ref["keys"].shape[0] // d
    shards = []
    for i in range(d):
        s = {"keys": ref["keys"][i * cap:(i + 1) * cap], "count": int(ref["counts"][i]),
             "ovf": bool(ref["ovf"][i])}
        if "values" in ref:
            s["values"] = {k: v[i * cap:(i + 1) * cap] for k, v in ref["values"].items()}
        shards.append(s)
    return shards


def _ref_valid(ref):
    return _valid_concat(_ref_shards(ref))


def _keyspace_sorted(x):
    from repro_torch.ops import keyspace

    return _bits(x[np.argsort(keyspace.encode_np(x), kind="stable")])


def _assert_same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["count"], g["ovf"]) == (w["count"], w["ovf"])
        np.testing.assert_array_equal(g["keys"], w["keys"])
        for name in w.get("values", {}):
            np.testing.assert_array_equal(g["values"][name], w["values"][name])


# --------------------------------------------------------------------------
# pure functions against the reference


def test_plan_schedule_matches_the_reference():
    from repro.dist import levels as ref_levels
    from repro_torch.dist import levels

    for sizes in ({"data": 1}, {"data": 8}, {"pod": 2, "data": 4}, {"a": 3, "b": 2, "c": 5}):
        names = tuple(sizes)
        for axes in (names, names[::-1], names[:1]):
            for n_local in (1, 100, 8192, 1 << 20):
                for slack in (0.05, 1.25, 2.0, 3.0):
                    for oversample in (0, 8, 64):
                        got = levels.plan_schedule(sizes, axes, n_local, slack=slack,
                                                   oversample=oversample)
                        want = ref_levels.plan_schedule(sizes, axes, n_local, slack=slack,
                                                        oversample=oversample)
                        assert [vars(lv) for lv in got] == [vars(lv) for lv in want]
                        assert [lv.n_out for lv in got] == [lv.n_out for lv in want]
    with pytest.raises(ValueError):
        levels.plan_schedule({"data": 2}, (), 8)


def test_order_axes_and_schedule_cost_match_the_reference():
    from repro.dist import levels as ref_levels
    from repro_torch.dist import levels

    rng = np.random.default_rng(0)
    for sizes in ({"pod": 2, "data": 4}, {"pod": 2, "data": 2}, {"a": 4, "b": 2, "c": 3},
                  {"data": 8}):
        names = tuple(sizes)
        assert levels.axis_bandwidths(sizes) == ref_levels.axis_bandwidths(sizes)
        for _ in range(6):
            bw = {a: float(rng.choice([1.0, 2.0, 4.0, 16.0])) for a in names}
            for axes in (names, names[::-1]):
                for n_local in (512, 8192, 1 << 18):
                    for bws in (None, bw):
                        assert levels.order_axes(sizes, axes, n_local, bandwidths=bws) == \
                            ref_levels.order_axes(sizes, axes, n_local, bandwidths=bws)
                    sched = levels.plan_schedule(sizes, axes, n_local)
                    ref_sched = ref_levels.plan_schedule(sizes, axes, n_local)
                    for itemsize in (4, 8):
                        assert levels.schedule_cost(sched, bw, itemsize) == \
                            ref_levels.schedule_cost(ref_sched, bw, itemsize)
    for n in (1, 2, 1000, 1 << 15, 1 << 24, 1 << 40):
        assert levels.default_oversample(n) == ref_levels.default_oversample(n)
    assert levels.normalize_axes("data") == ref_levels.normalize_axes("data")


def test_splitters_from_histogram_matches_the_reference():
    import jax.numpy as jnp
    from repro.core import sampling as ref_sampling
    from repro_torch.core import sampling

    cases = [(np.asarray([10, 20, 30, 40]), np.asarray([0, 10, 80, 90]), 4, 100),
             (np.asarray([10, 20, 30, 40]), np.asarray([0, 25, 50, 75]), 4, 100)]
    rng = np.random.default_rng(1)
    for _ in range(40):
        m = int(rng.integers(1, 200))
        cands = np.sort(rng.integers(-1000, 1000, m))
        if rng.random() < 0.5:  # skew: most of the mass below one candidate
            mass = rng.integers(0, 5, m)
            mass[rng.integers(0, m)] += int(rng.integers(100, 10_000))
        else:
            mass = rng.integers(0, 100, m)
        cum = np.cumsum(mass) - mass
        total = int(mass.sum() + rng.integers(0, 50))
        cases.append((cands, cum, int(rng.choice([2, 3, 4, 8, 16, 64])), total))
    cases.append((np.arange(64), np.arange(64) * 30_000_000, 64, 64 * 30_000_000 - 1))
    for cands, cum, k, total in cases:
        got = sampling.splitters_from_histogram(torch.as_tensor(cands, dtype=torch.int32),
                                                torch.as_tensor(cum), k, torch.tensor(total))
        want = ref_sampling.splitters_from_histogram(
            jnp.asarray(cands, jnp.int32), jnp.asarray(cum, jnp.int32), k,
            jnp.asarray(total, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_dist_autotune_chooses_as_the_reference(dtype, tmp_path):
    import jax.numpy as jnp
    from repro.ops import plan as ref_plan
    from repro_torch.ops import plan

    for n_local, d in ((2048, 4), (8192, 8), (4096, 2)):
        got = plan.PlanCache(str(tmp_path / "port.json")).dist_plan(
            n_local, d, getattr(torch, dtype), tune=True)
        want = ref_plan.PlanCache(str(tmp_path / "ref.json")).dist_plan(
            n_local, d, getattr(jnp, dtype), tune=True)
        assert (got.slack, got.oversample) == (want.slack, want.oversample)
        port_entry = json.loads((tmp_path / "port.json").read_text())[
            f"dist:n_local={n_local}:d={d}:dtype={dtype}"]
        ref_entry = json.loads((tmp_path / "ref.json").read_text())[
            f"dist:n_local={n_local}:d={d}:dtype={dtype}"]
        assert port_entry["sim_max_fill"] == ref_entry["sim_max_fill"]
        assert "engine" not in port_entry and "engine" not in port_entry["config"]


def test_dist_plan_round_trip_with_a_reference_entry(tmp_path):
    import jax.numpy as jnp
    from repro.ops import plan as ref_plan
    from repro_torch.ops import plan

    path = str(tmp_path / "plans.json")
    ref = ref_plan.PlanCache(path)
    ref.dist_plan(8192, 8, jnp.float32, tune=True)
    ref.record_dist_axis_order(8192, 8, jnp.float32, ("pod", "data"))
    want = ref_plan.PlanCache(path).dist_plan(8192, 8, jnp.float32)
    pc = plan.PlanCache(path)
    got = pc.dist_plan(8192, 8, torch.float32)
    assert (got.slack, got.oversample, got.axis_order) == (
        want.slack, want.oversample, want.axis_order)
    assert not hasattr(got, "engine")
    # the migration drops the engine at the next save; the knobs survive it
    pc.record_dist_axis_order(4096, 2, torch.int32, ("data",))
    entry = json.loads(open(path).read())["dist:n_local=8192:d=8:dtype=float32"]
    assert "engine" not in entry and "engine" not in entry["config"]
    again = plan.PlanCache(path).dist_plan(8192, 8, torch.float32)
    assert again == got
    # defaults, a foreign entry, and a re-tune keeping the recorded order
    fresh = plan.PlanCache(str(tmp_path / "other.json"))
    assert fresh.dist_plan(8192, 8, torch.float32).slack == 2.0
    assert fresh.dist_plan(8192, 8, torch.float32).oversample == ref.dist_plan(
        8192, 8, jnp.int8).oversample
    (tmp_path / "foreign.json").write_text(json.dumps(
        {"dist:n_local=4096:d=4:dtype=int32": {"config": {"slack": "huge"}}}))
    assert plan.PlanCache(str(tmp_path / "foreign.json")).dist_plan(
        4096, 4, torch.int32).slack == 2.0
    tuned = pc.dist_plan(8192, 8, torch.float32, tune=True)
    assert tuned.axis_order == ("pod", "data")


def test_refusals():
    from repro_torch import dist
    from repro_torch.dist import api

    class FakeMesh:  # enough of a DeviceMesh for the checks made before any collective
        device_type = "cuda"
        mesh_dim_names = ("data",)
        mesh = torch.arange(2).reshape(2)

    x = torch.zeros(8)
    with pytest.raises(ValueError, match="mesh is on cuda"):
        dist.sort(x, FakeMesh(), "data")
    with pytest.raises(ValueError, match="engine"):
        dist.sort(x, FakeMesh(), "data", engine="pallas")
    with pytest.raises(ValueError, match="axes"):
        api._prepare(x.cuda() if torch.cuda.is_available() else x, FakeMesh(), "pod")
    FakeMesh.device_type = "cpu"
    with pytest.raises(ValueError, match="divisible"):
        dist.sort(torch.zeros(7), FakeMesh(), "data")
    with pytest.raises(ValueError, match="order"):
        api._resolve_order("fastest", ("data",), FakeMesh(), 8, 2, torch.float32, (), 2.0, 32)


def test_exchange_pieces_on_one_rank():
    from repro_torch.dist import exchange
    from repro_torch.dist.levels import plan_schedule

    assert exchange.tile_for(48, 32) == 16 and exchange.tile_for(7, 4) == 1
    one = exchange.Group(None, 1, 0)
    (lv,) = plan_schedule({"data": 1}, "data", 512, slack=0.25)
    keys = torch.arange(512, dtype=torch.int32).flip(0)
    out, m, ovf = exchange.exchange_level({"k": keys, "v": torch.arange(512)},
                                          torch.tensor(512), lv, domain=one, axis=one,
                                          tile=64, seed=0, level_idx=0)
    assert out["k"].shape[0] == lv.n_out == 128 and int(m) == 128 and bool(ovf)
    assert torch.equal(out["k"], keys[:128]) and torch.equal(out["v"], torch.arange(128))
    a = exchange.sample_positions(7, 1, 2, 3, 64, torch.tensor(1000))
    b = exchange.sample_positions(7, 1, 2, 3, 64, torch.tensor(1000))
    c = exchange.sample_positions(7, 1, 2, 4, 64, torch.tensor(1000))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    k = torch.tensor([5, 9, 5, 5, 1, 7], dtype=torch.int32)
    dest, counts = exchange._classify(k, torch.tensor([5, 5], dtype=torch.int32),
                                      torch.tensor([True] * 5 + [False]), 3)
    assert dest[-1] == 3 and int(counts.sum()) == 5 and dest[4] == 0 and dest[1] == 2
    # radix destinations: the top bits of the reference's unsigned codes
    codes = torch.tensor([-2**31, -1, 0, 2**31 - 1], dtype=torch.int32)
    dest, counts = exchange._radix_dest(codes, torch.ones(4, dtype=torch.bool), 4)
    assert dest.tolist() == [0, 1, 2, 3] and counts.tolist() == [1, 1, 1, 1]


# --------------------------------------------------------------------------
# many ranks


def test_inputs_equal_the_reference_generators():
    from repro.data.distributions import make_input as ref_make_input
    from repro_torch.data.distributions import make_input

    for name in DISTS:
        for dtype in (np.float32, np.int32):
            np.testing.assert_array_equal(make_input(name, N4, dtype, seed=42),
                                          ref_make_input(name, N4, dtype, seed=42))


@pytest.mark.parametrize("mesh_name", ["4", "2x2"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_multilevel_bit_identity(ranks4, reference, mesh_name, dtype):
    from repro_torch.data.distributions import make_input

    results, _ = ranks4
    for name in DISTS:
        shards = _by_position(results, ("A", mesh_name, name, dtype))
        assert not any(s["ovf"] for s in shards), name
        got = _valid_concat(shards)
        x = make_input(name, N4, getattr(np, dtype), seed=42)
        np.testing.assert_array_equal(got, _keyspace_sorted(x))
        np.testing.assert_array_equal(got, _ref_valid(reference[("A", mesh_name, name, dtype)]))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_overlap_bit_identical_to_sync(ranks4, dtype):
    results, _ = ranks4
    for name in DISTS:
        _assert_same_shards(_by_position(results, ("B", name, dtype)),
                            _by_position(results, ("A", "2x2", name, dtype)))


@pytest.mark.parametrize("case", [c[0] for c in _SAME_POSITIONS4])
def test_per_rank_outputs_equal_the_reference_on_its_positions(ranks4, reference, case):
    results, _ = ranks4
    _assert_same_shards(_by_position(results, ("L", case)), _ref_shards(reference[("L", case)]))


def test_payload_rides_two_axes(ranks4):
    from repro_torch.data.distributions import make_input

    results, _ = ranks4
    shards = _by_position(results, ("L", "payload"))
    x = make_input("Uniform", N4, np.float32, seed=42)
    keys = _valid_concat(shards)
    idx = np.concatenate([s["values"]["idx"][:s["count"]] for s in shards])
    w = np.concatenate([s["values"]["w"][:s["count"]] for s in shards])
    np.testing.assert_array_equal(keys, _keyspace_sorted(x))
    np.testing.assert_array_equal(_bits(x[idx]), keys)  # rows followed their keys
    np.testing.assert_array_equal(w, idx[:, None] * np.asarray([1, 2, 3], np.float32))
    assert sorted(idx.tolist()) == list(range(N4))


def test_argsort_global_order(ranks4, reference):
    from repro_torch.data.distributions import make_input

    results, _ = ranks4
    parts = _by_position(results, "argsort")
    gidx = np.concatenate([p[0] for p in parts])
    assert not any(p[1] for p in parts)
    x = make_input("TwoDup", N4, np.int32, seed=5)
    assert sorted(gidx.tolist()) == list(range(N4))
    np.testing.assert_array_equal(x[gidx], np.sort(x))
    ref = reference["argsort"]
    cap = ref["order"].shape[0] // 4
    np.testing.assert_array_equal(gidx, np.concatenate(
        [ref["order"][i * cap:i * cap + ref["counts"][i]] for i in range(4)]))


@pytest.mark.parametrize("mesh_name", ["4", "2x2"])
def test_rank_k_equals_the_reference_on_every_rank(ranks4, reference, mesh_name):
    from repro_torch.data.distributions import make_input

    results, _ = ranks4
    x = make_input("Exponential", N4, np.float32, seed=17)
    want = reference[("rank_k", mesh_name)]
    for res in results.values():
        (bv, bi), (tv, ti) = res[("rank_k", mesh_name)]
        np.testing.assert_array_equal(_bits(bv), _bits(np.sort(x)[:100]))
        np.testing.assert_array_equal(_bits(tv), _bits(np.sort(x)[::-1][:100]))
        for (v, i), (wv, wi) in zip(((bv, bi), (tv, ti)), want):
            np.testing.assert_array_equal(_bits(v), _bits(wv))
            np.testing.assert_array_equal(i, wi)


def test_group_by_per_rank_runs(ranks4, reference):
    from repro_torch.data.distributions import make_input

    results, _ = ranks4
    parts = _by_position(results, "group_by")
    x = make_input("RootDup", N4, np.int32, seed=3)
    total = 0
    for ks, starts, count, ovf in parts:
        assert not ovf
        seg = ks[:count]
        want = np.ones(count, bool)
        want[1:] = seg[1:] != seg[:-1]
        np.testing.assert_array_equal(starts[:count], want)
        assert not starts[count:].any()
        total += int(starts.sum())
    uniq = len(np.unique(x))
    assert uniq <= total <= uniq + 3  # runs split only at rank boundaries
    keys = np.concatenate([p[0][:p[2]] for p in parts])
    np.testing.assert_array_equal(keys, np.sort(x))
    ref = reference["group_by"]
    cap = ref["keys"].shape[0] // 4
    np.testing.assert_array_equal(keys, np.concatenate(
        [ref["keys"][i * cap:i * cap + ref["counts"][i]] for i in range(4)]))


def test_truncation_contract(ranks4, reference):
    results, _ = ranks4
    entries = sorted((res["trunc"] for res in results.values()), key=lambda e: e[0])
    first = [e[1][0] for e in entries]
    second = [e[1][1] for e in entries]
    assert any(s["ovf"] for s in first), "an undersized capacity must flag overflow"
    for s in first:
        cap = s["keys"].shape[0] // 4
        assert s["count"] <= 4 * cap
        valid = s["keys"][:s["count"]].view(np.float32)
        assert np.all(valid[:-1] <= valid[1:]), "a truncated rank must stay sorted"
    _assert_same_shards(second, first)  # deterministic
    _assert_same_shards(first, _ref_shards(reference["trunc"]))


def test_resplit_rounds_converge_with_the_reference_metrics(ranks4, reference):
    from repro_torch.data.distributions import make_input

    results, _ = ranks4
    x = make_input("Exponential", N4, np.float32, seed=42)
    for retries in (0, 2):
        entries = sorted((res[("resplit", retries)] for res in results.values()),
                         key=lambda e: e[0])
        shards = [e[1] for e in entries]
        want = reference[("resplit", retries)]
        _assert_same_shards(shards, _ref_shards(want))
        rounds = sorted(v for e in entries for v in e[2]["rounds"])
        volume = sorted(v for e in entries for v in e[2]["bytes"])
        events = [ev for e in entries for ev in e[2]["events"]]
        assert rounds == sorted(want["obs"]["rounds"])
        assert volume == sorted(want["obs"]["bytes"])
        assert events == want["obs"]["events"]
        if retries == 0:
            assert any(s["ovf"] for s in shards) and events
            assert max(np.atleast_1d(events[0]["round_fill"])) > 1.0
        else:
            assert not any(s["ovf"] for s in shards) and max(rounds) >= 2 and not events
            np.testing.assert_array_equal(_valid_concat(shards), _bits(np.sort(x)))
    _assert_same_shards(_by_position(results, "resplit_overlap"),
                        [e[1] for e in sorted((res[("resplit", 2)] for res in results.values()),
                                              key=lambda e: e[0])])


def test_auto_order_sorts_and_records(ranks4):
    from repro_torch.data.distributions import make_input

    results, _ = ranks4
    entries = _by_position(results, "auto")
    declared = [e[0] for e in entries]
    again = [e[1] for e in entries]
    x = make_input("Uniform", N4, np.float32, seed=42)
    np.testing.assert_array_equal(_valid_concat(declared), _keyspace_sorted(x))
    _assert_same_shards(declared, again)
    assert all(tuple(e[2]) == ("pod", "data") for e in entries)


@pytest.mark.parametrize("dtype", ["float64", "int64", "uint8", "bfloat16"])
@pytest.mark.parametrize("classifier", ["tree", "radix"])
def test_other_key_dtypes_across_ranks(ranks4, dtype, classifier):
    """float64 and int64 keys travel as int64 codes, uint8 and bfloat16 as
    left-aligned int32 codes; the valid prefixes concatenated are the stable
    sort of the codes, and the payload followed its keys."""
    from repro_torch.ops import keyspace

    results, _ = ranks4
    parts = _by_position(results, ("dtype", dtype, classifier))
    x = torch.as_tensor(_other_dtype_inputs()[dtype])
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    codes = keyspace.encode(x).numpy()
    assert not any(p[2] for p in parts)
    got = np.concatenate([p[0] for p in parts])
    idx = np.concatenate([p[1] for p in parts])
    np.testing.assert_array_equal(got, np.sort(codes, kind="stable"))
    np.testing.assert_array_equal(codes[idx], got)
    assert sorted(idx.tolist()) == list(range(N4))


def test_d1_equals_ops_sort(ranks4):
    results, _ = ranks4
    assert all(res["d1"] for res in results.values())


def test_eight_ranks_on_two_by_four(ranks8, reference):
    from repro_torch.data.distributions import make_input

    own = _by_position(ranks8, "own")
    x = make_input("Exponential", N8, np.float32, seed=42)
    np.testing.assert_array_equal(_valid_concat(own), _keyspace_sorted(x))
    np.testing.assert_array_equal(_valid_concat(own), _ref_valid(reference["8own"]))
    _assert_same_shards(_by_position(ranks8, "same"), _ref_shards(reference["8same"]))
