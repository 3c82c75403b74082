"""``repro_torch.checkpoint`` and ``repro_torch.dist.sort_elastic`` on the
CPU.  Tolerance 0: outputs compared as bit patterns.

  * **checkpoints** in one process: the save/restore round trip (a bfloat16
    leaf, a payload pytree, host values), ``read_leaf``, a ``.tmp``
    directory ignored by ``latest_step`` and removed by the next manager,
    retention by ``keep``, the async save, and the refusals (another shape,
    another world size);
  * **checkpoints across ranks**: 4 ``gloo`` ranks write one ``.npy`` per
    (leaf, shard) each; the manifest holds the logical layout; every rank
    restores its own shard, and ``read_leaf`` the logical array;
  * **the elastic sort** on 4 ``gloo`` ranks (meshes (4,), (2, 2) and
    (4, 1)): uninterrupted equal to ``dist.sort``; killed at every level
    boundary (0: the pre-exchange, 1: the "pod" level, 2: the "data"
    level) and restored in a fresh process group by a fresh manager over
    the same directory, equal to the uninterrupted sort; a restore
    landing before the level whose re-split rounds engage; overlap with a
    payload and async saves; the finished directory replayed; the
    fingerprint guard.

The ranks are spawned once for the module, each with a ``file://``
rendezvous under a temporary directory (a new one for each fresh process
group).  On one H100 NCCL reaches world size 1 only; several ranks on one
card run with ``gloo``.
"""
import json
import os
import queue as queue_mod
import tempfile
import traceback

import numpy as np
import pytest
import torch

N = 1 << 15
CFG = dict(base_case=2048, kmax=32, tile=512, max_sample=2048)


# --------------------------------------------------------------------------
# one process


def test_checkpoint_round_trip(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    ck = CheckpointManager(str(tmp_path / "ck"))
    assert ck.latest_step() is None
    state = {"arrays": {"k": torch.arange(10, dtype=torch.int32),
                        "v": [torch.ones(10, 3), None]},
             "b16": (torch.arange(16, dtype=torch.float32) / 7).to(torch.bfloat16),
             "flag": torch.tensor([True]), "level": np.int32(2),
             "fingerprint": np.arange(32, dtype=np.uint8)}
    ck.save(5, state)
    assert ck.latest_step() == 5
    like = {"arrays": {"k": torch.empty(10, dtype=torch.int32),
                       "v": [torch.empty(10, 3), None]},
            "b16": torch.empty(16, dtype=torch.bfloat16), "flag": torch.empty(1, dtype=torch.bool),
            "level": None, "fingerprint": np.zeros(32, np.uint8)}
    got = ck.restore(5, like)
    assert torch.equal(got["arrays"]["k"], state["arrays"]["k"])
    assert torch.equal(got["arrays"]["v"][0], state["arrays"]["v"][0])
    assert got["arrays"]["v"][1] is None and got["level"] is None
    assert torch.equal(got["b16"].view(torch.int16), state["b16"].view(torch.int16))
    assert bool(got["flag"][0]) and np.array_equal(got["fingerprint"], state["fingerprint"])
    assert int(ck.read_leaf(5, "level")) == 2
    assert torch.equal(ck.read_leaf(5, "b16").view(torch.int16), state["b16"].view(torch.int16))
    manifest = json.loads((tmp_path / "ck" / "step_0000000005" / "MANIFEST.json").read_text())
    assert manifest["world"] == 1
    assert manifest["leaves"]["arrays/v/0"]["logical_shape"] == [10, 3]
    assert manifest["leaves"]["level"]["kind"] == "replicated"
    with pytest.raises(ValueError, match="checkpoint"):
        ck.restore(5, {**like, "b16": torch.empty(8, dtype=torch.bfloat16)})


def test_tmp_ignored_and_collected_and_keep(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    d = tmp_path / "ck"
    ck = CheckpointManager(str(d), keep=2)
    for step in range(4):
        ck.save(step, {"w": torch.full((4,), step)})
    assert sorted(os.listdir(d)) == ["step_0000000002", "step_0000000003"]
    (d / "step_0000000009.tmp").mkdir()  # a save that died before its commit
    (d / "step_0000000009.tmp" / "w.shard0.npy").write_bytes(b"partial")
    assert ck.latest_step() == 3
    again = CheckpointManager(str(d), keep=2)
    assert not (d / "step_0000000009.tmp").exists()
    assert again.restore(3, {"w": torch.empty(4, dtype=torch.int64)})["w"].tolist() == [3] * 4


def test_async_save(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    ck = CheckpointManager(str(tmp_path / "ck"))
    w = torch.arange(1000)
    ck.save(1, {"w": w}, blocking=False)
    w += 1  # the snapshot was taken at the call
    ck.save(2, {"w": w}, blocking=False)  # waits for the first save
    ck.wait()
    assert ck.latest_step() == 2
    assert torch.equal(ck.restore(1, {"w": w})["w"], torch.arange(1000))
    assert torch.equal(ck.restore(2, {"w": w})["w"], torch.arange(1000) + 1)


def test_restore_refuses_another_world_size(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    d = tmp_path / "ck"
    CheckpointManager(str(d)).save(1, {"w": torch.zeros(2)})
    path = d / "step_0000000001" / "MANIFEST.json"
    manifest = json.loads(path.read_text())
    manifest["world"] = 4
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="4 ranks"):
        CheckpointManager(str(d)).restore(1, {"w": torch.zeros(2)})


# --------------------------------------------------------------------------
# many ranks (spawned; this module imports neither jax nor repro)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _host(res):
    return [_bits(t) if isinstance(t, torch.Tensor) else
            {k: _bits(v) for k, v in t.items()} for t in res]


def _cases(rank, world, tmp, new_group):
    """Every elastic case on this rank; ``new_group()`` destroys the process
    group and makes a fresh one (a restarted job), returning its meshes."""
    from repro_torch import dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.ips4o import SortConfig
    from repro_torch.data.distributions import make_input

    cfg = SortConfig(**CFG)
    out = {}
    meshes = new_group()

    # sharded checkpoints across the ranks
    d = os.path.join(tmp, "shards")
    ck = CheckpointManager(d)
    ck.save(3, {"w": torch.arange(4) + 10 * rank, "level": np.int32(7)})
    out["files"] = sorted(os.listdir(os.path.join(d, "step_0000000003")))
    out["own"] = ck.restore(3, {"w": torch.empty(4, dtype=torch.int64)})["w"].tolist()
    out["logical"] = ck.read_leaf(3, "w").tolist()

    def shard(x):
        n_local = x.shape[0] // world
        return torch.as_tensor(x[rank * n_local:(rank + 1) * n_local])

    x = make_input("Exponential", N, np.float32, seed=42)
    xs = shard(x)
    # uninterrupted elastic == dist.sort on both mesh shapes
    for name, axes in (("4", "data"), ("2x2", ("pod", "data"))):
        ref = dist.sort(xs, meshes[name], axes, cfg=cfg)
        ck = CheckpointManager(os.path.join(tmp, f"whole{name}"), keep=8)
        got = dist.sort_elastic(xs, meshes[name], axes, manager=ck, cfg=cfg)
        out[("whole", name)] = (_host(got), _host(ref), ck.latest_step())
        # a finished directory replays its finish
        again = dist.sort_elastic(xs, meshes[name], axes, manager=ck, cfg=cfg)
        out[("replay", name)] = _host(again)

    # killed at every boundary of the (2, 2) mesh, restored in a fresh group
    axes = ("pod", "data")
    ref = _host(dist.sort(xs, meshes["2x2"], axes, cfg=cfg))
    for boundary in (0, 1, 2):
        ckdir = os.path.join(tmp, f"kill{boundary}")
        try:
            dist.sort_elastic(xs, meshes["2x2"], axes, manager=CheckpointManager(ckdir, keep=8),
                              cfg=cfg, _fail_at_step=boundary)
            killed = False
        except RuntimeError as exc:
            killed = "injected shard loss" in str(exc)
        meshes = new_group()
        survivor = CheckpointManager(ckdir, keep=8)
        latest = survivor.latest_step()
        got = _host(dist.sort_elastic(xs, meshes["2x2"], axes, manager=survivor, cfg=cfg))
        out[("kill", boundary)] = (killed, latest, got, ref)

    # the restore lands before the level whose re-split rounds engage
    kw = dict(cfg=cfg, slack=1.25, oversample=8, retries=4)
    ref = _host(dist.sort(xs, meshes["4"], "data", **kw))
    ckdir = os.path.join(tmp, "resplit")
    try:
        dist.sort_elastic(xs, meshes["4"], "data", manager=CheckpointManager(ckdir, keep=8),
                          _fail_at_step=0, **kw)
    except RuntimeError:
        pass
    meshes = new_group()
    from repro_torch import obs

    obs.enabled(True)
    got = _host(dist.sort_elastic(xs, meshes["4"], "data",
                                  manager=CheckpointManager(ckdir, keep=8), **kw))
    with_rounds = obs.hist_values("dist.resplit_rounds")
    obs.enabled(False)
    obs.reset()
    out["resplit"] = (got, ref, with_rounds)

    # overlap + payload + async saves, killed after the last boundary
    xi = make_input("TwoDup", N, np.int32, seed=7)
    xis = shard(xi)
    vs = {"idx": shard(np.arange(N, dtype=np.int32)), "half": shard(xi.astype(np.float32) / 2)}
    ref = dist.sort(xis, meshes["2x2"], axes, values=vs, cfg=cfg, overlap=True)
    ckdir = os.path.join(tmp, "overlap")
    try:
        dist.sort_elastic(xis, meshes["2x2"], axes, manager=CheckpointManager(ckdir, keep=8),
                          values=vs, cfg=cfg, overlap=True, blocking_saves=False,
                          _fail_at_step=2)
    except RuntimeError:
        pass
    meshes = new_group()
    got = dist.sort_elastic(xis, meshes["2x2"], axes, manager=CheckpointManager(ckdir, keep=8),
                            values=vs, cfg=cfg, overlap=True, blocking_saves=False)
    out["overlap"] = (_host(got), _host(ref))

    # the fingerprint guard: another slack must not resume this directory
    try:
        dist.sort_elastic(xis, meshes["2x2"], axes, manager=CheckpointManager(ckdir, keep=8),
                          values=vs, cfg=cfg, overlap=True, slack=3.0)
        out["guard"] = False
    except ValueError as exc:
        out["guard"] = "fingerprint" in str(exc)

    # d = 1 on the (4, 1) mesh: every rank alone, killed and restored
    ref = _host(dist.sort(xs, meshes["4x1"], "data", cfg=cfg))
    ckdir = os.path.join(tmp, f"d1_{rank}")  # one directory per one-rank job
    try:
        dist.sort_elastic(xs, meshes["4x1"], "data", cfg=cfg, _fail_at_step=0,
                          manager=CheckpointManager(ckdir, group=_one_rank_group(meshes)))
    except RuntimeError:
        pass
    survivor = CheckpointManager(ckdir, group=_one_rank_group(meshes))
    out["d1"] = (survivor.latest_step(),
                 _host(dist.sort_elastic(xs, meshes["4x1"], "data", cfg=cfg, manager=survivor)),
                 ref)
    return out


def _one_rank_group(meshes):
    """This rank's one-rank group (the (4, 1) mesh's "data" axis)."""
    return meshes["4x1"].get_group("data")


def _rank_main(rank, world, tmp, q):
    try:
        torch.set_num_threads(1)
        os.environ["REPRO_TORCH_OPS_PLAN_CACHE"] = os.path.join(tmp, f"plans{rank}.json")
        import torch.distributed as tdist
        from torch.distributed.device_mesh import init_device_mesh

        made = [0]

        def new_group():
            if tdist.is_initialized():
                tdist.destroy_process_group()
            made[0] += 1
            tdist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous{made[0]}",
                                     rank=rank, world_size=world)
            return {"4": init_device_mesh("cpu", (4,), mesh_dim_names=("data",)),
                    "2x2": init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data")),
                    "4x1": init_device_mesh("cpu", (4, 1), mesh_dim_names=("pod", "data"))}

        res = _cases(rank, world, tmp, new_group)
        q.put((rank, res))
        tdist.destroy_process_group()
    except BaseException:
        q.put((rank, {"__error__": traceback.format_exc()}))


@pytest.fixture(scope="module")
def ranks():
    import torch.multiprocessing as mp

    world, timeout = 4, 600
    tmp = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, tmp, q)) for r in range(world)]
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
    return got


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_array_equal(g, w)


def test_sharded_checkpoint_across_ranks(ranks):
    for rank, res in ranks.items():
        assert res["files"] == ["DONE.0", "DONE.1", "DONE.2", "DONE.3", "MANIFEST.json",
                                "level.npy", "w.shard0.npy", "w.shard1.npy", "w.shard2.npy",
                                "w.shard3.npy"]
        assert res["own"] == [10 * rank + i for i in range(4)]
        assert res["logical"] == [10 * r + i for r in range(4) for i in range(4)]


@pytest.mark.parametrize("mesh_name", ["4", "2x2"])
def test_elastic_equals_dist_sort(ranks, mesh_name):
    for res in ranks.values():
        got, ref, latest = res[("whole", mesh_name)]
        _same(got, ref)
        assert latest == (1 if mesh_name == "4" else 2)  # boundaries: init + each level
        _same(res[("replay", mesh_name)], ref)


@pytest.mark.parametrize("boundary", [0, 1, 2])
def test_kill_and_restore_at_every_boundary(ranks, boundary):
    for res in ranks.values():
        killed, latest, got, ref = res[("kill", boundary)]
        assert killed and latest == boundary
        _same(got, ref)


def test_restore_before_the_resplit_level(ranks):
    for rank, res in ranks.items():
        got, ref, rounds = res["resplit"]
        _same(got, ref)
        assert not got[-1].any()
        if rank == 0:
            assert rounds and max(rounds) >= 2  # the resumed level re-split


def test_overlap_payload_async_saves_restore(ranks):
    for res in ranks.values():
        got, ref = res["overlap"]
        _same(got, ref)


def test_fingerprint_guard(ranks):
    assert all(res["guard"] for res in ranks.values())


def test_d1_kill_and_restore(ranks):
    for res in ranks.values():
        latest, got, ref = res["d1"]
        assert latest == 0
        _same(got, ref)
