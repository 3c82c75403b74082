"""The port's batch scheduler (``repro_torch.serve.scheduler``) against the
reference's, on the CPU, and the mesh forms of the scheduler and of the
length packing (``repro_torch.data.pipeline``) on spawned ``gloo`` ranks.

  * ``next_batch`` over successive admissions with heavy ties on
    ``remaining`` (FIFO among them), a queue that grows between calls and
    queues shorter than the batch; ``admit_many`` over a ragged fleet (an
    empty queue, a queue with a backlog, a queue whose composite keys
    overflow int32, other batch sizes); ``attach_backlog`` twice (the
    runs merged on the host, earlier attaches winning ties) and the merged
    view's admissions through ``stream.merge``; the int32-overflow
    fallbacks (``np.lexsort`` on the host) and ``remaining`` at the
    sentinel (the host-side merge); the four obs sites (spans
    ``serve.next_batch`` and ``serve.admit_many``, counters
    ``serve.admitted`` and ``serve.backlog_attached``) equal to the
    reference's.  Admitted uids are compared in order, exactly.
  * **ranks**: four ``gloo`` ranks spawned once for the module (a
    ``file://`` rendezvous under a temporary directory), with the meshes
    (4,) and (2, 2): every rank holds the same queue and calls
    ``next_batch(mesh=)`` (queues of 20 and 50: a padded queue of 32
    splits into shards of 8; the reference's ``tests/test_dist.py``
    cases) and ``pack_by_length(mesh=)`` on 3000 lengths; each rank's
    admissions equal the single-device ones, exactly; each rank's packing
    has the single-device row count and is the same on every rank and
    valid (no row overfull, no two documents overlapping).  The
    distributed argsort does not keep the input order of equal lengths,
    so which of two equal documents lands where may differ from the
    single-device packing, as in the reference.
"""
import os
import queue as queue_mod
import tempfile
import traceback

import numpy as np
import pytest

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _plans_and_obs(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_OPS_PLAN_CACHE", str(tmp_path / "port_plans.json"))
    monkeypatch.setenv("REPRO_OPS_PLAN_CACHE", str(tmp_path / "ref_plans.json"))
    from repro import obs as ref_obs
    from repro_torch import obs

    for o in (obs, ref_obs):
        o.enabled(False)
        o.reset()
    yield
    for o in (obs, ref_obs):
        o.enabled(False)
        o.reset()


def _pair(batch_size, max_news, done=None):
    """(the port's Scheduler, the reference's) with the same queue."""
    from repro.serve import scheduler as ref_sched
    from repro_torch.serve import scheduler as sched

    port = sched.Scheduler(batch_size=batch_size, **CPU)
    ref = ref_sched.Scheduler(batch_size=batch_size)
    for uid, m in enumerate(max_news):
        d = 0 if done is None else done[uid]
        port.submit(sched.Request(uid=uid, prompt_len=10, max_new=int(m), done=d))
        ref.submit(ref_sched.Request(uid=uid, prompt_len=10, max_new=int(m), done=d))
    return port, ref


def _uids(batch):
    return [r.uid for r in batch]


def _submit(port, ref, uid, max_new):
    from repro.serve import scheduler as ref_sched
    from repro_torch.serve import scheduler as sched

    port.submit(sched.Request(uid=uid, prompt_len=3, max_new=max_new))
    ref.submit(ref_sched.Request(uid=uid, prompt_len=3, max_new=max_new))


@pytest.mark.parametrize("n,batch,high", [(100, 8, 4), (37, 16, 50), (5, 8, 3), (300, 64, 2)])
def test_next_batch_equals_the_reference(n, batch, high):
    rng = np.random.default_rng(n)
    port, ref = _pair(batch, rng.integers(1, high + 1, n))
    uid = n
    for _ in range(4):
        assert _uids(port.next_batch()) == _uids(ref.next_batch())
        for m in rng.integers(1, high + 1, 3):  # the queue grows between calls
            _submit(port, ref, uid, int(m))
            uid += 1
    assert _uids(port.queue) == _uids(ref.queue)


def test_ties_admit_in_fifo_order():
    port, _ = _pair(4, [2, 1, 2, 1, 1, 3])
    assert _uids(port.next_batch()) == [1, 3, 4, 0]


def test_backlog_and_merged_view_equal_the_reference():
    from repro.serve import scheduler as ref_sched
    from repro_torch.serve import scheduler as sched

    rng = np.random.default_rng(3)
    port, ref = _pair(8, rng.integers(1, 6, 30))
    for start, count in ((1000, 12), (2000, 9)):  # two attaches: merged on the host
        rem = rng.integers(1, 6, count)
        port.attach_backlog([sched.Request(uid=start + i, prompt_len=4, max_new=int(m))
                             for i, m in enumerate(rem)])
        ref.attach_backlog([ref_sched.Request(uid=start + i, prompt_len=4, max_new=int(m))
                            for i, m in enumerate(rem)])
    assert _uids(port.backlog) == _uids(ref.backlog)
    for _ in range(8):
        assert _uids(port.next_batch()) == _uids(ref.next_batch())
    assert _uids(port.backlog) == _uids(ref.backlog) and not port.queue


def test_overflow_fallbacks_equal_the_reference():
    from repro.serve import scheduler as ref_sched
    from repro_torch.serve import scheduler as sched

    big = 1 << 29  # remaining * n_pad passes int32.max: the host lexsort
    port, ref = _pair(4, [big, 5, big, 7, 5, big + 1, 1])
    assert _uids(port.next_batch()) == _uids(ref.next_batch())
    assert _uids(port.next_batch()) == _uids(ref.next_batch())
    # a backlog whose remaining reaches the sentinel: the host-side merge
    huge = int(np.iinfo(np.int32).max) + 5
    port, ref = _pair(3, [4, 2, 9])
    port.attach_backlog([sched.Request(uid=50, prompt_len=1, max_new=huge),
                         sched.Request(uid=51, prompt_len=1, max_new=2)])
    ref.attach_backlog([ref_sched.Request(uid=50, prompt_len=1, max_new=huge),
                        ref_sched.Request(uid=51, prompt_len=1, max_new=2)])
    for _ in range(3):
        assert _uids(port.next_batch()) == _uids(ref.next_batch())


@pytest.mark.parametrize("seed", [0, 1])
def test_admit_many_equals_the_reference(seed):
    from repro.serve import scheduler as ref_sched
    from repro_torch.serve import scheduler as sched

    rng = np.random.default_rng(seed)
    fleet = []
    for i, (n, batch) in enumerate(((40, 8), (0, 4), (13, 16), (70, 8), (5, 2))):
        fleet.append(_pair(batch, rng.integers(1, 5, n)))
    port_b, ref_b = _pair(4, rng.integers(1, 5, 9))  # one with a backlog
    port_b.attach_backlog([sched.Request(uid=900 + i, prompt_len=1, max_new=i % 3 + 1)
                           for i in range(6)])
    ref_b.attach_backlog([ref_sched.Request(uid=900 + i, prompt_len=1, max_new=i % 3 + 1)
                          for i in range(6)])
    fleet.append((port_b, ref_b))
    fleet.append(_pair(4, [1 << 29, 3, 1 << 29, 2]))  # overflow: its own host path
    ports, refs = [p for p, _ in fleet], [r for _, r in fleet]
    for _ in range(3):
        got = [_uids(b) for b in sched.admit_many(ports)]
        want = [_uids(b) for b in ref_sched.admit_many(refs)]
        assert got == want
    assert sched.admit_many([]) == ref_sched.admit_many([]) == []


def test_obs_sites_equal_the_reference():
    import jax

    from repro import obs as ref_obs
    from repro.serve import scheduler as ref_sched
    from repro_torch import obs
    from repro_torch.serve import scheduler as sched

    obs.enabled(True)
    ref_obs.enabled(True)
    port, ref = _pair(4, [3, 1, 2, 2, 5, 1])
    port.attach_backlog([sched.Request(uid=70, prompt_len=1, max_new=2)])
    ref.attach_backlog([ref_sched.Request(uid=70, prompt_len=1, max_new=2)])
    port.next_batch()
    ref.next_batch()
    ports = [_pair(2, [2, 1, 3])[0], _pair(3, [1, 1])[0]]
    refs = [_pair(2, [2, 1, 3])[1], _pair(3, [1, 1])[1]]
    sched.admit_many(ports)
    ref_sched.admit_many(refs)
    jax.effects_barrier()
    for name in ("serve.admitted", "serve.backlog_attached"):
        assert obs.counter_value(name) == ref_obs.counter_value(name) > 0
    got = [(s["name"], s["attrs"]) for s in obs.recorder().spans if s["name"].startswith("serve.")]
    want = [(s["name"], s["attrs"]) for s in ref_obs.recorder().spans
            if s["name"].startswith("serve.")]
    assert got == want and {n for n, _ in got} == {"serve.next_batch", "serve.admit_many"}


def test_selection_defaults_to_the_card(monkeypatch):
    import torch

    from repro_torch.serve import scheduler as sched

    s = sched.Scheduler(batch_size=2)
    s.submit(sched.Request(uid=0, prompt_len=1, max_new=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.next_batch()


# --------------------------------------------------------------------------
# the mesh forms on spawned gloo ranks (this part imports neither jax nor
# repro in the ranks)

SCHED_CASES = (20, 50)
PACK_N, PACK_SEQ = 3000, 1024


def _sched_lengths(n):
    return [int(v) for v in np.random.default_rng(0).integers(1, 20, n)]


def _pack_lengths():
    return np.random.default_rng(1).integers(1, 512, PACK_N).astype(np.int32)


def _rank_cases(meshes):
    from repro_torch.data.pipeline import pack_by_length
    from repro_torch.serve.scheduler import Request, Scheduler

    out = {}
    for name, (mesh, axes) in meshes.items():
        for n in SCHED_CASES:
            s = Scheduler(batch_size=8, device="cpu")
            for uid, m in enumerate(_sched_lengths(n)):
                s.submit(Request(uid=uid, prompt_len=10, max_new=m))
            out[("sched", name, n)] = [[r.uid for r in s.next_batch(mesh=mesh, axes=axes)]
                                       for _ in range(3)]
        row_id, offset, rows = pack_by_length(_pack_lengths(), PACK_SEQ, mesh=mesh, axes=axes)
        out[("pack", name)] = (row_id, offset, rows)
    return out


def _rank_main(rank, world, rdv, tmp, q):
    try:
        import torch

        torch.set_num_threads(1)
        os.environ["REPRO_TORCH_OPS_PLAN_CACHE"] = os.path.join(tmp, f"plans{rank}.json")
        import torch.distributed as tdist
        from torch.distributed.device_mesh import init_device_mesh

        tdist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                                 world_size=world)
        meshes = {"4": (init_device_mesh("cpu", (4,), mesh_dim_names=("data",)), "data"),
                  "2x2": (init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data")),
                          ("pod", "data"))}
        q.put((rank, _rank_cases(meshes)))
        tdist.destroy_process_group()
    except BaseException:
        q.put((rank, {"__error__": traceback.format_exc()}))


@pytest.fixture(scope="module")
def ranks():
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_sched_")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    world = 4
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "rendezvous"), tmp, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = q.get(timeout=300)
            if "__error__" in res:
                raise AssertionError(f"rank {rank} failed:\n{res['__error__']}")
            got[rank] = res
    except queue_mod.Empty:
        raise AssertionError("the ranks gave no result within 300 s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return got


@pytest.mark.parametrize("mesh_name", ["4", "2x2"])
@pytest.mark.parametrize("n", SCHED_CASES)
def test_next_batch_on_a_mesh_equals_single_device(ranks, mesh_name, n):
    from repro_torch.serve.scheduler import Request, Scheduler

    s = Scheduler(batch_size=8, **CPU)
    for uid, m in enumerate(_sched_lengths(n)):
        s.submit(Request(uid=uid, prompt_len=10, max_new=m))
    want = [[r.uid for r in s.next_batch()] for _ in range(3)]
    for rank in range(4):
        assert ranks[rank][("sched", mesh_name, n)] == want


@pytest.mark.parametrize("mesh_name", ["4", "2x2"])
def test_pack_by_length_on_a_mesh_equals_single_device(ranks, mesh_name):
    from repro_torch.data.pipeline import pack_by_length

    lengths = _pack_lengths()
    rows = pack_by_length(lengths, PACK_SEQ, **CPU)[2]
    got_row, got_off, got_rows = ranks[0][("pack", mesh_name)]
    assert got_rows == rows
    for rank in range(1, 4):  # every rank packs alike
        other = ranks[rank][("pack", mesh_name)]
        assert other[2] == got_rows
        np.testing.assert_array_equal(other[0], got_row)
        np.testing.assert_array_equal(other[1], got_off)
    assert got_row.min() >= 0 and got_row.max() < got_rows
    for r in range(got_rows):  # each row's documents lie apart, within seq_len
        docs = np.flatnonzero(got_row == r)
        docs = docs[np.argsort(got_off[docs])]
        ends = got_off[docs] + np.minimum(lengths[docs], PACK_SEQ)
        assert got_off[docs][0] == 0 and ends[-1] <= PACK_SEQ
        assert (got_off[docs][1:] >= ends[:-1]).all()
