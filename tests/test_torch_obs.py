"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``), on the CPU.  Counts and structure only: no
test here times anything (a wall-clock budget fails by worker load).

  * **disabled**: the null span is one shared object and the recorder stays
    empty; ``ops.sort(device="cpu")`` at two shapes issues the same aten op
    sequence (recorded by a ``TorchDispatchMode``) as with every hook
    replaced by a no-op; no ``jit_*`` hook touches its tensors;
  * **enabled**: the span names, nesting and attributes of ``ops.sort``,
    ``ops.batched_sort`` and ``stream.external_sort`` equal the reference's
    eager spans on the same call (the reference runs its Pallas engine in
    interpret mode; attributes naming an engine are dropped);
    ``sort.bucket_imbalance``, ``sort.largest_bucket``,
    ``sort.fallback_engaged`` and ``sort.base_case`` equal the reference's
    on the same input with the same splitters (the radix classifier, which
    samples nothing, and the tree fed the reference's splitters); the
    plan-cache, router and stream counters equal the reference's for the
    same calls, with ``_bench`` stubbed in both; ``timed_min`` records
    while disabled;
  * **exporters**: a ``Recorder`` on each side filled with the same
    synthetic spans, events and metrics gives the same ``export_jsonl``,
    ``export_chrome_trace`` and ``summary`` text.

Tolerance: exact equality throughout.
"""
import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import obs as ref_obs
from repro import ops as ref_ops
from repro.core import ips4o as ref_ips4o
from repro.core import sampling as ref_sampling
from repro_torch import obs, ops
from repro_torch.core import ips4o
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")
SMALL = dict(base_case=1024, kmax=16, tile=512, max_sample=1024)


@pytest.fixture(autouse=True)
def _obs_clean(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_OPS_PLAN_CACHE", str(tmp_path / "port_plans.json"))
    monkeypatch.setenv("REPRO_OPS_PLAN_CACHE", str(tmp_path / "ref_plans.json"))
    for o in (obs, ref_obs):
        o.enabled(False)
        o.reset()
    yield
    for o in (obs, ref_obs):
        o.enabled(False)
        o.reset()


def _port_cfg(**kw):
    return ips4o.SortConfig(**{**SMALL, **kw})


def _ref_cfg(**kw):
    return ref_ips4o.SortConfig(**{**SMALL, **kw})


def _keys(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# -- disabled ---------------------------------------------------------------


def test_disabled_null_span_is_shared_and_recorder_untouched():
    s1 = obs.trace("a")
    s2 = obs.trace("b", attr=1)
    assert s1 is s2
    with obs.trace("c") as s:
        assert s.set(x=1) is s
    obs.count("c")
    obs.observe("h", 1.0)
    obs.gauge("g", 2.0)
    rec = obs.recorder()
    assert rec.spans == [] and rec.counters == {} and rec.hists == {} and rec.gauges == {}
    assert rec.device_events == {}


class _AtenOps(TorchDispatchMode):
    """Records every aten op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _noop_hooks(monkeypatch):
    """Every hook of ``repro_torch.obs`` replaced by a no-op."""
    monkeypatch.setattr(obs, "trace", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(obs, "block", lambda x: x)
    monkeypatch.setattr(obs, "enabled", lambda *a: False)
    for name in ("count", "gauge", "observe", "jit_count", "jit_observe", "jit_event"):
        monkeypatch.setattr(obs, name, lambda *a, **k: None)


@pytest.mark.parametrize("n", [2048, 20000])  # one level / two levels
def test_disabled_sort_issues_the_ops_of_noop_hooks(n, monkeypatch):
    x = torch.as_tensor(_keys(n, seed=n))
    cfg = _port_cfg()
    with _AtenOps() as rec_obs:
        got = ops.sort(x, cfg=cfg, **CPU)
        order = ops.argsort(x, cfg=cfg, **CPU)
    with monkeypatch.context() as mp:
        _noop_hooks(mp)
        with _AtenOps() as rec_noop:
            want = ops.sort(x, cfg=cfg, **CPU)
            want_order = ops.argsort(x, cfg=cfg, **CPU)
    assert len(rec_obs.ops) > 100
    assert rec_obs.ops == rec_noop.ops
    assert torch.equal(got, want) and torch.equal(order, want_order)
    assert obs.recorder().spans == []


class _Untouchable:
    """Raises on any use: a hook that reads it fails."""

    def __getattr__(self, name):
        raise AssertionError(f"a disabled hook read .{name}")

    def __bool__(self):
        raise AssertionError("a disabled hook read a value")

    def __iter__(self):
        raise AssertionError("a disabled hook iterated a value")


def test_disabled_jit_hooks_read_no_tensor():
    u = _Untouchable()
    obs.jit_count("c", u)
    obs.jit_observe("h", u, gate=u)
    obs.jit_event("e", {"a": u}, gate=u, warn="never")
    t = torch.arange(8)
    with _AtenOps() as rec:
        obs.jit_count("c", t)
        obs.jit_observe("h", t, gate=t > 0)
        obs.jit_event("e", {"a": t})
    assert rec.ops == ["aten.gt.Scalar"]  # the caller's own comparison only
    assert obs.recorder().events == [] and obs.recorder().hists == {}


def test_enabled_jit_hooks_read_once_and_honour_the_gate():
    obs.enabled(True)
    t = torch.tensor([3, 4], dtype=torch.int32)
    obs.jit_count("c", t, k="v")
    obs.jit_observe("h", t, gate=torch.tensor(False))
    obs.jit_observe("h", t.to(torch.float32), gate=torch.tensor(True))
    obs.jit_event("e", {"m": torch.tensor([7]), "fill": torch.tensor([0.5, 1.5])},
                  gate=True, level="1")
    assert obs.counter_value("c", k="v") == 7.0
    assert obs.hist_values("h") == [3.0, 4.0]
    (ev,) = obs.events("e")
    assert ev["attrs"] == {"level": "1", "m": 7, "fill": [0.5, 1.5]}
    assert isinstance(ev["attrs"]["m"], int)


# -- enabled: spans ---------------------------------------------------------


def _span_tree(rec):
    """(name, parent name, depth, attributes other than an engine's) per
    span, in the order the spans closed."""
    by_id = {s["id"]: s for s in rec.spans}
    return [(s["name"], by_id[s["parent"]]["name"] if s["parent"] is not None else None,
             s["depth"], {k: v for k, v in s["attrs"].items() if k != "engine"})
            for s in rec.spans]


def _subtree(rec, root_name):
    """The spans under (and including) the first span named ``root_name``."""
    by_id = {s["id"]: s for s in rec.spans}
    root = next(s["id"] for s in rec.spans if s["name"] == root_name)

    def under(s):
        while s is not None:
            if s["id"] == root:
                return True
            s = by_id.get(s["parent"])
        return False

    return [(s["name"], s["depth"], {k: v for k, v in s["attrs"].items() if k != "engine"})
            for s in rec.spans if under(s)]


@pytest.mark.parametrize("n", [2048, 16384])  # one level / two levels
@pytest.mark.parametrize("classifier", ["tree", "radix"])
def test_sort_spans_equal_the_reference(n, classifier):
    x = _keys(n, seed=1)
    obs.enabled(True)
    ref_obs.enabled(True)
    ops.sort(torch.as_tensor(x), cfg=_port_cfg(classifier=classifier), **CPU)
    ref_ops.sort(jnp.asarray(x), cfg=_ref_cfg(classifier=classifier, engine="pallas"))
    jax.effects_barrier()
    got, want = _span_tree(obs.recorder()), _span_tree(ref_obs.recorder())
    assert [s[0] for s in got].count("level_pass") == (1 if n == 2048 else 2)
    assert got == want


def test_batched_sort_spans_equal_the_reference():
    x = _keys(4 * 4096, seed=2).reshape(4, 4096)
    obs.enabled(True)
    ref_obs.enabled(True)
    ops.batched_sort(torch.as_tensor(x), cfg=_port_cfg(), **CPU)
    ref_ops.batched_sort(jnp.asarray(x), cfg=_ref_cfg(engine="pallas"))
    jax.effects_barrier()
    got, want = _span_tree(obs.recorder()), _span_tree(ref_obs.recorder())
    assert {"ips4o_sort_batched", "level_pass", "base_case"} <= {s[0] for s in got}
    assert got == want


def test_external_sort_spans_and_counters_equal_the_reference(tmp_path):
    """The tournament's spans (the reference forms its runs with a jitted
    sorter, traced once, the port with one eager sort a chunk, so the
    spans under ``stream.external_sort`` are compared) and the stream
    counters."""
    from repro.stream import external_sort as ref_external_sort
    from repro_torch.stream import external_sort

    data = np.random.default_rng(1).integers(0, 1 << 20, 4096).astype(np.int32)
    obs.enabled(True)
    ref_obs.enabled(True)
    out = external_sort(data, chunk_size=1024, **CPU)
    want = np.asarray(ref_external_sort(data, chunk_size=1024))
    np.testing.assert_array_equal(out, want)
    assert _subtree(obs.recorder(), "stream.external_sort") == _subtree(
        ref_obs.recorder(), "stream.external_sort")
    for name in ("stream.tournament_rounds", "stream.spill_bytes"):
        assert obs.counter_value(name) == ref_obs.counter_value(name) > 0


# -- enabled: the sort's stats ----------------------------------------------


def _stats(o):
    return {(name, lv): o.hist_values(name, level=lv) for name in
            ("sort.bucket_imbalance", "sort.largest_bucket") for lv in ("1", "2")} | {
        name: o.counter_value(name) for name in ("sort.fallback_engaged", "sort.base_case")}


@pytest.mark.parametrize("n", [2048, 16384])
@pytest.mark.parametrize("dist", ["Uniform", "Exponential"])
def test_radix_sort_stats_equal_the_reference(n, dist):
    from repro.data.distributions import make_input

    x = make_input(dist, n, np.float32, seed=3)
    obs.enabled(True)
    ref_obs.enabled(True)
    ops.sort(torch.as_tensor(x), cfg=_port_cfg(classifier="radix"), **CPU)
    ref_ops.sort(jnp.asarray(x), cfg=_ref_cfg(classifier="radix"))
    jax.effects_barrier()
    got, want = _stats(obs), _stats(ref_obs)
    assert got["sort.fallback_engaged"] + got["sort.base_case"] == 1
    assert got == want


def _reference_splitters(u_pad, n_real, ref_cfg, levels):
    """The splitters the reference's partition passes draw, replicated from
    its jax.random draws (as ``tests/test_torch_level.py`` does)."""
    arrays = {"k": jnp.asarray(u_pad)}
    r1, r2 = jax.random.split(jax.random.PRNGKey(ref_cfg.seed))
    k1 = levels[0]
    m1 = min(max(ref_sampling.oversampling_factor(n_real) * k1, k1), ref_cfg.max_sample, n_real)
    pos = jax.random.randint(r1, (m1,), 0, n_real)
    spl = [ref_sampling.select_splitters(jnp.sort(jnp.take(arrays["k"], pos)), k1)]
    if len(levels) == 2:
        a1, off1, nb1, _ = ref_ips4o.level_pass(arrays, n_real, k1, ref_cfg, r1)
        k2 = levels[1]
        m = min(max(ref_sampling.oversampling_factor(n_real) * k2, k2), 2048)
        spos = jax.vmap(lambda r, lo, hi: ref_sampling.sample_indices(r, m, lo, hi))(
            jax.random.split(r2, nb1), off1[:-1], off1[1:])
        svals = jnp.sort(jnp.take(a1["k"], spos.reshape(-1), axis=0).reshape(nb1, m), -1)
        spl.append(ref_sampling.select_splitters(svals, k2))
    return [np.asarray(s) for s in spl]


@pytest.mark.parametrize("n", [2048, 16384])
@pytest.mark.parametrize("dist", ["Uniform", "RootDup"])
def test_tree_sort_stats_equal_the_reference_on_its_splitters(n, dist):
    from repro.data.distributions import make_input

    x = make_input(dist, n, np.float32, seed=4)
    ref_cfg = _ref_cfg()
    cfg = ips4o.config_from_reference(dataclasses.asdict(ref_cfg))
    u = np.asarray(ref_ops.keyspace.encode(jnp.asarray(x)))
    n_pad = -(-n // 1024) * 1024
    u_pad = np.concatenate([u, np.full(n_pad - n, np.iinfo(np.uint32).max, np.uint32)])
    levels = ips4o.plan_levels(n_pad, cfg)
    spl = _reference_splitters(u_pad, n, ref_cfg, levels)

    def to_port(a):  # the reference's unsigned codes as the port's signed ones
        return torch.as_tensor((a ^ np.uint32(1 << 31)).view(np.int32))

    obs.enabled(True)
    ref_obs.enabled(True)
    arrays = ips4o.pad_with_sentinel({"k": ops.keyspace.encode(torch.as_tensor(x))}, 1024)
    arrays, off, nb, pad_bucket = ips4o.partition_passes(
        arrays, n, cfg, levels, splitters=[to_port(s) for s in spl])
    ips4o.base_case_with_fallback(arrays, off, nb, pad_bucket, cfg)
    ref_ops.sort(jnp.asarray(x), cfg=ref_cfg)
    jax.effects_barrier()
    assert _stats(obs) == _stats(ref_obs)


# -- enabled: counters at their call sites ------------------------------------


def _counters(o, prefixes=("plan_cache.", "classifier.", "stream.")):
    return [(m["name"], m["labels"], m["value"]) for m in o.metrics_snapshot()["counters"]
            if m["name"].startswith(prefixes)]


def test_plan_router_and_stream_counters_equal_the_reference(tmp_path, monkeypatch):
    from repro.classify import router as ref_router
    from repro.ops import plan as ref_plan
    from repro.stream import external_sort as ref_external_sort
    from repro_torch.classify import router
    from repro_torch.ops import plan
    from repro_torch.stream import external_sort

    monkeypatch.setattr(plan, "_bench", lambda f, x, iters=3: 1.0)
    monkeypatch.setattr(ref_plan, "_bench", lambda f, x, iters=3: 1.0)
    pc = plan.PlanCache(str(tmp_path / "port.json"))
    ref = ref_plan.PlanCache(str(tmp_path / "ref.json"))
    x = _keys(4096, seed=5)
    data = np.random.default_rng(6).integers(0, 1 << 20, 4096).astype(np.int32)
    obs.enabled(True)
    ref_obs.enabled(True)
    for _ in range(2):
        pc.get_sorter(4096, torch.float32, **CPU)
        ref.get_sorter(4096, jnp.float32)
    pc.config_for("sort", 8192, torch.float32, tune=True, **CPU)
    ref.config_for("sort", 8192, jnp.float32, tune=True)
    assert pc.classifier_plan(4096, torch.float32, dist="skew", tune=True, **CPU) == \
        ref.classifier_plan(4096, jnp.float32, dist="skew", tune=True)
    pc.stream_plan(1024, 4, torch.int32, tune=True, **CPU)
    ref.stream_plan(1024, 4, jnp.int32, tune=True)
    pc.dist_plan(1024, 4, torch.float32)
    ref.dist_plan(1024, 4, jnp.float32)
    router.classifier_for(torch.as_tensor(x), cache=pc, tune=True)
    ref_router.classifier_for(jnp.asarray(x), cache=ref, tune=True)
    router.resolve_classifier("auto", 4096, torch.float32)
    ref_router.resolve_classifier("auto", 4096, jnp.float32)
    external_sort(data, chunk_size=1024, cache=pc, **CPU)
    ref_external_sort(data, chunk_size=1024, cache=ref)
    got, want = _counters(obs), _counters(ref_obs)
    assert {c[0] for c in got} >= {"plan_cache.hit", "plan_cache.miss",
                                   "plan_cache.autotune_sweep", "classifier.race_winner",
                                   "classifier.route", "stream.tournament_rounds"}
    assert got == want


def test_timed_min_records_even_while_disabled():
    rec = obs.Recorder()
    calls = []
    t = obs.timed_min("phase:x", lambda: calls.append(1), iters=3, warmup=1, recorder=rec, n=8)
    assert t >= 0.0
    spans = [s for s in rec.spans if s["name"] == "phase:x"]
    assert len(spans) == 3 and len(calls) == 4
    assert {s["attrs"]["iter"] for s in spans} == {0, 1, 2}
    assert obs.recorder().spans == []


def test_enabled_block_and_span_stats_on_the_cpu():
    obs.enabled(True)
    with obs.trace("outer", a=1):
        with obs.trace("inner"):
            y = obs.block(torch.arange(4))
    assert y.tolist() == [0, 1, 2, 3]
    stats = obs.span_stats()
    assert stats["outer"]["count"] == 1 and stats["inner"]["count"] == 1
    assert "device_ms" not in stats["outer"]  # no CUDA event on the CPU
    inner = next(s for s in obs.recorder().spans if s["name"] == "inner")
    outer = next(s for s in obs.recorder().spans if s["name"] == "outer")
    assert inner["parent"] == outer["id"] and inner["depth"] == 1


# -- exporters ----------------------------------------------------------------


def _fill(o, rec):
    """The same synthetic content on either side's recorder."""
    spans = [
        {"id": 0, "parent": None, "name": "ops.sort", "t0_ns": 1000, "dur_ns": 9_000_000,
         "depth": 0, "tid": 111, "attrs": {"n": 4096, "dtype": "float32"}},
        {"id": 1, "parent": 0, "name": "level_pass", "t0_ns": 2500, "dur_ns": 3_250_500,
         "depth": 1, "tid": 111, "attrs": {"level": 1, "k": 16}},
        {"id": 2, "parent": 1, "name": "classify", "t0_ns": 3000, "dur_ns": 1_234_567,
         "depth": 2, "tid": 222, "attrs": {"fused": True}},
        {"id": 3, "parent": 0, "name": "level_pass", "t0_ns": 5_000_000, "dur_ns": 17,
         "depth": 1, "tid": 111, "attrs": {"level": 2, "k": 8, "segmented": True}},
    ]
    for s in spans:
        rec.add_span(dict(s))
    rec.events.append({"name": "dist.exchange_overflow", "t_ns": 7_500_000,
                       "attrs": {"level": "0", "groups": 4, "capacity": 512,
                                 "round_fill": [1.25, 1.5], "rounds_used": 2}})
    rec.add_count("plan_cache.hit", 2.0, (("family", "sort"), ("op", "sort")))
    rec.add_count("plan_cache.miss", 1.0, (("family", "dist"),))
    rec.add_count("stream.tournament_rounds", 3.0, ())
    rec.set_gauge("queue.depth", 5.5, (("pool", "a"),))
    for v in (1.0, 2.5, 10.0):
        rec.add_observation("sort.bucket_imbalance", v, (("level", "1"),))
    rec.add_observation("dist.resplit_rounds", 2.0, (("axis", "data"), ("level", "0")))


def test_exporters_give_the_reference_text(tmp_path):
    port_rec, ref_rec = obs.Recorder(), ref_obs.Recorder()
    _fill(obs, port_rec)
    _fill(ref_obs, ref_rec)
    for name in ("export_jsonl", "export_chrome_trace"):
        getattr(obs, name)(str(tmp_path / "port"), port_rec)
        getattr(ref_obs, name)(str(tmp_path / "ref"), ref_rec)
        got, want = (tmp_path / "port").read_text(), (tmp_path / "ref").read_text()
        assert got == want, name
        if name == "export_jsonl":
            assert [json.loads(line)["type"] for line in got.splitlines()].count("span") == 4
        else:
            assert json.loads(got)["displayTimeUnit"] == "ms"
    assert obs.summary(port_rec) == ref_obs.summary(ref_rec)
    assert obs.span_stats(port_rec) == ref_obs.span_stats(ref_rec)
    assert obs.summary(obs.Recorder()) == ref_obs.summary(ref_obs.Recorder())
