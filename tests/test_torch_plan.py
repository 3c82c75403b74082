"""The port's plan cache and router against the reference's, on the CPU.

  * decisions: with ``_build`` and ``_bench`` stubbed in both packages to
    the same fake times (a function of the candidate's config, classifier
    or merge tile; the reference's "pallas" points are made slow, as the
    port has no engine), ``config_for(tune=True)`` (1-D and batched),
    ``classifier_plan`` races, ``classifier_hint`` consensus and
    ``stream_plan(tune=True)`` choose the same, under the same keys;
  * persistence: a JSON round trip, and entries of other schemas (pre-batch
    fields, pre-classifier configs, the reference's ``engine`` and
    ``classify_rows``, a ``stream:`` entry with an engine) load with the
    foreign fields dropped;
  * the default path is the port's own (``REPRO_TORCH_OPS_PLAN_CACHE``),
    never the reference's, and is read at the first lookup;
  * ``distribution_moments`` labels equal the reference's on the same arrays;
  * ``resolve_classifier("auto")``, ``classifier_for`` and the sorters of
    ``get_sorter`` work end to end on the CPU.

Every cache here lives under ``tmp_path``; ``REPRO_TORCH_OPS_PLAN_CACHE``
points there, so nothing is written to the home directory.  Tolerance:
zero, decisions and sorted keys compared exactly.
"""
import doctest
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.classify import router as ref_router
from repro.ops import plan as ref_plan
from repro_torch import ops
from repro_torch.classify import router
from repro_torch.ops import plan
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _plan_path(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_OPS_PLAN_CACHE", str(tmp_path / "default_plans.json"))
    monkeypatch.setattr(plan, "default_cache", plan.PlanCache())


def _fake_time(cfg) -> float:
    """A made-up time for one candidate: the best is W = 4096, tile 2048,
    slack 8; the learned classifier beats the tree, radix loses, and the
    reference's pallas points lose to all."""
    t = abs(math.log2(cfg.base_case) - 12) + 0.1 * abs(math.log2(cfg.tile) - 11)
    t += 0.01 * (cfg.slack == 4) + {"tree": 0.0, "radix": 0.5, "learned": -0.05}[cfg.classifier]
    return t + 10.0 * (getattr(cfg, "engine", "xla") == "pallas")


def _stub(monkeypatch, mod):
    """``mod._build`` returns its config and ``mod._bench`` prices it; a
    merge (a lambda whose defaults end with the tile, after the engine in
    the reference) is priced by its tile."""
    monkeypatch.setattr(mod, "_build", lambda op, cfg, k, batch=None, device=None: cfg)

    def bench(f, x, iters=3):
        if hasattr(f, "base_case"):
            return _fake_time(f)
        defaults = getattr(f, "__wrapped__", f).__defaults__
        engine = defaults[0] if len(defaults) == 2 else "xla"
        return abs(math.log2(defaults[-1]) - 9) + 5.0 * (engine == "pallas")

    monkeypatch.setattr(mod, "_bench", bench)


def test_decisions_match_the_reference(tmp_path, monkeypatch):
    _stub(monkeypatch, plan)
    _stub(monkeypatch, ref_plan)
    pc = plan.PlanCache(str(tmp_path / "port.json"))
    ref = ref_plan.PlanCache(str(tmp_path / "ref.json"))
    for n, batch in ((4096, None), (1 << 20, None), (4096, 4)):
        got = pc.config_for("sort", n, torch.float32, tune=True, batch=batch, **CPU)
        want = ref.config_for("sort", n, jnp.float32, tune=True, batch=batch)
        assert (got.base_case, got.tile, got.slack, got.classifier) == (
            want.base_case, want.tile, want.slack, want.classifier) == (4096, 2048, 8, "tree")
    for dist in ("uniform", "dup"):
        assert pc.classifier_plan(4096, torch.float32, dist=dist, tune=True, **CPU) == \
            ref.classifier_plan(4096, jnp.float32, dist=dist, tune=True) == "learned"
    assert pc.classifier_hint(4096, torch.float32) == ref.classifier_hint(4096, jnp.float32)
    got = pc.stream_plan(1024, 4, torch.float32, tune=True, **CPU)
    want = ref.stream_plan(1024, 4, jnp.float32, tune=True)
    assert got.merge_tile == want.merge_tile == 512
    assert set(pc._plans) == set(ref._plans)
    # a conflicting label kills the consensus in both: the tuned same-shape
    # sort plan's classifier answers, and with no such plan nothing does
    for cache in (pc, ref):
        cache._plans[cache._clf_key(4096, "float32", "sorted")] = {"winner": "radix"}
    assert pc.classifier_hint(4096, torch.float32) == \
        ref.classifier_hint(4096, jnp.float32) == "tree"
    for cache in (pc, ref):
        del cache._plans[cache._key("sort", 4096, "float32", None)]
    assert pc.classifier_hint(4096, torch.float32) is None
    assert ref.classifier_hint(4096, jnp.float32) is None
    assert pc.classifier_hint(4096, torch.float32, dist="dup") == \
        ref.classifier_hint(4096, jnp.float32, dist="dup") == "learned"


def test_json_round_trip(tmp_path, monkeypatch):
    _stub(monkeypatch, plan)
    path = tmp_path / "plans.json"
    pc = plan.PlanCache(str(path))
    cfg = pc.config_for("argsort", 4096, torch.int32, tune=True, **CPU)
    clf = pc.classifier_plan(4096, torch.int32, dist="skew", tune=True, **CPU)
    tile = pc.stream_plan(2048, 8, torch.int32, tune=True, **CPU).merge_tile
    again = plan.PlanCache(str(path))
    assert again.config_for("argsort", 4096, torch.int32) == cfg
    assert again.classifier_plan(4096, torch.int32, dist="skew") == clf
    assert again.stream_plan(2048, 8, torch.int32).merge_tile == tile
    saved = json.loads(path.read_text())
    assert all("engine" not in e and "engine" not in e.get("config", {})
               for e in saved.values())


def test_foreign_schemas_load(tmp_path):
    """Entries of older or foreign schemas: the known fields load, the rest
    are dropped and the entry is migrated at the next save."""
    path = tmp_path / "plans.json"
    path.write_text(json.dumps({
        # the reference's schema: engine and classify_rows in the config
        "sort:n=4096:dtype=float32": {"config": {"base_case": 1024, "kmax": 32, "tile": 256,
                                                 "engine": "pallas", "classify_rows": 8,
                                                 "classifier": "radix"},
                                      "engine": "pallas", "us": 2.0},
        # pre-classifier and pre-batch: a batch field, no classifier
        "sort:B=4:n=512:dtype=int32": {"config": {"base_case": 256, "slack": 4, "batch": 4}},
        # nothing known, or not a dict: defaults
        "sort:n=8:dtype=int32": {"config": {"bogus": 1}},
        "sort:n=16:dtype=int32": [1, 2],
        "stream:chunk=1024:fanin=4:dtype=float32": {"config": {"merge_tile": 256,
                                                               "engine": "pallas"}},
        "stream:chunk=64:fanin=2:dtype=float32": {"config": {"merge_tile": 3}},
    }))
    pc = plan.PlanCache(str(path))
    cfg = pc.config_for("sort", 4096, torch.float32)
    assert (cfg.base_case, cfg.kmax, cfg.tile, cfg.classifier) == (1024, 32, 256, "radix")
    assert pc._plans["sort:n=4096:dtype=float32"]["config"] == {
        "base_case": 1024, "kmax": 32, "tile": 256, "classifier": "radix"}
    old = pc.config_for("sort", 512, torch.int32, batch=4)
    assert (old.base_case, old.slack, old.classifier) == (256, 4, "tree")
    assert pc.config_for("sort", 8, torch.int32) == ops.SortConfig()
    assert pc.config_for("sort", 16, torch.int32) == ops.SortConfig()
    assert pc.stream_plan(1024, 4, torch.float32).merge_tile == 256
    assert pc.stream_plan(64, 2, torch.float32).merge_tile == plan.TILE  # not a K5 tile
    # the reference's own file format reads the same
    ref = ref_plan.PlanCache(str(path))
    assert ref.config_for("sort", 4096, jnp.float32).base_case == cfg.base_case


def test_default_path_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_OPS_PLAN_CACHE")
    monkeypatch.delenv("REPRO_OPS_PLAN_CACHE", raising=False)
    assert plan._default_path() != ref_plan._default_path()
    assert plan._default_path().endswith("repro_torch_ops_plans.json")
    monkeypatch.setenv("REPRO_OPS_PLAN_CACHE", str(tmp_path / "ref.json"))
    assert plan._default_path() != str(tmp_path / "ref.json")
    monkeypatch.setenv("REPRO_TORCH_OPS_PLAN_CACHE", str(tmp_path / "mine.json"))
    pc = plan.PlanCache()  # nothing read or written yet
    assert not (tmp_path / "mine.json").exists()
    assert pc.path == str(tmp_path / "mine.json")


def test_distribution_moments_match_the_reference():
    rng = np.random.default_rng(9)
    arrays = [rng.integers(0, 2**31, 8192), rng.integers(0, 5, 8192),
              np.sort(rng.standard_normal(8192)), rng.exponential(1.0, 8192),
              np.asarray([], np.int32), rng.standard_normal(100).astype(np.float32),
              rng.integers(-2**31, 2**31, 9000).astype(np.int32)]
    for x in arrays:
        want = ref_router.distribution_moments(x)
        assert router.distribution_moments(x) == want
        assert router.distribution_moments(torch.from_numpy(x)) == want
    assert router.distribution_moments(torch.from_numpy(arrays[3]).to(torch.bfloat16)) == \
        ref_router.distribution_moments(jnp.asarray(arrays[3], jnp.bfloat16))


def test_auto_routes_through_the_default_cache(tmp_path):
    assert router.resolve_classifier("auto", 4096, torch.float32) == "tree"  # nothing raced
    pc = plan.default_cache
    pc._plans[pc._clf_key(4096, torch.float32, "uniform")] = {"winner": "radix"}
    assert router.resolve_classifier("auto", 4096, torch.float32) == "radix"
    assert router.resolve_classifier("auto", 4097, torch.float32) == "tree"
    assert ops.with_engine(ops.SortConfig(), None, torch.zeros(4096), "auto").classifier == \
        "radix"
    pc._plans[pc._clf_key(64, torch.float32, "dup", batch=3)] = {"winner": "learned"}
    assert ops.with_engine_batched(ops.SortConfig(), None, torch.zeros(3, 64),
                                   "auto").classifier == "learned"
    x = torch.rand(4096)
    assert torch.equal(ops.sort(x, classifier="auto", **CPU), torch.sort(x).values)


def test_classifier_for_races_on_the_input(tmp_path):
    pc = plan.PlanCache(str(tmp_path / "p.json"))
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 2**31, 4096, dtype=np.int32))
    clf = router.classifier_for(x, cache=pc, tune=True)
    assert clf in router.CLASSIFIERS
    assert pc.classifier_plan(4096, torch.int32, dist="uniform") == clf
    entry = pc._plans[pc._clf_key(4096, torch.int32, "uniform")]
    assert set(entry["us_per_classifier"]) == set(router.CLASSIFIERS)
    assert router.classifier_for(x, cache=pc, tune=False) == clf


def test_sorters_and_make_sorter(tmp_path):
    pc = plan.PlanCache(str(tmp_path / "p.json"))
    x = torch.randn(5000)
    assert torch.equal(pc.get_sorter(5000, torch.float32, **CPU)(x), torch.sort(x).values)
    assert pc.get_sorter(5000, torch.float32, **CPU) is pc.get_sorter(5000, torch.float32, **CPU)
    v, i = pc.get_sorter(5000, torch.float32, "topk", k=7, **CPU)(x)
    assert torch.equal(v, torch.topk(x, 7).values)
    xb = torch.randn(3, 700)
    got = pc.get_sorter(700, torch.float32, "argsort", batch=3, **CPU)(xb)
    assert torch.equal(got.to(torch.int64), torch.sort(xb, dim=1, stable=True).indices)
    with pytest.raises(ValueError, match="requires k"):
        pc.get_sorter(10, torch.float32, "topk", **CPU)
    with pytest.raises(ValueError, match="unknown op"):
        pc.get_sorter(10, torch.float32, "median", **CPU)
    from repro_torch.core.ips4o import make_sorter

    keys = torch.randn(3000)
    want = torch.sort(keys).values
    same = keys
    assert make_sorter(3000, torch.float32)(keys) is same and torch.equal(keys, want)
    fresh = torch.randn(3000)
    out = make_sorter(3000, torch.float32, donate=False)(fresh)
    assert out is not fresh and torch.equal(out, torch.sort(fresh).values)
    with pytest.raises(ValueError, match="takes"):
        make_sorter(3000, torch.float32)(torch.randn(10))


def test_plan_doctests():
    for mod in (plan, router):
        result = doctest.testmod(mod, verbose=False)
        assert result.attempted > 0 and result.failed == 0, mod.__name__


def test_stream_takes_the_plan_cache(tmp_path):
    """The stream's entry points with ``cache=`` and ``tune=True``: each
    chunk's sorter and the merge tile come from the cache, which persists
    the ``sort:``/``argsort:``/``topk:`` and ``stream:`` entries; the
    results equal numpy's stable sort."""
    from repro_torch import stream

    pc = plan.PlanCache(str(tmp_path / "p.json"))
    x = np.random.default_rng(2).integers(-50, 50, 5000).astype(np.int32)
    np.testing.assert_array_equal(
        stream.external_sort(x, chunk_size=1024, cache=pc, tune=True, **CPU), np.sort(x))
    np.testing.assert_array_equal(
        stream.external_argsort(x, chunk_size=1024, cache=pc, tune=True, **CPU),
        np.argsort(x, kind="stable"))
    v, i = stream.streaming_topk(x, 10, chunk_size=1024, cache=pc, tune=True, **CPU)
    np.testing.assert_array_equal(i, np.argsort(-x.astype(np.int64), kind="stable")[:10])
    vals, counts = stream.streaming_group_by(x, chunk_size=1024, cache=pc, tune=True, **CPU)
    want_v, want_c = np.unique(x, return_counts=True)
    np.testing.assert_array_equal(vals, want_v)
    np.testing.assert_array_equal(counts, want_c)
    saved = set(json.loads(open(pc.path).read()))
    assert {"sort:n=1024:dtype=int32", "sort:n=904:dtype=int32", "argsort:n=1024:dtype=int32",
            "topk:n=1024:dtype=int32:k=10", "stream:chunk=1024:fanin=5:dtype=int32"} <= saved
    assert pc.stream_plan(1024, 5, torch.int32).merge_tile in plan._stream_tiles(torch.int32)
