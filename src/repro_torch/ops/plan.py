"""Tuned plan cache: (op, [B,] n, dtype) -> a sorter bound to a tuned config.

Counterpart of ``repro.ops.plan``.  The best base-case window W, tile and
slack depend on the problem size, so ``PlanCache`` owns that decision:

  * ``get_sorter(n, dtype, op)`` returns a plain callable for the op
    ("sort" | "argsort" | "topk" | "bottomk"), bound to a ``SortConfig``
    and a device;
  * the config comes from a persisted plan when one exists, from a small
    autotune sweep when ``tune=True`` (median of 3 timed calls of each
    candidate on a synthetic input, on the card, synchronized around each
    call), and from the defaults otherwise;
  * plans persist as JSON at ``REPRO_TORCH_OPS_PLAN_CACHE``, by default
    ``~/.cache/repro_torch_ops_plans.json``: never the reference's file.
    The file is read at the first lookup, not when the module is imported;
  * ``batch=B`` keys a plan under (op, B, n, dtype) and builds the
    ``ops.batched`` entry point; entries written by other schemas load
    their known fields and drop the rest (the reference's ``engine`` and
    ``classify_rows``, a pre-batch ``batch``), migrated at the next save;
  * the ``clf:`` key family records which of tree / radix / learned won a
    race of full sorts (``classifier_plan``); ``classifier_hint`` feeds the
    winner to ``SortConfig(classifier="auto")``, by exact label or by
    consensus across labels;
  * the ``stream:`` key family records the merge tile of an external sort
    at (chunk, fan-in, dtype) (``stream_plan``), swept over K5's tiles on a
    synthetic pairwise merge at the chunk shape;
  * the ``dist:`` key family plans the multi-level distributed sort
    (``dist_plan``): ``dist:n_local=8192:d=8:dtype=float32`` records the
    capacity factor (slack), the per-rank oversampling and, once
    ``dist.sort(order="auto")`` has run, the topology-chosen axis order;
    tuned by the reference's host-side *capacity simulation* (numpy; no
    card needed), which keeps the cheapest candidate whose worst
    simulated per-pair fill leaves headroom.

The port has no engine switch, so no plan carries an engine and the sweep
has no engine points (ROADMAP.md, queue 3); an entry the reference wrote
loads with its ``engine`` dropped.  Every lookup is counted through
``repro_torch.obs`` (off by default): ``plan_cache.hit``/``miss`` by
family (``family="sort" | "clf" | "stream" | "dist"``),
``plan_cache.autotune_sweep`` with a ``plan.autotune`` span,
``plan_cache.compiled_hit``/``miss``, and a ``classifier.race`` span with a
``classifier.race_winner`` counter.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from dataclasses import asdict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.ips4o import SortConfig, plan_levels
from repro_torch.kernels.merge_path import TILE, max_tile
from repro_torch.ops import keyspace

__all__ = ["PlanCache", "StreamPlan", "DistPlan", "get_sorter", "default_cache"]

_OPS = ("sort", "argsort", "topk", "bottomk")
_CFG_FIELDS = frozenset(f.name for f in dataclasses.fields(SortConfig))
# the contestants of a clf: race and the distribution labels raced (the
# vocabulary of ``classify.router.distribution_moments``)
_CLASSIFIER_RACERS = ("tree", "radix", "learned")
_CLF_DISTS = ("uniform", "dup", "sorted", "skew")


def _stream_tiles(dtype: torch.dtype) -> tuple:
    """The merge tiles the stream: sweep times for keys of ``dtype``: K5's
    tiles from the reference's smallest (128) up to K5's largest for the
    keys' codes (int32 codes up to 16384, int64 codes up to 8192).

    >>> _stream_tiles(torch.float64)[-1], _stream_tiles(torch.uint16)[-1]
    (8192, 16384)
    """
    top = max_tile(keyspace.encoded_dtype(dtype).itemsize)
    return tuple(1 << e for e in range(7, top.bit_length()))


def _dtype_name(dtype) -> str:
    """The reference's key spelling of a dtype ("float32", "bfloat16", ...)
    for a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return dtype if isinstance(dtype, str) else np.dtype(dtype).name


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, _dtype_name(dtype))


def _default_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_OPS_PLAN_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch_ops_plans.json"),
    )


def _device(device) -> torch.device:
    from repro_torch.ops.sort import _device as checked  # lazy: plan is imported by ops

    return checked(device)


def _synthetic_draw(dist: str, count: int, dtype: torch.dtype) -> np.ndarray:
    """A numpy draw with the shape of one ``distribution_moments`` label, in
    a numpy dtype safe to cast into ``dtype`` (the reference's draws)."""
    rng = np.random.default_rng(0)
    if dtype.is_floating_point:
        if dist == "uniform":
            return rng.random(count, dtype=np.float32)
        if dist == "dup":
            return rng.choice(np.linspace(0.0, 1.0, 97, dtype=np.float32), count)
        if dist == "sorted":
            return np.sort(rng.random(count, dtype=np.float32))
        if dist == "skew":
            return rng.exponential(size=count).astype(np.float32)
    else:
        info = torch.iinfo(dtype)
        nd = np.dtype(_dtype_name(dtype))
        if dist == "uniform":
            return rng.integers(info.min, info.max, count, endpoint=False, dtype=nd)
        if dist == "dup":
            return rng.integers(0, 97, count, dtype=nd)
        if dist == "sorted":
            return np.sort(rng.integers(info.min, info.max, count, endpoint=False, dtype=nd))
        if dist == "skew":
            hi = min(int(info.max), 1 << 20)
            return np.minimum(rng.exponential(scale=hi / 64, size=count), hi).astype(nd)
    raise ValueError(f"unknown distribution label {dist!r}; expected one of {_CLF_DISTS}")


def _uniform_draw(count: int, dtype: torch.dtype) -> np.ndarray:
    """The autotune's input, as the reference draws it: standard normal for
    floats, uniform over the dtype's range for ints."""
    rng = np.random.default_rng(0)
    if dtype.is_floating_point:
        return rng.standard_normal(count).astype(np.float32)
    info = torch.iinfo(dtype)
    return rng.integers(info.min, info.max, count, endpoint=False,
                        dtype=np.dtype(_dtype_name(dtype)))


def _on_device(x: np.ndarray, shape, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x.reshape(shape), device=dev).to(dtype)


def _candidates(n: int) -> list:
    """A small sweep about the paper's defaults, invalid plans skipped: the
    reference's W / tile / slack grid and its radix point (the learned
    classifier is raced by ``classifier_plan``, where the input's
    distribution is controlled)."""
    out = []
    grid = [SortConfig(base_case=base_case, tile=tile, slack=slack)
            for base_case, tile in [(8192, 4096), (8192, 2048), (4096, 2048), (16384, 4096)]
            for slack in (8, 4)]
    for cfg in grid + [SortConfig(classifier="radix")]:
        try:
            plan_levels(max(n, 1), cfg)
        except ValueError:
            continue
        out.append(cfg)
    return out


def _build(op: str, cfg: SortConfig, k: Optional[int], batch: Optional[int],
           device: torch.device) -> Callable:
    """The op's entry point bound to ``cfg`` and ``device``."""
    from repro_torch.ops.batched import (  # lazy: plan is imported by ops
        batched_argsort,
        batched_bottomk,
        batched_sort,
        batched_topk,
    )
    from repro_torch.ops.sort import argsort, sort
    from repro_torch.ops.topk import bottomk, topk

    if batch is not None:
        fns = {"sort": batched_sort, "argsort": batched_argsort,
               "topk": batched_topk, "bottomk": batched_bottomk}
    else:
        fns = {"sort": sort, "argsort": argsort, "topk": topk, "bottomk": bottomk}
    if op not in fns:
        raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")
    base = fns[op]
    if op in ("topk", "bottomk"):
        return lambda keys: base(keys, k, cfg=cfg, device=device)
    return lambda keys: base(keys, cfg=cfg, device=device)


def _bench(f: Callable, x: torch.Tensor, iters: int = 3) -> float:
    """Median seconds of ``iters`` calls of ``f(x)`` after a warm-up call,
    by the host clock with the card synchronized around each call."""
    def sync():
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    f(x)
    ts = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        f(x)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The merge geometry of one out-of-core family (DESIGN.md §7): the K5
    tile every pairwise merge of an external sort at this chunk size x
    fan-in uses."""

    chunk: int
    fanin: int
    merge_tile: int = TILE


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Tuned knobs for one distributed-sort family (DESIGN.md §8): the
    capacity factor (slack over the balanced per-pair expectation), the
    per-rank oversampling and, once ``dist.sort(order="auto")`` has run,
    the topology-chosen level order (empty: no recorded preference).  The
    reference's ``engine`` has no counterpart."""

    n_local: int
    d: int
    slack: float = 2.0
    oversample: int = 32
    axis_order: Tuple[str, ...] = ()


# capacity factors and oversample multipliers the dist: autotune sweeps,
# ascending, so the first passing candidate is the cheapest (collective
# volume scales linearly with slack); a candidate passes when the simulated
# worst per-pair fill stays under this fraction of capacity
_DIST_SLACKS = (1.5, 2.0, 2.5, 3.0)
_DIST_OVERSAMPLE_MULS = (1, 2, 4)
_DIST_FILL_MARGIN = 0.9


def _valid_tile(tile, dtype) -> bool:
    """Whether K5 takes ``tile`` for the codes of keys of ``dtype``."""
    top = max_tile(keyspace.encoded_dtype(_torch_dtype(dtype)).itemsize)
    return isinstance(tile, int) and 0 < tile <= top and not tile & (tile - 1)


class PlanCache:
    """Process-level cache of tuned sorter plans, JSON-persisted.

    >>> import os, tempfile
    >>> pc = PlanCache(path=os.path.join(tempfile.mkdtemp(), "plans.json"))
    >>> f = pc.get_sorter(4, torch.float32, device="cpu")
    >>> f(torch.tensor([3.0, 1.0, 2.0, 0.0])).tolist()
    [0.0, 1.0, 2.0, 3.0]
    >>> pc.config_for("sort", 4, torch.float32).classifier  # no tuned plan: defaults
    'tree'
    """

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._loaded: Optional[Dict[str, Dict[str, Any]]] = None
        self._compiled: Dict[str, Callable] = {}

    @property
    def path(self) -> str:
        """The JSON file, fixed at the first use (``_default_path`` then)."""
        if self._path is None:
            self._path = _default_path()
        return self._path

    @property
    def _plans(self) -> Dict[str, Dict[str, Any]]:
        """The plans, read from :attr:`path` at the first lookup."""
        if self._loaded is None:
            self._loaded = {}
            if os.path.exists(self.path):
                try:
                    with open(self.path) as fh:
                        loaded = json.load(fh)
                except (OSError, json.JSONDecodeError):
                    loaded = {}
                self._loaded = loaded if isinstance(loaded, dict) else {}
        return self._loaded

    # -- keys ---------------------------------------------------------------
    @staticmethod
    def _key(op: str, n: int, dtype, k: Optional[int], batch: Optional[int] = None) -> str:
        """The reference's plan key: ``sort:n=4096:dtype=float32``, with
        ``B=`` for batched plans and ``:k=`` for top/bottom-k."""
        b = f"B={batch}:" if batch is not None else ""
        key = f"{op}:{b}n={n}:dtype={_dtype_name(dtype)}"
        return key + (f":k={k}" if k is not None else "")

    # -- persistence --------------------------------------------------------
    def _save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # a temporary file of this process's own: the ranks of a distributed
        # sort may save one path at once, and the last atomic replace wins
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self._plans, fh, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    # -- plan selection -----------------------------------------------------
    def _coerce_config(self, key: str) -> Optional[SortConfig]:
        """A persisted plan's config, tolerating foreign schemas: the fields
        ``SortConfig`` knows whose JSON kind matches the default's load,
        the rest (the reference's ``engine`` and ``classify_rows``, a
        pre-batch ``batch``) are dropped and the entry is migrated at the
        next save.  An entry with no such field is foreign: None."""
        entry = self._plans.get(key)
        raw = entry.get("config") if isinstance(entry, dict) else None
        if not isinstance(raw, dict):
            return None
        defaults = SortConfig()
        known = {f: v for f, v in raw.items()
                 if f in _CFG_FIELDS and isinstance(v, type(getattr(defaults, f)))}
        if not known:
            return None
        if known != raw:
            entry["config"] = known
        return SortConfig(**known)

    def config_for(
        self,
        op: str,
        n: int,
        dtype,
        k: Optional[int] = None,
        tune: bool = False,
        batch: Optional[int] = None,
        device=None,
    ) -> SortConfig:
        """The SortConfig a sorter for this key would use; with ``tune=True``
        a missing plan is swept on ``device`` and persisted."""
        key = self._key(op, n, dtype, k, batch)
        if key in self._plans:
            cfg = self._coerce_config(key)
            if cfg is not None:
                obs.count("plan_cache.hit", family="sort", op=op)
                return cfg
        obs.count("plan_cache.miss", family="sort", op=op)
        if tune:
            return self._autotune(op, n, dtype, k, batch, _device(device))
        return SortConfig()

    def _autotune(self, op: str, n: int, dtype, k: Optional[int], batch: Optional[int],
                  dev: torch.device) -> SortConfig:
        key = self._key(op, n, dtype, k, batch)
        tdtype = _torch_dtype(dtype)
        shape = (batch, n) if batch is not None else (n,)
        x = _on_device(_uniform_draw(n if batch is None else batch * n, tdtype), shape,
                       tdtype, dev)
        cands = _candidates(n)
        obs.count("plan_cache.autotune_sweep", family="sort", op=op)
        best_cfg, best_t = SortConfig(), float("inf")
        with obs.trace("plan.autotune", key=key, candidates=len(cands)):
            for cfg in cands:
                t = _bench(_build(op, cfg, k, batch, dev), x)
                if t < best_t:
                    best_cfg, best_t = cfg, t
        self._plans[key] = {
            "config": asdict(best_cfg),
            "us": round(best_t * 1e6, 1),
            "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        self._save()
        return best_cfg

    # -- clf: key family (classifier races) ----------------------------------
    @staticmethod
    def _clf_key(n: int, dtype, dist: str, batch: Optional[int] = None) -> str:
        b = f"B={batch}:" if batch is not None else ""
        return f"clf:{b}n={n}:dtype={_dtype_name(dtype)}:dist={dist}"

    def classifier_plan(
        self,
        n: int,
        dtype,
        *,
        dist: str = "uniform",
        batch: Optional[int] = None,
        tune: bool = False,
        x: Optional[torch.Tensor] = None,
        device=None,
    ) -> Optional[str]:
        """The winning classifier for (n, dtype, ``dist``), or None.  A
        persisted ``clf:`` race wins; ``tune=True`` runs the race (a full
        sort per classifier, timed on ``x``'s device, or on ``device``) on
        ``x`` when given, else on a synthetic draw with the label's shape,
        and persists the winner.

        >>> import os, tempfile
        >>> pc = PlanCache(path=os.path.join(tempfile.mkdtemp(), "p.json"))
        >>> pc.classifier_plan(4096, torch.uint32) is None  # no race yet
        True
        """
        key = self._clf_key(n, dtype, dist, batch)
        entry = self._plans.get(key)
        if isinstance(entry, dict) and entry.get("winner") in _CLASSIFIER_RACERS:
            obs.count("plan_cache.hit", family="clf", dist=dist)
            return entry["winner"]
        obs.count("plan_cache.miss", family="clf", dist=dist)
        if tune:
            dev = x.device if x is not None else _device(device)
            return self._race_classifiers(n, dtype, dist, batch, x, dev)
        return None

    def _race_classifiers(self, n: int, dtype, dist: str, batch: Optional[int],
                          x: Optional[torch.Tensor], dev: torch.device) -> str:
        key = self._clf_key(n, dtype, dist, batch)
        if x is None:
            tdtype = _torch_dtype(dtype)
            shape = (batch, n) if batch is not None else (n,)
            count = n if batch is None else batch * n
            x = _on_device(_synthetic_draw(dist, count, tdtype), shape, tdtype, dev)
        times = {}
        with obs.trace("classifier.race", key=key, dist=dist):
            for clf in _CLASSIFIER_RACERS:
                times[clf] = _bench(_build("sort", SortConfig(classifier=clf), None, batch,
                                           dev), x)
        winner = min(times, key=times.get)
        obs.count("classifier.race_winner", winner=winner, dist=dist)
        self._plans[key] = {
            "winner": winner,
            "us_per_classifier": {c: round(t * 1e6, 1) for c, t in times.items()},
            "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        self._save()
        return winner

    def classifier_hint(self, n: int, dtype, batch: Optional[int] = None,
                        dist: Optional[str] = None) -> Optional[str]:
        """The persisted classifier for this shape, or None: what
        ``SortConfig(classifier="auto")`` resolves through.  With ``dist``
        the exact ``clf:`` race wins; without, a winner only when every
        raced label of this (n, dtype[, B]) agrees, else the classifier a
        tuned same-shape "sort" plan holds."""
        if dist is not None:
            got = self.classifier_plan(n, dtype, dist=dist, batch=batch)
            if got is not None:
                return got
        prefix = self._clf_key(n, dtype, "", batch)[: -len("dist=")]
        winners = {e.get("winner") for key, e in self._plans.items()
                   if key.startswith(prefix) and isinstance(e, dict)} & set(_CLASSIFIER_RACERS)
        if len(winners) == 1:
            return next(iter(winners))
        plan = self._plans.get(self._key("sort", n, dtype, None, batch))
        if isinstance(plan, dict):
            cfg = plan.get("config")
            clf = cfg.get("classifier") if isinstance(cfg, dict) else None
            if clf in _CLASSIFIER_RACERS:
                return clf
        return None

    # -- stream: key family (out-of-core merge geometry) ---------------------
    @staticmethod
    def _stream_key(chunk: int, fanin: int, dtype) -> str:
        return f"stream:chunk={chunk}:fanin={fanin}:dtype={_dtype_name(dtype)}"

    def stream_plan(self, chunk: int, fanin: int, dtype, *, tune: bool = False,
                    device=None) -> StreamPlan:
        """The merge geometry of an external sort at (chunk, fanin, dtype): a
        persisted ``stream:`` plan (an ``engine`` in it, the reference's,
        is dropped), else with ``tune=True`` a sweep of K5's tiles on a
        synthetic pairwise merge of two chunks on ``device``, persisted,
        else K5's default tile.

        >>> import os, tempfile
        >>> pc = PlanCache(path=os.path.join(tempfile.mkdtemp(), "p.json"))
        >>> pc.stream_plan(1024, 4, torch.float32).merge_tile  # no plan: K5's default
        2048
        """
        entry = self._plans.get(self._stream_key(chunk, fanin, dtype))
        cfg = entry.get("config") if isinstance(entry, dict) else None
        if isinstance(cfg, dict) and _valid_tile(cfg.get("merge_tile"), dtype):
            obs.count("plan_cache.hit", family="stream")
            return StreamPlan(chunk, fanin, cfg["merge_tile"])
        obs.count("plan_cache.miss", family="stream")
        if tune:
            return self._autotune_stream(chunk, fanin, dtype, _device(device))
        return StreamPlan(chunk, fanin)

    def _autotune_stream(self, chunk: int, fanin: int, dtype, dev: torch.device
                         ) -> StreamPlan:
        from repro_torch.stream.merge import merge  # lazy: stream layers on ops

        tdtype = _torch_dtype(dtype)
        draw = _uniform_draw(2 * chunk, tdtype)
        a = _on_device(np.sort(draw[:chunk]), (chunk,), tdtype, dev)
        b = _on_device(np.sort(draw[chunk:]), (chunk,), tdtype, dev)
        best, best_t = StreamPlan(chunk, fanin), float("inf")
        for tile in _stream_tiles(tdtype):
            t = _bench(lambda x, tile=tile: merge([x, b], tile=tile), a)
            if t < best_t:
                best, best_t = StreamPlan(chunk, fanin, tile), t
        self._plans[self._stream_key(chunk, fanin, dtype)] = {
            "config": {"merge_tile": best.merge_tile},
            "us": round(best_t * 1e6, 1),
            "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        self._save()
        return best

    # -- dist: key family (multi-level exchange geometry) ---------------------
    @staticmethod
    def _dist_key(n_local: int, d: int, dtype) -> str:
        return f"dist:n_local={n_local}:d={d}:dtype={_dtype_name(dtype)}"

    def dist_plan(self, n_local: int, d: int, dtype, *, tune: bool = False) -> DistPlan:
        """Capacity factor and oversampling for a distributed sort at
        (n_local, d, dtype): a persisted ``dist:`` plan wins (an ``engine``
        in it, the reference's, is dropped); ``tune=True`` runs the
        host-side capacity simulation and persists the winner; otherwise
        the defaults.

        >>> import os, tempfile
        >>> pc = PlanCache(path=os.path.join(tempfile.mkdtemp(), "p.json"))
        >>> pc.dist_plan(8192, 8, torch.float32).slack  # no plan: defaults
        2.0
        """
        key = self._dist_key(n_local, d, dtype)
        entry = self._plans.get(key)
        cfg = entry.get("config") if isinstance(entry, dict) else None
        axis_order = self._dist_axis_order(cfg)
        if isinstance(cfg, dict):
            slack, ovs = cfg.get("slack"), cfg.get("oversample")
            if (isinstance(slack, (int, float)) and not isinstance(slack, bool)
                    and isinstance(ovs, int) and not isinstance(ovs, bool)):
                obs.count("plan_cache.hit", family="dist")
                cfg.pop("engine", None)  # the reference's: migrated at the next save
                entry.pop("engine", None)
                return DistPlan(n_local, d, float(slack), ovs, axis_order)
        obs.count("plan_cache.miss", family="dist")
        if tune:
            return dataclasses.replace(self._autotune_dist(n_local, d, dtype),
                                       axis_order=axis_order)
        from repro_torch.dist.levels import default_oversample  # lazy: dist layers on ops

        return DistPlan(n_local, d, oversample=default_oversample(n_local * d),
                        axis_order=axis_order)

    @staticmethod
    def _dist_axis_order(cfg: Any) -> Tuple[str, ...]:
        if isinstance(cfg, dict):
            ao = cfg.get("axis_order")
            if isinstance(ao, list) and all(isinstance(a, str) for a in ao):
                return tuple(ao)
        return ()

    def record_dist_axis_order(self, n_local: int, d: int, dtype,
                               order: Tuple[str, ...]) -> None:
        """Persist the topology-chosen level order as a dimension of the
        ``dist:`` entry (DESIGN.md §13.4), for later
        ``dist.sort(order="auto")`` calls at the same (n_local, d, dtype);
        a later capacity autotune of the entry keeps it.

        >>> import os, tempfile
        >>> pc = PlanCache(path=os.path.join(tempfile.mkdtemp(), "p.json"))
        >>> pc.record_dist_axis_order(8192, 8, torch.float32, ("pod", "data"))
        >>> pc.dist_plan(8192, 8, torch.float32).axis_order
        ('pod', 'data')
        """
        entry = self._plans.setdefault(self._dist_key(n_local, d, dtype), {})
        entry.setdefault("config", {})["axis_order"] = [str(a) for a in order]
        self._save()

    def _autotune_dist(self, n_local: int, d: int, dtype) -> DistPlan:
        """The reference's host-side capacity simulation: for ascending
        (slack, oversample) candidates, replay the level-0 splitter
        selection and equality-bucket striping on adversarial synthetic
        draws (uniform / exponential / heavy-duplicate) and keep the
        cheapest candidate whose worst per-pair fill stays under
        ``_DIST_FILL_MARGIN`` of capacity.  numpy only: no card needed."""
        from repro_torch.dist.levels import default_oversample, plan_schedule

        key = self._dist_key(n_local, d, dtype)
        floating = _torch_dtype(dtype).is_floating_point
        base_ovs = default_oversample(n_local * d)

        def draws(rng):
            if floating:
                yield rng.standard_normal(n_local).astype(np.float32)
                yield rng.exponential(size=n_local).astype(np.float32)
                yield rng.choice(97, size=n_local).astype(np.float32)  # dup-heavy
            else:
                yield rng.integers(0, 1 << 30, n_local, dtype=np.int64)
                yield rng.integers(0, 97, n_local, dtype=np.int64)  # dup-heavy
                yield (rng.exponential(size=n_local) * (1 << 20)).astype(np.int64)

        def worst_fill(slack: float, oversample: int) -> float:
            cap = plan_schedule({"x": d}, "x", n_local, slack=slack,
                                oversample=oversample)[0].capacity
            worst = 0.0
            for seed in range(3):
                rng = np.random.default_rng(seed)
                for x in draws(rng):
                    # one rank's stripe after the pre-exchange: representative
                    # of the global distribution by construction
                    sample = rng.choice(x, size=min(oversample * d, n_local))
                    spl = np.sort(sample)[np.clip((np.arange(1, d) * len(sample)) // d,
                                                  0, len(sample) - 1)]
                    lo = np.searchsorted(spl, x, side="left")
                    hi = np.searchsorted(spl, x, side="right")
                    span = np.maximum(hi - lo + 1, 1)
                    # the exchange's hashed equality striping (dist.exchange)
                    pos = (np.arange(n_local, dtype=np.uint64) * 2654435761) & 0xFFFFFFFF
                    stripe = (pos >> 16).astype(np.int64) % span
                    dest = np.minimum(lo + stripe, d - 1)
                    worst = max(worst, np.bincount(dest, minlength=d).max() / cap)
            return worst

        best = None
        for slack in _DIST_SLACKS:
            for mul in _DIST_OVERSAMPLE_MULS:
                fill = worst_fill(slack, base_ovs * mul)
                if fill <= _DIST_FILL_MARGIN:
                    best = DistPlan(n_local, d, slack, base_ovs * mul)
                    break
            if best is not None:
                break
        if best is None:  # every candidate overflowed: the largest headroom
            best = DistPlan(n_local, d, _DIST_SLACKS[-1],
                            base_ovs * _DIST_OVERSAMPLE_MULS[-1])
            fill = worst_fill(best.slack, best.oversample)
        prev = self._plans.get(key)
        prev_order = self._dist_axis_order(prev.get("config") if isinstance(prev, dict)
                                           else None)
        self._plans[key] = {
            "config": {
                "slack": best.slack,
                "oversample": best.oversample,
                # a recorded topology order survives a capacity re-tune
                **({"axis_order": list(prev_order)} if prev_order else {}),
            },
            "sim_max_fill": round(float(fill), 3),
            "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        self._save()
        return best

    # -- public entry -------------------------------------------------------
    def get_sorter(
        self,
        n: int,
        dtype,
        op: str = "sort",
        *,
        k: Optional[int] = None,
        tune: bool = False,
        batch: Optional[int] = None,
        device=None,
    ) -> Callable:
        """A callable for ``op`` over (n,) keys of ``dtype``, or (B, n) with
        ``batch=B`` (the ``ops.batched`` entry points), bound to the plan's
        ``SortConfig`` on ``device`` (None: the card).  ``k`` is required
        for "topk"/"bottomk".  With ``tune=True`` a missing plan is swept
        and persisted first."""
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")
        if op in ("topk", "bottomk") and k is None:
            raise ValueError(f"op={op!r} requires k")
        dev = _device(device)
        key = self._key(op, n, dtype, k, batch)
        memo = f"{key}@{dev}"
        f = self._compiled.get(memo)
        # tune=True with no persisted plan must not be met by an untuned
        # callable: sweep and rebuild
        if f is None or (tune and key not in self._plans):
            obs.count("plan_cache.compiled_miss", op=op)
            cfg = self.config_for(op, n, dtype, k, tune=tune, batch=batch, device=dev)
            f = self._compiled[memo] = _build(op, cfg, k, batch, dev)
        else:
            obs.count("plan_cache.compiled_hit", op=op)
        return f


default_cache = PlanCache()


def get_sorter(n: int, dtype, op: str = "sort", **kw) -> Callable:
    """``default_cache.get_sorter``.

    >>> f = get_sorter(4, torch.int32, op="argsort", device="cpu")
    >>> f(torch.tensor([30, 10, 20, 0], dtype=torch.int32)).tolist()
    [3, 1, 2, 0]
    """
    return default_cache.get_sorter(n, dtype, op, **kw)
