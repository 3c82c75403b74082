"""repro_torch.dist: sharded sort-derived ops on the multi-level engine.

Counterpart of ``repro.dist.api`` on ``torch.distributed``.  The entry
points mirror ``repro_torch.ops`` lifted onto a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
(DESIGN.md §8): keys pass ``ops.keyspace.encode``/``decode`` at the
boundary (every key dtype of the port, NaN-safe, -0.0 < +0.0, the total
order of ``ops.sort``; 64-bit keys travel as int64 codes and sort locally
through the 64-bit kernels), and the capacity knobs come from the
``dist:`` plan family of the plan cache.

  sort / argsort   multi-level AMS-style sort over one or more mesh axes
                   (e.g. ``("pod", "data")``): per-axis splitter sets and
                   per-axis collective fan-in, re-split retry on overflow
  topk / bottomk   distributed rank-k: the local partial sort as a filter,
                   a gather of the per-rank candidates and one local finish
                   on every rank (replicated results)
  group_by         multi-level sort + per-rank run starts

**SPMD.**  The reference takes one global array sharded over the mesh and
returns global arrays; the port is per-rank code: every rank of the mesh
calls the entry point with its local shard ``(n_local,)`` (the same
arguments otherwise) and gets back its own shard of each output: the
sorted range padded to capacity with sentinels (decoded: NaN for float
keys), its valid count ``(1,)`` int32 and its overflow flag ``(1,)``
bool, the reference's shard i of ``(sorted, counts, overflow)``.  Rank
ranges concatenate in the row-major order of the mesh over ``axes`` in
the order used (``order="auto"`` may reorder them); an input shard's
global index is this rank's position in that order times n_local.

**Devices.**  The device is the mesh's ``device_type``: a CPU mesh (with
``gloo``) is the caller asking for the CPU, where every kernel's plain twin
runs.  Keys on another device type than the mesh's raise; they are never
moved.  On the card every partition runs kernel K2 and the local sort
the port's kernels (K1 or K1r, K2, K3); collectives go to NCCL or, for
several ranks on one card, ``gloo``.

The port has no engine switch: ``engine`` must be None.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Any, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.classify import resolve_classifier
from repro_torch.core.ips4o import SortConfig, _payload, ips4o_sort
from repro_torch.dist.exchange import compact_valid, exchange_level, group_for
from repro_torch.dist.levels import AxisNames, normalize_axes, order_axes, plan_schedule
from repro_torch.ops import keyspace
from repro_torch.ops.topk import smallest_encoded

__all__ = ["sort", "argsort", "topk", "bottomk", "group_by"]


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _check_engine(engine: Optional[str]) -> None:
    if engine is not None:
        raise ValueError(f"engine={engine!r}: the port has no engine switch; its kernels "
                         "always run on the card (pass engine=None)")


def _prepare(keys: torch.Tensor, mesh, axes: AxisNames,
             pre_exchange: bool = True) -> Tuple[Tuple[str, ...], int, int]:
    """(axis names, d, n_local) for this rank's shard ``keys``; raises for
    an unknown axis, a device other than the mesh's, or a shard size the
    pre-exchange cannot split."""
    names = normalize_axes(axes)
    sizes = _mesh_sizes(mesh)
    missing = [a for a in names if a not in sizes]
    if missing or not names:
        raise ValueError(f"axes {names} must name axes of the mesh {tuple(sizes)}")
    if not isinstance(keys, torch.Tensor) or keys.dim() != 1:
        raise ValueError("keys must be this rank's 1-D shard, a tensor")
    if keys.device.type != mesh.device_type:
        raise ValueError(f"keys on {keys.device} but the mesh is on {mesh.device_type}: "
                         "move the keys to the mesh's device")
    d = math.prod(sizes[a] for a in names)
    n_local = keys.shape[0]
    # the balanced pre-exchange splits each shard into d chunks; rank-k
    # queries never run it and take any shard size
    if pre_exchange and d > 1 and n_local % d:
        raise ValueError(f"shard size {n_local} must be divisible by d={d} (pre-exchange)")
    return names, d, n_local


def _plan_params(n_local: int, d: int, dtype, slack: Optional[float],
                 oversample: Optional[int], tune: bool):
    from repro_torch.ops import plan  # lazy, and read at call time: tests swap the cache

    p = plan.default_cache.dist_plan(n_local, d, dtype, tune=tune)
    return (p.slack if slack is None else float(slack),
            p.oversample if oversample is None else int(oversample),
            p.axis_order)


def _resolve_order(order: Optional[str], names: Tuple[str, ...], mesh, n_local: int, d: int,
                   dtype, planned: Tuple[str, ...], slack: float,
                   oversample: int) -> Tuple[str, ...]:
    """``order="auto"``: topology-aware axis ordering (DESIGN.md §13.4).  A
    persisted ``axis_order`` naming exactly this call's axes wins; else the
    static cost model picks and records it in the ``dist:`` plan.  None /
    "given" keep the caller's order."""
    if order not in (None, "given", "auto"):
        raise ValueError(f"order must be None, 'given' or 'auto', got {order!r}")
    if order in (None, "given") or len(names) < 2:
        return names
    if tuple(sorted(planned)) == tuple(sorted(names)):
        return tuple(planned)
    chosen = order_axes(_mesh_sizes(mesh), names, n_local, slack=slack, oversample=oversample)
    from repro_torch.ops import plan

    plan.default_cache.record_dist_axis_order(n_local, d, dtype, chosen)
    return chosen


def _finish_local(arrays: dict, m: torch.Tensor, cfg: SortConfig) -> dict:
    """The final local IPS4o sort of this rank's range.  Pads share the
    sentinel code with real max / NaN keys, so with a payload a validity
    bit rides the sort and one stable 2-bucket partition puts the pads
    behind every real element without disturbing the key order."""
    n = arrays["k"].shape[0]
    vals = {name: a for name, a in arrays.items() if name != "k"}
    if not vals:
        return {"k": ips4o_sort(arrays["k"], cfg=cfg)}
    validity = (torch.arange(n, device=m.device) < m).to(torch.int32)
    k_sorted, out_v = ips4o_sort(arrays["k"], {**vals, "_valid": validity}, cfg=cfg)
    valid_sorted = out_v.pop("_valid")
    return compact_valid({"k": k_sorted, **out_v}, valid_sorted > 0, cfg.tile)


def _pre_exchange(arrays: dict, mesh, names: Tuple[str, ...], d: int) -> dict:
    """The balanced pre-exchange over the whole domain: one round-robin
    all_to_all gives every rank a representative slice of every stripe,
    bounding per-pair counts for any input placement."""
    grp = group_for(mesh, names)
    out = {}
    for name, a in arrays.items():
        got, _ = grp.all_to_all(a.reshape(a.shape[0], -1).view(torch.uint8))
        out[name] = grp.arrivals(got).view(a.dtype).reshape(a.shape)
    return out


def _sort_body(arrays: dict, mesh, n_local: int, names: Tuple[str, ...], schedule,
               cfg: SortConfig, retries: int, d: int, overlap: bool):
    """This rank's part: the pre-exchange, the level loop and the local
    finish.  Returns (arrays, counts (1,) int32, overflow (1,) bool)."""
    if d > 1:
        arrays = _pre_exchange(arrays, mesh, names, d)
    dev = arrays["k"].device
    m = torch.full((), n_local, dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for i, level in enumerate(schedule):
        arrays, m, ovf = _level_step(arrays, m, mesh, names, i, level, cfg, retries, overlap)
        overflow = overflow | ovf
    out = _finish_local(arrays, m, cfg)
    return out, m.reshape(1).to(torch.int32), overflow.reshape(1)


def _level_step(arrays: dict, m: torch.Tensor, mesh, names: Tuple[str, ...], i: int,
                level, cfg: SortConfig, retries: int, overlap: bool):
    """Level i's exchange over ``names[i:]``: radix destinations only at
    level 0 (deeper domains hold splitter-delimited ranges once any round
    re-split)."""
    return exchange_level(
        arrays, m, level,
        domain=group_for(mesh, names[i:]), axis=group_for(mesh, names[i:i + 1]),
        tile=cfg.tile, seed=cfg.seed, level_idx=i, retries=retries,
        classifier=cfg.classifier if i == 0 else "tree", overlap=overlap,
    )


def _setup(keys, mesh, axes, slack, oversample, cfg, engine, classifier, tune, order):
    """The shared front of ``sort`` and ``argsort``: the axis order, the run
    config and the level schedule."""
    _check_engine(engine)
    names, d, n_local = _prepare(keys, mesh, axes)
    slack, oversample, planned = _plan_params(n_local, d, keys.dtype, slack, oversample, tune)
    names = _resolve_order(order, names, mesh, n_local, d, keys.dtype, planned, slack,
                           oversample)
    clf = resolve_classifier(classifier or cfg.classifier, n_local, keys.dtype)
    schedule = plan_schedule(_mesh_sizes(mesh), names, n_local, slack=slack,
                             oversample=oversample)
    return names, d, n_local, replace(cfg, classifier=clf), schedule


def sort(
    keys: torch.Tensor,
    mesh,
    axes: AxisNames = "data",
    *,
    values: Any = None,
    slack: Optional[float] = None,
    oversample: Optional[int] = None,
    retries: int = 2,
    cfg: SortConfig = SortConfig(),
    engine: Optional[str] = None,
    classifier: Optional[str] = None,
    tune: bool = False,
    overlap: bool = False,
    order: Optional[str] = None,
):
    """Multi-level distributed sort; every rank of ``mesh`` calls it with its
    shard.

    Args:
      keys: this rank's (n_local,) shard, on the mesh's device type
        (n_local divisible by d, the size of ``axes``, when d > 1).
      axes: one mesh axis or an outermost-first tuple (e.g.
        ``("pod", "data")``): one exchange level per axis.
      values: optional payload pytree (leaves with leading dim n_local);
        rows ride every partition and exchange.
      slack / oversample: capacity factor and per-rank sample size; None
        reads the ``dist:`` plan for (n_local, d, dtype) (``tune=True``
        runs the capacity simulation and persists the winner).
      retries: bounded re-split rounds per level before the overflow flag.
      classifier: "tree" | "radix" | "learned" | "auto" for the local sort,
        resolved by ``classify.resolve_classifier`` against (n_local,
        dtype); "radix" also takes bit-range destinations at round 0 of
        level 0, skipping that round's sampling collective.
      overlap: stagger each level's exchange against the partition of its
        second half (bit-identical results).
      order: None / "given" keep the caller's axis order; "auto" reorders
        the levels by the topology cost model, consulting and recording the
        ``dist:`` plan's ``axis_order``; rank ranges then concatenate in the
        reordered row-major order.

    Returns (sorted, counts, overflow), with values (sorted,
    sorted_values, counts, overflow): this rank's range padded to capacity
    (sentinel keys decode to the dtype's max, NaN for floats), its valid
    count (1,) int32, and (1,) True only if some exchange truncated after
    exhausting its re-split rounds.

    One rank (d = 1) needs no process group traffic at all; its result is
    ``ops.sort``'s, padded.
    """
    names, d, n_local, cfg_run, schedule = _setup(keys, mesh, axes, slack, oversample, cfg,
                                                  engine, classifier, tune, order)
    arrays = {"k": keyspace.encode(keys)}
    rebuild = None
    if values is not None:
        payload, rebuild = _payload(values, keys)
        arrays.update(payload)
    with obs.trace("dist.sort", axes=",".join(names), levels=len(schedule), d=d,
                   overlap="on" if overlap else "off"):
        out, counts, ovf = _sort_body(arrays, mesh, n_local, names, schedule, cfg_run,
                                      retries, d, overlap)
        obs.block(out)
    sorted_keys = keyspace.decode(out["k"], keys.dtype)
    if rebuild is None:
        return sorted_keys, counts, ovf
    return sorted_keys, rebuild(out, out["k"].shape[0]), counts, ovf


def argsort(
    keys: torch.Tensor,
    mesh,
    axes: AxisNames = "data",
    *,
    slack: Optional[float] = None,
    oversample: Optional[int] = None,
    retries: int = 2,
    cfg: SortConfig = SortConfig(),
    engine: Optional[str] = None,
    classifier: Optional[str] = None,
    tune: bool = False,
    overlap: bool = False,
    order: Optional[str] = None,
):
    """Distributed argsort: the global input positions (int32) ride as the
    payload.  Returns (order, counts, overflow): this rank's valid prefix
    of ``order`` holds the global indices of its sorted range, so the
    valid prefixes concatenated in rank-range order sort the global array.
    ``overlap`` / ``order`` behave as in :func:`sort`."""
    names, d, n_local, cfg_run, schedule = _setup(keys, mesh, axes, slack, oversample, cfg,
                                                  engine, classifier, tune, order)
    my = group_for(mesh, names).index
    gidx = my * n_local + torch.arange(n_local, dtype=torch.int32, device=keys.device)
    out, counts, ovf = _sort_body({"k": keyspace.encode(keys), "v": gidx}, mesh, n_local,
                                  names, schedule, cfg_run, retries, d, overlap)
    return out["v"], counts, ovf


def bottomk(keys: torch.Tensor, k: int, mesh, axes: AxisNames = "data", *,
            cfg: SortConfig = SortConfig(), engine: Optional[str] = None,
            classifier: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k globally smallest keys (ascending) with their global int32
    indices, the same on every rank.  Every rank runs the splitter-based
    partial sort of ``ops.bottomk`` on its shard as a filter, the
    candidates are gathered over the domain and every rank finishes them
    with one more partial sort.  NaN-safe like ``ops.bottomk``."""
    return _rank_k(keys, k, mesh, axes, cfg=cfg, engine=engine, classifier=classifier,
                   largest=False)


def topk(keys: torch.Tensor, k: int, mesh, axes: AxisNames = "data", *,
         cfg: SortConfig = SortConfig(), engine: Optional[str] = None,
         classifier: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k globally largest keys (descending) with their global int32
    indices: ``bottomk`` of the complemented codes, like ``ops.topk``."""
    return _rank_k(keys, k, mesh, axes, cfg=cfg, engine=engine, classifier=classifier,
                   largest=True)


def _rank_k(keys: torch.Tensor, k: int, mesh, axes: AxisNames, *, cfg: SortConfig,
            engine: Optional[str], largest: bool,
            classifier: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_engine(engine)
    names, d, n_local = _prepare(keys, mesh, axes, pre_exchange=False)
    kk = max(0, min(int(k), n_local * d))
    if kk == 0:
        return keys[:0], torch.zeros(0, dtype=torch.int32, device=keys.device)
    if d == 1:
        from repro_torch.ops.topk import bottomk as _bk, topk as _tk

        return (_tk if largest else _bk)(keys, kk, cfg=cfg, classifier=classifier,
                                         device=keys.device)
    cfg_run = replace(cfg, classifier=resolve_classifier(classifier or cfg.classifier,
                                                         n_local, keys.dtype))
    grp = group_for(mesh, names)
    enc = keyspace.encode(keys)
    if largest:
        enc = ~enc
    vals, idx = smallest_encoded(enc, min(kk, n_local), cfg_run)  # the local filter
    cand_v = grp.all_gather(vals)
    cand_i = grp.all_gather(grp.index * n_local + idx)
    fin_v, fin_i = smallest_encoded(cand_v, kk, cfg_run)  # the finish, on every rank
    if largest:
        fin_v = ~fin_v
    return keyspace.decode(fin_v, keys.dtype), cand_i[fin_i.to(torch.int64)]


def group_by(
    keys: torch.Tensor,
    mesh,
    axes: AxisNames = "data",
    *,
    values: Any = None,
    slack: Optional[float] = None,
    retries: int = 2,
    cfg: SortConfig = SortConfig(),
    engine: Optional[str] = None,
    classifier: Optional[str] = None,
    overlap: bool = False,
):
    """Sharded grouping: the multi-level sort by key, then the run starts of
    this rank's range.

    Returns (sorted_keys, [sorted_values,] starts, counts, overflow) where
    ``starts`` marks the first element of each key run *within this rank*
    (a run crossing a rank boundary starts again on the next rank; the
    global sort puts a key on adjacent ranks only).
    """
    res = sort(keys, mesh, axes, values=values, slack=slack, retries=retries, cfg=cfg,
               engine=engine, classifier=classifier, overlap=overlap)
    out_k, counts = res[0], res[-2]
    ek = keyspace.encode(out_k)  # one NaN class, -0.0 != +0.0
    pos = torch.arange(ek.shape[0], device=ek.device)
    prev = torch.cat([ek[:1], ek[:-1]])
    starts = (pos < counts[0]) & ((pos == 0) | (ek != prev))
    return res[:-2] + (starts,) + res[-2:]
