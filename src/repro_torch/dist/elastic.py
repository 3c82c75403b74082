"""Elastic distributed sort: level boundaries as restore points.

Counterpart of ``repro.dist.elastic``.  ``repro_torch.dist.sort`` runs the
pre-exchange, every level's exchange and the local finish in one call: a
rank lost anywhere loses everything.  :func:`sort_elastic` runs the same
sort as a *host-driven state machine* whose per-rank state is saved at
every level boundary through ``repro_torch.checkpoint.CheckpointManager``
(DESIGN.md §13.3):

    INIT --save(0)--> LEVEL 0 --save(1)--> LEVEL 1 -- ... --save(L)--> FINISH

  * **state** at boundary s, per rank: the key and payload arrays, the
    valid count, the accumulated overflow flag, the valid counts at every
    boundary so far, plus (alike on every rank) the consumed-level index
    and a fingerprint of the sort's parameters;
  * **restore**: ``latest_step()`` finds the last completed boundary,
    ``read_leaf`` recovers the level index (the state's shapes depend on
    it), and ``restore`` gives every rank its own shards back, on the
    current process group of a mesh of the same shape;
  * **determinism**: every level's sample positions depend on (seed,
    level, round, rank) alone (``dist.exchange.sample_positions``), so a
    resumed sort draws exactly the samples the uninterrupted sort drew
    and its output is bit-identical, re-split rounds and truncation
    included.

Each step runs the exact per-rank bodies of ``dist.api`` (the
pre-exchange, ``exchange_level`` through ``_level_step``, the local
finish), so the elastic path cannot drift from ``dist.sort``.  The price
of restorability is one host read of the valid count and one checkpoint
write per level; ``blocking_saves=False`` overlaps the write with the next
level.

A directory identifies ONE sort job: calling :func:`sort_elastic` with a
directory that holds a finished job's checkpoints replays its finish.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.ips4o import SortConfig, _payload
from repro_torch.dist.api import _finish_local, _level_step, _pre_exchange, _setup
from repro_torch.dist.levels import AxisNames
from repro_torch.ops import keyspace

__all__ = ["sort_elastic"]


def _fingerprint(meta: dict) -> np.ndarray:
    """sha256 of the sort's parameters as a (32,) uint8 leaf: a checkpoint
    of another sort must never be resumed silently."""
    digest = hashlib.sha256(json.dumps(meta, sort_keys=True).encode()).digest()
    return np.frombuffer(digest, dtype=np.uint8).copy()


def sort_elastic(
    keys: torch.Tensor,
    mesh,
    axes: AxisNames = "data",
    *,
    manager: CheckpointManager,
    values: Any = None,
    slack: Optional[float] = None,
    oversample: Optional[int] = None,
    retries: int = 2,
    cfg: SortConfig = SortConfig(),
    engine: Optional[str] = None,
    classifier: Optional[str] = None,
    overlap: bool = False,
    blocking_saves: bool = True,
    _fail_at_step: Optional[int] = None,
):
    """Restorable multi-level distributed sort (module docstring); every
    rank calls it with its shard, as :func:`repro_torch.dist.sort`.

    Same contract and bit-identical output as ``dist.sort``, but the sort
    saves its per-rank state into ``manager`` at every level boundary and,
    when the manager's directory already holds a matching checkpoint,
    resumes from the last completed level.  On resume the *data* comes
    from the checkpoint; ``keys`` / ``values`` supply only shapes, dtypes
    and the device.  A checkpoint whose parameter fingerprint disagrees
    (another seed, schedule, dtype, ...) raises ``ValueError``.

    ``_fail_at_step`` is the fault-injection hook of the restore tests: it
    raises ``RuntimeError`` (a lost rank) right after the named boundary's
    checkpoint commits.
    """
    names, d, n_local, cfg_run, schedule = _setup(keys, mesh, axes, slack, oversample, cfg,
                                                  engine, classifier, False, None)
    levels = len(schedule)
    dev = keys.device
    arrays = {"k": keyspace.encode(keys)}
    rebuild = None
    if values is not None:
        payload, rebuild = _payload(values, keys)
        arrays.update(payload)
    leaves = pytree.tree_flatten_with_path(values)[0] if values is not None else []
    val_meta = [(pytree.keystr(path), str(leaf.dtype), list(leaf.shape[1:]))
                for path, leaf in leaves if leaf is not None]
    fp = _fingerprint({
        "axes": list(names), "d": d, "n_local": n_local,
        "capacities": [lv.capacity for lv in schedule],
        "oversample": int(schedule[0].oversample),
        "retries": int(retries), "seed": int(cfg.seed),
        "dtype": str(keys.dtype).removeprefix("torch."), "classifier": cfg_run.classifier,
        "overlap": bool(overlap), "values": val_meta,
    })

    start = 0
    fills = torch.zeros(levels + 1, dtype=torch.int64)  # this rank's valid counts
    last = manager.latest_step()
    resumed = last is not None
    if resumed:
        if not np.array_equal(manager.read_leaf(last, "fingerprint").numpy(), fp):
            raise ValueError("checkpoint directory holds a different sort "
                             "(parameter fingerprint mismatch); use a fresh directory")
        start = int(manager.read_leaf(last, "level"))
        n_shard = n_local if start == 0 else schedule[start - 1].n_out
        like = {
            "arrays": {name: torch.empty((n_shard,) + tuple(a.shape[1:]), dtype=a.dtype,
                                         device=dev) for name, a in arrays.items()},
            "m": torch.empty(1, dtype=torch.int64, device=dev),
            "ovf": torch.empty(1, dtype=torch.bool, device=dev),
            "fills": fills,
        }
        st = manager.restore(last, like)
        arrays, m, ovf, fills = st["arrays"], st["m"][0], st["ovf"][0], st["fills"]

    def save(step: int) -> None:
        manager.save(step, {
            "arrays": arrays, "m": m.reshape(1), "ovf": ovf.reshape(1),
            "fills": fills.clone(), "level": np.int32(step), "fingerprint": fp,
        }, blocking=blocking_saves)
        if _fail_at_step is not None and step == _fail_at_step:
            manager.wait()
            raise RuntimeError(f"injected shard loss after level boundary {step}")

    with obs.trace("dist.sort_elastic", axes=",".join(names), levels=levels, d=d,
                   resumed="yes" if resumed else "no", start_level=start,
                   overlap="on" if overlap else "off"):
        if not resumed:
            if d > 1:
                arrays = _pre_exchange(arrays, mesh, names, d)
            m = torch.full((), n_local, dtype=torch.int64, device=dev)
            ovf = torch.zeros((), dtype=torch.bool, device=dev)
            fills[0] = n_local
            save(0)
        for i in range(start, levels):
            arrays, m, ovf_i = _level_step(arrays, m, mesh, names, i, schedule[i], cfg_run,
                                           retries, overlap)
            ovf = ovf | ovf_i
            fills[i + 1] = int(m)  # the boundary's host read
            save(i + 1)
        out = _finish_local(arrays, m, cfg_run)
    manager.wait()

    sorted_keys = keyspace.decode(out["k"], keys.dtype)
    counts, flag = m.reshape(1).to(torch.int32), ovf.reshape(1)
    if rebuild is None:
        return sorted_keys, counts, flag
    return sorted_keys, rebuild(out, out["k"].shape[0]), counts, flag
