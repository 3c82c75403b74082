"""Batch scheduler: admits requests shortest-remaining-first with the
port's sorting engine, so continuous batches retire together.

Counterpart of ``repro.serve.scheduler`` (``Request``, ``Scheduler``,
``admit_many``), with its semantics and its keys:

  * selection runs on the composite int32 key ``remaining * n_pad +
    position`` (the queue position is the arrival index), so ties on
    ``remaining`` admit in FIFO order; the queue pads to the next power of
    two with the ``int32.max`` sentinel, so a queue that grows by one
    request a tick asks the plan cache for O(log n) sorters;
  * where the composite would overflow int32, a host-side ``np.lexsort``
    on (remaining, position) gives the same order;
  * admission is the plan-cached ``bottomk`` (``ops.plan.get_sorter``);
    :func:`admit_many` admits every scheduler of a fleet with one
    ``batched_bottomk`` over a (S_pad, n_pad) matrix, both dims powers of
    two;
  * a persisted backlog (:meth:`Scheduler.attach_backlog`) is a sorted
    run; admission then merges it with the live candidates through the
    port's ``stream.merge`` (kernel K5 on the card), the backlog winning
    ties; a host-side stable argsort stands in when ``remaining`` reaches
    the sentinel;
  * ``next_batch(mesh=, axes=)`` takes a ``DeviceMesh``: every rank holds
    the queue (as the reference's host does), pads the composite keys to
    a power of two divisible by d, takes its own shard and calls the
    port's per-rank ``dist.bottomk``, which returns the same admission on
    every rank.  A mesh of one rank takes the single-device path.

Spans ``serve.next_batch`` and ``serve.admit_many`` and counters
``serve.admitted`` and ``serve.backlog_attached`` go to ``repro_torch.obs``.
Selection runs on ``device`` (the card by default, ``"cpu"`` for the plain
twins); with a mesh, on the mesh's device type.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ops import plan
from repro_torch.ops.sort import Device, _device

__all__ = ["Request", "Scheduler", "admit_many"]

_SENTINEL = np.iinfo(np.int32).max


@dataclass
class Request:
    uid: int
    prompt_len: int
    max_new: int
    done: int = 0

    @property
    def remaining(self) -> int:
        return self.max_new - self.done


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _remaining(reqs: Sequence[Request]) -> np.ndarray:
    return np.asarray([r.remaining for r in reqs], np.int64)


def _composite_of(reqs: Sequence[Request], n_pad: int) -> Optional[np.ndarray]:
    """(remaining, position) composite int32 keys of a request list, or
    None when the composite would overflow int32."""
    q = len(reqs)
    comp = _remaining(reqs) * n_pad + np.arange(q, dtype=np.int64)
    if q and comp.max() >= _SENTINEL:
        return None
    return comp.astype(np.int32)


def _padded(comp: np.ndarray, n_pad: int) -> np.ndarray:
    keys = np.full(n_pad, _SENTINEL, np.int32)
    keys[:comp.shape[0]] = comp
    return keys


def _host_order(reqs: Sequence[Request]) -> np.ndarray:
    """The (remaining, position) order on the host: the overflow fallback."""
    return np.lexsort((np.arange(len(reqs)), _remaining(reqs)))


@dataclass
class Scheduler:
    batch_size: int
    queue: List[Request] = field(default_factory=list)
    backlog: List[Request] = field(default_factory=list)  # persisted, sorted
    device: Device = None

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def attach_backlog(self, reqs: Sequence[Request]) -> None:
        """Attach a persisted queue (requests spilled by an earlier server
        session) as a sorted run: one plan-cached argsort on the composite
        (remaining, position) key, then a host-side stable merge into the
        backlog already attached, earlier attaches winning ties.  Backlog
        requests are older than anything live and win admission ties."""
        reqs = list(reqs)
        q = len(reqs)
        if not q:
            return
        n_pad = _pow2(q)
        comp = _composite_of(reqs, n_pad)
        if comp is None:  # int32 overflow: host-side stable order
            order = _host_order(reqs)
        else:
            dev = _device(self.device)
            f = plan.get_sorter(n_pad, torch.int32, "argsort", device=dev)
            order = f(torch.as_tensor(_padded(comp, n_pad), device=dev)).cpu().numpy()
            order = order[order < q]
        combined = self.backlog + [reqs[i] for i in order]
        # a stable argsort of two sorted runs' concatenation is their merge
        self.backlog = [combined[i] for i in np.argsort(_remaining(combined), kind="stable")]
        obs.count("serve.backlog_attached", q)

    def next_batch(self, *, mesh=None, axes="data") -> List[Request]:
        """Admit up to ``batch_size`` requests, shortest remaining first,
        FIFO among equal ``remaining``.  With ``mesh`` (a ``DeviceMesh``;
        every rank calls this with the same queue) the live selection is
        the distributed bottom-k over ``axes``, with the same admission.
        With a backlog attached, the backlog prefix and the live candidates
        (both sorted runs) interleave through one stable 2-way merge on
        ``remaining``, backlog first on ties."""
        kk = min(self.batch_size, len(self.queue) + len(self.backlog))
        if not kk:
            return []
        with obs.trace("serve.next_batch", queue=len(self.queue), backlog=len(self.backlog)):
            order = self._select_live(min(self.batch_size, len(self.queue)), mesh=mesh,
                                      axes=axes)
            if not self.backlog:
                batch = self._take(order)
                obs.count("serve.admitted", len(batch))
                return batch
            bk = _remaining(self.backlog[:self.batch_size])
            lk = _remaining([self.queue[i] for i in order])
            if max(bk.max(initial=0), lk.max(initial=0)) < _SENTINEL:
                from repro_torch.stream import merge  # lazy: stream layers above serve

                dev = self._selection_device(mesh)
                _, src = merge(
                    [torch.as_tensor(bk.astype(np.int32), device=dev),
                     torch.as_tensor(lk.astype(np.int32), device=dev)],
                    values=[torch.arange(len(bk), dtype=torch.int32, device=dev),
                            len(bk) + torch.arange(len(lk), dtype=torch.int32, device=dev)],
                )
                src = src.cpu().numpy()
            else:  # remaining at the sentinel: the host-side stable merge
                src = np.argsort(np.concatenate([bk, lk]), kind="stable")
            src = src[:kk]
            n_back = int(np.sum(src < len(bk)))  # a prefix of the backlog run
            live_iter = iter(self._take(order[:kk - n_back]))
            back_iter = iter(self.backlog[:n_back])
            self.backlog = self.backlog[n_back:]
            batch = [next(back_iter) if s < len(bk) else next(live_iter) for s in src]
            obs.count("serve.admitted", len(batch))
            return batch

    def _select_live(self, kk: int, mesh=None, axes="data") -> np.ndarray:
        """Queue positions of the live admission candidates, in selection
        order: the bottom-k path both admission views share."""
        q = len(self.queue)
        if not q or not kk:
            return np.zeros((0,), np.int64)
        if mesh is not None:
            from repro_torch.dist.levels import normalize_axes

            sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            d = 1
            for a in normalize_axes(axes):
                d *= int(sizes[a])
            if d > 1:
                return self._select_live_dist(kk, mesh, axes, d)
        n_pad = _pow2(q)
        comp = self._composite_keys(n_pad)
        if comp is None:  # the composite overflows int32: host-side selection
            return _host_order(self.queue)[:kk]
        dev = self._selection_device(mesh)
        f = plan.get_sorter(n_pad, torch.int32, "bottomk", k=min(self.batch_size, n_pad),
                            device=dev)
        _, order = f(torch.as_tensor(_padded(comp, n_pad), device=dev))
        order = order.cpu().numpy()
        return order[order < q][:kk]  # drop sentinel pad slots

    def _select_live_dist(self, kk: int, mesh, axes, d: int) -> np.ndarray:
        """The distributed live selection: this rank's shard of the padded
        composite keys through ``dist.bottomk``, whose result (global
        positions) is the same on every rank."""
        from repro_torch import dist
        from repro_torch.dist.exchange import group_for
        from repro_torch.dist.levels import normalize_axes

        q = len(self.queue)
        # a power of two divisible by d, so that every shard has one size
        n_pad = _pow2(max(q, d))
        if n_pad % d:
            n_pad = -(-n_pad // d) * d
        comp = self._composite_keys(n_pad)
        if comp is None:
            return _host_order(self.queue)[:kk]
        n_local = n_pad // d
        me = group_for(mesh, normalize_axes(axes)).index
        shard = _padded(comp, n_pad)[me * n_local:(me + 1) * n_local]
        keys = torch.as_tensor(shard, device=self._selection_device(mesh))
        _, order = dist.bottomk(keys, min(self.batch_size, n_pad), mesh, axes)
        order = order.cpu().numpy()
        return order[order < q][:kk]  # drop sentinel pad slots

    # -- shared selection plumbing (used by admit_many too) -----------------
    def _selection_device(self, mesh) -> torch.device:
        """The mesh's device type with a mesh, else ``device``."""
        return torch.device(mesh.device_type) if mesh is not None else _device(self.device)

    def _composite_keys(self, n_pad: int) -> Optional[np.ndarray]:
        return _composite_of(self.queue, n_pad)

    def _take(self, order: np.ndarray) -> List[Request]:
        """Pop the requests at queue positions ``order`` (selection order),
        keeping the relative order of everything left behind."""
        batch = [self.queue[i] for i in order]
        picked = set(int(i) for i in order)
        self.queue = [r for i, r in enumerate(self.queue) if i not in picked]
        return batch


def admit_many(schedulers: Sequence[Scheduler]) -> List[List[Request]]:
    """Admit one step for every scheduler with ONE batched rank-k call.

    Every admission queue becomes a row of one (S_pad, n_pad) composite-key
    matrix (short queues and the pad rows fill with the sentinel; both dims
    powers of two) and one plan-cached ``batched_bottomk`` selects every
    row's admitted prefix, on the first scheduler's device.  Each queue
    keeps the semantics of :meth:`Scheduler.next_batch`; a scheduler with a
    backlog takes its own merged path, and one whose composite overflows
    its host fallback.
    """
    results: List[List[Request]] = [[] for _ in schedulers]
    lens = [len(s.queue) for s in schedulers]
    n_max = max(lens, default=0)
    if n_max == 0 and not any(s.backlog for s in schedulers):
        return results
    with obs.trace("serve.admit_many", schedulers=len(schedulers)):
        return _admit_many(schedulers, results, lens, n_max)


def _admit_many(schedulers, results, lens, n_max):
    n_pad = _pow2(n_max)
    rows: List[np.ndarray] = []
    row_ids: List[int] = []
    for i, s in enumerate(schedulers):
        q = lens[i]
        if s.backlog:  # the merged view is scheduler-local
            results[i] = s.next_batch()
            continue
        if q == 0:
            continue
        comp = s._composite_keys(n_pad)
        if comp is None:  # per-queue overflow fallback, as in next_batch
            results[i] = s._take(_host_order(s.queue)[:min(s.batch_size, q)])
            obs.count("serve.admitted", len(results[i]))
            continue
        rows.append(_padded(comp, n_pad))
        row_ids.append(i)
    if not rows:
        return results

    S = len(rows)
    mat = np.full((_pow2(S), n_pad), _SENTINEL, np.int32)
    mat[:S] = np.stack(rows)
    kk = min(max(schedulers[i].batch_size for i in row_ids), n_pad)
    dev = _device(schedulers[0].device)
    f = plan.get_sorter(n_pad, torch.int32, "bottomk", k=kk, batch=mat.shape[0], device=dev)
    _, order = f(torch.as_tensor(mat, device=dev))
    order = order.cpu().numpy()
    for j, i in enumerate(row_ids):
        s, q = schedulers[i], lens[i]
        o = order[j]
        results[i] = s._take(o[o < q][:min(s.batch_size, q)])  # drop sentinel pad slots
        obs.count("serve.admitted", len(results[i]))
    return results
