"""Run formation: chunked IPS4o sorts with overlapped host-to-device copies
(DESIGN.md §7.1).

Counterpart of ``repro.stream.runs``.  A host-resident (or generator-fed)
keyset is split into device-sized chunks, and each chunk is sorted by the
plan cache's sorter for its (n, dtype) (``ops.plan.PlanCache.get_sorter``),
so a stream at a fixed chunk size picks up persisted tuned plans, and
``tune=True`` sweeps a plan for the chunk shape once.

**Double buffer.**  The reference enqueues ``jax.device_put`` of chunk i+1
before it dispatches the sort of chunk i.  Here each chunk is copied into
one of two pinned host staging buffers and from there to the card on a
side ``torch.cuda.Stream``; the copy of chunk i+1 is enqueued before chunk
i is handed to its consumer, so it runs under chunk i's sort.  The rules
that keep this safe, each of which only a card can show when broken:

  * a staging buffer is refilled only after its previous copy has
    completed (the host waits on that copy's CUDA event);
  * the consumer's stream waits on the chunk's copy event before it reads
    the chunk (``wait_event``, not ``wait_stream``: the latter would also
    wait for the copy of chunk i+1 and undo the overlap);
  * the device tensor, allocated on the side stream, is marked with
    ``record_stream`` for the consumer's stream, so its memory is not
    reused while the sort still reads it.

On the CPU the chunks are used as they are.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.ops import plan
from repro_torch.ops.sort import Device, _device

__all__ = ["iter_chunks", "device_chunks", "form_runs", "form_argsort_runs",
           "check_stream_dtype"]

Source = Union[np.ndarray, Iterable[np.ndarray]]
MAX_INDEX = 2**31 - 1  # global indices are int32, as in the reference
# the keys the stream takes: K5 merges int32 codes (kernels/merge_path.py)
STREAM_DTYPES = (torch.float32, torch.int32, np.float32, np.int32)


def check_stream_dtype(dtype) -> None:
    """Raise for keys the stream does not take yet (a numpy or torch dtype):
    its merge, kernel K5, compares int32 codes, so only float32 and int32
    keys stream; the other dtypes of ``ops.keyspace`` would reach K5 as
    codes it cannot take."""
    if dtype not in STREAM_DTYPES:
        raise NotImplementedError(
            f"the stream takes float32 and int32 keys, got {dtype}: its merge K5 compares "
            "int32 codes (ROADMAP.md, queue 1 item 1, what stays open)"
        )


def iter_chunks(data: Source, chunk_size: int) -> Iterator[np.ndarray]:
    """Normalize a source into host chunk views.

    A 1-D array yields ``chunk_size`` slices (views, no copies; the tail
    may be ragged); any other iterable is treated as generator-fed and
    passed through (each element must be a 1-D array the caller already
    sized to the device).

    >>> [c.tolist() for c in iter_chunks(np.arange(5), 2)]
    [[0, 1], [2, 3], [4]]
    """
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if isinstance(data, np.ndarray):
        if data.ndim != 1:
            raise ValueError("array source must be 1-D")
        for lo in range(0, data.shape[0], chunk_size):
            yield data[lo : lo + chunk_size]
        return
    for chunk in data:
        chunk = np.asarray(chunk)
        if chunk.ndim != 1:
            raise ValueError("generator-fed chunks must be 1-D")
        yield chunk


class _Staging:
    """Two pinned host buffers and a side stream for the H2D copies."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.stream = torch.cuda.Stream(dev)
        self.buffers: List[Optional[torch.Tensor]] = [None, None]
        self.done: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def put(self, chunk: np.ndarray) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Enqueue the copy of ``chunk`` to the card; returns the device
        tensor and the event its consumer must wait on."""
        slot, self.turn = self.turn, 1 - self.turn
        if self.done[slot] is not None:
            self.done[slot].synchronize()  # its previous copy has left the buffer
        src = torch.from_numpy(np.ascontiguousarray(chunk))
        nbytes = src.numel() * src.element_size()
        buf = self.buffers[slot]
        if buf is None or buf.numel() < nbytes:
            buf = self.buffers[slot] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        staged = buf[:nbytes].view(src.dtype)
        staged.copy_(src)
        with torch.cuda.stream(self.stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.dev)
            out.copy_(staged, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.done[slot] = event
        return out, event


def device_chunks(data: Source, chunk_size: int, device: Device = None
                  ) -> Iterator[Tuple[torch.Tensor, int]]:
    """Yield (chunk on the device, its offset in the stream) in stream order.
    On a card, the copy of chunk i+1 is enqueued before chunk i is yielded,
    and chunk i is ready for the current stream when it is yielded."""
    dev = _device(device)
    staging = _Staging(dev) if dev.type == "cuda" else None
    pending = None
    offset = 0
    for chunk in iter_chunks(data, chunk_size):
        check_stream_dtype(chunk.dtype)
        if offset + chunk.shape[0] > MAX_INDEX:
            raise ValueError("stream longer than 2^31 - 1 keys: global indices are int32")
        if staging is None:
            nxt = (torch.from_numpy(np.ascontiguousarray(chunk)), None, offset)
        else:
            nxt = (*staging.put(chunk), offset)
        if pending is not None:
            yield _ready(*pending)
        pending = nxt
        offset += chunk.shape[0]
    if pending is not None:
        yield _ready(*pending)


def _ready(x: torch.Tensor, event, offset: int) -> Tuple[torch.Tensor, int]:
    if event is not None:
        current = torch.cuda.current_stream(x.device)
        current.wait_event(event)
        x.record_stream(current)
    return x, offset


def form_runs(data: Source, chunk_size: int, *, cache: Optional[plan.PlanCache] = None,
              tune: bool = False, device: Device = None) -> List[torch.Tensor]:
    """Sorted device runs, one per chunk, in stream order (the plan-cached
    NaN-safe sort of each chunk: NaNs last, -0.0 before +0.0; ``cache``
    defaults to ``ops.plan.default_cache``).

    >>> [r.tolist() for r in form_runs(np.asarray([3, 1, 2, 0], np.int32), 2, device="cpu")]
    [[1, 3], [0, 2]]
    """
    cache = plan.default_cache if cache is None else cache
    return [cache.get_sorter(x.shape[0], x.dtype, "sort", tune=tune, device=x.device)(x)
            for x, _ in device_chunks(data, chunk_size, device)]


def form_argsort_runs(data: Source, chunk_size: int, *,
                      cache: Optional[plan.PlanCache] = None, tune: bool = False,
                      device: Device = None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(sorted keys, global int32 source indices) device runs, one per chunk.
    Each chunk's plan-cached argsort is stable; the indices are offset into
    the concatenated stream, so merged runs give a permutation of it."""
    cache = plan.default_cache if cache is None else cache
    runs = []
    for x, offset in device_chunks(data, chunk_size, device):
        idx = cache.get_sorter(x.shape[0], x.dtype, "argsort", tune=tune, device=x.device)(x)
        runs.append((x[idx.to(torch.int64)], idx + offset))
    return runs
