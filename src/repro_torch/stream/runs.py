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

**Key dtypes.**  Every dtype of ``ops.keyspace`` streams (8/16/32/64-bit
ints and uints, float16, bfloat16, float32, float64); complex and bool
keys are refused, as the reference refuses them.  numpy's uint16, uint32
and uint64 chunks become torch's unsigned dtypes, which lack ``>``,
``searchsorted`` and ``index_put``, and an ml_dtypes ``bfloat16`` array
cannot pass through ``torch.from_numpy`` at all: such chunks move as the
signed int of their width (the bits as they are) and are viewed back as
their key dtype on the device.  The bfloat16 array is known by its dtype's
name; nothing here imports ml_dtypes.  A CPU tensor (or an iterable of
CPU tensors) is a source too, the only host form of bfloat16 keys where
ml_dtypes is absent; the entry points then return CPU tensors.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.ops import keyspace, plan
from repro_torch.ops.sort import Device, _device

__all__ = ["iter_chunks", "device_chunks", "form_runs", "form_argsort_runs", "key_dtype",
           "host_array"]

Source = Union[np.ndarray, torch.Tensor, Iterable[Union[np.ndarray, torch.Tensor]]]
Chunk = Union[np.ndarray, torch.Tensor]
MAX_INDEX = 2**31 - 1  # global indices are int32, as in the reference
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def key_dtype(dtype) -> torch.dtype:
    """The torch key dtype of a numpy (or torch) key dtype; raises for
    dtypes the keyspace does not take (complex, bool, ...), which the
    reference refuses too.

    >>> key_dtype(np.dtype(np.uint16))
    torch.uint16
    """
    tdtype = dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name,
                                                                      None)
    if not isinstance(tdtype, torch.dtype) or not keyspace.supported(tdtype):
        raise NotImplementedError(
            f"the stream takes the keyspace's key dtypes, got {dtype}; the reference "
            "refuses it too")
    return tdtype


def _host_tensor(chunk: Chunk) -> Tuple[torch.Tensor, torch.dtype]:
    """(a CPU tensor of ``chunk``'s bits that torch can copy, its key dtype):
    the chunk itself, or its bits as the signed int of its width for
    uint16/32/64 and bfloat16 chunks (view it as the key dtype on the
    device)."""
    dtype = key_dtype(chunk.dtype)
    if isinstance(chunk, torch.Tensor):
        if chunk.device.type != "cpu":
            raise ValueError(f"a stream's chunks live on the host, got one on {chunk.device}")
        return chunk.contiguous().view(_SIGNED[chunk.element_size()]), dtype
    chunk = np.ascontiguousarray(chunk)
    if dtype in (torch.uint16, torch.uint32, torch.uint64, torch.bfloat16):
        chunk = chunk.view(f"int{8 * chunk.dtype.itemsize}")
    return torch.from_numpy(chunk), dtype


def host_array(x: torch.Tensor, dtype) -> Union[np.ndarray, torch.Tensor]:
    """``x``'s keys on the host in the source's ``dtype``: a numpy array
    (an ml_dtypes bfloat16 included: ``x``'s bits as the signed int of their
    width, viewed as ``dtype``), or a CPU tensor for a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return x.cpu()
    return x.view(_SIGNED[x.element_size()]).cpu().numpy().view(dtype)


def iter_chunks(data: Source, chunk_size: int) -> Iterator[Chunk]:
    """Normalize a source into host chunk views.

    A 1-D array (or CPU tensor) yields ``chunk_size`` slices (views, no
    copies; the tail may be ragged); any other iterable is treated as
    generator-fed and passed through (each element must be a 1-D array or
    CPU tensor the caller already sized to the device).

    >>> [c.tolist() for c in iter_chunks(np.arange(5), 2)]
    [[0, 1], [2, 3], [4]]
    """
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if isinstance(data, (np.ndarray, torch.Tensor)):
        if data.ndim != 1:
            raise ValueError("array source must be 1-D")
        for lo in range(0, data.shape[0], chunk_size):
            yield data[lo : lo + chunk_size]
        return
    for chunk in data:
        if not isinstance(chunk, torch.Tensor):
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

    def put(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Enqueue the copy of the CPU tensor ``src`` to the card; returns the
        device tensor and the event its consumer must wait on."""
        slot, self.turn = self.turn, 1 - self.turn
        if self.done[slot] is not None:
            self.done[slot].synchronize()  # its previous copy has left the buffer
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
        src, dtype = _host_tensor(chunk)
        if offset + chunk.shape[0] > MAX_INDEX:
            raise ValueError("stream longer than 2^31 - 1 keys: global indices are int32")
        if staging is None:
            nxt = (src.view(dtype), None, offset)
        else:
            x, event = staging.put(src)
            nxt = (x.view(dtype), event, offset)
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
        # gathered as the signed int of their width: torch's unsigned dtypes
        # have no gather on a card
        keys = x.view(_SIGNED[x.element_size()])[idx.to(torch.int64)].view(x.dtype)
        runs.append((keys, idx + offset))
    return runs
