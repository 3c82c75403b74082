"""G1-G4: the one-device sort's glue as kernels of its own.

The reference leaves this work to XLA around its Pallas kernels, where it
fuses; these kernels are no TPU kernel's counterpart.  The CUDA source is
``csrc/glue.cu``, whose header note gives their bound (bytes) and design.
Each wrapper launches its kernel on a CUDA tensor, runs its plain torch
twin (``*_plain``: the port's eager chain, the same outputs bit for bit)
only on a CPU tensor, and on the dry run's fake tensors launches nothing
and reports its bytes to ``_build.FAKE_HOOKS``.  Each counts its launches
under its own key of ``_build.LAUNCHES``.

- G1 :func:`close_placement` (``close_placement``): K1's, K1r's and K4's
  epilogue, the (rows, tiles, nb) tile histograms and in-tile ranks to the
  row-local destinations and offsets (the reference's ``_close_placement``,
  ``src/repro/kernels/level_fused.py:139``).  Three launches a call.
- G2 :func:`segment_ids` (``segment_ids``): each position's bucket or
  segment from (nb+1,) or (rows, nb+1) offsets (``src/repro/core/ips4o.py:229``).
- G3 :func:`composite_ids` (``composite_ids``, ``composite_ids64`` for
  int64 keys): level 2's ids ``seg * 2k + local``, the segment of G2 and
  the local id of ``classify.tree.classify_segmented`` or
  ``classify.radix.radix_bucket_ids``, in one pass.
- G6 :func:`sample_splitters` (``sample_splitters``): the level passes'
  samples, from the drawn positions (level 1) or uniforms (level 2) to the
  sorted splitters of each (row, segment), and level 1's upper form with
  its sentinel (``src/repro/core/ips4o.py:356-360``, ``:442-449``, batched
  ``:679-684``, ``:758-768``).  One launch a call.
- G4, two move kernels that each move every tensor of the arrays in one
  launch (a table of up to :data:`MAX_MOVE` tensors in the kernel's
  parameters): :func:`scatter_rows` (``scatter_rows``), ``out[dest[i]] =
  a[i]`` by row-local int32 positions (the level passes' ``.at[dest].set``),
  and :func:`gather_windows` (``gather_windows``), the base case's window
  gather by K3's permutation, in place for pass two.  Rows of any byte
  width: bool, bfloat16, ``(n, c)`` leaves, records' words.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.classify import classify_segmented, radix_bucket_ids, radix_shift
from repro_torch.core import sampling
from repro_torch.kernels import _build

__all__ = [
    "close_placement",
    "close_placement_plain",
    "segment_ids",
    "segment_ids_plain",
    "composite_ids",
    "composite_ids_plain",
    "scatter_rows",
    "scatter_rows_plain",
    "gather_windows",
    "gather_windows_plain",
    "sample_splitters",
    "sample_splitters_plain",
    "move_unit",
    "stage_plan",
    "gather_plan",
    "RUN_TILES",
    "STAGE_BYTES",
    "MAX_MOVE",
    "SCATTER_SPAN",
    "ROW_WINDOW_BYTES",
]

RUN_TILES = 16  # G1: tiles a run of its column sums (csrc/glue.cu's kRunTiles)
STAGE_BYTES = 65536  # G4: a span's or a window's slice in shared memory, at most (kStageBytes)
MAX_MOVE = 64  # G4: tensors one launch moves (kMaxMove)
SCATTER_SPAN = 4096  # G4's scatter: source rows a span (kScatterSpan)
ROW_WINDOW_BYTES = 131072  # G4's scatter: a span whose destinations lie closer moves row by row

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "glue_close_placement": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "glue_segment_ids": (_P, _I, _I, _I, _P, _P),
    "glue_composite_ids": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "glue_scatter": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "glue_gather_windows": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "glue_sample_splitters": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
}
MAX_SAMPLE = 16384  # G6: the largest sample a (row, segment) it sorts in shared memory
Arrays = Dict[str, torch.Tensor]


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def _lib():
    return _build.library("glue", _SIGNATURES)


def _launch(name: str, err: int) -> None:
    _build.check(_lib(), "glue", err, f"{name} kernel")
    _build.LAUNCHES[name] += 1


def _need(x: torch.Tensor, what: str, dtypes=(torch.int32,), dim: Optional[int] = None) -> None:
    if x.dtype not in dtypes or not x.is_contiguous() or (dim is not None and x.dim() != dim):
        raise ValueError(f"{what}: expected a contiguous {'' if dim is None else f'{dim}-D '}"
                         f"{' or '.join(map(str, dtypes))} tensor, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.numel() >= 2**31:
        raise ValueError(f"{what}: {x.numel()} elements exceed int32 positions")


# ---------------------------------------------------------------------------
# G1: the placement close of K1, K1r and K4


def cumsum_rows(hist: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum of a (..., rows, nb) histogram down its rows.
    Taken along the inner dim of a transposed copy: PyTorch's int32 scan
    along the outer dim took 1.1 ms at (4096, 257) on the H100 (PERF.md)."""
    return torch.cumsum(hist.transpose(-1, -2).contiguous(), -1,
                        dtype=torch.int32).transpose(-1, -2)


def close_placement_plain(
    bucket: torch.Tensor, rank: torch.Tensor, hist: torch.Tensor, nb: int, tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """G1's plain torch twin on any device: prefix-sum the (B, tiles, nb)
    histograms and place every element of the (B, n) rows,
    dest = offsets[row, b] + tile_off[row, t, b] + rank (row-local)."""
    B, n = bucket.shape
    tiles = hist.shape[1]
    dev = bucket.device
    offsets = torch.zeros((B, nb + 1), dtype=torch.int32, device=dev)
    offsets[:, 1:] = torch.cumsum(hist.sum(1, dtype=torch.int32), 1, dtype=torch.int32)
    tile_off = cumsum_rows(hist) - hist
    base = (offsets[:, None, :-1] + tile_off).reshape(B, tiles * nb)
    t_idx = torch.arange(n, dtype=torch.int64, device=dev) // tile
    dest = torch.gather(base, 1, t_idx * nb + bucket.to(torch.int64)) + rank
    return dest, offsets


def close_placement(
    bucket: torch.Tensor, rank: torch.Tensor, hist: torch.Tensor, nb: int, tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's, K1r's and K4's epilogue over (B, n) ``bucket`` ids in [0, nb),
    in-tile ``rank`` and the (B, ceil(n / tile), nb) tile histograms, all
    int32: (dest (B, n), offsets (B, nb+1)), row-local.  The G1 kernels on a
    CUDA tensor, :func:`close_placement_plain` on a CPU tensor."""
    B, n = bucket.shape
    if _build.is_fake(bucket):
        _build.note_fake("close_placement", 0.0, 12.0 * bucket.numel() + 8.0 * hist.numel())
        return torch.empty_like(bucket), bucket.new_empty((B, nb + 1))
    if not _on_card(bucket):
        return close_placement_plain(bucket, rank, hist, nb, tile)
    for x, what in ((bucket, "bucket"), (rank, "rank"), (hist, "hist")):
        _need(x, f"close_placement {what}")
    tiles = -(-n // tile)
    if rank.shape != bucket.shape or hist.shape != (B, tiles, nb):
        raise ValueError(f"close_placement: rank {tuple(rank.shape)} and hist "
                         f"{tuple(hist.shape)} do not fit bucket {tuple(bucket.shape)}, "
                         f"tile {tile}, nb {nb}")
    if n == 0:  # no position: nothing to place, every offset 0
        return torch.empty_like(bucket), torch.zeros((B, nb + 1), dtype=torch.int32,
                                                     device=bucket.device)
    # one allocation: the runs' counts, then the buckets' totals
    sizes = (B * -(-tiles // RUN_TILES) * nb, B * nb)
    part, totals = torch.empty(sum(sizes), dtype=torch.int32,
                               device=bucket.device).split(sizes)
    dest = torch.empty_like(bucket)
    offsets = torch.empty((B, nb + 1), dtype=torch.int32, device=bucket.device)
    err = _lib().glue_close_placement(
        bucket.data_ptr(), rank.data_ptr(), hist.data_ptr(), B, n, tile, nb, part.data_ptr(),
        totals.data_ptr(), offsets.data_ptr(), dest.data_ptr(),
        _build.stream_handle(bucket.device))
    _launch("close_placement", err)
    return dest, offsets


# ---------------------------------------------------------------------------
# G2: segment ids


def segment_ids_plain(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """G2's plain torch twin on any device: an ``arange`` and a right
    ``searchsorted``, less one."""
    pos = torch.arange(n, dtype=torch.int32, device=offsets.device)
    if offsets.dim() == 2:
        pos = pos.expand(offsets.shape[0], n).contiguous()
    return (torch.searchsorted(offsets, pos, right=True) - 1).to(torch.int32)


def segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Per-position bucket/segment id (n,) int32 from nondecreasing (nb+1,)
    int32 offsets, the last j with offsets[j] <= position (-1 if none); for
    (B, nb+1) offsets, (B, n) ids per row.  Any nb, empty buckets
    included.  The G2 kernel on a CUDA tensor, :func:`segment_ids_plain` on
    a CPU tensor."""
    if _build.is_fake(offsets):
        lead = offsets.shape[:-1]
        _build.note_fake("segment_ids", 0.0, 4.0 * n * max(1, math.prod(lead))
                         + 4.0 * offsets.numel())
        return offsets.new_empty(tuple(lead) + (n,))
    if not _on_card(offsets):
        return segment_ids_plain(offsets, n)
    if offsets.dim() not in (1, 2):
        raise ValueError(f"segment_ids: offsets must be (nb+1,) or (B, nb+1), got "
                         f"{tuple(offsets.shape)}")
    off2 = (offsets[None] if offsets.dim() == 1 else offsets).contiguous()
    _need(off2, "segment_ids offsets")
    rows, m = off2.shape
    if rows * n >= 2**31:
        raise ValueError(f"segment_ids: {rows} x {n} positions exceed int32 positions")
    out = torch.empty((rows, n), dtype=torch.int32, device=offsets.device)
    err = _lib().glue_segment_ids(off2.data_ptr(), rows, m, n, out.data_ptr(),
                                  _build.stream_handle(offsets.device))
    _launch("segment_ids", err)
    return out[0] if offsets.dim() == 1 else out


# ---------------------------------------------------------------------------
# G3: level 2's composite ids


def composite_ids_plain(
    keys: torch.Tensor, seg_offsets: torch.Tensor, num_seg: int, k: int,
    splitters: Optional[torch.Tensor] = None, consumed_bits: int = 0,
) -> torch.Tensor:
    """G3's plain torch twin on any device: :func:`segment_ids_plain`, then
    the flattened ``classify_segmented`` over one global segment per (row,
    segment), or the radix bits past ``consumed_bits`` when ``splitters``
    is None; ``seg * 2k + local``."""
    B, n = keys.shape
    seg = segment_ids_plain(seg_offsets, n)
    if splitters is None:
        # no sample: within a radix-aligned segment the next bits are monotone
        return seg * (2 * k) + radix_bucket_ids(keys, k, consumed_bits)
    # (row, segment) -> one global segment for the flattened classifier
    gseg = seg
    if B > 1:
        gseg = seg + torch.arange(B, dtype=torch.int32, device=keys.device)[:, None] * num_seg
    local = classify_segmented(
        keys.reshape(-1), gseg.reshape(-1), splitters.reshape(B * num_seg, k - 1), k,
    ).reshape(B, n)
    return seg * (2 * k) + local


def composite_ids(
    keys: torch.Tensor, seg_offsets: torch.Tensor, num_seg: int, k: int,
    splitters: Optional[torch.Tensor] = None, consumed_bits: int = 0,
) -> torch.Tensor:
    """Level 2's row-local composite ids (B, n) int32 of encoded int32 or
    int64 ``keys`` (B, n) with (B, num_seg+1) int32 ``seg_offsets`` (each
    row from 0 to n): ``seg * 2k + local``, local by each segment's sorted
    ``splitters`` (B, num_seg, k-1) of the keys' dtype, or by the radix
    bits past ``consumed_bits`` when ``splitters`` is None.  The G3 kernel
    on a CUDA tensor (``composite_ids64`` for int64 keys),
    :func:`composite_ids_plain` on a CPU tensor."""
    B, n = keys.shape
    wide = "64" if keys.dtype == torch.int64 else ""
    if _build.is_fake(keys):
        _build.note_fake("composite_ids" + wide, 0.0,
                         (keys.element_size() + 4.0) * keys.numel() + 4.0 * seg_offsets.numel())
        return keys.new_empty((B, n), dtype=torch.int32)
    if not _on_card(keys):
        return composite_ids_plain(keys, seg_offsets, num_seg, k, splitters, consumed_bits)
    if k < 2 or k & (k - 1):
        raise ValueError(f"k={k} must be a power of two >= 2")
    _need(keys, "composite_ids keys", (torch.int32, torch.int64), 2)
    seg_offsets = seg_offsets.contiguous()
    _need(seg_offsets, "composite_ids seg_offsets", dim=2)
    if seg_offsets.shape != (B, num_seg + 1):
        raise ValueError(f"composite_ids: seg_offsets {tuple(seg_offsets.shape)} != "
                         f"({B}, {num_seg + 1})")
    if B * num_seg * 2 * k >= 2**31:
        raise ValueError(f"composite_ids: {num_seg} segments x 2k = {2 * k} exceed int32 ids")
    shift = 0
    if splitters is None:
        shift = radix_shift(k, consumed_bits, 64 if wide else 32)
    else:
        splitters = splitters.contiguous()
        if splitters.shape != (B, num_seg, k - 1) or splitters.dtype != keys.dtype:
            raise ValueError(f"composite_ids: splitters {tuple(splitters.shape)} "
                             f"{splitters.dtype}, expected ({B}, {num_seg}, {k - 1}) {keys.dtype}")
    out = torch.empty((B, n), dtype=torch.int32, device=keys.device)
    err = _lib().glue_composite_ids(
        keys.data_ptr(), 64 if wide else 32, seg_offsets.data_ptr(),
        None if splitters is None else splitters.data_ptr(), B, num_seg, n, k, shift,
        out.data_ptr(), _build.stream_handle(keys.device))
    _launch("composite_ids" + wide, err)
    return out


# ---------------------------------------------------------------------------
# G4: the move kernel


def move_unit(row_bytes: int, *pointers: int) -> int:
    """The bytes G4 moves at once: the largest power of two up to 16 that
    divides a row's bytes and every pointer."""
    unit = 16
    while unit > 1 and (row_bytes % unit or any(p % unit for p in pointers)):
        unit //= 2
    return unit


def _row_bytes(a: torch.Tensor, lead: int) -> int:
    return a.element_size() * math.prod(a.shape[lead:])


def stage_plan(row_bytes: int, rows: int, *pointers: int) -> Tuple[int, int]:
    """G4's (unit, chunk) for a stage of ``rows`` rows (a scatter's span or a
    window): the bytes it moves at once (:func:`move_unit`, shrunk where
    ``rows`` whole units would not fit ``STAGE_BYTES``) and the units of
    every row it stages at once, so that the stage fits ``STAGE_BYTES``."""
    unit = move_unit(row_bytes, *pointers)
    unit = min(unit, 1 << max(0, (STAGE_BYTES // rows).bit_length() - 1))
    return unit, max(1, min(row_bytes // unit, STAGE_BYTES // (rows * unit)))


def gather_plan(row_bytes: int, W: int, *pointers: int) -> Tuple[int, int]:
    """The window gather's (unit, chunk): :func:`stage_plan` for windows of
    W rows (both passes stage every window)."""
    return stage_plan(row_bytes, W, *pointers)


def _table(entries) -> tuple:
    """The C table of one launch from (src, dst, unit, w, chunk) entries:
    count and five columns (csrc/glue.cu ``MoveTable``)."""
    k = len(entries)
    return (k,) + tuple((kind * k)(*[e[i] for e in entries])
                        for i, kind in enumerate((ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_int)))


def _groups(items):
    return [items[i:i + MAX_MOVE] for i in range(0, len(items), MAX_MOVE)]


def scatter_rows_plain(arrays: Arrays, dest: torch.Tensor,
                       offsets: Optional[torch.Tensor] = None) -> Arrays:
    """G4's scatter's plain torch twin on any device: an int64 copy of
    ``dest`` (with the rows' offsets for (B, n)) and ``index_put`` a
    tensor; ``offsets`` changes nothing."""
    lead = dest.dim()
    d = dest.to(torch.int64)
    if lead == 2:
        B, n = d.shape
        d = (d + torch.arange(B, dtype=torch.int64, device=d.device)[:, None] * n).reshape(-1)
    out = {}
    for name, a in arrays.items():
        flat = a.reshape((-1,) + tuple(a.shape[lead:]))
        o = torch.empty_like(flat)
        o[d] = flat
        out[name] = o.view(a.shape)
    return out


def scatter_rows(arrays: Arrays, dest: torch.Tensor,
                 offsets: Optional[torch.Tensor] = None) -> Arrays:
    """Move every tensor by the destinations, out[dest[i]] = a[i]: ``dest``
    (n,) int32, or (B, n) row-local (each row moves within itself), a
    permutation of each row; every tensor has ``dest``'s leading dims and
    any trailing dims and dtype.  Returns new tensors.  The G4 scatter on a
    CUDA tensor, one launch for every tensor (one more each further
    :data:`MAX_MOVE`): ``dest`` is read once a span of
    :data:`SCATTER_SPAN` source rows for all of them.
    :func:`scatter_rows_plain` on a CPU tensor.

    ``offsets`` ((nb+1,) or (B, nb+1) int32) says that ``dest`` is the
    stable placement with these bucket offsets (a level pass's): the
    kernel then groups each span's rows by bucket and writes a bucket's
    rows together, runs of consecutive destinations (each row still goes
    to its own destination, so any permutation moves right), except where
    the span's destinations lie within :data:`ROW_WINDOW_BYTES` of the
    widest tensor's rows of each other (found where the row has more than
    1024 buckets).  Without, row by row."""
    lead = dest.dim()
    if _build.is_fake(dest):
        moved = [a for a in arrays.values() if a.numel()]
        for group in _groups(moved):
            _build.note_fake("scatter_rows", 0.0, sum(2.0 * a.numel() * a.element_size()
                                                      for a in group) + 4.0 * dest.numel())
        return {name: torch.empty_like(a) for name, a in arrays.items()}
    if not _on_card(dest):
        return scatter_rows_plain(arrays, dest, offsets)
    dest = dest.contiguous()
    _need(dest, "scatter_rows dest")
    n = dest.shape[-1] if lead else 1
    rows = dest.numel() // n if n else 0
    if offsets is not None:
        offsets = offsets.contiguous()
        _need(offsets, "scatter_rows offsets")
        if offsets.shape[:-1] != dest.shape[:-1]:
            raise ValueError(f"scatter_rows: offsets {tuple(offsets.shape)} do not fit dest "
                             f"{tuple(dest.shape)}")
    out, items = {}, []
    for name, a in arrays.items():
        if tuple(a.shape[:lead]) != tuple(dest.shape) or a.device != dest.device:
            raise ValueError(f"scatter_rows {name}: {tuple(a.shape)} on {a.device} does not "
                             f"lead with dest's {tuple(dest.shape)} on {dest.device}")
        a = a.contiguous()
        out[name] = o = torch.empty_like(a)
        row = _row_bytes(a, lead)
        if row and dest.numel():
            items.append((a, o, row))
    if not items:
        return out
    for group in _groups(items):
        entries = []
        for a, o, row in group:
            unit, chunk = stage_plan(row, SCATTER_SPAN, a.data_ptr(), o.data_ptr())
            entries.append((a.data_ptr(), o.data_ptr(), unit, row // unit, chunk))
        stage = max(SCATTER_SPAN * e[2] * e[4] for e in entries)
        err = _lib().glue_scatter(
            *_table(entries), dest.data_ptr(), None if offsets is None else offsets.data_ptr(),
            0 if offsets is None else offsets.shape[-1], rows, n, -(-stage // 16) * 16,
            _build.stream_handle(dest.device))
        _launch("scatter_rows", err)
    return out


def _window_shape(src: torch.Tensor, perm: torch.Tensor) -> Tuple[int, int, int, int]:
    B, n = src.shape[:2]
    num_w, W = perm.shape
    if num_w % B:
        raise ValueError(f"gather_windows: {num_w} windows do not split over {B} rows")
    return B, n, num_w // B, W


def gather_windows_plain(src: torch.Tensor, perm: torch.Tensor, lo: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G4's window gather's plain torch twin on any device: int64 source
    positions from the window starts and ``perm``, one index gather."""
    B, n, per_row, W = _window_shape(src, perm)
    m = per_row * W
    starts = torch.arange(lo, lo + m, W, dtype=torch.int64, device=src.device)
    if B > 1:  # row r's windows start r * n further on
        starts = (torch.arange(0, B * n, n, dtype=torch.int64, device=src.device)[:, None]
                  + starts).reshape(-1)
    idx = (perm.to(torch.int64) + starts[:, None]).reshape(-1)
    got = src.reshape((B * n,) + src.shape[2:])[idx].reshape((B, m) + src.shape[2:])
    if out is None:
        return got
    out[:, lo:lo + m] = got
    return out


def gather_windows(arrays: Arrays, perm: torch.Tensor, lo: int,
                   out: Optional[Arrays] = None) -> Arrays:
    """The base case's window gather of every tensor: for (B, n, ...)
    tensors and K3's window-local (B * per_row, W) int32 ``perm``, the
    windows of each row from position ``lo`` (per_row of them, never past
    the row's end), each gathered by its permutation.  With ``out`` (a
    tensor of each one's shape and dtype under its name; the tensor itself
    for an in-place pass) writes them into ``out[name][:, lo:lo + per_row
    * W]`` and returns ``out``; without, the windows must cover the rows
    from 0, and the gathers are returned.  The G4 gather on CUDA tensors,
    one launch for every tensor (one more each further :data:`MAX_MOVE`):
    each window is staged in shared memory, all of it read before any of
    it is written; :func:`gather_windows_plain` a tensor on the CPU."""
    if not arrays:
        return {} if out is None else out
    first = next(iter(arrays.values()))
    B, n, per_row, W = _window_shape(first, perm)
    for name, a in arrays.items():
        if a.shape[:2] != first.shape[:2] or a.device != first.device:
            raise ValueError(f"gather_windows {name}: {tuple(a.shape)} on {a.device} does not "
                             f"lead with {tuple(first.shape[:2])} on {first.device}")
    if lo < 0 or lo + per_row * W > n:
        raise ValueError(f"gather_windows: windows [{lo}, {lo + per_row * W}) exceed rows of {n}")
    if out is None and (lo or per_row * W != n):
        raise ValueError("gather_windows: new tensors take windows over whole rows; pass out "
                         "for the others")
    if _build.is_fake(first):
        moved = [a for a in arrays.values() if a.numel()]
        for group in _groups(moved):
            _build.note_fake("gather_windows", 0.0, sum(
                2.0 * B * per_row * W * _row_bytes(a, 2) for a in group) + 4.0 * perm.numel())
        if out is None:
            return {name: a.new_empty((B, per_row * W) + tuple(a.shape[2:]))
                    for name, a in arrays.items()}
        return out
    if not _on_card(first):
        return {name: gather_windows_plain(a, perm, lo, None if out is None else out[name])
                for name, a in arrays.items()}
    perm = perm.contiguous()
    _need(perm, "gather_windows perm", dim=2)
    result, items = {}, []
    for name, src in arrays.items():
        if out is None:
            src = src.contiguous()
            dst = torch.empty_like(src)
        else:
            dst = out[name]
            if dst.shape != src.shape or dst.dtype != src.dtype or not dst.is_contiguous():
                raise ValueError(f"gather_windows {name}: out {tuple(dst.shape)} {dst.dtype} "
                                 f"must be a contiguous tensor of src's shape "
                                 f"{tuple(src.shape)} {src.dtype}")
            if dst.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
                if dst.data_ptr() != src.data_ptr():
                    raise ValueError(f"gather_windows {name} in place: out must be src itself")
            else:
                src = src.contiguous()
        result[name] = dst
        row = _row_bytes(src, 2)
        if row and perm.numel():
            items.append((src, dst, row))
    for group in _groups(items):
        entries = []
        for src, dst, row in group:
            unit, chunk = gather_plan(row, W, src.data_ptr(), dst.data_ptr())
            entries.append((src.data_ptr(), dst.data_ptr(), unit, row // unit, chunk))
        stage = max(W * e[2] * e[4] for e in entries)
        err = _lib().glue_gather_windows(
            *_table(entries), perm.data_ptr(), B * per_row, per_row, n, W, lo,
            -(-stage // 16) * 16, _build.stream_handle(first.device))
        _launch("gather_windows", err)
    return result


# ---------------------------------------------------------------------------
# G6: the level passes' samples


def _upper_plain(spl: torch.Tensor) -> torch.Tensor:
    sent = torch.full(spl.shape[:-1] + (1,), sampling.sentinel_for(spl.dtype),
                      dtype=spl.dtype, device=spl.device)
    return torch.cat([spl, sent], -1)


def sample_splitters_plain(keys: torch.Tensor, draw: torch.Tensor, k: int,
                           seg_offsets: Optional[torch.Tensor] = None, upper: bool = False):
    """G6's plain torch twin on any device: the gather of the sample, a
    ``torch.sort`` and ``sampling.select_splitters``; at level 2 the
    positions from ``sampling.positions_from_uniform`` first, clamped to
    the row (an empty last segment's lo is n); the upper form by a fill and
    a ``cat``."""
    B, n = keys.shape
    if seg_offsets is None:
        sample = torch.sort(torch.gather(keys, 1, draw), dim=1).values
    else:
        S, m = draw.shape[1:]
        pos = sampling.positions_from_uniform(draw, seg_offsets[:, :-1], seg_offsets[:, 1:])
        pos = pos.reshape(B, S * m).clamp_(max=n - 1)
        sample = torch.sort(torch.gather(keys, 1, pos).reshape(B, S, m), dim=-1).values
    spl = sampling.select_splitters(sample, k)
    return (spl, _upper_plain(spl)) if upper else spl


def sample_splitters(keys: torch.Tensor, draw: torch.Tensor, k: int,
                     seg_offsets: Optional[torch.Tensor] = None, upper: bool = False):
    """The sorted splitters of each row of encoded int32 or int64 ``keys``
    (B, n) from a drawn sample: level 1 (``seg_offsets`` None) takes
    ``draw`` (B, m) int64 positions and returns (B, k-1) splitters; level 2
    takes ``draw`` (B, S, m) float32 uniforms in [0, 1), maps them into each
    of the S segments of ``seg_offsets`` (B, S+1) int32 as
    ``sampling.sample_indices`` does, and returns (B, S, k-1).  The
    splitters are the sorted sample's ``clip(j m // k, 0, m-1)``-th values
    (``sampling.select_splitters``).  ``upper`` also returns the (B, k)
    upper form (level 1), the sentinel last, as K1 and K4 take it.  The G6
    kernel on a CUDA tensor (one launch), :func:`sample_splitters_plain` on
    a CPU tensor."""
    B, n = keys.shape
    level2 = seg_offsets is not None
    S = draw.shape[1] if level2 else 1
    m = draw.shape[-1]
    out_shape = (B, S, k - 1) if level2 else (B, k - 1)
    if upper and level2:
        raise ValueError("sample_splitters: the upper form is level 1's")
    if _build.is_fake(keys):
        _build.note_fake("sample_splitters", 0.0, draw.numel() * (keys.element_size()
                                                                  + draw.element_size()))
        spl = keys.new_empty(out_shape)
        return (spl, keys.new_empty((B, k))) if upper else spl
    if not _on_card(keys):
        return sample_splitters_plain(keys, draw, k, seg_offsets, upper)
    _need(keys, "sample_splitters keys", (torch.int32, torch.int64), 2)
    if k < 2 or m < 1 or m > MAX_SAMPLE or n < 1:
        raise ValueError(f"sample_splitters: k={k}, m={m} (at most {MAX_SAMPLE}), n={n}")
    draw = draw.contiguous()
    if level2:
        seg_offsets = seg_offsets.contiguous()
        _need(seg_offsets, "sample_splitters seg_offsets", dim=2)
        if draw.dtype != torch.float32 or draw.shape != (B, S, m) or \
                seg_offsets.shape != (B, S + 1):
            raise ValueError(f"sample_splitters: uniforms {tuple(draw.shape)} {draw.dtype} and "
                             f"offsets {tuple(seg_offsets.shape)} do not fit ({B}, S, m)")
    elif draw.dtype != torch.int64 or draw.shape != (B, m):
        raise ValueError(f"sample_splitters: positions {tuple(draw.shape)} {draw.dtype}, "
                         f"expected ({B}, m) int64")
    spl = torch.empty(out_shape, dtype=keys.dtype, device=keys.device)
    up = torch.empty((B, k), dtype=keys.dtype, device=keys.device) if upper else None
    err = _lib().glue_sample_splitters(
        keys.data_ptr(), 64 if keys.dtype == torch.int64 else 32, n,
        None if level2 else draw.data_ptr(), draw.data_ptr() if level2 else None,
        seg_offsets.data_ptr() if level2 else None, B, S, m, k, spl.data_ptr(),
        None if up is None else up.data_ptr(), _build.stream_handle(keys.device))
    _launch("sample_splitters", err)
    return (spl, up) if upper else spl
