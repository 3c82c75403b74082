"""K1 ``level_fused`` (tree and radix modes), K2 ``rank_hist`` and their
batched forms K4: the fused level pass.

Counterpart of ``repro.kernels.level_fused`` (the Pallas TPU kernels at
``level_fused.py:160``, ``:240``, ``:311`` and ``:364``).  The CUDA kernels
are in ``csrc/level_fused.cu``, whose header note gives their bound and
design.  Each wrapper launches its kernel on a CUDA tensor and runs its
plain torch twin (``*_plain``, same outputs bit for bit) only on a CPU
tensor; there is no fallback from one to the other.  Each counts its
launches under its own key of ``_build.LAUNCHES``.

K1 ``level_fused``: classify each key against the k-1 sorted splitters
(tree mode, key ``level_fused``) or by its next log2(k) bits (radix mode,
K1r, key ``level_fused_radix``), route positions >= n_real to the pad
bucket 2k, and rank each key stably within its tile; the epilogue
``kernels.glue.close_placement`` (XLA in the reference; the G1 kernels here,
its torch chain their plain twin) turns the per-tile ranks and histogram
into the global destinations and bucket offsets.  K4 ``level_fused_batched`` (key ``level_fused_batched``)
is the same over (B, n) rows, each row with its own splitters or the shared
radix shift, its own pads and its own placement.  The three take int32 or
int64 codes (``ops.keyspace``): the CUDA kernel is templated on the key
type, and its 64-bit form counts under the same keys with ``64`` appended
(``level_fused64``, ``level_fused_radix64``, ``level_fused_batched64``).

K2 ``rank_hist``: the stable counting placement over given ids in
[0, nb).  With ``seg_offsets`` it takes level 2's composite ids
``seg * seg_width + local`` at any nb: work items of at most ``tile``
positions never straddle a segment, and each is counted and ranked over
``seg_width`` counters.  On the card the placement is closed there too,
in four launches from one C call (items, count, per-segment scan, rank;
:func:`segment_schedule` gives their shape), with no torch op over the n
elements and no host read.  The plain twin cuts the items with
:func:`_items`, ranks them in torch and closes the placement with
:func:`_close_segments`.  K4 ``rank_hist_batched`` (key
``rank_hist_batched``) is the same per row of (B, n) ids: the kernels take
a row dimension, the twin flattens the rows into B x num_seg segments.

All return destinations and offsets bit-identical to the stable counting
placement of ``core.partition.partition_permutation`` (per row for the
batched forms): scattering ``a[i] -> dest[i]`` groups a payload by bucket,
stably.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.classify import CLASSIFIERS, classify_batched, radix_bucket_ids, radix_shift
from repro_torch.core.sampling import sentinel_for
from repro_torch.kernels import _build
from repro_torch.kernels.glue import close_placement, cumsum_rows as _cumsum_rows

__all__ = [
    "launch_info",
    "level_fused",
    "level_fused_plain",
    "level_fused_batched",
    "level_fused_batched_plain",
    "rank_hist",
    "rank_hist_plain",
    "rank_hist_batched",
    "rank_hist_batched_plain",
    "segment_launch_info",
    "segment_schedule",
    "TILE",
    "MAX_TILE",
    "MAX_TILE64",
    "MAX_NB",
]

TILE = 4096  # default keys per CTA (K1) or per work item (K2)
MAX_TILE = 16384  # K1: 32 warps of 512 positions; K2: 8 warps, 4 batches of 512 each
MAX_TILE64 = 8192  # K1's 64-bit form: 32 warps of 256 positions (8 chunks of 8-byte keys)
MAX_NB = 2048  # K2's counters per CTA: 8 warps x MAX_NB x 6 B of shared memory
RANK_SPAN = 512  # positions a warp of K2's count and rank CTAs takes at once (16 chunks)
RANK_WARPS = 8  # at most, a CTA of K2's count and rank
SMALL_WIDTH = 32  # up to this W2, K2's count and rank take a warp per item, in registers
SCAN_THREADS = 1024  # at most, a team of K2's per-segment scan

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "level_fused_tree": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "level_fused_radix": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "level_fused_batched": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "level_fused_tree64": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "level_fused_radix64": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "level_fused_batched64": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "level_fused_segment_place": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                  _P),
    "level_fused_info": (_I, _I, _I, _P),
    "level_fused_info64": (_I, _I, _I, _P),
    "level_fused_segment_info": (_I, _I, _P),
}


def _check_ids(x: torch.Tensor, what: str, dim: int = 1) -> None:
    if x.dim() != dim or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dim}-D int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.numel() >= 2**31:
        raise ValueError(f"{what}: {x.numel()} elements exceed int32 positions")


def _check_tile(tile: int, nb: int, max_tile: int = MAX_TILE) -> None:
    if not 0 < tile <= max_tile:
        raise ValueError(f"tile={tile} must be in (0, {max_tile}]")
    if nb > MAX_NB:
        raise ValueError(f"{nb} counters per tile exceed MAX_NB={MAX_NB}")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# plain building blocks (shared by the CPU path and the kernels' twins)


def _slot_rank_hist(slot: torch.Tensor, num_slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable rank of each element among the earlier elements of its slot,
    and the count per slot: the plain form of the kernels' in-tile pass."""
    n = slot.shape[0]
    s64 = slot.to(torch.int64)
    order = torch.sort(s64, stable=True).indices
    counts = torch.bincount(s64, minlength=num_slots).to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank = torch.empty(n, dtype=torch.int32, device=slot.device)
    pos = torch.arange(n, dtype=torch.int32, device=slot.device)
    rank[order] = pos - starts[s64[order]]
    return rank, counts


# ---------------------------------------------------------------------------
# K1, K1r and K4 level_fused_batched


def _upper(splitters: torch.Tensor) -> torch.Tensor:
    """(B, k-1) splitters -> (B, k) uppers, the last the sentinel."""
    sent = torch.full((splitters.shape[0], 1), sentinel_for(splitters.dtype),
                      dtype=splitters.dtype, device=splitters.device)
    return torch.cat([splitters, sent], 1).contiguous()


def _level_tiles_plain(keys, splitters, k, n_real, tile, consumed_bits=0):
    """(bucket, in-tile rank, (B, tiles, nb) histogram) of (B, n) keys: what
    the K1/K1r/K4 kernels write, in plain torch.  ``splitters`` (B, k-1)
    selects tree mode, None radix mode."""
    B, n = keys.shape
    nb = 2 * k + 1
    if splitters is None:
        bucket = radix_bucket_ids(keys, k, consumed_bits)
    else:
        bucket = classify_batched(keys, splitters, k)
    bucket[:, n_real:] = 2 * k
    tiles = -(-n // tile)
    t_idx = (torch.arange(B, dtype=torch.int64, device=keys.device)[:, None] * tiles
             + torch.arange(n, dtype=torch.int64, device=keys.device) // tile)
    rank, counts = _slot_rank_hist((t_idx * nb + bucket).reshape(-1), B * tiles * nb)
    return bucket, rank.reshape(B, n), counts.reshape(B, tiles, nb)


def _level_tiles_kernel(keys, splitters, k, n_real, tile, consumed_bits=0, batched=False,
                        upper=None):
    """The same three outputs from the CUDA kernel: K4 when ``batched``,
    else K1 (tree) or K1r (radix) on the one row of ``keys`` (1, n); the
    kernel's 64-bit form for int64 keys."""
    B, n = keys.shape
    nb = 2 * k + 1
    tiles = -(-n // tile)
    radix = splitters is None
    wide = "64" if keys.dtype == torch.int64 else ""
    shift = radix_shift(k, consumed_bits, 64 if wide else 32) if radix else 0
    if not radix and upper is None:
        upper = _upper(splitters)
    bucket = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    rank = torch.empty_like(bucket)
    hist = torch.empty((B, tiles, nb), dtype=torch.int32, device=keys.device)
    outs = (bucket.data_ptr(), rank.data_ptr(), hist.data_ptr(),
            _build.stream_handle(keys.device))
    lib = _build.library("level_fused", _SIGNATURES)
    if batched:
        name = "level_fused_batched"
        err = getattr(lib, name + wide)(
            keys.data_ptr(), None if radix else upper.data_ptr(), B, n, n_real, k,
            int(radix), shift, tile, *outs)
    elif radix:
        name = "level_fused_radix"
        err = getattr(lib, name + wide)(keys.data_ptr(), n, n_real, k, shift, tile, *outs)
    else:
        name = "level_fused"
        err = getattr(lib, "level_fused_tree" + wide)(keys.data_ptr(), upper.data_ptr(), n,
                                                      n_real, k, tile, *outs)
    _build.check(lib, "level_fused", err, f"{name + wide} kernel")
    _build.LAUNCHES[name + wide] += 1
    return bucket, rank, hist


def launch_info(k: int, tile: int = TILE, radix: bool = False, key_bits: int = 32) -> dict:
    """The K1/K1r/K4 kernel's launch at (k, tile, mode) for 32- or 64-bit
    keys, from the CUDA runtime (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): registers per
    thread, static and dynamic shared memory per CTA in bytes, threads per
    CTA, CTAs an SM holds at once and local memory per thread in bytes
    (spills).  Builds and loads the library; needs a card."""
    _check_tile(tile, 2 * k + 1, MAX_TILE64 if key_bits == 64 else MAX_TILE)
    out = (ctypes.c_int * 6)()
    lib = _build.library("level_fused", _SIGNATURES)
    info = lib.level_fused_info64 if key_bits == 64 else lib.level_fused_info
    _build.check(lib, "level_fused", info(k, int(radix), tile, ctypes.addressof(out)),
                 "level_fused kernel")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads", "ctas_per_sm",
                     "local_bytes"), out))


def _level_args(keys, splitters, k, n_real, tile, classifier, dim):
    if keys.dim() != dim or keys.dtype not in (torch.int32, torch.int64) or \
            not keys.is_contiguous():
        raise ValueError(f"level_fused keys: expected a contiguous {dim}-D int32 or int64 "
                         f"tensor, got {tuple(keys.shape)} {keys.dtype}")
    if keys.numel() >= 2**31:
        raise ValueError(f"level_fused keys: {keys.numel()} elements exceed int32 positions")
    if k < 2 or k & (k - 1):
        raise ValueError(f"k={k} must be a power of two >= 2")
    _check_tile(tile, 2 * k + 1, MAX_TILE64 if keys.dtype == torch.int64 else MAX_TILE)
    n = keys.shape[-1]
    n_real = n if n_real is None else n_real
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real={n_real} outside [0, {n}]")
    if classifier not in CLASSIFIERS:
        raise ValueError(f"classifier={classifier!r} must be one of {CLASSIFIERS}")
    if classifier == "radix":
        if splitters is not None:
            raise ValueError("radix mode takes no splitters")
        return n_real, None
    want = keys.shape[:-1] + (k - 1,)
    if splitters is None or splitters.shape != want or splitters.dtype != keys.dtype:
        raise ValueError(f"splitters: expected {want} {keys.dtype}, got "
                         f"{None if splitters is None else (tuple(splitters.shape), splitters.dtype)}")
    if splitters.device != keys.device:
        raise ValueError("keys and splitters must share a device")
    return n_real, splitters.reshape(-1, k - 1).contiguous()


def _level(keys, splitters, k, n_real, tile, classifier, consumed_bits, plain, batched,
           upper=None):
    n_real, spl = _level_args(keys, splitters, k, n_real, tile, classifier,
                              2 if batched else 1)
    rows = keys if batched else keys[None]
    if plain:
        bucket, rank, hist = _level_tiles_plain(rows, spl, k, n_real, tile, consumed_bits)
    else:
        if upper is not None and (spl is None or upper.shape != (rows.shape[0], k)
                                  or upper.dtype != keys.dtype or not upper.is_contiguous()):
            raise ValueError(f"upper: expected a contiguous ({rows.shape[0]}, {k}) "
                             f"{keys.dtype} tensor beside the splitters")
        bucket, rank, hist = _level_tiles_kernel(rows, spl, k, n_real, tile,
                                                 consumed_bits, batched, upper)
    dest, offsets = close_placement(bucket, rank, hist, 2 * k + 1, tile)
    return (dest, offsets) if batched else (dest[0], offsets[0])


def level_fused(
    keys: torch.Tensor,
    splitters: Optional[torch.Tensor] = None,
    *,
    k: int,
    n_real: Optional[int] = None,
    tile: int = TILE,
    classifier: str = "tree",
    consumed_bits: int = 0,
    upper: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused level pass over encoded ``keys`` (n,) int32 or int64: the K1
    kernel (tree mode, sorted ``splitters`` (k-1,) of the keys' dtype) or K1r
    (radix mode, no splitters, the bits past ``consumed_bits``) on a CUDA
    tensor, its plain twin on a CPU tensor.  Positions >= ``n_real`` go to
    the pad bucket 2k.  int64 keys take tiles up to ``MAX_TILE64``.

    ``upper`` (1, k), the splitters' upper form with the sentinel last as
    ``glue.sample_splitters`` writes it, spares the kernel path making it.

    Returns (dest (n,) int32, offsets (2k+2,) int32).
    """
    return _level(keys, splitters, k, n_real, tile, classifier, consumed_bits,
                  plain=_device_kind(keys) == "cpu", batched=False, upper=upper)


def level_fused_plain(
    keys: torch.Tensor,
    splitters: Optional[torch.Tensor] = None,
    *,
    k: int,
    n_real: Optional[int] = None,
    tile: int = TILE,
    classifier: str = "tree",
    consumed_bits: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's and K1r's plain torch twin on any device (the card-side
    comparison)."""
    return _level(keys, splitters, k, n_real, tile, classifier, consumed_bits,
                  plain=True, batched=False)


def level_fused_batched(
    keys: torch.Tensor,
    splitters: Optional[torch.Tensor] = None,
    *,
    k: int,
    n_real: Optional[int] = None,
    tile: int = TILE,
    classifier: str = "tree",
    consumed_bits: int = 0,
    upper: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused level pass per row of ``keys`` (B, n) int32 or int64: the K4 kernel
    on a CUDA tensor, its plain twin on a CPU tensor.  Row r classifies
    against its own ``splitters[r]`` ((B, k-1), tree mode) or by the shared
    radix shift (radix mode); positions >= ``n_real`` of every row go to
    its pad bucket 2k.

    ``upper`` (B, k) as in :func:`level_fused`.

    Returns (dest (B, n) int32 within each row, offsets (B, 2k+2) int32).
    """
    return _level(keys, splitters, k, n_real, tile, classifier, consumed_bits,
                  plain=_device_kind(keys) == "cpu", batched=True, upper=upper)


def level_fused_batched_plain(
    keys: torch.Tensor,
    splitters: Optional[torch.Tensor] = None,
    *,
    k: int,
    n_real: Optional[int] = None,
    tile: int = TILE,
    classifier: str = "tree",
    consumed_bits: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 ``level_fused_batched``'s plain torch twin on any device."""
    return _level(keys, splitters, k, n_real, tile, classifier, consumed_bits,
                  plain=True, batched=True)


# ---------------------------------------------------------------------------
# K2


def _items(seg_offsets: torch.Tensor, n: int, tile: int):
    """Work items (start, len, seg) of at most ``tile`` positions that never
    straddle a segment, in position order, padded with empty items (start n)
    to the static bound n // tile + num_seg, so no host read is needed."""
    dev = seg_offsets.device
    lo = seg_offsets[:-1].to(torch.int64)
    hi = seg_offsets[1:].to(torch.int64)
    num_seg = lo.shape[0]
    per_seg = (hi - lo + tile - 1) // tile
    ends = torch.cumsum(per_seg, 0)
    first = ends - per_seg
    num_items = n // tile + num_seg
    i = torch.arange(num_items, dtype=torch.int64, device=dev)
    seg = torch.clamp(torch.searchsorted(ends, i, right=True), max=num_seg - 1)
    start = lo[seg] + (i - first[seg]) * tile
    length = torch.clamp(torch.minimum(hi[seg] - start, torch.full_like(start, tile)), min=0)
    live = i < ends[-1]
    start = torch.where(live, start, n)
    length = torch.where(live, length, 0)
    return (start.to(torch.int32), length.to(torch.int32), seg.to(torch.int32),
            first, per_seg)


def _close_segments(rank, slot, hist, seg_offsets, item_seg, first, per_seg, n):
    """K2's epilogue: per segment, scan the items' histograms to get each
    item's start per local id, offset the segment's local buckets by its
    start, and place every element, dest = base[slot] + rank."""
    dev = hist.device
    num_items, width = hist.shape
    cum = torch.zeros((num_items + 1, width), dtype=torch.int32, device=dev)
    cum[1:] = _cumsum_rows(hist)
    totals = cum[first + per_seg] - cum[first]  # (num_seg, width)
    seg_base = (seg_offsets[:-1, None] + torch.cumsum(totals, 1, dtype=torch.int32)
                - totals)  # (num_seg, width)
    offsets = torch.cat([seg_base.reshape(-1),
                         torch.full((1,), n, dtype=torch.int32, device=dev)])
    seg64 = item_seg.to(torch.int64)
    base = (seg_base[seg64] + cum[:-1] - cum[first[seg64]]).reshape(-1)
    dest = base[slot.to(torch.int64)] + rank
    return dest, offsets


def _rank_hist_args(ids, nb, seg_offsets, seg_width, tile):
    """Checked (seg_offsets or None, seg_width, num_seg); None is one
    segment [0, n) of width nb."""
    _check_ids(ids, "rank_hist ids")
    if seg_offsets is None:
        seg_width = nb
    if seg_width is None or seg_width < 1 or nb % seg_width:
        raise ValueError(f"nb={nb} must be num_seg * seg_width (seg_width={seg_width})")
    if seg_offsets is not None:
        if seg_offsets.dtype != torch.int32 or seg_offsets.dim() != 1:
            raise ValueError("seg_offsets: expected a 1-D int32 tensor")
        if seg_offsets.device != ids.device:
            raise ValueError("ids and seg_offsets must share a device")
        if seg_offsets.shape[0] - 1 != nb // seg_width:
            raise ValueError(f"{seg_offsets.shape[0] - 1} segments != nb // seg_width")
        seg_offsets = seg_offsets.contiguous()
    _check_tile(tile, seg_width)
    return seg_offsets, seg_width, nb // seg_width


def _rank_hist_slots_plain(ids, seg_width, item_start, item_seg):
    n = ids.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=ids.device)
    item = torch.searchsorted(item_start, pos, right=True) - 1
    slot = item * seg_width + (ids - item_seg[item] * seg_width)
    rank, counts = _slot_rank_hist(slot, item_start.shape[0] * seg_width)
    return rank, slot, counts.reshape(-1, seg_width)


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def segment_schedule(n: int, num_seg: int, width: int, tile: int) -> dict:
    """The launch shape of K2's kernels for rows of n ids in ``num_seg``
    segments of ``width`` local ids, as ``csrc/level_fused.cu`` takes it:

    - ``slots``: item slots a row, the static bound n // tile + num_seg;
    - ``small``: width <= ``SMALL_WIDTH``: the count and the rank take one
      warp per slot, eight slots a CTA, in registers (``id_bits`` =
      ceil(log2(width)) ballots a chunk; up to width 4 the count needs none);
    - else ``warps``: of the count and rank CTAs, one CTA per slot, a warp
      per ``RANK_SPAN`` positions of a tile, 1 to ``RANK_WARPS``, and
      ``multi``: a warp's span can exceed one batch of 16 chunks, so the
      rank walks it twice;
    - ``scan_threads``: a team of the per-segment scan, a warp (eight to a
      CTA) or a CTA of up to ``SCAN_THREADS``: width rounded up to a power
      of two times the runs that take about 8 of a segment's items each on
      average; ``scan_ids``: the local ids it takes per pass, min(width,
      team), and ``scan_runs``: the runs it splits a segment's items into.
    """
    small = width <= SMALL_WIDTH
    warps = min(RANK_WARPS, max(1, -(-tile // RANK_SPAN)))
    span = -(-tile // warps)
    per_seg = max(1, -(-(-(-n // tile)) // num_seg))  # a segment's items on average
    team = min(SCAN_THREADS, max(32, _pow2(width) * _pow2(-(-per_seg // 8))))
    scan_ids = min(width, team)
    return {
        "slots": n // tile + num_seg, "small": small, "warps": warps,
        "multi": -(-span // 32) > RANK_SPAN // 32, "id_bits": (width - 1).bit_length(),
        "scan_threads": team, "scan_ids": scan_ids, "scan_runs": team // scan_ids,
    }


def _segment_place_kernel(ids, seg_offsets, num_seg, width, tile, name):
    """K2's four kernels on the card over (rows, n) ``ids``: (dest (rows, n),
    offsets (rows, num_seg * width + 1)), both row-local.  ``seg_offsets``
    (rows, num_seg + 1) or None (one segment a row)."""
    rows, n = ids.shape
    sched = segment_schedule(n, num_seg, width, tile)
    cells = rows * sched["slots"]
    if cells * width >= 2**31 or rows * (num_seg * width + 1) >= 2**31:
        raise ValueError(f"{rows} rows x {sched['slots']} items x {width} counters exceed "
                         "int32 indexing")
    # one allocation: the items (int4 each, first for 16-byte alignment), each
    # segment's first slot, and the (slots, width) counts
    sizes = (cells * 4, rows * (num_seg + 1), cells * width)
    items, first, hist = torch.empty(sum(sizes), dtype=torch.int32,
                                     device=ids.device).split(sizes)
    dest = torch.empty_like(ids)
    offsets = torch.empty((rows, num_seg * width + 1), dtype=torch.int32, device=ids.device)
    lib = _build.library("level_fused", _SIGNATURES)
    err = lib.level_fused_segment_place(
        ids.data_ptr(), None if seg_offsets is None else seg_offsets.data_ptr(), rows, n,
        num_seg, width, tile, sched["slots"], sched["scan_threads"], sched["scan_ids"],
        items.data_ptr(), first.data_ptr(), hist.data_ptr(), dest.data_ptr(),
        offsets.data_ptr(), _build.stream_handle(ids.device),
    )
    _build.check(lib, "level_fused", err, f"{name} kernels")
    _build.LAUNCHES[name] += 1
    return dest, offsets


def segment_launch_info(width: int, tile: int = TILE) -> dict:
    """K2's rank kernel at (width, tile) (a warp per slot up to
    ``SMALL_WIDTH``, else a CTA per slot), from the CUDA runtime, with the
    keys of :func:`launch_info`.  Builds and loads the library; needs a
    card."""
    _check_tile(tile, width)
    out = (ctypes.c_int * 6)()
    lib = _build.library("level_fused", _SIGNATURES)
    _build.check(lib, "level_fused", lib.level_fused_segment_info(width, tile,
                                                                  ctypes.addressof(out)),
                 "rank_hist kernel")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads", "ctas_per_sm",
                     "local_bytes"), out))


def _rank_hist(ids, nb, seg_offsets, seg_width, tile, plain):
    seg_offsets, seg_width, num_seg = _rank_hist_args(ids, nb, seg_offsets, seg_width, tile)
    n = ids.shape[0]
    if not plain:
        dest, offsets = _segment_place_kernel(
            ids[None], None if seg_offsets is None else seg_offsets[None], num_seg, seg_width,
            tile, "rank_hist")
        return dest[0], offsets[0]
    if seg_offsets is None:
        seg_offsets = torch.zeros(2, dtype=torch.int32, device=ids.device)
        seg_offsets[1] = n
    item_start, item_len, item_seg, first, per_seg = _items(seg_offsets, n, tile)
    rank, slot, hist = _rank_hist_slots_plain(ids, seg_width, item_start, item_seg)
    return _close_segments(rank, slot, hist, seg_offsets, item_seg, first, per_seg, n)


def rank_hist(
    ids: torch.Tensor,
    *,
    nb: int,
    seg_offsets: Optional[torch.Tensor] = None,
    seg_width: Optional[int] = None,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable rank + histogram over ``ids`` (n,) int32 in [0, nb): the K2
    kernels on a CUDA tensor, its plain twin on a CPU tensor.

    With ``seg_offsets`` (num_seg+1,) int32 the ids must be composite,
    ``seg * seg_width + local`` for the segment holding the position, and nb
    = num_seg * seg_width; only ``seg_width`` counters are live per item,
    whatever nb is.  Without it the whole array is one segment of width nb.

    Returns (dest (n,) int32, offsets (nb+1,) int32).
    """
    return _rank_hist(ids, nb, seg_offsets, seg_width, tile,
                      plain=_device_kind(ids) == "cpu")


def rank_hist_plain(
    ids: torch.Tensor,
    *,
    nb: int,
    seg_offsets: Optional[torch.Tensor] = None,
    seg_width: Optional[int] = None,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain torch twin on any device (the card-side comparison)."""
    return _rank_hist(ids, nb, seg_offsets, seg_width, tile, plain=True)


# ---------------------------------------------------------------------------
# K4 rank_hist_batched


def _row_segments(ids, seg_offsets, tile):
    """The B rows of ``ids``, flattened, are B * num_seg segments of one
    array: (flat ids, flat segment offsets, each row's start (B, 1), the
    work items of ``_items``, each item's row-local segment id, which is
    the id base the kernel subtracts)."""
    B, n = ids.shape
    dev = ids.device
    num_seg = seg_offsets.shape[1] - 1
    row_start = torch.arange(B, dtype=torch.int32, device=dev)[:, None] * n
    flat_off = torch.cat([(seg_offsets[:, :-1] + row_start).reshape(-1),
                          torch.full((1,), B * n, dtype=torch.int32, device=dev)])
    items = _items(flat_off, B * n, tile)
    return ids.reshape(-1), flat_off, row_start, items, items[2] % num_seg


def _rank_hist_batched(ids, nb, seg_offsets, seg_width, tile, plain):
    _check_ids(ids, "rank_hist_batched ids", 2)
    B, n = ids.shape
    dev = ids.device
    if seg_offsets is None:  # each row is one segment of width nb
        seg_width = nb
    if seg_width is None or seg_width < 1 or nb % seg_width:
        raise ValueError(f"nb={nb} must be num_seg * seg_width (seg_width={seg_width})")
    num_seg = nb // seg_width
    if seg_offsets is not None:
        if seg_offsets.dtype != torch.int32 or seg_offsets.shape[:1] != (B,) or \
                seg_offsets.dim() != 2:
            raise ValueError(f"seg_offsets: expected a ({B}, num_seg+1) int32 tensor")
        if seg_offsets.device != dev:
            raise ValueError("ids and seg_offsets must share a device")
        if seg_offsets.shape[1] - 1 != num_seg:
            raise ValueError(f"{seg_offsets.shape[1] - 1} segments != nb // seg_width")
        seg_offsets = seg_offsets.contiguous()
    _check_tile(tile, seg_width)
    if not plain:
        return _segment_place_kernel(ids, seg_offsets, num_seg, seg_width, tile,
                                     "rank_hist_batched")
    if seg_offsets is None:
        seg_offsets = torch.zeros((B, 2), dtype=torch.int32, device=dev)
        seg_offsets[:, 1] = n
    flat, flat_off, row_start, items, local_seg = _row_segments(ids, seg_offsets, tile)
    item_start, item_len, item_seg, first, per_seg = items
    rank, slot, hist = _rank_hist_slots_plain(flat, seg_width, item_start, local_seg)
    dest, offsets = _close_segments(rank, slot, hist, flat_off, item_seg, first, per_seg,
                                    B * n)
    offsets = torch.cat([offsets[:-1].reshape(B, nb) - row_start,
                         torch.full((B, 1), n, dtype=torch.int32, device=dev)], 1)
    return dest.reshape(B, n) - row_start, offsets


def rank_hist_batched(
    ids: torch.Tensor,
    *,
    nb: int,
    seg_offsets: Optional[torch.Tensor] = None,
    seg_width: Optional[int] = None,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row stable rank + histogram over ``ids`` (B, n) int32 in [0, nb):
    K2's kernels with a row dimension on a CUDA tensor (their own launch
    count), its plain twin on a CPU tensor.

    With ``seg_offsets`` (B, num_seg+1) int32 each row's ids must be
    row-local composite ids ``seg * seg_width + local`` (nb = num_seg *
    seg_width, any size); without it each row is one segment of width nb
    (nb <= MAX_NB).  Work items never straddle a segment, so never a row.

    Returns (dest (B, n) int32 within each row, offsets (B, nb+1) int32).
    """
    return _rank_hist_batched(ids, nb, seg_offsets, seg_width, tile,
                              plain=_device_kind(ids) == "cpu")


def rank_hist_batched_plain(
    ids: torch.Tensor,
    *,
    nb: int,
    seg_offsets: Optional[torch.Tensor] = None,
    seg_width: Optional[int] = None,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 ``rank_hist_batched``'s plain torch twin on any device."""
    return _rank_hist_batched(ids, nb, seg_offsets, seg_width, tile, plain=True)
