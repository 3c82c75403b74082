"""K7: classification plus a per-tile histogram, the stand-alone form of the
local-classification hot loop.

Counterpart of ``repro.kernels.classify`` (the Pallas TPU kernels
``classify_histogram`` at ``classify.py:100``, ``classify_histogram_batched``
at ``:153`` and ``radix_histogram`` at ``:222``; ``radix_histogram_batched``
at ``:271`` flattens its rows into the last).  The three are one CUDA kernel
with a row dimension and a tree/radix mode here, in ``csrc/classify.cu``,
whose header note gives its bound and design; :func:`schedule` gives its
CTA, its steps and its shared memory (``launch.roofline`` reports them).
Each wrapper launches it on a CUDA tensor, under its own key of
``_build.LAUNCHES``, and runs the plain twin (``*_plain``, same outputs bit
for bit) only on a CPU tensor; there is no fallback from one to the other.

Tree mode classifies *raw* keys of any of the reference's twelve key
dtypes (8/16/32/64-bit ints and uints, float16, bfloat16, float32,
float64; ``ops.keyspace``) against k-1 splitters sorted ascending (any NaN
last, as ``torch.sort`` leaves them) and the dtype's max as the last
upper: j counts the splitters below the key, eq says whether the key
equals one of the k uppers, and the id is 2j + eq in [0, 2k), each key
compared in its own dtype (unsigned ints as unsigned) as the reference's
dense compare does.  So NaN gets 0, -0.0 equals a +0.0 splitter, +inf gets
2(k-1) and a key equal to the dtype's max 2k-1.  Radix mode takes the
port's signed int32 or int64 codes (``ops.keyspace.encode``) by K1r's
rule (``classify.radix_bucket_ids``).  The ids and the (tiles, 2k)
histogram of every tile of ``rows * 128`` keys are returned.

Each entry point counts its launches by key width: its own name for 32-bit
keys, the name with 8, 16 or 64 appended for the others
(``classify_histogram16``, ``radix_histogram64``, ...).

``rows=None`` resolves through :func:`default_rows`, a copy of the
reference's TPU tile model: it is the shape contract of the histogram, not
a launch model of the H100.  Any tile of ``rows * 128`` keys is launched,
at any k whose splitter tree, uppers and one tile's histogram fit a CTA's
shared memory (k up to 8192 for every key width).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.classify import radix_bucket_ids, radix_shift
from repro_torch.core.sampling import from_ordered_view, ordered_view, sentinel_for
from repro_torch.kernels import _build
from repro_torch.kernels.level_fused import _device_kind

__all__ = [
    "classify_histogram",
    "classify_histogram_plain",
    "classify_histogram_batched",
    "classify_histogram_batched_plain",
    "radix_histogram",
    "radix_histogram_plain",
    "radix_histogram_batched",
    "radix_histogram_batched_plain",
    "default_rows",
    "launch_name",
    "launch_info",
    "schedule",
    "Schedule",
    "LANES",
    "THREADS",
]

LANES = 128
# the kernel's key kinds (csrc/classify.cu, enum Kind)
_KEY_KINDS = {
    torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.int8: 3, torch.uint8: 4,
    torch.int16: 5, torch.uint16: 6, torch.float16: 7, torch.uint32: 8, torch.int64: 9,
    torch.uint64: 10, torch.float64: 11,
}
_RADIX_CODES = (torch.int32, torch.int64)

# The reference's tile model (``repro/launch/roofline.py:148`` launch_spec ->
# spec_candidates, ``_bytes_per_row`` at :81): a third of a 16 MiB TPU VMEM
# per grid step, 128-lane rows of keys + a (128, 2k) int32 one-hot + the ids,
# power-of-two rows up to 128.  Kept only because it fixes the histogram's
# shape (num_tiles, 2k) for rows=None.
_TPU_STEP_BYTES = (16 * 2**20) // 3
_MAX_ROWS = 128

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "classify_histogram_tree": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "classify_histogram_radix": (_P, _I, _I, _I, _I, _I, _P, _P, _P),
    "classify_histogram_radix64": (_P, _I, _I, _I, _I, _I, _P, _P, _P),
    "classify_info": (_I, _I, _I, _P),
}

# The kernel's CTA (csrc/classify.cu): 256 threads, each lane 4 pieces of
# ids a warp step (a piece: 4 keys, 2 of 64 bits), the histograms of at most
# 32 KB of tiles (one tile's at least) beside the splitter tree.
THREADS = 256
_PIECES = 4
_HIST_BUDGET = 32 * 1024


class Schedule(NamedTuple):
    """The K7 launch's CTA at (key bytes, k): ``threads``, the keys a warp
    takes a step (``warp_step``), the most tiles a CTA takes
    (``tiles``: their histograms stay in shared memory until its end), and
    the CTA's dynamic shared memory in bytes (in tree mode the padded tree
    and the uppers, k' + k entries of the compare type, and for 8-bit keys
    a table of 256 ids; then ``tiles`` histograms of 2k int32 counters).
    A launch gives each CTA ceil(tiles / (4 x SMs x CTAs an SM holds))
    tiles of one row, at most ``tiles``."""

    threads: int
    warp_step: int
    tiles: int
    smem_bytes: int


def schedule(key_bytes: int, k: int, radix: bool = False) -> Schedule:
    """K7's launch at (key bytes, k, mode), as ``csrc/classify.cu``
    ``schedule`` computes it; any tile of 128-key rows.

    >>> schedule(4, 128)
    Schedule(threads=256, warp_step=512, tiles=32, smem_bytes=33792)
    >>> schedule(8, 100, radix=True)
    Schedule(threads=256, warp_step=256, tiles=40, smem_bytes=32000)
    """
    nb = 2 * k
    kp = 1 << (k - 1).bit_length()
    tiles = max(1, _HIST_BUDGET // (4 * nb))
    tree = 0 if radix else ((kp + k) * (8 if key_bytes == 8 else 4)
                            + (1024 if key_bytes == 1 else 0))
    return Schedule(THREADS, 32 * _PIECES * (2 if key_bytes == 8 else 4), tiles,
                    tree + tiles * nb * 4)


def default_rows(n: int, key_bytes: int, k: int) -> int:
    """The largest power-of-two row count whose tile (rows * 128) divides
    ``n`` and whose reference working set fits its TPU budget, or 0 when no
    candidate divides n: the reference's ``launch_spec("classify", ...)``.

    >>> default_rows(1 << 24, 4, 128), default_rows(1 << 24, 4, 256)
    (32, 16)
    >>> default_rows(1000, 4, 128)
    0
    """
    per_row = LANES * (key_bytes + 4 * (2 * k) + 4)
    rows = 1
    while rows * 2 <= _MAX_ROWS and rows * 2 * per_row <= _TPU_STEP_BYTES:
        rows *= 2
    while rows >= 1:
        if n % (rows * LANES) == 0:
            return rows
        rows //= 2
    return 0


def _tile(n: int, key_bytes: int, k: int, rows: Optional[int]) -> int:
    if rows is None:
        rows = default_rows(n, key_bytes, k)
    tile = rows * LANES
    if not rows or n % tile:
        raise ValueError(f"n={n} must be a multiple of a rows*{LANES} tile")
    return tile


def _check_keys(keys: torch.Tensor, dim: int, radix: bool) -> None:
    if keys.dim() != dim or not keys.is_contiguous():
        raise ValueError(f"keys: expected a contiguous {dim}-D tensor, got "
                         f"{tuple(keys.shape)}")
    if radix and keys.dtype not in _RADIX_CODES:
        raise ValueError(f"radix mode takes encoded int32 or int64 keys, got {keys.dtype}")
    if keys.dtype not in _KEY_KINDS:
        raise NotImplementedError(
            f"keys: K7 takes raw keys of the keyspace's dtypes {list(_KEY_KINDS)}, got "
            f"{keys.dtype}, which the reference refuses too")
    if keys.numel() >= 2**31:
        raise ValueError(f"{keys.numel()} keys exceed int32 positions")


def _uppers(keys: torch.Tensor, splitters: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k-1) splitters -> (B, k) uppers, the last the dtype's max."""
    want = keys.shape[:-1] + (k - 1,)
    if splitters.shape != want or splitters.dtype != keys.dtype:
        raise ValueError(f"splitters: expected {want} {keys.dtype}, got "
                         f"{tuple(splitters.shape)} {splitters.dtype}")
    if splitters.device != keys.device:
        raise ValueError("keys and splitters must share a device")
    # in the ordered view, where torch's unsigned dtypes have every op: the
    # view's max is the view of the dtype's max
    spl = ordered_view(splitters.reshape(math.prod(keys.shape[:-1]), k - 1))
    sent = torch.full((spl.shape[0], 1), sentinel_for(spl.dtype), dtype=spl.dtype,
                      device=spl.device)
    return from_ordered_view(torch.cat([spl, sent], 1), splitters.dtype)


def _widen(x: torch.Tensor) -> torch.Tensor:
    """Keys in a dtype whose torch compares give the key order: bfloat16 and
    float16 -> float32 (exact), uint16, uint32 and uint64 as their signed
    views with the sign bit flipped (``sampling.ordered_view``: torch's
    unsigned dtypes lack ``>``); the other dtypes as they are."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return ordered_view(x)


def _kernel_uppers(upper: torch.Tensor) -> torch.Tensor:
    """The uppers in the kernel's compare type for their key kind: float32
    for the floats of 32 bits or fewer, int32 for the 8- and 16-bit ints,
    the raw bits (a signed view) of uint32 and uint64, the rest as they
    are."""
    if upper.dtype in (torch.bfloat16, torch.float16):
        return upper.float()
    if upper.dtype in (torch.int8, torch.uint8, torch.int16, torch.uint16):
        return upper.to(torch.int32)
    if upper.dtype == torch.uint32:
        return upper.view(torch.int32)
    if upper.dtype == torch.uint64:
        return upper.view(torch.int64)
    return upper


def launch_name(name: str, dtype: torch.dtype) -> str:
    """The ``_build.LAUNCHES`` key of entry point ``name`` on keys of
    ``dtype``: the name for 32-bit keys, the name and the width otherwise.

    >>> launch_name("classify_histogram", torch.float64)
    'classify_histogram64'
    """
    bits = 8 * torch.empty((), dtype=dtype).element_size()
    return name if bits == 32 else f"{name}{bits}"


def launch_info(dtype: torch.dtype, k: int, radix: bool = False) -> dict:
    """The K7 kernel's 16-byte-aligned launch on keys of ``dtype`` (radix:
    int32 or int64 codes) at k, from the CUDA runtime
    (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``):
    registers per thread, static and dynamic shared memory per CTA in bytes,
    threads per CTA, CTAs an SM holds at once, local memory per thread in
    bytes (spills), keys a warp step and the most tiles a CTA takes.  Builds
    and loads the library; needs a card."""
    out = (ctypes.c_int * 8)()
    lib = _build.library("classify", _SIGNATURES)
    _build.check(lib, "classify", lib.classify_info(_KEY_KINDS[dtype], int(radix), k,
                                                    ctypes.addressof(out)), "classify_info")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads", "ctas_per_sm",
                     "local_bytes", "warp_step", "tiles"), out))


# ---------------------------------------------------------------------------
# plain twins


def _tree_ids_plain(keys: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """The reference's dense compare, one upper at a time: (B, n) keys
    against (B, k) uppers -> ids 2j + eq, int32."""
    x, u = _widen(keys), _widen(upper)
    k = u.shape[1]
    j = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    eq = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for i in range(k):
        ui = u[:, i:i + 1]
        if i < k - 1:
            j += x > ui
        eq |= x == ui
    return 2 * j + eq.to(torch.int32)


def _hist_plain(bucket: torch.Tensor, nb: int, tile: int) -> torch.Tensor:
    """(B, n) ids -> (B, n // tile, nb) int32 per-tile counts."""
    B, n = bucket.shape
    tiles = n // tile
    t = torch.arange(B * tiles, dtype=torch.int64, device=bucket.device).repeat_interleave(tile)
    slot = t * nb + bucket.reshape(-1).to(torch.int64)
    return torch.bincount(slot, minlength=B * tiles * nb).to(torch.int32).reshape(B, tiles, nb)


# ---------------------------------------------------------------------------
# the kernel


def _run_kernel(keys, upper, k, shift, tile, name):
    B, n = keys.shape
    bucket = torch.empty((B, n), dtype=torch.int32, device=keys.device)
    hist = torch.empty((B, n // tile, 2 * k), dtype=torch.int32, device=keys.device)
    lib = _build.library("classify", _SIGNATURES)
    stream = _build.stream_handle(keys.device)
    if upper is None:
        radix = (lib.classify_histogram_radix64 if keys.dtype == torch.int64
                 else lib.classify_histogram_radix)
        err = radix(keys.data_ptr(), B, n, k, shift, tile, bucket.data_ptr(), hist.data_ptr(),
                    stream)
    else:
        upper = _kernel_uppers(upper).contiguous()
        err = lib.classify_histogram_tree(keys.data_ptr(), upper.data_ptr(),
                                          _KEY_KINDS[keys.dtype], B, n, k, tile,
                                          bucket.data_ptr(), hist.data_ptr(), stream)
    name = launch_name(name, keys.dtype)
    _build.check(lib, "classify", err, f"{name} kernel")
    _build.LAUNCHES[name] += 1
    return bucket, hist


def _classify(keys, splitters, k, rows, plain, batched):
    _check_keys(keys, 2 if batched else 1, radix=False)
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    rows2 = keys if batched else keys[None]
    upper = _uppers(rows2, splitters if batched else splitters[None], k)
    tile = _tile(keys.shape[-1], keys.element_size(), k, rows)
    if plain:
        bucket = _tree_ids_plain(rows2, upper)
        hist = _hist_plain(bucket, 2 * k, tile)
    else:
        name = "classify_histogram_batched" if batched else "classify_histogram"
        bucket, hist = _run_kernel(rows2, upper, k, 0, tile, name)
    return (bucket, hist) if batched else (bucket[0], hist[0])


def _radix(keys, k, consumed_bits, rows, plain):
    _check_keys(keys, 1, radix=True)
    shift = radix_shift(k, consumed_bits, 8 * keys.element_size())
    tile = _tile(keys.shape[0], keys.element_size(), k, rows)
    if plain:
        bucket = radix_bucket_ids(keys, k, consumed_bits)[None]
        hist = _hist_plain(bucket, 2 * k, tile)
    else:
        bucket, hist = _run_kernel(keys[None], None, k, shift, tile, "radix_histogram")
    return bucket[0], hist[0]


def _radix_batched(keys, k, consumed_bits, rows, plain):
    """Flatten the rows into one radix call; tiles never straddle rows."""
    _check_keys(keys, 2, radix=True)
    B, n = keys.shape
    tile = _tile(n, keys.element_size(), k, rows)
    bucket, hist = _radix(keys.reshape(B * n), k, consumed_bits, tile // LANES, plain)
    return bucket.reshape(B, n), hist.reshape(B, n // tile, 2 * k)


def classify_histogram(keys: torch.Tensor, splitters: torch.Tensor, *, k: int,
                       rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classify raw ``keys`` (n,) of any keyspace dtype against sorted
    ``splitters`` (k-1,) of the same dtype: the K7 kernel on a CUDA tensor,
    its plain twin on a CPU tensor.

    Returns (ids (n,) int32 in [0, 2k), per-tile histogram (num_tiles, 2k)
    int32).  n must be a multiple of rows*128; ``rows=None`` takes
    :func:`default_rows`.
    """
    return _classify(keys, splitters, k, rows, _device_kind(keys) == "cpu", False)


def classify_histogram_plain(keys: torch.Tensor, splitters: torch.Tensor, *, k: int,
                             rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``classify_histogram``'s plain torch twin on any device."""
    return _classify(keys, splitters, k, rows, True, False)


def classify_histogram_batched(keys: torch.Tensor, splitters: torch.Tensor, *, k: int,
                               rows: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classify ``keys`` (B, n) row b against its own sorted ``splitters[b]``
    ((B, k-1)): the K7 kernel with B rows on a CUDA tensor, its plain twin on
    a CPU tensor.  Returns (ids (B, n) int32, histograms (B, num_tiles, 2k)
    int32)."""
    return _classify(keys, splitters, k, rows, _device_kind(keys) == "cpu", True)


def classify_histogram_batched_plain(keys: torch.Tensor, splitters: torch.Tensor, *, k: int,
                                     rows: Optional[int] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``classify_histogram_batched``'s plain torch twin on any device."""
    return _classify(keys, splitters, k, rows, True, True)


def radix_histogram(keys: torch.Tensor, *, k: int, consumed_bits: int = 0,
                    rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radix ids and per-tile histogram of encoded int32 or int64 ``keys``
    (n,): the next log2(k) bits past ``consumed_bits``, 2 * bits + (key ==
    sentinel).
    The K7 kernel in radix mode on a CUDA tensor, its plain twin on a CPU
    tensor.  Returns (ids (n,) int32, histogram (num_tiles, 2k) int32)."""
    return _radix(keys, k, consumed_bits, rows, _device_kind(keys) == "cpu")


def radix_histogram_plain(keys: torch.Tensor, *, k: int, consumed_bits: int = 0,
                          rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``radix_histogram``'s plain torch twin on any device."""
    return _radix(keys, k, consumed_bits, rows, True)


def radix_histogram_batched(keys: torch.Tensor, *, k: int, consumed_bits: int = 0,
                            rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row radix ids and histograms of ``keys`` (B, n): the rows are one
    :func:`radix_histogram` call (its launch count).  Returns (ids (B, n),
    histograms (B, n / tile, 2k))."""
    return _radix_batched(keys, k, consumed_bits, rows, _device_kind(keys) == "cpu")


def radix_histogram_batched_plain(keys: torch.Tensor, *, k: int, consumed_bits: int = 0,
                                  rows: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``radix_histogram_batched``'s plain torch twin on any device."""
    return _radix_batched(keys, k, consumed_bits, rows, True)
