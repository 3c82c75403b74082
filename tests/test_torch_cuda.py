"""The port's CUDA kernels against their plain twins, on a CUDA card:
K1 (tree), K1r (radix), K4 ``level_fused_batched`` (both modes; also at
MAX_TILE, a tile of 33, k = 2 and the largest k, every key on one
splitter, every position a pad), K2 ``rank_hist`` and K4
``rank_hist_batched`` (also with empty segments, W2 = MAX_NB at MAX_TILE,
widths about the count's ballot path, one id, sorted ids, no positions),
K3, K5 ``merge_path_perm`` (also at tile 1, the
default and MAX_TILE, all-equal runs, runs of length 1, unaligned
starts) and
K6 (``dispatch_ranks``, ``partition_ranks``, ``partition_ranks_batched``;
also at 65,536 tiles, one id, all trash, rows whose first tile is all
trash, nb = 4096 at tile 16384 and (8, 2^20) rows, each twice),
K7 (``classify_histogram`` and its batched and radix forms, on raw keys
of all twelve keyspace dtypes and on int64 radix codes, each launch under
its key width's name; at k = 1 .. 256 and tiles of 128 to 16384 on
all-equal, one-splitter, NaN-heavy, sorted and Zipf keys, at an offset
of one key, and its launch against ``classify.schedule``), K5's int64 form (ragged, unaligned, at its largest
tile), the stream, ``s3_sort`` and ``sort_blocks`` on float64, uint16 and
narrow keys against the CPU, K8
``permute_blocks_by_dest`` (every team size, 20 runs in a row, and a ``dst``
that is not a permutation) and K9 ``permute_blocks_inplace`` (in place: same
``data_ptr``, a peak-memory rise of at most a quarter of the data), and the
sorts and the stream on the card against the same calls on the CPU; K10
``flash_decode`` (the reference layout and the decode step's strided
(B, T, KVH, hd) cache; idle cluster ranks, length 0, shares below one
unit, two streams and 50 calls in a row) and K11 ``flash_attention``
against their plain twins (|got - want| <= atol + rtol * |want|: 2e-5 + 2e-5 in float32,
4e-3 + 2^-8 in bfloat16), a 2-layer yi-9b at full
width served through K10, and the 64-bit forms of K1, K1r, K4
``level_fused_batched`` (the edge cases above, shifts up to level 2's
clamp, no spills) and K3 (every W from 2 to 16384, descending windows
and equal keys across runs; no spill at any W) against their twins,
and the sorts of every key dtype on the card against the CPU; the learned
classifier's sorts (1-D and batched, the model kept or the fallback
taken) and its uint64 -> float32 cast against the CPU's, the records'
tie-break passes, a payload pytree through the batched path, and the plan
cache (a tuned sorter, a classifier race, a tuned stream) persisted and
reloaded; obs's span device times (present, nested) and, obs off, a
sort's launches and synchronizing calls equal to no-op hooks'; ``dist.sort``
at world size 1 on NCCL (the most one card takes) equal to ``ops.sort``;
the exchange's placement launching K2; the MoE dispatch through K6
(``dispatch_ranks`` and ``partition_ranks_batched``) equal to the plain
dispatch bit for bit, K10 at group 1 with hd 128 (the tensor-core
kernel) and hd 80 (the FMA kernel), the scheduler's admissions against
the host oracle, the glue kernels G1-G4 (``kernels.glue``: the placement
close on K4's tile histograms, the segment ids with empty and leading
buckets, the composite ids of both modes on int32 and int64 keys, the
scatter of payload rows of 1-16 bytes by a permutation, K1's, K4's and
K2's placements, and the window gather direct and in place at every W)
and ``ops.sort``'s profile without ``searchsorted``, ``index_put``,
``nonzero`` or a copy from the host; G5 (the codec on all twelve dtypes),
G6 (both levels' samples) and G7 (the fallback on crafted offsets, two
launches) against their twins, and the sort entry points under
``set_sync_debug_mode("error")``; and reduced MoE, RWKV-6 and zamba2 models on the card
against the CPU (float32, 1e-3 on the logits); training: the reduced
models' loss and gradients on the card against the CPU (float32, 1e-4 of
each leaf's largest gradient, 5e-4 for rwkv6 and zamba2) and bitwise on a second call, K6 twice per
MoE layer with remat, and a ``Trainer`` restart bitwise equal to the run
straight through.

Marked ``gpu``: every test skips (from its fixture) where no card is
present, so the CPU suite collects the same tests on every worker.  On the
card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Tolerance: exact equality for the integer outputs.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels, ops, stream
from repro_torch.core import sampling
from repro_torch.data.distributions import make_input
from repro_torch.kernels import bitonic, dispatch_rank, merge_path, level_fused as lf
from repro_torch.kernels import block_permute, classify, permute_inplace
from repro_torch.kernels import flash_attention, flash_decode, ref
from repro_torch.core.s3sort import s3_sort as ops_s3_sort
from repro_torch.kernels.ops import sort_blocks as ops_sort_blocks

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU suite runs the plain twins")
    return torch.device("cuda", 0)


def _equal(got, want):
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("k,n,n_real,tile", [(2, 1000, 1000, 256), (128, 70000, 65537, 4096)])
def test_level_fused_kernel(dev, k, n, n_real, tile):
    keys = ops.keyspace.encode(torch.as_tensor(make_input("TwoDup", n, np.int32), device=dev))
    spl = sampling.select_splitters(torch.sort(keys[:n_real][:512]).values, k)
    before = kernels.launch_counts()["level_fused"]
    _equal(lf.level_fused(keys, spl, k=k, n_real=n_real, tile=tile),
           lf.level_fused_plain(keys, spl, k=k, n_real=n_real, tile=tile))
    assert kernels.launch_counts()["level_fused"] == before + 1


LEVEL_EDGE_CASES = ["tile MAX_TILE", "tile 33", "k=2", "largest k", "all on one splitter",
                    "all pads"]


def _level_edge(dev, case, radix):
    """Keys, splitters (None in radix mode) and kwargs of one K1 edge case:
    a CTA of 32 warps (MAX_TILE) or one partial warp (33), k = 2 or the
    largest k under MAX_NB, every key equal to one splitter, every position
    a pad; heavy duplicates and sentinel keys throughout."""
    k, n, n_real, tile = 128, 50_000, 49_001, lf.TILE
    if case == "tile MAX_TILE":
        tile, n, n_real = lf.MAX_TILE, 3 * lf.MAX_TILE + 777, 3 * lf.MAX_TILE + 500
    elif case == "tile 33":
        tile, n, n_real = 33, 5000, 4990
    elif case == "k=2":
        k = 2
    elif case == "largest k":
        k = 1 << ((lf.MAX_NB - 1) // 2).bit_length() - 1
    elif case == "all pads":
        n_real = 0
    g = torch.Generator(device=dev).manual_seed(n + k)
    keys = torch.randint(-3000, 3000, (n,), generator=g, device=dev, dtype=torch.int32)
    keys[::53] = torch.iinfo(torch.int32).max  # the sentinel: an equality bucket
    spl = sampling.select_splitters(torch.sort(keys[:8192]).values, k)
    if case == "all on one splitter":
        keys.fill_(int(spl[k // 2]))
    kw = dict(k=k, n_real=n_real, tile=tile, classifier="radix" if radix else "tree")
    return keys, None if radix else spl, kw


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("case", LEVEL_EDGE_CASES)
def test_level_fused_kernel_edges(dev, case, classifier):
    """K1 and K1r bit for bit their plain twins at the edges of the CTA
    shape (one warp per 512 positions) and of the classifier."""
    keys, spl, kw = _level_edge(dev, case, classifier == "radix")
    name = "level_fused_radix" if classifier == "radix" else "level_fused"
    assert 2 * kw["k"] + 1 <= lf.MAX_NB
    before = kernels.launch_counts()[name]
    _equal(lf.level_fused(keys, spl, **kw), lf.level_fused_plain(keys, spl, **kw))
    assert kernels.launch_counts()[name] == before + 1


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("case", ["tile MAX_TILE", "tile 33", "largest k", "all pads"])
def test_level_fused_batched_kernel_edges(dev, case, classifier):
    """K4 ``level_fused_batched`` bit for bit its twin over three rows of
    the same edge cases, each row with its own splitters."""
    keys, spl, kw = _level_edge(dev, case, classifier == "radix")
    rows = torch.stack([keys, keys.flip(0), keys.roll(7)])
    if spl is not None:
        spl = torch.stack([spl, spl, sampling.select_splitters(
            torch.sort(rows[2, :8192]).values, kw["k"])])
    before = kernels.launch_counts()["level_fused_batched"]
    _equal(lf.level_fused_batched(rows, spl, **kw), lf.level_fused_batched_plain(rows, spl, **kw))
    assert kernels.launch_counts()["level_fused_batched"] == before + 1


@pytest.mark.parametrize("nb,seg", [(3, 0), (520, 0), (40 * 256, 40)])
def test_rank_hist_kernel(dev, nb, seg):
    g = torch.Generator(device=dev).manual_seed(nb)
    n = 50000
    if seg:
        off = torch.sort(torch.randint(0, n + 1, (seg + 1,), generator=g, device=dev)).values
        off[0], off[-1] = 0, n
        off = off.to(torch.int32)
        s = torch.searchsorted(off, torch.arange(n, device=dev, dtype=torch.int32), right=True) - 1
        ids = (s * 256 + torch.randint(0, 256, (n,), generator=g, device=dev)).to(torch.int32)
        kw = dict(nb=nb, seg_offsets=off, seg_width=256)
    else:
        ids = torch.randint(0, nb, (n,), generator=g, device=dev, dtype=torch.int32)
        kw = dict(nb=nb)
    before = kernels.launch_counts()["rank_hist"]
    _equal(lf.rank_hist(ids, **kw), lf.rank_hist_plain(ids, **kw))
    assert kernels.launch_counts()["rank_hist"] == before + 1


RANK_HIST_EDGES = {  # case: (rows, n, num_seg, width, tile)
    "empty segments": (3, 50000, 40, 256, 4096),
    "MAX_NB at MAX_TILE": (2, 100000, 3, lf.MAX_NB, lf.MAX_TILE),
    "two batches a warp": (1, 70000, 5, 300, 8192),
    "K4 shape, width 4": (4, 1 << 16, 257, 4, 4096),
    "width 32": (2, 30000, 9, 32, 1024),
    "width 33": (2, 30000, 9, 33, 1024),
    "tile 64": (2, 5000, 17, 16, 64),
    "one id": (2, 50000, 1, 256, 4096),
    "sorted ids": (2, 50000, 7, 64, 4096),
    "no positions": (2, 0, 3, 8, 512),
}


def _edge_ids(dev, case, rows, n, num_seg, width):
    """Row-local composite ids over segments: a quarter of them empty and
    the last two empty (one segment: every id equal for "one id")."""
    g = torch.Generator(device=dev).manual_seed(n + width)
    off = torch.sort(torch.randint(0, n + 1, (rows, num_seg + 1), generator=g, device=dev),
                     dim=1).values
    off[:, 1:num_seg // 4 + 1] = 0
    if num_seg >= 4:
        off[:, -3:] = n
    off[:, 0], off[:, -1] = 0, n
    off = off.to(torch.int32)
    pos = torch.arange(n, device=dev, dtype=torch.int32).expand(rows, n).contiguous()
    seg = torch.searchsorted(off, pos, right=True) - 1
    local = torch.randint(0, width, (rows, n), generator=g, device=dev)
    if case == "one id":
        local = torch.full_like(local, width - 1)
    elif case == "sorted ids":
        local = torch.sort(local, dim=1).values
    ids = (seg * width + local).to(torch.int32)
    return ids, off


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", list(RANK_HIST_EDGES))
def test_rank_hist_kernel_edges(dev, case, batched):
    """K2 (one row) and K4 ``rank_hist_batched`` bit for bit their twins
    at the edges of the four kernels: empty segments and empty slots, n not
    a multiple of the tile, W2 = MAX_NB at MAX_TILE (a warp's span walked
    twice), widths on both sides of the count's ballot path, CTAs of one
    warp, every id equal, sorted ids, no positions; one launch a call."""
    rows, n, num_seg, width, tile = RANK_HIST_EDGES[case]
    ids, off = _edge_ids(dev, case, rows, n, num_seg, width)
    kw = dict(nb=num_seg * width, seg_width=width, tile=tile)
    name = "rank_hist_batched" if batched else "rank_hist"
    before = kernels.launch_counts()[name]
    if batched:
        _equal(lf.rank_hist_batched(ids, seg_offsets=off, **kw),
               lf.rank_hist_batched_plain(ids, seg_offsets=off, **kw))
    else:
        _equal(lf.rank_hist(ids[0], seg_offsets=off[0], **kw),
               lf.rank_hist_plain(ids[0], seg_offsets=off[0], **kw))
    assert kernels.launch_counts()[name] == before + 1


SORT_WINDOWS_CASES = ["sorted ids", "any ids", "equal keys", "one window", "2049 windows",
                      "descending", "ties across runs", "run indices"]


def _window_case(case, b, k):
    """The (bucket, key) windows of ``case`` from random ones: every key and
    id equal; ids and keys both descending; or each 8 keys ending on the
    key that starts the next 8 (at E = 8 a merge's left run ending on its
    right run's head)."""
    if case == "equal keys":
        return torch.zeros_like(b), torch.full_like(k, -5)
    if case == "descending":
        return (torch.sort(b, dim=1, descending=True).values,
                torch.sort(k, dim=1, descending=True).values)
    if case == "ties across runs":
        pos = torch.arange(k.shape[1], device=k.device)
        tied = torch.where((pos // 8) % 2 == 1, -2, pos % 4 - 2).to(k.dtype)
        return torch.zeros_like(b), tied.expand_as(k).contiguous()
    return (b, k) if case == "any ids" else (torch.sort(b, dim=1).values, k)


@pytest.mark.parametrize("case", SORT_WINDOWS_CASES)
@pytest.mark.parametrize("W", [2, 32, 256, 1024, 8192, 16384])
def test_sort_windows_kernel(dev, W, case):
    """K3 bit for bit its plain twin: bucket ids nondecreasing (the sorts'
    windows) or in any order (the wrapper does not ask for sorted ids),
    every key and id equal, one window and 2049 (a partial last CTA at
    every W), descending windows, equal keys across runs, and the
    run-index route of ``base_case_windows`` for ids above K3's bucket
    field."""
    from repro_torch.kernels.ops import base_case_windows

    g = torch.Generator(device=dev).manual_seed(W)
    num_w = {"one window": 1, "2049 windows": 2049}.get(case, 5)
    b = torch.randint(0, 9, (num_w, W), generator=g, device=dev, dtype=torch.int32)
    k = torch.randint(-3, 4, (num_w, W), generator=g, device=dev, dtype=torch.int32)
    b, k = _window_case(case, b, k)
    if case == "run indices":  # nb = 2^31: past K3's field from W = 4 on, so K3
        # gets each window's run index (W = 2's 31-bit field takes any id)
        fb = (torch.arange(4 * W, device=dev, dtype=torch.int32) // 3) * 30011
        keys = torch.randint(-2**31, 2**31 - 1, (4 * W,), generator=g, device=dev,
                             dtype=torch.int32)
        before = kernels.launch_counts()["sort_windows"]
        got = base_case_windows({"k": keys}, fb, W, 1 << 31)["k"]
        assert kernels.launch_counts()["sort_windows"] > before
        want = base_case_windows({"k": keys.cpu()}, fb.cpu(), W, 1 << 31)["k"]
        assert torch.equal(got.cpu(), want)
        return
    before = kernels.launch_counts()["sort_windows"]
    _equal(bitonic.sort_windows(b, k, nb=9), bitonic.sort_windows_plain(b, k, nb=9))
    assert kernels.launch_counts()["sort_windows"] == before + 1


@pytest.mark.parametrize("n", [1, 5000, 300_000])
def test_sort_on_the_card_matches_the_cpu(dev, n):
    x = make_input("Exponential", n, np.float32, seed=1)
    x[::31] = np.nan
    got = ops.argsort(torch.as_tensor(x)).cpu()
    want = ops.argsort(torch.as_tensor(x), device="cpu")
    assert torch.equal(got, want)
    assert torch.equal(ops.sort(torch.as_tensor(x)).cpu().view(torch.int32),
                       ops.sort(torch.as_tensor(x), device="cpu").view(torch.int32))


@pytest.mark.parametrize("k,n,n_real,consumed", [(2, 1000, 1000, 0), (128, 70000, 65537, 0),
                                                  (16, 9000, 8000, 3)])
def test_level_fused_radix_kernel(dev, k, n, n_real, consumed):
    keys = torch.randint(-2**31, 2**31 - 1, (n,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(k))
    keys[::97] = torch.iinfo(torch.int32).max  # the sentinel: an equality bucket
    kw = dict(k=k, n_real=n_real, classifier="radix", consumed_bits=consumed)
    before = kernels.launch_counts()["level_fused_radix"]
    _equal(lf.level_fused(keys, **kw), lf.level_fused_plain(keys, **kw))
    assert kernels.launch_counts()["level_fused_radix"] == before + 1


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("B,n,n_real,k,tile", [(1, 1000, 1000, 2, 256), (5, 20000, 19000, 64, 4096),
                                               (64, 4096, 4000, 128, 1024)])
def test_level_fused_batched_kernel(dev, classifier, B, n, n_real, k, tile):
    x = make_input("TwoDup", B * n, np.int32, seed=B).reshape(B, n)
    keys = ops.keyspace.encode(torch.as_tensor(x, device=dev))
    spl = None
    if classifier == "tree":
        spl = sampling.select_splitters(torch.sort(keys[:, :256], dim=1).values, k)
    kw = dict(k=k, n_real=n_real, tile=tile, classifier=classifier)
    before = kernels.launch_counts()["level_fused_batched"]
    _equal(lf.level_fused_batched(keys, spl, **kw), lf.level_fused_batched_plain(keys, spl, **kw))
    assert kernels.launch_counts()["level_fused_batched"] == before + 1


@pytest.mark.parametrize("B,n,num_seg,width", [(3, 5000, 0, 40), (8, 30000, 17, 256)])
def test_rank_hist_batched_kernel(dev, B, n, num_seg, width):
    g = torch.Generator(device=dev).manual_seed(n)
    if num_seg:
        off = torch.sort(torch.randint(0, n + 1, (B, num_seg + 1), generator=g, device=dev),
                         dim=1).values
        off[:, 0], off[:, -1] = 0, n
        off = off.to(torch.int32)
        pos = torch.arange(n, device=dev, dtype=torch.int32).expand(B, n).contiguous()
        s = torch.searchsorted(off, pos, right=True) - 1
        ids = (s * width + torch.randint(0, width, (B, n), generator=g, device=dev)).to(
            torch.int32)
        kw = dict(nb=num_seg * width, seg_offsets=off, seg_width=width)
    else:
        ids = torch.randint(0, width, (B, n), generator=g, device=dev, dtype=torch.int32)
        kw = dict(nb=width)
    before = kernels.launch_counts()["rank_hist_batched"]
    _equal(lf.rank_hist_batched(ids, **kw), lf.rank_hist_batched_plain(ids, **kw))
    assert kernels.launch_counts()["rank_hist_batched"] == before + 1


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("B,n", [(3, 5000), (4, 300_000)])
def test_batched_sort_on_the_card_matches_the_cpu(dev, classifier, B, n):
    x = make_input("Uniform", B * n, np.float32, seed=2).reshape(B, n)
    x[:, ::29] = np.nan
    got = ops.batched_argsort(torch.as_tensor(x), classifier=classifier).cpu()
    want = ops.batched_argsort(torch.as_tensor(x), classifier=classifier, device="cpu")
    assert torch.equal(got, want)
    v, i = ops.batched_topk(torch.as_tensor(x), 64, classifier=classifier)
    wv, wi = ops.batched_topk(torch.as_tensor(x), 64, classifier=classifier, device="cpu")
    assert torch.equal(v.cpu().view(torch.int32), wv.view(torch.int32))
    assert torch.equal(i.cpu(), wi)


@pytest.mark.parametrize("na,nb,tile", [(1, 1, 2048), (1000, 77, 2048), (1_000_003, 77, 2048),
                                        (300_000, 200_000, 256), (5000, 3000, 8),
                                        (70_000, 0, 2048)])
def test_merge_path_kernel(dev, na, nb, tile):
    g = torch.Generator(device=dev).manual_seed(na + nb)
    a = torch.sort(torch.randint(-50, 50, (na,), generator=g, device=dev, dtype=torch.int32)).values
    b = torch.sort(torch.randint(-50, 50, (nb,), generator=g, device=dev, dtype=torch.int32)).values
    a[-1:] = torch.iinfo(torch.int32).max  # a NaN code: no sentinel padding to mistake it for
    before = kernels.launch_counts()["merge_path"]
    got = merge_path.merge_path_perm(a, b, tile=tile)
    assert torch.equal(got, merge_path.merge_path_perm_plain(a, b, tile=tile))
    assert torch.equal(got.to(torch.int64), torch.sort(torch.cat([a, b]), stable=True).indices)
    assert kernels.launch_counts()["merge_path"] == before + (1 if na and nb else 0)


MERGE_EDGE_CASES = ["all equal", "a of length 1", "b of length 1", "random"]


@pytest.mark.parametrize("case", MERGE_EDGE_CASES)
@pytest.mark.parametrize("tile", [1, merge_path.TILE, merge_path.MAX_TILE])
def test_merge_path_kernel_edges(dev, tile, case):
    """K5 bit for bit its twin and the stable sort at tile 1 (a CTA of one
    thread per output), the default and MAX_TILE (64 outputs a thread),
    with every key equal, one run of length 1, and runs whose first keys
    sit at every 4-byte offset from a 16-byte boundary (views into a
    larger tensor)."""
    g = torch.Generator(device=dev).manual_seed(tile)
    na, nb = (3000, 2000) if tile == 1 else (200_003, 150_001)
    if case == "a of length 1":
        na = 1
    elif case == "b of length 1":
        nb = 1
    lo, hi = (0, 1) if case == "all equal" else (-20, 20)
    for off in range(4):
        buf = torch.randint(lo, hi, (na + nb + 8,), generator=g, device=dev, dtype=torch.int32)
        a = torch.sort(buf[off:off + na]).values
        b = torch.sort(buf[na + off + 4:na + off + 4 + nb]).values
        base = torch.empty(na + nb + 8, dtype=torch.int32, device=dev)
        base[off:off + na], base[na + off + 4:na + off + 4 + nb] = a, b
        a, b = base[off:off + na], base[na + off + 4:na + off + 4 + nb]
        before = kernels.launch_counts()["merge_path"]
        got = merge_path.merge_path_perm(a, b, tile=tile)
        assert kernels.launch_counts()["merge_path"] == before + 1
        assert torch.equal(got, merge_path.merge_path_perm_plain(a, b, tile=tile))
        assert torch.equal(got.to(torch.int64),
                           torch.sort(torch.cat([a, b]), stable=True).indices)


K6_CASES = [  # rows, n, nb, tile, ids
    (1, 1000, 3, 4096, "random"),
    (1, 300_000, 65, 4096, "skew"),        # half the ids on one bucket
    (1, 100_000, 257, 1024, "random"),
    (5, 20_000, 257, 4096, "skew"),
    (2, 50_000, 4096, 4096, "random"),
    (1, 1 << 24, 257, 256, "prefix"),      # 65,536 tiles to look back over
    (1, 1 << 22, 64, 8192, "equal"),       # every id the same
    (1, 1 << 20, 64, 8192, "trash"),       # every id outside [0, nb)
    (3, 1 << 20, 257, 4096, "first empty"),  # each row's first tile all trash
    (1, 1 << 22, 4096, 16384, "prefix"),   # nb = MAX_NB at tile 16384 (cut to 3072)
    (8, 1 << 20, 257, 8192, "prefix"),     # (8, 2^20) rows
]


@pytest.mark.parametrize("rows,n,nb,tile,kind", K6_CASES)
def test_dispatch_rank_kernel(dev, rows, n, nb, tile, kind):
    """K6's one-pass kernel against its plain twin bit for bit, twice in a
    row (a race in the look-back would show as a difference), one launch a
    call; with prefix starts also the inverse of each row's stable argsort."""
    g = torch.Generator(device=dev).manual_seed(n + nb)
    hi = nb if kind in ("prefix", "equal") else nb + 1  # nb is the trash id
    ids = torch.randint(0, hi, (rows, n), generator=g, device=dev, dtype=torch.int32)
    if kind == "skew":
        ids[:, ::2] = nb // 2
    elif kind == "equal":
        ids[:] = nb - 1
    elif kind == "trash":
        ids[:] = nb
    elif kind == "first empty":
        ids[:, :tile] = nb
    if kind in ("prefix", "equal"):
        counts = torch.stack([torch.bincount(r, minlength=nb) for r in ids]).to(torch.int32)
        start = (torch.cumsum(counts, 1) - counts).to(torch.int32)
    else:
        start = torch.randint(0, 1 << 20, (rows, nb), generator=g, device=dev,
                              dtype=torch.int32)
    want = dispatch_rank.partition_ranks_batched_plain(ids, start, nb=nb, tile=tile)
    for _ in range(2):
        if rows == 1:
            for fn in (dispatch_rank.dispatch_ranks, dispatch_rank.partition_ranks):
                kw = dict(num_experts=nb) if fn is dispatch_rank.dispatch_ranks else dict(nb=nb)
                assert torch.equal(fn(ids[0], start[0], tile=tile, **kw), want[0])
        before = kernels.launch_counts()["partition_ranks_batched"]
        got = dispatch_rank.partition_ranks_batched(ids, start, nb=nb, tile=tile)
        assert kernels.launch_counts()["partition_ranks_batched"] == before + 1
        assert torch.equal(got, want)
    if kind in ("prefix", "equal"):
        order = torch.sort(ids, dim=1, stable=True).indices
        assert torch.equal(torch.gather(got, 1, order).to(torch.int64),
                           torch.arange(n, device=dev).expand(rows, n))


def test_external_argsort_many_chunks_on_the_card(dev):
    """200 chunks through the two pinned staging buffers: a buffer refilled
    before its copy finished, or a sort that did not wait for its copy,
    would sort a half-copied chunk."""
    x = make_input("Uniform", 200 * 4099, np.float32, seed=3)
    x[::37] = np.nan
    before = kernels.launch_counts()["merge_path"]
    got = stream.external_argsort(x, chunk_size=4099)
    assert torch.equal(torch.as_tensor(got), ops.argsort(torch.as_tensor(x), device="cpu"))
    assert kernels.launch_counts()["merge_path"] > before
    keys = stream.external_sort(x, chunk_size=4099)
    assert np.array_equal(keys.view(np.int32),
                          ops.sort(torch.as_tensor(x), device="cpu").numpy().view(np.int32))


def test_streaming_ops_on_the_card_match_the_cpu(dev):
    x = make_input("RootDup", 300_000, np.int32, seed=4)
    for largest in (True, False):
        got = stream.streaming_topk(x, 500, chunk_size=65536, largest=largest)
        want = stream.streaming_topk(x, 500, chunk_size=65536, largest=largest, device="cpu")
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got = stream.streaming_group_by(x, chunk_size=65536)
    want = stream.streaming_group_by(x, chunk_size=65536, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("method", ["partition", "pallas", "sort"])
def test_group_by_on_the_card_matches_the_cpu(dev, method):
    ids = torch.as_tensor(np.random.default_rng(5).integers(0, 64, 200_000).astype(np.int32))
    kw = dict(num_groups=64) if method != "sort" else {}
    name = {"partition": "partition_ranks", "pallas": "dispatch_ranks"}.get(method)
    before = kernels.launch_counts().get(name, 0)
    got = ops.group_by(ids, method=method, **kw)
    want = ops.group_by(ids, method=method, device="cpu", **kw)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g.cpu(), w)
    if name:
        assert kernels.launch_counts()[name] == before + 1


@pytest.mark.parametrize("method", ["auto", "partition", "pallas"])
def test_group_by_above_k6_counters_on_the_card(dev, method):
    """10,000 groups, above K6's 4096 counters: two K6 passes on the card,
    equal to the same call on the CPU and to the stable argsort."""
    ids = torch.as_tensor(np.random.default_rng(6).integers(0, 10_000, 300_000).astype(np.int32))
    before = kernels.launch_counts()["partition_ranks"]
    got = ops.group_by(ids, num_groups=10_000, method=method)
    want = ops.group_by(ids, num_groups=10_000, method=method, device="cpu")
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g.cpu(), w)
    assert torch.equal(got.perm.cpu().to(torch.int64), torch.sort(ids, stable=True).indices)
    assert kernels.launch_counts()["partition_ranks"] == before + 2


def test_segmented_sort_above_k3_bucket_field_on_the_card(dev):
    """2048 segments at k = 128: composite ids past K3's 2^19 bucket field
    at W = 8192, so K3 sees window-local run indices; equal to the CPU."""
    rng = np.random.default_rng(7)
    n, segs = 1 << 16, 2048
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    off = torch.as_tensor(np.concatenate([[0], np.sort(rng.integers(0, n, segs - 1)), [n]])
                          .astype(np.int32))
    v = torch.arange(n, dtype=torch.int32)
    got = ops.segmented_sort(x, off, segs, v, k=128)
    want = ops.segmented_sort(x, off, segs, v, k=128, device="cpu")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
@pytest.mark.parametrize("k,n,rows", [(2, 1024, 8), (5, 3 * 4096, 32), (128, 77 * 4096, 32),
                                      (256, 40 * 2048, None)])
def test_classify_histogram_kernel(dev, dtype, k, n, rows):
    g = torch.Generator(device=dev).manual_seed(k + n)
    x = torch.randn(n, device=dev, generator=g)
    if dtype == torch.int32:
        x = (x * 300).to(torch.int32)
    else:
        x = x.to(dtype)
        x[::37] = float("nan")
        x[1::37] = -0.0
        x[2::37] = float("inf")
        x[3::37] = torch.finfo(dtype).max
    sample = torch.sort(x[torch.randint(0, n, (4 * k,), device=dev, generator=g)]).values
    spl = sample[torch.linspace(0, 4 * k - 1, k - 1, device=dev).long()].contiguous()
    name = classify.launch_name("classify_histogram", dtype)  # by key width
    before = kernels.launch_counts()[name]
    _equal(classify.classify_histogram(x, spl, k=k, rows=rows),
           classify.classify_histogram_plain(x, spl, k=k, rows=rows))
    assert kernels.launch_counts()[name] == before + 1


@pytest.mark.parametrize("B,n,k", [(1, 1024, 4), (7, 3 * 4096, 64)])
def test_classify_histogram_batched_kernel(dev, B, n, k):
    g = torch.Generator(device=dev).manual_seed(B)
    x = torch.randn((B, n), device=dev, generator=g)
    x[:, ::29] = float("nan")
    spl = torch.sort(torch.randn((B, k - 1), device=dev, generator=g), dim=1).values
    _equal(classify.classify_histogram_batched(x, spl, k=k),
           classify.classify_histogram_batched_plain(x, spl, k=k))


@pytest.mark.parametrize("k,consumed", [(2, 0), (256, 0), (256, 8), (32, 30)])
def test_radix_histogram_kernel(dev, k, consumed):
    g = torch.Generator(device=dev).manual_seed(k + consumed)
    x = torch.randint(-2**31, 2**31 - 1, (3, 5 * 4096), device=dev, generator=g,
                      dtype=torch.int32)
    x[:, ::97] = torch.iinfo(torch.int32).max
    before = kernels.launch_counts()["radix_histogram"]
    _equal(classify.radix_histogram(x[0], k=k, consumed_bits=consumed),
           classify.radix_histogram_plain(x[0], k=k, consumed_bits=consumed))
    _equal(classify.radix_histogram_batched(x, k=k, consumed_bits=consumed),
           classify.radix_histogram_batched_plain(x, k=k, consumed_bits=consumed))
    assert kernels.launch_counts()["radix_histogram"] == before + 2


# ---- K7 on every key kind, its int64 radix form, and K5's int64 form ---------

K7_KINDS = [torch.int8, torch.uint8, torch.int16, torch.uint16, torch.float16, torch.bfloat16,
            torch.int32, torch.uint32, torch.float32, torch.int64, torch.uint64, torch.float64]
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _raw_keys(dtype, n, g, dev):
    """Keys of ``dtype`` on the card: random bits with a heavy duplicate and
    the dtype's extremes; floats with NaN, +-0.0, +-inf and the max."""
    signed = _SIGNED[torch.empty((), dtype=dtype).element_size()]
    info = torch.iinfo(signed)
    x = torch.randint(info.min, info.max, (n,), generator=g, device=dev, dtype=signed)
    x[::3] = x[0]
    x = x.view(dtype).clone()
    if dtype.is_floating_point:
        x[torch.isnan(x)] = 1.5
        x[::37] = float("nan")
        x[1::37] = -0.0
        x[2::37] = 0.0
        x[3::37] = float("inf")
        x[4::37] = float("-inf")
        x[5::37] = torch.finfo(dtype).max
    else:
        x.view(signed)[5::37] = -1 if dtype in (torch.uint8, torch.uint16, torch.uint32,
                                                 torch.uint64) else info.max
        x.view(signed)[6::37] = 0 if dtype in (torch.uint8, torch.uint16, torch.uint32,
                                                torch.uint64) else info.min
    return x


def _sorted_splitters(x, k, g):
    """k-1 keys of each row of x sorted in the keyspace order (NaN last),
    picked on the signed view (torch's unsigned dtypes have no gather on a
    card)."""
    signed = _SIGNED[x.element_size()]
    pos = torch.randint(0, x.shape[-1], x.shape[:-1] + (k - 1,), generator=g, device=x.device)
    pick = torch.gather(x.view(signed), -1, pos)
    order = torch.sort(ops.keyspace.encode(pick.view(x.dtype)), dim=-1, stable=True).indices
    return torch.gather(pick, -1, order).contiguous().view(x.dtype)


@pytest.mark.parametrize("k,n,rows", [(2, 1024, 8), (128, 77 * 4096, 32), (256, 40 * 2048, None)])
@pytest.mark.parametrize("dtype", K7_KINDS)
def test_classify_histogram_kernel_key_kinds(dev, dtype, k, n, rows):
    """K7's tree mode on raw keys of every keyspace dtype bit for bit its
    plain twin, one launch under the key width's name; rows=None takes
    the key width's tile."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    x = _raw_keys(dtype, n, g, dev)
    spl = _sorted_splitters(x, k, g)
    name = classify.launch_name("classify_histogram", dtype)
    before = kernels.launch_counts()[name]
    got = classify.classify_histogram(x, spl, k=k, rows=rows)
    assert kernels.launch_counts()[name] == before + 1
    _equal(got, classify.classify_histogram_plain(x, spl, k=k, rows=rows))


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint16, torch.float16, torch.uint32,
                                   torch.int64, torch.uint64, torch.float64])
def test_classify_histogram_batched_kernel_key_kinds(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    x = _raw_keys(dtype, 7 * 3 * 4096, g, dev).view(7, 3 * 4096)
    spl = _sorted_splitters(x, 64, g)
    name = classify.launch_name("classify_histogram_batched", dtype)
    before = kernels.launch_counts()[name]
    got = classify.classify_histogram_batched(x, spl, k=64)
    assert kernels.launch_counts()[name] == before + 1
    _equal(got, classify.classify_histogram_batched_plain(x, spl, k=64))


K7_SKEWS = ["all equal", "one splitter", "NaN-heavy", "sorted", "zipf"]
K7_WIDTHS = [torch.uint8, torch.int16, torch.float16, torch.float32, torch.uint32, torch.float64,
             torch.int64]


def _skewed_keys(dtype, skew, n, g, dev):
    """Keys of ``dtype`` on the card, with their splitters drawn per k: all
    one value, all equal to a splitter (set by the caller), NaN-heavy (the
    dtype's max for the ints), already sorted, or Zipf(1.3) ranks."""
    x = _raw_keys(dtype, n, g, dev)
    signed = _SIGNED[x.element_size()]
    if skew == "all equal":
        x.view(signed).fill_(int(x.view(signed)[7]))
    elif skew == "NaN-heavy":
        nan = torch.rand(n, generator=g, device=dev) < 0.7
        if dtype.is_floating_point:
            x[nan] = float("nan")
        else:
            x.view(signed)[nan] = -1 if dtype in (torch.uint8, torch.uint32) else \
                torch.iinfo(signed).max
    elif skew == "sorted":
        order = torch.sort(ops.keyspace.encode(x), stable=True).indices
        x = x.view(signed)[order].view(dtype).contiguous()
    elif skew == "zipf":
        z = np.minimum(np.random.default_rng(n).zipf(1.3, n), 100).astype(np.int64)
        x = torch.as_tensor(z, device=dev).to(signed).view(dtype) if not dtype.is_floating_point \
            else torch.as_tensor(z, device=dev).to(dtype)
    return x


@pytest.mark.parametrize("skew", K7_SKEWS)
@pytest.mark.parametrize("dtype", K7_WIDTHS)
def test_classify_histogram_kernel_skewed(dev, dtype, skew):
    """K7's tree mode at k = 1, 3, 100, 128 and 256 and tiles of 128, 4096
    and 16384 keys (steps of several tiles, one tile, several steps a
    tile) on skewed keys of each key width, bit for bit its plain twin:
    the run-merged atomics (random keys), the one atomic of a warp whose
    keys share a slot (equal, sorted and one-splitter keys), and the scalar
    loads and stores of keys at an offset of one element."""
    g = torch.Generator(device=dev).manual_seed(len(skew))
    n = 3 * 16384
    base = _skewed_keys(dtype, skew, n + 1, g, dev)
    for k in (1, 3, 100, 128, 256):
        for rows in (1, 32, 128):
            for x in (base[:n], base[1:]):  # 16-byte aligned, and one key on
                spl = _sorted_splitters(x, k, g)
                if skew == "one splitter" and k > 1:
                    x = spl[(k - 1) // 2].expand(n).contiguous()
                got = classify.classify_histogram(x, spl, k=k, rows=rows)
                want = classify.classify_histogram_plain(x, spl, k=k, rows=rows)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (k, rows,
                                                                           x.data_ptr() % 16)


@pytest.mark.parametrize("dtype", K7_WIDTHS)
def test_classify_histogram_batched_kernel_skewed(dev, dtype):
    """Three rows, each against its own splitters (a CTA never straddles two
    rows), at k = 3 and 100, tiles of 128 and 4096, random and all-equal
    rows side by side."""
    g = torch.Generator(device=dev).manual_seed(9)
    n = 3 * 4096
    x = _raw_keys(dtype, 3 * n, g, dev).view(3, n)
    signed = _SIGNED[x.element_size()]
    x[1].view(signed).fill_(int(x[1].view(signed)[0]))
    for k in (3, 100):
        spl = _sorted_splitters(x, k, g)
        for rows in (1, 32):
            _equal(classify.classify_histogram_batched(x, spl, k=k, rows=rows),
                   classify.classify_histogram_batched_plain(x, spl, k=k, rows=rows))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_radix_histogram_kernel_skewed(dev, dtype):
    """Radix mode at tiles of 128, 4096 and 16384 on all-equal, sorted and
    full-range codes, aligned and at an offset of one code."""
    g = torch.Generator(device=dev).manual_seed(4)
    info = torch.iinfo(dtype)
    n = 3 * 16384
    full = torch.randint(info.min, info.max, (n + 1,), device=dev, generator=g, dtype=dtype)
    bits = 8 * full.element_size()
    for x in (full, torch.sort(full).values, torch.full_like(full, 12345)):
        for rows in (1, 32, 128):
            for view in (x[:n], x[1:]):
                for k, consumed in ((2, 0), (256, 8), (16, bits - 4)):
                    _equal(classify.radix_histogram(view, k=k, consumed_bits=consumed, rows=rows),
                           classify.radix_histogram_plain(view, k=k, consumed_bits=consumed,
                                                          rows=rows))


def test_classify_launch_follows_the_schedule(dev):
    """The kernel's launch (shared bytes, threads, warp step, tiles a CTA)
    from the CUDA runtime equals ``classify.schedule``, with no spills."""
    code = {torch.float32: torch.int32, torch.float64: torch.int64}
    for dtype in (torch.uint8, torch.float16, torch.float32, torch.float64):
        for k in (1, 3, 100, 128, 256):
            for radix in ((False, True) if dtype in code and k > 1 else (False,)):
                info = classify.launch_info(code[dtype] if radix else dtype, k, radix)
                sch = classify.schedule(dtype.itemsize, k, radix)
                assert (info["dynamic_smem"], info["threads"], info["warp_step"],
                        info["tiles"]) == (sch.smem_bytes, sch.threads, sch.warp_step, sch.tiles)
                assert info["local_bytes"] == 0 and info["ctas_per_sm"] >= 1


@pytest.mark.parametrize("k,consumed", [(2, 0), (256, 0), (256, 8), (32, 59), (16, 60)])
def test_radix_histogram64_kernel(dev, k, consumed):
    """K7's radix mode on int64 codes over the whole range, the NaN code
    among them, at shifts up to 0."""
    g = torch.Generator(device=dev).manual_seed(k + consumed)
    info = torch.iinfo(torch.int64)
    x = torch.randint(info.min, info.max, (3, 5 * 4096), device=dev, generator=g,
                      dtype=torch.int64)
    x[:, ::97] = info.max
    before = kernels.launch_counts()["radix_histogram64"]
    _equal(classify.radix_histogram(x[0], k=k, consumed_bits=consumed),
           classify.radix_histogram_plain(x[0], k=k, consumed_bits=consumed))
    _equal(classify.radix_histogram_batched(x, k=k, consumed_bits=consumed),
           classify.radix_histogram_batched_plain(x, k=k, consumed_bits=consumed))
    assert kernels.launch_counts()["radix_histogram64"] == before + 2


def _sorted_run64(n, lo, hi, g, dev):
    run = torch.sort(torch.randint(lo, hi, (n,), generator=g, device=dev,
                                   dtype=torch.int64) * (2**60)).values
    run[-max(1, n // 1000):] = torch.iinfo(torch.int64).max  # the code of NaN
    return run


@pytest.mark.parametrize("na,nb,tile", [(1, 1, 2048), (1000, 77, 2048), (1_000_003, 77, 2048),
                                        (300_000, 200_000, 256), (5000, 3000, 8),
                                        (70_000, 0, 2048), (200_003, 150_001, 4096),
                                        (200_003, 150_001, merge_path.MAX_TILE64)])
def test_merge_path64_kernel(dev, na, nb, tile):
    """K5's int64 form bit for bit its plain twin and the stable merge, one
    launch under ``merge_path64`` (none with an empty run)."""
    g = torch.Generator(device=dev).manual_seed(na + nb + tile)
    a, b = _sorted_run64(na, -7, 7, g, dev), _sorted_run64(nb, -7, 7, g, dev)[:nb]
    before = kernels.launch_counts()["merge_path64"]
    got = merge_path.merge_path_perm(a, b, tile=tile)
    assert kernels.launch_counts()["merge_path64"] == before + (1 if na and nb else 0)
    assert torch.equal(got, merge_path.merge_path_perm_plain(a, b, tile=tile))
    assert torch.equal(got.to(torch.int64), torch.sort(torch.cat([a, b]), stable=True).indices)


@pytest.mark.parametrize("tile", [1, merge_path.TILE, merge_path.MAX_TILE64])
def test_merge_path64_kernel_unaligned(dev, tile):
    """Runs whose first keys sit 0 or 8 bytes past a 16-byte boundary
    (views into a larger tensor): one key of a run in a window's first
    16-byte piece."""
    g = torch.Generator(device=dev).manual_seed(tile)
    na, nb = (3000, 2000) if tile == 1 else (200_003, 150_001)
    for off_a, off_b in ((0, 1), (1, 0), (1, 1)):
        base = torch.empty(na + nb + 4, dtype=torch.int64, device=dev)
        a = base[off_a:off_a + na]
        b = base[na + 2 + off_b:na + 2 + off_b + nb]
        a.copy_(_sorted_run64(na, -3, 3, g, dev))
        b.copy_(_sorted_run64(nb, -3, 3, g, dev))
        got = merge_path.merge_path_perm(a, b, tile=tile)
        assert torch.equal(got, merge_path.merge_path_perm_plain(a, b, tile=tile))
        assert torch.equal(got.to(torch.int64),
                           torch.sort(torch.cat([a, b]), stable=True).indices)


def test_merge_path64_launch_info(dev):
    """The int64 form's largest step fits a CTA's shared memory, two stages
    and the transpose, without spills."""
    for tile in (merge_path.TILE, merge_path.MAX_TILE64):
        info = merge_path.launch_info(tile, key_bytes=8)
        assert info["dynamic_smem"] <= 232_448 and info["ctas_per_sm"] >= 1
        assert info["local_bytes"] == 0


@pytest.mark.parametrize("name", ["float64", "uint16", "bfloat16"])
def test_stream_of_new_dtypes_on_the_card(dev, name):
    """The stream's entry points on the card equal to the CPU's on keys
    that were refused before: numpy float64 and uint16 sources, and a CPU
    tensor of bfloat16 keys (no ml_dtypes on the card's machine); the
    64-bit merges launch ``merge_path64``."""
    dtype = getattr(torch, name)
    g = torch.Generator(device=dev).manual_seed(9)
    t = _raw_keys(dtype, 50 * 1031, g, dev).cpu()
    src = t if name == "bfloat16" else t.view(_SIGNED[t.element_size()]).numpy().view(
        {"float64": np.float64, "uint16": np.uint16}[name])

    def same(a, b):
        a, b = (torch.as_tensor(np.ascontiguousarray(v).view(f"i{v.itemsize}"))
                if isinstance(v, np.ndarray) else v.view(_SIGNED[v.element_size()])
                for v in (a, b))
        return torch.equal(a, b)

    key = "merge_path64" if name == "float64" else "merge_path"
    before = kernels.launch_counts()[key]
    assert same(stream.external_sort(src, chunk_size=1031),
                stream.external_sort(src, chunk_size=1031, device="cpu"))
    assert np.array_equal(stream.external_argsort(src, chunk_size=1031),
                          stream.external_argsort(src, chunk_size=1031, device="cpu"))
    for largest in (True, False):
        v, i = stream.streaming_topk(src, 100, chunk_size=1031, largest=largest)
        wv, wi = stream.streaming_topk(src, 100, chunk_size=1031, largest=largest, device="cpu")
        assert np.array_equal(i, wi) and same(v, wv)
    v, c = stream.streaming_group_by(src, chunk_size=1031)
    wv, wc = stream.streaming_group_by(src, chunk_size=1031, device="cpu")
    assert same(v, wv) and np.array_equal(c, wc)
    assert kernels.launch_counts()[key] > before


@pytest.mark.parametrize("dtype", [torch.float64, torch.uint16, torch.int8])
def test_s3_sort_and_sort_blocks_of_new_dtypes_on_the_card(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(11)
    x = _raw_keys(dtype, 1 << 16, g, dev)
    ks, vs = ops_s3_sort(x, torch.arange(x.shape[0], device=dev))
    wk, wv = ops_s3_sort(x.cpu(), torch.arange(x.shape[0]))
    signed = _SIGNED[x.element_size()]
    assert torch.equal(ks.cpu().view(signed), wk.view(signed)) and torch.equal(vs.cpu(), wv)
    bb = torch.randint(0, 16, (x.shape[0] // 1024,), generator=g, device=dev,
                       dtype=torch.int32)
    a = x.clone()
    before = kernels.launch_counts()["permute_blocks_by_dest"]
    out, d = ops_sort_blocks(a, bb, k=16, block_elems=1024)
    assert kernels.launch_counts()["permute_blocks_by_dest"] == before + 1
    want, want_d = ops_sort_blocks(x.cpu().clone(), bb.cpu(), k=16, block_elems=1024)
    assert out.data_ptr() == a.data_ptr()
    assert torch.equal(out.cpu().view(signed), want.view(signed)) and torch.equal(d.cpu(), want_d)


def _in_place_bound(a):
    """A quarter of the data (the card's form of the reference's <= 1.25n
    live bytes), but at least the caching allocator's smallest block."""
    return max(0.25 * a.numel() * a.element_size(), 512)


def _rise(fn):
    """Peak allocation above the start during fn(), in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


@pytest.mark.parametrize("dst_kind", ["buckets", "random", "one cycle", "identity"])
@pytest.mark.parametrize("N,be,extra,dtype", [
    (4096, 1024, 1000, torch.int32), (4096, 128, 0, torch.float32),
    (777, 256, 255, torch.int16), (2, 128, 3, torch.int32), (1, 1024, 5, torch.int32),
    # every team of the kernel: one warp at 128 B, 1 KB and 2 KB a block;
    # CTA teams at 16 KB, 64 KB and the largest block the wrapper takes
    (4096, 128, 100, torch.int8), (4096, 256, 0, torch.int32), (3000, 512, 9, torch.int32),
    (1024, 4096, 77, torch.int32), (300, 16384, 5, torch.int32),
    (150, block_permute.MAX_BLOCK_BYTES, 3, torch.int8),
])
def test_permute_blocks_by_dest_kernel(dev, N, be, extra, dtype, dst_kind):
    g = torch.Generator(device=dev).manual_seed(N + be)
    a = torch.randint(-1000, 1000, (N * be + extra,), device=dev, generator=g).to(dtype)
    dst = _k8_dst(dst_kind, N, g, dev)
    before = kernels.launch_counts()["permute_blocks_by_dest"]
    want = block_permute.permute_blocks_by_dest_plain(a.clone(), dst, block_elems=be)
    ptr = a.data_ptr()
    got, rise = _rise(lambda: block_permute.permute_blocks_by_dest(a, dst, block_elems=be))
    assert got.data_ptr() == ptr
    assert rise <= _in_place_bound(a)
    assert torch.equal(got, want)
    assert kernels.launch_counts()["permute_blocks_by_dest"] == before + (N > 1)


def _k8_dst(kind, N, g, dev):
    if kind == "buckets":
        bb = torch.randint(0, 256, (N,), device=dev, generator=g, dtype=torch.int32)
        return block_permute.stable_block_dest(bb)
    if kind == "random":
        return torch.randperm(N, device=dev, generator=g).to(torch.int32)
    if kind == "one cycle":
        return ((torch.arange(N, device=dev) + 1) % N).to(torch.int32)
    return torch.arange(N, device=dev, dtype=torch.int32)


def test_permute_blocks_by_dest_kernel_twenty_runs(dev):
    """The uniform case (block buckets uniform over 256, the stable order)
    at 32,768 blocks of 1024 int32, 20 runs in a row: the chains' claiming
    interleaves differently each time, the output stays the twin's bit for
    bit and in place."""
    g = torch.Generator(device=dev).manual_seed(20)
    N, be = 32768, 1024
    src = torch.randint(-2**31, 2**31 - 1, (N * be + 100,), device=dev, generator=g,
                        dtype=torch.int32)
    dst = _k8_dst("buckets", N, g, dev)
    want = block_permute.permute_blocks_by_dest_plain(src.clone(), dst, block_elems=be)
    for _ in range(20):
        a = src.clone()
        ptr = a.data_ptr()
        before = kernels.launch_counts()["permute_blocks_by_dest"]
        got, rise = _rise(lambda: block_permute.permute_blocks_by_dest(a, dst, block_elems=be))
        assert got.data_ptr() == ptr
        assert rise <= _in_place_bound(a)
        assert torch.equal(got, want)
        assert kernels.launch_counts()["permute_blocks_by_dest"] == before + 1


@pytest.mark.parametrize("kind", ["all zero", "repeats and out of range"])
@pytest.mark.parametrize("be", [1024, 4096])
def test_permute_blocks_by_dest_kernel_returns_on_a_non_permutation(dev, kind, be):
    """A dst that is not a permutation gives no defined output, but the
    kernel (one-warp teams at 4 KB blocks, CTA teams at 16 KB) must return:
    a chain stops at a slot outside [0, N), and a slot claimed by a chain is
    never waited on.  The trailing partial block stays untouched."""
    g = torch.Generator(device=dev).manual_seed(be)
    N = 2048
    a = torch.randint(-1000, 1000, (N * be + 100,), device=dev, generator=g, dtype=torch.int32)
    tail = a[N * be:].clone()
    if kind == "all zero":
        dst = torch.zeros(N, dtype=torch.int32, device=dev)
    else:
        dst = torch.randint(-5, N + 5, (N,), device=dev, generator=g, dtype=torch.int32)
    before = kernels.launch_counts()["permute_blocks_by_dest"]
    got = block_permute.permute_blocks_by_dest(a, dst, block_elems=be)
    torch.cuda.synchronize()
    assert got.data_ptr() == a.data_ptr()
    assert torch.equal(got[N * be:], tail)
    assert kernels.launch_counts()["permute_blocks_by_dest"] == before + 1


def _k9_buckets(kind, N, k, g, dev):
    """Block buckets for K9's claiming: uniform, already grouped (every block
    in its range), every fourth bucket only (the rest empty), or all blocks
    but one in one bucket."""
    if kind == "uniform":
        return torch.randint(0, k, (N,), device=dev, generator=g, dtype=torch.int32)
    if kind == "in place":
        return torch.sort(_k9_buckets("uniform", N, k, g, dev)).values
    if kind == "empty buckets":
        return torch.randint(0, -(-k // 4), (N,), device=dev, generator=g,
                             dtype=torch.int32) * 4 % k
    bb = torch.full((N,), k // 2, device=dev, dtype=torch.int32)  # all but one
    bb[N // 3] = k - 1
    return bb


def _k9_canonical(a, d, be):
    """The blocks of ``a`` with each bucket range's blocks sorted by their
    tag (first element): equal for two outputs iff their per-bucket block
    multisets are."""
    blocks = a.view(-1, be)
    slots = torch.arange(blocks.shape[0], device=a.device, dtype=torch.int32)
    slot_bucket = torch.searchsorted(d, slots, right=True) - 1
    return blocks[torch.argsort((slot_bucket.to(torch.int64) << 32) | blocks[:, 0].to(torch.int64))]


@pytest.mark.parametrize("N,be,k,kind", [
    (4096, 1024, 256, "uniform"), (300, 128, 7, "uniform"), (1, 256, 3, "uniform"),
    (1000, 512, 1, "uniform"), (4096, 1024, 1, "uniform"), (4096, 1024, 256, "in place"),
    (4096, 1024, 256, "empty buckets"), (3000, 128, 1024, "empty buckets"),
    (4096, 1024, 256, "all but one"), (2, 128, 2, "all but one"),
])
def test_permute_blocks_inplace_kernel(dev, N, be, k, kind):
    """K9 is not stable: its order within a bucket follows how its CTAs
    interleave.  Each output must hold every block intact, in its bucket's
    range, as multisets per bucket equal to the plain twin's (the replay of
    the reference's order), in place; 20 runs in a row of each case."""
    g = torch.Generator(device=dev).manual_seed(N + k)
    bb = _k9_buckets(kind, N, k, g, dev)
    d = torch.zeros(k + 1, dtype=torch.int32, device=dev)
    d[1:] = torch.cumsum(torch.bincount(bb, minlength=k), 0)
    tags = torch.arange(N * be, device=dev, dtype=torch.int32)  # block i holds i*be + [0, be)
    want = _k9_canonical(
        permute_inplace.permute_blocks_inplace_plain(tags.clone(), bb, d, k=k, block_elems=be),
        d, be)
    for _ in range(20):
        a = tags.clone()
        ptr = a.data_ptr()
        before = kernels.launch_counts()["permute_blocks_inplace"]
        got, rise = _rise(lambda: permute_inplace.permute_blocks_inplace(a, bb, d, k=k,
                                                                         block_elems=be))
        assert got.data_ptr() == ptr
        assert rise <= _in_place_bound(a)
        blocks = got.view(N, be)
        assert torch.equal(blocks - blocks[:, :1], tags[:be].expand(N, be))  # intact
        assert torch.equal(_k9_canonical(got, d, be), want)
        assert kernels.launch_counts()["permute_blocks_inplace"] == before + 1


# (atol, rtol): f32 is the same math in another summation order; bf16 is
# the output's rounding, one step of 2^-8 relative, with an absolute floor
# a few times the largest sound difference (chip_smoke.py's bf16 limit)
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 2 ** -8)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,t,hd,lengths", [
    (2, 4, 4, 2048, 64, (1, 2048)),
    (8, 32, 4, 4096, 128, (1, 1, 17, 1024, 1025, 2048, 4095, 4096)),
    (3, 8, 8, 512, 128, (0, 300, 64)),
    (2, 16, 2, 1000, 64, (999, 64)),
    # one request: a cluster of 16 with idle ranks at length 1
    (1, 32, 4, 4096, 128, (4096,)), (1, 32, 4, 4096, 128, (1,)),
    (3, 8, 8, 512, 128, (0, 0, 0)),            # every length 0
    (4, 8, 2, 256, 64, (5, 3, 16, 17)),         # below one 16-row unit per share
    (8, 32, 4, 4096, 128, (1056,) * 8),         # the served shape at the last step
])
def test_flash_decode_kernel(dev, b, h, kvh, t, hd, lengths, dtype):
    g = torch.Generator(device=dev).manual_seed(t + hd)
    q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
    cache_k = torch.randn((b, t, kvh, hd), generator=g, device=dev).to(dtype)
    cache_v = torch.randn((b, t, kvh, hd), generator=g, device=dev).to(dtype)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = kernels.launch_counts()["flash_decode"]
    got = flash_decode.flash_decode_cache(q, cache_k, cache_v, length)
    want = ref.flash_decode_ref(q[:, :, None], cache_k.transpose(1, 2), cache_v.transpose(1, 2),
                                length)[:, :, 0]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_decode"] == before + 1
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    if 0 in lengths:
        assert not bool(got[lengths.index(0)].any())
    # the reference's (B, H, T, hd) contract, GQA pre-expanded
    kx = cache_k.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    vx = cache_v.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    got4 = flash_decode.flash_decode(q[:, :, None], kx, vx, length)
    torch.testing.assert_close(got4[:, :, 0].float(), want.float(), atol=atol, rtol=rtol)


def test_flash_decode_kernel_streams_and_repeats(dev):
    """Two streams at once, then 50 calls in a row on one: every result is
    the twin's within the limit and equal to the first call's (the kernel
    keeps nothing between calls: no counter, no workspace), and the launch
    count rises by one a call."""
    g = torch.Generator(device=dev).manual_seed(50)
    b, h, kvh, t, hd = 4, 32, 4, 2048, 128
    atol, rtol = ATTN_TOL[torch.bfloat16]
    calls = []
    for lengths in ((1, 700, 2048, 33), (2048, 0, 5, 1500)):
        q = torch.randn((b, h, hd), generator=g, device=dev).to(torch.bfloat16)
        ck = torch.randn((b, t, kvh, hd), generator=g, device=dev).to(torch.bfloat16)
        cv = torch.randn((b, t, kvh, hd), generator=g, device=dev).to(torch.bfloat16)
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        want = ref.flash_decode_ref(q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2),
                                    length)[:, :, 0]
        calls.append(((q, ck, cv, length), want))
    torch.cuda.synchronize()
    before = kernels.launch_counts()["flash_decode"]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(5):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[i].append(flash_decode.flash_decode_cache(*calls[i][0]))
    torch.cuda.synchronize()
    for i in range(2):
        torch.testing.assert_close(outs[i][0].float(), calls[i][1].float(), atol=atol, rtol=rtol)
        assert all(torch.equal(o, outs[i][0]) for o in outs[i])
    row = [flash_decode.flash_decode_cache(*calls[0][0]) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0][0]) for o in row)
    assert kernels.launch_counts()["flash_decode"] == before + 60


ATTN_CASES = [
    (2, 4, 4, 512, 64, True, 0),
    (1, 2, 2, 1024, 128, True, 0),
    (1, 2, 2, 512, 64, True, 200),
    (1, 2, 2, 256, 64, False, 0),
    (1, 4, 2, 300, 128, False, 100),
    (2, 8, 2, 1000, 128, True, 333),
    (1, 16, 2, 700, 64, True, 0),
    (2, 16, 2, 640, 128, False, 0),
    (1, 16, 2, 1100, 128, True, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,s,hd,causal,window", ATTN_CASES)
def test_flash_attention_kernel(dev, b, h, kvh, s, hd, causal, window, dtype):
    """bfloat16 runs the wgmma kernel, float32 the 3xTF32 wgmma kernel; KV
    heads H or H/8 (GQA), read through strides from a (B, S, KVH, hd) layout
    too."""
    g = torch.Generator(device=dev).manual_seed(s + hd)
    q = torch.randn((b, h, s, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, kvh, s, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, kvh, s, hd), generator=g, device=dev).to(dtype)
    key = "flash_attention" if dtype == torch.bfloat16 else "flash_attention_f32"
    before = kernels.launch_counts()[key]
    copies = flash_attention.LAYOUT_COPIES["flash_attention"]
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[key] == before + 1
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # (B, S, H, hd) layouts, read through strides (no layout copy)
    def bshd(x):
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    got_t = flash_attention.flash_attention(bshd(q), bshd(k), bshd(v), causal=causal,
                                            window=window)
    assert torch.equal(got_t, got)
    assert flash_attention.LAYOUT_COPIES["flash_attention"] == copies


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,causal,window", [(128, True, 0), (64, True, 0), (128, True, 512),
                                              (128, False, 0)])
def test_flash_attention_bf16_limit_flags_a_dropped_tile(dev, hd, causal, window, dtype):
    """Each kernel passes its dtype's limit (bf16: the wgmma kernel; f32: the
    3xTF32 kernel), and the limit flags the twin with one tile of 64 keys
    dropped (the window, or the whole row, 64 keys narrower)."""
    g = torch.Generator(device=dev).manual_seed(hd)
    s = 2048
    q, k, v = (torch.randn((1, 8, s, hd), generator=g, device=dev).to(dtype)
               for _ in range(3))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window).float()
    atol, rtol = ATTN_TOL[dtype]
    limit = atol + rtol * want.abs()
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window).float()
    assert bool(((got - want).abs() <= limit).all())
    fault = ref.flash_attention_ref(q, k, v, causal=causal, window=(window or s) - 64).float()
    assert bool(((fault - want).abs() > limit).any())


def test_flash_attention_bf16_unaligned_strides_are_copied(dev):
    """A bf16 tensor whose strides TMA cannot take (here a seq stride of
    hd + 1 elements) is copied once to a contiguous layout and counted."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 2, 256, 65), generator=g, device=dev).to(torch.bfloat16)[..., :64]
    k, v = (torch.randn((1, 2, 256, 64), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    copies = flash_attention.LAYOUT_COPIES["flash_attention"]
    got = flash_attention.flash_attention(q, k, v)
    assert flash_attention.LAYOUT_COPIES["flash_attention"] == copies + 1
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v).float(),
                               atol=4e-3, rtol=2 ** -8)


def test_yi_9b_two_layers_full_width_served_through_k10(dev):
    """yi-9b at full width (d 4096, 32 heads, 4 KV heads, vocab 64000), two
    layers, bf16: the K10 path's decode logits against the eager path's on
    the same cache (teacher forced), and greedy generate twice equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.policy import compute_policy
    from repro_torch.models.transformer import forward, init_decode_cache, init_model
    from repro_torch.serve import Engine, ServeConfig
    import dataclasses

    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=2)
    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 136), generator=g, device=dev)
    full, _, _ = forward(model, cfg, tokens)
    for flash in (False, True):
        cache = init_decode_cache(cfg, 4, 256, device=dev)
        before = kernels.launch_counts()["flash_decode"]
        with compute_policy(flash_decode=flash):
            forward(model, cfg, tokens[:, :128], cache=cache)
            for i in range(128, 136):
                got, cache, _ = forward(model, cfg, tokens[:, i:i + 1],
                                        positions=torch.full((4, 1), i, device=dev),
                                        cache=cache)
                err = (got[:, 0].float() - full[:, i].float()).abs().max().item()
                scale = full[:, i].float().abs().max().item()
                assert err <= 0.05 * scale, (flash, i, err, scale)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["flash_decode"] - before == (8 * 2 if flash else 0)
    engine = Engine(cfg, ServeConfig(max_seq=256, batch_size=4), model, device=dev)
    with compute_policy(flash_decode=True):
        a = engine.generate(tokens[:, :100], 12)
        b = engine.generate(tokens[:, :100], 12)
    assert torch.equal(a, b) and a.shape == (4, 12)


# ---------------------------------------------------------------------------
# the 64-bit forms of K1, K1r, K4 level_fused_batched and K3, and the sorts
# on every key dtype


def _level_edge64(dev, case, radix):
    """``_level_edge``'s cases with int64 keys over the whole int64 range
    (a CTA of 32 warps is MAX_TILE64 here) and the sentinel LLONG_MAX."""
    k, n, n_real, tile = 128, 50_000, 49_001, lf.TILE
    if case == "tile MAX_TILE":
        tile, n, n_real = lf.MAX_TILE64, 3 * lf.MAX_TILE64 + 777, 3 * lf.MAX_TILE64 + 500
    elif case == "tile 33":
        tile, n, n_real = 33, 5000, 4990
    elif case == "k=2":
        k = 2
    elif case == "largest k":
        k = 1 << ((lf.MAX_NB - 1) // 2).bit_length() - 1
    elif case == "all pads":
        n_real = 0
    rng = np.random.default_rng(n + k)
    x = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    x[rng.random(n) < 0.5] = x[0]  # a heavy duplicate
    keys = torch.as_tensor(x, device=dev)
    keys[::53] = torch.iinfo(torch.int64).max  # the sentinel: an equality bucket
    spl = sampling.select_splitters(torch.sort(keys[:8192]).values, k)
    if case == "all on one splitter":
        keys.fill_(int(spl[k // 2]))
    kw = dict(k=k, n_real=n_real, tile=tile, classifier="radix" if radix else "tree")
    return keys, None if radix else spl, kw


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("case", LEVEL_EDGE_CASES)
def test_level_fused64_kernel_edges(dev, case, classifier):
    """K1's and K1r's 64-bit form bit for bit its plain twin at the edges of
    its CTA shape (one warp per 256 positions) and of the classifier."""
    keys, spl, kw = _level_edge64(dev, case, classifier == "radix")
    name = ("level_fused_radix" if classifier == "radix" else "level_fused") + "64"
    before = kernels.launch_counts()[name]
    _equal(lf.level_fused(keys, spl, **kw), lf.level_fused_plain(keys, spl, **kw))
    assert kernels.launch_counts()[name] == before + 1


@pytest.mark.parametrize("consumed", [0, 7, 57, 60])
def test_level_fused_radix64_kernel_shifts(dev, consumed):
    """K1r's 64-bit digit at level 1, level 2 and shifts clamped at 0."""
    g = torch.Generator(device=dev).manual_seed(consumed)
    keys = torch.randint(-2**63, 2**63 - 1, (70_000,), generator=g, device=dev,
                         dtype=torch.int64)
    keys[::97] = torch.iinfo(torch.int64).max
    kw = dict(k=128, n_real=65_537, classifier="radix", consumed_bits=consumed)
    _equal(lf.level_fused(keys, **kw), lf.level_fused_plain(keys, **kw))


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("case", ["tile MAX_TILE", "tile 33", "largest k", "all pads"])
def test_level_fused_batched64_kernel_edges(dev, case, classifier):
    keys, spl, kw = _level_edge64(dev, case, classifier == "radix")
    rows = torch.stack([keys, keys.flip(0), keys.roll(7)])
    if spl is not None:
        spl = torch.stack([spl, spl, sampling.select_splitters(
            torch.sort(rows[2, :8192]).values, kw["k"])])
    before = kernels.launch_counts()["level_fused_batched64"]
    _equal(lf.level_fused_batched(rows, spl, **kw), lf.level_fused_batched_plain(rows, spl, **kw))
    assert kernels.launch_counts()["level_fused_batched64"] == before + 1


def test_level_fused64_launch_does_not_spill(dev):
    for radix in (False, True):
        for tile in (lf.TILE, lf.MAX_TILE64):
            info = lf.launch_info(128, tile, radix, key_bits=64)
            assert info["local_bytes"] == 0 and info["threads"] == tile // 256 * 32


@pytest.mark.parametrize("case", SORT_WINDOWS_CASES[:-1])
@pytest.mark.parametrize("W", [2, 8, 16, 32, 256, 1024, 4096, 8192, 16384])
def test_sort_windows64_kernel(dev, W, case):
    """K3's 64-bit form bit for bit its plain twin, keys over the whole
    int64 range with heavy duplicates and the extremes, descending windows
    and equal keys across the merge's runs."""
    g = torch.Generator(device=dev).manual_seed(W + 64)
    num_w = {"one window": 1, "2049 windows": 2049}.get(case, 5)
    b = torch.randint(0, 9, (num_w, W), generator=g, device=dev, dtype=torch.int32)
    k = torch.randint(-3, 4, (num_w, W), generator=g, device=dev, dtype=torch.int64)
    k[:, : W // 4] += torch.iinfo(torch.int64).max - 3
    k[:, W // 4: W // 2] = torch.iinfo(torch.int64).min + (k[:, W // 4: W // 2] + 3)
    b, k = _window_case(case, b, k)
    before = kernels.launch_counts()["sort_windows64"]
    _equal(bitonic.sort_windows(b, k, nb=9), bitonic.sort_windows_plain(b, k, nb=9))
    assert kernels.launch_counts()["sort_windows64"] == before + 1


def test_sort_windows64_launch_does_not_spill(dev):
    for log2w in range(1, 15):
        info = bitonic.launch_info(1 << log2w)
        assert info["local_bytes"] == 0 and info["ctas_per_sm"] >= 1, (1 << log2w, info)


ALL_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.uint16, torch.float16, torch.bfloat16,
              torch.int32, torch.uint32, torch.float32, torch.int64, torch.uint64, torch.float64]


@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_every_key_dtype_on_the_card_matches_the_cpu(dev, dtype):
    """``ops.sort``, ``argsort``, ``topk`` and ``batched_sort`` on the card
    equal the plain twins' on the CPU, keys compared through integer
    views, NaN of both signs and the extremes included; 64-bit keys run
    the 64-bit kernels."""
    bits = ops.keyspace.key_bits(dtype)
    signed = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}[bits]
    rng = np.random.default_rng(bits)
    raw = rng.integers(-2**63, 2**63 - 1, 300_000, dtype=np.int64, endpoint=True)
    x = torch.as_tensor(raw).to(signed) if bits < 64 else torch.as_tensor(raw)
    x = x.view(dtype)
    if dtype.is_floating_point:
        x[::31] = float("nan")
        x[1::37] = -0.0
    wide = bits == 64
    before = dict(kernels.launch_counts())
    for classifier in ("tree", "radix"):
        got = ops.argsort(x, classifier=classifier).cpu()
        assert torch.equal(got, ops.argsort(x, classifier=classifier, device="cpu"))
        assert torch.equal(ops.sort(x.to(dev), classifier=classifier).cpu().view(signed),
                           ops.sort(x, classifier=classifier, device="cpu").view(signed))
    v, i = ops.topk(x.to(dev), 1024)
    wv, wi = ops.topk(x, 1024, device="cpu")
    assert torch.equal(v.cpu().view(signed), wv.view(signed)) and torch.equal(i.cpu(), wi)
    rows = x[: 4 * 65536].reshape(4, 65536)
    assert torch.equal(ops.batched_sort(rows.to(dev)).cpu().view(signed),
                       ops.batched_sort(rows, device="cpu").view(signed))
    after = kernels.launch_counts()
    for name in ("level_fused", "level_fused_radix", "level_fused_batched", "sort_windows"):
        assert after[name + ("64" if wide else "")] > before[name + ("64" if wide else "")]


@pytest.mark.parametrize("dist", ["Uniform", "Exponential", "TwoDup", "Zipf"])
def test_learned_sorts_on_the_card(dev, dist):
    """``ops.sort``/``argsort`` and ``batched_sort`` with the learned
    classifier equal ``torch.sort(stable=True)`` of the encoded keys; level
    1 places the model's ids with K2 (K4 ``rank_hist_batched`` for rows), or
    runs the tree through K1 when the fit falls back."""
    from repro_torch.classify import learned

    if dist == "Zipf":
        raw = np.random.default_rng(4).zipf(1.3, 1 << 20).astype(np.float32)
    else:
        raw = make_input(dist, 1 << 20, np.float32, seed=4)
    x = torch.as_tensor(raw, device=dev)
    enc = ops.keyspace.encode(x)
    want = torch.sort(enc, stable=True)
    learned.ROUTES.clear()
    before = dict(kernels.launch_counts())
    assert torch.equal(ops.keyspace.encode(ops.sort(x, classifier="learned")), want.values)
    assert torch.equal(ops.argsort(x, classifier="learned").to(torch.int64), want.indices)
    after = kernels.launch_counts()
    if learned.ROUTES["model"]:
        assert after["rank_hist"] - before["rank_hist"] >= 4  # levels 1 and 2, twice
    else:
        assert after["level_fused"] > before["level_fused"]
    rows = x.reshape(16, 1 << 16)
    got = ops.batched_sort(rows, classifier="learned")
    assert torch.equal(ops.keyspace.encode(got),
                       torch.sort(ops.keyspace.encode(rows), dim=1, stable=True).values)
    assert torch.equal(ops.batched_argsort(rows, classifier="learned").to(torch.int64),
                       torch.sort(ops.keyspace.encode(rows), dim=1, stable=True).indices)


def test_uint64_to_float32_cast_on_the_card(dev):
    """The learned model's float map of 64-bit codes (a uint64 view cast to
    float32) rounds on the card as on the CPU: the boundary codes, halfway
    cases that round to even, and random codes."""
    from repro_torch.classify.learned import _to_float

    u = np.array([0, 1, 2**24 - 1, 2**24 + 1, 2**24 + 3, 2**40 + 2**16, 2**40 + 3 * 2**16,
                  2**63 - 2**39, 2**63 - 1, 2**63, 2**63 + 1, 2**63 + 2**39, 2**64 - 2**39,
                  2**64 - 1], np.uint64)
    rand = np.random.default_rng(9).integers(0, 2**64 - 1, 1 << 16, dtype=np.uint64,
                                             endpoint=True)
    codes = torch.from_numpy(np.concatenate([u, rand]).view(np.int64).copy()) \
        ^ torch.iinfo(torch.int64).min
    want = _to_float(codes)
    assert torch.equal(_to_float(codes.to(dev)).cpu().view(torch.int32), want.view(torch.int32))
    # and the CPU's is numpy's correctly rounded cast
    np.testing.assert_array_equal(want.numpy().view(np.uint32),
                                  np.concatenate([u, rand]).astype(np.float32).view(np.uint32))


def test_tiebreak_passes_on_the_card(dev):
    """Tie-heavy three-word records (a few values a word): the card's
    records argsort and sort with a payload equal the CPU's and
    ``np.lexsort``."""
    rng = np.random.default_rng(10)
    words = rng.integers(0, 3, (1 << 20, 3)).astype(np.int32)
    words[::7, 2] = np.iinfo(np.int32).max
    w = torch.as_tensor(words, device=dev)
    order = ops.argsort_records(w).cpu()
    np.testing.assert_array_equal(order.numpy(), np.lexsort(words.T[::-1]))
    for clf in ("tree", "radix", "learned"):
        out, v = ops.sort_records(w, {"id": torch.arange(1 << 20, device=dev)}, classifier=clf)
        assert torch.equal(v["id"].cpu(), order.to(torch.int64))
        assert torch.equal(out.cpu(), torch.as_tensor(words)[order.to(torch.int64)])


def test_pytree_payload_through_the_batched_path_on_the_card(dev):
    """A nested payload (int64 ids, (n, 4) float32 rows, bfloat16, bool,
    uint32 and a None leaf) through ``batched_sort`` on the card equals the
    gather by the stable per-row argsort, and the CPU's run."""
    B, n = 8, 1 << 16
    x = torch.as_tensor(make_input("TwoDup", B * n, np.float32, seed=11), device=dev).view(B, n)
    gen = torch.Generator(device=dev).manual_seed(11)
    vals = {"id": torch.arange(B * n, device=dev).view(B, n),
            "rows": torch.randn(B, n, 4, device=dev, generator=gen),
            "more": (torch.randn(B, n, device=dev, generator=gen).to(torch.bfloat16),
                     torch.rand(B, n, device=dev, generator=gen) < 0.5,
                     torch.randint(0, 2**31, (B, n), device=dev, generator=gen,
                                   dtype=torch.int32).view(torch.uint32)),
            "none": None}
    keys, got = ops.batched_sort(x, vals)
    order = torch.sort(ops.keyspace.encode(x), dim=1, stable=True).indices
    assert torch.equal(got["id"], torch.gather(vals["id"], 1, order))
    assert torch.equal(got["rows"], torch.gather(vals["rows"], 1, order[..., None].expand(B, n, 4)))
    for g, v in zip(got["more"], vals["more"]):
        signed = {torch.uint32: torch.int32}.get(v.dtype, v.dtype)
        assert g.dtype == v.dtype
        assert torch.equal(g.view(signed), torch.gather(v.view(signed), 1, order))
    assert got["none"] is None
    cpu_keys, cpu_vals = ops.batched_sort(x.cpu(), {"id": vals["id"].cpu()}, device="cpu")
    assert torch.equal(cpu_vals["id"], got["id"].cpu()) and torch.equal(cpu_keys, keys.cpu())


def test_plan_cache_on_the_card(dev, tmp_path):
    """A tuned plan, a classifier race and a tuned stream plan on the card,
    persisted and reloaded; their sorters are right."""
    from repro_torch.ops import plan

    pc = plan.PlanCache(str(tmp_path / "plans.json"))
    x = torch.rand(1 << 18, device=dev)
    f = pc.get_sorter(1 << 18, torch.float32, tune=True, device=dev)
    assert torch.equal(f(x), torch.sort(x).values)
    from repro_torch.classify import classifier_for

    clf = classifier_for(x, cache=pc)
    tile = pc.stream_plan(1 << 16, 4, torch.float32, tune=True, device=dev).merge_tile
    again = plan.PlanCache(pc.path)
    assert again.config_for("sort", 1 << 18, torch.float32) == \
        pc.config_for("sort", 1 << 18, torch.float32)
    assert again.classifier_plan(1 << 18, torch.float32, dist="uniform") == clf
    assert again.stream_plan(1 << 16, 4, torch.float32).merge_tile == tile
    host = np.random.default_rng(12).standard_normal(1 << 18).astype(np.float32)
    out = stream.external_sort(host, chunk_size=1 << 16, cache=pc, tune=True, device=dev)
    np.testing.assert_array_equal(out, np.sort(host))


# -- observability and the distributed sort on the card ----------------------


def _sorted_codes(x):
    return torch.sort(ops.keyspace.encode(x), stable=True).values


def test_obs_span_device_times_present_and_nested(dev):
    """obs enabled: every span of ``ops.sort`` gets a ``device_ms`` (CUDA
    events, read at ``span_stats``), and a span's children take no more
    device time than the span (+1 us for the events' resolution)."""
    from repro_torch import obs

    x = torch.rand(1 << 20, device=dev)
    obs.enabled(True)
    obs.reset()
    try:
        out = ops.sort(x)
        stats = obs.span_stats()
        spans = list(obs.recorder().spans)
    finally:
        obs.enabled(False)
        obs.reset()
    assert torch.equal(ops.keyspace.encode(out), _sorted_codes(x))
    assert {"ops.sort", "ips4o_sort", "level_pass", "base_case"} <= set(stats)
    assert all("device_ms" in s for s in spans)
    for s in spans:
        kids = [c for c in spans if c["parent"] == s["id"]]
        assert sum(c["device_ms"] for c in kids) <= s["device_ms"] + 1e-3


def _launches_and_syncs(fn):
    """(runtime launch calls by torch.profiler, synchronizing calls flagged by
    ``torch.cuda.set_sync_debug_mode``) of one call of ``fn``."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key
                and e.device_type != torch.autograd.DeviceType.CUDA)
    counted = []
    for _ in range(2):  # the first call under the debug mode also flags a
        # one-time sync of torch's own (torch/cuda/__init__.py): the second counts
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counted.append(sum(1 for w in caught if "synchroniz" in str(w.message)))
    return calls, counted[-1]


def test_obs_disabled_launches_and_syncs_as_noop_hooks(dev, monkeypatch):
    import contextlib

    from repro_torch import obs

    x = torch.rand(1 << 20, device=dev)
    disabled = _launches_and_syncs(lambda: ops.sort(x))
    monkeypatch.setattr(obs, "trace", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(obs, "block", lambda v: v)
    monkeypatch.setattr(obs, "enabled", lambda *a: False)
    for name in ("count", "gauge", "observe", "jit_count", "jit_observe", "jit_event"):
        monkeypatch.setattr(obs, name, lambda *a, **k: None)
    assert disabled[0] > 0
    assert _launches_and_syncs(lambda: ops.sort(x)) == disabled


def test_dist_sort_world_size_1_on_nccl_equals_ops_sort(dev, tmp_path):
    """NCCL reaches world size 1 only on one card."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import dist

    x = torch.rand(1 << 20, device=dev)
    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                             world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        kernels.reset_launch_counts()
        keys, counts, ovf = dist.sort(x, mesh)
        order, _, _ = dist.argsort(x, mesh)
        launches = kernels.launch_counts()
    finally:
        tdist.destroy_process_group()
    n = x.shape[0]
    assert int(counts[0]) == n and not bool(ovf[0])
    assert torch.equal(keys[:n], ops.sort(x))
    assert torch.equal(order[:n], ops.argsort(x))
    assert all(launches[k] > 0 for k in ("level_fused", "rank_hist", "sort_windows"))


def test_exchange_placement_launches_k2(dev):
    """The exchange's (groups + 1)-bucket placement and its compaction run
    K2 on a CUDA tensor (a one-rank group stands in for the collectives;
    radix destinations, so no sample differs between the devices) and
    equal the plain twin's on the CPU."""
    from repro_torch.dist import exchange
    from repro_torch.dist.levels import Level

    n, g = 1 << 16, 4
    level = Level(axis="data", domain=("data",), groups=g, n_in=n, capacity=n // 2,
                  oversample=64)
    one = exchange.Group(None, 1, 0)
    keys = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32)
    got = {}
    for where in ("cuda", "cpu"):
        arrays = {"k": keys.to(where), "v": torch.arange(n, device=where)}
        kernels.reset_launch_counts()
        out, m, ovf = exchange.exchange_level(arrays, torch.tensor(n - 100, device=where), level,
                                              domain=one, axis=one, tile=4096, seed=1,
                                              level_idx=0, classifier="radix")
        got[where] = (out, int(m), bool(ovf), kernels.launch_counts()["rank_hist"])
    assert got["cuda"][3] >= 2 and got["cpu"][3] == 0  # placement + compaction
    assert got["cuda"][1:3] == got["cpu"][1:3]
    for name in ("k", "v"):
        assert torch.equal(got["cuda"][0][name].cpu(), got["cpu"][0][name])


# ---------------------------------------------------------------------------
# the MoE dispatch (K6), K10 at the new families' shapes, the scheduler and
# the new families on the card


@pytest.mark.parametrize("rows,m,experts,cap", [
    (1, 8192 * 6, 64, 960),    # deepseek-moe-16b's prefill routing (drops at cap 960)
    (1, 48, 64, 8),            # its decode step (8 tokens x top-6)
    (28, 1024 * 6, 64, 120),   # every layer of a step in one call
    (3, 5000, 128, 40),        # qwen3-moe's 128 experts, a ragged m
])
def test_sort_dispatch_k6_matches_the_plain_dispatch(dev, rows, m, experts, cap):
    from repro_torch.models.moe import sort_dispatch

    rng = np.random.default_rng(m + rows)
    e = rng.integers(0, experts, (rows, m)).astype(np.int32)
    e[:, ::5] = 3  # skew: expert 3 overflows its capacity
    ids = torch.as_tensor(e if rows > 1 else e[0])
    name = "partition_ranks_batched" if rows > 1 else "dispatch_ranks"
    before = kernels.launch_counts()[name]
    got = sort_dispatch(ids.to(dev), experts, cap)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = sort_dispatch(ids, experts, cap)  # the plain twin: partition_permutation
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.cpu(), w_)
    assert int((~got[1]).sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,hd,lengths", [
    (8, 16, 4096, 128, (1056,) * 8),            # deepseek-moe-16b: group 1, mma.sync
    (8, 32, 4096, 80, (1056,) * 8),             # zamba2-2.7b: group 1, hd 80, FMA
    (3, 32, 1024, 80, (1, 513, 1024)),
])
def test_flash_decode_kernel_group_one(dev, b, h, t, hd, lengths, dtype):
    g = torch.Generator(device=dev).manual_seed(hd + b)
    q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
    ck = torch.randn((b, t, h, hd), generator=g, device=dev).to(dtype)
    cv = torch.randn((b, t, h, hd), generator=g, device=dev).to(dtype)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = flash_decode.flash_decode_cache(q, ck, cv, length)
    want = ref.flash_decode_ref(q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2),
                                length)[:, :, 0]
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    info = flash_decode.launch_info(b, h, 1, hd, dtype)
    assert bool(info["tensor_cores"]) == (dtype == torch.bfloat16 and hd == 128)


def test_scheduler_on_the_card_matches_the_host_oracle(dev):
    from repro_torch.serve.scheduler import Request, Scheduler, admit_many

    rng = np.random.default_rng(9)
    rem = rng.integers(1, 64, 4096)
    s = Scheduler(batch_size=256, device=dev)
    for uid, m in enumerate(rem):
        s.submit(Request(uid=uid, prompt_len=1, max_new=int(m)))
    order = list(np.lexsort((np.arange(len(rem)), rem)))
    for i in range(3):
        assert [r.uid for r in s.next_batch()] == order[i * 256:(i + 1) * 256]
    back = rng.integers(1, 64, 1000)
    s.attach_backlog([Request(uid=10_000 + i, prompt_len=1, max_new=int(m))
                      for i, m in enumerate(back)])
    live = np.asarray([r.remaining for r in s.queue])
    both = np.concatenate([back[np.lexsort((np.arange(len(back)), back))],
                           np.sort(live, kind="stable")])
    want_rem = np.sort(both, kind="stable")[:256]
    got = s.next_batch()
    assert [r.remaining for r in got] == want_rem.tolist()
    fleet = [Scheduler(batch_size=8, device=dev) for _ in range(5)]
    for j, f in enumerate(fleet):
        for uid, m in enumerate(rng.integers(1, 5, 30 + 17 * j)):
            f.submit(Request(uid=uid, prompt_len=1, max_new=int(m)))
    want = []
    for f in fleet:
        r = np.asarray([q.remaining for q in f.queue])
        want.append(list(np.lexsort((np.arange(len(r)), r))[:8]))
    assert [[r.uid for r in b] for b in admit_many(fleet)] == want


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_reduced_family_on_the_card_matches_the_cpu(dev, arch):
    """The reduced model's forward and prefill + K10 decode on the card
    against the same model on the CPU (float32: cuBLAS and the CPU's
    products in other summation orders; 1e-3 on logits of ~4), and two
    greedy ``generate`` calls equal.  The states the reference keeps in
    bfloat16 (RWKV's shifts, Mamba2's conv) are made float32 on both sides
    here, so that a last-bit difference cannot round a state entry to a
    neighbouring bfloat16 value (2.5e-3 seen on rwkv6 with them, on an H100)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.policy import compute_policy
    from repro_torch.models.transformer import forward, init_decode_cache, init_model
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_reduced(arch)
    cpu = init_model(torch.Generator().manual_seed(0), cfg, dtype=torch.float32, device="cpu")
    card = init_model(torch.Generator().manual_seed(0), cfg, dtype=torch.float32,
                      device="cpu").to(dev)
    x = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    want, _, _ = forward(cpu, cfg, x)
    got, _, _ = forward(card, cfg, x.to(dev))
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
    caches = [init_decode_cache(cfg, 2, 64, dtype=torch.float32, device=d)
              for d in ("cpu", dev)]
    for c in (c for cache in caches for c in cache["layers"]):
        for name in ("tm_shift", "cm_shift", "conv"):
            if name in c:
                c[name] = c[name].float()
    with compute_policy(flash_decode=True):
        for m, c, d in ((cpu, caches[0], "cpu"), (card, caches[1], dev)):
            forward(m, cfg, x[:, :16].to(d), cache=c)
        for i in range(16, 24):
            pos = torch.full((2, 1), i)
            w, _, _ = forward(cpu, cfg, x[:, i:i + 1], positions=pos, cache=caches[0])
            g_, _, _ = forward(card, cfg, x[:, i:i + 1].to(dev), positions=pos.to(dev),
                               cache=caches[1])
            torch.testing.assert_close(g_.cpu(), w, atol=1e-3, rtol=1e-3)
        engine = Engine(cfg, ServeConfig(max_seq=64, batch_size=2), card, device=dev)
        a = engine.generate(x[:, :16].to(dev), 6)
        b = engine.generate(x[:, :16].to(dev), 6)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch,tol", [("yi-9b", 1e-4), ("deepseek-moe-16b", 1e-4),
                                      ("rwkv6-1.6b", 5e-4), ("zamba2-2.7b", 5e-4)])
def test_reduced_train_step_on_the_card_matches_the_cpu(dev, arch, tol):
    """The reduced model's training loss and every gradient on the card
    against the CPU (float32; each leaf within ``tol`` of its largest CPU
    gradient: cuBLAS and the CPU's kernels sum in other orders; rwkv6 and
    zamba2 at 5e-4, the bound their gradients are held to against the
    reference on the CPU, for their recurrences and chunked cumulative
    sums: 1.01e-4 seen for zamba2 on an H100), K6
    dispatching every MoE layer twice (forward and remat's recompute), and
    the card's loss and gradients bit for bit equal on a second call."""
    import copy

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import init_model
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import _accumulate_grads

    cfg = get_reduced(arch)
    cpu = init_model(torch.Generator().manual_seed(2), cfg, dtype=torch.float32, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    batch = SyntheticLM(cfg.vocab_size, 64, 4, seed=1).batch(0)

    def run(model, d, tcfg):
        model.requires_grad_(True)
        loss, _, grads = _accumulate_grads(cfg, tcfg, model,
                                           {k: torch.as_tensor(v, device=d) for k, v in batch.items()})
        return loss, [t for v in grads.values() for t in (v if isinstance(v, tuple) else (v,))]

    for tcfg in (TrainConfig(), TrainConfig(microbatch=2)):
        want_loss, want = run(cpu, "cpu", tcfg)
        kernels.reset_launch_counts()
        loss, got = run(card, dev, tcfg)
        torch.cuda.synchronize()
        if cfg.family == "moe":
            steps = 4 // (tcfg.microbatch or 4)
            assert kernels.launch_counts()["dispatch_ranks"] == 2 * cfg.num_layers * steps
        torch.testing.assert_close(loss.cpu(), want_loss, atol=0, rtol=1e-5)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(g.cpu(), w, rtol=0,
                                       atol=tol * float(w.abs().max()) + 1e-30)
        again_loss, again = run(card, dev, tcfg)
        assert torch.equal(loss, again_loss) and all(torch.equal(a, b) for a, b in zip(got, again))


def test_trainer_on_the_card_restarts_bitwise(dev, tmp_path):
    """Reduced deepseek-moe-16b (bf16, int8 moments, compressed gradients)
    through ``Trainer`` on the card: 6 steps straight equal 3 steps, a
    checkpoint, a restore in a fresh trainer and 3 more, bit for bit."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_reduced("deepseek-moe-16b")
    tcfg = TrainConfig(microbatch=2, warmup_steps=2, total_steps=6, compress_grads=True,
                       adamw=AdamWConfig(lr=1e-3, m_dtype="int8"))
    data = lambda: iter(SyntheticLM(cfg.vocab_size, 32, 4, seed=7))
    quiet = dict(log_every=100, log=lambda *_: None)
    t0 = Trainer(cfg, tcfg, seed=0, device=dev)
    t0.init_state()
    t0.run(data(), 6, ckpt_every=100, **quiet)
    ck = str(tmp_path / "ck")
    t1 = Trainer(cfg, tcfg, ckpt_dir=ck, seed=0, device=dev)
    t1.init_state()
    t1.run(data(), 3, ckpt_every=3, **quiet)
    t2 = Trainer(cfg, tcfg, ckpt_dir=ck, seed=0, device=dev)
    t2.init_state()
    assert t2.maybe_restore() and t2.step_num == 3
    it = data()
    for _ in range(3):
        next(it)
    t2.run(it, 3, ckpt_every=100, **quiet)
    a, b = pytree.tree_leaves(t0._tree()), pytree.tree_leaves(t2._tree())
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---- G1-G4: the sort's glue (csrc/glue.cu) against its plain twins ---------

def _glue_offsets(g, rows, nb, n, case, dev):
    """(rows, nb+1) int32 offsets from 0 to n: random cuts, runs of empty
    buckets, or every bucket empty but one."""
    cuts = torch.sort(torch.randint(0, n + 1, (rows, nb - 1), generator=g, device=dev,
                                    dtype=torch.int32), dim=1).values
    if case == "empty runs":
        cuts[:, : nb // 3] = 0
        cuts[:, -(nb // 3):] = n
    elif case == "one bucket":
        cuts[:] = n // 2
    return torch.cat([torch.zeros((rows, 1), dtype=torch.int32, device=dev), cuts,
                      torch.full((rows, 1), n, dtype=torch.int32, device=dev)], 1)


@pytest.mark.parametrize("B,n,tile,k", [(1, 70000, 1024, 128), (3, 10000, 33, 2),
                                        (2, 4096 * 40 + 1, 4096, 256), (1, 5, 4096, 4)])
def test_close_placement_kernel(dev, B, n, tile, k):
    """G1 on K4's tile histograms: runs past 32 stretches, nb above a pass
    of the offsets' scan, a ragged last tile, one tile."""
    from repro_torch.kernels import glue

    g = torch.Generator(device=dev).manual_seed(n)
    keys = torch.randint(-1000, 1000, (B, n), generator=g, device=dev, dtype=torch.int32)
    spl = torch.sort(torch.randint(-1000, 1000, (B, k - 1), generator=g, device=dev,
                                   dtype=torch.int32), dim=1).values
    bucket, rank, hist = lf._level_tiles_kernel(keys, spl, k, max(1, n - 7), tile, batched=True)
    before = kernels.launch_counts()["close_placement"]
    got = glue.close_placement(bucket, rank, hist, 2 * k + 1, tile)
    assert kernels.launch_counts()["close_placement"] == before + 1
    _equal(got, glue.close_placement_plain(bucket, rank, hist, 2 * k + 1, tile))


@pytest.mark.parametrize("rows,nb,n,case", [(1, 257, 1 << 20, "random"),
                                            (1, 65792, 1 << 20, "random"),
                                            (4, 3000, 5000, "empty runs"),
                                            (2, 9, 4096 * 3 + 5, "one bucket"),
                                            (1, 100000, 100000, "random")])
def test_segment_ids_kernel(dev, rows, nb, n, case):
    """G2 with empty buckets at both ends, spans holding more bucket starts
    than its stage, one bucket, B rows, and one row's (nb+1,) form."""
    from repro_torch.kernels import glue

    g = torch.Generator(device=dev).manual_seed(nb)
    off = _glue_offsets(g, rows, nb, n, case, dev)
    before = kernels.launch_counts()["segment_ids"]
    _equal(glue.segment_ids(off, n), glue.segment_ids_plain(off, n))
    _equal(glue.segment_ids(off[0], n), glue.segment_ids_plain(off[0], n))
    assert kernels.launch_counts()["segment_ids"] == before + 2


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,num_seg,n,k,radix", [(1, 257, 1 << 20, 128, False),
                                                    (8, 257, 1 << 14, 2, False),
                                                    (1, 257, 1 << 20, 128, True),
                                                    (2, 5000, 6000, 4, False),
                                                    (1, 1, 100, 2, False)])
def test_composite_ids_kernel(dev, dtype, rows, num_seg, n, k, radix):
    """G3 in both modes on int32 and int64 keys: keys on the splitters, at
    the extremes and on the sentinel, an empty last segment, spans whose
    segments' splitters do not fit its stage (5000 segments)."""
    from repro_torch.kernels import glue

    g = torch.Generator(device=dev).manual_seed(num_seg + n)
    info = torch.iinfo(dtype)
    keys = torch.randint(-50, 50, (rows, n), generator=g, device=dev, dtype=dtype)
    if radix:
        keys = torch.randint(info.min, info.max, (rows, n), generator=g, device=dev, dtype=dtype)
    keys[:, ::7] = info.max
    keys[:, 1::11] = info.min
    off = _glue_offsets(g, rows, num_seg, n, "random", dev)
    if num_seg > 1:
        off[:, -2] = n  # an empty last segment
    spl = None
    if not radix:
        spl = torch.sort(torch.randint(-50, 50, (rows, num_seg, k - 1), generator=g, device=dev,
                                       dtype=dtype), dim=-1).values
        keys[:, 2::13] = spl.reshape(rows, -1)[:, :1]
    name = "composite_ids" + ("64" if dtype == torch.int64 else "")
    for consumed in ((0, 7) if radix else (0,)):
        before = kernels.launch_counts()[name]
        got = glue.composite_ids(keys, off, num_seg, k, spl, consumed)
        assert kernels.launch_counts()[name] == before + 1
        _equal(got, glue.composite_ids_plain(keys, off, num_seg, k, spl, consumed))


def _glue_leaves(g, lead, dev):
    """Payload leaves of 1, 2, 4, 8, 12 and 16 bytes a row and a 3-byte one."""
    return {
        "b": torch.rand(lead, generator=g, device=dev) < 0.5,
        "h": torch.randn(lead, generator=g, device=dev).to(torch.bfloat16),
        "k": torch.randint(-9, 9, lead, generator=g, device=dev, dtype=torch.int32),
        "q": torch.randint(-9, 9, lead, generator=g, device=dev, dtype=torch.int64),
        "w3": torch.randn(lead + (3,), generator=g, device=dev),
        "c4": torch.randn(lead + (4,), generator=g, device=dev),
        "u3": torch.randint(0, 200, lead + (3,), generator=g, device=dev, dtype=torch.uint8),
    }


def _g4_record_leaves(g, lead, dev):
    """The arrays of an argsort of records: int32 keys, the int32 index and a
    3-word record leaf."""
    return {"k": torch.randint(-2**31, 2**31 - 1, lead, generator=g, device=dev,
                               dtype=torch.int32),
            "idx": torch.arange(lead[-1], device=dev, dtype=torch.int32).expand(lead).contiguous(),
            "words": torch.randint(-2**31, 2**31 - 1, lead + (3,), generator=g, device=dev,
                                   dtype=torch.int32)}


@pytest.mark.parametrize("lead", [(1 << 20,), (8, 1 << 16), (3, 1000)])
def test_scatter_rows_kernel(dev, lead):
    """G4's scatter, every tensor in one launch: payload rows of 1-16 bytes
    and the records' keys, index and 3-word leaf, by a random permutation
    (row by row), by K1's and K4's placements with their offsets (the
    planned path), by offsets the permutation is no placement of (planned
    all the same: each slot carries its row's destination), and more than
    MAX_MOVE tensors (one launch more)."""
    from repro_torch.kernels import glue

    g = torch.Generator(device=dev).manual_seed(len(lead))
    arrays = _glue_leaves(g, lead, dev)
    records = _g4_record_leaves(g, lead, dev)
    dest = torch.argsort(torch.rand(lead, generator=g, device=dev), dim=-1).to(torch.int32)

    def same(got, want):
        _equal(tuple(got.values()), tuple(want.values()))

    def one_launch(arrays_, dest_, offsets_=None):
        before = kernels.launch_counts()["scatter_rows"]
        got = glue.scatter_rows(arrays_, dest_, offsets_)
        assert kernels.launch_counts()["scatter_rows"] == before + 1
        same(got, glue.scatter_rows_plain(arrays_, dest_))

    one_launch(arrays, dest)
    n = lead[-1]
    off = torch.tensor([0, n // 2, n], dtype=torch.int32, device=dev).expand(
        lead[:-1] + (3,)).contiguous()
    one_launch(arrays, dest, off)
    k = 16
    keys = torch.randint(-2**31, 2**31 - 1, lead, generator=g, device=dev, dtype=torch.int32)
    rows = keys if keys.dim() == 2 else keys[None]
    spl = torch.sort(rows[:, : 4 * k], dim=1).values[:, torch.arange(1, k, device=dev) * 4]
    place, offsets = lf.level_fused_batched(rows, spl.contiguous(), k=k)
    if keys.dim() == 1:
        place, offsets = place[0], offsets[0]
    one_launch(arrays, place, offsets)
    one_launch(records, place, offsets)
    one_launch({"k": records["k"], "idx": records["idx"]}, place, offsets)
    # K2's placement over 17 segments x 128 local ids (more buckets than a
    # span stages whole: at 2^20 keys each span's buckets found by the warp
    # search; at 2^16 its destinations close enough to move row by row)
    ids = torch.sort(torch.randint(0, 17, lead[-1:], generator=g, device=dev,
                                   dtype=torch.int32)).values
    seg_off = torch.searchsorted(ids, torch.arange(18, device=dev, dtype=torch.int32)).to(
        torch.int32)
    comp = ids * 128 + torch.randint(0, 128, lead[-1:], generator=g, device=dev,
                                     dtype=torch.int32)
    place2, offsets2 = lf.rank_hist(comp, nb=17 * 128, seg_offsets=seg_off, seg_width=128)
    flat = {name: a.reshape((-1,) + tuple(a.shape[len(lead):]))[: lead[-1]]
            for name, a in {**arrays, **records}.items()}
    one_launch(flat, place2, offsets2)
    many = {f"t{i}": records["idx"] + i for i in range(glue.MAX_MOVE + 1)}
    before = kernels.launch_counts()["scatter_rows"]
    same(glue.scatter_rows(many, place, offsets), glue.scatter_rows_plain(many, place))
    assert kernels.launch_counts()["scatter_rows"] == before + 2


@pytest.mark.parametrize("W", [2, 8, 256, 8192, 16384])
def test_gather_windows_kernel(dev, W):
    """G4's window gather, every tensor in one launch: into new tensors, into
    copies and in place (pass two at W/2), over one row and 4 rows, on rows
    of 1-16 bytes and on the records' keys, index and 3-word leaf."""
    from repro_torch.kernels import glue

    g = torch.Generator(device=dev).manual_seed(W)
    for B in (1, 4):
        n = 4 * max(W, 256)
        for arrays in (_glue_leaves(g, (B, n), dev), _g4_record_leaves(g, (B, n), dev)):
            for lo, per in ((0, n // W), (W // 2, n // W - 1), (0, n // W // 2)):
                perm = torch.argsort(torch.rand((B * per, W), generator=g, device=dev),
                                     dim=1).to(torch.int32)
                want = {name: glue.gather_windows_plain(a, perm, lo, a.clone())
                        for name, a in arrays.items()}
                got = glue.gather_windows(arrays, perm, lo,
                                          {name: a.clone() for name, a in arrays.items()})
                _equal(tuple(got.values()), tuple(want.values()))
                inplace = {name: a.clone() for name, a in arrays.items()}
                before = kernels.launch_counts()["gather_windows"]
                got = glue.gather_windows(inplace, perm, lo, inplace)
                assert kernels.launch_counts()["gather_windows"] == before + 1
                assert all(got[name] is inplace[name] for name in arrays)
                _equal(tuple(inplace.values()), tuple(want.values()))
                if lo == 0 and per * W == n:
                    got = glue.gather_windows(arrays, perm, 0)
                    _equal(tuple(got.values()), tuple(
                        glue.gather_windows_plain(a, perm, 0) for a in arrays.values()))


def test_sort_runs_the_glue_kernels(dev):
    """ops.sort on the card launches G1-G7 and no torch chain of theirs: no
    searchsorted, no index_put and no nonzero (the fallback is G7's)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1 << 22, device=dev)
    kernels.reset_launch_counts()
    y = ops.sort(x)
    counts = kernels.launch_counts()
    for name in ("close_placement", "segment_ids", "composite_ids", "scatter_rows",
                 "gather_windows", "codec_encode", "codec_decode", "sample_splitters",
                 "fallback_list", "fallback_sort"):
        assert counts[name] > 0, name
    assert torch.equal(y, torch.sort(x).values)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.sort(x)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    for torch_op in ("searchsorted", "index_put", "nonzero", "Memcpy HtoD"):
        assert not [k_ for k_ in names if torch_op in k_], torch_op


KEY_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.uint16, torch.float16, torch.bfloat16,
              torch.int32, torch.uint32, torch.float32, torch.int64, torch.uint64, torch.float64]


def _codec_input(dtype, shape, dev, seed=0):
    """Random bits of ``dtype`` with NaN, -NaN, +-0.0, +-inf and a subnormal
    in front (floats)."""
    width = torch.empty(0, dtype=dtype).element_size()
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[width]
    g = torch.Generator().manual_seed(seed)
    raw = torch.randint(-2**62, 2**62, shape, generator=g).to(signed)
    keys = raw.view(dtype)
    if dtype.is_floating_point:
        sp = torch.tensor([float("nan"), -float("nan"), 0.0, -0.0, float("inf"), -float("inf"),
                           torch.finfo(dtype).tiny / 2])
        keys.view(-1)[:len(sp)] = sp.to(dtype)
    return keys.to(dev)


def _same(got, want):
    assert torch.equal(got, want)


def _signed(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


@pytest.mark.parametrize("dtype", KEY_DTYPES)
def test_codec_kernels(dev, dtype):
    """G5 against its twin bit for bit: the codes, the sentinel tail, the
    complement and the index payload, one row and (B, n) rows, and the
    decode of the first n codes of each row (NaN canonical)."""
    from repro_torch.kernels import codec

    for shape, n_pad in (((100003,), None), ((100003,), 106496), ((3, 5000), 8192)):
        x = _codec_input(dtype, shape, dev, seed=len(shape))
        for index, complement in ((False, False), (True, False), (True, True)):
            got = codec.encode_padded(x, n_pad, index, complement)
            want = codec.encode_padded_plain(x, n_pad, index, complement)
            _same(got[0], want[0])
            assert (got[1] is None) == (want[1] is None)
            if index:
                _same(got[1], want[1])
            n = shape[-1]
            _same(_signed(codec.decode(got[0], dtype, n, complement)),
                   _signed(codec.decode_plain(want[0], dtype, n, complement)))


@pytest.mark.parametrize("dtype", [d for d in KEY_DTYPES if d not in (torch.int32, torch.int64)])
def test_keyspace_codec_any_shape_runs_the_kernels(dev, dtype):
    """``ops.keyspace.encode``/``decode`` on the card take the G5 kernels for
    keys of any shape (3-D, a transposed view, 0-d), one launch each, bit
    for bit the plain twins."""
    from repro_torch.ops import keyspace

    x3 = _codec_input(dtype, (4, 5, 6), dev, seed=3)
    for x in (x3, x3.transpose(0, 2), x3[1, 2, 3]):
        kernels.reset_launch_counts()
        enc = keyspace.encode(x)
        assert kernels.launch_counts()["codec_encode"] == 1
        _same(enc, keyspace.encode_plain(x))
        dec = keyspace.decode(enc, dtype)
        assert kernels.launch_counts()["codec_decode"] == 1
        _same(_signed(dec), _signed(keyspace.decode_plain(enc, dtype)))


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_sample_splitters_kernel(dev, key_dtype):
    """G6 against its twin: level 1 with the upper form at the main path's
    m = 512, k = 128 and at m = 7 and 8192; level 2 over empty segments,
    an empty last one, and a uniform just below 1."""
    from repro_torch.kernels import glue

    for B, n, m, k in ((1, 1 << 20, 512, 128), (8, 1 << 16, 7, 4), (1, 50000, 8192, 256)):
        keys = torch.randint(-2**31, 2**31, (B, n), device=dev).to(key_dtype)
        keys[:, ::7] = 5
        pos = torch.randint(0, n, (B, m), device=dev)
        got = glue.sample_splitters(keys, pos, k, upper=True)
        want = glue.sample_splitters_plain(keys, pos, k, upper=True)
        _same(got[0], want[0])
        _same(got[1], want[1])
    B, n, S, m, k = 2, 1 << 16, 33, 96, 16
    keys = torch.randint(-2**31, 2**31, (B, n), device=dev).to(key_dtype)
    cuts = torch.sort(torch.randint(0, n, (B, S - 1), device=dev), dim=1).values
    cuts[:, 3:9] = cuts[:, 3:4]
    off = torch.cat([torch.zeros(B, 1, dtype=torch.int64, device=dev), cuts,
                     torch.full((B, 1), n, device=dev)], 1).to(torch.int32)
    off[:, -2] = n
    u = torch.rand((B, S, m), device=dev)
    u[..., 0] = 0.99999994
    _same(glue.sample_splitters(keys, u, k, seg_offsets=off),
           glue.sample_splitters_plain(keys, u, k, seg_offsets=off))


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("sizes,W", [([[1 << 15]], 8192),
                                      ([[129, 1, 2047, 1, 2048, 1, 2049, 1, 6149]], 256),
                                      ([[5000, 1, 300], [10, 20], [4097]], 8192),
                                      ([[100, 200]], 8192)])
def test_fallback_kernels(dev, key_dtype, sizes, W):
    """G7 against its twin bit for bit, in two launches: a bucket holding
    the whole row, buckets of W/2+1, C-1, C, C+1 and 3C+5 keys, rows of
    other counts with equal keys, no bucket over W/2; with and without
    ``limit``; keys, an int32 index, bool rows of 3, float32 rows of 2 and
    bfloat16 payloads moved, and the keys alone (merged themselves)."""
    from repro_torch.kernels import _build, fallback, glue

    n = max(sum(s) for s in sizes) + 1
    offs = [np.append(np.concatenate([[0], np.cumsum(s)]), n) for s in sizes]
    nb = max(len(o) for o in offs) - 1
    off = torch.tensor(np.stack([np.append(o, [n] * (nb + 1 - len(o))) for o in offs]),
                       dtype=torch.int32, device=dev)
    B = off.shape[0]
    keys = torch.randint(-2**31, 2**31, (B, n), device=dev).to(key_dtype) % 1000
    keys[-1] = 7
    fb = glue.segment_ids(off, n)
    for limit in (None, n // 3):
        arrays = {"k": keys, "v": torch.arange(B * n, device=dev).reshape(B, n).to(torch.int32),
                  "b": torch.rand(B, n, 3, device=dev) > 0.5, "f": torch.randn(B, n, 2, device=dev),
                  "h": torch.randn(B, n, device=dev).to(torch.bfloat16)}
        a1 = {k_: v.clone() for k_, v in arrays.items()}
        a2 = {k_: v.clone() for k_, v in arrays.items()}
        kernels.reset_launch_counts()
        fallback.sort_oversized(a1, fb, off, nb, W, None, limit)
        assert _build.LAUNCHES["fallback_list"] == 1 and _build.LAUNCHES["fallback_sort"] == 1
        fallback.sort_oversized_plain(a2, fb, off, nb, W, None, limit)
        for k_ in arrays:
            _same(_signed(a1[k_]) if a1[k_].dtype != torch.bool else a1[k_],
                  _signed(a2[k_]) if a2[k_].dtype != torch.bool else a2[k_])
        alone = {"k": keys.clone()}  # the keys alone: the kernel that merges the keys
        fallback.sort_oversized(alone, fb, off, nb, W, None, limit)
        _same(alone["k"], fallback.sort_oversized_plain({"k": keys.clone()}, fb, off, nb, W,
                                                        None, limit)["k"])


@pytest.mark.parametrize("leaves,sort_launches", [(20, 1), (128, 1), (129, 2)])
def test_fallback_moves_many_arrays(dev, leaves, sort_launches):
    """G7 with a payload of many leaves: one sort launch moves up to
    ``fallback.MAX_ARRAYS`` arrays (keys included), one more each further
    128; every array equal to the twin's."""
    from repro_torch.kernels import _build, fallback, glue

    n, W = 1 << 14, 256
    off = torch.tensor([[0, 5000, 5001, 9000, n]], dtype=torch.int32, device=dev)
    keys = torch.randint(0, 50, (1, n), device=dev, dtype=torch.int32)
    arrays = {"k": keys}
    for i in range(leaves - 1):
        dtype = (torch.int32, torch.float16, torch.uint8)[i % 3]
        arrays[f"v{i}"] = torch.randint(0, 100, (1, n), device=dev).to(dtype) + i
    a1 = {k_: v.clone() for k_, v in arrays.items()}
    a2 = {k_: v.clone() for k_, v in arrays.items()}
    kernels.reset_launch_counts()
    fallback.sort_oversized(a1, None, off, 4, W, None)
    assert _build.LAUNCHES["fallback_list"] == 1
    assert _build.LAUNCHES["fallback_sort"] == sort_launches
    fallback.sort_oversized_plain(a2, glue.segment_ids(off, n), off, 4, W, None)
    for k_ in arrays:
        _same(_signed(a1[k_]), _signed(a2[k_]))


def test_sorts_make_no_synchronizing_call(dev):
    """With obs off, the sort entry points read nothing back from the card
    between their entry and their return (``set_sync_debug_mode("error")``)."""
    n = 1 << 20
    x = torch.rand(n, device=dev)
    calls = [lambda: ops.sort(x), lambda: ops.argsort(x), lambda: ops.topk(x, 1024),
             lambda: ops.bottomk(x, 1024), lambda: ops.sort(x.double()),
             lambda: ops.sort((x * 2**31).to(torch.int32), classifier="radix"),
             lambda: ops.batched_sort(x.reshape(16, -1)),
             lambda: ops.batched_argsort(x.reshape(16, -1)),
             lambda: ops.batched_topk(x.reshape(16, -1), 64)]
    off = torch.tensor([0, 1000, 1000, 500000, n], dtype=torch.int32, device=dev)
    calls.append(lambda: ops.segmented_sort(x, off, 4))
    for call in calls:
        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
